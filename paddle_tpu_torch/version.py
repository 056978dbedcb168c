"""``paddle.version`` analog: the release the port tracks (the JAX
package's ``paddle_tpu/version.py`` names the same one)."""

full_version = "2.6.0+cuda"
