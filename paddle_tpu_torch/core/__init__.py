"""The port's core: flags, dtypes, the op bus, autograd controls, the
RNG and the ``Tensor`` facade (``paddle_tpu/core`` of the JAX package;
``native.py`` waits for ROADMAP A12)."""
