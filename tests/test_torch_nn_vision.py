"""The port's ``nn/functional/vision.py`` held to the JAX package's on the
CPU: the same numpy inputs (from a seed) through both, outputs within
1e-5 and the gradients of the float inputs within 1e-5 of their largest
entries.

* ``affine_grid`` in 2-D and 3-D, with and without ``align_corners``.
* ``grid_sample`` in both modes under every padding mode, with and
  without ``align_corners``, on grids reaching outside the input; a grid
  from ``affine_grid`` into ``grid_sample``.
* ``temporal_shift`` in NCHW and NHWC.
"""

import pytest

import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as F

from torch_nn_pairs import hold, randn


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("dims", [2, 3])
def test_affine_grid_matches_jax(dims, align_corners):
    theta = randn((2, dims, dims + 1), 22)
    shape = [2, 3, 4, 5] if dims == 2 else [2, 3, 3, 4, 5]
    hold(lambda t: JF.affine_grid(t, shape, align_corners),
          lambda t: F.affine_grid(t, shape, align_corners), [theta])


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(mode, padding_mode, align_corners):
    x = randn((2, 3, 5, 6), 23)
    grid = randn((2, 4, 7, 2), 24, scale=0.8)     # some samples outside
    kw = dict(mode=mode, padding_mode=padding_mode,
              align_corners=align_corners)
    hold(lambda v, g: JF.grid_sample(v, g, **kw),
          lambda v, g: F.grid_sample(v, g, **kw), [x, grid])


def test_affine_grid_into_grid_sample_matches_jax():
    x, theta = randn((2, 3, 5, 6), 25), randn((2, 2, 3), 26, scale=0.5)
    hold(lambda v, t: JF.grid_sample(v, JF.affine_grid(t, [2, 3, 4, 4])),
          lambda v, t: F.grid_sample(v, F.affine_grid(t, [2, 3, 4, 4])),
          [x, theta], grads=False)


@pytest.mark.parametrize("fmt, ratio", [("NCHW", 0.25), ("NHWC", 0.125)])
def test_temporal_shift_matches_jax(fmt, ratio):
    shape = (6, 8, 3, 4) if fmt == "NCHW" else (6, 3, 4, 8)
    hold(lambda v: JF.temporal_shift(v, 3, ratio, fmt),
          lambda v: F.temporal_shift(v, 3, ratio, fmt), [randn(shape, 27)],
          grads=fmt == "NCHW")
