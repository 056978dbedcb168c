"""The rest of the port's ``nn/functional/common.py`` and ``nn/common.py``
held to the JAX package's on the CPU (``nn/functional/vision.py``:
``tests/test_torch_nn_vision.py``): the
same numpy inputs (from a seed) through both, outputs within 1e-5 and,
where the backward is more than a copy (and once for each data-movement
function), the gradients of the float inputs within 1e-5 of their
largest entries.

* ``pad`` (constant, reflect, replicate, circular; spatial and full-rank
  pads; NCL, NCHW, NHWC, NCDHW) and ``zeropad2d``; ``one_hot`` (a class
  out of range gives a zero row), ``label_smooth``, ``cosine_similarity``,
  ``pairwise_distance``, ``bilinear``, ``pdist``,
  ``get_triangle_upper_mask``.
* ``interpolate`` / ``upsample`` in every mode (nearest, linear,
  bilinear, trilinear, bicubic, area) up and down, by size and by scale,
  with and without ``align_corners``, NCHW and NHWC.
* ``unfold`` / ``fold``, the pixel and channel shuffles, the three
  ``max_unpool``s (on the JAX pools' indices).
* Every new layer over its functional, ``Bilinear`` with the JAX weights.
* The dropouts (``dropout2d``, ``dropout3d``, ``alpha_dropout`` and their
  layers) held by structure and scale at a fixed mask given to both
  packages' draws: the mask's shape (whole channels), the outputs equal;
  eval mode the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import common as pcommon
from torch_nn_pairs import as_numpy, assert_near, hold, randn


# --- padding ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("shape, pad, fmt", [
    ((2, 3, 6), [2, 1], "NCL"), ((2, 3, 5, 6), [1, 2, 0, 3], "NCHW"),
    ((2, 5, 6, 3), [2, 1, 1, 0], "NHWC"),
    ((2, 3, 4, 5, 6), [1, 1, 2, 0, 0, 2], "NCDHW"),
    ((2, 3, 5, 6), [0, 0, 1, 0, 2, 1, 1, 3], "NCHW")])
def test_pad_matches_jax(mode, shape, pad, fmt):
    kw = dict(mode=mode, value=0.5, data_format=fmt)
    hold(lambda x: JF.pad(x, pad, **kw), lambda x: F.pad(x, pad, **kw),
          [randn(shape, 1)], grads=mode == "reflect")


def test_pad_layers_match_jax():
    x4, x3, x5 = randn((2, 3, 5, 6), 2), randn((2, 3, 6), 3), randn((1, 2, 3, 4, 5), 4)
    for jl, pl, x in (
            (jnn.Pad1D([1, 2], mode="reflect"), nn.Pad1D([1, 2],
                                                         mode="reflect"), x3),
            (jnn.Pad2D([1, 0, 2, 1], value=3.0), nn.Pad2D([1, 0, 2, 1],
                                                          value=3.0), x4),
            (jnn.Pad3D([1, 1, 0, 1, 2, 0], mode="replicate"),
             nn.Pad3D([1, 1, 0, 1, 2, 0], mode="replicate"), x5),
            (jnn.ZeroPad2D([2, 1, 0, 1]), nn.ZeroPad2D([2, 1, 0, 1]), x4)):
        hold(jl, pl, [x], grads=False)
    hold(lambda x: JF.zeropad2d(x, [1, 2, 3, 4]),
          lambda x: F.zeropad2d(x, [1, 2, 3, 4]), [x4], grads=False)


# --- small maps ---------------------------------------------------------------

def test_one_hot_and_label_smooth_match_jax():
    idx = np.array([[0, 3, 4], [2, -1, 5]], np.int64)
    hold(lambda v: JF.one_hot(v, 5), lambda v: F.one_hot(v, 5), [idx],
          grads=False)
    lab = np.eye(4, dtype=np.float32)[[0, 2, 1]]
    hold(lambda v: JF.label_smooth(v, epsilon=0.2),
          lambda v: F.label_smooth(v, epsilon=0.2), [lab])
    prior = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    hold(lambda v: JF.label_smooth(v, paddle.to_tensor(prior)),
          lambda v: F.label_smooth(v, torch.from_numpy(prior)), [lab])


@pytest.mark.parametrize("axis", [1, -1])
def test_cosine_similarity_matches_jax(axis):
    a, b = randn((3, 4, 5), 5), randn((3, 4, 5), 6)
    hold(lambda x, y: JF.cosine_similarity(x, y, axis=axis),
          lambda x, y: F.cosine_similarity(x, y, axis=axis), [a, b])
    hold(jnn.CosineSimilarity(axis=axis), nn.CosineSimilarity(axis=axis),
          [a, b])


@pytest.mark.parametrize("p, keepdim", [(2.0, False), (1.0, True),
                                        (3.0, False)])
def test_pairwise_distance_matches_jax(p, keepdim):
    a, b = randn((4, 6), 7), randn((4, 6), 8)
    hold(lambda x, y: JF.pairwise_distance(x, y, p, keepdim=keepdim),
          lambda x, y: F.pairwise_distance(x, y, p, keepdim=keepdim), [a, b])
    hold(jnn.PairwiseDistance(p, keepdim=keepdim),
          nn.PairwiseDistance(p, keepdim=keepdim), [a, b])


@pytest.mark.parametrize("bias", [True, False])
def test_bilinear_matches_jax(bias):
    paddle.seed(9)
    jl = jnn.Bilinear(3, 4, 5, bias_attr=None if bias else False)
    pl = nn.Bilinear(3, 4, 5, bias_attr=None if bias else False)
    convert.load_paddle_tpu_state(pl, {k: as_numpy(v) for k, v in
                                       jl.state_dict().items()})
    a, b = randn((6, 3), 10), randn((6, 4), 11)
    hold(jl, pl, [a, b])
    w = randn((5, 3, 4), 12)
    hold(lambda x, y, z: JF.bilinear(x, y, z), lambda x, y, z:
          F.bilinear(x, y, z), [a, b, w])


@pytest.mark.parametrize("p", [2.0, 1.0])
def test_pdist_and_triangle_mask_match_jax(p):
    hold(lambda x: JF.pdist(x, p), lambda x: F.pdist(x, p), [randn((5, 3), 13)])
    x = randn((2, 4, 4), 14)
    hold(JF.get_triangle_upper_mask, F.get_triangle_upper_mask, [x],
          grads=False)


# --- interpolation ------------------------------------------------------------

@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(9, 13), (3, 4)])
def test_interpolate_2d_matches_jax(mode, size, align_corners):
    x = randn((2, 3, 5, 7), 15)
    kw = dict(size=list(size), mode=mode, align_corners=align_corners)
    hold(lambda v: JF.interpolate(v, **kw), lambda v: F.interpolate(v, **kw),
          [x])


@pytest.mark.parametrize("mode, shape, fmt, kw", [
    ("linear", (2, 3, 7), "NCW", dict(size=[11])),
    ("linear", (2, 3, 7), "NCW", dict(scale_factor=0.5)),
    ("trilinear", (1, 2, 3, 4, 5), "NCDHW", dict(size=[5, 2, 7])),
    ("trilinear", (1, 2, 3, 4, 5), "NCDHW",
     dict(size=[5, 2, 7], align_corners=True)),
    ("bilinear", (2, 5, 7, 3), "NHWC", dict(scale_factor=[1.5, 0.5])),
    ("nearest", (2, 5, 7, 3), "NHWC", dict(size=[10, 3])),
    ("bicubic", (1, 2, 6, 6), "NCHW", dict(scale_factor=2)),
    ("area", (2, 3, 5, 7), "NCHW", dict(size=[9, 13])),
    ("area", (2, 3, 5, 7), "NCHW", dict(size=[3, 4]))])
def test_interpolate_layouts_and_scales_match_jax(mode, shape, fmt, kw):
    kw = dict(kw, mode=mode, data_format=fmt)
    x = randn(shape, 16)
    hold(lambda v: JF.interpolate(v, **kw), lambda v: F.interpolate(v, **kw),
          [x], grads=mode != "linear")
    if mode == "bicubic":
        hold(lambda v: JF.upsample(v, **kw), lambda v: F.upsample(v, **kw),
              [x], grads=False)


def test_upsample_layers_match_jax():
    x = randn((2, 3, 4, 5), 17)
    for jl, pl in (
            (jnn.Upsample(size=[7, 3], mode="bicubic"),
             nn.Upsample(size=[7, 3], mode="bicubic")),
            (jnn.UpsamplingNearest2D(scale_factor=2),
             nn.UpsamplingNearest2D(scale_factor=2)),
            (jnn.UpsamplingBilinear2D(size=[6, 9]),
             nn.UpsamplingBilinear2D(size=[6, 9]))):
        hold(jl, pl, [x], grads=False)


def test_resize_weights_match_jax_compute_weight_mat():
    from jax._src.image import scale as jscale

    for n_in, n_out, kernel, fn in ((7, 3, "linear",
                                     jscale._fill_triangle_kernel),
                                    (5, 12, "cubic",
                                     jscale._fill_keys_cubic_kernel)):
        want = np.asarray(jscale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, fn, True))
        np.testing.assert_allclose(pcommon.resize_weight_mat(n_in, n_out,
                                                             kernel),
                                   want, rtol=1e-12, atol=1e-15)


# --- patches and shuffles -----------------------------------------------------

@pytest.mark.parametrize("k, s, p, d", [
    (2, 1, 0, 1), ([3, 2], [2, 1], [1, 0], 1), (2, 2, [1, 2, 0, 1], [2, 1])])
def test_unfold_and_fold_match_jax(k, s, p, d):
    x = randn((2, 3, 7, 8), 18)
    hold(lambda v: JF.unfold(v, k, s, p, d),
          lambda v: F.unfold(v, k, s, p, d), [x], grads=d == 1)
    hold(jnn.Unfold(k, s, p, d), nn.Unfold(k, s, p, d), [x], grads=False)
    cols = as_numpy(F.unfold(torch.from_numpy(x), k, s, p, d))
    hold(lambda v: JF.fold(v, [7, 8], k, s, p, d),
          lambda v: F.fold(v, [7, 8], k, s, p, d), [cols], grads=s == 1)
    hold(jnn.Fold([7, 8], k, s, p, d), nn.Fold([7, 8], k, s, p, d), [cols],
          grads=False)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_shuffles_match_jax(fmt):
    x = randn((2, 8, 4, 6) if fmt == "NCHW" else (2, 4, 6, 8), 19)
    for jl, pl in ((jnn.PixelShuffle(2, fmt), nn.PixelShuffle(2, fmt)),
                   (jnn.PixelUnshuffle(2, fmt), nn.PixelUnshuffle(2, fmt)),
                   (jnn.ChannelShuffle(4, fmt), nn.ChannelShuffle(4, fmt))):
        hold(jl, pl, [x], grads=False)
    hold(lambda v: JF.channel_shuffle(v, 2, fmt),
          lambda v: F.channel_shuffle(v, 2, fmt), [x], grads=False)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_max_unpool_matches_jax(ndim):
    shape = (2, 3) + (8, 6, 4)[:ndim]
    x = randn(shape, 20)
    pool = getattr(JF, f"max_pool{ndim}d")
    pooled, idx = pool(paddle.to_tensor(x), 2, 2, return_mask=True)
    jfn = getattr(JF, f"max_unpool{ndim}d")
    pfn = getattr(F, f"max_unpool{ndim}d")
    hold(lambda v, i: jfn(v, i, 2), lambda v, i: pfn(v, i, 2),
          [as_numpy(pooled), as_numpy(idx)], grads=ndim == 2)
    out = [shape[2 + d] + 1 for d in range(ndim)]
    hold(lambda v, i: jfn(v, i, 2, output_size=out),
          lambda v, i: pfn(v, i, 2, output_size=out), [as_numpy(pooled), as_numpy(idx)],
          grads=False)


def test_unflatten_matches_jax():
    x = randn((2, 12, 3), 21)
    hold(jnn.Unflatten(1, [3, 4]), nn.Unflatten(1, [3, 4]), [x],
          grads=False)


# --- dropouts at a fixed mask -------------------------------------------------

@pytest.fixture
def fixed_mask(monkeypatch):
    """Both packages' dropout draws return one given mask; the shapes they
    asked for are recorded."""
    asked = []

    def give(shape):
        asked.append(tuple(shape))
        return np.random.default_rng(7).random(tuple(shape)) < 0.6

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(give(shape)))
    monkeypatch.setattr(pcommon, "keep_mask", lambda shape, p, device,
                        generator=None: torch.from_numpy(give(shape)))
    return asked


@pytest.mark.parametrize("name, shape, kw, mask_shape", [
    ("dropout2d", (2, 3, 4, 5), {}, (2, 3, 1, 1)),
    ("dropout2d", (2, 4, 5, 3), dict(data_format="NHWC"), (2, 1, 1, 3)),
    ("dropout3d", (2, 3, 2, 4, 5), {}, (2, 3, 1, 1, 1)),
    ("alpha_dropout", (3, 4, 5), {}, (3, 4, 5))])
def test_dropouts_at_a_fixed_mask_match_jax(fixed_mask, name, shape, kw,
                                            mask_shape):
    x = randn(shape, 28)
    jout = getattr(JF, name)(paddle.to_tensor(x), 0.4, **kw)
    pout = getattr(F, name)(torch.from_numpy(x), 0.4, **kw)
    assert fixed_mask == [mask_shape, mask_shape]
    assert_near(as_numpy(pout), as_numpy(jout), 1e-6)
    if name != "alpha_dropout":     # whole channels kept or zeroed
        np.testing.assert_array_equal(as_numpy(pout) == 0,
                                      as_numpy(jout) == 0)
    for p in (0.0,):
        np.testing.assert_array_equal(
            as_numpy(getattr(F, name)(torch.from_numpy(x), p, **kw)), x)
    np.testing.assert_array_equal(as_numpy(getattr(F, name)(
        torch.from_numpy(x), 0.4, training=False, **kw)), x)


@pytest.mark.parametrize("name, shape", [("Dropout2D", (2, 3, 4, 5)),
                                         ("Dropout3D", (2, 3, 2, 4, 5)),
                                         ("AlphaDropout", (3, 4, 5))])
def test_dropout_layers_match_jax(fixed_mask, name, shape):
    x = randn(shape, 29)
    jl, pl = getattr(jnn, name)(0.3), getattr(nn, name)(0.3)
    assert_near(as_numpy(pl(torch.from_numpy(x))), as_numpy(jl(paddle.to_tensor(x))), 1e-6)
    pl.eval()
    np.testing.assert_array_equal(as_numpy(pl(torch.from_numpy(x))), x)


def test_dropout2d_draws_from_its_generator():
    x = torch.ones(4, 6, 3, 3)
    a = F.dropout2d(x, 0.5, generator=torch.Generator().manual_seed(5))
    b = F.dropout2d(x, 0.5, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    per_channel = a.reshape(4, 6, -1)
    assert set(per_channel.unique().tolist()) <= {0.0, 2.0}
    assert torch.all(per_channel.amin(-1) == per_channel.amax(-1))
