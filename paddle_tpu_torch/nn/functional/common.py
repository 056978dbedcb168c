"""Common functionals: the port of ``paddle_tpu/nn/functional/common.py``
(all of it but ``sdp_kernel``, which flips the JAX package's Pallas kill
switch; the port has no kill switch: a CUDA tensor takes its kernel or the
call raises).

``linear`` keeps Paddle's weight layout, ``[in, out]``: a caller passes the
weight itself.  Only the ``Linear`` layer (``nn/common.py``) stores
``[out, in]``.  The dropouts draw their masks from ``generator`` (a
``torch.Generator`` on the input's device) when given, else from torch's
default generator; the JAX package draws from its global key, so masks
differ and only their structure, scale and statistics agree.

``interpolate`` resizes as the JAX function does, not by PyTorch's rules:

* ``"nearest"`` picks ``floor((i + 0.5) * in / out)`` (half-pixel
  centres, computed in fp32 as ``jax.image.resize``), whatever
  ``align_corners`` says;
* ``"linear"``, ``"bilinear"``, ``"trilinear"`` and ``"area"`` (which the
  JAX package maps to linear) use the triangle kernel and ``"bicubic"``
  Keys' cubic with a = -0.5, both on half-pixel centres, widened by the
  scale when downsampling (antialiasing), normalised over each output
  sample and zero where it falls outside the input: each resized axis is
  one weight matrix (``jax.image.resize``'s ``compute_weight_mat``, in
  float64 as the JAX package computes it under x64, cast to the input's
  dtype), applied as a matrix product;
* with ``align_corners`` every mode but nearest is the JAX package's own
  linear gather: samples at ``linspace(0, in - 1, out)``, the two
  neighbours mixed by the fraction.

An axis whose size does not change is left as it is.  The port never
calls ``torch.nn.functional.interpolate``.

``pad`` pads each axis as ``numpy.pad`` (``jnp.pad``) does: ``reflect``,
``replicate`` (numpy's ``edge``) and ``circular`` (``wrap``) gather the
indices ``numpy.pad`` gives ``arange(n)``.  ``one_hot`` gives fp32 rows,
all zero for a class outside ``[0, num_classes)``, as ``jax.nn.one_hot``
does.  ``edit_distance`` is a dynamic programme on the host, as in the JAX
package.  ``gather_tree`` follows parent pointers from the last step back
(``nn/decode.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.dispatch import op, run_op


def linear(x, weight, bias=None, name=None):
    """``y = x @ W + b`` with ``W`` ``[in, out]`` (Paddle's layout); under
    ``amp.auto_cast`` the JAX op ``linear``'s casts."""
    return run_op("linear", _linear, x, weight, bias)


def _linear(x, weight, bias):
    return F.linear(x, weight.t(), bias)


@op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, max_norm=None,
              norm_type=2.0, name=None):
    """Rows of ``weight`` at ``x``; where ``x == padding_idx`` the row is
    zero (so is its gradient), as in the JAX package."""
    out = F.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


# --- dropouts -----------------------------------------------------------------

def keep_mask(shape, p, device, generator=None):
    """A boolean mask of ``shape``, each element kept with probability
    ``1 - p``: every dropout's draw."""
    return torch.rand(tuple(shape), device=device, generator=generator) \
        < 1.0 - p


@op("dropout")
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero each element (each slice along the dims not in ``axis``, when
    ``axis`` is given) with probability ``p``.  ``upscale_in_train`` scales
    the kept ones by ``1 / (1 - p)`` in training and is the identity in
    eval; ``downscale_in_infer`` keeps them as they are in training and
    multiplies by ``1 - p`` in eval."""
    if not training or p == 0.0:
        if not training and p > 0.0 and mode == "downscale_in_infer":
            return (x * (1.0 - p)).to(x.dtype)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = keep_mask(shape, p, x.device, generator)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels dropped: one draw a (sample, channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training, generator=generator)


@op("alpha_dropout")
def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU's dropout: a dropped element takes ``-alpha * scale``, then
    ``a * x + b`` keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = keep_mask(x.shape, p, x.device, generator)
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


# --- padding ------------------------------------------------------------------

_NUMPY_MODES = {"reflect": "reflect", "replicate": "edge",
                "circular": "wrap"}


def _pad_pairs(pad, nd, data_format):
    """Per-axis ``(before, after)``: a full-rank ``pad`` pairs the axes in
    order; a shorter one pads the spatial axes, its first pair the last
    spatial axis (W), as Paddle and torch read it."""
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    n_spatial = len(pad) // 2
    pairs = [(0, 0)] * nd
    if data_format.endswith("C"):       # NHWC / NDHWC / NLC
        spatial_axes = list(range(1, 1 + n_spatial))
    else:
        spatial_axes = list(range(nd - n_spatial, nd))
    for i, a in enumerate(reversed(spatial_axes)):
        pairs[a] = (pad[2 * i], pad[2 * i + 1])
    return pairs


@op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True, name=None):
    """Paddle's ``pad``: ``pad`` lists ``[before, after]`` for every axis
    (full rank) or for the spatial axes, last axis first."""
    if isinstance(pad, torch.Tensor):
        pad = [int(v) for v in pad.tolist()]
    pairs = _pad_pairs(list(pad), x.dim(), data_format)
    if mode == "constant":
        flat = [n for pair in reversed(pairs) for n in pair]
        return F.pad(x, flat, mode="constant", value=value)
    np_mode = _NUMPY_MODES[mode]
    for axis, (before, after) in enumerate(pairs):
        if before or after:
            idx = np.pad(np.arange(x.shape[axis]), (before, after),
                         mode=np_mode)
            x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# --- small maps ---------------------------------------------------------------

@op("one_hot")
def one_hot(x, num_classes, name=None):
    classes = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


@op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        pd = torch.as_tensor(prior_dist, device=label.device)
        return (1 - epsilon) * label + epsilon * pd
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    dot = torch.sum(x1 * x2, dim=axis)
    na = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    nb = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(na * nb, eps)


@op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    d = x - y + epsilon
    return torch.sum(torch.abs(d) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


@op("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] W[o] x2[b] (+ bias[o])``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


# --- interpolation ------------------------------------------------------------

def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_weight_mat(n_in, n_out, kernel):
    """``jax.image.resize``'s ``compute_weight_mat`` in float64, ``[n_in,
    n_out]``: ``kernel`` is ``"linear"`` or ``"cubic"``, antialiased."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) \
        / kernel_scale
    w = (_triangle if kernel == "linear" else _keys_cubic)(x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _resize_nearest(v, axis, n_out):
    n_in = v.shape[axis]
    pos = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
           * np.float32(n_in)) / np.float32(n_out)
    idx = np.floor(pos).astype(np.int64)
    return v.index_select(axis, torch.from_numpy(idx).to(v.device))


def _resize_kernel(v, axis, n_out, kernel):
    w = torch.from_numpy(resize_weight_mat(v.shape[axis], n_out, kernel))
    w = w.to(device=v.device, dtype=v.dtype)
    return (v.movedim(axis, -1) @ w).movedim(-1, axis)


def _resize_align_corners(v, axis, n_out):
    n_in = v.shape[axis]
    if n_out == 1 or n_in == 1:
        pos = np.zeros((n_out,), np.float32)
    else:
        pos = np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.floor(pos).astype(np.int64)
    hi = np.clip(lo + 1, 0, n_in - 1)
    shape = [1] * v.dim()
    shape[axis] = n_out
    w = torch.from_numpy((pos - lo).astype(np.float64)).to(
        device=v.device, dtype=v.dtype).reshape(shape)
    lo_t, hi_t = (torch.from_numpy(i).to(v.device) for i in (lo, hi))
    return v.index_select(axis, lo_t) * (1 - w) \
        + v.index_select(axis, hi_t) * w


_KERNELS = {"bilinear": "linear", "linear": "linear", "trilinear": "linear",
            "bicubic": "cubic", "area": "linear", "nearest": "nearest"}


@op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of ``x`` to ``size`` (or ``round(in *
    scale_factor)``), by the JAX package's rules (module docstring)."""
    channel_last = data_format.endswith("C")
    spatial = list(range(1, x.dim() - 1)) if channel_last \
        else list(range(2, x.dim()))
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = [int(v) for v in size.reshape(-1).tolist()]
        sizes = size if isinstance(size, (list, tuple)) else [size]
        out_sizes = [int(s) for s in sizes]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(spatial)
        out_sizes = [int(round(x.shape[a] * float(s)))
                     for a, s in zip(spatial, sf)]
    kernel = _KERNELS[mode]
    out = x
    for axis, n_out in zip(spatial, out_sizes):
        if out.shape[axis] == n_out:
            continue
        if kernel == "nearest":
            out = _resize_nearest(out, axis, n_out)
        elif align_corners:
            out = _resize_align_corners(out, axis, n_out)
        else:
            out = _resize_kernel(out, axis, n_out, kernel)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# --- patches and shuffles -----------------------------------------------------

def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def _window_args(kernel_sizes, strides, paddings, dilations):
    k, s, p, d = (_pair(v) for v in (kernel_sizes, strides, paddings,
                                     dilations))
    if len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]
    return k, s, p, d


@op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: NCHW -> ``[N, C * kh * kw, L]``, paddings ``[top, left,
    bottom, right]`` (or ``[h, w]``)."""
    k, s, p, d = _window_args(kernel_sizes, strides, paddings, dilations)
    N, C = x.shape[:2]
    v = F.pad(x, [p[1], p[3], p[0], p[2]])
    oh = (v.shape[2] - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
    ow = (v.shape[3] - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
    patches = [v[:, :, i * d[0]: i * d[0] + oh * s[0]: s[0],
                 j * d[1]: j * d[1] + ow * s[1]: s[1]]
               for i in range(k[0]) for j in range(k[1])]
    return torch.stack(patches, dim=2).reshape(N, C * k[0] * k[1], oh * ow)


@op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: ``[N, C * kh * kw, L]`` -> NCHW, overlapping patches
    summed."""
    o = _pair(output_sizes)
    k, s, p, d = _window_args(kernel_sizes, strides, paddings, dilations)
    N = x.shape[0]
    C = x.shape[1] // (k[0] * k[1])
    H, W = o[0] + p[0] + p[2], o[1] + p[1] + p[3]
    oh = (H - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
    ow = (W - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
    v = x.reshape(N, C, k[0], k[1], oh, ow)
    out = x.new_zeros((N, C, H, W))
    for i in range(k[0]):
        for j in range(k[1]):
            out[:, :, i * d[0]: i * d[0] + oh * s[0]: s[0],
                j * d[1]: j * d[1] + ow * s[1]: s[1]] += v[:, :, i, j]
    return out[:, :, p[0]: H - p[2], p[1]: W - p[3]]


@op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        v = x.reshape(N, C // (r * r), r, r, H, W).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(N, C // (r * r), H * r, W * r)
    N, H, W, C = x.shape
    v = x.reshape(N, H, W, r, r, C // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(N, H * r, W * r, C // (r * r))


@op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        v = x.reshape(N, C, H // r, r, W // r, r).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(N, C * r * r, H // r, W // r)
    N, H, W, C = x.shape
    v = x.reshape(N, H // r, r, W // r, r, C).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(N, H // r, W // r, C * r * r)


@op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        N, C, H, W = x.shape
        v = x.reshape(N, groups, C // groups, H, W).permute(0, 2, 1, 3, 4)
        return v.reshape(N, C, H, W)
    N, H, W, C = x.shape
    v = x.reshape(N, H, W, groups, C // groups).permute(0, 1, 2, 4, 3)
    return v.reshape(N, H, W, C)


@op("pdist")
def pdist(x, p=2.0, name=None):
    """Condensed pairwise p-distances of the rows of ``[N, D]``:
    ``[N * (N - 1) / 2]``."""
    iu, ju = (torch.from_numpy(i).to(x.device)
              for i in np.triu_indices(x.shape[0], k=1))
    diff = x[iu] - x[ju]
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, -1) + 0.0)
    return torch.sum(torch.abs(diff) ** p, -1) ** (1.0 / p)


def _max_unpool(x, indices, ndim, kernel_size, stride, padding, output_size):
    """Scatter pooled values back to their argmax positions (``indices``:
    Paddle's flattened per-channel spatial indices, as ``return_mask``
    gives them)."""
    ks = (kernel_size,) * ndim if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    st = ks if stride is None else (
        (stride,) * ndim if isinstance(stride, int) else tuple(stride))
    pd = (padding,) * ndim if isinstance(padding, int) else tuple(padding)
    N, C = x.shape[:2]
    if output_size is not None:
        out_sp = tuple(output_size)[-ndim:]
    else:
        out_sp = tuple((x.shape[2 + d] - 1) * st[d] - 2 * pd[d] + ks[d]
                       for d in range(ndim))
    flat = x.new_zeros((N, C, int(np.prod(out_sp))))
    flat = flat.scatter(2, indices.reshape(N, C, -1).long(),
                        x.reshape(N, C, -1))
    return flat.reshape((N, C) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size)


# --- sequences ----------------------------------------------------------------

@op("gather_tree")
def gather_tree(ids, parents):
    """Beam-search backtrace: ``ids`` and ``parents`` ``[T, B, beam]`` ->
    the full sequences, each followed back from its last step's slot."""
    ids, parents = torch.as_tensor(ids), torch.as_tensor(parents)
    T, B, K = ids.shape
    beams = torch.arange(K, device=ids.device).expand(B, K)
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = ids[t].gather(-1, beams)
        beams = parents[t].gather(-1, beams).long()
    return torch.stack(toks)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance of each row of two padded integer batches
    (``ignored_tokens`` dropped first), over the label's length when
    ``normalized``: ``(distance [B, 1] fp32, sequence_num [1] int64)`` on
    the input's device, computed on the host."""
    device = torch.as_tensor(input).device
    a = torch.as_tensor(input).cpu().numpy()
    b = torch.as_tensor(label).cpu().numpy()
    la = (torch.as_tensor(input_length).cpu().numpy()
          if input_length is not None else np.full(a.shape[0], a.shape[1]))
    lb = (torch.as_tensor(label_length).cpu().numpy()
          if label_length is not None else np.full(b.shape[0], b.shape[1]))
    ignored = set(ignored_tokens or [])
    out = np.zeros((a.shape[0], 1), np.float32)
    for i in range(a.shape[0]):
        s = [t for t in a[i, :la[i]].tolist() if t not in ignored]
        t = [t for t in b[i, :lb[i]].tolist() if t not in ignored]
        m, n = len(s), len(t)
        dp = np.arange(n + 1, dtype=np.int64)
        for r in range(1, m + 1):
            prev = dp.copy()
            dp[0] = r
            for c in range(1, n + 1):
                dp[c] = min(prev[c] + 1, dp[c - 1] + 1,
                            prev[c - 1] + (s[r - 1] != t[c - 1]))
        d = float(dp[n])
        out[i, 0] = d / max(n, 1) if normalized else d
    return (torch.from_numpy(out).to(device),
            torch.tensor([a.shape[0]], dtype=torch.int64, device=device))


@op("triangle_upper_mask")
def get_triangle_upper_mask(x):
    """An additive ``[S, S]`` mask for ``x``'s last axis: fp32's lowest
    value above the diagonal, 0 elsewhere, in ``x``'s dtype."""
    S = x.shape[-1]
    mask = torch.triu(torch.ones((S, S), dtype=torch.bool, device=x.device),
                      diagonal=1)
    low = torch.finfo(torch.float32).min
    return torch.where(mask, low, 0.0).to(x.dtype)
