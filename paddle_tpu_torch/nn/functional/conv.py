"""Convolutions: the port of ``paddle_tpu/nn/functional/conv.py``.

The JAX package lowers every convolution to ``lax.conv_general_dilated``
(XLA code, no Pallas kernel); the port calls ``torch.nn.functional.conv*``
(cuDNN on the card).  Paddle's conventions are kept:

* input NCHW (or NHWC: ``data_format`` ending in ``C``), weight OIHW
  (``[out, in / groups, *k]``; a transposed conv's ``[in, out / groups,
  *k]``);
* ``padding`` an int, one int a spatial dim, two a dim (``[before0,
  after0, ...]``), or ``"SAME"`` / ``"VALID"`` with XLA's rule (``SAME``
  pads ``max((ceil(n / s) - 1) s + (k - 1) d + 1 - n, 0)``, the odd one
  after);
* the bias added after the product, on the product rounded to the input's
  dtype, as the JAX function adds it;
* under ``amp.auto_cast`` the JAX op names (``conv1d``, ``conv2d``,
  ``conv3d``, ``conv2d_transpose``; ``conv1d_transpose`` and
  ``conv3d_transpose`` are not on the list) decide the casts.

A padding torch cannot take (uneven sides) is applied by ``F.pad`` first;
a channel-last input is viewed as channel-first (a permutation, which
cuDNN reads as the channels-last memory format) and the result viewed
back.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.dispatch import run_op

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    """The JAX package's reading of a size argument: n ints, or n (before,
    after) pairs from a list of 2n."""
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 2 * n:
            return tuple((int(v[2 * i]), int(v[2 * i + 1]))
                         for i in range(n))
        return tuple(int(v[0]) for _ in range(n))
    return tuple(int(v) for _ in range(n))


def _pairs(padding, n, spatial, s, k, d):
    """``padding`` as one (before, after) pair a spatial dim."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(padding)
        pads = []
        for i in range(n):
            eff = (k[i] - 1) * d[i] + 1
            total = max((math.ceil(spatial[i] / s[i]) - 1) * s[i] + eff
                        - spatial[i], 0)
            pads.append((total // 2, total - total // 2))
        return pads
    p = _tuple(padding, n)
    if p and isinstance(p[0], tuple):
        return list(p)
    return [(x, x) for x in p]


def _channel_first(x, n, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _channel_back(y, channel_last):
    return y.movedim(1, -1) if channel_last else y


def _add_bias(out, b, channel_last):
    shape = [1] * out.dim()
    shape[-1 if channel_last else 1] = -1
    return out + b.reshape(shape)


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format, name):
    def f(x, weight, bias):
        return _conv_body(x, weight, bias, stride, padding, dilation, groups,
                          n, data_format)

    return run_op(name, f, x, weight, bias)


def _conv_body(x, weight, bias, stride, padding, dilation, groups, n,
               data_format):
    channel_last = data_format.endswith("C")
    s, d = _tuple(stride, n), _tuple(dilation, n)
    v = _channel_first(x, n, channel_last)
    pads = _pairs(padding, n, v.shape[2:], s, weight.shape[2:], d)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        # F.pad lists the last dim first
        v = TF.pad(v, [p for pair in reversed(pads) for p in pair])
        pad = 0
    out = _CONV[n](v, weight, None, s, pad, d, groups)
    out = _channel_back(out, channel_last)
    return out if bias is None else _add_bias(out, bias, channel_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 "NHC" if data_format == "NLC" else "NCH", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format, output_size, name):
    """The gradient of a conv: output ``(i - 1) s + (k - 1) d + 1 - lo - hi
    + output_padding`` a spatial dim, as the JAX function's dilated
    convolution gives it."""
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")

    def f(x, weight, bias):
        return _conv_transpose_body(x, weight, bias, stride, padding,
                                    output_padding, dilation, groups, n,
                                    data_format, output_size, name)

    return run_op(name, f, x, weight, bias)


def _conv_transpose_body(x, weight, bias, stride, padding, output_padding,
                         dilation, groups, n, data_format, output_size, name):
    channel_last = data_format.endswith("C")
    s, d = _tuple(stride, n), _tuple(dilation, n)
    op = (_tuple(output_padding, n)
          if not isinstance(output_padding, int) or output_padding
          else (0,) * n)
    v = _channel_first(x, n, channel_last)
    pads = _pairs(padding, n, None, s, None, d)
    if all(lo == hi for lo, hi in pads) and all(
            o < max(si, di) for o, si, di in zip(op, s, d)):
        out = _CONV_T[n](v, weight, None, s, tuple(lo for lo, _ in pads),
                         op, groups, d)
    else:
        # uneven sides: the full product, then each dim cut to its pads
        out = _CONV_T[n](v, weight, None, s, 0, 0, groups, d)
        extra = [o for o in op]
        out = TF.pad(out, [p for e in reversed(extra) for p in (0, e)])
        for i, (lo, hi) in enumerate(pads):
            out = out.narrow(2 + i, lo, out.shape[2 + i] - lo - hi)
    if output_size is not None:
        want = _tuple(output_size, n)
        if tuple(out.shape[2:]) != want:
            raise ValueError(f"{name}: output_size {want} does not match "
                             f"the computed {tuple(out.shape[2:])}")
    out = _channel_back(out, channel_last)
    return out if bias is None else _add_bias(out, bias, channel_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1,
                           "NHC" if data_format == "NLC" else "NCH",
                           output_size, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size,
                           "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size,
                           "conv3d_transpose")
