"""Spatial-transformer and video functionals: the port of
``paddle_tpu/nn/functional/vision.py`` (``affine_grid``, ``grid_sample``,
``temporal_shift``), gathers and mixes in torch ops with the JAX
package's ``align_corners`` and padding rules (not torch's
``grid_sample``).

``affine_grid`` builds its base grid in float64, as the JAX package does
under x64, and returns the grid in ``theta``'s dtype (the JAX package
returns float64).  ``grid_sample`` maps a normalised coordinate ``c`` to
``(c + 1) (size - 1) / 2`` with ``align_corners``, else ``((c + 1) size -
1) / 2``; ``"border"`` clamps it into the input, ``"reflection"``
reflects it at the outer pixel centres (``align_corners``) or edges,
``"zeros"`` reads 0 outside; ``"nearest"`` rounds half to even, as
``jnp.round``.
"""

from __future__ import annotations

import torch

from ...core.dispatch import op


def _lin(n, align_corners, device):
    if align_corners:
        return torch.linspace(-1.0, 1.0, n, dtype=torch.float64,
                              device=device)
    half = 1.0 - 1.0 / n
    return torch.linspace(-half, half, n, dtype=torch.float64, device=device)


@op("affine_grid")
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``theta`` ``[N, 2, 3]`` -> the sampling grid ``[N, H, W, 2]`` (``[N,
    3, 4]`` -> ``[N, D, H, W, 3]``)."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    out_shape = [int(v) for v in out_shape]
    dev = theta.device
    th = theta.to(torch.float64)
    if tuple(theta.shape[-2:]) == (2, 3):
        _, _, H, W = out_shape
        ys, xs = torch.meshgrid(_lin(H, align_corners, dev),
                                _lin(W, align_corners, dev), indexing="ij")
        base = torch.stack([xs, ys, torch.ones_like(xs)], -1)
        grid = torch.einsum("hwk,njk->nhwj", base, th)
    else:
        _, _, D, H, W = out_shape
        zs, ys, xs = torch.meshgrid(_lin(D, align_corners, dev),
                                    _lin(H, align_corners, dev),
                                    _lin(W, align_corners, dev),
                                    indexing="ij")
        base = torch.stack([xs, ys, zs, torch.ones_like(xs)], -1)
        grid = torch.einsum("dhwk,njk->ndhwj", base, th)
    return grid.to(theta.dtype)


def _reflect(c, size, align_corners):
    if align_corners:
        span = 2.0 * (size - 1)
        c = torch.abs(torch.remainder(c, span))
        return torch.where(c > size - 1, span - c, c)
    m = torch.remainder(torch.abs(c + 0.5), 2.0 * size)
    m = torch.where(m > size, 2.0 * size - m, m)
    return torch.clamp(m - 0.5, 0, size - 1)


@op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW ``x`` at the normalised coordinates of ``grid`` ``[N, Hg,
    Wg, 2]`` (x, then y): ``[N, C, Hg, Wg]``."""
    N, C, H, W = x.shape

    def unnorm(coord, size):
        if align_corners:
            return (coord + 1.0) * (size - 1) / 2.0
        return ((coord + 1.0) * size - 1.0) / 2.0

    gx = unnorm(grid[..., 0], W)
    gy = unnorm(grid[..., 1], H)
    if padding_mode == "border":
        gx = torch.clamp(gx, 0, W - 1)
        gy = torch.clamp(gy, 0, H - 1)
    elif padding_mode == "reflection":
        gx = _reflect(gx, W, align_corners)
        gy = _reflect(gy, H, align_corners)
    batch = torch.arange(N, device=x.device)[:, None, None]

    def tap(ix, iy):
        """``x`` at integer coordinates: ``[N, Hg, Wg, C]``, 0 outside for
        ``"zeros"``."""
        inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        cx = torch.clamp(ix, 0, W - 1).long()
        cy = torch.clamp(iy, 0, H - 1).long()
        val = x.permute(0, 2, 3, 1)[batch, cy, cx]
        if padding_mode == "zeros":
            val = torch.where(inside[..., None], val, 0.0)
        return val

    if mode == "nearest":
        return tap(torch.round(gx), torch.round(gy)).permute(0, 3, 1, 2)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    out = (tap(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
           + tap(x0 + 1, y0) * (wx * (1 - wy))[..., None]
           + tap(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
           + tap(x0 + 1, y0 + 1) * (wx * wy)[..., None])
    return out.permute(0, 3, 1, 2)


@op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift across the ``seg_num`` frames of each clip: the first
    ``shift_ratio`` of the channels from the next frame, the next
    ``shift_ratio`` from the previous one (zeros at the clip's ends), the
    rest in place."""
    v = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    NT, C, H, W = v.shape
    v5 = v.reshape(NT // seg_num, seg_num, C, H, W)
    c1 = int(C * shift_ratio)
    c2 = int(C * 2 * shift_ratio)
    back = torch.cat([v5[:, 1:, :c1], torch.zeros_like(v5[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(v5[:, :1, c1:c2]), v5[:, :-1, c1:c2]],
                    1)
    out = torch.cat([back, fwd, v5[:, :, c2:]], 2).reshape(NT, C, H, W)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
