"""Vision transforms: the port of ``paddle_tpu/vision/transforms``, numpy
arrays in and out, CHW (a 2-D array is one channel).  Every random draw
comes from numpy's global generator in the JAX order, so one
``np.random.seed`` gives both packages the same crops, flips and jitters.

``Resize`` is bilinear as ``jax.image.resize(method="bilinear")`` is: a
triangle kernel on half-pixel centres, widened by the scale when it
downsamples (antialiasing), its weights normalised over each output pixel
and zero where the sample falls outside the input.  The port builds the
same weight matrix for each resized axis (``nn.functional.common.
resize_weight_mat``, float64 as the JAX package computes it, cast to
float32) and applies the two as a pair of small matrix products on the
CPU (``torch.matmul``, so a worker's ``torch.set_num_threads(1)`` bounds
its threads); an axis whose size does
not change is left as it is, as ``jax.image.resize`` leaves it.  The
products sum in another order than XLA's einsum: the two agree within
1e-5 on [0, 1] images, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ...nn.functional.common import resize_weight_mat


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        a = np.asarray(img, np.float32)
        if a.max() > 1.5:
            a = a / 255.0
        if a.ndim == 2:
            a = a[None]
        elif a.ndim == 3 and a.shape[-1] in (1, 3, 4) and self.data_format == "CHW":
            a = a.transpose(2, 0, 1)
        return a


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, img):
        return (np.asarray(img, np.float32) - self.mean) / self.std


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        a = np.asarray(img, np.float32)
        h, w = a.shape[-2:]
        oh, ow = self.size
        if h == oh and w == ow:
            return a
        t = torch.from_numpy(np.require(a, np.float32, ("C", "W")))
        if h != oh:
            t = torch.matmul(torch.from_numpy(
                resize_weight_mat(h, oh, "linear").astype(np.float32).T), t)
        if w != ow:
            t = torch.matmul(t, torch.from_numpy(
                resize_weight_mat(w, ow, "linear").astype(np.float32)))
        return t.numpy()


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(np.asarray(img)[..., ::-1])
        return img


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        a = np.asarray(img)
        if self.padding:
            pads = [(0, 0)] * (a.ndim - 2) + [(self.padding, self.padding)] * 2
            a = np.pad(a, pads)
        h, w = a.shape[-2:]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return a[..., i : i + th, j : j + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        a = np.asarray(img)
        h, w = a.shape[-2:]
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return a[..., i : i + th, j : j + tw]


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


# ---------------------------------------------------------------------------
# round-2 completion of the transforms surface
# (``python/paddle/vision/transforms/transforms.py`` + ``functional.py``).
# Convention: CHW float arrays (ToTensor output); photometric math follows
# the ITU-R 601 luma weights the reference uses.
# ---------------------------------------------------------------------------

_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


class BaseTransform:
    """(transforms.py BaseTransform) keys-aware base; subclasses implement
    ``_apply_image`` (and optionally ``_apply_*`` for other keys)."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, image):
        return image

    def __call__(self, inputs):
        if isinstance(inputs, (list, tuple)) and len(self.keys) > 1:
            out = []
            for key, data in zip(self.keys, inputs):
                fn = getattr(self, f"_apply_{key}", None)
                out.append(fn(data) if fn else data)
            return tuple(out)
        return self._apply_image(inputs)


def _chw(img):
    a = np.asarray(img, np.float32)
    return a[None] if a.ndim == 2 else a


def hflip(img):
    return np.ascontiguousarray(np.asarray(img)[..., ::-1])


def vflip(img):
    return np.ascontiguousarray(np.asarray(img)[..., ::-1, :])


def crop(img, top, left, height, width):
    return np.asarray(img)[..., top:top + height, left:left + width]


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def pad(img, padding, fill=0, padding_mode="constant"):
    a = np.asarray(img)
    if isinstance(padding, int):
        pl = pr = pt = pb = padding
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    pads = [(0, 0)] * (a.ndim - 2) + [(pt, pb), (pl, pr)]
    if padding_mode == "constant":
        return np.pad(a, pads, constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    return np.pad(a, pads, mode=mode)


def _value_range(img):
    """255 for integer dtypes, 1 for floats — by DTYPE, never by content
    (a dark uint8 frame must not be misclassified as [0,1])."""
    return 255.0 if np.issubdtype(np.asarray(img).dtype, np.integer) else 1.0


def adjust_brightness(img, brightness_factor):
    return np.clip(_chw(img) * brightness_factor, 0.0, _value_range(img))


def adjust_contrast(img, contrast_factor):
    a = _chw(img)
    mean = (a[:3] * _LUMA[:a.shape[0], None, None]).sum(0).mean() \
        if a.shape[0] >= 3 else a.mean()
    hi = _value_range(img)
    return np.clip((a - mean) * contrast_factor + mean, 0.0, hi)


def adjust_saturation(img, saturation_factor):
    a = _chw(img)
    gray = (a[:3] * _LUMA[:, None, None]).sum(0, keepdims=True)
    hi = _value_range(img)
    return np.clip((a - gray) * saturation_factor + gray, 0.0, hi)


def adjust_hue(img, hue_factor):
    """Rotate hue by hue_factor (in [-0.5, 0.5] turns) via HSV."""
    a = _chw(img)
    hi = _value_range(img)
    rgb = (a[:3] / hi).transpose(1, 2, 0)
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4)) / 6
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out.transpose(2, 0, 1) * hi


def to_grayscale(img, num_output_channels=1):
    a = _chw(img)
    gray = (a[:3] * _LUMA[:, None, None]).sum(0, keepdims=True)
    return np.repeat(gray, num_output_channels, 0)


def erase(img, i, j, h, w, v, inplace=False):
    a = np.asarray(img) if inplace else np.asarray(img).copy()
    v = np.asarray(v, a.dtype)
    if v.ndim == 1:  # per-channel values fill along C, not W
        v = v[:, None, None]
    a[..., i:i + h, j:j + w] = v
    return a


def _inverse_warp(a, M_inv, out_h=None, out_w=None, fill=0.0):
    """Bilinear inverse warp of CHW image with 3x3 matrix (dst->src)."""
    C, H, W = a.shape
    oh, ow = out_h or H, out_w or W
    ys, xs = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], 0).reshape(3, -1).astype(np.float64)
    src = M_inv @ pts
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    wx = sx - x0
    wy = sy - y0

    def tap(yi, xi):
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        val = a[:, np.clip(yi, 0, H - 1).astype(np.int32),
                np.clip(xi, 0, W - 1).astype(np.int32)]
        return np.where(inb[None], val, fill)

    out = (tap(y0, x0) * ((1 - wy) * (1 - wx))[None]
           + tap(y0 + 1, x0) * (wy * (1 - wx))[None]
           + tap(y0, x0 + 1) * ((1 - wy) * wx)[None]
           + tap(y0 + 1, x0 + 1) * (wy * wx)[None])
    return out.reshape(C, oh, ow).astype(a.dtype)


def _affine_matrix(angle, translate, scale, shear, center):
    cx, cy = center
    rot = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in (shear if isinstance(shear, (list, tuple))
                                      else (shear, 0.0)))
    # forward: T(center) R S Sh T(-center) T(translate)
    a = np.cos(rot - sy) / max(np.cos(sy), 1e-9)
    b = -np.cos(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-9) - np.sin(rot)
    c = np.sin(rot - sy) / max(np.cos(sy), 1e-9)
    d = -np.sin(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-9) + np.cos(rot)
    M = np.array([[a * scale, b * scale, 0.0],
                  [c * scale, d * scale, 0.0],
                  [0.0, 0.0, 1.0]])
    T1 = np.array([[1, 0, cx + translate[0]], [0, 1, cy + translate[1]],
                   [0, 0, 1.0]])
    T2 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    return T1 @ M @ T2


def affine(img, angle, translate, scale, shear, interpolation="bilinear",
           fill=0, center=None):
    a = _chw(np.asarray(img, np.float32))
    H, W = a.shape[-2:]
    ctr = center or ((W - 1) / 2, (H - 1) / 2)
    M = _affine_matrix(angle, translate, scale, shear, ctr)
    return _inverse_warp(a, np.linalg.inv(M), fill=fill)


def rotate(img, angle, interpolation="bilinear", expand=False, center=None,
           fill=0):
    if not expand:
        return affine(img, angle, (0, 0), 1.0, (0.0, 0.0), fill=fill,
                      center=center)
    # expand: enlarge the canvas so the whole rotated image fits
    a = _chw(np.asarray(img, np.float32))
    H, W = a.shape[-2:]
    rad = np.deg2rad(angle)
    c, s = abs(np.cos(rad)), abs(np.sin(rad))
    oh = int(np.ceil(H * c + W * s))
    ow = int(np.ceil(W * c + H * s))
    ctr = center or ((W - 1) / 2, (H - 1) / 2)
    M = _affine_matrix(angle, (0, 0), 1.0, (0.0, 0.0), ctr)
    # shift so the rotated content is centered in the new canvas
    shift = np.array([[1, 0, (ow - W) / 2], [0, 1, (oh - H) / 2],
                      [0, 0, 1.0]])
    return _inverse_warp(a, np.linalg.inv(shift @ M), out_h=oh, out_w=ow,
                         fill=fill)


def perspective(img, startpoints, endpoints, interpolation="bilinear",
                fill=0):
    """Warp so ``startpoints`` (4 corner pts, (x, y)) map to ``endpoints``."""
    a = _chw(np.asarray(img, np.float32))
    src = np.asarray(startpoints, np.float64)
    dst = np.asarray(endpoints, np.float64)
    # solve the 8-dof homography dst -> src (inverse warp)
    A, bvec = [], []
    for (xd, yd), (xs, ys) in zip(dst, src):
        A.append([xd, yd, 1, 0, 0, 0, -xs * xd, -xs * yd])
        bvec.append(xs)
        A.append([0, 0, 0, xd, yd, 1, -ys * xd, -ys * yd])
        bvec.append(ys)
    h = np.linalg.solve(np.asarray(A), np.asarray(bvec))
    M_inv = np.array([[h[0], h[1], h[2]], [h[3], h[4], h[5]],
                      [h[6], h[7], 1.0]])
    return _inverse_warp(a, M_inv, fill=fill)


class Transpose(BaseTransform):
    """(transforms.py Transpose) HWC -> CHW."""

    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return np.asarray(img).transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self._args = (padding, fill, padding_mode)

    def _apply_image(self, img):
        return pad(img, *self._args)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if np.random.rand() < self.prob else img


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """(transforms.py ColorJitter) random order of the four photometric
    transforms, like the reference."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self._ts = [BrightnessTransform(brightness),
                    ContrastTransform(contrast),
                    SaturationTransform(saturation), HueTransform(hue)]

    def _apply_image(self, img):
        for i in np.random.permutation(len(self._ts)):
            img = self._ts[i]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.n = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.n)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="bilinear", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        self.degrees = ((-degrees, degrees) if np.isscalar(degrees)
                        else tuple(degrees))
        self.center, self.fill = center, fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="bilinear", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = ((-degrees, degrees) if np.isscalar(degrees)
                        else tuple(degrees))
        self.translate, self.scale_rng = translate, scale
        self.shear, self.fill, self.center = shear, fill, center

    def _apply_image(self, img):
        a = _chw(np.asarray(img, np.float32))
        H, W = a.shape[-2:]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * W
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * H
        sc = (np.random.uniform(*self.scale_rng) if self.scale_rng else 1.0)
        sh = 0.0
        if self.shear is not None:
            shr = ((-self.shear, self.shear) if np.isscalar(self.shear)
                   else tuple(self.shear[:2]))
            sh = np.random.uniform(*shr)
        return affine(a, angle, (tx, ty), sc, (sh, 0.0), fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="bilinear", fill=0, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.fill = prob, distortion_scale, fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        a = _chw(np.asarray(img, np.float32))
        H, W = a.shape[-2:]
        d = self.scale
        def jitter(x, y):
            return (x + np.random.uniform(-d, d) * W / 2,
                    y + np.random.uniform(-d, d) * H / 2)
        start = [(0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)]
        end = [jitter(*p) for p in start]
        return perspective(a, start, end, fill=self.fill)


class RandomResizedCrop(BaseTransform):
    """(transforms.py RandomResizedCrop) random area/aspect crop → resize."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale, self.ratio = scale, ratio

    def _apply_image(self, img):
        a = _chw(np.asarray(img, np.float32))
        H, W = a.shape[-2:]
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                i = np.random.randint(0, H - h + 1)
                j = np.random.randint(0, W - w + 1)
                return resize(a[..., i:i + h, j:j + w], self.size)
        return resize(CenterCrop(min(H, W))(a), self.size)


class RandomErasing(BaseTransform):
    """(transforms.py RandomErasing) random rectangle filled with value or
    noise."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        a = np.asarray(img)
        H, W = a.shape[-2:]
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.random.uniform(*self.ratio)
            h = int(round(np.sqrt(target * ar)))
            w = int(round(np.sqrt(target / ar)))
            if h < H and w < W:
                i = np.random.randint(0, H - h + 1)
                j = np.random.randint(0, W - w + 1)
                v = (np.random.standard_normal((a.shape[0], h, w))
                     if isinstance(self.value, str) and self.value == "random"
                     else self.value)
                return erase(a, i, j, h, w, v, self.inplace)
        return img
