"""Vision transforms — port of ``paddle_tpu/vision/transforms`` (:10-180):
a numpy HWC pipeline on the host. The random ones draw from numpy's global
RNG as the JAX package's do, so one ``np.random.seed`` gives both packages
the same crops and flips. ``Resize`` is ``jax.image.resize``'s linear
(antialiased triangle) filter written in numpy. ``to_tensor`` and
``normalize`` return CPU torch tensors.

The breadth transforms (``ColorJitter``, ``RandomResizedCrop``, ``rotate``
...; JAX :183 on) are the JAX package's numpy code; the random ones draw
from ``numpy.random.default_rng(next_host_seed())``, the JAX package's
host seed stream (``framework.random``), so under one ``paddle.seed``
their outputs are byte-equal to JAX's. The geometric ones sample nearest,
as in JAX; another ``interpolation`` raises."""

from __future__ import annotations

import numpy as np

import torch

from ...framework.random import next_host_seed


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(np.asarray(img))


class ToTensor(BaseTransform):
    """HWC uint8 -> CHW float32 in [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        arr = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img.astype(np.float32)
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m = self.mean.reshape(1, 1, -1)
            s = self.std.reshape(1, 1, -1)
        return (img - m) / s


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[0] < img.shape[-1]
        arr = np.asarray(img, np.float32)
        if chw:
            new_shape = (arr.shape[0],) + self.size
        elif arr.ndim == 3:
            new_shape = self.size + (arr.shape[2],)
        else:
            new_shape = self.size
        out = _linear_resize(arr, new_shape)
        return out.astype(img.dtype if img.dtype != np.uint8 else np.float32)


def _triangle_weights(n_in, n_out):
    """[n_in, n_out] fp32 weights of ``jax.image.resize``'s "linear"
    method along one axis: a triangle kernel widened by the downscale
    factor (antialias), each column normalised, zero outside the input."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _linear_resize(arr, shape):
    """``jax.image.resize(arr, shape, "linear")`` in numpy (fp32): each axis
    whose size changes is contracted with its weight matrix."""
    for d, (n_in, n_out) in enumerate(zip(arr.shape, shape)):
        if n_in != n_out:
            arr = np.moveaxis(np.tensordot(arr, _triangle_weights(n_in, n_out),
                                           axes=([d], [0])), -1, d)
    return arr.astype(np.float32)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return img[:, ::-1].copy() if img.ndim == 2 else np.flip(img, axis=-2 if img.shape[0] in (1, 3) else 1).copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return np.flip(img, axis=0 if img.ndim == 2 else (1 if img.shape[0] in (1, 3) else 0)).copy()
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0, padding_mode="constant"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3)
        h_ax, w_ax = (1, 2) if chw else (0, 1)
        arr = img
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) else [self.padding] * 2
            width = [(0, 0)] * arr.ndim
            width[h_ax] = (p[0], p[0])
            width[w_ax] = (p[1] if len(p) > 1 else p[0],) * 2
            arr = np.pad(arr, width)
        th, tw = self.size
        h, w = arr.shape[h_ax], arr.shape[w_ax]
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        sl = [slice(None)] * arr.ndim
        sl[h_ax] = slice(i, i + th)
        sl[w_ax] = slice(j, j + tw)
        return arr[tuple(sl)]


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3)
        h_ax, w_ax = (1, 2) if chw else (0, 1)
        th, tw = self.size
        h, w = img.shape[h_ax], img.shape[w_ax]
        i, j = (h - th) // 2, (w - tw) // 2
        sl = [slice(None)] * img.ndim
        sl[h_ax] = slice(i, i + th)
        sl[w_ax] = slice(j, j + tw)
        return img[tuple(sl)]


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = 1 + np.random.uniform(-self.value, self.value)
        return np.clip(img.astype(np.float32) * f, 0, 255).astype(img.dtype)


def to_tensor(pic, data_format="CHW"):
    return torch.from_numpy(ToTensor(data_format)(pic))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = img.numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    return torch.from_numpy(Normalize(mean, std, data_format)._apply_image(arr))


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(np.asarray(img))


def hflip(img):
    return np.flip(np.asarray(img), axis=-2).copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(np.asarray(img))


# ---------------------------------------------------------------------------
# the breadth transforms (JAX :183 on): numpy on the host, random ones
# drawing from the host seed stream
# ---------------------------------------------------------------------------

def _rng():
    """numpy's generator seeded from the host seed stream (the JAX
    package's: ``next_host_seed`` restarts at ``paddle.seed``)."""
    return np.random.default_rng(next_host_seed())


def _nearest_only(fname, interpolation):
    if interpolation != "nearest":
        raise NotImplementedError(
            f"{fname}(interpolation={interpolation!r}): only 'nearest' (the "
            f"JAX package takes the argument and samples nearest)")


def _as_hwc(img):
    """Normalize to HWC for the geometry ops; returns (arr, restore_fn).
    CHW detection mirrors RandomCrop/CenterCrop in this module."""
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[2] not in (1, 3)
    if chw:
        return arr.transpose(1, 2, 0), lambda a: a.transpose(2, 0, 1)
    return arr, lambda a: a


def crop(img, top, left, height, width):
    arr, restore = _as_hwc(img)
    return restore(arr[top:top + height, left:left + width])


def vflip(img):
    arr, restore = _as_hwc(img)
    return restore(arr[::-1].copy())


def pad(img, padding, fill=0, padding_mode="constant"):
    if isinstance(padding, int):
        padding = [padding] * 4
    elif len(padding) == 2:  # (left/right, top/bottom) — reference API form
        padding = [padding[0], padding[1], padding[0], padding[1]]
    l, t, r, b = padding
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if padding_mode == "constant" else {}
    arr, restore = _as_hwc(img)
    cfg = [(t, b), (l, r)] + ([(0, 0)] if arr.ndim == 3 else [])
    return restore(np.pad(arr, cfg, mode=mode, **kw))


def adjust_brightness(img, brightness_factor):
    arr = np.asarray(img).astype(np.float32) * brightness_factor
    return np.clip(arr, 0, 255).astype(np.asarray(img).dtype)


def adjust_contrast(img, contrast_factor):
    arr = np.asarray(img).astype(np.float32)
    mean = arr.mean()
    out = mean + contrast_factor * (arr - mean)
    return np.clip(out, 0, 255).astype(np.asarray(img).dtype)


def adjust_saturation(img, saturation_factor):
    arr = np.asarray(img).astype(np.float32)
    gray = arr.mean(-1, keepdims=True) if arr.ndim == 3 else arr
    out = gray + saturation_factor * (arr - gray)
    return np.clip(out, 0, 255).astype(np.asarray(img).dtype)


def adjust_hue(img, hue_factor):
    """Rotate hue by hue_factor in [-0.5, 0.5] (HSV roundtrip)."""
    arr = np.asarray(img).astype(np.float32) / 255.0
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    mx, mn = arr.max(-1), arr.min(-1)
    diff = mx - mn + 1e-8
    h = np.zeros_like(mx)
    h = np.where(mx == r, ((g - b) / diff) % 6, h)
    h = np.where(mx == g, (b - r) / diff + 2, h)
    h = np.where(mx == b, (r - g) / diff + 4, h)
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-8), 0)
    v = mx
    i = np.floor(h * 6)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = i.astype(np.int32) % 6
    out = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q])], -1)
    return np.clip(out * 255, 0, 255).astype(np.asarray(img).dtype)


def to_grayscale(img, num_output_channels=1):
    arr = np.asarray(img).astype(np.float32)
    gray = arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114
    out = np.repeat(gray[..., None], num_output_channels, -1)
    return out.astype(np.asarray(img).dtype)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotation via inverse-mapped nearest sampling (pure numpy).
    expand=True enlarges the canvas to hold the whole rotated image."""
    _nearest_only("rotate", interpolation)
    arr, restore = _as_hwc(img)
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2, (w - 1) / 2) if center is None else (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    if expand:
        oh = int(np.ceil(abs(h * cos) + abs(w * sin)))
        ow = int(np.ceil(abs(w * cos) + abs(h * sin)))
        ocy, ocx = (oh - 1) / 2, (ow - 1) / 2
    else:
        oh, ow, ocy, ocx = h, w, cy, cx
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    xs = cos * (xx - ocx) + sin * (yy - ocy) + cx
    ys = -sin * (xx - ocx) + cos * (yy - ocy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out_shape = (oh, ow) + arr.shape[2:]
    out = np.full(out_shape, fill, arr.dtype)
    out[valid] = arr[yi[valid], xi[valid]]
    return restore(out)


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", fill=0, center=None):
    """Inverse-mapped affine transform (rotation+translate+scale+shear)."""
    _nearest_only("affine", interpolation)
    arr, restore = _as_hwc(img)
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2, (w - 1) / 2) if center is None else (center[1], center[0])
    rad = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    # forward matrix M = T(center+translate) R S Shear T(-center); invert it
    m00 = scale * (np.cos(rad) + np.tan(sy) * np.sin(rad))
    m01 = scale * (np.tan(sx) * np.cos(rad) + np.sin(rad))
    m10 = scale * (-np.sin(rad) + np.tan(sy) * np.cos(rad))
    m11 = scale * (-np.tan(sx) * np.sin(rad) + np.cos(rad))
    M = np.array([[m00, m01], [m10, m11]], np.float64)
    Minv = np.linalg.inv(M)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dx = xx - cx - translate[0]
    dy = yy - cy - translate[1]
    xs = Minv[0, 0] * dx + Minv[0, 1] * dy + cx
    ys = Minv[1, 0] * dx + Minv[1, 1] * dy + cy
    xi, yi = np.round(xs).astype(np.int64), np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(arr, fill)
    out[valid] = arr[yi[valid], xi[valid]]
    return restore(out)


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    """4-point perspective warp via the homography solve."""
    _nearest_only("perspective", interpolation)
    arr, restore = _as_hwc(img)
    h, w = arr.shape[:2]
    A = []
    for (x, y), (u, v) in zip(endpoints, startpoints):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    B = np.array([c for pt in startpoints for c in pt], np.float64)
    coef = np.linalg.lstsq(np.asarray(A, np.float64), B, rcond=None)[0]
    H = np.append(coef, 1.0).reshape(3, 3)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    denom = H[2, 0] * xx + H[2, 1] * yy + H[2, 2]
    xs = (H[0, 0] * xx + H[0, 1] * yy + H[0, 2]) / denom
    ys = (H[1, 0] * xx + H[1, 1] * yy + H[1, 2]) / denom
    xi, yi = np.round(xs).astype(np.int64), np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(arr, fill)
    out[valid] = arr[yi[valid], xi[valid]]
    return restore(out)


def erase(img, i, j, h, w, v, inplace=False):
    arr, restore = _as_hwc(img)
    arr = arr if inplace else arr.copy()
    arr[i:i + h, j:j + w] = v
    return restore(arr)


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = _rng().uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = _rng().uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, _rng().uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.t = [BrightnessTransform(brightness), ContrastTransform(contrast),
                  SaturationTransform(saturation), HueTransform(hue)]

    def _apply_image(self, img):
        order = _rng().permutation(4)
        for i in order:
            img = self.t[i](img)
        return img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding, self.fill, self.mode = padding, fill, padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.mode)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        if interpolation != "bilinear":
            raise NotImplementedError(
                f"RandomResizedCrop(interpolation={interpolation!r}): only "
                f"'bilinear' (the JAX package takes the argument and "
                f"resizes bilinearly)")
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale, self.ratio = scale, ratio

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        rng = _rng()
        for _ in range(10):
            area = h * w * rng.uniform(*self.scale)
            ar = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(area * ar)))
            ch = int(round(np.sqrt(area / ar)))
            if cw <= w and ch <= h:
                top = rng.integers(0, h - ch + 1)
                left = rng.integers(0, w - cw + 1)
                return resize(crop(arr, top, left, ch, cw), self.size)
        return resize(arr, self.size)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        self.degrees = ((-degrees, degrees) if isinstance(degrees, (int, float))
                        else tuple(degrees))
        self.kw = dict(interpolation=interpolation, expand=expand,
                       center=center, fill=fill)

    def _apply_image(self, img):
        return rotate(img, _rng().uniform(*self.degrees), **self.kw)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None):
        _nearest_only("RandomAffine", interpolation)
        self.degrees = ((-degrees, degrees) if isinstance(degrees, (int, float))
                        else tuple(degrees))
        self.translate, self.scale_rng, self.shear = translate, scale, shear
        self.fill, self.center = fill, center

    def _apply_image(self, img):
        rng = _rng()
        h, w = np.asarray(img).shape[:2]
        angle = rng.uniform(*self.degrees)
        tr = ((rng.uniform(-self.translate[0], self.translate[0]) * w,
               rng.uniform(-self.translate[1], self.translate[1]) * h)
              if self.translate else (0, 0))
        sc = rng.uniform(*self.scale_rng) if self.scale_rng else 1.0
        if self.shear is None:
            sh = (0.0, 0.0)
        elif isinstance(self.shear, (int, float)):
            sh = (rng.uniform(-self.shear, self.shear), 0.0)
        else:  # (min, max) range, or (xmin, xmax, ymin, ymax)
            vals = list(self.shear)
            sh_x = rng.uniform(vals[0], vals[1])
            sh_y = rng.uniform(vals[2], vals[3]) if len(vals) == 4 else 0.0
            sh = (sh_x, sh_y)
        return affine(img, angle, tr, sc, sh, fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0):
        _nearest_only("RandomPerspective", interpolation)
        self.prob, self.d = prob, distortion_scale

    def _apply_image(self, img):
        rng = _rng()
        if rng.uniform() > self.prob:
            return np.asarray(img)
        h, w = np.asarray(img).shape[:2]
        dx, dy = self.d * w / 2, self.d * h / 2
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(rng.uniform(0, dx), rng.uniform(0, dy)),
               (w - 1 - rng.uniform(0, dx), rng.uniform(0, dy)),
               (w - 1 - rng.uniform(0, dx), h - 1 - rng.uniform(0, dy)),
               (rng.uniform(0, dx), h - 1 - rng.uniform(0, dy))]
        return perspective(img, start, end)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.n)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob, self.scale, self.ratio, self.value = prob, scale, ratio, value

    def _apply_image(self, img):
        rng = _rng()
        arr = np.asarray(img)
        if rng.uniform() > self.prob:
            return arr
        h, w = arr.shape[:2]
        for _ in range(10):
            area = h * w * rng.uniform(*self.scale)
            ar = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            eh, ew = int(round(np.sqrt(area / ar))), int(round(np.sqrt(area * ar)))
            if eh < h and ew < w:
                top = rng.integers(0, h - eh)
                left = rng.integers(0, w - ew)
                return erase(arr, top, left, eh, ew, self.value)
        return arr
