"""Vision transforms — port of ``paddle_tpu/vision/transforms`` (:10-180):
a numpy HWC pipeline on the host. The random ones draw from numpy's global
RNG as the JAX package's do, so one ``np.random.seed`` gives both packages
the same crops and flips. ``Resize`` is ``jax.image.resize``'s linear
(antialiased triangle) filter written in numpy. ``to_tensor`` and
``normalize`` return CPU torch tensors.

The breadth transforms (``ColorJitter``, ``RandomResizedCrop``, ``rotate``
...) draw from the JAX package's host seed stream, which has no port yet:
they raise, naming the slice that brings them."""

from __future__ import annotations

import numpy as np

import torch

from ..._later import later_slice


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


_LATER = ("crop", "vflip", "pad", "adjust_brightness", "adjust_contrast",
          "adjust_saturation", "adjust_hue", "to_grayscale", "rotate",
          "affine", "perspective", "erase", "SaturationTransform",
          "ContrastTransform", "HueTransform", "ColorJitter", "Pad",
          "RandomResizedCrop", "RandomRotation", "RandomAffine",
          "RandomPerspective", "Grayscale", "RandomErasing")


def __getattr__(name):
    if name in _LATER:
        raise later_slice(f"paddle_tpu_torch.vision.transforms.{name}",
                          "Paddle API surface", "8",
                          " (with the host seed stream it draws from)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
