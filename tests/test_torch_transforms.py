"""The port's breadth transforms (the 23 names of JAX
``vision/transforms/__init__.py`` :183 on) against the JAX package's, on
the same seeded uint8 images, HWC and CHW: the functional forms on fixed
arguments, the random classes after the same ``paddle.seed`` on both
sides (both draw from numpy seeded by the host seed stream; the
brightness part of ``ColorJitter`` from numpy's global generator, seeded
alike). Every output
is byte-equal (same dtype, same shape, same bytes), except that
``RandomResizedCrop`` resizes its (byte-equal) crop with ``Resize``, the
numpy form of ``jax.image.resize``, which is held within rtol 1e-6
(tests/test_torch_io.py: the same filter, other rounding).
"""

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch as pt
import paddle_tpu_torch.vision.transforms as TT

IMG = np.random.default_rng(0).integers(0, 256, (12, 16, 3)).astype(
    np.uint8)
CHW = np.ascontiguousarray(IMG.transpose(2, 0, 1))

FUNCS = [
    ("crop", (2, 3, 5, 7), {}),
    ("vflip", (), {}),
    ("pad", (2,), {}),
    ("pad", ([1, 2],), {"padding_mode": "reflect"}),
    ("pad", ([1, 2, 3, 4],), {"fill": 9}),
    ("adjust_brightness", (1.4,), {}),
    ("adjust_contrast", (0.6,), {}),
    ("adjust_saturation", (1.7,), {}),
    ("adjust_hue", (0.2,), {}),
    ("to_grayscale", (3,), {}),
    ("rotate", (30,), {}),
    ("rotate", (-75,), {"expand": True, "fill": 5}),
    ("affine", (20, (2, -1), 0.9, (10.0, 5.0)), {}),
    ("perspective", ([(0, 0), (15, 0), (15, 11), (0, 11)],
                     [(1, 2), (14, 0), (13, 10), (2, 11)]), {}),
    ("erase", (2, 3, 4, 5, 7), {}),
]


@pytest.mark.parametrize("i", range(len(FUNCS)))
def test_functional_byte_equal(i):
    name, args, kw = FUNCS[i]
    imgs = [IMG] if name.startswith(("adjust", "to_gray")) else [IMG, CHW]
    for img in imgs:
        got = getattr(TT, name)(img.copy(), *args, **kw)
        ref = getattr(JT, name)(img.copy(), *args, **kw)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


CLASSES = [
    ("SaturationTransform", (0.5,)), ("ContrastTransform", (0.5,)),
    ("HueTransform", (0.3,)), ("ColorJitter", (0.3, 0.3, 0.3, 0.2)),
    ("Pad", (3,)), ("RandomResizedCrop", (8,)), ("RandomRotation", (40,)),
    ("RandomAffine", (30, (0.1, 0.2), (0.8, 1.2), 10)),
    ("RandomPerspective", (1.0, 0.5)), ("Grayscale", (3,)),
    ("RandomErasing", (1.0,)),
]


@pytest.mark.parametrize("name,args", CLASSES)
def test_random_transforms_byte_equal_under_seed(name, args):
    outs = {}
    for key, P, M in (("jax", jp, JT), ("torch", pt, TT)):
        P.seed(21)
        np.random.seed(21)   # BrightnessTransform draws from numpy's
        t = getattr(M, name)(*args)
        outs[key] = [np.asarray(t(IMG.copy())) for _ in range(3)]
    for got, ref in zip(outs["torch"], outs["jax"]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if name == "RandomResizedCrop":   # the same crop, then Resize
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)


def test_the_23_names_are_there():
    names = ("crop", "vflip", "pad", "adjust_brightness", "adjust_contrast",
             "adjust_saturation", "adjust_hue", "to_grayscale", "rotate",
             "affine", "perspective", "erase", "SaturationTransform",
             "ContrastTransform", "HueTransform", "ColorJitter", "Pad",
             "RandomResizedCrop", "RandomRotation", "RandomAffine",
             "RandomPerspective", "Grayscale", "RandomErasing")
    assert len(names) == 23
    assert all(callable(getattr(TT, n)) for n in names)


def test_other_interpolations_raise():
    with pytest.raises(NotImplementedError, match="nearest"):
        TT.rotate(IMG, 10, interpolation="bilinear")
    with pytest.raises(NotImplementedError, match="bilinear"):
        TT.RandomResizedCrop(8, interpolation="nearest")
