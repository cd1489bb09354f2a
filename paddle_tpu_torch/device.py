"""Device and dtype resolution for the port's entry points.

The port runs on the CUDA device. A caller that names no device gets the
port's current place: the current CUDA device unless
:func:`set_device` ("cpu" or "gpu"/"cuda[:i]", Paddle's
``paddle.set_device``) chose another; without a card the CUDA place is an
error, never a silent move to the CPU. ``device="cpu"`` (or
``set_device("cpu")``) is an explicit request for the plain PyTorch
versions of the kernels (the CPU tests use it).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# the place set by set_device (None: the current CUDA device)
_PLACE: Optional[torch.device] = None


class CPUPlace:
    """Paddle's host place: ``to_tensor(x, place=CPUPlace())``."""

    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace:
    """Paddle's card place: ``CUDAPlace(i)`` is ``cuda:i``."""

    def __init__(self, i=0):
        self.index = int(i)

    def __repr__(self):
        return f"Place(gpu:{self.index})"


class CUDAPinnedPlace:
    """Page-locked host memory: ``to_tensor(data, place=CUDAPinnedPlace())``
    gives a pinned CPU tensor (fast, asynchronous copies to the card)."""

    def __repr__(self):
        return "Place(gpu_pinned)"


class TPUPlace:
    """The JAX package's TPU place; the port runs on no TPU, and a tensor
    asked for there is an error."""

    def __init__(self, i=0):
        self.index = int(i)


def set_device(device: Union[str, torch.device]) -> torch.device:
    """Make ``device`` the port's current place (``paddle.set_device``):
    "cpu", or "gpu"/"cuda" with an optional ":index". Returns it; raises as
    :func:`resolve_device` does for a card that is not there."""
    global _PLACE
    _PLACE = resolve_place(device if device is not None else "cuda")
    return _PLACE


def resolve_place(place=None) -> torch.device:
    """A Paddle ``place`` argument as a device: None is the current place;
    "gpu"/"gpu:i" and ``CUDAPlace(i)`` are CUDA, ``CPUPlace()`` and
    ``CUDAPinnedPlace()`` the CPU; otherwise as :func:`resolve_device`."""
    if isinstance(place, (CPUPlace, CUDAPinnedPlace)):
        place = "cpu"
    elif isinstance(place, CUDAPlace):
        place = f"cuda:{place.index}"
    elif isinstance(place, TPUPlace):
        raise ValueError("TPUPlace: the port runs on CUDA or the CPU")
    if isinstance(place, str) and place.split(":")[0] == "gpu":
        place = "cuda" + place[3:]
    return resolve_device(place)


def get_device() -> str:
    """The current place as Paddle names it: "cpu" or "gpu:<index>"."""
    dev = resolve_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the current place (the CUDA
    device unless :func:`set_device` chose another) when none is named.

    Raises ``RuntimeError`` when CUDA is asked for (or implied) and no card
    is present, and ``ValueError`` for device types the port does not run
    on."""
    if device is None and _PLACE is not None:
        return _PLACE
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def resolve_dtype(dtype: str) -> torch.dtype:
    """``"float32"``/``"bfloat16"``/``"float16"`` (the JAX package's config
    strings) -> torch dtype."""
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r} "
                         f"(supported: {sorted(_DTYPES)})") from None
