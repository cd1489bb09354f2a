"""Device and dtype resolution for the port's entry points.

The port runs on the CUDA device. A caller that names no device gets the
current CUDA device; without a card that is an error, never a silent move
to the CPU. ``device="cpu"`` is an explicit request for the plain PyTorch
versions of the kernels (the CPU tests use it).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` when none is named.

    Raises ``RuntimeError`` when CUDA is asked for (or implied) and no card
    is present, and ``ValueError`` for device types the port does not run
    on."""
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
    """``"float32"``/``"bfloat16"`` (the JAX package's config strings) ->
    torch dtype."""
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r} "
                         f"(supported: {sorted(_DTYPES)})") from None
