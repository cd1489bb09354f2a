"""The port's versions — port of ``paddle_tpu/version``: the package's
``full_version`` / ``major`` / ``minor`` / ``patch`` / ``rc`` (from the
installed metadata, else pyproject's), and what it runs on: ``torch``,
``cuda`` (the CUDA torch was built with, None on a CPU build) and
``show()``."""

from __future__ import annotations

import torch as _torch

full_version = "0.2.0"
try:  # installed: the package metadata
    from importlib.metadata import version as _v

    full_version = _v("paddle-tpu")
except Exception:
    pass

_parts = (full_version.split("+")[0].split(".") + ["0", "0", "0"])[:3]
major, minor, patch = _parts[0], _parts[1], _parts[2]
rc = "0"
torch = _torch.__version__
cuda_version = _torch.version.cuda

__all__ = ["full_version", "major", "minor", "patch", "rc", "show", "cuda",
           "torch"]


def cuda():
    """The CUDA version torch was built with, or "False" on a CPU build
    (Paddle's ``version.cuda()``)."""
    return cuda_version if cuda_version is not None else "False"


def show() -> None:
    """Print the versions."""
    print(f"full_version: {full_version}")
    print(f"major: {major}")
    print(f"minor: {minor}")
    print(f"patch: {patch}")
    print(f"rc: {rc}")
    print(f"torch: {torch}")
    print(f"cuda: {cuda()}")
