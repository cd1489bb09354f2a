"""paddle_tpu_torch — the PyTorch and CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors its
module paths and names, runs PyTorch on an NVIDIA H100, and replaces each
Pallas TPU kernel with a kernel written by hand for Hopper (CUDA C++ built
from ``ops/csrc`` at first use). It imports ``torch`` and never ``jax`` or
``paddle_tpu``.

Entry points (model construction, ``_init_paged_caches`` and the serving
engine) run on the CUDA device unless the caller passes ``device="cpu"``,
which runs every kernel's plain PyTorch version instead; the training
``distributed.Engine`` runs where its model lives.
"""

from __future__ import annotations

from .device import resolve_device, resolve_dtype  # noqa: F401

__all__ = ["resolve_device", "resolve_dtype"]
