"""The JAX package's scalar promotion, written out for torch.

The optimizers' update rules are shared between two callers that type
their scalars differently, and torch's own rules match neither:

- eager ``Optimizer.step()`` passes ``lr`` as a Python float. JAX types a
  Python number *weakly*: it takes the dtype of the array it meets, so
  ``0.37 * g_bf16`` rounds 0.37 to bf16 (0.369140625) before the product.
  torch keeps the scalar at full precision and rounds only the product;
- the jitted hapi and Engine steps pass ``lr`` (and the step count) as
  *strong* fp32 scalars: ``lr * g_bf16`` promotes to fp32 in JAX, while
  torch keeps a 0-dim fp32 tensor times a bf16 tensor in bf16.

:func:`scale` computes ``s * x`` as JAX types it, for either kind of ``s``.
"""

from __future__ import annotations

import torch

_LOW = (torch.bfloat16, torch.float16)


def weak(s, like: torch.Tensor):
    """A Python number ``s`` as JAX's weak type meets ``like``: rounded to
    ``like``'s dtype when that is a 16-bit float (fp32 tensors already
    take the scalar in fp32 in torch). A tensor passes unchanged."""
    if isinstance(s, torch.Tensor) or like.dtype not in _LOW:
        return s
    return torch.tensor(s, dtype=like.dtype).item()


def scale(s, x: torch.Tensor) -> torch.Tensor:
    """``s * x`` under JAX's promotion: a Python ``s`` is weak (rounded to
    ``x``'s dtype first); a tensor ``s`` is strong and promotes ``x`` to
    their common dtype (a bf16 ``x`` times an fp32 scalar is fp32)."""
    if isinstance(s, torch.Tensor):
        return s * x.to(torch.promote_types(s.dtype, x.dtype))
    return weak(s, x) * x
