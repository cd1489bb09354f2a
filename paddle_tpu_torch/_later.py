"""The port's refusal of a feature that a later slice of the port brings.

Every entry point that the JAX package offers and the port does not yet
raises this ``NotImplementedError``, never accepts the argument and
ignores it.
"""

from __future__ import annotations

from typing import Optional


def later_slice(what: str, slice_name: str, item: Optional[str] = None,
                note: str = "") -> NotImplementedError:
    """The error for ``what``: it names the slice that ports it and, where
    given, its item of ROADMAP Queue 1; ``note`` says what the caller can
    use meanwhile."""
    where = f"ROADMAP Queue 1, item {item}" if item else "ROADMAP Queue 1"
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the {slice_name} slice "
        f"of the port ({where}){note}")
