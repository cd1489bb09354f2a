"""Runtime flags of the port: the one flag it reads, ``use_pallas_attention``
(``paddle_tpu/flags.py:75``, default True), with ``get_flag`` / ``set_flags``
as in the JAX package's registry. ``FLAGS_use_pallas_attention`` in the
environment sets its starting value. The name is the JAX package's; in the
port it selects the hand-written flash kernel (K1) over the plain attention
in ``nn.functional``."""

from __future__ import annotations

import os
from typing import Any, Dict


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "on")


_FLAGS: Dict[str, Any] = {"use_pallas_attention": True}
for _name in _FLAGS:
    if "FLAGS_" + _name in os.environ:
        _FLAGS[_name] = _parse_bool(os.environ["FLAGS_" + _name])


def _key(name: str) -> str:
    name = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
    if name not in _FLAGS:
        raise KeyError(f"unknown flag {name!r} (the port has "
                       f"{sorted(_FLAGS)})")
    return name


def get_flag(name: str) -> Any:
    return _FLAGS[_key(name)]


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags at runtime (``paddle.set_flags``); a string value is
    parsed as the environment's is."""
    for name, value in flags.items():
        _FLAGS[_key(name)] = (_parse_bool(value) if isinstance(value, str)
                              else bool(value))
