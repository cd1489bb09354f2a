"""Runtime flags of the port, with ``get_flag`` / ``get_flags`` /
``set_flags`` as in the JAX package's registry (``paddle_tpu/flags.py``);
``FLAGS_<name>`` in the environment sets a flag's starting value. The port
reads four:

- ``use_pallas_attention`` (:75, default True): the JAX package's name; in
  the port it selects the hand-written flash kernel (K1) over the plain
  attention in ``nn.functional``;
- ``check_nan_inf`` (:72, default False): the op dispatcher checks every
  op's outputs for NaN/Inf (a host read per op);
- ``check_nan_inf_level`` (:73, default 0): 0 raises ``FloatingPointError``
  on a hit, 1 or more warns;
- ``low_precision_op_list`` (:74, default 0): AMP counts the ops it ran in
  low precision (``amp.auto_cast``'s state, ``low_precision_ops``).
"""

from __future__ import annotations

import os
from typing import Any, Dict


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "on")


_FLAGS: Dict[str, Any] = {"use_pallas_attention": True,
                          "check_nan_inf": False, "check_nan_inf_level": 0,
                          "low_precision_op_list": 0}


def _parse(name: str, value):
    """A string as the environment gives it, typed by the flag's default;
    any other value as the flag's type."""
    kind = type(_FLAGS[name])
    if isinstance(value, str):
        return _parse_bool(value) if kind is bool else kind(value)
    return kind(value)


for _name in _FLAGS:
    if "FLAGS_" + _name in os.environ:
        _FLAGS[_name] = _parse(_name, os.environ["FLAGS_" + _name])


def _key(name: str) -> str:
    name = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
    if name not in _FLAGS:
        raise KeyError(f"unknown flag {name!r} (the port has "
                       f"{sorted(_FLAGS)})")
    return name


def get_flag(name: str) -> Any:
    return _FLAGS[_key(name)]


def get_flags(names=None) -> Dict[str, Any]:
    """Current flag values: all flags, or the requested subset."""
    if names is None:
        return dict(_FLAGS)
    if isinstance(names, str):
        names = [names]
    return {n: _FLAGS[_key(n)] for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags at runtime (``paddle.set_flags``); a string value is
    parsed as the environment's is."""
    for name, value in flags.items():
        key = _key(name)
        _FLAGS[key] = _parse(key, value)
