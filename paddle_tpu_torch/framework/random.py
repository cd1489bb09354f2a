"""The global random state — port of ``paddle_tpu/framework/random.py``
(``seed``, ``get_rng_state``, ``set_rng_state``) on explicit
``torch.Generator``s.

The port keeps one generator per device, created at first use from the
process seed (0 until ``seed`` sets another, as the JAX package's key).
``paddle_tpu_torch.tensor.random`` and the dropout functionals draw from
the generator of their result's device. The bits cannot equal
``jax.random``'s (threefry keys against torch's Philox and CPU engines):
the same seed gives a reproducible run of each package, not the same
numbers.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

_LOCK = threading.Lock()
_STATE = {"seed": 0}
_GENERATORS: Dict[torch.device, torch.Generator] = {}


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device) -> torch.Generator:
    """The global generator of ``device``, seeded from the process seed at
    first use."""
    dev = _key(device)
    with _LOCK:
        gen = _GENERATORS.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(_STATE["seed"])
            _GENERATORS[dev] = gen
    return gen


def seed(s: int) -> int:
    """``paddle.seed``: reseed every device's generator (and those made
    later) with ``s``."""
    with _LOCK:
        _STATE["seed"] = int(s)
        for gen in _GENERATORS.values():
            gen.manual_seed(int(s))
    return int(s)


def get_rng_state():
    """{device: generator state} of every generator made so far (the
    state ``set_rng_state`` restores)."""
    with _LOCK:
        return {str(dev): gen.get_state()
                for dev, gen in _GENERATORS.items()}


def set_rng_state(state) -> None:
    """Restore states from :func:`get_rng_state`."""
    for dev, s in state.items():
        generator(dev).set_state(s)
