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

Inside a region that ``torch.compile`` or ``torch.export`` traces
(``paddle_tpu_torch.jit``, the static ``Executor``) a ``torch.Generator``
cannot be a graph input, so :func:`generator` returns None there and the
random ops draw from torch's default generator of their device, which
``seed`` reseeds too. :func:`next_host_seed` and :func:`explicitly_seeded`
are the JAX module's: the static Executor seeds each run of a stochastic
program from the first, and the program records the second.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

_LOCK = threading.Lock()
_STATE = {"seed": 0, "seeded": False}
_HOST_COUNTER = [0]
_GENERATORS: Dict[torch.device, torch.Generator] = {}


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device):
    """The global generator of ``device``, seeded from the process seed at
    first use; None inside a traced region (torch's default generator of
    the device serves there) and for the meta device (a static program's
    shape inference)."""
    if torch.compiler.is_compiling():
        return None
    dev = _key(device)
    if dev.type == "meta":
        return None
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
        _STATE["seeded"] = True
        _HOST_COUNTER[0] = 0   # next_host_seed restarts: a reseed reproduces
        for gen in _GENERATORS.values():
            gen.manual_seed(int(s))
    torch.manual_seed(int(s))
    return int(s)


def explicitly_seeded() -> bool:
    """Has ``seed`` been called in this process? A stochastic op recorded
    into a static program without it is not reproducible run to run."""
    return _STATE["seeded"]


def next_host_seed() -> int:
    """A fresh uint32 seed, reproducible under ``seed`` (the static
    Executor seeds each run of a stochastic program from it)."""
    _HOST_COUNTER[0] += 1
    return hash((_STATE["seed"], _HOST_COUNTER[0])) & 0xFFFFFFFF


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
    _STATE["seeded"] = True
