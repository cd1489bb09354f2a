"""The model-parallel RNG tracker — port of ``paddle_tpu/distributed/
fleet/meta_parallel/parallel_layers/random.py`` on explicit
``torch.Generator``s.

``rng_state(name)`` runs its block with the port's global generator of
the current device (``framework.random.generator``, which the random ops
and dropout draw from) set to the named state, keeps the advanced state
for the next block, and puts the global state back: the reference's
tracker swaps the CUDA generator's state the same way. The JAX package
splits a key instead; the bits of the two packages never agree, so the
same seeds give each package a reproducible stream of its own.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .....device import resolve_device
from .....framework import random as _random

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_.clear()

    def add(self, name, seed):
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        gen = torch.Generator(device=resolve_device(None))
        gen.manual_seed(int(seed))
        self.states_[name] = gen.get_state()

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        gen = _random.generator(resolve_device(None))
        if name not in self.states_:
            # derived deterministically from the global state and the name
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            self.add(name, seed ^ (abs(hash(name)) % (2 ** 31)))
        outer = gen.get_state()
        gen.set_state(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = gen.get_state()
            gen.set_state(outer)


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None, hcg=None):
    """Reset the tracker with the model-parallel state seeded ``seed +
    1024 + mp_rank`` (``mp_rank``: ``hcg.get_model_parallel_rank()`` when
    a hybrid group is given, else 0)."""
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    base = seed if seed is not None else np.random.randint(0, 2 ** 20)
    _tracker.reset()
    _tracker.add(MODEL_PARALLEL_RNG, base + 1024 + mp_rank)
