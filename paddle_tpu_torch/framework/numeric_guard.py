"""The numeric health word — port of ``paddle_tpu/framework/
numeric_guard.py``.

- the device half: :func:`guard_step` folds every gradient's nan/inf
  test, the loss's finiteness and an EMA/deviation loss-spike detector
  into one int32 *health word* on the engine's device, advancing a
  three-float state (``[loss_ema, dev_ema, n_healthy]``) only on healthy
  steps. It reads nothing on the host: the caller reads the word once a
  step, as the JAX package's caller does. :class:`GuardPolicy` says what
  the host does about a non-zero word, :class:`NumericAnomalyError` is
  the typed abort, and ``INJECT_*`` are the fault plan's in-step codes.
- the eager half: one process-wide word into which every eager detection
  channel reports (the op dispatcher's nan/inf check and the AMP loss
  scaler's overflow scan); ``consume_health`` reads and clears it.
- :class:`BadBatchRecorder` dumps an offending batch to
  ``<root>/step_<n>/`` (``batch.npz``, then ``meta.json`` last and
  atomically), byte for byte the JAX package's format, so a capture of
  either package replays in the other.

Bits and codes, with the JAX package's values:

=========  ===  ==========  ================================================
bit        val  code        meaning
=========  ===  ==========  ================================================
NAN_GRAD   1    PT-NUM-001  NaN in gradients (or eager op outputs)
INF_GRAD   2    PT-NUM-002  Inf in gradients (or eager op outputs)
NAN_LOSS   4    PT-NUM-003  loss is NaN/Inf
SPIKE      8    PT-NUM-004  loss exceeded EMA + k * deviation (post-warmup)
OVERFLOW   16   PT-NUM-005  AMP loss-scale overflow (``found_inf``)
=========  ===  ==========  ================================================
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "NAN_GRAD", "INF_GRAD", "NAN_LOSS", "SPIKE", "OVERFLOW", "ALL_BITS",
    "BIT_NAMES", "BIT_CODES", "describe_health", "health_codes",
    "guard_init_state", "guard_step", "GuardPolicy", "NumericAnomalyError",
    "record_health", "consume_health", "peek_health", "health_events",
    "BadBatchRecorder", "INJECT_NONE", "INJECT_NAN_GRAD",
    "INJECT_LOSS_SPIKE", "SPIKE_INJECT_FACTOR",
]

NAN_GRAD = 1
INF_GRAD = 2
NAN_LOSS = 4
SPIKE = 8
OVERFLOW = 16
ALL_BITS = NAN_GRAD | INF_GRAD | NAN_LOSS | SPIKE | OVERFLOW

BIT_NAMES = {
    NAN_GRAD: "NAN_GRAD",
    INF_GRAD: "INF_GRAD",
    NAN_LOSS: "NAN_LOSS",
    SPIKE: "SPIKE",
    OVERFLOW: "OVERFLOW",
}
BIT_CODES = {
    NAN_GRAD: "PT-NUM-001",
    INF_GRAD: "PT-NUM-002",
    NAN_LOSS: "PT-NUM-003",
    SPIKE: "PT-NUM-004",
    OVERFLOW: "PT-NUM-005",
}

# the fault plan's in-step codes (``distributed.resilience.faults.
# numeric_inject_code`` maps the actions nan_grad / loss_spike onto them)
INJECT_NONE = 0
INJECT_NAN_GRAD = 1
INJECT_LOSS_SPIKE = 2
SPIKE_INJECT_FACTOR = 1024.0


def describe_health(word: int) -> str:
    """``"NAN_GRAD|SPIKE (PT-NUM-001, PT-NUM-004)"`` for a non-zero word."""
    word = int(word)
    if not word:
        return "healthy"
    names = [n for b, n in BIT_NAMES.items() if word & b]
    codes = [c for b, c in BIT_CODES.items() if word & b]
    return "|".join(names) + " (" + ", ".join(codes) + ")"


def health_codes(word: int) -> List[str]:
    return [c for b, c in BIT_CODES.items() if int(word) & b]


# ---------------------------------------------------------------------------
# the device half
# ---------------------------------------------------------------------------

def guard_init_state(device=None) -> torch.Tensor:
    """Fresh spike-detector state: ``[loss_ema, dev_ema, n_healthy]``."""
    return torch.zeros((3,), dtype=torch.float32, device=device)


def grad_flags(grads) -> torch.Tensor:
    """``[has_nan, has_inf]`` (int32, on the gradients' device) over every
    tensor of ``grads``. ``isnan`` / ``isinf`` read bf16 as it is: its
    widening to fp32, which the JAX package does first, is exact."""
    nan = torch.stack([torch.isnan(g).any() for g in grads]).any()
    inf = torch.stack([torch.isinf(g).any() for g in grads]).any()
    return torch.stack([nan, inf]).to(torch.int32)


def guard_step(loss, grads, state, *, spike_factor: float = 10.0,
               warmup_steps: int = 5, ema_beta: float = 0.9,
               reduce_flags: Optional[Callable] = None):
    """The step's health word and the detector's next state, ``(word,
    state')``, both on the device (JAX :108-160; nothing is read on the
    host). ``grads`` may be each rank's local shards: ``reduce_flags``
    then ORs the ``[has_nan, has_inf]`` flags over the ranks (an
    all-reduce of two ints), so every rank computes the same word. The
    detector advances only on healthy steps, so an anomalous loss never
    poisons its own threshold."""
    loss32 = loss.detach().float()
    finite = torch.isfinite(loss32)
    flags = grad_flags(grads)
    if reduce_flags is not None:
        flags = reduce_flags(flags)
    ema, dev, n = state[0], state[1], state[2]
    warm = n >= float(warmup_steps)
    # deviation floor: a flat loss must not make every wiggle a spike
    dev_floor = torch.maximum(dev, 0.01 * ema.abs() + 1e-6)
    spike = warm & finite & (loss32 > ema + float(spike_factor) * dev_floor)
    word = (flags[0] * NAN_GRAD + flags[1] * INF_GRAD
            + (~finite).to(torch.int32) * NAN_LOSS
            + spike.to(torch.int32) * SPIKE)
    healthy = word == 0
    first = n == 0
    beta = float(ema_beta)
    upd_ema = torch.where(first, loss32, beta * ema + (1.0 - beta) * loss32)
    upd_dev = torch.where(first, torch.zeros_like(dev),
                          beta * dev + (1.0 - beta) * (loss32 - ema).abs())
    new_state = torch.stack([torch.where(healthy, upd_ema, ema),
                             torch.where(healthy, upd_dev, dev),
                             n + healthy.to(torch.float32)])
    return word, new_state


@dataclasses.dataclass
class GuardPolicy:
    """What to do when the health word is non-zero (JAX :167-206).

    ``action`` is the first response; SKIP_STEP escalates to ROLLBACK once
    more than ``max_skips_per_window`` anomalies land inside ``window``
    steps, and ROLLBACK escalates to ABORT after ``max_rollbacks``. After a
    rollback the learning rate re-warms linearly over ``rewarm_steps``
    steps (0 = no re-warm).
    """

    WARN = "warn"
    SKIP_STEP = "skip_step"
    ROLLBACK = "rollback"
    ABORT = "abort"

    action: str = "skip_step"
    max_skips_per_window: int = 3
    window: int = 100
    max_rollbacks: int = 3
    rewarm_steps: int = 0
    spike_factor: float = 10.0
    warmup_steps: int = 5
    record_bad_batches: bool = True

    def __post_init__(self):
        if self.action not in (self.WARN, self.SKIP_STEP, self.ROLLBACK,
                               self.ABORT):
            raise ValueError(f"unknown guard action {self.action!r}")

    @property
    def skip_mask(self) -> int:
        """Bits that leave the update unapplied. WARN observes only: the
        anomalous update is applied; every other action protects state."""
        return 0 if self.action == self.WARN else ALL_BITS


class NumericAnomalyError(RuntimeError):
    """A numeric anomaly escalated past its policy (ABORT, or budgets
    exhausted). Carries the health ``word`` and its PT-NUM ``codes``."""

    def __init__(self, word: int, step: Optional[int] = None,
                 detail: str = ""):
        self.word = int(word)
        self.step = step
        self.codes = health_codes(word)
        at = f" at step {step}" if step is not None else ""
        extra = f": {detail}" if detail else ""
        super().__init__(
            f"numeric anomaly{at}: {describe_health(word)}{extra}")


# ---------------------------------------------------------------------------
# the eager half
# ---------------------------------------------------------------------------

_EAGER_LOCK = threading.Lock()
_EAGER: Dict[str, object] = {"word": 0, "events": []}
_MAX_EVENTS = 256


def record_health(bits: int, source: str = "") -> None:
    """OR ``bits`` into the process-global eager health word (the loss
    scaler's overflow scan and the dispatcher's nan/inf check call it)."""
    with _EAGER_LOCK:
        _EAGER["word"] = int(_EAGER["word"]) | int(bits)
        ev: List = _EAGER["events"]  # type: ignore[assignment]
        if len(ev) < _MAX_EVENTS:
            ev.append((int(bits), source))


def report_nan_inf(num_nan: int, num_inf: int, source: str = "") -> int:
    """Map host-side nan/inf counts onto the PT-NUM-001/002 bits and record
    them. Returns the bits (0 when both counts are zero)."""
    bits = (NAN_GRAD if num_nan else 0) | (INF_GRAD if num_inf else 0)
    if bits:
        record_health(bits, source)
    return bits


def consume_health() -> int:
    """Read-and-clear the eager health word (one consumer per step)."""
    with _EAGER_LOCK:
        word = int(_EAGER["word"])
        _EAGER["word"] = 0
        _EAGER["events"] = []
    return word


def peek_health() -> int:
    with _EAGER_LOCK:
        return int(_EAGER["word"])


def health_events() -> List[Tuple[int, str]]:
    with _EAGER_LOCK:
        return list(_EAGER["events"])  # type: ignore[arg-type]


# ---------------------------------------------------------------------------
# bad-batch capture
# ---------------------------------------------------------------------------

def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


class BadBatchRecorder:
    """Dump an offending batch for offline replay (JAX :273-329).

    Each capture lands in ``<root>/step_<n>/`` as ``batch.npz`` (the host
    arrays) plus ``meta.json`` (step, health word, bit names, PT-NUM codes,
    rng seed, free-form extra), written last and atomically.
    ``distributed.resilience.replay`` re-runs the pair.
    """

    def __init__(self, root: str):
        self.root = str(root)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step):08d}")

    def record(self, step: int, word: int, arrays: Dict[str, object], *,
               rng_seed: Optional[int] = None, extra: Optional[dict] = None
               ) -> str:
        d = self._dir(step)
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "batch.npz"),
                 **{k: _host_array(v) for k, v in arrays.items()})
        meta = {
            "step": int(step),
            "health_word": int(word),
            "bits": [n for b, n in BIT_NAMES.items() if int(word) & b],
            "codes": health_codes(word),
            "rng_seed": rng_seed,
            "arrays": sorted(arrays),
            "extra": extra or {},
        }
        tmp = os.path.join(d, ".meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(d, "meta.json"))   # lands last
        return d

    def steps(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.root, name, "meta.json")):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    pass
        return sorted(out)

    def load(self, step: int) -> Tuple[dict, Dict[str, np.ndarray]]:
        d = self._dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "batch.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return meta, arrays
