"""Deterministic fault injection — port of
``paddle_tpu/distributed/resilience/faults.py`` (the serving slice of it).

A :class:`FaultPlan` is a list of :class:`FaultSpec` entries. Each spec
watches one injection *site* (a short dotted name) and fires on the
``at``-th matching event (an event whose detail contains ``match``) for
``count`` events (-1 = every event from ``at`` on). Production code
consults the sites through hooks; with no plan installed each hook is one
global read.

- :func:`maybe_inject` — control-flow faults: ``kill`` (raises
  :class:`FaultInjected`, a ``ConnectionError``), ``stall``/``delay``
  (sleeps ``arg`` seconds), ``error`` (raises ``RuntimeError``).
- :func:`resource_hold` — ``exhaust``: the number of pool units (serving KV
  blocks) to take out of circulation at this event.
- :func:`device_loss` — ``lose``: the number of devices the engine's tp
  group loses at this event.

Sites the port consults:

====================  =====================================================
``serving.block_pool``  serving admission, before block allocation
                        (detail = ``rid:<id>``; ``exhaust`` holds ``arg``
                        free KV blocks)
``serving.step``      serving engine, top of every ``step()`` (detail =
                      ``step:<n>``; ``kill`` crashes the engine mid-wave)
``serving.stall``     same event stream as ``serving.step`` but consulted
                      first (``stall`` hangs the step past its budget)
``device.loss``       serving engine, same event stream (``lose``; the
                      port has no tp mesh, so the engine ignores it)
``fleet.replica_kill``  fleet router, before each replica's supervisor
                        step (detail = ``replica:<i>:step:<n>``)
``fleet.drain``       fleet router, top of every fleet step per replica
                      (same detail; ``kill`` = operator drain signal)
``serving.kv_transfer``  tiered router, each KV-chain artifact in transit
                         (detail = ``rid:<id>``; :func:`corrupt`'s data
                         actions damage the bytes)
====================  =====================================================

Plans, counters and draws work exactly as the JAX package's, so the same
plan over the same event stream fires at the same events (``log``,
``fired()``) in both packages. The port keeps its own installed plan: a
JAX plan and a port plan are installed independently. The data hook
:func:`corrupt` draws from ``plan.rng_for(spec)`` in the JAX package's
order, so one plan damages the same bytes in both packages. The wire and
numeric hooks (``wire_faults``, ``numeric_inject_code``,
``poison_arrays``) arrive with the slices that consult them.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import List, Optional, Sequence

__all__ = ["FaultSpec", "FaultPlan", "ComposedFaultPlan", "FaultInjected",
           "maybe_inject", "active_plan", "resource_hold", "device_loss",
           "corrupt"]


class FaultInjected(ConnectionError):
    """Raised by a ``kill`` fault — a ConnectionError so transport-level
    retry paths treat it exactly like a real peer loss / EOF."""


@dataclasses.dataclass
class FaultSpec:
    """One planned fault: ``action`` at the ``at``-th matching event of
    ``site`` (events whose detail contains ``match``), for ``count`` events
    (-1 = every event from ``at`` on)."""

    site: str
    action: str
    at: int = 0
    count: int = 1
    arg: float = 0.0       # seconds (stall/delay) or units (exhaust, lose)
    match: str = ""

    # every action the JAX package knows, so the same specs validate alike
    _CONTROL = ("kill", "stall", "delay", "error")
    _DATA = ("bitflip", "truncate", "garbage")
    _NUMERIC = ("nan_grad", "loss_spike", "poison_batch")
    _RESOURCE = ("exhaust",)
    _NET = ("drop", "duplicate", "torn", "blackhole")
    _DEVICE = ("lose",)

    def __post_init__(self):
        known = (self._CONTROL + self._DATA + self._NUMERIC
                 + self._RESOURCE + self._NET + self._DEVICE)
        if self.action not in known:
            raise ValueError(
                f"unknown fault action {self.action!r} (choose: {known})")


class FaultPlan:
    """Seeded, step-indexed fault schedule.

    >>> plan = FaultPlan(seed=7, specs=[
    ...     FaultSpec("serving.step", "kill", at=3, count=1)])
    >>> with plan:             # hooks consult it inside the block
    ...     ...

    Event counters are per-spec and advance only on matching events; every
    random choice comes from ``random.Random(seed)``.
    """

    def __init__(self, seed: int = 0, specs: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.specs = list(specs)
        self.rng = random.Random(self.seed)
        self.log: List[tuple] = []          # (site, detail, action) fired
        self._counts = [0] * len(self.specs)
        self._lock = threading.Lock()

    def fire(self, site: str, detail: str = "") -> List[FaultSpec]:
        """Advance counters for this event; return the specs due now."""
        due = []
        with self._lock:
            for i, s in enumerate(self.specs):
                if s.site != site or (s.match and s.match not in detail):
                    continue
                idx = self._counts[i]
                self._counts[i] = idx + 1
                if idx >= s.at and (s.count < 0 or idx < s.at + s.count):
                    due.append(s)
                    self.log.append((site, detail, s.action))
        return due

    def rng_for(self, spec: FaultSpec) -> random.Random:
        """The RNG a data hook draws from when ``spec`` fires (one shared
        stream here; :class:`ComposedFaultPlan` gives each spec its own)."""
        return self.rng

    def fired(self) -> dict:
        """``{site: times fired}`` snapshot of the log."""
        with self._lock:
            out = {}
            for site, _detail, _action in self.log:
                out[site] = out.get(site, 0) + 1
            return out

    def install(self) -> "FaultPlan":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class ComposedFaultPlan(FaultPlan):
    """One seeded plan scheduling several fault sites at once, each spec
    drawing from its own stream derived from ``(seed, spec index, site,
    action)``: draws replay in each site's event order whatever the
    threads' interleaving across sites."""

    def __init__(self, seed: int = 0, specs: Sequence[FaultSpec] = ()):
        super().__init__(seed, specs)
        self._spec_rngs = {
            id(s): random.Random(f"{self.seed}:{i}:{s.site}:{s.action}")
            for i, s in enumerate(self.specs)}

    def rng_for(self, spec: FaultSpec) -> random.Random:
        return self._spec_rngs.get(id(spec), self.rng)


_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def maybe_inject(site: str, detail: str = "") -> None:
    """Control-flow hook: no-op without a plan; otherwise sleep/raise per
    the specs due at this event."""
    plan = _ACTIVE
    if plan is None:
        return
    for s in plan.fire(site, detail):
        if s.action in ("stall", "delay"):
            time.sleep(s.arg)
        elif s.action == "kill":
            raise FaultInjected(
                f"fault injected: kill at {site} ({detail})")
        elif s.action == "error":
            raise RuntimeError(f"fault injected: error at {site} ({detail})")
        # data actions at a control-only site are ignored


def corrupt(site: str, detail: str, data: bytes) -> bytes:
    """Data hook (``serving.kv_transfer``): ``data`` with the due data
    faults applied — ``truncate`` drops ``arg`` trailing bytes (half when
    0), ``bitflip`` flips ``arg`` (at least 1) bits in the middle half,
    ``garbage`` replaces every byte; control actions act as in
    :func:`maybe_inject`. No plan -> ``data`` unchanged."""
    plan = _ACTIVE
    if plan is None:
        return data
    for s in plan.fire(site, detail):
        if s.action == "truncate":
            n = int(s.arg) or max(1, len(data) // 2)
            data = data[: max(0, len(data) - n)]
        elif s.action == "bitflip":
            buf = bytearray(data)
            nbits = int(s.arg) or 1
            rng = plan.rng_for(s)
            # the middle half: past container headers, before trailing
            # indexes — the silent-corruption zone
            lo, hi = len(buf) // 4, max(len(buf) // 4 + 1, (3 * len(buf)) // 4)
            for _ in range(nbits):
                pos = rng.randrange(lo, hi)
                buf[pos] ^= 1 << rng.randrange(8)
            data = bytes(buf)
        elif s.action == "garbage":
            data = bytes(plan.rng_for(s).getrandbits(8)
                         for _ in range(len(data)))
        elif s.action in ("stall", "delay"):
            time.sleep(s.arg)
        elif s.action == "kill":
            raise FaultInjected(
                f"fault injected: kill at {site} ({detail})")
        elif s.action == "error":
            raise RuntimeError(f"fault injected: error at {site} ({detail})")
    return data


def resource_hold(site: str, detail: str = "") -> int:
    """Resource hook: pool units (serving KV blocks) the due ``exhaust``
    specs remove from circulation at this event. No plan -> 0."""
    plan = _ACTIVE
    if plan is None:
        return 0
    total = 0
    for s in plan.fire(site, detail):
        if s.action == "exhaust":
            total += max(0, int(s.arg))
    return total


def device_loss(detail: str = "") -> int:
    """Device-loss hook (``device.loss``): devices the due ``lose`` specs
    remove from the engine's tp group at this event. No plan -> 0."""
    plan = _ACTIVE
    if plan is None:
        return 0
    total = 0
    for s in plan.fire("device.loss", detail):
        if s.action == "lose":
            total += max(0, int(s.arg))
    return total
