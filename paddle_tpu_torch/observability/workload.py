"""Open-loop traffic replay: seeded production-shaped load for the fleet
— port of ``paddle_tpu/observability/workload.py``.

A closed-loop wave (submit, step until drained) can never show queueing
collapse: the generator politely waits for the server. OPEN-loop load
generation (MLPerf-Inference style) is the fix: arrivals follow a fixed
schedule drawn from an arrival process, regardless of server progress, so
a server falling behind grows a real backlog and its TTFT/queue-wait tails
look like production's.

Three pieces, all host-side:

- :class:`WorkloadConfig` + :func:`generate_schedule` — a SEEDED,
  deterministic schedule generator: Poisson / diurnal (sinusoidally
  modulated, via thinning) / burst (square-wave rate multiplier) arrival
  processes, heavy-tailed lognormal prompt/output length draws, and a
  multi-tenant mix where each tenant's requests share a system prefix
  (exercising the radix prefix cache exactly like production system
  prompts do). Same seed ⇒ byte-identical schedule
  (:func:`encode_schedule`), and the same bytes as the JAX package's
  generator: both draw from one ``numpy.random.default_rng`` stream in
  the same order. A schedule is an artifact you can attach to a bug
  report and replay in either package.
- :class:`VirtualClock` — a discrete-event clock the replay driver (and a
  :class:`~paddle_tpu_torch.observability.tracing.TraceRecorder` via its
  ``clock=`` parameter) advances one fixed ``dt`` per fleet step. One
  virtual second means the same thing on every machine, so SLO attainment
  measured against it is reproducible; it models each replica stepping
  once per tick. ``wall_clock=True`` replays against real time instead.
- :class:`ReplayDriver` — feeds the schedule to a
  :class:`~paddle_tpu_torch.inference.fleet.FleetRouter` (or any object
  with ``submit``/``step``/``has_work``) WITHOUT waiting for completions:
  at each tick it submits every arrival whose time has come (a refusal —
  ``RequestShed`` / ``EngineSaturated`` — is counted and dropped, never
  retried: the open-loop contract), steps the target, advances the clock,
  and at each SLO window boundary rolls the attached
  :class:`~paddle_tpu_torch.observability.slo.SLOMonitor` window and ticks
  the attached autoscaler.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ReplayDriver", "ScheduledArrival", "TenantSpec", "VirtualClock",
           "WorkloadConfig", "decode_schedule", "encode_schedule",
           "generate_schedule", "schedule_digest"]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant in the traffic mix.

    ``weight`` is the tenant's share of arrivals (normalized over the
    mix); ``prefix_len`` tokens of every prompt are the tenant's SHARED
    system prefix (drawn once per tenant from the workload seed), so a
    multi-tenant schedule exercises the radix prefix cache the way
    production system prompts do; ``priority`` maps straight onto
    ``Request.priority`` (LOW tenants are the ones fleet brownout sheds
    first)."""

    name: str
    weight: float = 1.0
    prefix_len: int = 0
    priority: int = 1            # Request.PRIORITY_NORMAL


@dataclasses.dataclass
class WorkloadConfig:
    """Knobs for :func:`generate_schedule`.

    Arrival process (``arrival``):

    - ``"poisson"`` — homogeneous Poisson at ``rate_rps``.
    - ``"diurnal"`` — inhomogeneous Poisson, rate modulated by
      ``1 + diurnal_depth * sin(2*pi*t/diurnal_period_s)`` (thinning).
    - ``"burst"`` — square wave: ``rate_rps`` baseline, multiplied by
      ``burst_multiplier`` inside every ``[k*burst_every_s,
      k*burst_every_s + burst_len_s)`` window — the schedule shape that
      exposes queueing collapse (ROADMAP item 3/5's
      ``serving_ttft_p99_under_burst_ms``).

    Lengths are clipped lognormals (heavy-tailed, like production): the
    ``*_mu``/``*_sigma`` parameters are the underlying normal's, lengths
    land in ``[*_min, *_max]``. Tenants default to one anonymous tenant
    with no shared prefix."""

    seed: int = 0
    duration_s: float = 10.0
    rate_rps: float = 4.0
    arrival: str = "poisson"
    diurnal_period_s: float = 10.0
    diurnal_depth: float = 0.8
    burst_every_s: float = 4.0
    burst_len_s: float = 1.0
    burst_multiplier: float = 4.0
    vocab_size: int = 256
    prompt_mu: float = 2.5
    prompt_sigma: float = 0.6
    prompt_min: int = 4
    prompt_max: int = 64
    output_mu: float = 2.0
    output_sigma: float = 0.7
    output_min: int = 2
    output_max: int = 32
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("default"),)


@dataclasses.dataclass
class ScheduledArrival:
    """One scheduled request: arrival time (seconds from schedule start),
    tenant, the full prompt token ids (shared tenant prefix + fresh
    suffix), the decode budget, the sampling seed and the priority — a
    complete, replayable description (the same fields the request journal
    persists)."""

    t: float
    tenant: str
    prompt: Tuple[int, ...]
    max_new: int
    seed: int
    priority: int


def _rate_at(cfg: WorkloadConfig, t: float) -> float:
    if cfg.arrival == "poisson":
        return cfg.rate_rps
    if cfg.arrival == "diurnal":
        return cfg.rate_rps * (1.0 + cfg.diurnal_depth
                               * math.sin(2.0 * math.pi * t
                                          / cfg.diurnal_period_s))
    if cfg.arrival == "burst":
        in_burst = (t % cfg.burst_every_s) < cfg.burst_len_s
        return cfg.rate_rps * (cfg.burst_multiplier if in_burst else 1.0)
    raise ValueError(f"unknown arrival process {cfg.arrival!r} "
                     "(poisson | diurnal | burst)")


def _peak_rate(cfg: WorkloadConfig) -> float:
    if cfg.arrival == "diurnal":
        return cfg.rate_rps * (1.0 + abs(cfg.diurnal_depth))
    if cfg.arrival == "burst":
        return cfg.rate_rps * max(1.0, cfg.burst_multiplier)
    return cfg.rate_rps


def _clipped_lognormal(rng, mu: float, sigma: float, lo: int,
                       hi: int) -> int:
    return int(min(hi, max(lo, round(float(rng.lognormal(mu, sigma))))))


def generate_schedule(cfg: WorkloadConfig) -> List[ScheduledArrival]:
    """Draw the full arrival schedule. Deterministic: every random draw
    comes from ONE ``np.random.default_rng(cfg.seed)`` stream in a fixed
    order, so the same config produces the byte-identical schedule
    (:func:`encode_schedule`) on every platform numpy supports.

    Inhomogeneous processes use thinning: candidates are drawn at the
    peak rate and accepted with probability ``rate(t)/peak`` — exact for
    any bounded rate function, and the acceptance draw is consumed for
    EVERY candidate so the stream stays aligned."""
    if cfg.rate_rps <= 0 or cfg.duration_s <= 0:
        raise ValueError("rate_rps and duration_s must be positive")
    tenants = list(cfg.tenants) or [TenantSpec("default")]
    total_w = sum(max(0.0, t.weight) for t in tenants)
    if total_w <= 0:
        raise ValueError("tenant weights must sum to a positive value")
    cum_w = np.cumsum([max(0.0, t.weight) / total_w for t in tenants])
    rng = np.random.default_rng(int(cfg.seed))
    # per-tenant shared system prefixes, drawn FIRST (fixed order) so the
    # tenant mix cannot shift them between runs
    prefixes = {t.name: tuple(int(x) for x in rng.integers(
        0, cfg.vocab_size, (max(0, int(t.prefix_len)),)))
        for t in tenants}
    peak = _peak_rate(cfg)
    out: List[ScheduledArrival] = []
    t = 0.0
    k = 0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= cfg.duration_s:
            break
        accept = float(rng.random())          # consumed per candidate
        if accept * peak > _rate_at(cfg, t):
            continue
        tw = float(rng.random())
        # clamp: normalized weights can cumulate to 1 - 2^-53, and a draw
        # landing exactly there would index one past the end
        ten = tenants[min(int(np.searchsorted(cum_w, tw, side="right")),
                          len(tenants) - 1)]
        plen = _clipped_lognormal(rng, cfg.prompt_mu, cfg.prompt_sigma,
                                  cfg.prompt_min, cfg.prompt_max)
        olen = _clipped_lognormal(rng, cfg.output_mu, cfg.output_sigma,
                                  cfg.output_min, cfg.output_max)
        prefix = prefixes[ten.name]
        suffix_len = max(1, plen - len(prefix))
        suffix = tuple(int(x) for x in rng.integers(
            0, cfg.vocab_size, (suffix_len,)))
        k += 1
        out.append(ScheduledArrival(
            t=round(t, 9), tenant=ten.name, prompt=prefix + suffix,
            max_new=olen, seed=int(cfg.seed) * 1_000_003 + k,
            priority=ten.priority))
    return out


def encode_schedule(schedule: Sequence[ScheduledArrival]) -> bytes:
    """Canonical byte encoding (JSON lines, sorted keys, fixed float
    formatting via ``round`` at generation time) — the replayable artifact
    whose byte-identity across same-seed runs the selftest pins."""
    lines = []
    for a in schedule:
        lines.append(json.dumps(
            {"t": a.t, "tenant": a.tenant, "prompt": list(a.prompt),
             "max_new": a.max_new, "seed": a.seed, "priority": a.priority},
            sort_keys=True, separators=(",", ":")).encode("utf-8"))
    return b"\n".join(lines) + (b"\n" if lines else b"")


def decode_schedule(data: bytes) -> List[ScheduledArrival]:
    out = []
    for line in data.decode("utf-8").splitlines():
        if not line.strip():
            continue
        d = json.loads(line)
        out.append(ScheduledArrival(
            t=float(d["t"]), tenant=str(d["tenant"]),
            prompt=tuple(int(x) for x in d["prompt"]),
            max_new=int(d["max_new"]), seed=int(d["seed"]),
            priority=int(d["priority"])))
    return out


def schedule_digest(schedule: Sequence[ScheduledArrival]) -> str:
    return hashlib.blake2b(encode_schedule(schedule),
                           digest_size=16).hexdigest()


class VirtualClock:
    """Discrete-event clock: ``clock()`` reads the current virtual time in
    seconds, ``advance(dt)`` moves it. Passed as a
    :class:`TraceRecorder`'s ``clock=`` so TTFT/inter-token spans are
    measured in virtual seconds — machine-speed independent, hence CI
    stable. (Queue-wait as stamped by the engine uses wall monotonic time;
    virtual-clock SLOs should target TTFT, which subsumes queueing.)"""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t


class ReplayDriver:
    """Open-loop replay of a schedule against a fleet (or engine-like
    target).

    >>> clock = VirtualClock()
    >>> tracer = TraceRecorder(clock=clock)
    >>> fleet = FleetRouter(build, d, num_replicas=1, tracer=tracer)
    >>> drv = ReplayDriver(fleet, schedule, clock=clock, dt_s=0.05,
    ...                    monitor=monitor, autoscaler=scaler)
    >>> report = drv.run()

    Each tick: submit every arrival with ``t <= now`` (open-loop — the
    schedule never waits for the server; refusals are counted in
    ``stats["refused"]`` and dropped), step the target once, advance the
    clock by ``dt_s``. At every ``window_s`` boundary the SLO monitor's
    window is rolled and the autoscaler ticks (measurement then control —
    the closed loop of the observatory). With ``wall_clock=True`` the
    driver paces against real ``time.monotonic()`` instead and never
    sleeps (steps ARE the pacing; a tick with no due arrival still
    steps the target so in-flight work drains).

    After the last arrival the driver keeps stepping until the target
    reports no work (the drain tail is still measured — tail latching is
    the point of open-loop replay) or ``max_steps`` elapses."""

    def __init__(self, target, schedule: Sequence[ScheduledArrival],
                 clock: Optional[VirtualClock] = None, dt_s: float = 0.05,
                 monitor=None, autoscaler=None,
                 window_s: Optional[float] = None, wall_clock: bool = False,
                 max_steps: int = 200_000, request_cls=None):
        self.target = target
        self.schedule = sorted(schedule, key=lambda a: a.t)
        self.clock = clock if clock is not None else VirtualClock()
        self.dt_s = float(dt_s)
        self.monitor = monitor
        self.autoscaler = autoscaler
        self.window_s = float(window_s) if window_s is not None else (
            monitor.config.window_s if monitor is not None else None)
        self.wall_clock = bool(wall_clock)
        self.max_steps = int(max_steps)
        if request_cls is None:
            from ..inference.serving import Request

            request_cls = Request
        self._request_cls = request_cls
        self.requests: List = []
        self._last_roll_t = 0.0
        self.stats = {"submitted": 0, "refused": 0, "steps": 0,
                      "windows": 0}

    def _submit_due(self, now: float, idx: int) -> int:
        from ..inference.serving import EngineSaturated, RequestShed

        while idx < len(self.schedule) and self.schedule[idx].t <= now:
            a = self.schedule[idx]
            idx += 1
            req = self._request_cls(
                np.asarray(a.prompt, np.int32), max_new_tokens=a.max_new,
                seed=a.seed, priority=a.priority, tenant=a.tenant)
            try:
                self.target.submit(req)
            except (EngineSaturated, RequestShed):
                # open-loop: a refused arrival is load the server failed to
                # take, not load to re-offer — count it and move on (sheds
                # the router stamped are already in the tracer/monitor)
                self.stats["refused"] += 1
                continue
            self.stats["submitted"] += 1
            self.requests.append(req)
        return idx

    def _roll_window(self, now: float) -> None:
        """Roll at clock time ``now``: the window's rate denominator is
        the MEASURED time since the previous roll (under a wall clock,
        slow fleet steps make windows roll late — booking their tokens
        over the nominal ``window_s`` would overstate goodput). Virtual
        clocks roll exactly on the boundary, so measured == nominal
        there. A catch-up roll with zero elapsed time reports null
        rates."""
        self.stats["windows"] += 1
        dt = max(0.0, now - self._last_roll_t)
        self._last_roll_t = now
        if self.monitor is not None:
            self.monitor.roll_window(duration_s=dt if dt > 0 else None)
        if self.autoscaler is not None:
            self.autoscaler.tick()

    def run(self) -> dict:
        t0_wall = time.monotonic()
        idx = 0
        self._last_roll_t = 0.0
        next_window = (self.window_s if self.window_s is not None
                       else float("inf"))
        for _ in range(self.max_steps):
            now = (time.monotonic() - t0_wall if self.wall_clock
                   else self.clock())
            idx = self._submit_due(now, idx)
            if idx >= len(self.schedule) and not self.target.has_work():
                break
            if (self.wall_clock and not self.target.has_work()
                    and idx < len(self.schedule)):
                # idle gap before the next arrival: sleep instead of
                # hot-stepping an empty fleet (open-loop still holds —
                # nothing is due, so nothing is delayed)
                time.sleep(min(self.schedule[idx].t - now, 0.01))
                now = time.monotonic() - t0_wall
                while now >= next_window:
                    self._roll_window(now)
                    next_window += self.window_s
                continue
            self.target.step()
            self.stats["steps"] += 1
            if not self.wall_clock:
                self.clock.advance(self.dt_s)
                now = self.clock()
            else:
                now = time.monotonic() - t0_wall
            while now >= next_window:
                self._roll_window(now)
                next_window += self.window_s
        # close the partial final window so the tail is measured
        if self.window_s is not None and self.monitor is not None:
            self._roll_window(self.clock() if not self.wall_clock
                              else time.monotonic() - t0_wall)
        return self.report()

    def report(self) -> dict:
        rep = {"driver": dict(self.stats),
               "schedule": {"arrivals": len(self.schedule),
                            "digest": schedule_digest(self.schedule)}}
        if self.monitor is not None:
            rep["slo"] = self.monitor.report()
        if self.autoscaler is not None:
            rep["autoscaler"] = self.autoscaler.report()
        return rep
