"""SLO-pressure autoscaler: attainment windows in, fleet actions out —
port of ``paddle_tpu/inference/autoscale.py``.

:class:`SLOAutoscaler` reads the
:class:`~paddle_tpu_torch.observability.slo.SLOMonitor` windows and drives
the fleet router's scaling hooks —

- **scale up** (PT-ASC-001): ``up_after`` consecutive windows below
  ``target_attainment`` add a replica via
  :meth:`~paddle_tpu_torch.inference.fleet.FleetRouter.add_replica` (the
  same supervisor/journal factory path every other replica was built
  through).
- **brownout** (PT-ASC-002): at ``max_replicas`` the only lever left is
  degradation — :meth:`FleetRouter.force_brownout` sheds sheddable
  priority classes at submit until attainment recovers.
- **scale down** (PT-ASC-003): ``down_after`` consecutive windows at or
  above ``headroom_attainment`` first release a forced brownout, then
  retire the least-loaded replica via
  :meth:`FleetRouter.retire_replica` (drain-then-remove: still-queued
  work migrates, in-flight work finishes in place — nothing is lost to a
  scale-in).

Hysteresis everywhere: consecutive-window counters gate every transition
and ``cooldown_windows`` quiet periods follow every action, so one noisy
window can neither flap replicas nor oscillate brownout. Windows with
fewer than ``min_window_requests`` finished requests are no evidence and
leave the counters untouched.

Every decision is stamped as a trace event (``autoscale`` instants in the
engine lane), appended to :attr:`decisions`, and counted in the metrics
registry (``pt_autoscaler_*`` families). The same windows give the JAX
controller's decisions.

The controller is deliberately thread-free: :meth:`tick` is called at
window boundaries by whoever owns the clock (the
:class:`~paddle_tpu_torch.observability.workload.ReplayDriver` in replay,
an operator loop in production).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["AutoscaleConfig", "SLOAutoscaler"]


@dataclasses.dataclass
class AutoscaleConfig:
    """Controller knobs (module docstring for the state machine).

    ``target_attainment=None`` inherits the monitor's
    ``SLOConfig.target_attainment`` — one contract, judged in one place."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_attainment: Optional[float] = None
    headroom_attainment: float = 0.98
    up_after: int = 2
    down_after: int = 4
    cooldown_windows: int = 1
    min_window_requests: int = 1


class SLOAutoscaler:
    """>>> scaler = SLOAutoscaler(fleet, monitor, AutoscaleConfig(
    ...     min_replicas=1, max_replicas=3))
    >>> # at every SLO window boundary:
    >>> decision = scaler.tick()      # None | scale_up | scale_down |
    ...                               # brownout | brownout_exit

    ``enabled=False`` is the control arm: the
    ticks still read the windows and keep counters, but no fleet action is
    taken — under the same seeded burst schedule the attainment difference
    between the arms is the autoscaler's measured worth."""

    def __init__(self, router, monitor, config: Optional[AutoscaleConfig]
                 = None, registry=None, tracer=None, enabled: bool = True):
        self.router = router
        self.monitor = monitor
        self.config = config or AutoscaleConfig()
        self.tracer = tracer
        self.enabled = bool(enabled)
        self.decisions: List[dict] = []
        self.stats = {"ticks": 0, "scale_ups": 0, "scale_downs": 0,
                      "brownouts": 0, "brownout_exits": 0,
                      "pressured_windows": 0, "headroom_windows": 0}
        self._low = 0          # consecutive windows below target
        self._high = 0         # consecutive windows at/above headroom
        self._cooldown = 0
        self._forced_brownout = False
        self._c_up = self._c_down = self._c_brown = self._g_replicas = None
        if registry is not None:
            self._c_up = registry.counter(
                "pt_autoscaler_scale_ups_total",
                "replicas added on SLO-attainment shortfall")
            self._c_down = registry.counter(
                "pt_autoscaler_scale_downs_total",
                "replicas retired on sustained SLO headroom")
            self._c_brown = registry.counter(
                "pt_autoscaler_brownouts_total",
                "forced fleet brownouts at max replicas")
            self._g_replicas = registry.gauge(
                "pt_autoscaler_replicas",
                "replicas the autoscaler currently counts as serving")

    # -- internals ---------------------------------------------------------
    def _target(self) -> float:
        if self.config.target_attainment is not None:
            return self.config.target_attainment
        return self.monitor.config.target_attainment

    def _alive(self) -> int:
        from .fleet import ReplicaState

        return sum(1 for r in self.router.replicas
                   if r.state in (ReplicaState.ALIVE,
                                  ReplicaState.DRAINING))

    def _decide(self, action: str, window: Optional[dict],
                detail: str) -> str:
        replicas = self._alive()
        if self._g_replicas is not None:
            self._g_replicas.set(replicas)      # post-action truth
        rec = {"tick": self.stats["ticks"], "action": action,
               "replicas": replicas,
               "window": None if window is None else window.get("window"),
               "attainment": (None if window is None
                              else window.get("attainment")),
               "detail": detail}
        self.decisions.append(rec)
        key = {"scale_up": "scale_ups", "scale_down": "scale_downs",
               "brownout": "brownouts",
               "brownout_exit": "brownout_exits"}[action]
        self.stats[key] += 1
        # brownout_exit deliberately has no counter: pt_autoscaler_
        # brownouts_total counts ENTRIES only
        counter = {"scale_up": self._c_up, "scale_down": self._c_down,
                   "brownout": self._c_brown}.get(action)
        if counter is not None:
            counter.inc()
        if self.tracer is not None:
            self.tracer.instant("autoscale", None, None, action=action,
                                replicas=replicas, detail=detail,
                                attainment=rec["attainment"])
        self._cooldown = self.config.cooldown_windows
        self._low = self._high = 0
        return action

    # -- the control step --------------------------------------------------
    def tick(self, window: Optional[dict] = None) -> Optional[str]:
        """One control step: judge the latest finalized window, maybe act.
        Returns the decision name (or None). Call at window boundaries,
        AFTER ``monitor.roll_window`` (the ReplayDriver does both)."""
        cfg = self.config
        self.stats["ticks"] += 1
        if window is None:
            window = self.monitor.last_window()
        if self._g_replicas is not None:
            self._g_replicas.set(self._alive())
        if window is None:
            return None
        attain = window.get("attainment")
        finished = window.get("finished", 0)
        if attain is None or finished < cfg.min_window_requests:
            return None          # no evidence: counters hold, no decay
        if self._forced_brownout:
            # the forced brownout's OWN sheds count as unmet requests, so
            # overall attainment is capped at (1 - sheddable share) and
            # could never reach headroom — recovery must be judged on the
            # traffic that was actually served
            served = window.get("served_attainment")
            if served is not None:
                attain = served
        target = self._target()
        if attain < target:
            self._low += 1
            self._high = 0
            self.stats["pressured_windows"] += 1
        elif attain >= cfg.headroom_attainment:
            self._high += 1
            self._low = 0
            self.stats["headroom_windows"] += 1
        else:
            self._low = self._high = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if not self.enabled:
            return None
        if self._low >= cfg.up_after:
            alive = self._alive()
            if alive < cfg.max_replicas:
                idx = self.router.add_replica()
                return self._decide(
                    "scale_up", window,
                    f"attainment {attain:.3f} < {target:.3f} for "
                    f"{cfg.up_after} window(s) — replica {idx} added "
                    f"({alive} -> {alive + 1})")
            if not self._forced_brownout:
                self._forced_brownout = True
                self.router.force_brownout(True)
                return self._decide(
                    "brownout", window,
                    f"attainment {attain:.3f} < {target:.3f} at max "
                    f"replicas ({cfg.max_replicas}) — fleet brownout "
                    "forced (shedding sheddable priorities at submit)")
            self._low = 0        # already maximally degraded: hold state
            return None
        if self._high >= cfg.down_after:
            if self._forced_brownout:
                self._forced_brownout = False
                self.router.force_brownout(False)
                return self._decide(
                    "brownout_exit", window,
                    f"attainment {attain:.3f} >= "
                    f"{cfg.headroom_attainment:.3f} for {cfg.down_after} "
                    "window(s) — forced brownout released")
            alive = self._alive()
            if alive > cfg.min_replicas:
                idx = self._pick_retire()
                if idx is not None and self.router.retire_replica(idx):
                    return self._decide(
                        "scale_down", window,
                        f"attainment {attain:.3f} >= "
                        f"{cfg.headroom_attainment:.3f} for "
                        f"{cfg.down_after} window(s) — replica {idx} "
                        f"retiring ({alive} -> {alive - 1})")
            self._high = 0       # nothing to shed: hold at floor
        return None

    def _pick_retire(self) -> Optional[int]:
        """Least-loaded ALIVE replica (highest index tie-break — the
        autoscaler retires newest-first so the original fleet shape is
        what survives a scale cycle)."""
        from .fleet import ReplicaState

        alive = [r for r in self.router.replicas
                 if r.state == ReplicaState.ALIVE]
        if len(alive) <= 1:
            return None
        return min(alive, key=lambda r: (r.sup.load(), -r.idx)).idx

    def report(self) -> dict:
        return {"config": dataclasses.asdict(self.config),
                "enabled": self.enabled,
                "stats": dict(self.stats),
                "forced_brownout": self._forced_brownout,
                "replicas": self._alive(),
                "decisions": list(self.decisions)}
