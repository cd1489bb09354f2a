"""SLO attainment and goodput accounting over the trace surface — port
of ``paddle_tpu/observability/slo.py``.

The metrics layer measures latency; this module judges it: an
:class:`SLOConfig` names per-request targets (TTFT, mean inter-token
latency, queue wait) and :class:`SLOMonitor` turns the
:class:`~paddle_tpu_torch.observability.tracing.TraceRecorder` data into

- **windowed attainment** — per window, the fraction of finished requests
  that met EVERY target (plus per-signal attainment read straight from the
  recorder's fixed-bucket histograms via ``Histogram.snapshot()`` /
  ``delta()`` — no recorder swap between windows), and per-TENANT
  attainment from the ``tenant`` tag the serving engine stamps on
  submit/admit;
- **goodput** — tokens/sec from requests that met every SLO, as distinct
  from raw throughput: a server in queueing collapse can post high
  tokens/sec while its goodput is ~0 because every token lands after the
  deadline the caller cared about. Goodput is what the autoscaler
  (inference/autoscale.py) optimizes.

Wiring: ``monitor.attach(tracer)`` installs the monitor as the tracer's
``slo`` sink — the stamp sites (submit/admit/first_token/finish/shed) feed
it per-request facts under the tracer's stamp lock, behind one
``is not None`` check each, so an un-monitored tracer pays nothing. All
monitor state sits behind its own lock (the driver/autoscaler thread reads
windows while replica threads stamp), and the per-request staging table is
bounded: terminal requests retire from it immediately, which is what keeps
a long replay O(in-flight).

Export: :func:`paddle_tpu_torch.observability.collectors.slo_collector`
renders the monitor as ``pt_slo_*`` Prometheus families. The report of the
same stamps on the same clock equals the JAX monitor's.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, Optional

__all__ = ["SLOConfig", "SLOMonitor"]


@dataclasses.dataclass
class SLOConfig:
    """Per-request SLO targets + the windowing/attainment contract.

    A request MEETS the SLO iff it finished cleanly (``finish`` — sheds,
    deadline evictions and failures never meet it) and each of its
    measured signals is at or under its target; a signal that was never
    measured for the request (e.g. inter-token latency on a 1-token
    response) is vacuously met. ``None`` disables a target entirely.

    ``target_attainment`` is the WINDOW contract the autoscaler and the
    replay gate judge against: the fraction of a window's finished
    requests that must meet the SLO. ``window_s`` is the attainment
    window length in the driving clock's seconds (virtual seconds under
    :class:`~paddle_tpu.observability.workload.VirtualClock` replay)."""

    ttft_ms: Optional[float] = 1000.0
    inter_token_ms: Optional[float] = None
    queue_wait_ms: Optional[float] = None
    target_attainment: float = 0.9
    window_s: float = 1.0


class _Window:
    __slots__ = ("finished", "met", "shed", "tokens", "good_tokens",
                 "submitted", "by_tenant")

    def __init__(self):
        self.submitted = 0
        self.finished = 0           # terminals of any kind (sheds included)
        self.met = 0
        self.shed = 0               # sheds among finished (never met)
        self.tokens = 0             # tokens from every terminal'd request
        self.good_tokens = 0        # tokens from SLO-meeting requests only
        self.by_tenant: Dict[str, list] = {}   # name -> [finished, met]


class SLOMonitor:
    """Windowed SLO attainment + goodput over one TraceRecorder.

    >>> monitor = SLOMonitor(SLOConfig(ttft_ms=500.0, window_s=1.0))
    >>> monitor.attach(tracer)          # tracer.slo = monitor
    >>> ... serve ...
    >>> monitor.roll_window(duration_s=1.0)   # per window boundary
    >>> monitor.report()["windows"][-1]["attainment"]

    ``roll_window`` finalizes the in-progress window into the (bounded)
    history and returns its summary; the driver calls it at each window
    boundary of ITS clock and passes the window duration explicitly —
    the monitor never reads a clock itself, so the same code serves
    virtual-clock replays and wall-clock production."""

    def __init__(self, config: SLOConfig,
                 tracer=None, max_windows: int = 512):
        self.config = config
        self.tracer = None
        self._lock = threading.Lock()
        # rid -> staged facts; retired at terminal (bounded by in-flight)
        self._staging: Dict[int, dict] = {}
        # sheds are staged here until the window ROLLS instead of booking
        # immediately: a fleet router that catches one replica's
        # RequestShed and places the request on the next candidate
        # re-opens the rid (note_reopen) in the same submit call — booking
        # the shed eagerly would count a successfully-rerouted request as
        # an SLO miss forever
        self._pending_sheds: Dict[int, dict] = {}
        self._cur = _Window()
        self.windows: deque = deque(maxlen=int(max_windows))
        self._windows_total = 0
        self.totals = {"submitted": 0, "finished": 0, "met": 0, "shed": 0,
                       "tokens": 0, "good_tokens": 0}
        self._hists = None
        self._hist_marks = None
        if tracer is not None:
            self.attach(tracer)

    def attach(self, tracer) -> "SLOMonitor":
        """Install as ``tracer.slo`` and snapshot the recorder's TTFT /
        inter-token / queue-wait histograms so the first window's
        per-signal deltas start from here."""
        self.tracer = tracer
        self._hists = {"ttft_ms": tracer._h_ttft,
                       "inter_token_ms": tracer._h_itl,
                       "queue_wait_ms": tracer._h_qwait}
        self._hist_marks = {k: h.snapshot() for k, h in self._hists.items()}
        tracer.slo = self
        return self

    # -- sink API (called by TraceRecorder under ITS stamp lock) -----------
    def note_submit(self, rid: int, tenant: Optional[str]) -> None:
        with self._lock:
            self._staging[rid] = {"tenant": tenant, "ttft": None,
                                  "qwait": None}
            self._cur.submitted += 1
            self.totals["submitted"] += 1

    def note_queue_wait(self, rid: int, wait_ms: float) -> None:
        with self._lock:
            st = self._staging.get(rid)
            if st is not None:
                st["qwait"] = float(wait_ms)

    def note_ttft(self, rid: int, ttft_ms: float) -> None:
        with self._lock:
            st = self._staging.get(rid)
            if st is not None:
                st["ttft"] = float(ttft_ms)

    def note_reopen(self, rid: int, tenant: Optional[str]) -> None:
        """The tracer re-opened a terminal'd rid (a fleet router caught
        one replica's shed and routed the request onward): cancel the
        pending shed — the request is live again and its REAL terminal is
        what gets booked. A reopen after the window already rolled (or of
        a long-gone rid) restores fresh staging instead."""
        with self._lock:
            st = self._pending_sheds.pop(rid, None)
            if st is None and rid not in self._staging:
                st = {"tenant": tenant, "ttft": None, "qwait": None}
            if st is not None:
                self._staging[rid] = st

    def note_terminal(self, rid: int, kind: str, n_out: int,
                      itl_ms: Optional[float]) -> None:
        """Book the request into the current window. A rid with no staged
        submit (e.g. a request re-opened after an earlier terminal already
        booked it) is ignored — one booking per lifecycle. Sheds are
        PENDED until the window rolls (see :meth:`note_reopen`)."""
        cfg = self.config
        with self._lock:
            st = self._staging.pop(rid, None)
            if st is None:
                return
            if kind == "shed":
                self._pending_sheds[rid] = st
                return
            met = kind == "finish"

            def within(value, target):
                # unmeasured signal = vacuously met (a 1-token response
                # has no inter-token latency to miss)
                return (target is None or value is None
                        or value <= target)

            met = (met and within(st["ttft"], cfg.ttft_ms)
                   and within(itl_ms, cfg.inter_token_ms)
                   and within(st["qwait"], cfg.queue_wait_ms))
            w = self._cur
            w.finished += 1
            w.tokens += int(n_out)
            self.totals["finished"] += 1
            self.totals["tokens"] += int(n_out)
            if met:
                w.met += 1
                w.good_tokens += int(n_out)
                self.totals["met"] += 1
                self.totals["good_tokens"] += int(n_out)
            ten = st.get("tenant")
            if ten is not None:
                row = w.by_tenant.setdefault(ten, [0, 0])
                row[0] += 1
                row[1] += 1 if met else 0

    # -- windows -----------------------------------------------------------
    def _signal_stats(self) -> Dict[str, dict]:
        """Per-signal window stats straight from the recorder histograms:
        the delta since the last roll gives this window's observations
        (``Histogram.snapshot``/``delta`` — no recorder swap), from which
        attainment-at-target and the window p50/p99 interpolate."""
        out: Dict[str, dict] = {}
        if self._hists is None:
            return out
        targets = {"ttft_ms": self.config.ttft_ms,
                   "inter_token_ms": self.config.inter_token_ms,
                   "queue_wait_ms": self.config.queue_wait_ms}
        for name, h in self._hists.items():
            row = h.delta(self._hist_marks[name])
            self._hist_marks[name] = h.snapshot()
            tgt = targets[name]
            frac = (h.row_fraction_le(row, tgt)
                    if tgt is not None else None)
            out[name] = {
                "count": h.row_count(row),
                "p50": h.row_quantile(row, 0.50),
                "p99": h.row_quantile(row, 0.99),
                "target": tgt,
                "attainment": None if frac is None else round(frac, 6),
            }
        return out

    def roll_window(self, duration_s: Optional[float] = None) -> dict:
        """Finalize the current window; returns its summary dict (also
        appended to :attr:`windows`). ``duration_s`` (the driving clock's
        window length) is the goodput denominator; without it the window
        reports token counts with null rates."""
        with self._lock:
            w, self._cur = self._cur, _Window()
            # finalize pending sheds: nothing re-opened them before the
            # window closed, so they are real caller-visible refusals
            for st in self._pending_sheds.values():
                w.finished += 1
                w.shed += 1
                self.totals["finished"] += 1
                self.totals["shed"] += 1
                ten = st.get("tenant")
                if ten is not None:
                    row = w.by_tenant.setdefault(ten, [0, 0])
                    row[0] += 1
            self._pending_sheds.clear()
            self._windows_total += 1
            idx = self._windows_total
        signals = self._signal_stats()     # instrument locks only
        dur = float(duration_s) if duration_s else None
        served = w.finished - w.shed
        rec = {
            "window": idx,
            "duration_s": dur,
            "submitted": w.submitted,
            "finished": w.finished,
            "met": w.met,
            "shed": w.shed,
            # an empty window has no evidence either way: attainment None
            "attainment": (round(w.met / w.finished, 6)
                           if w.finished else None),
            # attainment among requests that were actually SERVED (sheds
            # excluded) — what a forced brownout's exit decision must read:
            # brownout's own sheds cap the overall number, so judging
            # recovery on it would lock the degraded mode in forever
            "served_attainment": (round(w.met / served, 6)
                                  if served else None),
            "tokens": w.tokens,
            "good_tokens": w.good_tokens,
            "throughput_tokens_per_sec": (w.tokens / dur if dur else None),
            "goodput_tokens_per_sec": (w.good_tokens / dur
                                       if dur else None),
            "by_tenant": {ten: {"finished": f, "met": m,
                                "attainment": round(m / f, 6) if f else None}
                          for ten, (f, m) in sorted(w.by_tenant.items())},
            "signals": signals,
        }
        with self._lock:
            self.windows.append(rec)
        return rec

    def last_window(self) -> Optional[dict]:
        with self._lock:
            return self.windows[-1] if self.windows else None

    def attainment(self, last_n: Optional[int] = None) -> Optional[float]:
        """Request-level attainment aggregated over the last ``last_n``
        windows (all history when None) — the number the autoscaler and
        the replay gate judge against ``config.target_attainment``."""
        with self._lock:
            wins = list(self.windows)
        if last_n is not None:
            wins = wins[-int(last_n):]
        fin = sum(w["finished"] for w in wins)
        met = sum(w["met"] for w in wins)
        return (met / fin) if fin else None

    def report(self) -> dict:
        with self._lock:
            return {
                "config": dataclasses.asdict(self.config),
                "totals": dict(self.totals),
                "attainment": (self.totals["met"] / self.totals["finished"]
                               if self.totals["finished"] else None),
                # true monotonic count — self.windows is a bounded deque,
                # so len() plateaus at max_windows
                "windows_total": self._windows_total,
                "windows": list(self.windows),
            }
