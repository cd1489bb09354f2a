"""Collector adapters: the port's telemetry dicts exposed as registry
collectors — port of ``paddle_tpu/observability/collectors.py``.

Each adapter is a zero-arg callable returning fresh
:class:`~paddle_tpu_torch.observability.metrics.MetricFamily` objects
built from LIVE state at scrape time — pull-based, so the instrumented
objects pay nothing between scrapes, and adapters that wrap a rebuildable
object (a supervisor's engine, a fleet's replica set) always read the
current one, never a pre-rebuild corpse.

Adapters (register with ``MetricsRegistry.register_collector``):

- :func:`engine_collector` — ``ContinuousBatchingEngine``: stats dict,
  queue depth / busy slots, KV pool + radix-cache occupancy, brownout,
  the speculative-decode and int8-pool families. The port's engine has
  stats keys of its own (``graph_captures``, ``graph_replays``,
  ``eager_decode_steps``, ``spec_graph_captures``, ``spec_graph_replays``,
  ``eager_spec_steps``, ``prefill_groups``, ``decode_steps``): they export
  as extra ``pt_engine_*`` families beside every family the JAX engine
  renders.
- :func:`retry_collector` — the ``retry_call`` module registry
  (calls/attempts/retries/giveups/latency + bounded per-``what``).
- :func:`supervisor_collector` — ``ServingSupervisor`` recovery stats +
  its CURRENT engine's families.
- :func:`fleet_collector` — ``FleetRouter``: router stats, per-replica
  state/load, and each alive replica's supervisor+engine families with a
  ``replica`` label.
- :func:`tracer_collector` — ``TraceRecorder`` health:
  ``pt_tracer_dropped_total`` / ``pt_tracer_gc_total`` — a saturated
  trace buffer silently under-reports TTFT tails, so saturation itself
  must be scrapeable.
- :func:`slo_collector` — ``SLOMonitor``: windowed SLO attainment,
  per-tenant attainment and goodput as ``pt_slo_*`` families.

Later slices of the port, refused with ``NotImplementedError`` when asked
for: :func:`guard_collector` (the numeric guard, ROADMAP Queue 1 item 6),
:func:`checkpoint_collector` (the checkpoint lifecycle, item 6) and
:func:`procfleet_collector` (the process fleet, item 3b).

Nothing here touches device state.
"""

from __future__ import annotations

from typing import Iterable, List

from .._later import later_slice
from .metrics import MetricFamily

__all__ = ["checkpoint_collector", "engine_collector", "fleet_collector",
           "guard_collector", "procfleet_collector", "retry_collector",
           "slo_collector", "supervisor_collector", "tracer_collector"]


def _stat_families(prefix: str, stats: dict, kinds: dict,
                   **labels) -> List[MetricFamily]:
    out = []
    for key, val in stats.items():
        if not isinstance(val, (int, float)):
            continue
        name = f"{prefix}_{key}"
        kind = kinds.get(key, "counter")
        out.append(MetricFamily(name, kind).add(float(val), **labels))
    return out


# stats-dict keys that are level readings, not monotonic totals
_ENGINE_GAUGE_KEYS = {"compile_cache_entries"}
# stats-dict keys NOT exported from engine.stats: "evictions" is a lagging
# copy of radix.evictions (synced only at admit/brownout time) and the
# collector already exports the live value as pt_radix_evictions_total —
# two families for one quantity that disagree mid-flight is worse than one.
# The spec proposed/accepted counters export under their REQUIRED
# pt_spec_* names below, not as a second pt_engine_* copy; spec_steps has
# no pt_spec_* twin and stays in the auto-exported pt_engine_* set (the
# verify-dispatch count is what shows spec degrading to 1-token
# dispatches). The mesh counters export under their REQUIRED
# pt_serving_* names below.
_ENGINE_SKIP_KEYS = {"evictions", "spec_proposed", "spec_accepted",
                     "mesh_collective_bytes", "mesh_decode_steps"}


def engine_collector(engine, **labels):
    """Families for one ``ContinuousBatchingEngine`` (pass ``labels`` such
    as ``replica="0"`` when scraping several engines into one registry)."""

    def collect() -> Iterable[MetricFamily]:
        fams = _stat_families(
            "pt_engine",
            {k: v for k, v in engine.stats.items()
             if k not in _ENGINE_SKIP_KEYS},
            {k: "gauge" for k in _ENGINE_GAUGE_KEYS}, **labels)
        fams.append(MetricFamily(
            "pt_engine_queue_depth", "gauge",
            "requests waiting for a slot").add(len(engine._queue), **labels))
        fams.append(MetricFamily(
            "pt_engine_busy_slots", "gauge").add(
            engine.active_slots(), **labels))
        fams.append(MetricFamily("pt_engine_max_batch", "gauge").add(
            engine.max_batch, **labels))
        fams.append(MetricFamily(
            "pt_engine_scheduled_tokens_total", "counter",
            "tokens scheduled across all requests").add(
            engine._sched_tokens, **labels))
        fams.append(MetricFamily("pt_engine_steps_total", "counter").add(
            engine._step_idx, **labels))
        rate = MetricFamily("pt_engine_decode_tokens_per_sec", "gauge",
                            "EMA of scheduled-tokens/s")
        rate.add(engine._ema_tok_s or 0.0, **labels)
        fams.append(rate)
        if engine.prefix_cache is not None:
            alloc, radix = engine._alloc, engine._radix
            fams.append(MetricFamily(
                "pt_pool_blocks_total", "gauge",
                "KV pool capacity in pages").add(alloc.num_blocks, **labels))
            fams.append(MetricFamily(
                "pt_pool_free_blocks", "gauge").add(alloc.free_blocks,
                                                    **labels))
            fams.append(MetricFamily(
                "pt_radix_cached_blocks", "gauge",
                "pages registered in the radix prefix cache").add(
                len(radix), **labels))
            fams.append(MetricFamily(
                "pt_radix_evictions_total", "counter").add(radix.evictions,
                                                           **labels))
        # _brownout_active exists on every engine (it just never flips
        # without a prefix cache) — emit unconditionally so dashboards
        # keyed on the gauge never see the family vanish
        fams.append(MetricFamily(
            "pt_engine_brownout_active", "gauge").add(
            1.0 if engine._brownout_active else 0.0, **labels))
        # speculative decode + int8 KV block format: required families,
        # rendered at zero on non-spec / fp engines so dashboards never
        # lose them
        prop = float(engine.stats.get("spec_proposed", 0))
        acc = float(engine.stats.get("spec_accepted", 0))
        fams.append(MetricFamily(
            "pt_spec_proposed_total", "counter",
            "draft tokens proposed by the speculative decoder").add(
            prop, **labels))
        fams.append(MetricFamily(
            "pt_spec_accepted_total", "counter",
            "draft tokens accepted by the in-graph verify").add(
            acc, **labels))
        fams.append(MetricFamily(
            "pt_spec_acceptance_rate", "gauge",
            "accepted / proposed draft tokens (lifetime)").add(
            acc / prop if prop > 0 else 0.0, **labels))
        fams.append(MetricFamily(
            "pt_kv_quant_blocks", "gauge",
            "pool pages held in the int8 KV block format").add(
            float(getattr(engine, "_kv_quant_blocks", 0)), **labels))
        # mesh-sharded serving: required families, rendered on unsharded
        # engines too (tp=1, zero collective bytes; the port serves
        # unsharded until the tp-sharded serving slice) so dashboards
        # keyed on the gauge see every replica of a mixed fleet
        mesh = getattr(engine, "mesh", None)
        fams.append(MetricFamily(
            "pt_serving_mesh_shape", "gauge",
            "tp width of the engine's serving mesh (1 == unsharded)").add(
            float(mesh.tp) if mesh is not None else 1.0, **labels))
        fams.append(MetricFamily(
            "pt_serving_collective_bytes_total", "counter",
            "wire bytes moved by serving collectives, per device group "
            "(traced census x dispatches)").add(
            float(engine.stats.get("mesh_collective_bytes", 0.0)),
            **labels))
        fams.append(MetricFamily(
            "pt_serving_mesh_decode_steps_total", "counter",
            "sharded decode/verify program dispatches").add(
            float(engine.stats.get("mesh_decode_steps", 0)), **labels))
        return fams

    return collect


def retry_collector():
    """The ``retry_call`` module-level stats registry
    (distributed/resilience/retry.py) — calls/attempts/retries/giveups,
    cumulative latency, and the bounded per-``what`` attempt breakdown."""

    def collect() -> Iterable[MetricFamily]:
        from ..distributed.resilience.retry import retry_stats

        rs = retry_stats()
        fams = [
            MetricFamily("pt_retry_calls_total", "counter").add(rs["calls"]),
            MetricFamily("pt_retry_attempts_total", "counter").add(
                rs["attempts"]),
            MetricFamily("pt_retry_retries_total", "counter").add(
                rs["retries"]),
            MetricFamily("pt_retry_giveups_total", "counter").add(
                rs["giveups"]),
            MetricFamily("pt_retry_latency_seconds_total", "counter").add(
                rs["latency_s"]),
        ]
        by = MetricFamily("pt_retry_attempts_by_what", "counter",
                          "attempts per operation label (capped at 64)")
        for what, n in rs.get("by_what", {}).items():
            by.add(n, what=str(what))
        if by.samples:
            fams.append(by)
        return fams

    return collect


def guard_collector(watchdog=None):
    """Numeric-guard escalation surface (``pt_guard_*``): needs the port's
    numeric guard, a later slice."""
    raise later_slice("guard_collector (framework/numeric_guard.py)",
                      "resilience", "6")


# supervisor stats NOT auto-exported as pt_supervisor_*: the elastic
# mesh-degrade pair exports under its required pt_serving_* names below
# (reshard total + degraded gauge), and a second pt_supervisor_* copy of
# each would just split dashboards across two names for one quantity.
_SUPERVISOR_SKIP_KEYS = {"mesh_reshards", "mesh_degraded"}


def supervisor_collector(sup, **labels):
    """``ServingSupervisor`` stats + its CURRENT engine's families (read
    through ``sup.engine`` at scrape time — a rebuild swaps the engine out
    from under any collector that captured it directly)."""

    def collect() -> Iterable[MetricFamily]:
        fams = _stat_families(
            "pt_supervisor",
            {k: v for k, v in sup.stats.items()
             if k not in _SUPERVISOR_SKIP_KEYS}, {}, **labels)
        stats = sup.stats
        fams.append(MetricFamily(
            "pt_serving_mesh_reshards_total", "counter",
            "elastic PT-SRV-008 mesh-degrade reshards absorbed").add(
            float(stats.get("mesh_reshards", 0)), **labels))
        fams.append(MetricFamily(
            "pt_serving_mesh_degraded", "gauge",
            "1 = this supervisor's engine is serving below its spawned "
            "mesh width (degraded)").add(
            float(stats.get("mesh_degraded", 0)), **labels))
        fams.extend(engine_collector(sup.engine, **labels)())
        return fams

    return collect


def fleet_collector(router):
    """``FleetRouter``: router-level stats, per-replica state/load gauges,
    and every serving replica's supervisor+engine families labeled
    ``replica="<idx>"`` (DEAD and RETIRED replicas keep their state gauge
    but report no load — a retired supervisor is closed)."""

    def collect() -> Iterable[MetricFamily]:
        from ..inference.fleet import _GONE, ReplicaState

        fams = _stat_families("pt_fleet", router.stats, {})
        fams.append(MetricFamily(
            "pt_fleet_brownout_active", "gauge").add(
            1.0 if router._brownout_active else 0.0))
        state = MetricFamily(
            "pt_fleet_replica_state", "gauge",
            "1=alive 0.5=draining 0=dead -1=retired (scaled in)")
        load = MetricFamily("pt_fleet_replica_load", "gauge",
                            "queued + slotted requests per replica")
        for rep in router.replicas:
            # tier label: "serving" on a flat fleet, prefill/decode under
            # a TieredRouter — so dashboards can split load/state per tier
            tier = getattr(rep, "tier", "serving")
            state.add({ReplicaState.ALIVE: 1.0,
                       ReplicaState.DRAINING: 0.5,
                       ReplicaState.RETIRED: -1.0}.get(rep.state, 0.0),
                      replica=str(rep.idx), tier=tier)
            if rep.state not in _GONE:
                load.add(rep.sup.load(), replica=str(rep.idx), tier=tier)
                fams.extend(supervisor_collector(
                    rep.sup, replica=str(rep.idx))())
        fams.append(state)
        fams.append(load)
        return fams

    return collect


def procfleet_collector(router, scrape_workers: bool = True,
                        timeout_s: float = 2.0):
    """Process-fleet transport telemetry (``pt_procfleet_*``,
    ``pt_transport_*``) and remote worker aggregation: needs the process
    fleet, a later slice."""
    raise later_slice("procfleet_collector (inference/procfleet)",
                      "process-fleet", "3b")


def tracer_collector(tracer, **labels):
    """``TraceRecorder`` health counters (read through the recorder's
    ``counters()`` — one stamp-lock acquisition per scrape):
    ``pt_tracer_dropped_total`` events refused by the bounded buffer and
    ``pt_tracer_gc_total`` terminal request records evicted past
    ``max_requests``. Either one moving means the recorder is saturated
    and TTFT tails are being under-reported — alert on it, don't trust
    the percentiles."""

    def collect() -> Iterable[MetricFamily]:
        c = tracer.counters()
        return [
            MetricFamily(
                "pt_tracer_dropped_total", "counter",
                "trace events dropped by the bounded buffer").add(
                c["dropped"], **labels),
            MetricFamily(
                "pt_tracer_gc_total", "counter",
                "terminal request records GC'd past max_requests").add(
                c["gc"], **labels),
            MetricFamily("pt_tracer_buffered_events", "gauge").add(
                c["events"], **labels),
            MetricFamily("pt_tracer_open_requests", "gauge").add(
                c["open"], **labels),
            MetricFamily("pt_tracer_resubmits_total", "counter").add(
                c["resubmits"], **labels),
        ]

    return collect


def checkpoint_collector(stats_fn=None):
    """Checkpoint-lifecycle families (``pt_checkpoint_*``,
    ``pt_lifecycle_phase``): needs the checkpoint lifecycle, a later
    slice."""
    raise later_slice(
        "checkpoint_collector (distributed/resilience/lifecycle.py)",
        "resilience", "6")


def slo_collector(monitor):
    """``SLOMonitor`` → ``pt_slo_*`` families: cumulative
    finished/met/good-token counters, the latest window's attainment
    (overall, per signal, per tenant) and goodput — the scrape-side face
    of the SLO observatory."""

    def collect() -> Iterable[MetricFamily]:
        rep = monitor.report()
        tot = rep["totals"]
        fams = [
            MetricFamily("pt_slo_requests_finished_total", "counter").add(
                tot["finished"]),
            MetricFamily(
                "pt_slo_requests_met_total", "counter",
                "finished requests that met every SLO target").add(
                tot["met"]),
            MetricFamily(
                "pt_slo_good_tokens_total", "counter",
                "tokens from SLO-meeting requests (goodput numerator)").add(
                tot["good_tokens"]),
            MetricFamily("pt_slo_tokens_total", "counter").add(
                tot["tokens"]),
            MetricFamily("pt_slo_windows_total", "counter").add(
                # the true monotonic count — rep["windows"] is a bounded
                # deque view that plateaus at the monitor's max_windows
                rep["windows_total"]),
            MetricFamily(
                "pt_slo_requests_shed_total", "counter",
                "sheds among finished (refused at submit — never met)"
            ).add(rep["totals"]["shed"]),
            MetricFamily(
                "pt_slo_target_attainment", "gauge",
                "the configured window attainment contract").add(
                monitor.config.target_attainment),
        ]
        att = MetricFamily("pt_slo_attainment", "gauge",
                           "last window's attainment by scope")
        goodput = MetricFamily("pt_slo_goodput_tokens_per_sec", "gauge")
        win = rep["windows"][-1] if rep["windows"] else None
        if win is not None:
            if win["attainment"] is not None:
                att.add(win["attainment"], scope="window")
            for name, sig in win["signals"].items():
                if sig.get("attainment") is not None:
                    att.add(sig["attainment"], scope=f"signal:{name}")
            for ten, row in win["by_tenant"].items():
                if row["attainment"] is not None:
                    att.add(row["attainment"], scope=f"tenant:{ten}")
            if win["goodput_tokens_per_sec"] is not None:
                goodput.add(win["goodput_tokens_per_sec"])
        if rep["attainment"] is not None:
            att.add(rep["attainment"], scope="total")
        if att.samples:
            fams.append(att)
        if goodput.samples:
            fams.append(goodput)
        return fams

    return collect
