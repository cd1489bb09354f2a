"""Typed metrics registry with a Prometheus text exposition surface —
port of ``paddle_tpu/observability/metrics.py``.

Every telemetry dict the port keeps (``engine.stats``, the ``retry_call``
registry, pool/radix occupancy, ``FleetRouter`` per-replica load) becomes
a **collector** that is read at SCRAPE time — pull-based, so instrumented
code pays nothing between scrapes and the registry holds no unbounded
state:

- :class:`Counter` / :class:`Gauge` — one float per label set.
- :class:`Histogram` — FIXED bucket bounds (no reservoir, no unbounded
  sample list); percentiles are estimated from the cumulative bucket
  counts (:meth:`Histogram.quantile`), which is what the serving SLO
  summaries read.
- :class:`MetricsRegistry` — owns instruments + collectors;
  :meth:`~MetricsRegistry.dump` renders the whole surface in Prometheus
  text format (one-shot scrape);
  :class:`~paddle_tpu_torch.observability.server.MetricsServer` serves it.

A collector is a zero-arg callable (or an object with ``collect()``)
returning an iterable of :class:`MetricFamily` — built fresh per scrape,
so adapters read live objects (``sup.engine`` after a rebuild, a fleet's
current replica set) instead of pinning dead ones.

The exposition text is an interface: the same registry operations give
the JAX package's bytes (float formatting, label escaping, family order).
Everything here is stdlib-only and host-side: recording never touches a
device tensor or the captured step.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily",
           "MetricsRegistry", "parse_prometheus_text",
           "DEFAULT_LATENCY_BUCKETS_MS"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default bucket bounds for millisecond latency histograms — fixed and
#: log-spaced so the state is bounded regardless of traffic volume
DEFAULT_LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                              250.0, 500.0, 1000.0, 2500.0, 5000.0,
                              10000.0, 30000.0)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class MetricFamily:
    """One named metric with samples — the unit collectors emit and
    :func:`parse_prometheus_text` returns. ``samples`` are
    ``(suffix, labels_dict, value)``; the suffix is "" for plain
    counters/gauges and ``_bucket``/``_sum``/``_count`` for histograms."""

    def __init__(self, name: str, kind: str, help: str = ""):
        self.name = _check_name(name)
        if kind not in ("counter", "gauge", "histogram", "untyped"):
            raise ValueError(f"invalid metric kind {kind!r}")
        self.kind = kind
        self.help = help
        self.samples: List[Tuple[str, Dict[str, str], float]] = []

    def add(self, value: float, suffix: str = "", **labels) -> "MetricFamily":
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        self.samples.append((suffix, {k: str(v) for k, v in labels.items()},
                             float(value)))
        return self

    def render(self) -> List[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for suffix, labels, value in self.samples:
            out.append(f"{self.name}{suffix}{_label_str(labels)} "
                       f"{_fmt(value)}")
        return out


class _Instrument:
    """Base: one value (or bucket vector) per label set; thread-safe under a
    shared registry lock (recording paths are host-side control plane)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 lock: Optional[threading.Lock] = None):
        self.name = _check_name(name)
        self.help = help
        self._lock = lock or threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def _key(self, labels: Dict[str, str]):
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.kind, self.help)
        with self._lock:
            items = list(self._values.items())
        for key, value in items:
            fam.add(value, **dict(key))
        if not items and self.kind in ("counter", "gauge"):
            fam.add(0.0)        # a registered metric always renders
        return fam


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)


class Histogram(_Instrument):
    """Fixed-bucket histogram: cumulative counts per upper bound plus
    sum/count — bounded state no matter how many observations land, and
    enough to estimate percentiles (:meth:`quantile`, linear interpolation
    inside the winning bucket) for the SLO summary lines."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                 lock: Optional[threading.Lock] = None):
        super().__init__(name, help, lock)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets: Tuple[float, ...] = tuple(bs)
        # per label set: [count per bucket..., +Inf count, sum]
        self._values: Dict[tuple, List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = [0.0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    row[i] += 1
                    break
            else:
                row[len(self.buckets)] += 1
            row[-1] += v

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            row = list(self._values.get(key) or ())
        return int(sum(row[:-1])) if row else 0

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimate the q-quantile (0..1) from the bucket counts: walk the
        cumulative distribution to the winning bucket, interpolate linearly
        between its bounds. Observations past the last bound clamp to it
        (the standard Prometheus ``histogram_quantile`` posture). None when
        nothing was observed."""
        return self.row_quantile(self.snapshot(**labels), q)

    # -- windowed reads (the SLO monitor's windows): a scraper that wants PER-WINDOW percentiles/attainment
    # snapshots the row at each window boundary and works on the delta —
    # no recorder swap, no state reset, reads under the instrument lock
    def snapshot(self, **labels) -> Tuple[float, ...]:
        """Immutable copy of the row for one label set:
        ``(count per bucket..., +Inf count, sum)`` — all zeros when nothing
        was observed yet, so ``delta`` against a pre-traffic snapshot is
        always well-defined."""
        key = self._key(labels)
        with self._lock:
            row = self._values.get(key)
            return tuple(row) if row else (0.0,) * (len(self.buckets) + 2)

    def delta(self, since: Optional[Sequence[float]], **labels
              ) -> Tuple[float, ...]:
        """Current row minus an earlier :meth:`snapshot` — the WINDOW'S
        observations as a standalone row (``since=None`` means everything
        so far). Counts are monotonic, so the subtraction is exact."""
        cur = self.snapshot(**labels)
        if since is None:
            return cur
        return tuple(c - s for c, s in zip(cur, since))

    def row_count(self, row: Sequence[float]) -> int:
        return int(sum(row[:-1]))

    def row_quantile(self, row: Sequence[float], q: float
                     ) -> Optional[float]:
        """:meth:`quantile` over an explicit row (a snapshot or a window
        delta) instead of the live state."""
        if not row:
            return None
        total = sum(row[:-1])
        if total <= 0:
            return None
        rank = max(0.0, min(1.0, float(q))) * total
        cum = 0.0
        lo = 0.0
        for i, b in enumerate(self.buckets):
            prev = cum
            cum += row[i]
            if cum >= rank and row[i] > 0:
                frac = (rank - prev) / row[i]
                return lo + (b - lo) * min(1.0, max(0.0, frac))
            lo = b
        return self.buckets[-1]    # landed in the +Inf bucket: clamp

    def row_fraction_le(self, row: Sequence[float], value: float
                        ) -> Optional[float]:
        """Fraction of a row's observations at or below ``value`` (linear
        interpolation inside the straddling bucket) — the per-signal SLO
        attainment read. Observations in the +Inf bucket count as above
        every finite value; None when the row is empty."""
        total = sum(row[:-1])
        if total <= 0:
            return None
        v = float(value)
        cum = 0.0
        lo = 0.0
        for i, b in enumerate(self.buckets):
            if v >= b:
                cum += row[i]
            else:
                if v > lo and row[i] > 0:
                    cum += row[i] * (v - lo) / (b - lo)
                break
            lo = b
        return min(1.0, cum / total)

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.kind, self.help)
        with self._lock:
            items = [(k, list(v)) for k, v in self._values.items()]
        for key, row in items:
            labels = dict(key)
            cum = 0.0
            for i, b in enumerate(self.buckets):
                cum += row[i]
                fam.add(cum, suffix="_bucket", le=_fmt(b), **labels)
            cum += row[len(self.buckets)]
            fam.add(cum, suffix="_bucket", le="+Inf", **labels)
            fam.add(row[-1], suffix="_sum", **labels)
            fam.add(cum, suffix="_count", **labels)
        if not items:
            # a registered histogram always renders (all-zero row) — same
            # posture as counters/gauges in _Instrument.family: dashboards
            # keyed on the family never see it vanish, and the scrape gate
            # can REQUIRE it before the first observation lands (e.g.
            # pt_migration_time_ms on a fleet that has not migrated yet)
            for b in self.buckets:
                fam.add(0.0, suffix="_bucket", le=_fmt(b))
            fam.add(0.0, suffix="_bucket", le="+Inf")
            fam.add(0.0, suffix="_sum")
            fam.add(0.0, suffix="_count")
        return fam


class MetricsRegistry:
    """Instrument factory + collector host + exposition renderer.

    >>> reg = MetricsRegistry()
    >>> c = reg.counter("pt_requests_total", "requests seen")
    >>> c.inc(replica="0")
    >>> reg.register_collector(lambda: [MetricFamily("pt_up", "gauge")
    ...                                 .add(1.0)])
    >>> text = reg.dump()        # Prometheus text format, one-shot scrape

    Re-requesting an instrument name returns the SAME instrument (the
    engine and a collector can share a counter); re-requesting it with a
    different type raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._collectors: List[Callable[[], Iterable[MetricFamily]]] = []

    # -- instrument factories ----------------------------------------------
    def _make(self, cls, name, help, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, not {cls.kind}")
                return inst
            inst = self._instruments[name] = cls(name, help, **kw)
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._make(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._make(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        return self._make(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    # -- collectors --------------------------------------------------------
    def register_collector(self, collector) -> None:
        """``collector`` is a zero-arg callable or an object with
        ``collect()``, returning an iterable of :class:`MetricFamily`.
        Called at every scrape — read live state, never cache objects that
        can be rebuilt out from under you."""
        fn = getattr(collector, "collect", None)
        with self._lock:
            # the scrape thread snapshots under this lock (collect());
            # registration happens while serving traffic is live
            self._collectors.append(fn if callable(fn) else collector)

    def collect(self) -> List[MetricFamily]:
        """All families: own instruments first, then each collector's. A
        collector that raises is surfaced as a ``pt_collector_errors``
        sample instead of killing the scrape (a wedged adapter must not
        take the whole telemetry endpoint down with it)."""
        fams: List[MetricFamily] = []
        with self._lock:
            instruments = list(self._instruments.values())
            collectors = list(self._collectors)
        for inst in instruments:
            fams.append(inst.family())
        errors = 0
        for coll in collectors:
            try:
                fams.extend(coll())
            except Exception:
                errors += 1
        if errors:
            fams.append(MetricFamily(
                "pt_collector_errors", "gauge",
                "collectors that raised during this scrape").add(errors))
        # merge same-name families (e.g. per-replica engine families from a
        # fleet collector): Prometheus text allows ONE block per name
        merged: Dict[str, MetricFamily] = {}
        for fam in fams:
            have = merged.get(fam.name)
            if have is None:
                merged[fam.name] = fam
            else:
                have.samples.extend(fam.samples)
        return list(merged.values())

    def dump(self) -> str:
        """The whole registry in Prometheus text exposition format —
        the one-shot scrape the ``MetricsServer`` ``/metrics`` endpoint
        serves."""
        lines: List[str] = []
        for fam in self.collect():
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, MetricFamily]:
    """Parse Prometheus text exposition back into families — the validator
    run over a scrape (name -> family; histogram suffixes fold into their
    base family)."""
    fams: Dict[str, MetricFamily] = {}
    types: Dict[str, str] = {}
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(\S+)\s*$")
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

    def unescape(s: str) -> str:
        # inverse of _escape: \\ -> \, \n -> newline, \" -> quote
        return (s.replace("\\\\", "\x00").replace("\\n", "\n")
                .replace('\\"', '"').replace("\x00", "\\"))
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            parts = rest.split()
            if len(parts) == 2:
                types[parts[0]] = parts[1]
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            raise ValueError(f"unparseable metric line: {raw!r}")
        name, _, labelblob, value = m.groups()
        base = name
        suffix = ""
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and name[: -len(suf)] in types:
                base, suffix = name[: -len(suf)], suf
                break
        fam = fams.get(base)
        if fam is None:
            fam = fams[base] = MetricFamily(base,
                                            types.get(base, "untyped"))
        labels = {k: unescape(v)
                  for k, v in label_re.findall(labelblob or "")}
        v = float("inf") if value == "+Inf" else (
            float("-inf") if value == "-Inf" else float(value))
        fam.samples.append((suffix, labels, v))
    return fams
