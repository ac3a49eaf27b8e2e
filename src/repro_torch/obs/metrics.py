"""Host-side metric primitives: counters, gauges, log-bucketed histograms
(the port's copy of ``repro/obs/metrics.py``, kept line for line).

Everything here is plain Python state on the host: no tensors, no device
work, no clocks.  The serving engine records into these objects from
values its tick's one device-to-host copy already brought to the host,
so instrumentation adds no copy, no sync and no launch.  Callers pass
concrete Python numbers.

Histograms use geometric buckets ``[start·factor^i, start·factor^(i+1))``
stored sparsely by integer bucket index, so one histogram covers many
orders of magnitude (latencies, trial counts) in a handful of dict
entries, and two histograms on the same lattice merge exactly.  State is
single-writer: the engine's tick loop and the scheduler run on one thread
(the front door's event loop).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple


class LogHistogram:
    """Sparse geometric-bucket histogram.

    Bucket ``i`` holds values in ``[start * factor**i, start * factor**(i+1))``
    for any integer ``i`` (negative indices reach below ``start``); values
    below ``start * factor**_UNDER_RANGE`` land in a single underflow
    bucket.  Exact ``sum``/``count``/``min``/``max`` are tracked alongside,
    so ``mean()`` is exact and percentiles are bucket-resolution
    (a relative error of at most ``factor``).
    """

    _UNDER_RANGE = -64  # below start*factor**-64 → underflow bucket

    __slots__ = ("start", "factor", "counts", "underflow", "count",
                 "total", "vmin", "vmax")

    def __init__(self, start: float = 1e-6, factor: float = 2.0):
        if start <= 0.0:
            raise ValueError(f"start must be positive, got {start}")
        if factor <= 1.0:
            raise ValueError(f"factor must exceed 1, got {factor}")
        self.start = float(start)
        self.factor = float(factor)
        self.counts: Dict[int, int] = {}
        self.underflow = 0
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    # ---------------------------------------------------------------- lattice
    def bucket_edges(self, i: int) -> Tuple[float, float]:
        """(lo, hi) of bucket ``i``: ``[start·factor^i, start·factor^(i+1))``."""
        return (self.start * self.factor ** i,
                self.start * self.factor ** (i + 1))

    def bucket_index(self, v: float) -> int:
        """Index ``i`` with ``lo(i) <= v < hi(i)``, exact against
        ``bucket_edges`` — the log/floor estimate is snapped onto the edge
        lattice so edge values never misbucket to float rounding."""
        i = int(math.floor(math.log(v / self.start) / math.log(self.factor)))
        while v >= self.start * self.factor ** (i + 1):
            i += 1
        while v < self.start * self.factor ** i:
            i -= 1
        return i

    # --------------------------------------------------------------- recording
    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        if v < self.start * self.factor ** self._UNDER_RANGE:
            self.underflow += 1
        else:
            i = self.bucket_index(v)
            self.counts[i] = self.counts.get(i, 0) + 1

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Exact merge of two histograms on the same bucket lattice."""
        if (self.start, self.factor) != (other.start, other.factor):
            raise ValueError(
                f"cannot merge histograms on different lattices: "
                f"({self.start}, {self.factor}) vs "
                f"({other.start}, {other.factor})")
        out = LogHistogram(self.start, self.factor)
        for src in (self, other):
            for i, n in src.counts.items():
                out.counts[i] = out.counts.get(i, 0) + n
            out.underflow += src.underflow
            out.count += src.count
            out.total += src.total
            for v in (src.vmin, src.vmax):
                if v is None:
                    continue
                out.vmin = v if out.vmin is None else min(out.vmin, v)
                out.vmax = v if out.vmax is None else max(out.vmax, v)
        return out

    # ----------------------------------------------------------------- queries
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile at bucket resolution.

        Returns the upper edge of the bucket holding the rank-``q`` value,
        clamped to the exact observed ``[vmin, vmax]`` — so p0 ≥ vmin, p100
        == vmax, and the estimate is never below the true value by more
        than one bucket width (relative error ≤ ``factor``).
        """
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        if self.count == 0:
            return float("nan")
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = self.underflow
        if rank <= seen:
            return self.vmin  # underflow holds the smallest values
        for i in sorted(self.counts):
            seen += self.counts[i]
            if rank <= seen:
                hi = self.start * self.factor ** (i + 1)
                return max(self.vmin, min(hi, self.vmax))
        return self.vmax  # pragma: no cover — seen always reaches count

    def to_dict(self) -> dict:
        """JSON-safe snapshot (committed into BENCH rows / flight dumps)."""
        return {
            "start": self.start,
            "factor": self.factor,
            "buckets": {str(i): n for i, n in sorted(self.counts.items())},
            "underflow": self.underflow,
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
        }


class _LabeledMetric:
    """Base for metrics with a fixed label schema and per-labelset children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self._children: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def labelsets(self):
        """Sorted (labelvalues, child) pairs — exposition order."""
        return sorted(self._children.items())

    def _fmt(self, key: Tuple[str, ...], extra: str = "") -> str:
        pairs = [f'{k}="{v}"' for k, v in zip(self.labelnames, key)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_LabeledMetric):
    """Monotone labelled counter."""

    kind = "counter"

    def inc(self, v: float = 1.0, **labels) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (v={v})")
        key = self._key(labels)
        self._children[key] = self._children.get(key, 0.0) + v

    def value(self, **labels) -> float:
        return self._children.get(self._key(labels), 0.0)

    def total(self) -> float:
        """Sum over every labelset."""
        return sum(self._children.values())


class Gauge(_LabeledMetric):
    """Labelled gauge (last value wins)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        self._children[self._key(labels)] = float(v)

    def value(self, **labels) -> float:
        return self._children.get(self._key(labels), 0.0)


class Histogram(_LabeledMetric):
    """Labelled histogram — one ``LogHistogram`` child per labelset."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = (),
                 start: float = 1e-6, factor: float = 2.0):
        super().__init__(name, help, labels)
        self.start = float(start)
        self.factor = float(factor)

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = LogHistogram(self.start,
                                                       self.factor)
        child.observe(v)

    def data(self, **labels) -> LogHistogram:
        """The child histogram for a labelset (empty if never observed)."""
        return self._children.get(self._key(labels),
                                  LogHistogram(self.start, self.factor))

    def percentile(self, q: float, **labels) -> float:
        return self.data(**labels).percentile(q)

    def mean(self, **labels) -> float:
        return self.data(**labels).mean()


class MetricRegistry:
    """Get-or-create registry of named metrics with a text exposition.

    ``counter``/``gauge``/``histogram`` are idempotent: asking for an
    existing name returns the existing instrument (schema must match), so
    several engines can share one registry and the helper that declares
    the engine instrument set can run once per engine.
    """

    def __init__(self):
        self._metrics: Dict[str, _LabeledMetric] = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, labels=labels, **kw)
            return m
        if not isinstance(m, cls) or m.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  start: float = 1e-6, factor: float = 2.0) -> Histogram:
        h = self._get_or_create(Histogram, name, help, labels,
                                start=start, factor=factor)
        if (h.start, h.factor) != (float(start), float(factor)):
            raise ValueError(
                f"histogram {name!r} already registered with lattice "
                f"({h.start}, {h.factor})")
        return h

    def get(self, name: str) -> _LabeledMetric:
        return self._metrics[name]

    def names(self):
        return sorted(self._metrics)

    # -------------------------------------------------------------- exporters
    def expose(self) -> str:
        """Prometheus text exposition (histograms as cumulative buckets)."""
        def le(x) -> str:
            return 'le="%s"' % (x if isinstance(x, str) else "%g" % x)

        lines = []
        for name in self.names():
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, child in m.labelsets():
                if m.kind == "histogram":
                    cum = child.underflow
                    if cum:
                        lo = child.start * child.factor ** child._UNDER_RANGE
                        lines.append(f"{name}_bucket"
                                     f"{m._fmt(key, le(lo))} {cum}")
                    for i in sorted(child.counts):
                        cum += child.counts[i]
                        hi = child.start * child.factor ** (i + 1)
                        lines.append(f"{name}_bucket"
                                     f"{m._fmt(key, le(hi))} {cum}")
                    lines.append(f"{name}_bucket"
                                 f"{m._fmt(key, le('+Inf'))} {child.count}")
                    lines.append(f"{name}_sum{m._fmt(key)} {child.total:g}")
                    lines.append(f"{name}_count{m._fmt(key)} {child.count}")
                else:
                    lines.append(f"{name}{m._fmt(key)} {child:g}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-safe nested snapshot: {name: {type, values: {labels: v}}}."""
        out = {}
        for name in self.names():
            m = self._metrics[name]
            values = {}
            for key, child in m.labelsets():
                lk = ",".join(f"{k}={v}"
                              for k, v in zip(m.labelnames, key))
                values[lk] = (child.to_dict() if m.kind == "histogram"
                              else child)
            out[name] = {"type": m.kind, "values": values}
        return out
