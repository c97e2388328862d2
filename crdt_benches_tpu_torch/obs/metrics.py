"""Typed metric registry: Counter / Gauge / fixed-bucket Histogram (the
JAX package's ``obs/metrics.py``).

Replaces the grown-by-accretion telemetry lists of ``ServeStats``: a
long drain used to append one float per macro-round to ``occupancy`` /
``queue_depth`` / ``round_latencies`` forever; histograms here hold
O(buckets) state regardless of run length and still answer
p50/p99/p99.9 within bucket resolution.  Everything is stdlib-only and
allocation-light — ``Histogram.observe`` is a bisect + three adds, safe
on the serving hot path (no numpy, no device traffic).

Design points:

- **fixed, declared buckets**: two histograms with the same bounds are
  *mergeable* (bucket-wise add — associative, the property sharded or
  resumed runs rely on; asserted in tests);
- **quantiles from buckets**: linear interpolation inside the covering
  bucket, clamped to the observed min/max, so a p99 from a histogram
  tracks the exact-list p99 within the bucket's width;
- **versioned serialization**: ``MetricsRegistry.to_dict()`` is the
  serve artifact's ``metrics`` block (``version`` bumps on schema
  change); ``from_dict`` round-trips it losslessly;
- **registered constant names**: dotted lowercase (``serve.pool.
  evictions``), never f-strings on the hot path — dynamic context
  belongs in separate pre-registered series (e.g. one drain-latency
  histogram per cause tag), not in name interpolation.
"""

from __future__ import annotations

from bisect import bisect_left

#: Bump when the serialized registry layout changes shape.
METRICS_VERSION = 1


def geometric_bounds(lo: float, hi: float, per_octave: int = 4
                     ) -> tuple[float, ...]:
    """Geometric bucket upper bounds covering [lo, hi] with
    ``per_octave`` buckets per doubling — the relative quantile error
    is bounded by one bucket's ratio (2**(1/per_octave))."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    factor = 2.0 ** (1.0 / per_octave)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


#: Macro-round / per-doc latency buckets (seconds): 100us .. ~2min,
#: 4 per octave (~21% resolution).
LATENCY_BUCKETS_S = geometric_bounds(1e-4, 128.0, per_octave=4)

#: Fleet occupancy is a fraction: 20 linear buckets.
OCCUPANCY_BUCKETS = tuple(i / 20.0 for i in range(1, 21))

#: Queue depths / waiting-doc counts: powers of two to 64k.
DEPTH_BUCKETS = (0.0,) + tuple(float(1 << i) for i in range(17))


class Counter:
    """A monotonically increasing integer."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: int = 0):
        self.name = name
        self.value = int(value)

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_dict(self) -> int:
        return self.value


class Gauge:
    """A last-write-wins scalar (plus its observed extrema)."""

    __slots__ = ("name", "value", "vmin", "vmax", "updates")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None
        self.updates = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self.updates += 1

    def to_dict(self) -> dict:
        return {
            "value": self.value, "min": self.vmin, "max": self.vmax,
            "updates": self.updates,
        }


class Histogram:
    """Fixed-bucket histogram with mergeable buckets.

    ``bounds`` are ascending bucket *upper* edges; an implicit overflow
    bucket catches anything above the last edge.  Exact ``count`` /
    ``total`` / ``min`` / ``max`` ride along, so means are exact and
    quantiles clamp to the observed range.
    """

    __slots__ = ("name", "bounds", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, name: str, bounds):
        bounds = tuple(float(b) for b in bounds)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"bucket bounds not ascending: {bounds}")
        self.name = name
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def _bucket_edges(self, i: int) -> tuple[float, float]:
        lo = self.bounds[i - 1] if i > 0 else (
            self.vmin if self.vmin is not None else 0.0
        )
        hi = self.bounds[i] if i < len(self.bounds) else (
            self.vmax if self.vmax is not None else lo
        )
        return lo, hi

    def quantile(self, p: float) -> float:
        """Linear-interpolated quantile from the buckets, clamped to
        the observed [min, max] (exact for p=0/1 by construction)."""
        if not self.count:
            raise ValueError(f"quantile of empty histogram {self.name}")
        rank = p * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if rank < cum + c:
                lo, hi = self._bucket_edges(i)
                frac = (rank - cum + 1.0) / c
                v = lo + (hi - lo) * min(1.0, max(0.0, frac))
                return min(max(v, self.vmin), self.vmax)
            cum += c
        return self.vmax  # p == 1 tail

    def quantiles(self, ps=(0.5, 0.95, 0.99)) -> dict[str, float]:
        """Same key format as ``bench/harness.py quantiles``."""
        return {f"p{100 * p:g}": self.quantile(p) for p in ps}

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise add of ``other`` into self (associative and
        commutative over same-bounds histograms).  Returns self."""
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge {other.name} into {self.name}: "
                "bucket bounds differ"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        if other.vmin is not None:
            self.vmin = other.vmin if self.vmin is None else min(
                self.vmin, other.vmin
            )
        if other.vmax is not None:
            self.vmax = other.vmax if self.vmax is None else max(
                self.vmax, other.vmax
            )
        return self

    @classmethod
    def merged(cls, *hs: "Histogram") -> "Histogram":
        """A fresh histogram holding the bucket-wise sum of ``hs``."""
        if not hs:
            raise ValueError("merged() of no histograms")
        out = cls(hs[0].name, hs[0].bounds)
        for h in hs:
            out.merge(h)
        return out

    def to_dict(self) -> dict:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
        }

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "Histogram":
        h = cls(name, d["bounds"])
        counts = [int(c) for c in d["counts"]]
        if len(counts) != len(h.counts):
            raise ValueError(
                f"histogram {name}: {len(counts)} counts for "
                f"{len(h.bounds)} bounds"
            )
        h.counts = counts
        h.count = int(d["count"])
        h.total = float(d["sum"])
        h.vmin = d["min"]
        h.vmax = d["max"]
        return h


class MetricsRegistry:
    """Get-or-create home for named metrics; one per serve drain.

    The registry is the artifact surface: ``to_dict()`` is written as
    the versioned ``metrics`` block, ``from_dict`` reads one back
    (the JAX package's ``tools/bench_compare.py`` diffs two of them).  Re-requesting a
    name returns the existing instance (so scheduler, pool, journal and
    faults can all hold references to the same series), and
    :meth:`attach` adopts a metric created before the registry existed
    — the pool's counters predate the scheduler that owns the run's
    registry.
    """

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, bounds=LATENCY_BUCKETS_S) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, bounds)
        elif tuple(float(b) for b in bounds) != h.bounds:
            raise ValueError(
                f"histogram {name} re-registered with different bounds"
            )
        return h

    def attach(self, metric) -> None:
        """Adopt an existing metric object under its own name (identity
        preserved: the owner keeps incrementing the same instance)."""
        table = {
            Counter: self.counters, Gauge: self.gauges,
            Histogram: self.histograms,
        }[type(metric)]
        table[metric.name] = metric

    def to_dict(self) -> dict:
        return {
            "version": METRICS_VERSION,
            "counters": {
                k: c.to_dict() for k, c in sorted(self.counters.items())
            },
            "gauges": {
                k: g.to_dict() for k, g in sorted(self.gauges.items())
            },
            "histograms": {
                k: h.to_dict()
                for k, h in sorted(self.histograms.items())
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MetricsRegistry":
        ver = d.get("version")
        if ver != METRICS_VERSION:
            raise ValueError(
                f"metrics block version {ver!r} != {METRICS_VERSION}"
            )
        reg = cls()
        for k, v in d.get("counters", {}).items():
            reg.counters[k] = Counter(k, v)
        for k, v in d.get("gauges", {}).items():
            g = Gauge(k)
            g.value = v["value"]
            g.vmin, g.vmax = v["min"], v["max"]
            g.updates = int(v["updates"])
            reg.gauges[k] = g
        for k, v in d.get("histograms", {}).items():
            reg.histograms[k] = Histogram.from_dict(k, v)
        return reg
