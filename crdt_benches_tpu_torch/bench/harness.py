"""Criterion-style measurement harness (a copy of the JAX package's
``bench/harness.py``): warm-up, repeated timed samples, robust statistics
(median/mean/stddev/min, quantiles, Tukey-fence outliers), throughput in
elements/sec where an element is one trace patch, bench ids of the form
``group/trace/backend``, JSON result files and named baseline
save/compare.

:func:`measure` puts a ``torch.cuda.synchronize()`` inside each timed
sample, so queued device work is always counted.  Results are written as
``bench_results/torch_<name>.json`` (``torch_latest.json`` by default), so
the port never overwrites the JAX package's result files.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Callable

import torch

#: ``bench_results/`` at the repository root.
RESULTS_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "bench_results")
)
#: The prefix of every result file the port writes or reads.
PREFIX = "torch_"


@dataclass
class Sample:
    seconds: float


@dataclass
class BenchResult:
    group: str  # "upstream" | "downstream" | ...
    trace: str
    backend: str
    elements: int  # throughput element count (= patch count)
    samples: list[float] = field(default_factory=list)
    replicas: int = 1
    extra: dict = field(default_factory=dict)

    @property
    def bench_id(self) -> str:
        return f"{self.group}/{self.trace}/{self.backend}"

    @property
    def median(self) -> float:
        s = sorted(self.samples)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples)

    @property
    def stddev(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        m = self.mean
        return math.sqrt(sum((x - m) ** 2 for x in self.samples)
                         / (len(self.samples) - 1))

    @property
    def best(self) -> float:
        return min(self.samples)

    @property
    def worst(self) -> float:
        return max(self.samples)

    @property
    def p50(self) -> float:
        return quantiles(self.samples)["p50"]

    @property
    def p95(self) -> float:
        return quantiles(self.samples)["p95"]

    @property
    def p99(self) -> float:
        return quantiles(self.samples)["p99"]

    @property
    def outliers(self) -> dict:
        """Tukey classification of this cell's final kept samples."""
        return classify_outliers(self.samples)

    @property
    def elements_per_sec(self) -> float:
        """Criterion throughput: elements / median sample time, scaled by the
        replica count for batched backends (aggregate throughput)."""
        return self.elements * self.replicas / self.median

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(
            median=self.median,
            mean=self.mean,
            stddev=self.stddev,
            min=self.best,
            max=self.worst,
            **quantiles(self.samples),
            elements_per_sec=self.elements_per_sec,
            outliers=self.outliers,
        )
        # measure() hands back a SampleList carrying any samples it
        # discarded as severe outliers and re-ran: persist them, so every
        # saved result explains itself.
        discarded = getattr(self.samples, "discarded", [])
        if discarded:
            d["discarded_outliers"] = list(discarded)
        return d


def _quantile(sorted_s: list[float], p: float) -> float:
    n = len(sorted_s)
    k = p * (n - 1)
    f = math.floor(k)
    c = min(f + 1, n - 1)
    return sorted_s[f] + (sorted_s[c] - sorted_s[f]) * (k - f)


def quantiles(samples, ps=(0.5, 0.95, 0.99)) -> dict[str, float]:
    """Linear-interpolated quantiles as a {"p50": ..., "p95": ..., ...}
    table (the same interpolation as the Tukey fences)."""
    if not samples:
        raise ValueError("quantiles of an empty sample list")
    s = sorted(samples)
    return {f"p{100 * p:g}": _quantile(s, p) for p in ps}


def steady_quantiles(
    samples, skip_flags, ps=(0.5, 0.95, 0.99)
) -> tuple[dict[str, float], float, int]:
    """Quantiles over the samples NOT flagged in ``skip_flags`` (the
    serve family's steady-state latency report, where flagged rounds are
    cold-start rounds, not serving jitter).  Falls back to the full list
    when every sample is flagged (tiny drains).  Returns (quantile table,
    flagged_time, flagged_count)."""
    if len(samples) != len(skip_flags):
        raise ValueError(
            f"{len(samples)} samples vs {len(skip_flags)} skip flags"
        )
    kept = [s for s, skip in zip(samples, skip_flags) if not skip]
    skipped = [s for s, skip in zip(samples, skip_flags) if skip]
    return quantiles(kept or list(samples), ps), sum(skipped), len(skipped)


def summarize(values) -> dict:
    """Compact count/mean/max summary of a metric list (the result form
    of a per-event series).  Zeros when the list is empty, so every run
    shares one schema."""
    vs = list(values)
    if not vs:
        return {"n": 0, "mean": 0.0, "max": 0}
    return {
        "n": len(vs),
        "mean": float(sum(vs)) / len(vs),
        "max": max(vs),
    }


def classify_outliers(samples: list[float]) -> dict:
    """Tukey fences: mild outside Q1/Q3 +- 1.5*IQR, severe outside
    +- 3*IQR (IQR floored at 2% of the median, so timer jitter in tightly
    clustered samples is not flagged)."""
    n = len(samples)
    if n < 4:
        return {"mild": 0, "severe": 0, "flagged": []}
    s = sorted(samples)
    q1, q3 = _quantile(s, 0.25), _quantile(s, 0.75)
    med = _quantile(s, 0.5)
    iqr = max(q3 - q1, 0.02 * abs(med))
    lo3, lo15 = q1 - 3.0 * iqr, q1 - 1.5 * iqr
    hi15, hi3 = q3 + 1.5 * iqr, q3 + 3.0 * iqr
    severe = [x for x in samples if x < lo3 or x > hi3]
    mild = [x for x in samples
            if (lo3 <= x < lo15) or (hi15 < x <= hi3)]
    out = {"mild": len(mild), "severe": len(severe),
           "flagged": sorted(mild + severe)}
    if severe or mild:
        out["fences"] = [lo3, lo15, hi15, hi3]
    return out


class SampleList(list):
    """The kept samples plus ``discarded`` severe outliers that were
    re-measured and replaced, and how many ``reruns`` that took."""

    def __init__(self, xs=()):
        super().__init__(xs)
        self.discarded: list[float] = []
        self.reruns: int = 0


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(
    fn: Callable[[], object],
    *,
    warmup: int = 1,
    samples: int = 5,
    min_sample_time: float = 0.0,
    max_reruns: int = 2,
) -> SampleList:
    """Time ``fn`` ``samples`` times after ``warmup`` untimed calls; each
    call ends with a device synchronize.  If one call is shorter than
    ``min_sample_time``, a sample loops over calls and divides (Criterion's
    iteration batching).  Severe Tukey outliers are re-measured up to
    ``max_reruns`` times; replaced values are kept in ``.discarded``."""

    def one_sample() -> float:
        iters = 0
        t0 = time.perf_counter()
        while True:
            fn()
            _sync()
            iters += 1
            dt = time.perf_counter() - t0
            if dt >= min_sample_time:
                break
        return dt / iters

    for _ in range(warmup):
        fn()
        _sync()
    out = SampleList(one_sample() for _ in range(samples))
    for _ in range(max_reruns):
        cls = classify_outliers(out)
        if not cls["severe"]:
            break
        lo3, hi3 = cls["fences"][0], cls["fences"][3]
        keep = SampleList(x for x in out if lo3 <= x <= hi3)
        keep.discarded = out.discarded + [
            x for x in out if x < lo3 or x > hi3
        ]
        keep.reruns = out.reruns + 1
        keep.extend(one_sample() for _ in range(samples - len(keep)))
        out = keep
    return out


# ---- persistence / baselines (Criterion's --save-baseline / --baseline) ----


def _path(name: str, results_dir: str | None) -> str:
    return os.path.join(results_dir or RESULTS_DIR, f"{PREFIX}{name}.json")


def save_results(results: list[BenchResult], name: str = "latest",
                 results_dir: str | None = None) -> str:
    """Write ``results`` as ``torch_<name>.json`` in ``results_dir``
    (default ``bench_results/``); returns the path."""
    path = _path(name, results_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in results], f, indent=2)
    return path


def load_results(name: str,
                 results_dir: str | None = None) -> dict[str, dict]:
    """The records of ``torch_<name>.json`` by bench id."""
    with open(_path(name, results_dir)) as f:
        return {d["group"] + "/" + d["trace"] + "/" + d["backend"]: d
                for d in json.load(f)}


def compare_to_baseline(
    results: list[BenchResult], baseline_name: str,
    results_dir: str | None = None,
) -> list[str]:
    """Human-readable change report against a saved baseline."""
    base = load_results(baseline_name, results_dir)
    lines = []
    for r in results:
        b = base.get(r.bench_id)
        if not b:
            lines.append(f"{r.bench_id}: new")
            continue
        change = (r.median - b["median"]) / b["median"] * 100.0
        lines.append(
            f"{r.bench_id}: {r.median * 1e3:.2f}ms vs {b['median'] * 1e3:.2f}ms "
            f"({change:+.1f}%)"
        )
    return lines


def markdown_table(results: list[BenchResult]) -> str:
    """The bench table: one row per (group, trace), one column per
    backend."""
    backends = sorted({r.backend for r in results})
    rows: dict[tuple[str, str], dict[str, BenchResult]] = {}
    for r in results:
        rows.setdefault((r.group, r.trace), {})[r.backend] = r
    out = ["| group | trace | " + " | ".join(backends) + " |"]
    out.append("|---" * (2 + len(backends)) + "|")
    for (group, trace), by_backend in sorted(rows.items()):
        cells = []
        for b in backends:
            r = by_backend.get(b)
            cells.append(f"{r.elements_per_sec:,.0f}/s" if r else "—")
        out.append(f"| {group} | {trace} | " + " | ".join(cells) + " |")
    return "\n".join(out)
