"""Measurement harness: a copy of the JAX package's ``bench/harness.py``
``measure`` (warm-up, timed samples, Tukey-fence outlier re-runs), with a
``torch.cuda.synchronize()`` inside each timed sample so queued device
work is always counted."""

from __future__ import annotations

import math
import time
from typing import Callable

import torch


def _quantile(sorted_s: list[float], p: float) -> float:
    n = len(sorted_s)
    k = p * (n - 1)
    f = math.floor(k)
    c = min(f + 1, n - 1)
    return sorted_s[f] + (sorted_s[c] - sorted_s[f]) * (k - f)


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
    max_reruns: int = 2,
) -> SampleList:
    """Time ``fn`` ``samples`` times after ``warmup`` untimed calls; each
    sample ends with a device synchronize.  Severe Tukey outliers are
    re-measured up to ``max_reruns`` times; replaced values are kept in
    ``.discarded``."""

    def one_sample() -> float:
        t0 = time.perf_counter()
        fn()
        _sync()
        return time.perf_counter() - t0

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
