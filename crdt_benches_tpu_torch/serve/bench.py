"""The serving fleet's benchmark (the JAX package's ``serve/bench.py``
``run_serve_bench``, its core): build the fleet, construct the pool,
prepare the streams, drain once, verify against the oracle, report.

Timed region: the drain, from the first macro-round to the final device
fence (``FleetScheduler.run``).  The metric is fleet patches per second
(every session's trace patches over the drain's wall time).  Verification
replays each verified doc's trace through the oracle and compares the
decoded document byte for byte: every document by default, or a seeded
per-class sample of ``verify_sample`` docs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._build import kernels
from ..device import resolve_device
from ..oracle.text_oracle import replay_trace
from .pool import DocPool
from .scheduler import FleetScheduler, prepare_streams
from .workload import build_fleet


def _verify_ids(pool: DocPool, sessions, verify_sample: int,
                seed: int) -> list[int]:
    """Every doc id (``verify_sample`` 0), or a seeded sample of about
    ``verify_sample`` docs spread over every final class (the JAX bench's
    rule: ceil(sample / classes) per class, seed + 1)."""
    if verify_sample <= 0:
        return [s.doc_id for s in sessions]
    by_class: dict[int, list[int]] = {}
    for s in sessions:
        rec = pool.docs[s.doc_id]
        cls = rec.cls or pool.class_for(max(rec.length, 1))
        by_class.setdefault(cls, []).append(s.doc_id)
    per_class = max(1, -(-verify_sample // max(1, len(by_class))))
    rng = np.random.default_rng(seed + 1)
    out: list[int] = []
    for cls in sorted(by_class):
        ids = by_class[cls]
        out.extend(int(x) for x in rng.choice(
            ids, size=min(per_class, len(ids)), replace=False))
    return out


def run_serve_bench(
    mix: str = "mixed",
    n_docs: int = 4096,
    batch: int = 64,
    classes: tuple[int, ...] = (256, 1024, 4096, 8192, 49152),
    slots: tuple[int, ...] = (2048, 512, 128, 32, 16),
    seed: int = 0,
    arrival_span: int = 8,
    macro_k: int = 8,
    batch_chars: int = 256,
    verify_sample: int = 0,
    serve_kernel: str = "fused",
    device: str | torch.device = "cuda",
    pool_hook=None,
    log=print,
) -> dict:
    """Build, drain and verify one fleet through ``serve_kernel``
    (``serve/pool.py SERVE_KERNELS``); returns the report.
    ``pool_hook(pool)``, if given, runs on the pool just before the drain
    (``chip_smoke.py`` arms the pool's CUDA-event spans there)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels()  # build and load the kernels before the clock starts
    t0 = time.perf_counter()
    sessions = build_fleet(n_docs, mix=mix, seed=seed,
                           arrival_span=arrival_span)
    pool = DocPool(classes=classes, slots=slots, serve_kernel=serve_kernel,
                   device=dev)
    try:
        streams = prepare_streams(sessions, pool, batch=batch,
                                  batch_chars=batch_chars)
        sched = FleetScheduler(pool, streams, batch=batch, macro_k=macro_k,
                               batch_chars=batch_chars)
        setup_s = time.perf_counter() - t0
        total_ops = sum(s.remaining for s in streams.values())
        log(f"serve: {n_docs} docs ({mix}, seed {seed}), {total_ops} range "
            f"ops, classes {classes} slots {slots} batch {batch} chars "
            f"{batch_chars} K {macro_k} kernel {serve_kernel} on {dev}; "
            f"set-up {setup_s:.1f} s")
        if pool_hook is not None:
            pool_hook(pool)
        stats = sched.run()
        if not sched.done:
            raise RuntimeError("scheduler stopped with pending work")
        lat = stats.latency_quantiles()
        rate = stats.patches / stats.wall_time

        t1 = time.perf_counter()
        ids = _verify_ids(pool, sessions, verify_sample, seed)
        session_of = {s.doc_id: s for s in sessions}
        oracle: dict[int, str] = {}  # id(trace) -> content (shared windows)
        failures = []
        for d in ids:
            tr = session_of[d].trace
            want = oracle.get(id(tr))
            if want is None:
                want = oracle[id(tr)] = replay_trace(tr)
            if pool.decode(d) != want:
                failures.append(d)
        verify_s = time.perf_counter() - t1
        docs_per_class: dict[int, int] = {}
        for d in ids:
            rec = pool.docs[d]
            cls = rec.cls or pool.class_for(max(rec.length, 1))
            docs_per_class[cls] = docs_per_class.get(cls, 0) + 1
        verify_ok = bool(ids) and not failures
        log(f"serve: drained in {stats.wall_time:.3f} s over {stats.rounds} "
            f"macro-rounds ({stats.slices} device rounds, "
            f"{stats.dispatches} dispatches) -> {rate:,.0f} patches/s; "
            f"verified {len(ids)} docs in {verify_s:.1f} s: "
            + ("all byte-identical to the oracle" if verify_ok
               else f"MISMATCH on docs {failures[:16]}"))
        return {
            "fleet_docs": n_docs, "mix": mix, "seed": seed,
            "batch": batch, "batch_chars": batch_chars, "macro_k": macro_k,
            "serve_kernel": serve_kernel,
            "classes": list(classes), "slots": list(slots),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "patches": stats.patches,
            "wall_time": stats.wall_time,
            "patches_per_sec": rate,
            "batch_latency": lat,
            "rounds": stats.rounds,
            "device_rounds": stats.slices,
            "dispatches": stats.dispatches,
            "range_ops": stats.ops,
            "unit_ops": stats.unit_ops,
            "coalesce_ratio": stats.coalesce_ratio,
            "pad_fraction": stats.pad_fraction,
            "evictions": stats.evictions,
            "restores": stats.restores,
            "promotions": stats.promotions,
            "admissions": stats.admissions,
            "phase_seconds": dict(stats.phase_seconds),
            "setup_seconds": setup_s,
            "verify": "all" if verify_sample <= 0 else "sample",
            "verified_docs": len(ids),
            "verified_per_class": {str(c): n for c, n in
                                   sorted(docs_per_class.items())},
            "verify_seconds": verify_s,
            "verify_ok": verify_ok,
        }
    finally:
        pool.close()
