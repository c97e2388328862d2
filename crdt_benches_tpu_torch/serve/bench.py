"""The serving fleet's benchmark (the JAX package's ``serve/bench.py``
``run_serve_bench``, its core and its tiered residency): build the fleet,
construct the pool, prepare the streams, drain once, verify against the
oracle, report.  ``serve_tiers`` (``hot=ROWS,warm=DOCS``,
:func:`parse_tier_spec`) scales the device rows and arms the warm tier
and its prefetcher; the report then gains a ``residency`` block and the
metric id is ``serve/tier/<mix>/<fleet>``.

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


def parse_tier_spec(spec: str, slots: tuple[int, ...]
                    ) -> tuple[tuple[int, ...], int]:
    """The ``--serve-tiers hot=ROWS,warm=DOCS`` grammar.

    ``hot=ROWS`` scales the per-class slot table proportionally so the
    total device-row budget lands at ~ROWS (each class keeps >= 2 rows
    so every capacity class stays servable); ``warm=DOCS`` bounds the
    host warm tier (and arms the prefetcher).  ``hot`` may be omitted:
    ``warm=256`` alone keeps ``slots``.  Returns ``(slots, warm_docs)``."""
    hot = None
    warm = None
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"tier spec token {tok!r}: expected k=v")
        key, val = tok.split("=", 1)
        key = key.strip()
        if key == "hot":
            hot = int(val)
        elif key == "warm":
            warm = int(val)
        else:
            raise ValueError(
                f"tier spec: unknown key {key!r} (expected hot/warm)"
            )
    if warm is None or warm <= 0:
        raise ValueError(
            f"tier spec {spec!r}: warm=DOCS (> 0) is required — the "
            "three-tier pool IS the warm tier"
        )
    if hot is not None:
        if hot < 2 * len(slots):
            raise ValueError(
                f"tier spec: hot={hot} below the floor of 2 rows per "
                f"capacity class ({2 * len(slots)})"
            )
        total = sum(slots)
        slots = tuple(
            max(2, round(s * hot / total)) for s in slots
        )
    return slots, warm


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
    arrival_dist: str = "uniform",
    macro_k: int = 8,
    batch_chars: int = 256,
    verify_sample: int = 0,
    serve_kernel: str = "fused",
    serve_tiers: str | None = None,
    device: str | torch.device = "cuda",
    pool_hook=None,
    log=print,
) -> dict:
    """Build, drain and verify one fleet through ``serve_kernel``
    (``serve/pool.py SERVE_KERNELS``), with three-tier residency when
    ``serve_tiers`` is given (:func:`parse_tier_spec`); returns the
    report.  ``pool_hook(pool)``, if given, runs on the pool just before
    the drain (``chip_smoke.py`` arms the pool's CUDA-event spans
    there)."""
    warm_docs = 0
    if serve_tiers:
        slots, warm_docs = parse_tier_spec(serve_tiers, slots)
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels()  # build and load the kernels before the clock starts
    t0 = time.perf_counter()
    sessions = build_fleet(n_docs, mix=mix, seed=seed,
                           arrival_span=arrival_span,
                           arrival_dist=arrival_dist)
    pool = DocPool(classes=classes, slots=slots, serve_kernel=serve_kernel,
                   device=dev, warm_docs=warm_docs)
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
        if warm_docs:
            log(f"serve: tiered residency: hot {sum(slots)} rows "
                f"({'/'.join(map(str, slots))}), warm {warm_docs} docs, "
                f"cold spool compressed, prefetch "
                f"{'armed' if pool.prefetcher is not None else 'off'}")
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
        pf = pool.prefetcher
        hits, restores = pool.warm_hits, pool.restores
        residency = None if not warm_docs else {
            "version": 1,
            "tiers": serve_tiers,
            "hot_rows_budget": sum(slots),
            "warm_budget": warm_docs,
            "arrival_dist": arrival_dist,
            "hot_rows_final": pool.hot_rows,
            "warm_docs_final": len(pool.warm),
            "cold_docs_final": pool.cold_docs,
            "evictions": stats.evictions,
            "warm_hits": hits,
            "warm_evictions": pool.warm_evictions,
            "cold_restores": restores,
            "prefetch_hits": pool.prefetch_hits,
            "prefetch_submitted": pf.submitted if pf is not None else 0,
            "prefetch_harvested": pf.harvested if pf is not None else 0,
            "prefetch_dropped": pf.dropped if pf is not None else 0,
            "prefetch_errors": pf.errors if pf is not None else 0,
            "prefetch_wasted": sched.prefetch_wasted,
            "prefetch_missed": sched.prefetch_missed,
            # of the admissions that needed a doc's state back, the
            # share that avoided the synchronous cold read
            "hit_rate": (hits / (hits + restores)
                         if hits + restores else None),
        }
        if residency is not None:
            log(f"serve: residency: hot {pool.hot_rows}/{sum(slots)} rows, "
                f"warm {len(pool.warm)}/{warm_docs} docs, cold "
                f"{pool.cold_docs}; warm hits {hits} (prefetched "
                f"{pool.prefetch_hits}), cold restores {restores}, warm to "
                f"cold {pool.warm_evictions}, limbo pulls "
                f"{sched.limbo_pulls}; hit rate "
                + (f"{residency['hit_rate']:.3f}" if hits + restores
                   else "n/a"))
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
            "fresh_admits": pool.fresh_admits,
            "phase_seconds": dict(stats.phase_seconds),
            "setup_seconds": setup_s,
            "verify": "all" if verify_sample <= 0 else "sample",
            "verified_docs": len(ids),
            "verified_per_class": {str(c): n for c, n in
                                   sorted(docs_per_class.items())},
            "verify_seconds": verify_s,
            "verify_ok": verify_ok,
            **({} if residency is None else {
                "arrival_dist": arrival_dist,
                "limbo_pulls": sched.limbo_pulls,
                "residency": residency}),
        }
    finally:
        pool.close()
