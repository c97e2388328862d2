"""Bench matrix runner of the port: the classic cells of the JAX package's
``bench/runner.py`` (a Criterion-style matrix of trace x backend cells)
filled with the port's backends, under the same bench ids and the same
JSON result schema.

    python -m crdt_benches_tpu_torch.bench.runner --traces sveltecomponent \\
        --backends cpp-rope,cpp-crdt,torch --replicas 8 --samples 5 \\
        [--device cuda|cpu] [--range-engine v4|v3] [--filter upstream] \\
        [--only ID] [--verify | --verify-only] [--save-baseline NAME] \\
        [--baseline NAME] [--profile DIR]

Groups and columns (``--backends``; the JAX runner's ``jax*`` columns are
``torch*`` here, the host columns keep their names):

- upstream (local-edit replay of each trace): ``torch`` (the range layout
  where coalescing halves the op stream, else the unit layout; its apply
  picked by ``--range-engine``), ``torch-unit``, and the host baselines
  ``cpp-rope``, ``cpp-rope-bytes``, ``cpp-crdt``, ``cpp-crdt-bytes``,
  ``cpp-cola``, ``python-oracle``, ``py-reconcile``;
- downstream (remote-update apply of each trace): ``torch`` (v5),
  ``torch-pos`` (v3), ``torch-range``, ``torch-runs``, ``torch-patch``,
  ``torch-unitwire``, and ``cpp-crdt``;
- merge (``--filter merge`` or ``--only merge/...``; concurrent agents'
  op logs, ``--merge-configs traces,synthetic,adversarial``): ``torch``
  (the packed unit merge), ``torch-range``, ``torch-flat``, and
  ``cpp-crdt`` (the native treap).

Each cell's median and spread go to standard error, the markdown table to
standard output, and the records to ``bench_results/torch_latest.json``
(``--save-baseline NAME``: also ``torch_NAME.json``; ``--baseline NAME``
compares with ``torch_NAME.json``).  ``--verify`` first checks every cell's
final document byte for byte against the pure-Python oracle (merges:
against the native treap's merge of the same delivered log) and exits 1
on a mismatch; ``--verify-only`` checks and times nothing.  A cell whose
backend is unavailable (no native library) or whose workload exceeds the
engine's bound is skipped, and the skip is printed.  Without CUDA this
exits with an error unless ``--device cpu`` is given.

``--family serve`` is the JAX runner's serve family (:func:`run_serve`):

    python -m crdt_benches_tpu_torch.bench.runner --family serve \\
        --serve-docs 4096 --serve-mix mixed --serve-mesh 8 --serve-macro 8

drains the document fleet once (``serve/bench.py``; the replicated family
with ``--serve-writers W``, the knee sweep with ``--serve-open-sweep``, the
soak with ``--serve-soak``), verifies a seeded per-class sample against the
oracle (``--serve-verify-sample``, drawn with ``--serve-sample-seed``,
default ``--serve-seed`` + 1), prints JAX's summary lines and writes JAX's
artifact through :func:`save_results` as ``torch_serve_<mix>_<docs>.json``
(``--serve-save-name NAME``: ``torch_NAME.json``).  ``--serve-mesh N``
shards every bucket's rows over N shards (``parallel/mesh.py fleet_mesh``:
on CUDA shard s on ``cuda:(s mod GPUs)``).  It exits 1 on a verification
miss, an unfired or unrecovered fault or an anomaly still active, and 2 on
a refused flag combination (JAX's refusals, word for word).
``--serve-profile N`` captures N steady rounds under ``torch.profiler``
(``obs/profiler.py``: the artifact's ``profile`` block), and
``--serve-sanitize LIST`` arms the runtime sanitizers (``lint/``); their
counters fill the artifact's ``boundary_syncs``, ``thread_crossings``,
``fs_ops``, ``lifecycle`` and ``ranges`` blocks, armed or not.
``--serve-edgecheck small|full`` runs the dtype-edge harness
(``serve/edgecheck.py``) in place of a drain, refusing every flag that
shapes one.
"""

from __future__ import annotations

import argparse
import functools
import sys

from ..backends import native
from ..backends.base import upstream_backends
from ..device import resolve_device
from ..traces.loader import TRACES, load_testing_data
from ..traces.patches import patch_arrays
from .harness import (
    BenchResult,
    compare_to_baseline,
    markdown_table,
    measure,
    save_results,
)
from .serve_flags import add_serve_flags, edgecheck_refusal, serve_refusal

UPSTREAM_TORCH = ("torch", "torch-unit")
DOWNSTREAM_TORCH = ("torch", "torch-pos", "torch-range", "torch-runs",
                    "torch-patch", "torch-unitwire")
#: merge column -> engine of ``bench/merge.py MergeCell``
MERGE_TORCH = {"torch": "unit", "torch-range": "range",
               "torch-flat": "flat"}
#: run downstream column -> granularity of ``TorchRunDownstreamBackend``
RUN_GRANULARITY = {"torch-runs": "coalesced", "torch-patch": "patch",
                   "torch-unitwire": "unit"}


def in_group(group: str, backend: str) -> bool:
    """Whether ``backend`` is a column of ``group``; every name that is not
    a downstream or merge column counts as upstream, so an unknown name
    fails there."""
    if group == "downstream":
        return backend == "cpp-crdt" or backend in DOWNSTREAM_TORCH
    if group == "merge":
        return backend == "cpp-crdt" or backend in MERGE_TORCH
    return backend in UPSTREAM_TORCH or not (
        backend in DOWNSTREAM_TORCH or backend in MERGE_TORCH)


def _native_upstreams() -> dict[str, type]:
    """Registered Upstream backends with a native whole-replay path."""
    return {name: cls for name, cls in upstream_backends().items()
            if hasattr(cls, "replay_patches")}


def _native_patches(trace, cls):
    """The trace's patch arrays in ``cls``'s offset units."""
    if getattr(cls, "EDITS_USE_BYTE_OFFSETS", False):
        return patch_arrays(trace.chars_to_bytes(), bytes_mode=True)
    return patch_arrays(trace)


def _replay_backend(backend, replicas, batch, device, range_engine):
    from ..backends.torch_backend import TorchReplayBackend

    return TorchReplayBackend(
        n_replicas=replicas, batch=batch,
        layout="unit" if backend == "torch-unit" else None,
        range_engine=range_engine, device=device,
    )


def _profile(fn, profile_dir: str) -> None:
    """One call of ``fn`` under ``torch.profiler``, its trace written to
    ``profile_dir`` (view in Perfetto or TensorBoard)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        fn()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run_upstream(trace_name: str, backend: str, samples: int, warmup: int,
                 replicas: int, batch: int, device="cuda",
                 range_engine: str = "v4",
                 profile_dir: str | None = None) -> BenchResult | None:
    """Time one upstream cell; None when it is skipped (a downstream or
    merge-only column, or no native library)."""
    trace = load_testing_data(trace_name)
    elements = len(trace)
    if backend.startswith("cpp-"):
        if not native.native_available():
            return None
        cls = _native_upstreams()[backend]
        pa = _native_patches(trace, cls)
        end_len = pa.end_len

        def iter_fn():
            n = cls.replay_patches(pa)
            if n != end_len:
                raise RuntimeError(f"{backend}: {n} != {end_len}")

        times = measure(iter_fn, warmup=warmup, samples=samples,
                        min_sample_time=0.05)
        return BenchResult("upstream", trace_name, backend, elements, times)
    if backend in ("python-oracle", "py-reconcile"):
        if backend == "python-oracle":
            from ..oracle import OracleDocument as Doc
            want = len(trace.end_content)
        else:
            from ..backends.reconcile import PyReconcile as Doc
            want = len(trace.end_content.encode())

        def iter_fn():
            doc = Doc.from_str(trace.start_content)
            for pos, d, ins in trace.iter_patches():
                doc.replace(pos, pos + d, ins)
            if len(doc) != want:
                raise RuntimeError(f"{backend}: {len(doc)} != {want}")

        times = measure(iter_fn, warmup=0, samples=max(2, samples // 2))
        return BenchResult("upstream", trace_name, backend, elements, times)
    if backend in UPSTREAM_TORCH:
        b = _replay_backend(backend, replicas, batch, device, range_engine)
        b.prepare(trace)
        times = measure(b.replay_once, warmup=warmup, samples=samples)
        if profile_dir:
            _profile(b.replay_once, profile_dir)
        return BenchResult("upstream", trace_name, b.NAME, elements, times,
                           replicas=replicas)
    if backend in DOWNSTREAM_TORCH or backend in MERGE_TORCH:
        return None  # downstream/merge-only columns
    raise ValueError(f"unknown backend {backend!r}")


def _downstream_backend(backend, replicas, batch, device):
    """The port's backend of a torch downstream column (None: the native
    library its generation anchors on is missing)."""
    from ..engine.downstream import TorchDownstreamBackend
    from ..engine.downstream_range import TorchRangeDownstreamBackend
    from ..engine.merge_range import TorchRunDownstreamBackend

    if backend == "torch-range":
        if not native.native_available():
            return None
        return TorchRangeDownstreamBackend(n_replicas=replicas, device=device)
    if backend in RUN_GRANULARITY:
        return TorchRunDownstreamBackend(
            n_replicas=replicas, granularity=RUN_GRANULARITY[backend],
            device=device)
    return TorchDownstreamBackend(
        n_replicas=replicas, batch=batch,
        engine="v3" if backend == "torch-pos" else "v5", device=device)


def run_downstream(trace_name: str, backend: str, samples: int,
                   warmup: int, replicas: int = 1, batch: int = 256,
                   device="cuda") -> BenchResult | None:
    """Time one downstream cell; None when it is skipped."""
    trace = load_testing_data(trace_name)
    elements = len(trace)
    if backend == "cpp-crdt":
        if not native.native_available():
            return None
        down, _ = native.CppCrdtDownstream.upstream_updates(trace)  # untimed
        end_len = len(trace.end_content)

        def iter_fn():
            n = down.apply_all_native()
            if n != end_len:
                raise RuntimeError(f"cpp-crdt: {n} != {end_len}")

        times = measure(iter_fn, warmup=warmup, samples=samples,
                        min_sample_time=0.05)
        return BenchResult("downstream", trace_name, backend, elements,
                           times)
    if backend in DOWNSTREAM_TORCH:
        b = _downstream_backend(backend, replicas, batch, device)
        if b is None:
            return None
        try:
            b.prepare(trace)
        except ValueError:
            return None  # capacity beyond this engine's bound
        times = measure(b.replay_once, warmup=warmup, samples=samples)
        return BenchResult("downstream", trace_name, b.NAME, elements,
                           times, replicas=replicas)
    return None


@functools.lru_cache(maxsize=4)
def _merge_sim(config: str, merge_ops: int, batch: int, device: str):
    """The merge cell's agents and op logs (untimed, shared by a cell's
    verify and its timed run)."""
    from .merge import merge_sim

    return merge_sim(config, merge_ops, batch, device=device)


def _merge_cell(config, engine, merge_ops, batch, replicas, epoch, device):
    """``bench/merge.py MergeCell`` of one merge column; None when the
    engine refuses the workload (duplicated delivery on the run merge,
    its precondition, or the packed fill range)."""
    from .merge import MergeCell

    sim = _merge_sim(config, merge_ops, batch, str(device))
    try:
        return MergeCell(sim, config, engine, n_replicas=replicas,
                         epoch=epoch, merge_ops=merge_ops)
    except ValueError:
        return None


def run_merge(config: str, backend: str, samples: int, warmup: int,
              replicas: int, batch: int, merge_ops: int, epoch: int = 32,
              device="cuda") -> BenchResult | None:
    """Concurrent-merge throughput: the timed region merges the delivered
    log into fresh replicas and confirms convergence (every replica's
    digest equal); an element is one delivered op.  None when skipped."""
    dev = resolve_device(device)
    if backend == "cpp-crdt":
        if not native.native_available():
            return None
        from ..engine.merge import to_native_ops
        from .merge import delivered_log

        sim = _merge_sim(config, merge_ops, batch, str(dev))
        delivered = delivered_log(sim, config, merge_ops)
        ops = to_native_ops(sim, delivered)  # untimed translation
        base = "".join(chr(int(c))
                       for c in sim.chars[: sim.n_base].tolist())
        nm0 = native.NativeMerge(base)
        expect_len = nm0.integrate(*ops)
        nm0.close()

        def iter_fn():
            nm = native.NativeMerge(base)
            try:
                if nm.integrate(*ops) != expect_len:
                    raise RuntimeError("cpp-crdt merge length changed")
            finally:
                nm.close()

        times = measure(iter_fn, warmup=warmup, samples=samples,
                        min_sample_time=0.05)
        return BenchResult("merge", config, backend, len(delivered), times)
    if backend not in MERGE_TORCH:
        return None
    cell = _merge_cell(config, MERGE_TORCH[backend], merge_ops, batch,
                       replicas, epoch, dev)
    if cell is None:
        return None
    times = measure(cell.run, warmup=warmup, samples=samples)
    tag = f"-r{replicas}" if replicas > 1 else ""
    suffix = {"unit": "", "range": "-range", "flat": "-flat"}[cell.engine]
    return BenchResult("merge", config, f"torch-{dev.type}{tag}{suffix}",
                       cell.elements, times, replicas=replicas)


@functools.lru_cache(maxsize=8)
def _oracle_content(trace_name: str) -> str:
    """The pure-Python oracle's replay, once per trace."""
    from ..oracle.text_oracle import replay_trace

    trace = load_testing_data(trace_name)
    want = replay_trace(trace)
    if want != trace.end_content:
        raise RuntimeError(f"{trace_name}: the oracle's replay differs from "
                           "the trace's end content")
    return want


def verify_upstream(trace_name: str, backend: str, replicas: int,
                    batch: int, device="cuda",
                    range_engine: str = "v4") -> bool | None:
    """Byte-identity of one upstream cell's final document with the
    oracle's (a lengths-only backend: its length, per op and through the
    one-call replay).  None when the cell is skipped."""
    trace = load_testing_data(trace_name)
    if backend.startswith("cpp-"):
        if not native.native_available():
            return None
        want = _oracle_content(trace_name)
        cls = _native_upstreams()[backend]
        pa = _native_patches(trace, cls)
        if hasattr(cls, "replay_patches_content"):
            return cls.replay_patches_content(pa) == want
        doc = cls.from_str(trace.start_content)
        t = (trace.chars_to_bytes()
             if getattr(cls, "EDITS_USE_BYTE_OFFSETS", False) else trace)
        for pos, d, ins in t.iter_patches():
            doc.replace(pos, pos + d, ins)
        got = doc.content()
        if got is None:  # lengths-only (cpp-cola): its one observable
            return (len(doc) == pa.end_len
                    and cls.replay_patches(pa) == pa.end_len)
        return got == want
    if backend == "python-oracle":
        return True  # the oracle is the reference point
    if backend == "py-reconcile":
        from ..backends.reconcile import PyReconcile

        doc = PyReconcile.from_str(trace.start_content)
        for pos, d, ins in trace.iter_patches():
            doc.replace(pos, pos + d, ins)
        return doc.content() == _oracle_content(trace_name)
    if backend in UPSTREAM_TORCH:
        b = _replay_backend(backend, replicas, batch, device, range_engine)
        b.prepare(trace)
        return b.final_content() == _oracle_content(trace_name)
    return None


def verify_downstream(trace_name: str, backend: str, replicas: int,
                      batch: int, device="cuda") -> bool | None:
    """Byte-identity of one downstream cell's final document with the
    oracle's; None when the cell is skipped."""
    trace = load_testing_data(trace_name)
    if backend == "cpp-crdt":
        if not native.native_available():
            return None
        down, _ = native.CppCrdtDownstream.upstream_updates(trace)
        down.apply_all_native()
        return down.content() == _oracle_content(trace_name)
    if backend in DOWNSTREAM_TORCH:
        b = _downstream_backend(backend, replicas, batch, device)
        if b is None:
            return None
        try:
            b.prepare(trace)
        except ValueError:
            return None
        return b.final_content() == _oracle_content(trace_name)
    return None


def verify_merge(config: str, backend: str, merge_ops: int, batch: int,
                 replicas: int, epoch: int = 32,
                 device="cuda") -> bool | None:
    """Byte-identity of one torch merge column: replica 0 of the merge,
    at the timed cell's schedule, against the independent native treap's
    merge of the same delivered log; the replicas must also converge.
    None when the cell is skipped (no native library, or the engine
    refuses the workload)."""
    if backend not in MERGE_TORCH or not native.native_available():
        return None
    cell = _merge_cell(config, MERGE_TORCH[backend], merge_ops, batch,
                       replicas, epoch, resolve_device(device))
    if cell is None:
        return None
    try:
        state = cell.run()
    except RuntimeError:  # the replicas diverged
        return False
    return cell.check(state)[0]


def _skipped(what: str) -> None:
    print(f"skip {what}: backend unavailable or workload refused",
          file=sys.stderr)


def _report(r: BenchResult) -> None:
    """One cell's median, min/max and outlier annotation."""
    o = r.outliers
    note = ""
    if o["mild"] or o["severe"]:
        note = f"  [outliers: {o['mild']} mild, {o['severe']} severe]"
    disc = getattr(r.samples, "discarded", [])
    if disc:
        note += (f"  [re-ran {len(disc)} severe: "
                 + ", ".join(f"{x:.3g}s" for x in disc) + "]")
    print(f"{r.bench_id}: median {r.median * 1e3:.2f}ms "
          f"(min {r.best * 1e3:.2f} / max {r.worst * 1e3:.2f}) -> "
          f"{r.elements_per_sec:,.0f} el/s{note}", file=sys.stderr)


def _verify(args, device) -> list[tuple[str, str, str]]:
    """Every selected cell's verify; returns the mismatches."""
    failures = []

    def note(group, name, backend, ok):
        if ok is None:
            _skipped(f"verify {group}/{name}/{backend}")
            return
        print(f"verify {group}/{name}/{backend}: "
              f"{'ok' if ok else 'MISMATCH'}", file=sys.stderr)
        if not ok:
            failures.append((group, name, backend))

    for trace in args.traces.split(","):
        for backend in args.backends.split(","):
            if (not args.filter or args.filter in "upstream") and in_group(
                    "upstream", backend):
                note("upstream", trace, backend, verify_upstream(
                    trace, backend, args.replicas, args.batch, device,
                    args.range_engine))
            if (not args.filter or args.filter in "downstream") and in_group(
                    "downstream", backend):
                note("downstream", trace, backend, verify_downstream(
                    trace, backend, args.replicas, args.batch, device))
    if not args.filter or args.filter in "merge":
        for config in args.merge_configs.split(","):
            for backend in args.backends.split(","):
                if backend in MERGE_TORCH:  # cpp-crdt is the reference
                    note("merge", config, backend, verify_merge(
                        config, backend, args.merge_ops, args.batch,
                        args.replicas, args.epoch, device))
    return failures


#: The artifact's blocks of the sanitizers' counters and the device
#: profile (``lint/``, ``obs/profiler.py``).
LINT_BLOCKS = ("boundary_syncs", "thread_crossings", "fs_ops", "lifecycle",
               "ranges", "profile")

#: Keys of a serve report the JAX artifact carries under the same name.
_SERVE_KEYS = (
    "fleet_docs", "batch", "batch_chars", "macro_k", "op_dtypes", "classes",
    "slots", "mesh_devices", "rounds", "device_rounds", "range_ops",
    "unit_ops", "coalesce_ratio", "pad_fraction", "patches_per_sec",
    "batch_latency", "compile_time", "compile_rounds", "barrier_time",
    "barrier_rounds", "steady_rounds", "occupancy_mean", "queue_depth_mean",
    "queue_depth_max", "evictions", "restores", "promotions", "admissions",
    "queue_cap", "overflow_policy", "shed_ops", "deferred_ops",
    "overflow_events", "backpressure_rounds", "dup_ops_dropped",
    "stall_rounds", "quarantines", "recoveries", "ops_replayed",
    "replay_dispatches", "mttr_rounds", "degraded_rounds", "lossy_docs",
    "journal", "longhaul", "construction", "recovery", "reshard", "ingest",
    "knee", "faults", "metrics", "doc_drain_latency", "timeseries",
    "anomalies", "reqtrace", "slo", "flight", "status_port", "trace",
    "docs_per_class", "verify_ok", *LINT_BLOCKS)
_REPL_KEYS = (
    "fleet_docs", "writers", "replica_rows", "batch", "batch_chars",
    "macro_k", "classes", "slots", "rounds", "range_ops", "unit_ops",
    "patches_per_sec", "merge_unit_ops_per_sec", "batch_latency",
    "compile_time", "compile_rounds", "steady_rounds", "occupancy_mean",
    "evictions", "restores", "promotions", "coalesce_ratio", "pad_fraction",
    "replication", "convergence", "faults", "journal", "metrics", "reqtrace",
    "slo", "verify_ok", "ra_ok")


def serve_artifact(rep: dict) -> tuple[BenchResult, str]:
    """JAX's artifact of one serve report (``serve/bench.py`` or the
    replicated family's) and its default name, JAX's: the same bench id and
    ``extra`` keys."""
    if rep.get("family") == "serve-repl":
        n, w = rep["fleet_docs"], rep["writers"]
        extra = {"family": "serve-repl",
                 **{k: rep[k] for k in _REPL_KEYS},
                 "kernel": rep["serve_kernel"],
                 "thread_crossings": rep["thread_crossings"]}
        return (BenchResult("serve/repl", rep["mix"], f"{n}x{w}",
                            rep["patches"], [rep["wall_time"]], replicas=w,
                            extra=extra),
                f"serve_repl_{rep['mix']}_{n}x{w}")
    label = rep["bench_id"].split("/", 1)[1].rsplit("/", 1)[0]
    extra = {"family": "serve", **{k: rep.get(k) for k in _SERVE_KEYS},
             "kernel": rep["serve_kernel"],
             "residency": rep.get("residency"),
             "verified_docs": rep["verified_ids"]}
    n = rep["fleet_docs"]
    return (BenchResult("serve", label, str(n), rep["patches"],
                        [rep["wall_time"]], replicas=1, extra=extra),
            f"serve_{label.replace('/', '_')}_{n}")


def _serve_summary(r: BenchResult, iterations: int) -> None:
    """JAX's summary lines of a serve run (standard output)."""
    x = r.extra
    print(f"{r.bench_id}: {r.elements_per_sec:,.0f} patches/s "
          f"(K={x['macro_k']}, kernel={x['kernel']}, steady batch latency "
          f"p50 {x['batch_latency']['p50'] * 1e3:.1f}ms "
          f"/ p99 {x['batch_latency']['p99'] * 1e3:.1f}ms, "
          f"compile {x['compile_time']:.2f}s, "
          f"coalesce x{x['coalesce_ratio']:.2f}, "
          f"pad {x['pad_fraction']:.3f})")
    if x.get("residency") is not None:
        res = x["residency"]
        hr = res.get("hit_rate")
        print(f"  residency: hot {res['hot_rows_budget']} rows / warm "
              f"{res['warm_budget']} docs / cold compressed; warm hits "
              f"{res['warm_hits']} (prefetched {res['prefetch_hits']}), "
              f"cold restores {res['cold_restores']}, hit rate "
              + (f"{hr:.3f}" if hr is not None else "n/a"))
    if x.get("ingest") is not None:
        ing = x["ingest"]
        fr, dl = ing["front"], ing["deadline"]
        hit = dl.get("hit_rate")
        print(f"  ingest: {fr['ops_delivered']} ops / {fr['ops_frames']} "
              f"frames over {fr['sessions_opened']} sessions "
              f"({fr['sessions_resumed']} resumed, {fr['churn_drops']} churn "
              "drops); "
              + "; ".join(f"{t}: admit {d['admitted_ops']} defer "
                          f"{d['deferred_ops']} shed {d['shed_ops']}"
                          for t, d in sorted(
                              ing["admission"]["tenants"].items()))
              + (f"; deadline hit rate {hit:.3f} "
                 f"({'EDF' if dl['edf'] else 'rr'})"
                 if hit is not None else ""))
    if x.get("knee") is not None:
        knee = x["knee"]
        print(f"  knee: capacity {knee['capacity_ops_per_round']:.1f} "
              f"ops/round over {len(knee['points'])} probes — "
              + ", ".join(f"u={p['utilization']:.2f}:p99 {p['p99_ms']:.1f}ms"
                          for p in knee["points"]))
    if x["faults"] is not None:
        f, mttr = x["faults"], x["mttr_rounds"]
        print(f"  chaos: {f['injected']} injected / {f['recovered']} "
              f"recovered ({f['not_fired']} not fired), "
              f"MTTR {mttr['mean']:.1f} rounds (max {mttr['max']}), "
              f"replayed {x['ops_replayed']} ops, shed {x['shed_ops']}, "
              f"quarantines {len(x['quarantines'])}, "
              f"degraded rounds {x['degraded_rounds']}")
    if x.get("recovery") is not None:
        rec = x["recovery"]
        print(f"  recovery: {rec['recover_ms']:.1f}ms restore "
              f"(snapshot round {rec['snapshot_round']}, chain depth "
              f"{rec['chain_depth']}, {rec['chain_fallbacks']} fallbacks)"
              f" + {rec['redo_ms']:.1f}ms redo of {rec['redo_ops']} ops, "
              f"WAL {rec['journal_disk_bytes']} B on disk, "
              f"verify {'ok' if rec['verify_ok'] else 'FAILED'}")
    if x.get("reshard") is not None:
        rs = x["reshard"]
        mid = rs["mid_latency"]
        print(f"  reshard: {rs['kind']} {rs['shards']} {rs['state']} "
              f"(rounds {rs['begin_round']}..{rs['commit_round']}); "
              f"{rs['migrated']} row moves + {rs['evicted']} demotions, "
              f"{rs['deferred_lanes']} lanes / {rs['deferred_ops']} ops "
              f"deferred, {rs['resumes']} crash resumes"
              + (f"; mid-reshard round p99 {mid['p99'] * 1e3:.1f}ms"
                 if mid else ""))
    if x.get("anomalies") is not None:
        a = x["anomalies"]
        print(f"  soak: {iterations} drain(s), "
              f"anomalies {a['fired']} fired / {a['uncleared']} uncleared"
              + (f" (active: {', '.join(a['active'])})" if a["active"]
                 else ""))


def run_serve(args) -> int:
    """The serve family (the JAX runner's ``run_serve``): the replicated
    family, the open-loop sweep, the soak or one drain, in JAX's order and
    behind JAX's refusals; the artifact saved through :func:`save_results`.
    Returns 0, 1 on a verification miss, an unfired or unrecovered fault,
    an anomaly still active or a missing CUDA device (as the classic
    family), 2 on a refused combination.  A drain's ValueError (its own
    refusals) exits 2; any other failure keeps its traceback."""
    log = lambda m: print(m, file=sys.stderr)
    if args.serve_edgecheck is not None:
        # the dtype-edge harness owns its fleets, both kernels and the
        # armed range sanitizer: a flag that shapes a drain is refused
        why = edgecheck_refusal(args)
        if why:
            log(why)
            return 2
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"runner: {e}", file=sys.stderr)
            return 1
        from ..serve.edgecheck import main as edge_main

        return edge_main((["--small"] if args.serve_edgecheck == "small"
                          else []) + ["--device", args.device])
    why = serve_refusal(args)
    if why:
        log(why)
        return 2
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"runner: {e}", file=sys.stderr)
        return 1
    from ..serve.bench import (
        run_serve_bench,
        run_serve_open_sweep,
        run_serve_soak,
    )
    from ..serve.replicate.bench import run_serve_repl_bench

    ints = lambda text: tuple(int(x) for x in text.split(",") if x.strip())
    try:
        if args.serve_writers > 1:
            rep = run_serve_repl_bench(
                mix=args.serve_mix, n_docs=args.serve_docs,
                writers=args.serve_writers, batch=args.serve_batch,
                classes=ints(args.serve_classes),
                slots=ints(args.serve_slots), seed=args.serve_seed,
                arrival_span=args.serve_arrival_span,
                macro_k=args.serve_macro, batch_chars=args.serve_batch_chars,
                serve_kernel=args.serve_kernel,
                turn_ops=args.serve_turn_ops,
                journal_dir=args.serve_journal,
                snapshot_every=args.serve_snapshot_every,
                faults=args.serve_faults,
                reqtrace_samples=args.serve_reqtrace,
                slo_spec=args.serve_slo, sanitize=args.serve_sanitize or (),
                device=args.device, log=log)
            r, name = serve_artifact(rep)
            log(f"serve/repl: wrote {save_results([r], args.serve_save_name or name)}")
            rb, conv = r.extra["replication"], r.extra["convergence"]
            print(f"{r.bench_id}: {r.extra['patches_per_sec']:,.0f} "
                  f"replica-patches/s, merge "
                  f"{r.extra['merge_unit_ops_per_sec']:,.0f} unit-ops/s, "
                  f"broadcast {rb['broadcast_bytes'] / 1024:.1f} KiB, "
                  f"divergence max {rb['divergence_depth_max']} blocks, "
                  f"converged {conv['replicas_checked']} replicas "
                  f"(RA axioms {'ok' if conv['ra_ok'] else 'VIOLATED'})")
            return 0 if (rep["verify_ok"] and rep["ra_ok"]
                         and rep["faults_ok"]) else 1
        common = dict(
            mix=args.serve_mix, n_docs=args.serve_docs,
            batch=args.serve_batch, classes=ints(args.serve_classes),
            slots=ints(args.serve_slots),
            arrival_span=args.serve_arrival_span,
            arrival_dist=args.serve_arrival_dist,
            mesh_devices=args.serve_mesh,
            verify_sample=args.serve_verify_sample,
            stream=args.serve_stream, sample_seed=args.serve_sample_seed,
            macro_k=args.serve_macro, batch_chars=args.serve_batch_chars,
            serve_kernel=args.serve_kernel, serve_tiers=args.serve_tiers,
            journal_dir=args.serve_journal,
            snapshot_every=args.serve_snapshot_every,
            snapshot_keep=args.serve_snapshot_keep,
            snapshot_full_every=args.serve_full_every,
            wal_segment_bytes=args.serve_wal_segment_bytes,
            longhaul=args.serve_longhaul,
            measure_recovery=args.serve_recover,
            crash_after=args.serve_crash_round,
            reshard_spec=args.serve_reshard,
            record_evict=args.serve_record_evict,
            faults=args.serve_faults, queue_cap=args.serve_queue_cap,
            overflow_policy=args.serve_overflow_policy,
            open_spec=args.serve_open, tenants_spec=args.serve_tenants,
            deadline=args.serve_deadline,
            deadline_budget=args.serve_deadline_budget,
            trace_path=args.serve_trace,
            reqtrace_samples=args.serve_reqtrace, slo_spec=args.serve_slo,
            flight_path=args.serve_flight,
            profile_rounds=args.serve_profile,
            sanitize=args.serve_sanitize or (), device=args.device, log=log)
        telemetry = dict(status_port=args.serve_status,
                         timeseries_path=args.serve_timeseries,
                         timeseries_window=args.serve_timeseries_window)
        if args.serve_soak is not None:
            # repeated drains under one telemetry bundle, the anomaly
            # detectors armed: an anomaly still active fails the run
            rep = run_serve_soak(soak_seconds=args.serve_soak,
                                 seed=args.serve_seed,
                                 watchdog_s=args.serve_watchdog,
                                 **telemetry, **common)
        elif args.serve_open_sweep is not None:
            # each offered rate probed, then the configured rate drained
            # with the knee attached
            try:
                rates = [float(x) for x in args.serve_open_sweep.split(",")
                         if x.strip()]
            except ValueError:
                log(f"--serve-open-sweep: bad rate list "
                    f"{args.serve_open_sweep!r}")
                return 2
            sweep_kw = dict(common)
            open_spec = sweep_kw.pop("open_spec")
            rep = run_serve_open_sweep(rates, open_spec=open_spec,
                                       seed=args.serve_seed, **telemetry,
                                       **sweep_kw)
        else:
            scaling = None
            if args.serve_stream_scaling:
                # one fresh process a (size, mode) cell: ru_maxrss only
                # grows in a process
                from ..serve.construction import scaling_table

                try:
                    sizes = ints(args.serve_stream_scaling)
                except ValueError:
                    log(f"--serve-stream-scaling: bad size list "
                        f"{args.serve_stream_scaling!r}")
                    return 2
                scaling = scaling_table(
                    sizes, mix=args.serve_mix, seed=args.serve_seed,
                    arrival_span=args.serve_arrival_span,
                    arrival_dist=args.serve_arrival_dist,
                    serve_tiers=args.serve_tiers, device=args.device,
                    log=log)
            rep = run_serve_bench(seed=args.serve_seed,
                                  construction_scaling=scaling,
                                  **telemetry, **common)
    except ValueError as e:
        log(f"error: {e}")
        return 2
    r, name = serve_artifact(rep)
    log(f"serve: wrote {save_results([r], args.serve_save_name or name)}")
    _serve_summary(r, rep.get("iterations", 1))
    ok = rep["verify_ok"] and rep["faults_ok"] and rep["anomalies_ok"]
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--family", default="classic",
                    choices=("classic", "serve"),
                    help="'classic' = the per-trace matrix; 'serve' = the "
                         "document-fleet engine (serve/)")
    add_serve_flags(ap)
    # the serve family's flags of this entry alone
    ap.add_argument("--serve-mesh", type=int, default=0, metavar="N",
                    help="shard every bucket's rows over N shards "
                         "(parallel/mesh.py fleet_mesh; on CUDA shard s on "
                         "cuda:(s mod GPUs)); 0 or 1 = no mesh")
    ap.add_argument("--serve-seed", type=int, default=0,
                    help="the fleet's seed (a soak re-seeds each drain)")
    ap.add_argument("--serve-sample-seed", type=int, default=None,
                    metavar="SEED",
                    help="seed of the sampled oracle verify (default: "
                         "--serve-seed + 1); recorded in the artifact "
                         "(construction.verify_sample_seed) next to the "
                         "picked doc ids")
    ap.add_argument("--serve-save-name", default=None,
                    help="artifact basename (default serve_<mix>_<docs>; "
                         "written as torch_<name>.json)")
    ap.add_argument("--serve-edgecheck", default=None,
                    choices=("small", "full"), metavar="MODE",
                    help="run the dtype-edge harness (serve/edgecheck.py) "
                         "instead of a bench drain: adversarial fleets "
                         "through both serve kernels with the range "
                         "sanitizer armed, then the boundary-contract fuzz "
                         "('full' adds the 65,408- and 65,664-column "
                         "ladders that bracket the uint16 ids)")
    ap.add_argument("--traces", default=",".join(TRACES))
    ap.add_argument("--backends", default="cpp-rope,cpp-crdt,cpp-cola,torch")
    ap.add_argument("--filter", default="", help="substring filter on group")
    ap.add_argument("--only", default="",
                    help="substring filter on the full bench id "
                         "'group/trace/backend'")
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--merge-configs", default="traces,synthetic",
                    help="merge workloads (with --filter merge): traces, "
                         "synthetic, adversarial")
    ap.add_argument("--merge-ops", type=int, default=1_000_000)
    ap.add_argument("--epoch", type=int, default=32,
                    help="id->position snapshot rebuild period (batches)")
    ap.add_argument("--save-baseline", default=None)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one iteration of "
                         "each upstream torch cell into DIR")
    ap.add_argument("--verify", action="store_true",
                    help="byte-compare every cell's final document with "
                         "the oracle first; exit 1 on a mismatch")
    ap.add_argument("--verify-only", action="store_true",
                    help="run the --verify checks and time nothing")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the torch columns run (default cuda; no "
                         "fallback to the CPU)")
    ap.add_argument("--range-engine", default="v4", choices=("v4", "v3"),
                    help="the range apply of the upstream torch column")
    args = ap.parse_args(argv)

    if args.family == "serve":
        return run_serve(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"runner: {e}", file=sys.stderr)
        return 1

    if args.verify or args.verify_only:
        failures = _verify(args, device)
        if failures:
            print(f"verify FAILED: {failures}", file=sys.stderr)
            return 1
        if args.verify_only:
            print("verify: all cells byte-identical", file=sys.stderr)
            return 0

    def want(group: str, name: str, backend: str) -> bool:
        return not args.only or args.only in f"{group}/{name}/{backend}"

    def keep(r, what):
        if r is None:
            _skipped(what)
            return
        results.append(r)
        _report(r)

    results: list[BenchResult] = []
    for trace in args.traces.split(","):
        for backend in args.backends.split(","):
            if (not args.filter or args.filter in "upstream") and want(
                    "upstream", trace, backend) and in_group("upstream",
                                                             backend):
                keep(run_upstream(trace, backend, args.samples, args.warmup,
                                  args.replicas, args.batch, device,
                                  args.range_engine, args.profile),
                     f"upstream/{trace}/{backend}")
            if (not args.filter or args.filter in "downstream") and want(
                    "downstream", trace, backend) and in_group("downstream",
                                                               backend):
                keep(run_downstream(trace, backend, args.samples,
                                    args.warmup, args.replicas, args.batch,
                                    device),
                     f"downstream/{trace}/{backend}")
    if (args.filter and args.filter in "merge") or (
            args.only and args.only.startswith("merge")):
        for config in args.merge_configs.split(","):
            for backend in args.backends.split(","):
                if want("merge", config, backend) and in_group("merge",
                                                               backend):
                    keep(run_merge(config, backend, args.samples,
                                   args.warmup, args.replicas, args.batch,
                                   args.merge_ops, args.epoch, device),
                         f"merge/{config}/{backend}")

    print(markdown_table(results))
    save_results(results, "latest")
    if args.save_baseline:
        save_results(results, args.save_baseline)
    if args.baseline:
        print("\n".join(compare_to_baseline(results, args.baseline)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
