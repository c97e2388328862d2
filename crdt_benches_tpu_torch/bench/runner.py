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
exits with an error unless ``--device cpu`` is given.  ``--family serve``
is not ported here: the serve drain is ``python -m
crdt_benches_tpu_torch.bench --group serve``.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--family", default="classic",
                    choices=("classic", "serve"),
                    help="'classic' = the per-trace matrix; 'serve' is not "
                         "ported to this runner")
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
        print("runner: the serve family is not ported to this runner; run "
              "the serve drain with `python -m crdt_benches_tpu_torch.bench "
              "--group serve` (the rest of the serve family is ROADMAP "
              "Queue 1 item 6)", file=sys.stderr)
        return 2
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
