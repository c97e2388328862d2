"""Headline benchmark of the port — prints ONE JSON line.

    python -m crdt_benches_tpu_torch.bench [--trace automerge-paper]
        [--group replay|downstream|merge|serve] [--replicas N] [--batch B]
        [--samples 5] [--device cuda]
        [--layout auto|range|unit] [--unit-engine v4|v3|v2]   (replay)
        [--engine v5|v3|v1|range|runs|patch|unitwire]
        [--schedule flat|batched]                            (downstream)
        [--merge-config traces|synthetic|adversarial]
        [--merge-engine unit|range|flat] [--merge-ops 1000000]
        [--epoch 32]                                         (merge)
        [--serve-docs 4096] [--serve-mix mixed] [--serve-batch 64]
        [--serve-macro 8] [--serve-batch-chars 256]
        [--serve-classes 256,...] [--serve-slots 2048,...]
        [--serve-arrival-span 8] [--serve-verify-sample 0] [--seed 0]
                                                             (serve)

The default is the headline range replay (1024 replicas, batch 1536);
``--layout unit --batch 256`` is the unit-op engine (the JAX package's
``jax-unit`` bench column).  ``--group downstream`` is the remote-update
apply (64 replicas, batch 256 unless given; ``--engine`` picks v5, v3 or
v1 on unit updates, ``range`` on run updates, or the run merge of one
writer's log at ``runs``, ``patch`` or ``unitwire`` granularity, with
``--schedule flat`` (default) or ``batched``): its timed region is fresh
replicas, the full apply and the length fetch, with the updates generated
untimed.  ``--group merge`` is the concurrent merge of divergent agents'
op logs (``traces``: rustcode and seph-blog1 from an empty base, 64
replicas, batch 256, epoch 32; ``--merge-engine`` picks the packed unit-op
merge, the run merge or the one-shot flat merge): its timed region is
the merge into fresh replicas and every replica's digest with the
convergence check, an element is one delivered op, and it exits non-zero
when replica 0 differs from the native treap's merge.  ``--group serve``
drains the document fleet once (``serve/mixed/4096`` by default: 4096
documents of the ``mixed`` band table, macro depth 8) and verifies every
document against the oracle (``--serve-verify-sample N``: a seeded sample of about
N spread over the classes); its metric is fleet patches/sec over the
drain's wall time, and it exits non-zero when verification fails.  A flag
of another group is an error.

Metric: aggregate throughput of the trace across many replicas on one GPU,
in elements/sec (element = one trace patch, times replicas).
``vs_baseline`` divides it by the single-core native C++ CRDT doing the
same (replaying the same coalesced stream, or applying its own encoded
updates); the baseline is advisory: without the native library it is 0.0
and the metric prints all the same.  Without CUDA this exits with an error
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from statistics import median

import torch

from .merge import CONFIGS as MERGE_CONFIGS
from .merge import ENGINES as MERGE_ENGINES

DOWN_ENGINES = ("v5", "v3", "v1", "range", "runs", "patch", "unitwire")
#: downstream engine -> granularity of the run merge that carries it
RUN_GRANULARITY = {"runs": "coalesced", "patch": "patch", "unitwire": "unit"}


def _native_rate(trace, run, samples: int) -> float:
    """cpp-crdt elements/sec of ``run()``, which returns the final length."""
    from .harness import measure

    end_len = len(trace.end_content)

    def once():
        n = run()
        if n != end_len:
            raise RuntimeError(f"cpp-crdt length {n} != {end_len}")

    return len(trace) / median(measure(once, warmup=1, samples=samples))


def _replay_baselines(trace, samples: int) -> dict:
    """cpp-crdt replay rates: per patch, and over the coalesced stream."""
    from ..backends.native import CppCrdt
    from ..traces.patches import patch_arrays
    from ..traces.tensorize import coalesce_patches

    rle = patch_arrays(trace, patches=list(coalesce_patches(trace)))
    pp = patch_arrays(trace)
    return {
        "cpp_perpatch_els_per_sec": _native_rate(
            trace, lambda: CppCrdt.replay_patches(pp), samples),
        "cpp_rle_els_per_sec": _native_rate(
            trace, lambda: CppCrdt.replay_patches(rle), samples),
    }


def _downstream_baselines(trace, samples: int) -> dict:
    """cpp-crdt downstream rate: applying its own encoded updates."""
    from ..backends.native import CppCrdtDownstream

    native = CppCrdtDownstream(trace)  # untimed generation
    return {"cpp_downstream_els_per_sec":
            _native_rate(trace, native.apply_all, samples)}


def _replay_metric(args, backend, kind, rates):
    """(metric text, baseline rate or None, extra keys) of the replay."""
    from ..engine.replay import ReplayEngine

    base_pp = rates.get("cpp_perpatch_els_per_sec")
    # the unit engine replays the per-patch stream exploded to chars, so
    # its baseline is the per-patch C++ replay
    unit = isinstance(backend.engine, ReplayEngine)
    base = base_pp if unit else (rates.get("cpp_rle_els_per_sec") or base_pp)
    label = ("cpp-crdt 1 core, per patch" if unit
             else "cpp-crdt 1 core, same coalesced stream")
    text = (
        f"{args.trace} aggregate replay throughput, {args.replicas} "
        "replicas, " + (f"unit layout {args.unit_engine}, " if unit else "")
        + f"torch-{backend.device.type} ({kind}) (baseline: "
        + (label if base else "cpp-crdt unavailable") + ")"
    )
    return text, base, ({"vs_cpp_perpatch": base_pp} if base_pp else {})


def _downstream_metric(args, backend, kind, rates):
    """(metric text, baseline rate or None, extra keys) of the downstream."""
    base = rates.get("cpp_downstream_els_per_sec")
    text = (
        f"{args.trace} downstream apply throughput, {args.replicas} "
        f"replicas, engine {args.engine}, batch {args.batch}, "
        + (f"schedule {args.schedule}, " if args.engine in RUN_GRANULARITY
           else "")
        + 
        f"{backend.NAME} ({kind}) (baseline: "
        + ("cpp-crdt downstream 1 core" if base else "cpp-crdt unavailable")
        + ")"
    )
    return text, base, {}


def _merge(args) -> int:
    """One merge cell; one JSON line; 1 if replica 0 differs from the
    native treap's merge."""
    from .harness import measure
    from .merge import MergeCell, merge_sim

    try:
        sim = merge_sim(args.merge_config, args.merge_ops, args.batch,
                        device=args.device)
        cell = MergeCell(sim, args.merge_config, args.merge_engine,
                         n_replicas=args.replicas, epoch=args.epoch,
                         merge_ops=args.merge_ops)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    times = measure(cell.run, warmup=1, samples=args.samples)
    agg = cell.elements * args.replicas / median(times)
    ok, want = cell.check(cell.run())
    base = None
    try:  # advisory: the native treap merging the same delivered log
        from ..backends.native import NativeMerge
        from ..engine.merge import to_native_ops

        ops = to_native_ops(sim, cell.delivered)
        start = "".join(map(chr, sim.chars[: sim.n_base].tolist()))

        def native_once():
            nm = NativeMerge(start)
            try:
                if nm.integrate(*ops) != len(want):
                    raise RuntimeError("native merge length differs")
            finally:
                nm.close()

        base = cell.elements / median(measure(native_once, warmup=1,
                                              samples=args.samples))
    except (OSError, RuntimeError) as e:
        print(f"native baseline failed: {e}", file=sys.stderr)
    dev = sim.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tag = f"-r{args.replicas}" if args.replicas > 1 else ""
    name = f"torch-{dev.type}{tag}" + (
        "" if args.merge_engine == "unit" else f"-{args.merge_engine}")
    out = {
        "metric": (f"merge/{args.merge_config} aggregate merge throughput, "
                   f"{cell.elements} delivered ops, {args.replicas} "
                   f"replicas, engine {args.merge_engine}, {name} ({kind}) "
                   "(baseline: " + ("cpp-crdt merge 1 core" if base
                                    else "cpp-crdt unavailable") + ")"),
        "value": round(agg, 1),
        "unit": "elements/sec",
        "vs_baseline": round(agg / base, 3) if base else 0.0,
        "verify_ok": ok,
    }
    print(json.dumps(out))
    if not ok:
        print("error: replica 0 differs from the native treap's merge",
              file=sys.stderr)
    return 0 if ok else 1


def _ints(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.split(",") if x.strip())


def _serve(args) -> int:
    """Drain the serving fleet once; one JSON line; 1 if verify fails."""
    from ..serve.bench import run_serve_bench

    try:
        rep = run_serve_bench(
            mix=args.serve_mix, n_docs=args.serve_docs,
            batch=args.serve_batch, classes=_ints(args.serve_classes),
            slots=_ints(args.serve_slots), seed=args.seed,
            arrival_span=args.serve_arrival_span, macro_k=args.serve_macro,
            batch_chars=args.serve_batch_chars,
            verify_sample=args.serve_verify_sample, device=args.device,
            log=lambda m: print(m, file=sys.stderr),
        )
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out = {
        "metric": (f"serve/{args.serve_mix}/{args.serve_docs} fleet "
                   f"patches/sec, K={args.serve_macro}, torch-"
                   f"{torch.device(args.device).type} ({rep['device']})"),
        "value": round(rep["patches_per_sec"], 1),
        "unit": "elements/sec",
    }
    out.update(rep)
    print(json.dumps(out))
    return 0 if rep["verify_ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="automerge-paper")
    ap.add_argument("--group",
                    choices=("replay", "downstream", "merge", "serve"),
                    default="replay")
    ap.add_argument("--replicas", type=int, default=None,
                    help="default 1024 (replay), 64 (downstream, merge)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 1536 (replay), 256 (downstream v5/v3/v1, "
                    "merge), 2048 (downstream range), 512 (downstream "
                    "runs/patch/unitwire)")
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layout", choices=("auto", "range", "unit"),
                    help="replay layout (default auto)")
    ap.add_argument("--unit-engine", choices=("v4", "v3", "v2"),
                    help="replay unit engine (default v4)")
    ap.add_argument("--engine", choices=DOWN_ENGINES,
                    help="downstream apply engine (default v5)")
    ap.add_argument("--schedule", choices=("flat", "batched"),
                    help="downstream runs/patch/unitwire schedule "
                    "(default flat)")
    merge_flags = (
        ("--merge-config", str, "traces", MERGE_CONFIGS),
        ("--merge-engine", str, "unit", MERGE_ENGINES),
        ("--merge-ops", int, 1_000_000, None), ("--epoch", int, 32, None),
    )
    for flag, typ, default, choices in merge_flags:
        ap.add_argument(flag, type=typ, choices=choices,
                        help=f"merge (default {default})")
    serve_flags = (
        ("--serve-docs", int, 4096), ("--serve-mix", str, "mixed"),
        ("--serve-batch", int, 64), ("--serve-macro", int, 8),
        ("--serve-batch-chars", int, 256),
        ("--serve-classes", str, "256,1024,4096,8192,49152"),
        ("--serve-slots", str, "2048,512,128,32,16"),
        ("--serve-arrival-span", int, 8),
        ("--serve-verify-sample", int, 0), ("--seed", int, 0),
    )
    for flag, typ, default in serve_flags:
        ap.add_argument(flag, type=typ, help=f"serve (default {default})")
    args = ap.parse_args(argv)
    flag_set = lambda flags: [f for f, *_ in flags
                              if getattr(args, f[2:].replace("-", "_"))
                              is not None]
    given = flag_set(serve_flags)
    merge_given = flag_set(merge_flags)
    if args.group != "merge" and merge_given:
        ap.error(f"{', '.join(merge_given)} belong to --group merge")
    if args.group == "merge":
        if given or (args.layout, args.unit_engine, args.engine,
                     args.schedule) != (None,) * 4:
            ap.error("only --replicas, --batch, --samples, --device and the "
                     "--merge-* and --epoch flags belong to --group merge")
        for flag, _, default, _ in merge_flags:
            key = flag[2:].replace("-", "_")
            if getattr(args, key) is None:
                setattr(args, key, default)
        args.replicas = args.replicas or 64
        args.batch = args.batch or 256
        return _merge(args)
    if args.group == "serve":
        if (args.replicas, args.batch, args.layout, args.unit_engine,
                args.engine, args.schedule) != (None,) * 6:
            ap.error("--replicas, --batch, --layout, --unit-engine, "
                     "--engine and --schedule do not belong to --group "
                     "serve")
        for flag, _, default in serve_flags:
            key = flag[2:].replace("-", "_")
            if getattr(args, key) is None:
                setattr(args, key, default)
        return _serve(args)
    if given:
        ap.error(f"{', '.join(given)} belong to --group serve")
    down = args.group == "downstream"
    if down and (args.layout or args.unit_engine):
        ap.error("--layout and --unit-engine belong to --group replay")
    if not down and (args.engine or args.schedule):
        ap.error("--engine and --schedule belong to --group downstream")
    args.layout = args.layout or "auto"
    args.unit_engine = args.unit_engine or "v4"
    args.engine = args.engine or "v5"
    runs = args.engine in RUN_GRANULARITY
    if args.schedule and not runs:
        ap.error("--schedule belongs to the downstream engines runs, patch "
                 "and unitwire")
    args.schedule = args.schedule or "flat"
    if args.replicas is None:
        args.replicas = 64 if down else 1024
    if args.batch is None:
        args.batch = (1536 if not down else 2048 if args.engine == "range"
                      else 512 if runs else 256)

    from ..traces.loader import load_testing_data
    from .harness import measure

    try:
        if down and args.engine == "range":
            from ..engine.downstream_range import TorchRangeDownstreamBackend

            backend = TorchRangeDownstreamBackend(
                n_replicas=args.replicas, batch_ops=args.batch,
                device=args.device,
            )
        elif runs:
            from ..engine.merge_range import TorchRunDownstreamBackend

            backend = TorchRunDownstreamBackend(
                n_replicas=args.replicas, batch=args.batch,
                granularity=RUN_GRANULARITY[args.engine],
                schedule=args.schedule, device=args.device,
            )
        elif down:
            from ..engine.downstream import TorchDownstreamBackend

            backend = TorchDownstreamBackend(
                n_replicas=args.replicas, batch=args.batch,
                engine=args.engine, device=args.device,
            )
        else:
            from ..backends.torch_backend import TorchReplayBackend

            backend = TorchReplayBackend(
                n_replicas=args.replicas, batch=args.batch,
                layout=args.layout, unit_engine=args.unit_engine,
                device=args.device,
            )
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    trace = load_testing_data(args.trace)

    rates = {}
    try:  # advisory: the metric prints without it
        rates = (_downstream_baselines if down else _replay_baselines)(
            trace, args.samples)
    except (OSError, RuntimeError) as e:
        print(f"native baseline failed: {e}", file=sys.stderr)

    backend.prepare(trace)
    times = measure(backend.replay_once, warmup=1, samples=args.samples)
    agg = len(trace) * args.replicas / median(times)
    dev = backend.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    text, base, vs = (_downstream_metric if down else _replay_metric)(
        args, backend, kind, rates)
    out = {
        "metric": text,
        "value": round(agg, 1),
        "unit": "elements/sec",
        "vs_baseline": round(agg / base, 3) if base else 0.0,
    }
    out.update({k: round(agg / v, 3) for k, v in vs.items()})
    out.update({k: round(v, 1) for k, v in rates.items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
