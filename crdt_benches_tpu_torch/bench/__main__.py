"""Headline benchmark of the port — prints ONE JSON line.

    python -m crdt_benches_tpu_torch.bench [--trace automerge-paper]
        [--group replay|downstream] [--replicas N] [--batch B]
        [--samples 5] [--device cuda]
        [--layout auto|range|unit] [--unit-engine v4|v3|v2]   (replay)
        [--engine v5|v3|v1]                                  (downstream)

The default is the headline range replay (1024 replicas, batch 1536);
``--layout unit --batch 256`` is the unit-op engine (the JAX package's
``jax-unit`` bench column).  ``--group downstream`` is the remote-update
apply (64 replicas, batch 256 unless given; ``--engine`` picks v5, v3 or
v1): its timed region is fresh replicas, the full apply and the length
fetch, with the updates generated untimed.  A flag of the other group is
an error.

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
        f"{backend.NAME} ({kind}) (baseline: "
        + ("cpp-crdt downstream 1 core" if base else "cpp-crdt unavailable")
        + ")"
    )
    return text, base, {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="automerge-paper")
    ap.add_argument("--group", choices=("replay", "downstream"),
                    default="replay")
    ap.add_argument("--replicas", type=int, default=None,
                    help="default 1024 (replay), 64 (downstream)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 1536 (replay), 256 (downstream)")
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layout", choices=("auto", "range", "unit"),
                    help="replay layout (default auto)")
    ap.add_argument("--unit-engine", choices=("v4", "v3", "v2"),
                    help="replay unit engine (default v4)")
    ap.add_argument("--engine", choices=("v5", "v3", "v1"),
                    help="downstream apply engine (default v5)")
    args = ap.parse_args(argv)
    down = args.group == "downstream"
    if down and (args.layout or args.unit_engine):
        ap.error("--layout and --unit-engine belong to --group replay")
    if not down and args.engine:
        ap.error("--engine belongs to --group downstream")
    args.layout = args.layout or "auto"
    args.unit_engine = args.unit_engine or "v4"
    args.engine = args.engine or "v5"
    if args.replicas is None:
        args.replicas = 64 if down else 1024
    if args.batch is None:
        args.batch = 256 if down else 1536

    from ..traces.loader import load_testing_data
    from .harness import measure

    try:
        if down:
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
