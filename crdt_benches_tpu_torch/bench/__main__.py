"""Headline benchmark of the port — prints ONE JSON line.

    python -m crdt_benches_tpu_torch.bench [--trace automerge-paper]
        [--replicas 1024] [--batch 1536] [--samples 5] [--device cuda]
        [--layout auto|range|unit] [--unit-engine v4|v3|v2]

The default is the headline range replay; ``--layout unit --batch 256``
is the unit-op engine (the JAX package's ``jax-unit`` bench column).

Metric: aggregate replay throughput of the trace across many replicas on
one GPU, in elements/sec (element = one trace patch, times replicas).
``vs_baseline`` divides it by the single-core native C++ CRDT replaying
the same coalesced stream; the baseline is advisory and the metric prints
without it.  Without CUDA this exits with an error unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from statistics import median

import torch


def _native_baseline(trace, samples: int):
    """(per-patch, coalesced-stream) cpp-crdt elements/sec, or None each
    when the native library is unavailable."""
    from ..backends.native import CppCrdt
    from ..traces.patches import patch_arrays
    from ..traces.tensorize import coalesce_patches
    from .harness import measure

    end_len = len(trace.end_content)
    out = []
    for pa in (patch_arrays(trace),
               patch_arrays(trace, patches=list(coalesce_patches(trace)))):
        def run(pa=pa):
            n = CppCrdt.replay_patches(pa)
            if n != end_len:
                raise RuntimeError(f"cpp-crdt length {n} != {end_len}")

        out.append(len(trace) / median(measure(run, warmup=1, samples=samples)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="automerge-paper")
    ap.add_argument("--replicas", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1536)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layout", choices=("auto", "range", "unit"),
                    default="auto")
    ap.add_argument("--unit-engine", choices=("v4", "v3", "v2"),
                    default="v4")
    args = ap.parse_args(argv)

    from ..backends.torch_backend import TorchReplayBackend
    from ..engine.replay import ReplayEngine
    from ..traces.loader import load_testing_data
    from .harness import measure

    try:
        backend = TorchReplayBackend(
            n_replicas=args.replicas, batch=args.batch, layout=args.layout,
            unit_engine=args.unit_engine, device=args.device,
        )
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    trace = load_testing_data(args.trace)
    elements = len(trace)

    base_pp = base_rle = None
    try:
        base_pp, base_rle = _native_baseline(trace, args.samples)
    except (OSError, RuntimeError) as e:  # advisory: the metric still prints
        print(f"native baseline failed: {e}", file=sys.stderr)

    backend.prepare(trace)
    times = measure(backend.replay_once, warmup=1, samples=args.samples)
    agg = elements * args.replicas / median(times)
    kind = (
        torch.cuda.get_device_name(backend.device)
        if backend.device.type == "cuda" else "cpu"
    )
    # the unit engine replays the per-patch stream exploded to chars, so
    # its baseline is the per-patch C++ replay
    unit = isinstance(backend.engine, ReplayEngine)
    base = base_pp if unit else (base_rle or base_pp)
    label = ("cpp-crdt 1 core, per patch" if unit
             else "cpp-crdt 1 core, same coalesced stream")
    out = {
        "metric": (
            f"{args.trace} aggregate replay throughput, {args.replicas} "
            f"replicas, "
            + (f"unit layout {args.unit_engine}, " if unit else "")
            + f"torch-{backend.device.type} ({kind}) (baseline: "
            + (label if base else "cpp-crdt unavailable")
            + ")"
        ),
        "value": round(agg, 1),
        "unit": "elements/sec",
        "vs_baseline": round(agg / base, 3) if base else 0.0,
    }
    if base_pp:
        out["vs_cpp_perpatch"] = round(agg / base_pp, 3)
        out["cpp_perpatch_els_per_sec"] = round(base_pp, 1)
    if base_rle:
        out["cpp_rle_els_per_sec"] = round(base_rle, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
