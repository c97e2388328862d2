"""K7 against K6 as the no-cv fused apply, end to end, on one GPU.

    python -m crdt_benches_tpu_torch.bench.nocv_versus [--out FILE]

The id-resolved v5 apply (``engine/downstream.py _apply_update_batch5``),
which the v5 downstream and the packed unit merge run every batch, calls
K7 (``ops/expand.py apply_fused_blocked``).  K6 with ``emit_cv=False``
(``ops/apply_range_fused.py apply_fused2``) computes the same function from
the same operands, one block per replica row.  This script swaps K6 in for
the comparison and times whole runs on the host clock, each ending in a
device synchronize, in turns K6, K7, K7, K6:

- ``flagship.downstream()`` at its defaults (automerge-paper, 1024
  replicas, batch 1536);
- the v5 downstream cell (automerge-paper, 64 replicas, batch 256);
- the packed unit merge of merge/traces (rustcode and seph-blog1, 1024
  replicas, batch 256, epoch 32), one run each way (K6, then K7).

Every run's lengths are checked, and replica 0 is decoded against the end
content (the merge: against the native treap) after each kernel's first
run.  Prints one JSON line (and writes it to ``--out``) with the seconds
of every run and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch

from ..engine import downstream as dsm
from ..ops.apply_range_fused import apply_fused2


def _k6_nocv(doc_predel, combo, cnt_base, new_len):
    return apply_fused2(doc_predel, combo, new_len, emit_cv=False)


@contextlib.contextmanager
def _apply(kernel: str):
    """Run the v5 apply through ``kernel`` ("k6" or "k7") inside."""
    k7 = dsm.apply_fused_blocked
    if kernel == "k6":
        dsm.apply_fused_blocked = _k6_nocv
    try:
        yield
    finally:
        dsm.apply_fused_blocked = k7


def _timed(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nocv_versus: CUDA is not available", file=sys.stderr)
        return 1
    from ..bench.merge import MergeCell, merge_sim
    from ..models import flagship
    from ..traces import load_testing_data

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    trace = load_testing_data("automerge-paper")
    end = trace.end_content
    out: dict = {"card": smi}

    def versus(tag, run, lengths, decode):
        secs: dict[str, list[float]] = {"k6": [], "k7": []}
        for kernel in ("k6", "k7", "k7", "k6"):
            with _apply(kernel):
                s, st = _timed(run)
            if not lengths(st):
                raise RuntimeError(f"{tag} through {kernel}: lengths differ")
            if not secs[kernel] and not decode(st):
                raise RuntimeError(f"{tag} through {kernel}: replica 0 "
                                   "differs")
            secs[kernel].append(s)
            del st
        out[tag] = secs
        print(f"[{tag}] " + "; ".join(
            f"{k} {', '.join(f'{x:.4f}' for x in v)} s"
            for k, v in secs.items()), file=sys.stderr, flush=True)

    feng = flagship.downstream(trace)
    feng.run()  # warm-up
    versus("flagship R=1024 B=1536", feng.run,
           lambda st: bool((st.nvis == len(end)).all()),
           lambda st: feng.decode(st, 0) == end)
    del feng
    deng = dsm.DownstreamEngine(dsm.tensorize(trace, batch=256),
                                n_replicas=64)
    versus("downstream R=64 B=256", deng.run,
           lambda st: bool((st.nvis == len(end)).all()),
           lambda st: deng.decode(st, 0) == end)
    del deng

    sim = merge_sim("traces", batch=256)
    cell = MergeCell(sim, "traces", "unit", n_replicas=1024)
    want = None
    secs = {}
    for kernel in ("k6", "k7"):
        with _apply(kernel):
            s, st = _timed(cell.run)
        ok, want = cell.check(st)
        if not ok or not bool((st.nvis == len(want)).all()):
            raise RuntimeError(f"unit merge through {kernel} differs from "
                               "the native treap")
        secs[kernel] = [s]
        del st
    out["unit merge traces R=1024 B=256"] = secs
    out["merge_elements"] = cell.elements
    print(f"[unit merge] {secs}", file=sys.stderr, flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
