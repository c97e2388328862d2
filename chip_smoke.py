"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

    python chip_smoke.py

Phases (one line each; any failure exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile ``crdt_benches_tpu_torch/csrc/*.cu`` (nvcc, sm_90a);
3. K1 (range resolver) against ``resolve_range_plain``: every batch of
   sveltecomponent and automerge-paper at 8 replicas, one sveltecomponent
   batch with the token list capped below its demand, and one
   automerge-paper batch at 1024 replicas — all eight outputs equal;
4. K2/K3 (fused range apply) against ``range_apply_plain`` on the
   producer's outputs: automerge-paper at 8 replicas (capacity 183,296),
   at 1024 replicas, and at 2 replicas with a capacity of 1,048,576 —
   all three outputs equal;
5. the main path at full width: ``TorchReplayBackend(1024 replicas,
   batch 1536)`` replays automerge-paper (1 warm-up, 3 timed); every
   replica's length must be the trace's, replicas 0 and 1023 must decode
   byte-identical to its end content, and each replay must launch K1 and
   K2 once per batch and call no plain version.

The line before the last holds the kernels' numbers as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet) used for the bounds: HBM bytes/s,
#: and the float32 non-tensor rate as the int32 ALU rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def k2_bytes(R: int, C: int) -> int:
    """Bytes the fused apply must move: four int32 inputs and new_len read
    once; doc (int32), cv_intile (int16) and vis_tile written once."""
    return R * C * (4 * 4 + 4 + 2) + R * (C // 128) * 4 + R * 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def elapsed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want) -> int:
    """Largest absolute difference over paired tensors (0 = identical)."""
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return 1 << 62
        if g.numel():
            d = (g.long() - w.long()).abs().max().item()
            worst = max(worst, int(d))
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from crdt_benches_tpu_torch import _build
    from crdt_benches_tpu_torch.backends.torch_backend import (
        TorchReplayBackend,
    )
    from crdt_benches_tpu_torch.ops import apply_range_fused as arf
    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops.apply2 import PackedState4, init_state4
    from crdt_benches_tpu_torch.traces import (
        load_testing_data,
        tensorize_ranges,
    )

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name}; nvidia-smi: {smi_line}", flush=True)

    t0 = time.perf_counter()
    _build.kernels()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "bytes stack" in ln:
            print(f"[build] {ln.strip()}", flush=True)

    traces = {n: load_testing_data(n)
              for n in ("sveltecomponent", "automerge-paper")}
    rts = {n: tensorize_ranges(t, batch=1536, coalesce=True)
           for n, t in traces.items()}
    err = {"k1": 0, "k2": 0}
    times: dict[str, float] = {}

    def walk(tname, R, C, check_k1, check_k2, until=None, time_at=None,
             tag="", stages=None):
        """Replay ``tname`` batch by batch through the kernels, holding
        them against the plain versions where asked, timing both at batch
        ``time_at`` (under ``tag``) and, when ``stages`` is a dict, summing
        each stage's device time over all batches into it."""
        rt = rts[tname]
        kb, pb, lb, sb = (torch.as_tensor(a, device=dev)
                          for a in rt.batched())
        st = init_state4(R, C, len(rt.init_chars), device=dev)
        n = rt.n_batches if until is None else until + 1
        ev = []
        for i in range(n):
            if stages is not None:
                ev.append([torch.cuda.Event(enable_timing=True)
                           for _ in range(4)])
                ev[-1][0].record()
            args = (kb[i], pb[i], lb[i], sb[i], st.nvis)
            tok, dints, nused = rr.resolve_range(*args)
            if stages is not None:
                ev[-1][1].record()
            if check_k1(i):
                want = rr.resolve_range_plain(*args)
                e = max_err((*tok, *dints, nused), (*want[0], *want[1],
                                                    want[2]))
                if e:
                    fail(f"K1 != plain on {tname} batch {i} at R={R}: {e}")
                err["k1"] = max(err["k1"], e)
            if i == time_at:
                times[f"k1{tag}_ms"] = elapsed_ms(
                    lambda: rr.resolve_range(*args), 3)
                times[f"k1{tag}_plain_ms"] = elapsed_ms(
                    lambda: rr.resolve_range_plain(*args), 1)
                times[f"k1{tag}_shape"] = (R, kb.shape[1], tok[0].shape[1])
            delpk, ind_d, dd, new_len, nvis, dsh = arf.range_apply_operands(
                st, tok, dints)
            if stages is not None:
                ev[-1][2].record()
            ops = (st.doc, delpk, ind_d, dd, new_len, dsh)
            out = arf.range_apply(*ops)
            if stages is not None:
                ev[-1][3].record()
            if check_k2(i):
                want = arf.range_apply_plain(*ops)
                e = max_err(out, want)
                if e:
                    fail(f"K2 != plain on {tname} batch {i} at R={R}, "
                         f"C={C}: {e}")
                err["k2"] = max(err["k2"], e)
            if i == time_at:
                times[f"k2{tag}_ms"] = elapsed_ms(
                    lambda: arf.range_apply(*ops), 10)
                times[f"k2{tag}_plain_ms"] = elapsed_ms(
                    lambda: arf.range_apply_plain(*ops), 3)
                times[f"k2{tag}_shape"] = (R, C)
            st = PackedState4(doc=out[0], cv_intile=out[1],
                              vis_tile=out[2], length=new_len, nvis=nvis)
        torch.cuda.synchronize()
        for e in ev:
            for k, (a, b) in enumerate(zip(e, e[1:])):
                key = ("k1", "producer", "k2")[k]
                stages[key] = stages.get(key, 0.0) + a.elapsed_time(b)
        return st

    every = lambda i: True
    never = lambda i: False
    cap_am = 183_296
    t0 = time.perf_counter()
    walk("sveltecomponent", 8, 94_208, every, every)
    walk("automerge-paper", 8, cap_am, every, every)
    print(f"[k1+k2 R=8] sveltecomponent and automerge-paper, every batch "
          f"equal ({time.perf_counter() - t0:.1f} s)", flush=True)

    # K1's overflow contract: a token list capped below the batch's demand
    # drops placements past T while nused still counts the true demand
    rt = rts["sveltecomponent"]
    v0 = torch.full((8,), len(rt.init_chars), dtype=torch.int32, device=dev)
    args = [torch.as_tensor(a[0], device=dev) for a in rt.batched()] + [v0]
    got = rr.resolve_range(*args, token_cap=256)
    want = rr.resolve_range_plain(*args, token_cap=256)
    e = max_err((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    demand = int(got[2].max())
    if e or demand <= 256:
        fail(f"K1 capped at T=256: error {e}, demand {demand}")
    print(f"[k1 capped] sveltecomponent batch 0 at T=256 (demand {demand}) "
          "equal", flush=True)

    t0 = time.perf_counter()
    walk("automerge-paper", 1024, cap_am, lambda i: i == 3,
         lambda i: i == 3, until=3, time_at=3)
    print(f"[k1 R=1024] automerge-paper batch 3 equal; kernel "
          f"{times['k1_ms']:.3f} ms, plain {times['k1_plain_ms']:.1f} ms "
          f"at (R, B, T) = {times['k1_shape']}", flush=True)
    print(f"[k2 R=1024] automerge-paper batch 3 equal; kernel "
          f"{times['k2_ms']:.3f} ms, plain {times['k2_plain_ms']:.3f} ms "
          f"at (R, C) = {times['k2_shape']}  "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    st = walk("automerge-paper", 2, 1 << 20, never, every, time_at=6,
              tag="_long")
    if st.nvis.tolist() != [len(traces["automerge-paper"].end_content)] * 2:
        fail(f"long-capacity replay lengths {st.nvis.tolist()}")
    print(f"[k2 long] automerge-paper at R=2, C={1 << 20}: every batch "
          f"equal; batch 6 kernel {times['k2_long_ms']:.3f} ms, plain "
          f"{times['k2_long_plain_ms']:.3f} ms, bytes bound "
          f"{k2_bytes(2, 1 << 20) / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del st

    stages: dict[str, float] = {}
    t0 = time.perf_counter()
    walk("automerge-paper", 1024, cap_am, never, never, stages=stages)
    wall = (time.perf_counter() - t0) * 1e3
    print("[stages] automerge-paper R=1024, all batches, device ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.2f} of {wall:.2f} ms wall "
          "(wall includes state init)", flush=True)

    # ---- the main path at full width ----
    R, B = 1024, 1536
    trace = traces["automerge-paper"]
    bk = TorchReplayBackend(n_replicas=R, batch=B, device=dev)
    bk.prepare(trace)
    nb = bk.engine.rt.n_batches
    counters = (rr.resolve_range, arf.range_apply)
    plains = (rr.resolve_range_plain, arf.range_apply_plain)
    bk.replay_once()  # warm-up
    samples = []
    launches = {}
    for _ in range(3):
        for f in counters:
            f.launches = 0
        for f in plains:
            f.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = bk.replay_once()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        launches = {f.__name__: f.launches for f in counters}
        plain_calls = {f.__name__: f.calls for f in plains}
        if any(v != nb for v in launches.values()):
            fail(f"launches per replay {launches}, want {nb} each")
        if any(plain_calls.values()):
            fail(f"plain versions called on the main path: {plain_calls}")
    if n != len(trace.end_content):
        fail(f"replay length {n} != {len(trace.end_content)}")
    st = bk.engine.run()
    lengths = st.nvis.cpu()
    if not bool((lengths == len(trace.end_content)).all()):
        fail("replica lengths differ from the trace's end length")
    for r in (0, R - 1):
        if bk.engine.decode(st, r) != trace.end_content:
            fail(f"replica {r} does not decode to the trace's end content")
    del st
    med = sorted(samples)[1]
    eps = len(trace) * R / med
    print(f"[main] automerge-paper R={R} B={B}: {nb} batches, all "
          f"{R} lengths {len(trace.end_content)}, replicas 0 and {R - 1} "
          f"byte-identical; replay s {[round(s, 4) for s in samples]}, "
          f"median {med:.4f} s, {eps:.1f} elements/s; launches per "
          f"replay {launches}, plain calls 0", flush=True)

    R1, B1, T1 = times["k1_shape"]
    k1_bytes = 4 * B1 * 4 + R1 * 4 + R1 * (4 * T1 + 3 * B1 + 1) * 4
    k1_ops = R1 * B1 * T1 * 3  # three token fields rewritten per op
    R2, C2 = times["k2_shape"]
    # per position: depth-field decode (3), four prefix adds, vis clear
    # (2), fill arithmetic (3) — 12 int32 operations
    k2_ops = R2 * C2 * 12

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    rows = []
    for key, kname, src, rep, nbytes, nops in (
        ("k1", "resolve_range", "crdt_benches_tpu_torch/csrc/resolve_range.cu",
         "crdt_benches_tpu/ops/resolve_range_pallas.py:255", k1_bytes,
         k1_ops),
        ("k2", "range_apply", "crdt_benches_tpu_torch/csrc/range_apply.cu",
         "crdt_benches_tpu/ops/apply_range_fused.py:388", k2_bytes(R2, C2),
         k2_ops),
    ):
        b_ms, b_by = bound(nbytes, nops)
        rows.append({
            "name": kname, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[kname], "max_abs_err": err[key],
            "ms": times[f"{key}_ms"], "plain_ms": times[f"{key}_plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
