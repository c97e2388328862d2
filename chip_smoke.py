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
   K2 once per batch and call no plain version;
6. K5 (unit resolver) against ``resolve_batch_plain``, with
   ``emit_origin`` off and on, on every batch of sveltecomponent at 8
   replicas (the plain versions run on the CPU, in worker processes) —
   all six outputs equal;
7. K6 (fused unit apply) against ``apply_fused2_plain``, with ``emit_cv``
   on and off, on the v4 producer's operands for every batch of
   automerge-paper at 8 replicas (staged capacities up to 182,400) and at
   2 replicas with a capacity of 1,310,720;
8. the v3 and v2 unit replays of automerge-paper at 64 replicas, batch
   256: every length the trace's, replicas 0 and 63 byte-identical, K5
   and K8 (or K9) launched once per batch, no plain version called; then
   K8 and K9 (expansions) against their plain versions on the v3 and v2
   producers' operands for every batch at 64 replicas (capacity 182,400)
   and at 2 replicas with a capacity of 1,310,720, timed at batch 1013;
9. the unit path at full width: ``TorchReplayBackend(1024 replicas,
   batch 256, layout="unit")`` (v4) replays automerge-paper (1 warm-up,
   3 timed) under the same checks, launching K5 and K6 once per batch;
   one more replay times each stage, and K5 and K6 are held against
   their plain versions (both flags each way) on the operands of its
   batch 1013 (1024 replicas, capacity 182,400) and timed there;
10. downstream update generation for automerge-paper at batch 256 (K5 on
    one replica, counted), then K7 (blocked no-cv apply) and K6 with
    ``emit_cv`` off held against their plain versions on the v5
    producer's operands of every batch at 8 replicas and at 2 replicas
    with a capacity of 1,310,720;
11. the downstream path at its recorded width:
    ``TorchDownstreamBackend(64 replicas, batch 256)`` (v5) applies the
    updates (1 warm-up, 3 timed): every length the trace's, replicas 0
    and 63 byte-identical, K7 once per batch, no K6 and no plain version;
    one more replay times each stage (query, producer, apply, snapshot
    rebuild), and the profiler gives the device's idle share over one
    whole ``replay_once``; K7, K6 without cv, K7's plain version and
    ``torch.gather`` are timed at batch 1013;
12. ``flagship.downstream`` at its defaults (1024 replicas, batch 1536),
    one replay: byte-identical at replicas 0 and 1023, K6 with ``emit_cv``
    off once per batch and no K7; its stages, idle share over one whole
    ``run`` and the same four timings at a late batch;
13. the v3 (K8 once per batch) and v1 downstream engines at 64 replicas,
    byte-identical at replicas 0 and 63.

The line before the last holds the kernels' numbers as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.  The int32
#: rate is the card's own (``int32_rate``): the data sheet's 67 TFLOP/s
#: float32 rate counts 128 FP32 lanes per SM and two operations per FMA,
#: which is not the int32 rate.
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per Hopper SM.
INT32_LANES_PER_SM = 64
REPO = os.path.dirname(os.path.abspath(__file__))


def int32_rate(smi_max_sm_mhz: str) -> float:
    """The card's int32 operations/s: SMs x 64 INT32 lanes x the maximum
    SM clock that nvidia-smi reports (MHz)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(smi_max_sm_mhz.split()[0]) * 1e6


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
    """Largest absolute difference over paired tensors (0 = identical);
    a lone tensor counts as a 1-tuple."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return 1 << 62
        if g.numel():
            d = (g.long() - w.long()).abs().max().item()
            worst = max(worst, int(d))
    return worst


def k5_plain_on_cpu(task):
    """Worker process: K5's plain version on CPU tensors from numpy
    operands (kind, pos, v0, emit_origin); returns its outputs as numpy."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    from crdt_benches_tpu_torch.ops.resolve import resolve_batch_plain

    torch.set_num_threads(1)
    kind, pos, v0, emit_origin = task
    out = resolve_batch_plain(
        torch.from_numpy(kind), torch.from_numpy(pos), torch.from_numpy(v0),
        emit_origin=emit_origin,
    )
    return [t.numpy() for t in out]


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
    from crdt_benches_tpu_torch.engine import replay as urep
    from crdt_benches_tpu_torch.engine.replay import ReplayEngine
    from crdt_benches_tpu_torch.ops import apply2
    from crdt_benches_tpu_torch.ops import apply_range_fused as arf
    from crdt_benches_tpu_torch.ops import expand as ex
    from crdt_benches_tpu_torch.ops import resolve as rs
    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops.apply2 import (
        PackedState4,
        init_state2,
        init_state3,
        init_state4,
    )
    from crdt_benches_tpu_torch.traces import (
        load_testing_data,
        tensorize,
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
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if clk.returncode:
        fail(f"nvidia-smi: {clk.stderr.strip()}")
    int32_ops_per_s = int32_rate(clk.stdout.strip().splitlines()[0])
    print(f"[device] {name}; nvidia-smi: {smi_line}; int32 rate "
          f"{int32_ops_per_s:.4g} ops/s "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} "
          f"SMs x {INT32_LANES_PER_SM} lanes x "
          f"{clk.stdout.strip()})", flush=True)

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
    print("[stages] automerge-paper R=1024, all batches, span ms (CUDA "
          "events, include device waits on the host): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.2f} of {wall:.2f} ms wall "
          "(wall includes state init)", flush=True)

    def main_path(bk, trace, counters, plains, tag, absent=()):
        """Drive ``bk`` on ``trace``: 1 warm-up and 3 timed replays, each
        with every count set to 0 just before and read just after; every
        kernel in ``counters`` must launch once per batch, every kernel in
        ``absent`` never, and no plain version run; all lengths must be
        the trace's and replicas 0 and R-1 decode to its end content.
        Returns the launches per replay."""
        R = bk.n_replicas
        eng = bk.engine
        nb = (eng.rt.n_batches if hasattr(eng, "rt") else
              eng.tt.n_batches if hasattr(eng, "tt") else eng.n_batches)
        bk.replay_once()  # warm-up
        samples = []
        launches = {}
        for _ in range(3):
            for f in (*counters, *absent):
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
                fail(f"{tag}: launches per replay {launches}, want {nb} each")
            if any(f.launches for f in absent):
                fail(f"{tag}: launched " + ", ".join(
                    f"{f.__name__} {f.launches}x" for f in absent
                    if f.launches) + " on this path")
            if any(plain_calls.values()):
                fail(f"{tag}: plain versions called on the main path: "
                     f"{plain_calls}")
        if n != len(trace.end_content):
            fail(f"{tag}: replay length {n} != {len(trace.end_content)}")
        st = eng.run()
        lengths = st.nvis.cpu()
        if not bool((lengths == len(trace.end_content)).all()):
            fail(f"{tag}: replica lengths differ from the trace's end length")
        for r in (0, R - 1):
            if eng.decode(st, r) != trace.end_content:
                fail(f"{tag}: replica {r} does not decode to the trace's "
                     "end content")
        del st
        med = sorted(samples)[1]
        eps = len(trace) * R / med
        print(f"[{tag}] automerge-paper R={R} B={bk.batch}: {nb} batches, "
              f"all {R} lengths {len(trace.end_content)}, replicas 0 and "
              f"{R - 1} byte-identical; replay s "
              f"{[round(s, 4) for s in samples]}, median {med:.4f} s, "
              f"{eps:.1f} elements/s; launches per replay {launches}, "
              "plain calls 0", flush=True)
        return launches

    # ---- the main path at full width ----
    trace = traces["automerge-paper"]
    bk = TorchReplayBackend(n_replicas=1024, batch=1536, device=dev)
    bk.prepare(trace)
    launches = main_path(
        bk, trace, (rr.resolve_range, arf.range_apply),
        (rr.resolve_range_plain, arf.range_apply_plain), "main",
    )
    del bk

    # ---- the unit-op path: K5, K6, K8, K9 ----
    utts = {n: tensorize(t, batch=256) for n, t in traces.items()}
    uerr = {"k5": 0, "k6": 0, "k8": 0, "k9": 0}
    am = utts["automerge-paper"]
    end_am = len(trace.end_content)
    late = am.n_batches - 2  # the last batch without PAD ops
    kb, pb, _, sb = (torch.as_tensor(a, device=dev) for a in am.batched())
    # engine: (producer, kernel, plain version, finish, init, kernel keys
    # each checked), as apply2.apply_batch2/3/4 compose them
    unit = {
        "v4": ("k6", apply2.batch4_operands, arf.apply_fused2,
               arf.apply_fused2_plain, apply2.batch4_finish, init_state4,
               ({}, {"emit_cv": False})),
        "v3": ("k8", apply2.batch3_operands, ex.expand_packed,
               ex.expand_packed_plain, apply2.batch3_finish, init_state3,
               ({},)),
        "v2": ("k9", apply2.batch2_operands, ex.expand_fill_zero,
               ex.expand_fill_zero_plain, apply2.batch2_finish, init_state2,
               ({},)),
    }

    def engine_chunks(e):
        return list(zip(e.stage_caps, e.chunks))

    def time_unit_batch(key, kern, plain, ops, args):
        """At one batch: K5 held against its plain version with emit_origin
        off and on, and K5 (v4 only), the apply kernel, its plain version
        and (K8, K9) torch.gather on the source index timed."""
        for eo in (False, True):
            e = max_err(tuple(rs.resolve_batch(*args, emit_origin=eo)),
                        tuple(rs.resolve_batch_plain(*args, emit_origin=eo)))
            if e:
                fail(f"K5 != plain at R={args[2].shape[0]}, emit_origin "
                     f"{eo}: {e}")
            uerr["k5"] = max(uerr["k5"], e)
        R, C = ops[0].shape
        if key == "k6":
            times["k5_ms"] = elapsed_ms(
                lambda: rs.resolve_batch(*args, emit_origin=False), 10)
            times["k5_plain_ms"] = elapsed_ms(
                lambda: rs.resolve_batch_plain(*args, emit_origin=False), 1)
            times["k5_shape"] = (R, args[0].shape[0],
                                 rs.token_list_size(args[0].shape[0]))
            # doc and combo matter only below new_len (2 is written past it)
            times["k6_rows"] = int(ops[2].clamp(max=C).sum())
        col = torch.arange(C, device=dev)
        if key == "k8":
            src = (col - (ops[1] >> 1)).clamp(min=0).long()
            times["k8_lib_ms"] = elapsed_ms(
                lambda: torch.gather(ops[0], 1, src), 20)
        elif key == "k9":
            src = (col - ops[2]).clamp(min=0).long()
            times["k9_lib_ms"] = elapsed_ms(
                lambda: (torch.gather(ops[0], 1, src),
                         torch.gather(ops[1], 1, src)), 20)
        times[f"{key}_ms"] = elapsed_ms(lambda: kern(*ops), 20)
        times[f"{key}_plain_ms"] = elapsed_ms(lambda: plain(*ops), 3)
        times[f"{key}_shape"] = (R, C)

    def unit_walk(eng, st, chunks, check=never, k5_log=None, time_at=None,
                  stages=None):
        """Replay ``chunks`` ((capacity, (kind, pos, slot)) each) from
        ``st`` batch by batch as ``ReplayEngine.run`` does: K5, then
        ``eng``'s producer, kernel and finish.  Where ``check(i)`` or at
        batch ``time_at`` the kernel's outputs (with each keyword variant)
        are held against its plain version on the same operands; at
        ``time_at`` K5 is checked too and both are timed
        (:func:`time_unit_batch`); K5's operands and outputs go to
        ``k5_log`` if given; with ``stages`` a dict, each stage's device
        time is summed into it.  Returns (state, batches checked, host
        seconds spent checking and timing)."""
        key, producer, kern, plain, finish, _, variants = unit[eng]
        i = n_checked = 0
        aside = 0.0
        ev = []
        for cap, (kind, pos, slot) in chunks:
            if eng == "v4":
                st = urep._grow_state4(st, cap)
            for j in range(kind.shape[0]):
                if stages is not None:
                    ev.append([torch.cuda.Event(enable_timing=True)
                               for _ in range(4)])
                    ev[-1][0].record()
                args = (kind[j], pos[j], st.nvis)
                res = rs.resolve_batch(*args, emit_origin=False)
                if stages is not None:
                    ev[-1][1].record()
                if k5_log is not None:
                    k5_log.append((args, res))
                ops, rest = producer(st, res, slot[j])
                if stages is not None:
                    ev[-1][2].record()
                out = kern(*ops)
                if stages is not None:
                    ev[-1][3].record()
                if check(i) or i == time_at:
                    t1 = time.perf_counter()
                    for kw in variants:
                        got = kern(*ops, **kw) if kw else out
                        e = max_err(got, plain(*ops, **kw))
                        if e:
                            fail(f"{kern.__name__} != plain ({kw}) at batch "
                                 f"{i}, (R, C) = {tuple(ops[0].shape)}: {e}")
                        uerr[key] = max(uerr[key], e)
                    n_checked += 1
                    if i == time_at:
                        time_unit_batch(key, kern, plain, ops, args)
                    aside += time.perf_counter() - t1
                st = finish(out, *rest)
                i += 1
        torch.cuda.synchronize()
        for e in ev:
            for k, (a, b) in enumerate(zip(e, e[1:])):
                name = ("k5", "producer", key)[k]
                stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
        return st, n_checked, aside

    def lengths_ok(st, tag):
        if not bool((st.nvis == end_am).all()):
            fail(f"{tag}: lengths {st.nvis[:4].tolist()} != {end_am}")

    def checked_all(n, tag):
        if n != am.n_batches:
            fail(f"{tag}: {n} batches checked, want {am.n_batches}")

    # K5 on every sveltecomponent batch, emit_origin off (as the replay
    # launches it) and on; the plain versions run in CPU worker processes
    t0 = time.perf_counter()
    sv = ReplayEngine(utts["sveltecomponent"], n_replicas=8, device=dev)
    k5_log = []
    unit_walk("v4", sv.init_state(), engine_chunks(sv), k5_log=k5_log)
    if len(k5_log) != sv.tt.n_batches:
        fail(f"K5 logged {len(k5_log)} batches, want {sv.tt.n_batches}")
    tasks, got = [], []
    for args, out in k5_log:
        for eo, res in ((False, out),
                        (True, rs.resolve_batch(*args, emit_origin=True))):
            tasks.append((*(a.cpu().numpy() for a in args), eo))
            got.append(res)
    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    with ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        wants = list(pool.map(k5_plain_on_cpu, tasks, chunksize=8))
    for i, (g, w) in enumerate(zip(got, wants)):
        e = max_err(tuple(g), tuple(torch.from_numpy(x).to(dev) for x in w))
        if e:
            fail(f"K5 != plain on sveltecomponent batch {i // 2}, "
                 f"emit_origin {tasks[i][3]}: {e}")
        uerr["k5"] = max(uerr["k5"], e)
    print(f"[k5 R=8] sveltecomponent: all {len(k5_log)} batches equal with "
          f"emit_origin off and on (plain on {workers} CPU workers; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    del k5_log, tasks, got, wants

    # K6 on every automerge-paper batch: R = 8 at the staged capacities,
    # R = 2 at a capacity past the TPU kernel's ~1.09M-position gate
    long_c = 1_310_720
    long_chunks = [(long_c, (kb, pb, sb))]
    t0 = time.perf_counter()
    e8 = ReplayEngine(am, n_replicas=8, device=dev)
    st, n, _ = unit_walk("v4", e8.init_state(), engine_chunks(e8), every)
    lengths_ok(st, "K6 R=8")
    checked_all(n, "K6 R=8")
    st, n, _ = unit_walk(
        "v4", init_state4(2, long_c, len(am.init_chars), device=dev),
        long_chunks, every)
    lengths_ok(st, "K6 long")
    checked_all(n, "K6 long")
    print(f"[k6] automerge-paper, all {am.n_batches} batches equal with "
          f"emit_cv on and off at R=8 (C up to {e8.stage_caps[-1]}) and at "
          f"R=2, C={long_c} ({time.perf_counter() - t0:.1f} s)", flush=True)
    del st, e8

    # K8 (v3) and K9 (v2): their replays at R = 64 through the engine,
    # counted; then every batch held against the plain version at that
    # width and at R = 2 past the gate, timed at a late batch
    alt_launches = {}
    for eng in ("v3", "v2"):
        key, _, kern, plain, _, init, _ = unit[eng]
        t0 = time.perf_counter()
        e64 = ReplayEngine(am, n_replicas=64, engine=eng, device=dev)
        pair = (rs.resolve_batch, kern)
        for f in pair:
            f.launches = 0
        for f in (rs.resolve_batch_plain, plain, arf.apply_fused2_plain):
            f.calls = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = e64.run()
        lengths_ok(st, f"{eng} R=64")
        secs = time.perf_counter() - t1
        la = {f.__name__: f.launches for f in pair}
        pc = (rs.resolve_batch_plain.calls + plain.calls
              + arf.apply_fused2_plain.calls)
        if any(v != am.n_batches for v in la.values()) or pc:
            fail(f"{eng} replay: launches {la}, plain calls {pc}")
        for r in (0, 63):
            if e64.decode(st, r) != trace.end_content:
                fail(f"{eng} replay: replica {r} differs from the end content")
        alt_launches[key] = la[kern.__name__]
        st, n, _ = unit_walk(eng, e64.init_state(), engine_chunks(e64),
                             every, time_at=late)
        lengths_ok(st, f"{key} R=64")
        checked_all(n, f"{key} R=64")
        st, n, _ = unit_walk(
            eng, init(2, long_c, len(am.init_chars), device=dev),
            long_chunks, every)
        lengths_ok(st, f"{key} long")
        checked_all(n, f"{key} long")
        del st
        print(f"[{key}] automerge-paper: the {eng} replay at R=64: all "
              f"lengths {end_am}, replicas 0 and 63 byte-identical, launches "
              f"{la}, plain calls 0, {secs:.3f} s; all {am.n_batches} batches"
              f" equal at R=64, C={e64.capacity} and at R=2, C={long_c}; "
              f"batch {late}: kernel {times[key + '_ms']:.4f} ms, plain "
              f"{times[key + '_plain_ms']:.4f} ms, torch.gather on the "
              f"source index {times[key + '_lib_ms']:.4f} ms at (R, C) = "
              f"{times[key + '_shape']} ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    # ---- the unit path at full width ----
    bk = TorchReplayBackend(n_replicas=1024, batch=256, layout="unit",
                            device=dev)
    bk.prepare(trace)
    unit_launches = main_path(
        bk, trace, (rs.resolve_batch, arf.apply_fused2),
        (rs.resolve_batch_plain, arf.apply_fused2_plain), "unit main",
    )
    # one more replay, stage by stage, with K5 and K6 held against their
    # plain versions (both flags each way) and timed at a late batch
    ustages: dict[str, float] = {}
    eng = bk.engine
    t0 = time.perf_counter()
    st, n, aside = unit_walk("v4", eng.init_state(), engine_chunks(eng),
                             time_at=late, stages=ustages)
    wall = (time.perf_counter() - t0 - aside) * 1e3
    lengths_ok(st, "unit stages")
    if n != 1:
        fail(f"unit stages: {n} batches checked, want 1")
    del st, bk, eng
    print("[unit stages] automerge-paper R=1024 B=256, all batches, span "
          "ms (CUDA events, include device waits on the host): " + ", ".join(f"{k} {v:.2f}" for k, v in ustages.items())
          + f"; sum {sum(ustages.values()):.2f} of {wall:.2f} ms wall "
          f"(wall includes state init and capacity growth, not the check)",
          flush=True)
    print(f"[k5+k6 R=1024] automerge-paper batch {late} equal (K5 with "
          f"emit_origin off and on, K6 with emit_cv on and off); "
          f"K5 {times['k5_ms']:.3f} ms, plain {times['k5_plain_ms']:.1f} ms "
          f"at (R, B, T) = {times['k5_shape']}; K6 {times['k6_ms']:.3f} ms, "
          f"plain {times['k6_plain_ms']:.3f} ms at (R, C) = "
          f"{times['k6_shape']}, {times['k6_rows']} positions below "
          f"new_len ({aside:.1f} s)", flush=True)

    # ---- the downstream path: K7, and K6 without cv (slice 3) ----
    from crdt_benches_tpu_torch.engine import downstream as dsm
    from crdt_benches_tpu_torch.models import flagship
    from crdt_benches_tpu_torch.ops.idpos import snap_rebuild

    kernels_all = (rs.resolve_batch, arf.apply_fused2, ex.expand_packed,
                   ex.expand_fill_zero, ex.apply_fused_blocked)
    plains_all = (rs.resolve_batch_plain, arf.apply_fused2_plain,
                  ex.expand_packed_plain, ex.expand_fill_zero_plain,
                  ex.apply_fused_blocked_plain)
    derr = {"k7": 0, "k6nocv": 0}

    def zero_counts():
        for f in kernels_all:
            f.launches = 0
        for f in plains_all:
            f.calls = 0

    def time_down_batch(tag, ops):
        """K7, K6 without cv, K7's plain version and torch.gather on the
        precomputed source index (d - cnt[d], clamped), timed on one
        batch's operands."""
        doc_predel, combo, cnt_base, new_len = ops
        R, C = doc_predel.shape
        nt = C // 128
        cnt = (torch.cumsum((combo & 1).view(R, nt, 128), dim=2,
                            dtype=torch.int32)
               + cnt_base[:, :, None]).view(R, C)
        src = (torch.arange(C, device=dev) - cnt).clamp(0, C - 1).long()
        times[f"k7{tag}_ms"] = elapsed_ms(
            lambda: ex.apply_fused_blocked(*ops), 20)
        times[f"k6nocv{tag}_ms"] = elapsed_ms(
            lambda: arf.apply_fused2(doc_predel, combo, new_len,
                                     emit_cv=False), 20)
        times[f"k7{tag}_plain_ms"] = elapsed_ms(
            lambda: ex.apply_fused_blocked_plain(*ops), 3)
        times[f"k7{tag}_lib_ms"] = elapsed_ms(
            lambda: torch.gather(doc_predel, 1, src), 20)
        times[f"k7{tag}_shape"] = (R, C)
        # doc_predel and combo matter only below new_len
        times[f"k7{tag}_rows"] = int(new_len.clamp(max=C).sum())

    def down_walk(wire, st, check=never, time_at=None, tag="", stages=None,
                  until=None, epoch=32):
        """Apply the v5 wire tensors (ins, anchor, rank, dslot int32[N, B])
        to ``st`` batch by batch as ``dsm.apply_updates5`` does: the
        anchor/delete query, the producer, the no-cv apply through the
        dispatch, the snapshot rebuild after each epoch.  Where
        ``check(i)`` or at batch ``time_at``, K7 and K6 without cv are held
        against their plain versions (and each other) on the batch's
        operands; at ``time_at`` they are timed (:func:`time_down_batch`).
        With ``stages`` a dict, each stage's CUDA-event span (ms, device
        waits on the host included) is summed into it.
        Stops after batch ``until``.  Returns (state, batches checked, host
        seconds spent checking and timing)."""
        ins_b, anchor_b, rank_b, dslot_b = wire
        doc, snap, length, nvis = st
        N = ins_b.shape[0] if until is None else until + 1
        n_checked = 0
        aside = 0.0
        ev, evs = [], []
        mk = lambda: torch.cuda.Event(enable_timing=True)
        for e0 in range(0, N, epoch):
            levels = []
            for i in range(e0, min(e0 + epoch, N)):
                if stages is not None:
                    ev.append([mk() for _ in range(4)])
                    ev[-1][0].record()
                targets = dsm.resolve_targets5(snap, levels, anchor_b[i],
                                               dslot_b[i])
                if stages is not None:
                    ev[-1][1].record()
                ops, (nvis, lv) = dsm.batch5_operands(
                    doc, length, nvis, targets, ins_b[i], anchor_b[i],
                    rank_b[i], dslot_b[i])
                if stages is not None:
                    ev[-1][2].record()
                out = ex.fused_apply_nocv_dispatch(*ops)
                if stages is not None:
                    ev[-1][3].record()
                if check(i) or i == time_at:
                    t1 = time.perf_counter()
                    k7 = ex.apply_fused_blocked(*ops)
                    k6 = arf.apply_fused2(ops[0], ops[1], ops[3],
                                          emit_cv=False)
                    e7 = max_err(k7, ex.apply_fused_blocked_plain(*ops))
                    e6 = max_err(k6, arf.apply_fused2_plain(
                        ops[0], ops[1], ops[3], emit_cv=False))
                    if e7 or e6 or max_err(k7, k6) or max_err(out, k7):
                        fail(f"K7/K6 (no cv) != plain at batch {i}, (R, C) "
                             f"= {tuple(ops[0].shape)}: K7 {e7}, K6 {e6}")
                    derr["k7"] = max(derr["k7"], e7)
                    derr["k6nocv"] = max(derr["k6nocv"], e6)
                    n_checked += 1
                    if i == time_at:
                        time_down_batch(tag, ops)
                    aside += time.perf_counter() - t1
                doc, length = out, ops[3]
                levels.append(lv)
            if stages is not None:
                evs.append([mk(), mk()])
                evs[-1][0].record()
            snap = snap_rebuild(doc)
            if stages is not None:
                evs[-1][1].record()
        torch.cuda.synchronize()
        for e in ev:
            for k, (a, b) in enumerate(zip(e, e[1:])):
                key = ("query", "producer", "apply")[k]
                stages[key] = stages.get(key, 0.0) + a.elapsed_time(b)
        for a, b in evs:
            stages["snap"] = stages.get("snap", 0.0) + a.elapsed_time(b)
        return dsm.DownPacked(doc, snap, length, nvis), n_checked, aside

    def idle_share(window):
        """Device idle share of ``window()``: 1 - the summed device time of
        its kernels and copies (torch.profiler, one profiled call) over its
        wall time (host clock, one unprofiled call, after a warm-up), None
        when the profiler shows no device time; with the wall and busy ms
        and the seconds the measurement took."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window()
            torch.cuda.synchronize()
        # the raw kineto events: prof.events() builds a Python tree of every
        # host op, minutes for a whole v5 replay's ~1M of them
        busy = sum(e.duration_ns()
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA) / 1e6
        return ((1 - busy / wall if busy > 0 else None), wall, busy,
                time.perf_counter() - t0)

    def fmt_idle(idle, wall, busy, secs):
        if idle is None:
            return (f"idle not measured (no device time), wall {wall:.2f} ms "
                    f"({secs:.1f} s)")
        return (f"device busy {busy:.2f} of {wall:.2f} ms wall, idle "
                f"{100 * idle:.1f}% ({secs:.1f} s)")

    # the recorded downstream width: R = 64, B = 256; updates generated
    # untimed (K5 on one replica, emit_origin on), counted
    t0 = time.perf_counter()
    zero_counts()
    dbk = dsm.TorchDownstreamBackend(n_replicas=64, batch=256, device=dev)
    dbk.prepare(trace)
    deng = dbk.engine
    gen_k5 = rs.resolve_batch.launches
    if gen_k5 != deng.n_batches or any(f.calls for f in plains_all):
        fail(f"downstream generation: K5 launched {gen_k5} times for "
             f"{deng.n_batches} batches, plain calls "
             f"{[f.calls for f in plains_all]}")
    dcap, dinit = deng.upd.capacity, deng.upd.n_init
    wire = (deng.ins_b, deng.anchor_b, deng.rank_b, deng.dslot_b)
    print(f"[down gen] automerge-paper B=256: {deng.n_batches} update "
          f"batches, capacity {dcap}, generated untimed in "
          f"{time.perf_counter() - t0:.1f} s (K5 {gen_k5} launches, plain "
          "calls 0)", flush=True)

    # K7 and K6 without cv on every batch's v5 operands: R = 8, and R = 2
    # at a capacity past the TPU kernel's ~1.09M-position gate
    t0 = time.perf_counter()
    st, n, _ = down_walk(wire, dsm.down_packed_init(8, dcap, dinit, dev),
                         check=every)
    lengths_ok(st, "K7 R=8")
    checked_all(n, "K7 R=8")
    if dbk.engine.decode(st, 7) != trace.end_content:
        fail("K7 R=8 walk: replica 7 differs from the end content")
    st, n, _ = down_walk(wire, dsm.down_packed_init(2, long_c, dinit, dev),
                         check=every, time_at=late, tag="_long")
    lengths_ok(st, "K7 long")
    checked_all(n, "K7 long")
    del st
    print(f"[k7] automerge-paper downstream: all {am.n_batches} batches' v5 "
          f"operands, K7 and K6 (emit_cv off) equal their plain versions "
          f"and each other at R=8 (C={dcap}) and at R=2, C={long_c}; batch "
          f"{late} at R=2: K7 {times['k7_long_ms']:.4f} ms, plain "
          f"{times['k7_long_plain_ms']:.4f} ms "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # the downstream path at the recorded width: K7 once per batch
    down_launches = main_path(
        dbk, trace, (ex.apply_fused_blocked,), plains_all, "down main",
        absent=(arf.apply_fused2, rs.resolve_batch, ex.expand_packed,
                ex.expand_fill_zero),
    )
    dstages: dict[str, float] = {}
    t0 = time.perf_counter()
    st, n, aside = down_walk(wire, deng.init_state(), time_at=late,
                             tag="_r64", stages=dstages)
    wall = (time.perf_counter() - t0 - aside) * 1e3
    lengths_ok(st, "down stages")
    del st
    idle64 = idle_share(dbk.replay_once)
    print("[down stages] automerge-paper v5 R=64 B=256, all batches, span "
          "ms (CUDA events, include device waits on the host): "
          + ", ".join(f"{k} {v:.2f}" for k, v in dstages.items())
          + f"; sum {sum(dstages.values()):.2f} of {wall:.2f} ms wall "
          f"(wall includes state init, not the check); one replay_once: "
          + fmt_idle(*idle64), flush=True)
    print(f"[k7 R=64] batch {late}: K7 {times['k7_r64_ms']:.4f} ms, K6 "
          f"(emit_cv off) {times['k6nocv_r64_ms']:.4f} ms, plain "
          f"{times['k7_r64_plain_ms']:.4f} ms, torch.gather on the source "
          f"index {times['k7_r64_lib_ms']:.4f} ms at (R, C) = "
          f"{times['k7_r64_shape']}", flush=True)

    # flagship.downstream() at its defaults: R = 1024, B = 1536, K6
    t0 = time.perf_counter()
    feng = flagship.downstream(trace, device=dev)
    gen_s = time.perf_counter() - t0
    fR = feng.n_replicas
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = feng.run()
    torch.cuda.synchronize()
    rep_s = time.perf_counter() - t0
    fl = {f.__name__: f.launches for f in kernels_all}
    if (fl["apply_fused2"] != feng.n_batches or fl["apply_fused_blocked"]
            or any(f.calls for f in plains_all)):
        fail(f"flagship downstream: launches {fl} for {feng.n_batches} "
             f"batches, plain calls {[f.calls for f in plains_all]}")
    if not bool((st.nvis == end_am).all()):
        fail("flagship downstream: lengths differ from the trace's")
    for r in (0, fR - 1):
        if feng.decode(st, r) != trace.end_content:
            fail(f"flagship downstream: replica {r} differs from the end "
                 "content")
    del st
    fwire = (feng.ins_b, feng.anchor_b, feng.rank_b, feng.dslot_b)
    flate = feng.n_batches - 2
    fstages: dict[str, float] = {}
    t0 = time.perf_counter()
    st, n, aside = down_walk(fwire, feng.init_state(), time_at=flate,
                             tag="_r1024", stages=fstages)
    fwall = (time.perf_counter() - t0 - aside) * 1e3
    lengths_ok(st, "flagship stages")
    del st
    idle1k = idle_share(feng.run)
    print(f"[down flagship] automerge-paper v5 R={fR} "
          f"B={feng.upd.ins_slot.shape[1]}: "
          f"{feng.n_batches} batches, generation {gen_s:.1f} s, one replay "
          f"{rep_s:.4f} s = {len(trace) * fR / rep_s:.1f} elements/s; all "
          f"lengths {end_am}, replicas 0 and {fR - 1} byte-identical; K6 "
          f"(emit_cv off) {fl['apply_fused2']} launches, K7 0, plain calls "
          "0; stages, span ms (CUDA events, include device waits on the "
          "host): "
          + ", ".join(f"{k} {v:.2f}" for k, v in fstages.items())
          + f"; sum {sum(fstages.values()):.2f} of {fwall:.2f} ms wall; "
          "one run: " + fmt_idle(*idle1k), flush=True)
    print(f"[k7 R=1024] batch {flate} equal; K7 {times['k7_r1024_ms']:.4f} "
          f"ms, K6 (emit_cv off) {times['k6nocv_r1024_ms']:.4f} ms, plain "
          f"{times['k7_r1024_plain_ms']:.4f} ms, torch.gather on the source "
          f"index {times['k7_r1024_lib_ms']:.4f} ms at (R, C) = "
          f"{times['k7_r1024_shape']}", flush=True)
    del feng

    # the v3 (K8) and v1 downstream engines at R = 64, counted
    for ename in ("v3", "v1"):
        t0 = time.perf_counter()
        e = dsm.DownstreamEngine(am, n_replicas=64, engine=ename, device=dev)
        gen_s = time.perf_counter() - t0
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = e.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        la = {f.__name__: f.launches for f in kernels_all}
        want = {f.__name__: 0 for f in kernels_all}
        if ename == "v3":
            want["expand_packed"] = e.n_batches
        if la != want or any(f.calls for f in plains_all):
            fail(f"downstream {ename}: launches {la}, want {want}; plain "
                 f"calls {[f.calls for f in plains_all]}")
        lengths_ok(st, f"downstream {ename}")
        for r in (0, 63):
            if e.decode(st, r) != trace.end_content:
                fail(f"downstream {ename}: replica {r} differs from the end "
                     "content")
        del st, e
        print(f"[down {ename}] automerge-paper R=64 B=256: all lengths "
              f"{end_am}, replicas 0 and 63 byte-identical; launches "
              f"{ {k: v for k, v in la.items() if v} or 'none (no kernel)'}"
              f", plain calls 0; generation {gen_s:.1f} s, one replay "
              f"{secs:.4f} s", flush=True)

    R1, B1, T1 = times["k1_shape"]
    k1_bytes = 4 * B1 * 4 + R1 * 4 + R1 * (4 * T1 + 3 * B1 + 1) * 4
    k1_ops = R1 * B1 * T1 * 3  # three token fields rewritten per op
    R2, C2 = times["k2_shape"]
    # per position: depth-field decode (3), four prefix adds, vis clear
    # (2), fill arithmetic (3) — 12 int32 operations
    k2_ops = R2 * C2 * 12
    R5, B5, T5 = times["k5_shape"]
    # kind/pos and v0 read; five int32 and one bool output per (R, B)
    k5_bytes = 2 * B5 * 4 + R5 * 4 + R5 * B5 * (5 * 4 + 1)
    k5_ops = R5 * B5 * T5 * 2  # two token fields (tta, cum) per op
    R6, C6 = times["k6_shape"]
    # doc_predel and combo read below new_len; doc (int32), cv_intile
    # (int16) and vis_tile written everywhere; new_len read
    k6_bytes = (times["k6_rows"] * (4 + 4) + R6 * C6 * (4 + 2)
                + R6 * (C6 // 128) * 4 + R6 * 4)
    k6_ops = R6 * C6 * 8  # prefix, hole test, source, length test, vis
    R8, C8 = times["k8_shape"]
    R9, C9 = times["k9_shape"]
    R7, C7 = times["k7_r64_shape"]
    # doc_predel and combo read below new_len; out written everywhere;
    # cnt_base and new_len read
    k7_bytes = (times["k7_r64_rows"] * (4 + 4) + R7 * C7 * 4
                + R7 * (C7 // 128) * 4 + R7 * 4)
    k7_ops = R7 * C7 * 6  # in-tile prefix, source, length test, selects

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S, nops / int32_ops_per_s
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    src = "crdt_benches_tpu_torch/csrc/"
    tpu = "crdt_benches_tpu/ops/"
    rows = []
    for key, kname, cu, rep, n_launch, e, nbytes, nops, lib in (
        ("k1", "resolve_range", "resolve_range.cu",
         "resolve_range_pallas.py:255", launches["resolve_range"],
         err["k1"], k1_bytes, k1_ops, None),
        ("k2", "range_apply", "range_apply.cu",
         "apply_range_fused.py:388", launches["range_apply"], err["k2"],
         k2_bytes(R2, C2), k2_ops, None),
        ("k5", "resolve_batch", "resolve_unit.cu",
         "resolve_pallas.py:282", unit_launches["resolve_batch"],
         uerr["k5"], k5_bytes, k5_ops, None),
        ("k6", "apply_fused2", "unit_apply.cu", "apply_range_fused.py:167",
         unit_launches["apply_fused2"], uerr["k6"], k6_bytes, k6_ops, None),
        ("k8", "expand_packed", "expand.cu", "expand_pallas.py:114",
         alt_launches["k8"], uerr["k8"], R8 * C8 * 12, R8 * C8 * 3,
         times["k8_lib_ms"]),
        ("k9", "expand_fill_zero", "expand.cu", "expand_pallas.py:396",
         alt_launches["k9"], uerr["k9"], R9 * C9 * 24, R9 * C9 * 4,
         times["k9_lib_ms"]),
        ("k7_r64", "apply_fused_blocked", "apply_blocked.cu",
         "expand_pallas.py:276", down_launches["apply_fused_blocked"],
         derr["k7"], k7_bytes, k7_ops, times["k7_r64_lib_ms"]),
    ):
        b_ms, b_by = bound(nbytes, nops)
        rows.append({
            "name": kname, "route": "cuda", "source": src + cu,
            "replaces": tpu + rep, "launches": n_launch, "max_abs_err": e,
            "ms": times[f"{key}_ms"], "plain_ms": times[f"{key}_plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        })
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
