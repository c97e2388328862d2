"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

    python chip_smoke.py

Phases (one line each; any failure exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile ``crdt_benches_tpu_torch/csrc/*.cu`` (nvcc, sm_90a);
3. K1 (range resolver) against ``resolve_range_plain``: every other batch
   of sveltecomponent and automerge-paper at 8 replicas, one sveltecomponent
   batch with the token list capped below its demand, one
   automerge-paper batch at 1024 replicas, and the worst cases (inserts
   at 0, deletes at 0 past the end of a short document, inserts at
   alternating ends, scattered inserts under one spanning delete, a PAD
   tail, automerge-paper batch 3) at 1, 5 and 1024 replicas, timed at
   1024 — all eight outputs equal;
   Then K4 (the serve macro apply) against ``serve_macro_plain`` on its
   worst cases (inserts at 0 in every round, one delete spanning the row,
   rows ending exactly at capacity, one row, C = 1152, and a capacity past
   the shared-memory reach), resolved by K1's per-row form, each timed;
4. K2 and K3 (the fused range apply, one block per row and each row
   split across blocks) against ``range_apply_plain`` on the producer's
   outputs: automerge-paper at 8 replicas (capacity 183,296) and at 1024
   replicas — all three outputs equal; ``[k3]``: automerge-paper at 2
   replicas with a capacity of 1,048,576 through the dispatch, which must
   take K3 at every batch, each held against the plain version, batch 6
   timed beside its bound; ``[k3 worst]``: K3 on ``bench/k3_cases.py``'s
   cases at the card's size (a paste wider than a block at column 0, a
   delete over many blocks, runs across block edges, new lengths on a
   block edge, inside a tile, at 0 and at C, rows ending at C, 64 full
   rows, ragged capacities, run depth 2, random operands), each checked
   before and after ten timed launches; ``[k2 worst]``: K2 called directly
   on ``bench/k3_cases.py``'s cases built to K2's widths (a paste wider
   than its x ring, new lengths on a chunk edge, inside a tile, at 0 and at
   C, full rows, mixed rows, run depth 2, random operands) at R = 132 and
   at R = 1, 2 and 3, each checked before and after ten timed launches and
   its count of columns sourced left of the ring held against
   ``range_apply_ring_misses``; ``[k3 vs k2]``: both kernels on
   automerge-paper batch 3's operands at R = 1, 2, 8, 64, 80, 84, 88, 96,
   128, 256, 1024 and 4096 (C = 183,296) and at R = 2, C = 1,048,576, and on
   full rows at R = 64 to 1024, timed in turns beside the bound, with the
   kernel the dispatch takes there;
5. the main path at full width: ``TorchReplayBackend(1024 replicas,
   batch 1536)`` replays automerge-paper (1 warm-up, 3 timed); every
   replica's length must be the trace's, replicas 0 and 1023 must decode
   byte-identical to its end content, and each replay must launch K1 and
   the apply the dispatch takes at R = 1024 once per batch, the other
   never, and call no plain version; then ``[range R=1]``, the
   reference's own configuration (one replica, ``layout="range"``), under
   the same checks with K1 and K3 once per batch and K2 never;
6. K5 (unit resolver) against ``resolve_batch_plain``, with
   ``emit_origin`` off and on, on every fourth batch of sveltecomponent at
   8 replicas (the plain versions run on the CPU, in worker processes), and
   on the worst-case batches (inserts at 0, deletes at 0, inserts at
   alternating ends, a late automerge-paper batch) at 1, 5 and 1024
   replicas — all six outputs equal;
7. K6 (fused unit apply) against ``apply_fused2_plain``, with ``emit_cv``
   on and off, on the v4 producer's operands for every batch of
   automerge-paper at 8 replicas (staged capacities up to 182,400) and
   every other batch at 2 replicas with a capacity of 1,310,720;
8. the v3 and v2 unit replays of automerge-paper at 64 replicas, batch
   256: every length the trace's, replicas 0 and 63 byte-identical, K5
   and K8 (or K9) launched once per batch, no plain version called; then
   K8 and K9 (expansions) against their plain versions on the v3 and v2
   producers' operands for every batch at 64 replicas (capacity 182,400)
   and every other batch at 2 replicas with a capacity of 1,310,720, timed
   at batch 1013;
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
    one replay: byte-identical at replicas 0 and 1023, K7 once per batch
    and no K6; its stages, idle share over one whole ``run`` and the same
    four timings at a late batch (K7 against K6 without cv);
13. the v3 (K8 once per batch) and v1 downstream engines at 64 replicas,
    byte-identical at replicas 0 and 63;
14. the serving fleet on serve/mixed/4096 (4096 documents, five capacity
    classes, batch 64, macro depth 8): one drain in which every dispatch's
    per-row resolve (K1's per-row form) equals its plain version and the
    round-starts recurrence, and every K4 (serve macro apply) launch
    equals ``serve_macro_plain`` — every class, tiers below the bucket
    rows, all-PAD rows and PAD tails — with K1's per-row form timed, K4
    timed at every (class, tier) the drain launched it at (its launches,
    bound and cluster geometry beside each), and K1's per-row form on rows
    of inserts at 0 in every round; then the
    timed drain through ``run_serve_bench``: both kernels once per
    dispatch, no plain version, evictions, restores and promotions, every
    document byte-identical to the oracle, its host phases and device
    spans; and the device's idle share over a third, profiled drain;
15. the concurrent merges (``bench/merge.py``, ``--group merge``):
    merge/traces (rustcode and seph-blog1, 1,348,053 delivered ops)
    through the unit, run and flat engines at 64 replicas and through the
    run and flat engines at 1024, merge/adversarial (9,999,872 delivered
    ops, each unique op ~16 times, shuffled) through the unit and flat
    engines at 64: the generation counted (K5 once a batch of every
    agent's stream, held against its plain version on one batch), then per
    cell a counted run (K7 once a batch on the unit and run merges),
    every replica's digest equal, replicas 0 and R-1 byte-identical to the
    native treap's merge, a timed run with CUDA-event spans, the device's
    idle share over a profiled run, and the engines' documents identical;
    K7 held against its plain version on one unit-merge batch at 64
    replicas;
16. the range and run downstream columns on automerge-paper at 64
    replicas (``range``, ``runs`` flat and batched, ``patch``,
    ``unitwire``): counted, timed (1 warm-up, 3 timed), replicas 0 and 63
    byte-identical; K7 held against its plain version on one ``range``
    batch.

The line before the last holds the kernels' numbers as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
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


def range_apply_bound(bound, new_len, C: int):
    """The fused range apply's bound (K2 and K3 compute one function: one
    count) from new_len int32[R]: doc, delpk, ind_d and dd read below each
    row's new length (16 B a column; past it the output is the constant
    2), doc (int32) and cv_intile (int16) written in every column and
    vis_tile in every tile, new_len read; 12 int32 operations a column
    below new_len (depth-field decode 3, four prefix adds, vis clear 2,
    fill 3).  ``bound(bytes, ops)`` gives (ms, "bytes" or "operations")."""
    R = new_len.shape[0]
    live = int(new_len.clamp(min=0, max=C).sum())
    return bound(16 * live + 6 * R * C + 4 * R * (C // 128) + 4 * R,
                 12 * live)


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


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, enqueued while the
    device sleeps (~10 ms), so that a kernel shorter than its wrapper's
    host time is timed back to back and not at the host's pace."""
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
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


#: The serve/mixed/4096 cell (``serve/bench.py run_serve_bench`` defaults,
#: the README's serve quickstart): 4096 documents of the ``mixed`` band
#: table, five capacity classes, batch 64, macro depth 8, 256 chars a slice.
SERVE_CELL = dict(mix="mixed", n_docs=4096, batch=64, macro_k=8,
                  batch_chars=256, classes=(256, 1024, 4096, 8192, 49152),
                  slots=(2048, 512, 128, 32, 16), arrival_span=8, seed=0)


def kernel_row(name, cu, replaces, launches, err, ms, plain_ms, bound,
               library_ms=None) -> dict:
    """One kernel's entry of the ``kernels`` line; ``bound`` is
    (bound ms, "bytes" or "operations")."""
    return {
        "name": name, "route": "cuda",
        "source": "crdt_benches_tpu_torch/csrc/" + cu,
        "replaces": "crdt_benches_tpu/ops/" + replaces, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
    }


def serve_phases(dev, bound) -> list[dict]:
    """The serving fleet's fused macro step on ``SERVE_CELL``.

    ``[k1 rows]``/``[k4]``: one drain in which every dispatch's per-row
    resolve (K1's per-row form) is held against its plain version and the
    round-starts recurrence, and every K4 launch against
    ``serve_macro_plain`` on the same operands; K1's per-row form is timed
    at the dispatch with the most rows, K4 at every (class, tier) the drain
    launched it at, on that pair's first operands (the ``kernels`` line
    holds the largest class's widest tier).  ``[serve]``: the drain
    through ``run_serve_bench`` with every count set to 0 just before and
    read just after, every document verified against the oracle, and
    CUDA-event stage spans; a third drain
    under the profiler gives the device's idle share.  ``bound(bytes,
    ops)`` gives (ms, "bytes" or "operations").  Returns the two kernels'
    rows of the ``kernels`` line."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from crdt_benches_tpu_torch.ops import apply_range_fused as arf
    from crdt_benches_tpu_torch.ops import expand as ex
    from crdt_benches_tpu_torch.ops import resolve as rs
    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops import serve_fused as sf
    from crdt_benches_tpu_torch.ops.apply2 import PackedState
    from crdt_benches_tpu_torch.serve import pool as pool_mod
    from crdt_benches_tpu_torch.serve.bench import run_serve_bench
    from crdt_benches_tpu_torch.serve.scheduler import (
        FleetScheduler,
        prepare_streams,
    )
    from crdt_benches_tpu_torch.serve.workload import build_fleet
    from crdt_benches_tpu_torch.traces.tensorize import INSERT, PAD

    cell = SERVE_CELL
    t0 = time.perf_counter()
    sessions = build_fleet(cell["n_docs"], mix=cell["mix"], seed=cell["seed"],
                           arrival_span=cell["arrival_span"])
    fleet_s = time.perf_counter() - t0

    def fresh_drain():
        """A new pool and scheduler over the fleet's sessions."""
        pool = pool_mod.DocPool(classes=cell["classes"], slots=cell["slots"],
                                device=dev)
        streams = prepare_streams(sessions, pool, batch=cell["batch"],
                                  batch_chars=cell["batch_chars"])
        return pool, FleetScheduler(pool, streams, batch=cell["batch"],
                                    macro_k=cell["macro_k"],
                                    batch_chars=cell["batch_chars"])

    # ---- [k1 rows] and [k4]: every dispatch of one drain checked ----
    err = {"k1rows": 0, "k4": 0}
    seen = {"dispatches": 0, "pad_rows": 0, "pad_tails": 0, "below": set(),
            "classes": set()}
    keep: dict[str, tuple] = {}
    k4_keep: dict[tuple[int, int], tuple] = {}
    k4_launches: dict[tuple[int, int], int] = {}
    pool, sched = fresh_drain()

    def k1_checked(kind, pos, rlen, slot0, v0):
        got = rr.resolve_range_rows(kind, pos, rlen, slot0, v0)
        want = rr.resolve_range_rows_plain(kind, pos, rlen, slot0, v0)
        e = max(max_err((*got[0], *got[1], got[2]),
                        (*want[0], *want[1], want[2])),
                max_err(got[2], sf.round_starts(kind, pos, rlen, v0)))
        if e:
            fail(f"K1 rows != plain at (K, R, B) = {tuple(kind.shape)}: {e}")
        err["k1rows"] = max(err["k1rows"], e)
        pad = kind == PAD
        seen["pad_rows"] += int(pad.all(2).sum())  # (round, row): all PAD
        seen["pad_tails"] += int((pad.any(2) & ~pad.all(2)).sum())
        if "k1" not in keep or kind.numel() > keep["k1"][0].numel():
            keep["k1"] = (kind, pos, rlen, slot0, v0.clone())
        return got

    def k4_checked(sub, tokens, dints, *, inputs=None, out=None):
        want = sf.serve_macro_plain(sub, tokens, dints)  # before the update
        Rt, C = sub.doc.shape
        k4_launches[C, Rt] = k4_launches.get((C, Rt), 0) + 1
        if (C, Rt) not in k4_keep:  # each (class, tier)'s first operands
            k4_keep[C, Rt] = (PackedState(sub.doc.clone(),
                                          sub.length.clone(),
                                          sub.nvis.clone()), tokens, dints)
        got = sf.serve_macro_fused(sub, tokens, dints, inputs=inputs, out=out)
        e = max_err((got.doc, got.length, got.nvis),
                    (want.doc, want.length, want.nvis))
        if e:
            fail(f"K4 != plain at (K, Rt, C) = "
                 f"{(tokens[0].shape[0], Rt, C)}: {e}")
        err["k4"] = max(err["k4"], e)
        seen["dispatches"] += 1
        seen["classes"].add(C)
        if Rt < pool.buckets[C].R:
            seen["below"].add((C, Rt))
        return got

    t0 = time.perf_counter()
    saved = pool_mod.resolve_range_rows, pool_mod.serve_macro_fused
    pool_mod.resolve_range_rows, pool_mod.serve_macro_fused = (k1_checked,
                                                               k4_checked)
    try:
        stats = sched.run()
    finally:
        pool_mod.resolve_range_rows, pool_mod.serve_macro_fused = saved
        pool.close()
    if not sched.done or seen["dispatches"] != stats.dispatches:
        fail(f"checked drain: done {sched.done}, {seen['dispatches']} "
             f"checked of {stats.dispatches} dispatches")
    if seen["classes"] != set(cell["classes"]) or not seen["below"]:
        fail(f"checked drain: classes {sorted(seen['classes'])}, tiers "
             f"below the bucket rows {sorted(seen['below'])}")
    if not (seen["pad_rows"] and seen["pad_tails"]):
        fail(f"checked drain: {seen['pad_rows']} all-PAD rows, "
             f"{seen['pad_tails']} PAD tails")
    print(f"[k1 rows] serve/{cell['mix']}/{cell['n_docs']}: all "
          f"{stats.dispatches} dispatches' per-row resolves equal the plain "
          f"version and the round-starts recurrence ({seen['pad_rows']} "
          f"all-PAD (round, row) pairs, {seen['pad_tails']} PAD tails); "
          f"fleet built in {fleet_s:.1f} s, checked drain "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del pool, sched

    # timings at the kept operands
    args = keep["k1"]
    K1r, R1r, B1r = args[0].shape
    k1_ms = elapsed_ms(lambda: rr.resolve_range_rows(*args), 10)
    k1_plain_ms = elapsed_ms(lambda: rr.resolve_range_rows_plain(*args), 1)
    T1r = rr.effective_token_list_size(B1r, None)
    live = int((args[0] != PAD).sum())
    # ops, v0 read; four (K, R, T) and three (K, R, B) outputs and the
    # starts written; the live tails moved or clamped and the search steps
    # of every row's rounds (the token walk, round by round)
    k1_bound = bound(4 * args[0].numel() * 4 + R1r * 4
                     + K1r * R1r * (4 * T1r + 3 * B1r + 1) * 4,
                     k1_rows_ops(*args))
    # rows of inserts at 0 in every round: each op moves the whole list
    rng = np.random.default_rng(1)
    shape = (K1r, R1r, B1r)
    rlen = rng.integers(1, 9, shape)
    flat = rlen.transpose(1, 0, 2).reshape(R1r, -1)  # each row's ops
    slot0 = (np.cumsum(flat, 1) - flat).reshape(R1r, K1r, B1r)
    wargs = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                             device=dev)
             for a in (np.full(shape, INSERT), np.zeros(shape), rlen,
                       slot0.transpose(1, 0, 2), rng.integers(0, 1000, R1r))]
    k1_checked(*wargs)
    k1w_ms = elapsed_ms(lambda: rr.resolve_range_rows(*wargs), 10)
    # K4 at every (class, tier) the drain launched, on its first operands
    k4_at = {}
    for (C, Rt), (st, tokens, dints) in sorted(k4_keep.items()):
        inputs = sf.serve_round_inputs(tokens, dints, st.length, st.nvis)
        K4, _, T = tokens[0].shape
        sf.serve_macro_fused(st, tokens, dints, inputs=inputs)  # warm-up:
        # a first call may wait on the host (allocation), which the events
        # would count
        ms = elapsed_ms(lambda: sf.serve_macro_fused(st, tokens, dints,
                                                     inputs=inputs), 20)
        k4_at[C, Rt] = (K4, ms, k4_bound(bound, st.length, inputs[5],
                                         dints[0].shape[2], T, C),
                        sf.serve_macro_launch_geometry(Rt, C))
    widest = {C: max(Rt for c, Rt in k4_at if c == C) for C, _ in k4_at}
    top = max(widest)
    st, tokens, dints = k4_keep[top, widest[top]]
    k4_plain_ms = elapsed_ms(lambda: sf.serve_macro_plain(st, tokens, dints),
                             3)
    K4, k4_ms, k4_bnd, _ = k4_at[top, widest[top]]
    per_launch = sum(n * k4_at[key][1] for key, n in k4_launches.items())
    print(f"[k4] serve/{cell['mix']}/{cell['n_docs']}: all "
          f"{stats.dispatches} K4 launches equal serve_macro_plain (max abs "
          f"error {err['k4']}) over classes {sorted(seen['classes'])}, tiers "
          f"below the bucket rows {sorted(seen['below'])}; launches per "
          f"(class, tier) {dict(sorted(k4_launches.items()))}; sum of "
          f"launches x K4 ms {per_launch:.4f} ms; at (K, Rt, C) = "
          f"{(K4, widest[top], top)}: K4 {k4_ms:.4f} ms, plain "
          f"{k4_plain_ms:.3f} ms, bound {k4_bnd[0]:.4f} ms ({k4_bnd[1]})",
          flush=True)
    for (C, Rt), (K, ms, b, geo) in k4_at.items():
        tag = " (widest)" if widest[C] == Rt else ""
        print(f"[k4 class] C={C} Rt={Rt}{tag}: {k4_launches[C, Rt]} "
              f"launches, K={K}, K4 {ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), geometry (n, slice, smem bytes, "
              f"resident, active clusters) {geo}", flush=True)
    print(f"[k1 rows] at (K, R, B, T) = {(K1r, R1r, B1r, T1r)} ({live} live "
          f"ops): {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms, bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}); rows of inserts at 0 in "
          f"every round, equal to the plain version and the round starts: "
          f"{k1w_ms:.4f} ms", flush=True)
    del keep, k4_keep, args, st, tokens, dints

    # ---- [serve]: the timed drain through the bench's entry point ----
    counted = (rr.resolve_range, arf.range_apply, rs.resolve_batch,
               arf.apply_fused2, ex.expand_packed, ex.expand_fill_zero,
               ex.apply_fused_blocked, rr.resolve_range_rows,
               sf.serve_macro_fused)
    plains = (rr.resolve_range_plain, arf.range_apply_plain,
              rs.resolve_batch_plain, arf.apply_fused2_plain,
              ex.expand_packed_plain, ex.expand_fill_zero_plain,
              ex.apply_fused_blocked_plain, rr.resolve_range_rows_plain,
              sf.serve_macro_plain)
    held = {}

    def arm(p):
        p.spans = []
        held["pool"] = p
        torch.cuda.synchronize()
        for f in counted:
            f.launches = 0
        for f in plains:
            f.calls = 0

    rep = run_serve_bench(**cell, device=dev, pool_hook=arm,
                          log=lambda m: print(f"[serve] {m}", flush=True))
    launches = {f.__name__: f.launches for f in counted if f.launches}
    plain_calls = {f.__name__: f.calls for f in plains if f.calls}
    n = rep["dispatches"]
    if launches != {"resolve_range_rows": n, "serve_macro_fused": n} or (
            plain_calls):
        fail(f"serve drain: launches {launches} for {n} dispatches, plain "
             f"calls {plain_calls}")
    if not (rep["verify_ok"] and rep["verify"] == "all"
            and rep["verified_docs"] == cell["n_docs"]
            and set(rep["verified_per_class"]) == set(map(
                str, cell["classes"]))):
        fail(f"serve drain: verify {rep['verify']} ok {rep['verify_ok']} on "
             f"{rep['verified_docs']} docs, per class "
             f"{rep['verified_per_class']}")
    if not (rep["evictions"] and rep["restores"] and rep["promotions"]):
        fail(f"serve drain: evictions {rep['evictions']}, restores "
             f"{rep['restores']}, promotions {rep['promotions']}")
    spans: dict[str, float] = {}
    for name, a, b in held.pop("pool").spans:
        spans[name] = spans.get(name, 0.0) + a.elapsed_time(b)

    # ---- the device's idle share over a whole drain ----
    t0 = time.perf_counter()
    pool, sched = fresh_drain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pstats = sched.run()
    pool.close()
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    wall = rep["wall_time"] * 1e3
    idle = (f"device busy {busy:.2f} of {wall:.2f} ms wall (the timed drain;"
            f" profiled drain {pstats.wall_time * 1e3:.2f} ms), idle "
            f"{100 * (1 - busy / wall):.1f}%" if busy > 0 else
            "idle not measured (no device time)")
    lat = rep["batch_latency"]
    ph = rep["phase_seconds"]
    print(f"[serve] serve/{cell['mix']}/{cell['n_docs']}: "
          f"{rep['patches_per_sec']:.1f} patches/s ({rep['patches']} patches "
          f"in {rep['wall_time']:.4f} s); macro-round latency p50 "
          f"{lat['p50'] * 1e3:.2f} ms, p95 {lat['p95'] * 1e3:.2f}, p99 "
          f"{lat['p99'] * 1e3:.2f}; {rep['rounds']} rounds, "
          f"{rep['device_rounds']} slices, {n} dispatches, "
          f"{rep['range_ops']} range ops ({rep['unit_ops']} unit), pad "
          f"fraction {rep['pad_fraction']:.4f}; evictions "
          f"{rep['evictions']}, restores {rep['restores']}, promotions "
          f"{rep['promotions']}, admissions {rep['admissions']}; verify_ok "
          f"on all {rep['verified_docs']} docs ({rep['verified_per_class']}"
          f", {rep['verify_seconds']:.1f} s); launches {launches}, plain "
          f"calls 0; host phase s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ph.items())
          + "; device span ms (CUDA events, include device waits on the "
          "host): " + ", ".join(f"{k} {v:.2f}" for k, v in spans.items())
          + f"; {idle} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return [
        kernel_row("resolve_range_rows", "resolve_range.cu",
                   "resolve_range_pallas.py:255",
                   launches["resolve_range_rows"], err["k1rows"], k1_ms,
                   k1_plain_ms, k1_bound),
        kernel_row("serve_macro_fused", "serve_macro.cu", "serve_fused.py:685",
                   launches["serve_macro_fused"], err["k4"], k4_ms,
                   k4_plain_ms, k4_bnd),
    ]


#: The K5 worst cases (each also in ``tests/test_torch_resolve_unit.py``):
#: inserts at 0 move the whole live list every op; deletes at 0 grow a run
#: of zero-length tokens at the head and run past the end of a short
#: document; alternating ends land on the FREE sentinel every other op.
K5_WORST = ("ins_at_0", "del_at_0", "alternate")


def k5_worst_cases(dev, tt, late) -> tuple[int, dict[str, float]]:
    """K5 held against ``resolve_batch_plain`` (both on the card, emit_origin
    off and on) on the worst-case batches and ``tt``'s batch ``late`` (v0
    its true length before the batch), at R = 1, 5 and 1024.  Replica 0
    starts at 1000 chars (the trace batch: its true length), then 0, 7, 300,
    then seeded lengths below twice that.  Returns the max abs error (0;
    any other fails) and K5's ms per launch on each batch at R = 1024
    (emit_origin off)."""
    import numpy as np
    import torch

    from crdt_benches_tpu_torch.ops import resolve as rs
    from crdt_benches_tpu_torch.traces.tensorize import DELETE, INSERT

    kind_b, pos_b = tt.batched()[:2]
    B = tt.batch
    step = np.where(kind_b == INSERT, 1, np.where(kind_b == DELETE, -1, 0))
    batches = {"trace": (kind_b[late], pos_b[late],
                         len(tt.init_chars) + int(step[:late].sum()))}
    for name in K5_WORST:
        kind = np.full(B, DELETE if name == "del_at_0" else INSERT, np.int32)
        pos = np.zeros(B, np.int32)
        if name == "alternate":
            pos[1::2] = 10**6  # clamps to the end
        batches[name] = (kind, pos, 1000)
    rng = np.random.default_rng(0)
    worst = 0
    ms = {}
    for name, (kind, pos, v_first) in batches.items():
        for R in (1, 5, 1024):
            v0 = np.concatenate([[v_first, 0, 7, 300],
                                 rng.integers(0, 2 * v_first, max(R - 4, 0))])
            args = [torch.as_tensor(a, dtype=torch.int32, device=dev)
                    for a in (kind, pos, v0[:R])]
            for eo in (False, True):
                e = max_err(tuple(rs.resolve_batch(*args, emit_origin=eo)),
                            tuple(rs.resolve_batch_plain(*args,
                                                         emit_origin=eo)))
                if e:
                    fail(f"K5 != plain on the {name} batch at R={R}, "
                         f"emit_origin {eo}: {e}")
                worst = max(worst, e)
            if R == 1024:
                ms[name] = elapsed_ms(
                    lambda: rs.resolve_batch(*args, emit_origin=False), 10)
    return worst, ms


def k5_ops(kind, pos, v0) -> int:
    """The int32 operations K5 needs on these inputs: per op that acts, its
    live tail moved (two fields for each of the tokens after its token) and
    its search steps (ceil(log2(nused + 1)) compares), from the plain token
    walk of replica 0 on the CPU, times R (every replica of a replay has the
    same v0)."""
    import torch

    from crdt_benches_tpu_torch.ops import resolve as rs

    w = rs.resolve_tokens_plain(kind.cpu(), pos.cpu(), v0[:1].cpu(),
                                emit_origin=False)
    acts = w.t[0] >= 0
    nused, t = w.nused[0][acts], w.t[0][acts]
    steps = torch.ceil(torch.log2(nused.double() + 1)).long()
    return int(2 * (nused - t).sum() + steps.sum()) * v0.shape[0]


def k1_ops(walk) -> int:
    """The int32 operations K1 needs for one token walk
    (``range_token_walk``): per op that acts, three fields of each tail
    token it moves or clamps, and its search steps (ceil(log2(nused + 1))
    compares), summed over the replicas (rows)."""
    import torch

    steps = torch.ceil(torch.log2(walk.nused[:, :-1].double() + 1)).long()
    return int((3 * walk.tail + torch.where(walk.t >= 0, steps, 0)).sum())


def k1_rows_ops(kind, pos, rlen, slot0, v0) -> int:
    """:func:`k1_ops` of K1's per-row form: every row's rounds walked in
    order, each from the visible total the round before left."""
    from crdt_benches_tpu_torch.ops.resolve_range import range_token_walk

    n = 0
    for k in range(kind.shape[0]):
        w = range_token_walk(kind[k], pos[k], rlen[k], v0)
        n += k1_ops(w)
        v0 = w.total.to(v0.dtype)
    return n


#: K1's worst cases (each also in ``tests/test_torch_resolve_range_worst.py``,
#: at B = 32 and 64 there): inserts at 0 move the whole live list every
#: op; deletes at 0 clamp the whole tail and run past the end of a short
#: document; inserts at alternating ends land on the FREE sentinel every
#: other op; scattered inserts split the document into ~B runs that one
#: final delete spans (the longest reduction); a PAD tail (the first
#: quarter of automerge-paper's batch 3); automerge-paper's batch 3.
K1_WORST = ("ins_at_0", "del_at_0", "alternate", "span", "pad_tail", "trace")


def k1_worst_cases(dev, rt, bound) -> tuple[int, dict[str, tuple]]:
    """K1 held against ``resolve_range_plain`` (both on the card, all eight
    outputs) on the worst-case batches at B = ``rt.batch``, at R = 1, 5
    and 1024.  Replica 0 starts at the case's own length (1000, or
    automerge-paper's before batch 3), then 0, 7, 300, then seeded lengths
    below twice that.  Returns the max abs error (0; any other fails) and,
    per case at R = 1024, K1's ms per launch and its bound (``bound(bytes,
    ops)``, ops from the token walk of all 1024 replicas)."""
    import numpy as np
    import torch

    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.traces.tensorize import DELETE, INSERT, PAD

    B = rt.batch
    kind_b, pos_b, rlen_b, slot_b = rt.batched()
    delta = (np.where(kind_b == INSERT, rlen_b, 0).sum(1)
             - np.where(kind_b == DELETE, rlen_b, 0).sum(1))
    v_trace = len(rt.init_chars) + int(delta[:3].sum())
    rng = np.random.default_rng(B)
    batches = {}
    for name in K1_WORST:
        kind = np.full(B, INSERT)
        pos = np.zeros(B)
        rlen = rng.integers(1, 9, B)
        v = 1000
        if name in ("trace", "pad_tail"):
            kind, pos, rlen, slot0 = (np.array(a[3]) for a in
                                      (kind_b, pos_b, rlen_b, slot_b))
            v = v_trace
            if name == "pad_tail":
                for a in (pos, rlen, slot0):
                    a[B // 4:] = 0
                kind[B // 4:] = PAD
        elif name == "del_at_0":
            kind[:] = DELETE
            rlen = rng.integers(1, 5, B)
        elif name == "alternate":
            pos[1::2] = 10**6  # clamps to the end: the sentinel
        elif name == "span":
            pos = rng.integers(1, v, B)
            kind[-1], pos[-1], rlen[-1] = DELETE, 0, 10**6
        if name not in ("trace", "pad_tail"):
            slot0 = v + np.cumsum(rlen) - rlen
        batches[name] = (kind, pos, rlen, slot0, v)
    worst = 0
    out = {}
    for name, (kind, pos, rlen, slot0, v_first) in batches.items():
        for R in (1, 5, 1024):
            v0 = np.concatenate([[v_first, 0, 7, 300],
                                 rng.integers(0, 2 * v_first, max(R - 4, 0))])
            args = [torch.as_tensor(a, dtype=torch.int32, device=dev)
                    for a in (kind, pos, rlen, slot0, v0[:R])]
            got = rr.resolve_range(*args)
            want = rr.resolve_range_plain(*args)
            e = max_err((*got[0], *got[1], got[2]),
                        (*want[0], *want[1], want[2]))
            if e:
                fail(f"K1 != plain on the {name} batch at R={R}: {e}")
            worst = max(worst, e)
            if R == 1024:
                T = got[0][0].shape[1]
                ms = elapsed_ms(lambda: rr.resolve_range(*args), 3)
                ops = k1_ops(rr.range_token_walk(*args[:3], args[4]))
                out[name] = (ms, bound(4 * B * 4 + R * 4
                                       + R * (4 * T + 3 * B + 1) * 4, ops),
                             int(got[2].max()))
    return worst, out


#: K4's worst cases (``crdt_benches_tpu_torch/bench/k4_cases.py``; each also
#: in ``tests/test_torch_serve_macro_worst.py``, at CPU sizes there), as
#: (label, case, K, Rt, B, C): inserts at 0 in
#: every round (every gather source crosses slice boundaries: a round
#: inserts more than a slice holds), one delete spanning the whole row,
#: rows whose final new length is exactly C, one row (a single cluster),
#: C = 1152 (slices of 640 and 512 columns), and two capacities above the
#: shared-memory reach (the device-memory instantiation): 262,144 (slices
#: of 16,384 columns) and 180,352 (slices of 11,392 columns, 89 groups of
#: 128, so each block's scratch is padded to stay 16-byte aligned).
K4_WORST = (
    ("ins_at_0", "ins_at_0", 8, 16, 64, 49152),
    ("span", "span", 8, 16, 64, 49152),
    ("full", "full", 8, 16, 64, 49152),
    ("one_row", "ins_at_0", 8, 1, 64, 49152),
    ("c1152", "ins_at_0", 8, 4, 64, 1152),
    ("beyond_reach", "mixed", 4, 2, 64, 262144),
    ("beyond_reach_89_groups", "mixed", 4, 2, 64, 180352),
)


def k4_bound(bound, length0, newlen, B, T, C):
    """K4's bound from the starting lengths int32[Rt] and the rounds' new
    lengths int32[K, Rt]: each row's columns below its starting length read
    once (the rest of the doc carries no data), every column written once,
    and the K rounds' operands read once (dlo, dhi; gvis, live, cumlen, ta,
    tch, tlen; len_k, nvis_k, newlen); about 16 int32 operations per
    position below each round's new length (visible prefix, three boundary
    prefixes, clear, hole count, source, selects, fill)."""
    K, Rt = newlen.shape
    read = int(length0.clamp(max=C).sum())
    return bound(4 * read + 4 * Rt * C + K * Rt * (2 * B + 6 * T + 3) * 4,
                 16 * int(newlen.clamp(max=C).sum()))


def k4_worst_cases(dev, bound) -> tuple[int, list[tuple]]:
    """K4 held against ``serve_macro_plain`` (both on the card) on
    ``K4_WORST``, resolved by K1's per-row form.  Returns the max abs error
    (0; any other fails) and per case (label, (K, Rt, C), launch geometry,
    final new lengths' min and max, K4 ms, bound)."""
    import torch

    from crdt_benches_tpu_torch.bench.k4_cases import worst_rounds
    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops import serve_fused as sf
    from crdt_benches_tpu_torch.ops.apply2 import PackedState

    worst = 0
    out = []
    for label, name, K, Rt, B, C in K4_WORST:
        doc, length, nvis, *ops = worst_rounds(name, K, Rt, B, C, C + K)
        t = [torch.as_tensor(a, dtype=torch.int32, device=dev)
             for a in (doc, length, nvis, *ops)]
        st = PackedState(*t[:3])
        tokens, dints, _ = rr.resolve_range_rows(*t[3:], st.nvis)
        inputs = sf.serve_round_inputs(tokens, dints, st.length, st.nvis)
        newlen = inputs[5]
        if int(newlen.max()) > C or (name == "full"
                                     and int(newlen[-1].min()) != C):
            fail(f"K4 worst {label}: new lengths {newlen[-1].tolist()} "
                 f"against C = {C}")
        want = sf.serve_macro_plain(st, tokens, dints)
        got = sf.serve_macro_fused(st, tokens, dints, inputs=inputs)
        e = max_err((got.doc, got.length, got.nvis),
                    (want.doc, want.length, want.nvis))
        if e:
            fail(f"K4 != plain on the {label} case at (K, Rt, C) = "
                 f"{(K, Rt, C)}: {e}")
        worst = max(worst, e)
        ms = elapsed_ms(lambda: sf.serve_macro_fused(st, tokens, dints,
                                                     inputs=inputs), 10)
        T = tokens[0].shape[2]
        out.append((label, (K, Rt, C), sf.serve_macro_launch_geometry(Rt, C),
                    (int(newlen[-1].min()), int(newlen[-1].max())), ms,
                    k4_bound(bound, st.length, newlen, B, T, C)))
    return worst, out


def k3_worst_cases(dev, bound) -> tuple[int, list[tuple]]:
    """K3 held against ``range_apply_plain`` (both on the card) on
    ``bench/k3_cases.py``'s ``CHIP_CASES`` (4096-column span), once before
    and once after ten timed launches (each launch a new epoch on the same
    chain state).  Returns the max abs error (0; any other fails) and per
    case (name, R, C, new lengths' min and max, K3 ms, bound)."""
    import torch

    from crdt_benches_tpu_torch.bench.k3_cases import (
        CHIP_CASES,
        DSH,
        k3_case,
    )
    from crdt_benches_tpu_torch.ops import apply_range_fused as arf

    worst = 0
    out = []
    for name, R, C in CHIP_CASES:
        ops = [torch.as_tensor(a, device=dev)
               for a in k3_case(name, R, C, arf.K3_SPAN, seed=R + C)]
        want = arf.range_apply_plain(*ops, DSH)
        e = max_err(arf.range_apply_blocked(*ops, DSH), want)
        ms = queued_ms(lambda: arf.range_apply_blocked(*ops, DSH), 10)
        e = max(e, max_err(arf.range_apply_blocked(*ops, DSH), want))
        if e:
            fail(f"K3 != plain on the {name} case at (R, C) = {(R, C)}: {e}")
        worst = max(worst, e)
        nl = ops[4]
        out.append((name, R, C, (int(nl.min()), int(nl.max())), ms,
                    range_apply_bound(bound, nl, C)))
        del ops, want
    return worst, out


def k2_worst_cases(dev, bound) -> tuple[int, list[tuple]]:
    """K2 held against ``range_apply_plain`` (both on the card) on
    ``bench/k3_cases.py``'s ``K2_CHIP_CASES`` (built to K2's chunk and
    ring), once before and once after ten timed launches, and its count of
    columns sourced left of its x ring against ``range_apply_ring_misses``.
    Returns the max abs error (0; any other fails) and per case (name, R,
    C, new lengths' min and max, columns left of the ring, K2 ms,
    bound)."""
    import torch

    from crdt_benches_tpu_torch.bench.k3_cases import (
        DSH,
        K2_CHIP_CASES,
        k2_case,
    )
    from crdt_benches_tpu_torch.ops import apply_range_fused as arf

    worst = 0
    out = []
    spills = torch.zeros(1, dtype=torch.int64, device=dev)
    for name, R, C in K2_CHIP_CASES:
        ops = [torch.as_tensor(a, device=dev) for a in k2_case(
            name, R, C, arf.K2_CHUNK, arf.K2_RING, seed=R + C)]
        want = arf.range_apply_plain(*ops, DSH)
        spills.zero_()
        e = max_err(arf.range_apply(*ops, DSH, spills=spills), want)
        ms = queued_ms(lambda: arf.range_apply(*ops, DSH), 10)
        e = max(e, max_err(arf.range_apply(*ops, DSH), want))
        if e:
            fail(f"K2 != plain on the {name} case at (R, C) = {(R, C)}: {e}")
        misses = arf.range_apply_ring_misses(ops[2], ops[4])
        if int(spills) != misses:
            fail(f"K2 sourced {int(spills)} columns left of its ring on the "
                 f"{name} case at (R, C) = {(R, C)}, want {misses}")
        worst = max(worst, e)
        nl = ops[4]
        out.append((name, R, C, (int(nl.min()), int(nl.max())), misses, ms,
                    range_apply_bound(bound, nl, C)))
        del ops, want
    return worst, out


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


class Spans:
    """CUDA-event spans around module-level functions: while active, each
    ``(module, name, key)`` target is wrapped so that every call records an
    event before and after it; :meth:`ms` sums each key's device time
    (device waits on the host included).  ``keep`` = {key: call index}
    clones the arguments of that call of that key into ``kept[key]``."""

    def __init__(self, targets, keep=None):
        self.targets = targets
        self.keep = keep or {}
        self.ev: dict[str, list] = {}
        self.kept: dict[str, tuple] = {}

    def __enter__(self):
        import torch

        self.saved = []
        for mod, name, key in self.targets:
            fn = getattr(mod, name)

            def wrap(*a, _fn=fn, _key=key, **k):
                calls = self.ev.setdefault(_key, [])
                if self.keep.get(_key) == len(calls):
                    self.kept[_key] = tuple(
                        x.clone() if isinstance(x, torch.Tensor) else x
                        for x in a)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = _fn(*a, **k)
                e.record()
                calls.append((s, e))
                return out

            setattr(mod, name, wrap)
            self.saved.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def ms(self) -> dict[str, float]:
        import torch

        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.ev.items()}


class Hooks:
    """While active, calls ``at[i]()`` just before the i-th call of
    ``module.name`` (0-based)."""

    def __init__(self, module, name, at):
        self.module, self.name, self.at = module, name, at

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)
        calls = [0]

        def wrap(*a, **k):
            hook = self.at.get(calls[0])
            calls[0] += 1
            if hook is not None:
                hook()
            return fn(*a, **k)

        setattr(self.module, self.name, wrap)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class _WindowEnd(Exception):
    """Ends a profiled run at the end of its window."""


def window_busy_ms(run, module, name, lo, hi) -> float:
    """Device time (ms) of the kernels and copies issued between the
    ``lo``-th and the ``hi``-th call of ``module.name`` in a call of
    ``run()``, which stops there: the profiler records that window only,
    each edge after a device synchronize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])

    def start():
        torch.cuda.synchronize()
        prof.start()

    def stop():
        torch.cuda.synchronize()
        prof.stop()
        raise _WindowEnd

    with Hooks(module, name, {lo: start, hi: stop}):
        try:
            run()
        except _WindowEnd:
            pass
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6


def device_busy_ms(window) -> float:
    """Device time (ms) of the kernels and copies of one call of
    ``window()`` under ``torch.profiler``, device activity only: the host
    ops' events are not needed, and a whole v5 replay or unit merge issues
    millions of them.  The raw kineto events are summed (``prof.events()``
    builds a Python tree of every event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6


def k7_row(tag, ops, launches, err, bound) -> dict:
    """K7's row of the ``kernels`` line on one batch's operands ``ops``
    (doc_predel, combo, cnt_base, new_len) of a new path: K7 (20 launches),
    its plain version (3) and ``torch.gather`` on the precomputed source
    index, timed with CUDA events; the bound reads doc_predel and combo
    below new_len, writes the output everywhere, reads cnt_base and
    new_len; 6 int32 operations a position."""
    import torch

    from crdt_benches_tpu_torch.ops import expand as ex

    doc_predel, combo, cnt_base, new_len = ops
    R, C = doc_predel.shape
    cnt = (torch.cumsum((combo & 1).view(R, C // 128, 128), dim=2,
                        dtype=torch.int32) + cnt_base[:, :, None]).view(R, C)
    src = (torch.arange(C, device=combo.device) - cnt).clamp(0, C - 1).long()
    live = int(new_len.clamp(max=C).sum())
    b = bound(live * 8 + R * C * 4 + R * (C // 128) * 4 + R * 4, R * C * 6)
    row = kernel_row(
        f"apply_fused_blocked ({tag}, (R, C) = ({R}, {C}))",
        "apply_blocked.cu", "expand_pallas.py:276", launches, err,
        elapsed_ms(lambda: ex.apply_fused_blocked(*ops), 20),
        elapsed_ms(lambda: ex.apply_fused_blocked_plain(*ops), 3), b,
        elapsed_ms(lambda: torch.gather(doc_predel, 1, src), 20))
    return row


#: The merge cells (config, engine, replicas) in the order they run: the
#: README's concurrent-merge table at 64 replicas, and BASELINE.json's
#: 1024-replica merge width through the run and flat engines.
MERGE_PATHS = {
    "traces": (("unit", 64), ("range", 64), ("flat", 64), ("range", 1024),
               ("flat", 1024)),
    "adversarial": (("unit", 64), ("flat", 64)),
}


def merge_phases(dev, bound) -> list[dict]:
    """The concurrent merges (``bench/merge.py``): for each config of
    ``MERGE_PATHS``, the untimed generation (every agent's stream replayed
    through K5, counted; K5 held against its plain version on one late
    batch and timed there), then for each (engine, replicas): a run with
    every count set to 0 just before and read just after (K7 once a batch
    on the unit and run merges, none on the flat one, no plain version),
    every replica's digest equal (``MergeCell.run``) and replica
    0 byte-identical to the native treap's merge, timed, with CUDA-event
    spans (arrangement, chain or fragments, query, producer, K7, snapshot,
    delete fold, digest; after a warm-up run except on the unit merge,
    which runs for many seconds); the device's idle share from a run under
    the profiler (on the unit merges over the middle 256 batches, whose
    wall time the timed run takes between two synchronizes: a whole
    profiled unit merge takes minutes).  The engines' documents must be identical to each
    other.  K7 is held against its plain version on one unit-merge batch's
    operands at 64 replicas.  Returns the rows of the ``kernels`` line (K7
    on the merge, K5 in the generation)."""
    import torch

    from crdt_benches_tpu_torch.bench import merge as bm
    from crdt_benches_tpu_torch.engine import downstream as dsm
    from crdt_benches_tpu_torch.engine import downstream_flat as dfl
    from crdt_benches_tpu_torch.engine import downstream_range as drg
    from crdt_benches_tpu_torch.engine import merge as mg
    from crdt_benches_tpu_torch.engine import merge_range as mrg
    from crdt_benches_tpu_torch.engine import replay as urep
    from crdt_benches_tpu_torch.ops import apply_range_fused as arf
    from crdt_benches_tpu_torch.ops import expand as ex
    from crdt_benches_tpu_torch.ops import resolve as rs

    kernels = (rs.resolve_batch, ex.apply_fused_blocked, arf.apply_fused2)
    plains = (rs.resolve_batch_plain, ex.apply_fused_blocked_plain,
              arf.apply_fused2_plain)

    def zero():
        for f in kernels:
            f.launches = 0
        for f in plains:
            f.calls = 0

    def counts():
        return ({f.__name__: f.launches for f in kernels},
                sum(f.calls for f in plains))

    spans_of = {
        "unit": [(mg, "_rank_sorted_segments", "arrangement"),
                 (mg, "_sort_dedup", "arrangement"),
                 (mg, "_chain_structure", "chain"),
                 (dsm, "resolve_targets5", "query"),
                 (dsm, "batch5_operands", "producer"),
                 (dsm, "apply_fused_blocked", "K7"),
                 (mg, "snap_rebuild", "snapshot"),
                 (bm, "doc_digest_packed", "digest")],
        "range": [(mrg, "_arrange_runs", "arrangement"),
                  (mrg, "_run_batch_fragments", "fragments"),
                  (mrg, "_apply_range_update_batch5", "batch apply"),
                  (drg, "query", "query"),
                  (drg, "apply_fused_blocked", "K7"),
                  (mrg, "snap_rebuild", "snapshot"),
                  (mrg, "delete_fold", "delete fold"),
                  (bm, "doc_digest_packed", "digest")],
        "flat": [(dfl, "flatten_unit_log", "flat merge"),
                 (dfl, "flatten_runs", "flatten"),
                 (dfl, "_link_and_rank", "link and rank"),
                 (mrg, "delete_fold", "delete fold"),
                 (bm, "doc_digest_packed", "digest")],
    }
    rows = []
    k7_err = k5_err = 0
    for config, paths in MERGE_PATHS.items():
        merge_ops = 10_000_000 if config == "adversarial" else 1_000_000
        t0 = time.perf_counter()
        zero()
        gen = Spans([(urep, "resolve_batch", "K5")], keep={"K5": 40})
        with gen:
            sim = bm.merge_sim(config, merge_ops, batch=256, device=dev)
        la, pc = counts()
        want_k5 = sum(max(1, -(-len(lg) // 256)) for lg in sim.agent_logs)
        if la["resolve_batch"] != want_k5 or pc or la["apply_fused2"]:
            fail(f"merge/{config} generation: launches {la} for {want_k5} "
                 f"batches, plain calls {pc}")
        gen_s = time.perf_counter() - t0
        if config == "traces":
            args = gen.kept["K5"][:3]
            e = max_err(tuple(rs.resolve_batch(*args, emit_origin=True)),
                        tuple(rs.resolve_batch_plain(*args,
                                                     emit_origin=True)))
            if e:
                fail(f"K5 != plain on merge/traces generation batch 40: {e}")
            k5_err = max(k5_err, e)
            out = rs.resolve_batch(*args, emit_origin=True)
            nbytes = (sum(a.numel() * a.element_size() for a in args)
                      + sum(t.numel() * t.element_size() for t in out))
            rows.append(kernel_row(
                "resolve_batch (merge/traces generation, emit_origin on, "
                f"(R, B) = (1, {args[0].shape[0]}))", "resolve_unit.cu",
                "resolve_pallas.py:282", la["resolve_batch"], k5_err,
                elapsed_ms(lambda: rs.resolve_batch(*args, emit_origin=True),
                           10),
                elapsed_ms(lambda: rs.resolve_batch_plain(
                    *args, emit_origin=True), 1),
                bound(nbytes, k5_ops(*args))))
        print(f"[merge gen] merge/{config}: {sim.n_agents} agents, "
              f"{len(sim.log)} unique ops, capacity {sim.capacity}, "
              f"generated untimed in {gen_s:.1f} s (K5 "
              f"{la['resolve_batch']} launches, plain calls 0)", flush=True)
        docs = {}
        want = None
        for engine, R in paths:
            t0 = time.perf_counter()
            cell = bm.MergeCell(sim, config, engine, n_replicas=R,
                                merge_ops=merge_ops)
            if engine == "unit":
                padded = len(sim._padded(cell.delivered,
                                         sim.batch * cell.epoch))
                quantum = sim.batch * cell.epoch
                keep = min(padded, -(-len(sim.log) // quantum) * quantum)
                want_k7 = keep // sim.batch
            elif engine == "range":
                want_k7 = len(cell.runs.lamport) // cell.runs.batch
            else:
                want_k7 = 0
            set_s = time.perf_counter() - t0
            if engine != "unit":
                cell.run()  # warm-up (a unit merge runs for many seconds)
            sp = Spans(spans_of[engine],
                       keep={"K7": want_k7 - 2} if (
                           engine == "unit" and config == "traces") else None)
            # the unit merge's idle-share window: the middle 256 batches,
            # timed here between two synchronizes
            lo = max(0, want_k7 // 2 - 128)
            hi = min(want_k7 - 1, lo + 256)
            edges = {}

            def edge(k):
                def mark():
                    torch.cuda.synchronize()
                    edges[k] = time.perf_counter()
                return mark

            hooks = (Hooks(mg, "_chain_structure",
                           {lo: edge("lo"), hi: edge("hi")})
                     if engine == "unit" else contextlib.nullcontext())
            torch.cuda.synchronize()
            zero()
            with sp, hooks:
                t1 = time.perf_counter()
                st = cell.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            la, pc = counts()
            if (la["apply_fused_blocked"] != want_k7 or pc
                    or la["resolve_batch"] or la["apply_fused2"]):
                fail(f"merge/{config} {engine} R={R}: launches {la}, want "
                     f"K7 {want_k7}; plain calls {pc}")
            if want is None:  # one native merge of the config's log
                want = mg.native_merge_content(sim, cell.delivered)
            docs[engine] = sim.decode(st, R - 1)
            if (sim.decode(st, 0) != want or docs[engine] != want
                    or not bool((st.nvis == len(want)).all())):
                fail(f"merge/{config} {engine} R={R}: replica 0 or {R - 1} "
                     "differs from the native treap's merge")
            del st
            span = sp.ms()
            if engine == "range":
                span["producer"] = (span.pop("batch apply") - span["query"]
                                    - span["K7"])
            elif engine == "flat":
                span["dedup"] = span.pop("flat merge", 0.0) - span["flatten"]
                span["materialize"] = span.pop("flatten") - span[
                    "link and rank"]
            if engine == "unit":
                busy = window_busy_ms(cell.run, mg, "_chain_structure", lo,
                                      hi)
                span_wall = (edges["hi"] - edges["lo"]) * 1e3
                over = f" over batches {lo}-{hi - 1} of {want_k7}"
            else:
                busy, span_wall, over = device_busy_ms(cell.run), wall * 1e3, (
                    "")
            eps = cell.elements * R / wall
            print(f"[merge] merge/{config} {engine} R={R}: "
                  f"{cell.elements} delivered ops, set-up {set_s:.1f} s; "
                  f"timed merge {wall:.4f} s = {eps:.1f} elements/s; every "
                  f"replica's digest equal, replicas 0 and {R - 1} "
                  f"byte-identical to the native treap; launches {la}, plain "
                  "calls 0; spans ms (CUDA events, include device waits on "
                  "the host): " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in span.items())
                  + f"; device busy {busy:.2f} of {span_wall:.2f} ms wall"
                  f"{over}, idle {100 * (1 - busy / span_wall):.1f}% "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if "K7" in sp.kept:
                ops = sp.kept["K7"]
                e = max_err(ex.apply_fused_blocked(*ops),
                            ex.apply_fused_blocked_plain(*ops))
                if e:
                    fail(f"K7 != plain on merge/traces unit batch "
                         f"{want_k7 - 2}: {e}")
                k7_err = max(k7_err, e)
                rows.append(k7_row(f"merge/traces unit R={R}, batch "
                                   f"{want_k7 - 2}", ops,
                                   la["apply_fused_blocked"], k7_err, bound))
                del ops
            del cell
        if len(set(docs.values())) != 1:
            fail(f"merge/{config}: the engines' documents differ")
        print(f"[merge] merge/{config}: {', '.join(docs)} give one "
              f"document ({len(docs['unit'])} chars)", flush=True)
        del sim
    return rows


#: The run-granular downstream columns: (label, engine, schedule).
DOWN_RUN_COLUMNS = (("range", "range", None), ("runs", "runs", "flat"),
                    ("runs batched", "runs", "batched"),
                    ("patch", "patch", "flat"),
                    ("unitwire", "unitwire", "flat"))


def run_down_phases(dev, bound) -> list[dict]:
    """The five range and run downstream columns on automerge-paper at 64
    replicas (``--group downstream --engine range|runs|patch|unitwire``):
    each prepared untimed (K5 counted in the run columns' generation), one
    warm-up and three timed ``replay_once`` with every count set to 0 just
    before and read just after (K7 once a batch on ``range`` and the
    batched schedule, none on the flat one, no plain version), replicas 0
    and 63 decoded against the end content.  K7 is held against its plain
    version on one ``range`` batch's operands.  Returns K7's row."""
    import torch

    from crdt_benches_tpu_torch.engine import downstream_range as drg
    from crdt_benches_tpu_torch.engine.merge_range import (
        TorchRunDownstreamBackend,
    )
    from crdt_benches_tpu_torch.ops import apply_range_fused as arf
    from crdt_benches_tpu_torch.ops import expand as ex
    from crdt_benches_tpu_torch.ops import resolve as rs
    from crdt_benches_tpu_torch.traces import load_testing_data

    trace = load_testing_data("automerge-paper")
    end = trace.end_content
    kernels = (rs.resolve_batch, ex.apply_fused_blocked, arf.apply_fused2)
    plains = (rs.resolve_batch_plain, ex.apply_fused_blocked_plain,
              arf.apply_fused2_plain)
    rows = []
    for label, engine, schedule in DOWN_RUN_COLUMNS:
        if engine == "range":
            bk = drg.TorchRangeDownstreamBackend(n_replicas=64, device=dev)
        else:
            bk = TorchRunDownstreamBackend(
                n_replicas=64, device=dev, schedule=schedule,
                granularity={"runs": "coalesced", "patch": "patch",
                             "unitwire": "unit"}[engine])
        for f in (*kernels, *plains):
            setattr(f, "launches" if f in kernels else "calls", 0)
        t0 = time.perf_counter()
        bk.prepare(trace)
        gen_s = time.perf_counter() - t0
        gen_k5 = rs.resolve_batch.launches
        eng = bk.engine
        if engine == "range":
            nb, want_gen, want_k7 = eng.n_batches, 0, eng.n_batches
            run = eng.run
        else:
            nb = len(eng.lamport) // eng.batch
            want_gen = -(-len(eng.sim.log) // 512)
            want_k7 = nb if schedule == "batched" else 0
            run = bk._merge
        if gen_k5 != want_gen or any(f.calls for f in plains):
            fail(f"[down {label}] generation: K5 {gen_k5}, want {want_gen}")
        bk.replay_once()  # warm-up
        secs = []
        for _ in range(3):
            for f in (*kernels, *plains):
                setattr(f, "launches" if f in kernels else "calls", 0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n = bk.replay_once()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            la = {f.__name__: f.launches for f in kernels}
            if (la["apply_fused_blocked"] != want_k7 or la["resolve_batch"]
                    or la["apply_fused2"] or any(f.calls for f in plains)):
                fail(f"[down {label}] launches {la}, want K7 {want_k7}")
        if n != len(end):
            fail(f"[down {label}] length {n} != {len(end)}")
        sp = Spans([(drg, "apply_fused_blocked", "K7")],
                   keep={"K7": nb - 2} if engine == "range" else None)
        with sp:
            st = run()
        for r in (0, 63):
            if eng.decode(st, r) != end:
                fail(f"[down {label}] replica {r} differs from the end "
                     "content")
        del st
        med = sorted(secs)[1]
        wire = bk.batch_ops if engine == "range" else eng.batch
        print(f"[down {label}] automerge-paper R=64, "
              f"{'schedule ' + schedule + ', ' if schedule else ''}"
              f"{bk.NAME}: {nb} batches ({wire} wire ops a batch), generation {gen_s:.1f} s (K5 {gen_k5}); replay s "
              f"{[round(s, 4) for s in secs]}, median {med:.4f} s, "
              f"{len(trace) * 64 / med:.1f} elements/s; replicas 0 and 63 "
              f"byte-identical; launches per replay {la}, plain calls 0",
              flush=True)
        if "K7" in sp.kept:
            ops = sp.kept["K7"]
            e = max_err(ex.apply_fused_blocked(*ops),
                        ex.apply_fused_blocked_plain(*ops))
            if e:
                fail(f"K7 != plain on the range downstream batch {nb - 2}: "
                     f"{e}")
            rows.append(k7_row(f"range downstream R=64, batch {nb - 2}", ops,
                               want_k7, e, bound))
            del ops
        del bk, eng
    return rows


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
    from crdt_benches_tpu_torch.bench.k3_cases import DSH as K3_DSH
    from crdt_benches_tpu_torch.bench.k3_cases import k3_case
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

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S, nops / int32_ops_per_s
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

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
    err = {"k1": 0, "k2": 0, "k3": 0}
    times: dict[str, float] = {}
    kept: dict[tuple[int, int], tuple] = {}

    def walk(tname, R, C, check_k1, check_k2, until=None, time_at=None,
             tag="", stages=None, apply=None, kname="k2", also=(),
             keep_at=None, on_ops=None):
        """Replay ``tname`` batch by batch through K1 and ``apply`` (K2
        unless given), holding them against the plain versions where
        asked — ``apply`` under ``err[kname]``, and each (kernel, key) of
        ``also`` on the same operands — timing K1, ``apply`` and the plain
        version at batch ``time_at`` (under
        ``kname`` + ``tag``), keeping the apply's operands of batch
        ``keep_at`` in ``kept[(R, C)]``, passing every batch's apply
        operands to ``on_ops`` and, when ``stages`` is a dict, summing each
        stage's device time over all batches into it."""
        apply = apply or arf.range_apply
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
                times[f"k1{tag}_ops"] = k1_ops(rr.range_token_walk(
                    *args[:3], args[4]))
                times[f"k1{tag}_plain_ms"] = elapsed_ms(
                    lambda: rr.resolve_range_plain(*args), 1)
                times[f"k1{tag}_shape"] = (R, kb.shape[1], tok[0].shape[1])
            delpk, ind_d, dd, new_len, nvis, dsh = arf.range_apply_operands(
                st, tok, dints)
            if stages is not None:
                ev[-1][2].record()
            ops = (st.doc, delpk, ind_d, dd, new_len, dsh)
            out = apply(*ops)
            if stages is not None:
                ev[-1][3].record()
            if check_k2(i):
                want = arf.range_apply_plain(*ops)
                for fn, key in ((apply, kname), *also):
                    e = max_err(out if fn is apply else fn(*ops), want)
                    if e:
                        fail(f"{fn.__name__} != plain on {tname} batch {i} "
                             f"at R={R}, C={C}: {e}")
                    err[key] = max(err[key], e)
            if i == keep_at:
                kept[R, C] = ops
            if on_ops is not None:
                on_ops(ops)
            if i == time_at:
                times[f"{kname}{tag}_ms"] = queued_ms(lambda: apply(*ops),
                                                      10)
                times[f"{kname}{tag}_plain_ms"] = elapsed_ms(
                    lambda: arf.range_apply_plain(*ops), 3)
                times[f"{kname}{tag}_shape"] = (R, C)
                times[f"{kname}{tag}_newlen"] = new_len.clone()
            st = PackedState4(doc=out[0], cv_intile=out[1],
                              vis_tile=out[2], length=new_len, nvis=nvis)
        torch.cuda.synchronize()
        for e in ev:
            for k, (a, b) in enumerate(zip(e, e[1:])):
                key = ("k1", "producer", "apply")[k]
                stages[key] = stages.get(key, 0.0) + a.elapsed_time(b)
        return st

    every = lambda i: True
    never = lambda i: False
    # every other batch: where a plain version on every batch would set a
    # phase's time (each main path runs its kernels on every batch)
    half = lambda i: i % 2 == 0
    cap_am = 183_296
    t0 = time.perf_counter()
    k3_also = ((arf.range_apply_blocked, "k3"),)
    walk("sveltecomponent", 8, 94_208, half, half, also=k3_also)
    walk("automerge-paper", 8, cap_am, half, half, also=k3_also)
    print(f"[k1+k2 R=8] sveltecomponent and automerge-paper, every other "
          f"batch equal (K3 too) ({time.perf_counter() - t0:.1f} s)",
          flush=True)

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
         lambda i: i == 3, until=3, time_at=3, also=k3_also, keep_at=3)
    print(f"[k1 R=1024] automerge-paper batch 3 equal; kernel "
          f"{times['k1_ms']:.4f} ms, plain {times['k1_plain_ms']:.1f} ms "
          f"at (R, B, T) = {times['k1_shape']}; {times['k1_ops']} int32 "
          "operations (live tails moved or clamped, search steps)",
          flush=True)
    b2 = range_apply_bound(bound, times["k2_newlen"], cap_am)
    ops3 = kept[1024, cap_am]
    k2_spills = torch.zeros(1, dtype=torch.int64, device=dev)
    arf.range_apply(*ops3, spills=k2_spills)
    k2_misses = arf.range_apply_ring_misses(ops3[2], ops3[4])
    if int(k2_spills) != k2_misses:
        fail(f"K2 sourced {int(k2_spills)} columns left of its ring at "
             f"batch 3, want {k2_misses}")
    k2_info = arf.range_apply_info()
    print(f"[k2 R=1024] automerge-paper batch 3 equal (K3 too); kernel "
          f"{times['k2_ms']:.4f} ms, plain {times['k2_plain_ms']:.3f} ms, "
          f"bound {b2[0]:.4f} ms ({b2[1]}) at (R, C) = "
          f"{times['k2_shape']}; {k2_info['regs']} registers a thread, "
          f"{k2_info['smem_bytes']} B shared memory a block, "
          f"{k2_info['blocks_per_sm']} blocks an SM; {k2_misses} of "
          f"{int(ops3[4].clamp(min=0, max=cap_am).sum())} live columns "
          f"sourced left of the {arf.K2_RING}-column x ring "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del ops3

    t0 = time.perf_counter()
    e, k1w = k1_worst_cases(dev, rts["automerge-paper"], bound)
    err["k1"] = max(err["k1"], e)
    print("[k1 worst] " + ", ".join(K1_WORST) + " at B = 1536: all eight "
          "outputs equal at R = 1, 5 and 1024; at R = 1024, K1 ms, bound ms "
          "(by; from the token walk) and max nused: " + "; ".join(
              f"{k} {ms:.4f}, {b[0]:.4f} ({b[1]}), {n}"
              for k, (ms, b, n) in k1w.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    e, k4w = k4_worst_cases(dev, bound)
    print("[k4 worst] K4 equals serve_macro_plain (max abs error "
          f"{e}) on every case; (K, Rt, C), geometry (n, slice, smem bytes, "
          "resident, active clusters), final new lengths, K4 ms, bound ms "
          "(by): " + "; ".join(
              f"{lb} {shape}, {geo}, {nl[0]}-{nl[1]}, {ms:.4f}, "
              f"{b[0]:.4f} ({b[1]})" for lb, shape, geo, nl, ms, b in k4w)
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- K3: the long-document walk through the dispatch ----
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    if not arf.range_apply_takes_blocked(2, 1 << 20, sms):
        fail("the dispatch does not take K3 at R=2, C=2^20")
    n2, n3 = arf.range_apply.launches, arf.range_apply_blocked.launches
    st = walk("automerge-paper", 2, 1 << 20, never, every, time_at=6,
              tag="_long", apply=arf.range_apply_dispatch, kname="k3",
              keep_at=3)
    nb_am = rts["automerge-paper"].n_batches
    if (arf.range_apply.launches != n2
            or arf.range_apply_blocked.launches - n3 < nb_am):
        fail("the long-document walk did not go through K3 at every batch")
    if st.nvis.tolist() != [len(traces["automerge-paper"].end_content)] * 2:
        fail(f"long-capacity replay lengths {st.nvis.tolist()}")
    b3 = range_apply_bound(bound, times["k3_long_newlen"], 1 << 20)
    print(f"[k3] automerge-paper at R=2, C={1 << 20} through the dispatch: "
          f"every batch K3, equal to plain; batch 6 (new lengths "
          f"{times['k3_long_newlen'].tolist()}) kernel "
          f"{times['k3_long_ms']:.4f} ms, plain "
          f"{times['k3_long_plain_ms']:.3f} ms, bound {b3[0]:.4f} ms "
          f"({b3[1]}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    del st

    t0 = time.perf_counter()
    e, k3w = k3_worst_cases(dev, bound)
    err["k3"] = max(err["k3"], e)
    print("[k3 worst] K3 equals range_apply_plain (max abs error "
          f"{e}) on every case; (R, C), new lengths, K3 ms, bound ms (by): "
          + "; ".join(f"{n} ({R}, {C}), {nl[0]}-{nl[1]}, {ms:.4f}, "
                      f"{b[0]:.4f} ({b[1]})" for n, R, C, nl, ms, b in k3w)
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    e, k2w = k2_worst_cases(dev, bound)
    err["k2"] = max(err["k2"], e)
    print("[k2 worst] K2 equals range_apply_plain (max abs error "
          f"{e}) on every case, and its count of columns sourced left of "
          "its ring equals range_apply_ring_misses; (R, C), new lengths, "
          "columns left of the ring, K2 ms, bound ms (by): "
          + "; ".join(f"{n} ({R}, {C}), {nl[0]}-{nl[1]}, {m}, {ms:.4f}, "
                      f"{b[0]:.4f} ({b[1]})"
                      for n, R, C, nl, m, ms, b in k2w)
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- K3 against K2 on automerge-paper batch 3's operands ----
    t0 = time.perf_counter()
    full = kept.pop((1024, cap_am))
    rows = lambda o, R: tuple(x[:R].contiguous() for x in o[:5]) + (o[5],)
    shapes = [(f"R={R} C={cap_am}", rows(full, R))
              for R in (1, 2, 8, 64, 80, 84, 88, 96, 128, 256, 1024)]
    shapes.append((f"R=4096 C={cap_am} (batch 3's rows four times)",
                   tuple(x.repeat(4, 1) if x.dim() == 2 else x.repeat(4)
                         for x in full[:5]) + (full[5],)))
    shapes.append((f"R=2 C={1 << 20}", kept.pop((2, 1 << 20))))
    full = tuple(torch.as_tensor(a, device=dev) for a in k3_case(
        "full", 1024, cap_am, arf.K3_SPAN, seed=1024)) + (K3_DSH,)
    shapes += [(f"R={R} C={cap_am} full rows (bench/k3_cases.py)",
                rows(full, R)) for R in (64, 80, 84, 88, 96, 128, 256,
                                         1024)]
    del full
    for label, ops in shapes:
        R, C = ops[0].shape
        want = arf.range_apply_plain(*ops)
        for fn, key in ((arf.range_apply, "k2"),
                        (arf.range_apply_blocked, "k3")):
            e = max_err(fn(*ops), want)
            if e:
                fail(f"{fn.__name__} != plain at {label}: {e}")
            err[key] = max(err[key], e)
        k2a = queued_ms(lambda: arf.range_apply(*ops), 10)
        k3a = queued_ms(lambda: arf.range_apply_blocked(*ops), 10)
        k3b = queued_ms(lambda: arf.range_apply_blocked(*ops), 10)
        k2b = queued_ms(lambda: arf.range_apply(*ops), 10)
        k2ms, k3ms = (k2a + k2b) / 2, (k3a + k3b) / 2
        b = range_apply_bound(bound, ops[4], C)
        takes = arf.range_apply_takes_blocked(R, C, sms)
        print(f"[k3 vs k2] {label}: K2 {k2ms:.4f} ms ({k2a:.4f}, "
              f"{k2b:.4f}), K3 {k3ms:.4f} ms ({k3a:.4f}, {k3b:.4f}), bound "
              f"{b[0]:.4f} ms ({b[1]}); faster here: "
              f"{'K3' if k3ms < k2ms else 'K2'}; the dispatch takes "
              f"{'K3' if takes else 'K2'}", flush=True)
    del shapes, ops, want
    # the whole replay's apply, both kernels on every batch's operands
    for R in (128, 1024):
        per: dict[str, list[float]] = {"k2": [], "k3": []}

        def time_both(ops, per=per):
            k2a = queued_ms(lambda: arf.range_apply(*ops), 10)
            k3a = queued_ms(lambda: arf.range_apply_blocked(*ops), 10)
            k3b = queued_ms(lambda: arf.range_apply_blocked(*ops), 10)
            k2b = queued_ms(lambda: arf.range_apply(*ops), 10)
            per["k2"].append((k2a + k2b) / 2)
            per["k3"].append((k3a + k3b) / 2)

        walk("automerge-paper", R, cap_am, never, never, on_ops=time_both)
        print(f"[k3 vs k2] automerge-paper R={R} C={cap_am}, every batch: "
              + "; ".join(f"K{k[1]} {sum(v):.4f} ms ("
                          + ", ".join(f"{x:.4f}" for x in v) + ")"
                          for k, v in per.items()), flush=True)
    cross = next((R for R in range(1, 1 << 16)
                  if not arf.range_apply_takes_blocked(R, cap_am, sms)),
                 None)
    print(f"[k3 vs k2] on this card's {sms} SMs the dispatch takes K3 "
          + (f"below R = {cross}" if cross else "at every R below 65,536")
          + f" at C = {cap_am} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    stages: dict[str, float] = {}
    t0 = time.perf_counter()
    walk("automerge-paper", 1024, cap_am, never, never, stages=stages,
         apply=arf.range_apply_dispatch)
    wall = (time.perf_counter() - t0) * 1e3
    print("[stages] automerge-paper R=1024, all batches, span ms (CUDA "
          "events, include device waits on the host): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.2f} of {wall:.2f} ms wall "
          "(wall includes state init; apply as dispatched)", flush=True)

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
    k_main, k_off = arf.range_apply, arf.range_apply_blocked
    if arf.range_apply_takes_blocked(1024, bk.engine.capacity, sms):
        k_main, k_off = k_off, k_main
    launches = main_path(
        bk, trace, (rr.resolve_range, k_main),
        (rr.resolve_range_plain, arf.range_apply_plain), "main",
        absent=(k_off,),
    )
    del bk

    # ---- the reference's own configuration: one replica, through K3 ----
    bk = TorchReplayBackend(n_replicas=1, batch=1536, layout="range",
                            device=dev)
    bk.prepare(trace)
    r1_launches = main_path(
        bk, trace, (rr.resolve_range, arf.range_apply_blocked),
        (rr.resolve_range_plain, arf.range_apply_plain), "range R=1",
        absent=(arf.range_apply,),
    )
    del bk
    stages = {}
    t0 = time.perf_counter()
    walk("automerge-paper", 1, cap_am, never, never, stages=stages,
         apply=arf.range_apply_dispatch)
    wall = (time.perf_counter() - t0) * 1e3
    print("[range R=1 stages] automerge-paper R=1, all batches, span ms "
          "(CUDA events, include device waits on the host): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.2f} of {wall:.2f} ms wall "
          "(wall includes state init; apply as dispatched: K3)", flush=True)

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
            times["k5_ops"] = k5_ops(*args)
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

    def checked_all(n, tag, want=None):
        want = am.n_batches if want is None else want
        if n != want:
            fail(f"{tag}: {n} batches checked, want {want}")

    # K5 on sveltecomponent's batches, emit_origin off (as the replay
    # launches it) and on; the plain versions run in CPU worker processes
    t0 = time.perf_counter()
    sv = ReplayEngine(utts["sveltecomponent"], n_replicas=8, device=dev)
    k5_log = []
    unit_walk("v4", sv.init_state(), engine_chunks(sv), k5_log=k5_log)
    if len(k5_log) != sv.tt.n_batches:
        fail(f"K5 logged {len(k5_log)} batches, want {sv.tt.n_batches}")
    # every fourth batch (the plain version on the CPU sets this phase's
    # time; every batch of the main paths runs K5 at full width)
    k5_log = k5_log[::4]
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
            fail(f"K5 != plain on sveltecomponent batch {4 * (i // 2)}, "
                 f"emit_origin {tasks[i][3]}: {e}")
        uerr["k5"] = max(uerr["k5"], e)
    print(f"[k5 R=8] sveltecomponent: every fourth batch ({len(k5_log)} "
          f"of {sv.tt.n_batches}) equal with "
          f"emit_origin off and on (plain on {workers} CPU workers; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    del k5_log, tasks, got, wants
    t0 = time.perf_counter()
    e, wms = k5_worst_cases(dev, am, late)
    uerr["k5"] = max(uerr["k5"], e)
    print(f"[k5 worst] {', '.join(K5_WORST)} and automerge-paper batch "
          f"{late}: equal at R = 1, 5 and 1024 with emit_origin off and on; "
          "K5 ms at R = 1024: " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in wms.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

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
        long_chunks, half)
    lengths_ok(st, "K6 long")
    checked_all(n, "K6 long", (am.n_batches + 1) // 2)
    print(f"[k6] automerge-paper, all {am.n_batches} batches equal with "
          f"emit_cv on and off at R=8 (C up to {e8.stage_caps[-1]}), every "
          f"other batch at R=2, C={long_c} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
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
            long_chunks, half)
        lengths_ok(st, f"{key} long")
        checked_all(n, f"{key} long", (am.n_batches + 1) // 2)
        del st
        print(f"[{key}] automerge-paper: the {eng} replay at R=64: all "
              f"lengths {end_am}, replicas 0 and 63 byte-identical, launches "
              f"{la}, plain calls 0, {secs:.3f} s; all {am.n_batches} batches"
              f" equal at R=64, C={e64.capacity}, every other at R=2, "
              f"C={long_c}; "
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
    R5, B5, T5 = times["k5_shape"]
    # kind/pos and v0 read; five int32 and one bool output per (R, B)
    k5_bytes = 2 * B5 * 4 + R5 * 4 + R5 * B5 * (5 * 4 + 1)
    k5_bound = bound(k5_bytes, times["k5_ops"])
    print(f"[k5+k6 R=1024] automerge-paper batch {late} equal (K5 with "
          f"emit_origin off and on, K6 with emit_cv on and off); "
          f"K5 {times['k5_ms']:.4f} ms, plain {times['k5_plain_ms']:.1f} ms "
          f"at (R, B, T) = {times['k5_shape']}, bound {k5_bound[0]:.5f} ms "
          f"by {k5_bound[1]} ({k5_bytes} bytes; {times['k5_ops']} int32 "
          f"operations: live tails moved and search steps); "
          f"K6 {times['k6_ms']:.3f} ms, "
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
        anchor/delete query, the producer, the no-cv apply K7, the
        snapshot rebuild after each epoch.  Where
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
                out = ex.apply_fused_blocked(*ops)
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
        its kernels and copies (:func:`device_busy_ms`, one profiled call)
        over its wall time (host clock, one unprofiled call, after a
        warm-up), None when the profiler shows no device time; with the
        wall and busy ms and the seconds the measurement took."""
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        busy = device_busy_ms(window)
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

    # flagship.downstream() at its defaults: R = 1024, B = 1536, K7
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
    if (fl["apply_fused_blocked"] != feng.n_batches or fl["apply_fused2"]
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
          f"lengths {end_am}, replicas 0 and {fR - 1} byte-identical; K7 "
          f"{fl['apply_fused_blocked']} launches, K6 0, plain calls "
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
    k1_nops = times["k1_ops"]  # live tails moved or clamped, searches
    R2, C2 = times["k2_shape"]
    R3, C3 = times["k3_long_shape"]
    k2_b = range_apply_bound(bound, times["k2_newlen"], C2)
    k3_b = range_apply_bound(bound, times["k3_long_newlen"], C3)
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

    src = "crdt_benches_tpu_torch/csrc/"
    tpu = "crdt_benches_tpu/ops/"
    rows = []
    for key, kname, cu, rep, n_launch, e, nbytes, nops, lib in (
        ("k1", "resolve_range", "resolve_range.cu",
         "resolve_range_pallas.py:255", launches["resolve_range"],
         err["k1"], k1_bytes, k1_nops, None),
        ("k2", "range_apply", "range_apply.cu",
         "apply_range_fused.py:388", launches.get("range_apply", 0),
         err["k2"], k2_b, None, None),
        ("k3_long", "range_apply_blocked", "range_apply_blocked.cu",
         "apply_range_fused.py:591", r1_launches["range_apply_blocked"],
         err["k3"], k3_b, None, None),
        ("k5", "resolve_batch", "resolve_unit.cu",
         "resolve_pallas.py:282", unit_launches["resolve_batch"],
         uerr["k5"], k5_bytes, times["k5_ops"], None),
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
        b_ms, b_by = nbytes if nops is None else bound(nbytes, nops)
        rows.append({
            "name": kname, "route": "cuda", "source": src + cu,
            "replaces": tpu + rep, "launches": n_launch, "max_abs_err": e,
            "ms": times[f"{key}_ms"], "plain_ms": times[f"{key}_plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        })
    # ---- the serving fleet: K1's per-row form and K4 ----
    rows += serve_phases(dev, bound)
    # ---- the concurrent merges and the run-granular downstream ----
    t0 = time.perf_counter()
    rows += merge_phases(dev, bound)
    print(f"[merge] all merge phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    rows += run_down_phases(dev, bound)
    print(f"[down runs] all run-granular downstream phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
