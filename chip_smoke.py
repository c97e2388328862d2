"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

    python chip_smoke.py

``--tier-only`` runs the device, build and three-tier phases alone,
``--chaos-only`` the device, build and fault phases alone,
``--stream-only`` the device, build and streaming phases alone,
``--telemetry-only`` the device, build and telemetry phases alone,
``--repl-only`` the device, build and replication phases alone,
``--reshard-only`` the device, build and reshard phases alone,
``--open-only`` the device, build and open-loop phases alone,
``--mesh-only`` the device, build and serve mesh phases alone (after a
plain drain of serve/mixed/4096 for the reference rate),
``--tooling-only`` the device, build and runtime tooling phases alone
(after the same reference drain),
``--tier-full`` drains the README's 65,536-document tier cell in ``[serve
tier]`` in place of its cut, ``--stream-full`` the README's
262,144-document streamed cell in ``[serve stream]`` (and adds eager rows
to ``[serve construction]``), and ``--ab-pairs N`` sets the pairs of
``[serve tier ab]``, and ``--open-full`` drains the README's uncut
4,096-document open-loop cell in ``[serve open]``.

Phases (one line each; any failure exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile ``crdt_benches_tpu_torch/csrc/*.cu`` (nvcc, sm_90a);
3. K1 (range resolver) against ``resolve_range_plain``: every sixteenth batch
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
   ``emit_origin`` off and on, on every thirty-second batch of sveltecomponent at
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
    producer's operands of every batch at 8 replicas and of every other
    batch (and batch 1013) at 2 replicas with a capacity of 1,310,720;
11. the downstream path at its recorded width:
    ``TorchDownstreamBackend(64 replicas, batch 256)`` (v5) applies the
    updates (1 warm-up, 3 timed): every length the trace's, replicas 0
    and 63 byte-identical, K7 once per batch, no K6 and no plain version;
    one more replay times each stage (query, producer, apply, snapshot
    rebuild), and the profiler gives the device's idle share over batches
    128-255 of a ``replay_once``; K7, K6 without cv, K7's plain version and
    ``torch.gather`` are timed at batch 1013;
12. ``flagship.downstream`` at its defaults (1024 replicas, batch 1536),
    one replay: byte-identical at replicas 0 and 1023, K7 once per batch
    and no K6; its stages, idle share over one whole ``run`` and the same
    four timings at a late batch (K7 against K6 without cv);
13. the v3 (K8 once per batch) and v1 downstream engines at 64 replicas,
    byte-identical at replicas 0 and 63;
14. the serving fleet on serve/mixed/4096 (4096 documents, five capacity
    classes, batch 64, macro depth 8): one drain in which every dispatch's
    per-row resolve (K1's per-row form) equals its plain version (the
    dispatches' rows stacked after the drain) and the round-starts
    recurrence, and every K4 (serve macro apply) launch
    equals ``serve_macro_plain`` — every class, tiers below the bucket
    rows, all-PAD rows and PAD tails — with K1's per-row form timed, K4
    timed at every (class, tier) the drain launched it at (its launches,
    bound and cluster geometry beside each), and K1's per-row form on rows
    of inserts at 0 in every round; then the
    timed drain through ``run_serve_bench``: both kernels once per
    dispatch, no plain version, evictions, restores and promotions, every
    document byte-identical to the oracle, its host phases and device
    spans; and the device's idle share over a third, profiled drain;
    then ``[serve scan]``: the same cell drained through the ``scan``
    serve kernel (``engine/merge_fleet.py``: K1's per-row form and K4,
    each at K = 1, once a round), every document byte-identical to the
    oracle, every bucket state, row map and doc record and every counter
    equal to the fused drain's, its latency and spans; K1's per-row form
    and K4 at K = 1 held against their plain versions and timed on round 0
    of the fused drain's kept dispatches; then ``[serve mesh]``: the
    README's serve command (``--family serve --serve-docs 4096 --serve-mix
    mixed --serve-mesh 8 --serve-macro 8``, every document verified)
    in-process through the port's runner, 8 mesh shards on the one card:
    exit 0, JAX's artifact keys, every document byte-identical to the
    oracle, K1's per-row form and K4 once a shard of every dispatch, both
    held against their plain versions and timed on shard 0's kept
    operands, the rate against ``[serve]``'s, the drain's seconds and the
    device's idle share over a profiled drain, each line with the
    placement and the card's name and power limit; then three-tier
    residency:
    ``[serve tier]``, the README's tiered cell cut to 1,024 documents
    (``TIER_CELL``: zipf arrivals over 32 rounds, ``--serve-tiers
    hot=16,warm=256``, 64 times over-subscribed) through
    ``run_serve_bench``: both kernels once per dispatch, no plain version,
    every document byte-identical to the oracle, its rate, latency, host
    phases (``prefetch`` included), ``residency`` block, limbo pulls and
    spans; a second drain of the same fleet, profiled over a window of
    its dispatches, gives the device's idle share against the timed
    drain's wall time there and keeps each (class, rows) pair's first
    operands; ``[serve tier kernels]``: those operands through one K1
    per-row launch and one K4 launch, equal to their plain versions,
    timed; ``[serve tier ab]``: serve/mixed/4096 cut to 1,024 docs at
    slots (96, 24, 6, 2, 2), pairs of drains with a warm tier of 512 and
    the prefetcher and
    with the same tiers and no prefetcher, in turns, then one through the
    two-tier pool: each side's median, least and largest rate and moves,
    the first pair's and the two-tier drain's spool writes, reads and hit
    rate; every tiered drain equal to the first in every fact no thread
    timing moves, the first pair and the two-tier drain byte-identical to
    the oracle (one pair by default); then the journal
    (``journal_phases``): ``[serve journal]``, the cell cut to 2,048 docs
    and journaled (a barrier every 4 rounds, every 4th full) with the
    measured recovery leg, both kernels once per dispatch of the drain
    and the resumed drain, the barrier counts and times, the WAL, the
    rate, ``recover_ms``, ``redo_ms``, a seeded sample of 512 docs
    verified after each; ``[serve crash]``, the whole cell's drain stopped
    after round 10 and recovered from a delta at chain depth 2 with a redo tail;
    ``[serve tier crash]``, 1,024 docs at the ``[serve tier ab]`` tiers
    crashed the same way, warm members restored; each crash-recovered
    fleet byte-identical to the oracle in every document; ``[journal
    rebuild]``, 8 documents of each class rebuilt by ``rebuild_doc`` from
    their snapshot base and from nothing (K1's per-row form and K4 once
    per slice, each byte-identical), and both kernels held against their
    plain versions and timed on one slice of the largest class at R = 1;
    then the faults (``chaos_phases``): ``[serve chaos]``, the README's
    chaos run (serve/mixed/512 at slots (256, 64, 16, 8, 4), the journal,
    queue cap 512, seeded spool damage, a device loss, a queue overflow,
    duplicate batches and a stall) drained clean and under the plan, K1's
    per-row form and K4 once per dispatch and once per slice of every
    rebuild (spool heals, the lost class's residents), every event fired
    and recovered, no quarantine, every document byte-identical to the
    oracle, the repairs' ms by kind, the chaos and clean rates; both
    kernels held against their plain versions and timed on a slice of the
    first rebuild; ``[serve chaos durability]``, the longhaul crash recipe
    (a torn GC pass, a damaged delta, a crash after round 4) recovered
    down the chain; ``[serve tier chaos]``, warm-tier pressure and a
    dropped prefetch batch on a tiered fleet; then streaming construction
    (``stream_phases``): ``[serve stream]``, the README's streamed cell
    (serve/tier/mixed/262144, zipf arrivals over 32 rounds, a fleet 256
    times its device rows, a warm tier 16 times them) cut to 1,024 docs at
    ``hot=16,warm=256``, built lazily through ``run_serve_bench(stream=
    True)`` with the prefetcher: K1's per-row form and K4 once per
    dispatch, every doc materialized, some by the prefetch thread, none
    left in genesis, no construct error, every document byte-identical to
    the oracle, its ``construction`` and ``residency`` blocks; ``[serve
    stream kernels]``: the drain's kept operands through one K1 per-row
    launch and one K4 launch, equal to their plain versions, timed;
    ``[serve stream evict]``, the recipe at 1,024 docs with record
    eviction: records reclaimed, the records left within the hot rows, the
    warm budget and one GC batch, each surviving document byte-identical;
    ``[serve construction]``, the construction probe's table on the card
    (stream rows at 4,096 and 1,048,576 docs, an eager row at
    4,096), a fresh process a cell, in a thread started with the script
    (its processes overlap the earlier phases), no error row; ``[serve stream
    trickle]``, 512 docs arriving one a macro-round, where the prefetch
    thread must build streams; and the telemetry (``telemetry_phases``,
    run right after ``[serve]``): ``[serve telemetry]``, the cell drained
    again with the tracer, the time-series, the status server (scraped
    mid-run by a thread), request tracing, an SLO and the flight recorder
    armed, equal to ``[serve]``'s drain in every counter and launch, every
    document verified, the trace valid, the windows covering every round,
    the flight recorder quiet; ``[serve telemetry kernels]`` its kept
    operands through K1's per-row form and K4 against their plain
    versions; ``[serve telemetry chaos]``, a stall against a 250 ms
    watchdog (fired and cleared, a valid flight dump); ``[serve soak]``,
    5 s of re-seeded drains under the anomaly detectors, none firing;
    then multi-writer replication (``repl_phases``): ``[serve repl]``, the
    README's serve/repl/mixed/512x4 uncut (2,048 replica rows), K1's
    per-row form and K4 once per dispatch, every replica byte-identical to
    the oracle and the RA-linearizability axioms on 16 sampled histories,
    remote:local 3.00; ``[serve repl kernels]`` its kept operands against
    the plain versions; ``[serve repl chaos]``, the JAX smoke's replicated
    chaos leg (a partition and a reorder fired and recovered, every replica
    converged), then the same fleet journaled, stopped after 8 macro-rounds
    and resumed by ``recover_replicated_fleet`` to convergence; and live
    resharding (``reshard_phases``): ``[serve reshard]``, the README's
    acceptance recipe (serve/mixed/4096 on 8 logical shards,
    ``shrink:8:6@16,batch=64`` under ``reshard_crash@16``, the journal):
    the crash resumed, shards 6 and 7 retired, the partition clean, the
    seeded sample byte-identical, its ``reshard`` block and its rate over
    ``[serve]``'s; ``[serve reshard kernels]`` its kept operands (tiers
    gathered over the shards) against the plain versions; ``[serve reshard
    crash]``, the JAX smoke's reshard leg with ``/metrics`` read at each of
    the coordinator's publishes (``serve_reshard_active 1`` with
    ``pending_docs`` counting down) and a scraping thread, then the fleet
    stopped mid-move and rolled forward by ``recover_fleet``, every
    document byte-identical; and the live ingest front
    (``open_phases``): ``[serve open]``, the README's open-loop cell
    (serve/open/mixed/4096 at 16,384 ops a round, poisson, two tenants,
    EDF) cut to 1,024 docs with the rate and the tenants scaled by the
    same factor: ops over a loopback TCP front while the fleet drains, K1's
    per-row form and K4 once per dispatch, every document verified, every
    planned op delivered, no client error, every document scored against
    its deadline, the device's idle share over the drain; ``[serve open
    kernels]`` its kept operands against the plain versions; ``[serve open
    sweep]``, the offered-load sweep on 256 docs with burst arrivals at
    512, 1,024 and 2,048 ops a round (the README cell's rate scaled to
    that fleet, half and twice it), every probe verified, the knee;
    ``[serve open chaos]``, the JAX smoke's open chaos leg (``conn_churn``
    and ``tenant_flood`` fired and recovered, connections dropped and
    resumed), then its journal recovered by ``recover_fleet`` to the
    drained fleet, doc for doc; and the runtime tooling
    (``tooling_phases``, run right after ``[serve mesh]``): ``[serve
    profile]``, the README's serve command through the runner with
    ``--serve-profile 4``, K1's per-row kernel and K4 named in the
    profile's top ops with their calls equal to their launches in the
    captured rounds; ``[serve sanitized]``, serve/mixed/4096 with every
    sanitizer armed and the native sync tripwire on (no undeclared sync),
    every document verified, the blocks and the syncs fence by fence;
    ``[edgecheck]``, the full dtype-edge harness (the 65,408- and
    65,664-column ladders that bracket the uint16 ids, both serve kernels,
    byte-exact), K1's per-row form and K4 held against their plain
    versions on the big ladders' kept operands and timed (``[edgecheck
    kernels]``); ``[lifecheck]`` and ``[fscrash]`` at ``small``: zero
    leaks, every crash point recovered;
15. the concurrent merges (``bench/merge.py``, ``--group merge``):
    merge/traces (rustcode and seph-blog1, 1,348,053 delivered ops)
    through the unit, run and flat engines at 64 replicas and through the
    run and flat engines at 1024, merge/adversarial (cut to about
    625,000 delivered ops, each unique op ~16 times, shuffled) through
    the unit and flat
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
    batch;
17. ``[runner]``: the bench matrix runner (``bench/runner.py``) in-process
    with ``--verify --samples 1 --warmup 0`` (2 samples until the journal
    phases needed the time, a warm-up until the open-loop phases did): the
    upstream columns
    ``cpp-rope``, ``cpp-crdt``, ``cpp-cola``, ``torch`` (1024 replicas,
    batch 1536) and ``torch-unit`` (batch 256) on sveltecomponent (and
    automerge-paper until the streaming phases came), the downstream
    columns ``cpp-crdt``, ``torch``,
    ``torch-range`` and ``torch-runs`` at 64 replicas on sveltecomponent,
    and the merge columns ``cpp-crdt`` and ``torch-flat`` on merge/traces
    at 64 replicas; every cell verified, none skipped, each call's kernels
    counted; the records written to ``bench_results/torch_chip.json``;
18. ``[range v3]``: automerge-paper through the v3 range engine at 1024
    replicas, batch 1536 (K1, then K4 at K = 1 on its scratch path): K1
    and K4 once per batch, every length the trace's, replicas 0 and 1023
    byte-identical; K4 against ``serve_apply_round_plain`` on every other
    batch at 8 replicas; K4 timed at batch 3 beside its plain round and
    bound;
19. ``[entry]``: ``entry()``'s step on the card against the same step on
    the CPU, all five outputs equal;
20. ``[mesh]``: the replica mesh (``parallel/mesh.py``) over NCCL at world
    size 1 (this machine's one card): ``sharded_downstream_runs`` on
    automerge-paper at 64 subscribers (digests equal to the run
    downstream backend's), ``sharded_merge_runs`` on merge/traces (replica
    0 equal to the native treap's merge), ``sharded_replay_and_digest`` on
    the whole automerge-paper trace at B = 256, R = 64 (digests equal to
    the one-replica v1 engine's), and the v1 and packed sharded merges of
    the dry run's streams, each counted (K7, K7, K5, both), timed and its
    converged flag read from the collective; K5 and K7 held against their
    plain versions on one batch of these paths;
21. ``[dryrun]``: ``entry.dryrun_multichip(1)`` on the card and on the
    CPU (gloo), the same three digests.

serve/mixed/4096's sessions are built once and shared by every drain of
that fleet, and each of their oracle texts computed once
(:func:`share_serve_fleet`).

The line before the last holds the kernels' numbers as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
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
#: Seconds after which every thread's stack goes to standard error, so a
#: run stopped at its 1200 s limit shows where it was.
STACKS_AFTER_S = 1140


class Timeline:
    """Standard output that copies the tag of every line it finishes to
    standard error with the seconds since the start, so that the end of
    standard error says which phase a stopped run had reached."""

    def __init__(self, out, t_start: float):
        self.out, self.t_start, self.part = out, t_start, ""

    def write(self, text: str) -> int:
        self.part += text
        *lines, self.part = self.part.split("\n")
        for ln in lines:
            sys.stderr.write(f"[+{time.perf_counter() - self.t_start:.1f} s] "
                             f"{ln[:72]}\n")
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()
        sys.stderr.flush()

    def __getattr__(self, name):
        return getattr(self.out, name)


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


#: Rows a stacked call of K1's per-row plain version takes at most
#: (:func:`k1_rows_plain_stacked`).
K1_PLAIN_ROWS = 16384


def k1_rows_plain_stacked(items) -> list[tuple]:
    """``resolve_range_rows_plain`` on every item (kind, pos, rlen, slot0,
    v0; int32[K, R, B] and int32[R], one B) in few calls: the items' rows
    stacked (those of one B), up to ``K1_PLAIN_ROWS`` a call, their rounds
    padded to the
    largest K with PAD rounds, and each item's (K, R) slice of the outputs
    returned in its order.  The plain version walks each row on its own,
    in a Python loop over the rounds and the live op columns of all rows,
    so a stacked call costs about what one item's does."""
    import torch

    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.traces.tensorize import PAD

    out: list[tuple] = []
    start = 0
    while start < len(items):
        stop, rows = start, 0
        while stop < len(items) and (stop == start or (
                rows + items[stop][4].shape[0] <= K1_PLAIN_ROWS
                and items[stop][0].shape[2] == items[start][0].shape[2])):
            rows += items[stop][4].shape[0]
            stop += 1
        group = items[start:stop]
        K = max(it[0].shape[0] for it in group)

        def stacked(j, fill):
            return torch.cat([torch.cat([it[j], torch.full(
                (K - it[j].shape[0], *it[j].shape[1:]), fill,
                dtype=it[j].dtype, device=it[j].device)]) for it in group],
                1).contiguous()

        want = rr.resolve_range_rows_plain(
            stacked(0, PAD), stacked(1, 0), stacked(2, 0), stacked(3, 0),
            torch.cat([it[4] for it in group]))
        r0 = 0
        for it in group:
            k, r = it[0].shape[:2]
            cut = lambda t: t[:k, r0:r0 + r]
            out.append((tuple(map(cut, want[0])), tuple(map(cut, want[1])),
                        cut(want[2])))
            r0 += r
        start = stop
    return out


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


def profiled_drain_busy_ms(pool, sched) -> tuple[float, float]:
    """Device milliseconds and wall milliseconds of one drain
    (``sched.run()``) under the profiler (CUDA activity only), for a
    device's idle share against a timed drain run without the profiler
    (and the profiler's cost beside it); closes the pool."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stats = sched.run()
    pool.close()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6, \
        stats.wall_time * 1e3


def serve_phases(dev, bound) -> tuple[float, list[dict], tuple]:
    """The serving fleet's fused macro step on ``SERVE_CELL``.

    ``[k1 rows]``/``[k4]``: one drain in which every dispatch's per-row
    resolve (K1's per-row form) is held against its plain version (kept,
    and checked after the drain with the dispatches' rows stacked) and the
    round-starts recurrence, and every K4 launch against
    ``serve_macro_plain`` on the same operands; K1's per-row form is timed
    at the dispatch with the most rows, K4 at every (class, tier) the drain
    launched it at, on that pair's first operands (the ``kernels`` line
    holds the largest class's widest tier).  ``[serve]``: the drain
    through ``run_serve_bench`` with every count set to 0 just before and
    read just after, every document verified against the oracle, and
    CUDA-event stage spans; a third drain under the profiler gives the
    device's idle share (:func:`profiled_drain_busy_ms`).  ``bound(bytes,
    ops)`` gives (ms, "bytes" or "operations").  Returns the timed drain's
    patches/s, the kernels' rows of the ``kernels`` line and the timed
    drain's report and launches (``[serve telemetry]``'s reference)."""
    import numpy as np
    import torch

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

    pending: list[tuple] = []  # (operands, K1's outputs) for the plain

    def k1_checked(kind, pos, rlen, slot0, v0):
        got = rr.resolve_range_rows(kind, pos, rlen, slot0, v0)
        e = max_err(got[2], sf.round_starts(kind, pos, rlen, v0))
        if e:
            fail(f"K1 rows' starts != the recurrence at (K, R, B) = "
                 f"{tuple(kind.shape)}: {e}")
        pending.append((tuple(t.clone() for t in (kind, pos, rlen, slot0,
                                                  v0)),
                        tuple(t.clone() for t in (*got[0], *got[1], got[2]))))
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

    def k1_plain_check():
        """Every pending per-row resolve against the plain version, the
        dispatches' rows stacked (:func:`k1_rows_plain_stacked`)."""
        wants = k1_rows_plain_stacked([a for a, _ in pending])
        for (a, got), want in zip(pending, wants):
            e = max_err(got, (*want[0], *want[1], want[2]))
            if e:
                fail(f"K1 rows != plain at (K, R, B) = {tuple(a[0].shape)}: "
                     f"{e}")
            err["k1rows"] = max(err["k1rows"], e)
        pending.clear()

    k1_plain_check()
    if seen["classes"] != set(cell["classes"]) or not seen["below"]:
        fail(f"checked drain: classes {sorted(seen['classes'])}, tiers "
             f"below the bucket rows {sorted(seen['below'])}")
    if not (seen["pad_rows"] and seen["pad_tails"]):
        fail(f"checked drain: {seen['pad_rows']} all-PAD rows, "
             f"{seen['pad_tails']} PAD tails")
    print(f"[k1 rows] serve/{cell['mix']}/{cell['n_docs']}: all "
          f"{stats.dispatches} dispatches' per-row resolves equal the plain "
          f"version (their rows stacked, {K1_PLAIN_ROWS} a call) and the "
          f"round-starts recurrence ({seen['pad_rows']} "
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
    k1_plain_check()
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
    # the scan kernel's shapes (K = 1): round 0 of each kept dispatch, the
    # round the scan kernel applies first there; timed queued behind a
    # device sleep (a launch at K = 1 can be shorter than its wrapper's
    # host time) and back to back, at the host's pace
    scan_at = {}
    for (C, Rt), (st, tokens, dints) in sorted(k4_keep.items()):
        t1 = tuple(t[:1] for t in tokens)
        d1 = tuple(d[:1] for d in dints)
        e = max_err(tuple(sf.serve_macro_fused(st, t1, d1)),
                    tuple(sf.serve_macro_plain(st, t1, d1)))
        if e:
            fail(f"K4 at K = 1 != plain at (Rt, C) = {(Rt, C)}: {e}")
        err["k4_k1"] = max(err.get("k4_k1", 0), e)
        inputs = sf.serve_round_inputs(t1, d1, st.length, st.nvis)
        launch = lambda: sf.serve_macro_fused(st, t1, d1, inputs=inputs)
        scan_at[C, Rt] = (queued_ms(launch, 20),
                          k4_bound(bound, st.length, inputs[5],
                                   d1[0].shape[2], t1[0].shape[2], C),
                          elapsed_ms(launch, 20))
        if (C, Rt) == (top, widest[top]):
            scan_at["k4_plain_ms"] = elapsed_ms(
                lambda: sf.serve_macro_plain(st, t1, d1), 3)
    a1 = tuple(x[:1] for x in args[:4]) + (args[4],)
    got1 = rr.resolve_range_rows(*a1)
    want1 = rr.resolve_range_rows_plain(*a1)
    err["k1rows_k1"] = max_err((*got1[0], *got1[1], got1[2]),
                               (*want1[0], *want1[1], want1[2]))
    if err["k1rows_k1"]:
        fail(f"K1 rows at K = 1 != plain: {err['k1rows_k1']}")
    scan_at["k1"] = (
        queued_ms(lambda: rr.resolve_range_rows(*a1), 10),
        elapsed_ms(lambda: rr.resolve_range_rows_plain(*a1), 1),
        bound(4 * a1[0].numel() * 4 + R1r * 4
              + R1r * (4 * T1r + 3 * B1r + 1) * 4, k1_rows_ops(*a1)),
        elapsed_ms(lambda: rr.resolve_range_rows(*a1), 10))
    del keep, k4_keep, args, st, tokens, dints

    # ---- [serve]: the timed drain through the bench's entry point ----
    held = {}

    def arm(p):
        p.spans = []
        held["pool"] = p
        torch.cuda.synchronize()
        zero_all_counts()

    rep = run_serve_bench(**cell, device=dev, pool_hook=arm,
                          log=lambda m: print(f"[serve] {m}", flush=True))
    launches = read_all_counts("serve drain")
    n = rep["dispatches"]
    if launches != {"resolve_range_rows": n, "serve_macro_fused": n}:
        fail(f"serve drain: launches {launches} for {n} dispatches")
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
    fpool = held.pop("pool")  # closed: its spool is gone, its rows stay
    fused_final = ({c: (list(b.rows), b.state.doc.cpu(), b.state.length.cpu(),
                        b.state.nvis.cpu()) for c, b in fpool.buckets.items()},
                   {d: (r.cls, r.row, r.length, r.last_sched, r.spool is None)
                    for d, r in fpool.docs.items()})
    for name, a, b in fpool.spans:
        spans[name] = spans.get(name, 0.0) + a.elapsed_time(b)

    # ---- the device's idle share over a whole drain ----
    t0 = time.perf_counter()
    busy, pwall = profiled_drain_busy_ms(*fresh_drain())
    wall = rep["wall_time"] * 1e3
    idle = (f"device busy {busy:.2f} of {wall:.2f} ms wall (the timed drain;"
            f" busy from a third drain under the profiler, {pwall:.2f} ms "
            f"wall), idle {100 * (1 - busy / wall):.1f}%" if busy > 0 else
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
    del fpool

    # ---- [serve scan]: the same cell through the scan serve kernel ----
    t0 = time.perf_counter()
    held = {}
    srep = run_serve_bench(**cell, serve_kernel="scan", device=dev,
                           pool_hook=arm,
                           log=lambda m: print(f"[serve scan] {m}",
                                               flush=True))
    scan_launches = read_all_counts("serve scan drain")
    spool = held.pop("pool")
    n_sl = srep["device_rounds"]
    if scan_launches != {"resolve_range_rows": n_sl,
                         "serve_macro_fused": n_sl}:
        fail(f"serve scan drain: launches {scan_launches} for {n_sl} "
             "rounds")
    if not (srep["verify_ok"] and srep["verify"] == "all"
            and srep["verified_docs"] == cell["n_docs"]):
        fail(f"serve scan drain: verify {srep['verify']} ok "
             f"{srep['verify_ok']} on {srep['verified_docs']} docs")
    same = ("patches", "rounds", "device_rounds", "dispatches", "range_ops",
            "unit_ops", "coalesce_ratio", "pad_fraction", "evictions",
            "restores", "promotions", "admissions")
    differ = [k for k in same if srep[k] != rep[k]]
    buckets, records = fused_final
    for c, b in spool.buckets.items():
        rows_f, doc, length, nvis = buckets[c]
        if not (b.rows == rows_f and torch.equal(b.state.doc.cpu(), doc)
                and torch.equal(b.state.length.cpu(), length)
                and torch.equal(b.state.nvis.cpu(), nvis)):
            differ.append(f"bucket c{c}")
    if {d: (r.cls, r.row, r.length, r.last_sched, r.spool is None)
            for d, r in spool.docs.items()} != records:
        differ.append("doc records")
    if differ:
        fail(f"serve scan drain differs from the fused drain in {differ}")
    sspans: dict[str, float] = {}
    for name, a, b in spool.spans:
        sspans[name] = sspans.get(name, 0.0) + a.elapsed_time(b)
    del spool
    slat = srep["batch_latency"]
    sk1_ms, sk1_plain, sk1_b, sk1_paced = scan_at["k1"]
    sk4_ms, sk4_b, _ = scan_at[top, widest[top]]
    print(f"[serve scan] serve/{cell['mix']}/{cell['n_docs']} through the "
          f"scan kernel: {srep['patches_per_sec']:.1f} patches/s "
          f"({srep['wall_time']:.4f} s; fused {rep['patches_per_sec']:.1f} "
          f"in this run); macro-round latency p50 {slat['p50'] * 1e3:.2f} "
          f"ms, p95 {slat['p95'] * 1e3:.2f}, p99 {slat['p99'] * 1e3:.2f}; "
          f"every doc byte-identical to the oracle, every bucket state, row "
          f"map and doc record equal to the fused drain's, and "
          f"{', '.join(same)} equal; launches {scan_launches} ({n_sl} "
          f"rounds), plain calls 0; device span ms (CUDA events, include "
          f"device waits on the host): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sspans.items())
          + f"; host phase s: " + ", ".join(
              f"{k} {v:.4f}" for k, v in srep["phase_seconds"].items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[serve scan] at K = 1, ms queued behind a device sleep (back "
          f"to back, at the host's pace): K1 per-row at (R, B, T) = "
          f"{(R1r, B1r, T1r)} {sk1_ms:.4f} ({sk1_paced:.4f}) ms, plain "
          f"{sk1_plain:.1f} ms, bound {sk1_b[0]:.4f} ms ({sk1_b[1]}); K4 by "
          "(class, tier) "
          + ", ".join(f"C={C} Rt={Rt}: {v[0]:.4f} ({v[2]:.4f}) ms, bound "
                      f"{v[1][0]:.4f}"
                      for (C, Rt), v in sorted(
                          (k, v) for k, v in scan_at.items()
                          if isinstance(k, tuple)))
          + f"; K4 plain at (Rt, C) = {(widest[top], top)}: "
          f"{scan_at['k4_plain_ms']:.3f} ms", flush=True)
    return rep["patches_per_sec"], [
        kernel_row("resolve_range_rows", "resolve_range.cu",
                   "resolve_range_pallas.py:255",
                   launches["resolve_range_rows"], err["k1rows"], k1_ms,
                   k1_plain_ms, k1_bound),
        kernel_row("serve_macro_fused", "serve_macro.cu", "serve_fused.py:685",
                   launches["serve_macro_fused"], err["k4"], k4_ms,
                   k4_plain_ms, k4_bnd),
        kernel_row(f"resolve_range_rows (scan, K = 1, (R, B) = "
                   f"({R1r}, {B1r}))", "resolve_range.cu",
                   "resolve_range_pallas.py:255",
                   scan_launches["resolve_range_rows"], err["k1rows_k1"],
                   sk1_ms, sk1_plain, sk1_b),
        kernel_row(f"serve_macro_fused (scan, K = 1, (Rt, C) = "
                   f"({widest[top]}, {top}))", "serve_macro.cu",
                   "serve_fused.py:685", scan_launches["serve_macro_fused"],
                   err["k4_k1"], sk4_ms, scan_at["k4_plain_ms"], sk4_b),
    ], (rep, launches)


#: The README's serve command (``README.md``, JAX's runner docstring)
#: through the port's runner, as ``[serve mesh]`` runs it: serve/mixed/4096
#: over 8 mesh shards, every document verified by the runner
#: (``--serve-verify-sample 0``; the runner's default draws a sample of 8).
MESH_ARGV = ("--family", "serve", "--serve-docs", "4096", "--serve-mix",
             "mixed", "--serve-mesh", "8", "--serve-macro", "8",
             "--serve-verify-sample", "0")
MESH_SHARDS = 8
#: The ``extra`` keys of JAX's serve artifact (``crdt_benches_tpu/serve/
#: bench.py``), which the runner's artifact must carry.
JAX_SERVE_KEYS = frozenset((
    "family", "fleet_docs", "batch", "batch_chars", "macro_k", "kernel",
    "op_dtypes", "classes", "slots", "mesh_devices", "rounds",
    "device_rounds", "range_ops", "unit_ops", "coalesce_ratio",
    "pad_fraction", "patches_per_sec", "batch_latency", "compile_time",
    "compile_rounds", "barrier_time", "barrier_rounds", "steady_rounds",
    "occupancy_mean", "queue_depth_mean", "queue_depth_max", "evictions",
    "restores", "promotions", "admissions", "queue_cap", "overflow_policy",
    "shed_ops", "deferred_ops", "overflow_events", "backpressure_rounds",
    "dup_ops_dropped", "stall_rounds", "quarantines", "recoveries",
    "ops_replayed", "replay_dispatches", "mttr_rounds", "degraded_rounds",
    "lossy_docs", "journal", "longhaul", "construction", "residency",
    "recovery", "reshard", "ingest", "knee", "faults", "boundary_syncs",
    "thread_crossings", "fs_ops", "lifecycle", "ranges", "metrics",
    "doc_drain_latency", "profile", "timeseries", "anomalies", "reqtrace",
    "slo", "flight", "status_port", "trace", "docs_per_class",
    "verified_docs", "verify_ok"))


def share_serve_fleet() -> dict:
    """Build ``SERVE_CELL``'s 4,096 sessions once for every drain of that
    fleet (``[serve]``, ``[serve scan]``, ``[serve mesh]``, the telemetry,
    journal and reshard drains): ``build_fleet`` memoized on the cell's
    arguments, and the oracle's text of each of their traces computed once
    (a drain reads sessions and never writes them: its state lives in its
    streams and pool).  Every other fleet is built as before.  Returns the
    counts of builds and oracle replays saved."""
    from crdt_benches_tpu_torch.serve import bench as bench_mod
    from crdt_benches_tpu_torch.serve import workload

    build, replay = workload.build_fleet, bench_mod.replay_trace
    want = dict(mix=SERVE_CELL["mix"], seed=SERVE_CELL["seed"],
                arrival_span=SERVE_CELL["arrival_span"],
                arrival_dist="uniform", bands=None, horizon=1, delivery=None)
    held: dict = {"builds_saved": 0, "replays_saved": 0, "texts": {}}

    def shared_fleet(n_docs, **kw):
        if n_docs != SERVE_CELL["n_docs"] or {**want, **kw} != want:
            return build(n_docs, **kw)
        if "sessions" in held:
            held["builds_saved"] += 1
        else:
            held["sessions"] = build(n_docs, **kw)
            held["traces"] = {id(s.trace) for s in held["sessions"]}
        return held["sessions"]

    def shared_replay(tr):
        if id(tr) not in held.get("traces", ()):
            return replay(tr)
        if id(tr) in held["texts"]:
            held["replays_saved"] += 1
        else:
            held["texts"][id(tr)] = replay(tr)
        return held["texts"][id(tr)]

    workload.build_fleet = bench_mod.build_fleet = shared_fleet
    bench_mod.replay_trace = shared_replay
    return held


def serve_mesh_phase(dev, bound, serve_rate, smi_line) -> list[dict]:
    """``[serve mesh]``: the README's serve command (:data:`MESH_ARGV`)
    in-process through the port's runner (``bench/runner.py --family
    serve``), serve/mixed/4096 over 8 mesh shards on the one card (shard s
    on ``cuda:(s mod 1)``).  Every count is set to 0 just before the runner
    and read just after: K1's per-row form and K4 once a shard of every
    dispatch, no plain version.  The runner exits 0, its artifact has
    JAX's keys and every document verified against the oracle.  K1's
    per-row form and K4 are held against their plain versions on shard 0's
    operands of the widest dispatch (kept during the drain) and timed
    there; a second mesh drain under the profiler (no runner, no verify)
    gives the device's idle share against the runner's drain, as
    ``[serve]``'s third drain does.  Each line names the placement and the
    card.
    Returns the two kernels' rows of the ``kernels`` line."""
    import io
    import shutil
    import tempfile

    import torch

    from crdt_benches_tpu_torch.bench import harness, runner
    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops import serve_fused as sf
    from crdt_benches_tpu_torch.ops.apply2 import PackedState
    from crdt_benches_tpu_torch.parallel.mesh import fleet_mesh
    from crdt_benches_tpu_torch.serve import pool as pool_mod
    from crdt_benches_tpu_torch.serve.scheduler import (
        FleetScheduler,
        prepare_streams,
    )
    from crdt_benches_tpu_torch.serve.workload import build_fleet

    cell = SERVE_CELL
    mesh = fleet_mesh(MESH_SHARDS, dev)
    where = f"{mesh.describe()}; {smi_line}"
    calls = {"k1": 0, "k4": 0}
    keep: dict = {}
    k1, k4 = pool_mod.resolve_range_rows, pool_mod.serve_macro_fused

    def k1_kept(kind, pos, rlen, slot0, v0):
        # a dispatch resolves shard 0 first: keep its operands at the
        # widest dispatch so far, and the same dispatch's shard-0 K4 launch
        if calls["k1"] % MESH_SHARDS == 0 and (
                "k1" not in keep or kind.numel() > keep["k1"][0].numel()):
            keep["k1"] = (kind, pos, rlen, slot0, v0.clone())
            keep["k4_next"] = True
        calls["k1"] += 1
        return k1(kind, pos, rlen, slot0, v0)

    def k4_kept(sub, tokens, dints, *, inputs=None, out=None):
        if calls["k4"] % MESH_SHARDS == 0 and keep.pop("k4_next", False):
            keep["k4"] = (PackedState(sub.doc.clone(), sub.length.clone(),
                                      sub.nvis.clone()), tokens, dints)
        calls["k4"] += 1
        return k4(sub, tokens, dints, inputs=inputs, out=out)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    saved_dir = harness.RESULTS_DIR
    harness.RESULTS_DIR = tmp
    pool_mod.resolve_range_rows, pool_mod.serve_macro_fused = k1_kept, k4_kept
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        torch.cuda.synchronize()
        zero_all_counts()
        with contextlib.redirect_stdout(out):
            rc = runner.main(list(MESH_ARGV))
        launches = read_all_counts("serve mesh")
        with open(os.path.join(tmp, "torch_serve_mixed_4096.json")) as fh:
            (rec,) = json.load(fh)
    finally:
        pool_mod.resolve_range_rows, pool_mod.serve_macro_fused = k1, k4
        harness.RESULTS_DIR = saved_dir
        shutil.rmtree(tmp, ignore_errors=True)
    run_s = time.perf_counter() - t0
    for ln in out.getvalue().splitlines():
        print(f"[serve mesh] runner: {ln}", flush=True)
    x = rec["extra"]
    if rc != 0:
        fail(f"serve mesh: the runner exited {rc}")
    if set(x) != JAX_SERVE_KEYS:
        fail(f"serve mesh: artifact keys differ from JAX's: missing "
             f"{sorted(JAX_SERVE_KEYS - set(x))}, extra "
             f"{sorted(set(x) - JAX_SERVE_KEYS)}")
    if not (x["verify_ok"] and x["verified_docs"] == list(range(
            cell["n_docs"])) and x["mesh_devices"] == MESH_SHARDS
            and sum(x["docs_per_class"].values()) == cell["n_docs"]):
        fail(f"serve mesh: verify_ok {x['verify_ok']} on "
             f"{len(x['verified_docs'])} docs, mesh {x['mesh_devices']}, "
             f"per class {x['docs_per_class']}")
    n = calls["k1"]
    if not (n and n == calls["k4"] and n % MESH_SHARDS == 0 and launches
            == {"resolve_range_rows": n, "serve_macro_fused": n}):
        fail(f"serve mesh: launches {launches} for {n} and {calls['k4']} "
             "shard calls")
    wall = rec["samples"][0]
    print(f"[serve mesh] serve/mixed/4096, {where}: "
          f"{x['patches_per_sec']:.1f} patches/s ({rec['elements']} "
          f"patches), {x['patches_per_sec'] / serve_rate:.4f} of "
          f"[serve]'s {serve_rate:.1f} in this run", flush=True)
    print(f"[serve mesh] drain, {where}: {wall:.4f} s over {x['rounds']} "
          f"rounds ({x['device_rounds']} slices, {n // MESH_SHARDS} "
          f"dispatches); runner call {run_s:.1f} s with set-up and the "
          f"oracle verify of all {len(x['verified_docs'])} docs (every one "
          f"byte-identical); artifact keys JAX's", flush=True)
    print(f"[serve mesh] launches, {where}: {launches} ({n // MESH_SHARDS} "
          f"dispatches x {MESH_SHARDS} shards), plain calls 0", flush=True)

    # ---- the kernels on shard 0's kept operands ----
    args = keep["k1"]
    got = rr.resolve_range_rows(*args)
    want = rr.resolve_range_rows_plain(*args)
    e1 = max_err((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    st, tokens, dints = keep["k4"]
    got4 = sf.serve_macro_fused(st, tokens, dints)
    want4 = sf.serve_macro_plain(st, tokens, dints)
    e4 = max_err(tuple(got4), tuple(want4))
    if e1 or e4:
        fail(f"serve mesh: shard 0's kept operands: K1 rows error {e1}, K4 "
             f"error {e4}")
    K1r, R1r, B1r = args[0].shape
    T1r = rr.effective_token_list_size(B1r, None)
    k1_ms = elapsed_ms(lambda: rr.resolve_range_rows(*args), 10)
    k1_plain_ms = elapsed_ms(lambda: rr.resolve_range_rows_plain(*args), 1)
    k1_bound = bound(4 * args[0].numel() * 4 + R1r * 4
                     + K1r * R1r * (4 * T1r + 3 * B1r + 1) * 4,
                     k1_rows_ops(*args))
    inputs = sf.serve_round_inputs(tokens, dints, st.length, st.nvis)
    K4, Rt, T = tokens[0].shape
    C = st.doc.shape[1]
    sf.serve_macro_fused(st, tokens, dints, inputs=inputs)  # warm-up
    k4_ms = elapsed_ms(lambda: sf.serve_macro_fused(st, tokens, dints,
                                                    inputs=inputs), 20)
    k4_plain_ms = elapsed_ms(lambda: sf.serve_macro_plain(st, tokens, dints),
                             3)
    k4_bnd = k4_bound(bound, st.length, inputs[5], dints[0].shape[2], T, C)
    print(f"[serve mesh] kernels, {where}: shard 0's operands of the "
          f"widest dispatch equal the plain versions (max abs "
          f"error 0); K1 per-row at (K, R, B, T) = {(K1r, R1r, B1r, T1r)} "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms, bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}); K4 at (K, Rt, C) = "
          f"{(K4, Rt, C)} {k4_ms:.4f} ms, plain {k4_plain_ms:.3f} ms, bound "
          f"{k4_bnd[0]:.4f} ms ({k4_bnd[1]})", flush=True)
    del keep, args, st, tokens, dints

    # ---- the device's idle share: a second mesh drain, profiled ----
    sessions = build_fleet(cell["n_docs"], mix=cell["mix"], seed=cell["seed"],
                           arrival_span=cell["arrival_span"])
    pool = pool_mod.DocPool(classes=cell["classes"], slots=cell["slots"],
                            device=dev, mesh=mesh)
    streams = prepare_streams(sessions, pool, batch=cell["batch"],
                              batch_chars=cell["batch_chars"])
    busy, pwall = profiled_drain_busy_ms(pool, FleetScheduler(
        pool, streams, batch=cell["batch"], macro_k=cell["macro_k"],
        batch_chars=cell["batch_chars"]))
    idle = (f"device busy {busy:.2f} of {wall * 1e3:.2f} ms wall (the "
            f"runner's drain; busy from a second drain under the "
            f"profiler, {pwall:.2f} ms wall), idle "
            f"{100 * (1 - busy / (wall * 1e3)):.1f}%"
            if busy > 0 else "idle not measured (no device time)")
    print(f"[serve mesh] idle, {where}: {idle}", flush=True)
    return [
        kernel_row(f"resolve_range_rows (mesh, {MESH_SHARDS} shards on 1 "
                   f"GPU, shard (K, R, B) = ({K1r}, {R1r}, {B1r}))",
                   "resolve_range.cu", "resolve_range_pallas.py:255",
                   launches["resolve_range_rows"], e1, k1_ms, k1_plain_ms,
                   k1_bound),
        kernel_row(f"serve_macro_fused (mesh, {MESH_SHARDS} shards on 1 "
                   f"GPU, shard (K, Rt, C) = ({K4}, {Rt}, {C}))",
                   "serve_macro.cu", "serve_fused.py:685",
                   launches["serve_macro_fused"], e4, k4_ms, k4_plain_ms,
                   k4_bnd),
    ]


#: The README's tiered cell, serve/tier/mixed/65536 (the ``--serve-tiers
#: hot=1024,warm=16384`` row of its "Tiered residency" table: the
#: ``mixed`` table, zipf arrivals over 32 rounds, a fleet 64 times its
#: device-row budget, a warm tier 16 times it; the serve cell's batch,
#: macro depth, slice and kernel), every document verified.  ``python3
#: chip_smoke.py --tier-only --tier-full`` drains it.
TIER_FULL = dict(SERVE_CELL, n_docs=65536, arrival_span=32,
                 arrival_dist="zipf", serve_tiers="hot=1024,warm=16384",
                 verify_sample=0)
#: ``[serve tier]``'s cell in the default run: TIER_FULL cut to a
#: sixty-fourth to fit the script's time (a thirty-second until the runtime
#: tooling phases came, an eighth until the streaming phases, a quarter
#: until the journal phases).  1,024 documents at ``hot=16,warm=256``
#: (slots (12, 3, 2, 2, 2)) keep the 64x over-subscription and the 16:1
#: warm to hot ratio.
TIER_CELL = dict(TIER_FULL, n_docs=1024, serve_tiers="hot=16,warm=256")
#: ``[serve tier ab]``'s fleet, and its tiers for ``[serve tier crash]`` too:
#: SERVE_CELL's fleet cut to 1,024 docs (2,048 until the runtime tooling
#: phases came, 4,096 at ``hot=256,warm=1024`` until the streaming phases)
#: at slots (96, 24, 6, 2, 2), 8 times over-subscribed, with a warm tier of
#: 512.
TIER_AB_DOCS = 1024
#: ``[serve tier crash]``'s fleet: the A/B fleet cut to 1,024 docs (2,048
#: until the replication and reshard phases came), 8 times over-subscribed.
TIER_CRASH_DOCS = 1024
TIER_AB = "hot=128,warm=512"
#: Pairs of prefetch and no-prefetch drains ``[serve tier ab]`` runs in
#: the default run: one, the prefetch drain first (a pair takes ~25-30 s
#: on an H100 host, and the script has a time limit that the journal
#: phases share); ``--ab-pairs 10`` is the measurement.
TIER_AB_PAIRS = 1
#: Dispatches of the second, instrumented tier drain traced by the
#: profiler for the device's idle share ((128, 512) until the tier cell was
#: cut to 1,024 docs, which drains in about 420 dispatches).  That drain
#: stops at the window's end once it has kept the operands of every (class,
#: rows) pair the timed drain used.
TIER_PROFILED = (64, 320)


#: ``[serve profile]``: the README's serve command (serve/mixed/4096, B =
#: 64, K = 8, the two-tier pool) through the port's runner with four steady
#: rounds under the device profiler (``--serve-profile 4``) and the sync
#: sanitizer armed with its native tripwire (``--serve-sanitize syncs``):
#: stopping the capture synchronizes the device, outside the hot path.
PROFILE_ARGV = ("--family", "serve", "--serve-docs", "4096", "--serve-mix",
                "mixed", "--serve-batch", "64", "--serve-macro", "8",
                "--serve-profile", "4", "--serve-sanitize", "syncs",
                "--serve-save-name", "chip_profile")
#: The kernels of the serve path by wrapper, and the substring of their
#: device names in a ``torch.profiler`` trace (K4 has one template instance
#: a block width).
PROFILE_KERNELS = {"resolve_range_rows": "resolve_rows_kernel",
                   "serve_macro_fused": "serve_macro_kernel"}
#: The edge harness's uint16 bracket: the narrow ladder's largest class and
#: the wide ladder's smallest (``serve/edgecheck.py``).
EDGE_CLASSES = (65408, 65664)


def tooling_phases(dev, bound, serve_rate, smi_line) -> list[dict]:
    """Item 7's runtime tooling on the card, each line with the card's name
    and power limit.

    ``[serve profile]``: :data:`PROFILE_ARGV` in-process through the
    runner, the sync sanitizer armed (no undeclared sync, the capture's
    stop included); the artifact's ``profile`` block lists K1's per-row
    kernel and K4's by name, their calls equal to the launches made between the
    capture's start and stop (the device is waited for before the stop, so
    every launch of the window has finished).  ``[serve sanitized]``:
    ``SERVE_CELL`` through ``run_serve_bench`` with every sanitizer armed
    and the native sync tripwire on (``torch.cuda.set_sync_debug_mode
    ("error")`` on the hot path): a sync outside a declared fence raises
    and fails the script; every document verified; the blocks, the syncs
    fence by fence and the rate as a share of ``[serve]``'s printed.
    ``[edgecheck]``: the full dtype-edge harness (the small ladder and the
    65,408- and 65,664-column ladders, both serve kernels, the range
    sanitizer armed, the boundary fuzz); the fused drains' first operands
    at the two big classes kept and held, through one K1 per-row launch
    and one K4 launch, against the plain versions (max abs error 0) and
    timed (:func:`kept_kernel_check`).  ``[lifecheck]`` and ``[fscrash]``:
    the two harnesses at ``small``: zero leaks, every crash point
    recovered.  Every count is set to 0 before each phase and read after
    it: K1's per-row form and K4 launched, no plain version.  Returns the
    edge ladders' two kernel rows."""
    import io
    import shutil
    import tempfile

    import torch

    from crdt_benches_tpu_torch.bench import harness, runner
    from crdt_benches_tpu_torch.lint import SANITIZERS, fs_sanitizer
    from crdt_benches_tpu_torch.obs import profiler as prof_mod
    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops import serve_fused as sf
    from crdt_benches_tpu_torch.ops.apply2 import PackedState
    from crdt_benches_tpu_torch.serve import pool as pool_mod
    from crdt_benches_tpu_torch.serve.bench import run_serve_bench
    from crdt_benches_tpu_torch.serve.edgecheck import run_edgecheck
    from crdt_benches_tpu_torch.serve.fscrash import enumerate_crash_points
    from crdt_benches_tpu_torch.serve.lifecheck import run_lifecheck

    def launched(tag, launches):
        if not all(launches.get(k) for k in PROFILE_KERNELS):
            fail(f"{tag}: launches {launches}")

    # ---- [serve profile]: the runner with --serve-profile 4 ----
    window = {}
    begin, stop = prof_mod.DeviceProfiler.round_begin, \
        prof_mod.DeviceProfiler._stop

    def counted_begin(self):
        if self.state == "ready":
            window["start"] = (rr.resolve_range_rows.launches,
                               sf.serve_macro_fused.launches)
        begin(self)

    def counted_stop(self):
        torch.cuda.synchronize()  # the window's launches have finished
        window["stop"] = (rr.resolve_range_rows.launches,
                          sf.serve_macro_fused.launches)
        stop(self)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    saved_dir = harness.RESULTS_DIR
    harness.RESULTS_DIR = tmp
    prof_mod.DeviceProfiler.round_begin = counted_begin
    prof_mod.DeviceProfiler._stop = counted_stop
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        torch.cuda.synchronize()
        zero_all_counts()
        with contextlib.redirect_stdout(out):
            rc = runner.main(list(PROFILE_ARGV))
        launches = read_all_counts("serve profile")
        with open(os.path.join(tmp, "torch_chip_profile.json")) as fh:
            (rec,) = json.load(fh)
    finally:
        prof_mod.DeviceProfiler.round_begin = begin
        prof_mod.DeviceProfiler._stop = stop
        harness.RESULTS_DIR = saved_dir
        shutil.rmtree(tmp, ignore_errors=True)
    x = rec["extra"]
    if rc != 0 or not x["verify_ok"] or not x["boundary_syncs"]["sanitized"]:
        fail(f"serve profile: the runner exited {rc}, verify_ok "
             f"{x['verify_ok']}, sanitized "
             f"{x['boundary_syncs']['sanitized']}")
    launched("serve profile", launches)
    block = x["profile"]
    if block is None or block["rounds"] != 4 or "start" not in window \
            or "stop" not in window:
        fail(f"serve profile: block {block}, window {window}")
    want = {k: window["stop"][i] - window["start"][i]
            for i, k in enumerate(PROFILE_KERNELS)}
    got = {k: sum(o["calls"] for o in block["top_ops"] if sub in o["name"])
           for k, sub in PROFILE_KERNELS.items()}
    if got != want or not all(want.values()):
        fail(f"serve profile: calls in top_ops {got}, launches in the "
             f"window {want}")
    print(f"[serve profile] serve/mixed/4096 through the runner with "
          f"--serve-profile 4 --serve-sanitize syncs (0 undeclared syncs), "
          f"{smi_line}: {block['rounds']} steady rounds "
          f"captured ({block['dirty_rounds']} dirty), K1 per-row and K4 "
          f"calls in the trace {got} equal their launches in the window; "
          f"drain {x['patches_per_sec']:.1f} patches/s under the profiler; "
          f"runner call {time.perf_counter() - t0:.1f} s", flush=True)
    for o in block["top_ops"]:
        print(f"[serve profile] top op, {smi_line}: {o['total_ms']:.3f} ms "
              f"in {o['calls']} calls: {o['name'][:120]}", flush=True)

    # ---- [serve sanitized]: every sanitizer armed, the native tripwire ----
    logs = []
    t0 = time.perf_counter()
    rep = run_serve_bench(**SERVE_CELL, verify_sample=0, sanitize=SANITIZERS,
                          device=dev, pool_hook=zero_counts,
                          log=logs.append)
    launches = read_all_counts("serve sanitized")
    launched("serve sanitized", launches)
    run_s = time.perf_counter() - t0
    if not any("native sync tripwire on" in m for m in logs):
        fail("serve sanitized: the native sync tripwire was not armed")
    bs = rep["boundary_syncs"]
    if not (rep["verify_ok"] and rep["verified_docs"] == SERVE_CELL["n_docs"]
            and bs["sanitized"] and bs["syncs"] is not None):
        fail(f"serve sanitized: verify_ok {rep['verify_ok']} on "
             f"{rep['verified_docs']} docs, {bs}")
    rate = rep["patches_per_sec"]
    print(f"[serve sanitized] serve/mixed/4096, every sanitizer armed "
          f"({','.join(SANITIZERS)}) and the native sync tripwire on, "
          f"{smi_line}: 0 undeclared syncs, all {rep['verified_docs']} docs "
          f"byte-identical to the oracle; {rate:.1f} patches/s, "
          f"{rate / serve_rate:.4f} of [serve]'s {serve_rate:.1f} in this "
          f"run; launches {launches}; call {run_s:.1f} s", flush=True)
    print(f"[serve sanitized] fences, {smi_line}: "
          + ", ".join(f"{k} {n} entries {bs['syncs'].get(k, 0)} syncs"
                      for k, n in bs["entries"].items()), flush=True)
    for key in ("thread_crossings", "fs_ops", "lifecycle", "ranges"):
        b = rep[key]
        body = {k: v for k, v in b.items()
                if isinstance(v, dict) and v}
        print(f"[serve sanitized] {key}, {smi_line}: "
              f"{json.dumps(body, sort_keys=True)}", flush=True)

    # ---- [edgecheck]: the full harness, the uint16 bracket kept ----
    keep: dict = {}
    step = pool_mod.DocPool.macro_step

    def kept_step(pool, cls, kind, pos, rlen, slot0, nbits):
        Rt = kind.shape[1]
        if (cls in EDGE_CLASSES and pool.serve_kernel == "fused"
                and (cls, Rt) not in keep):
            t = pool.tier_rows(cls, Rt)
            keep[cls, Rt] = ((kind.copy(), pos.copy(), rlen.copy(),
                              slot0.copy()),
                             PackedState(t.doc.clone(), t.length.clone(),
                                         t.nvis.clone()))
        return step(pool, cls, kind, pos, rlen, slot0, nbits)

    pool_mod.DocPool.macro_step = kept_step
    t0 = time.perf_counter()
    try:
        torch.cuda.synchronize()
        zero_all_counts()
        report = run_edgecheck(
            device=dev, log=lambda m: print(f"[edgecheck] {m}, {smi_line}",
                                            flush=True))
        launches = read_all_counts("edgecheck")
    finally:
        pool_mod.DocPool.macro_step = step
    launched("edgecheck", launches)
    if set(report["ladders"]) != {"small-ladder", "narrow-max", "wide-min"}:
        fail(f"edgecheck: ladders {sorted(report['ladders'])}")
    fz = report["boundary_fuzz"]
    print(f"[edgecheck] {sum(t['docs'] for t in report['ladders'].values())} "
          f"docs x 2 kernels across 3 ladders byte-identical to the oracle "
          f"and across the kernels, {smi_line}: range checks "
          f"{report['checks']}, masks {report['masks']}; {fz['contracts']} "
          f"contracts, {fz['rejected']} edge perturbations refused; "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    kk = kept_kernel_check("edgecheck kernels",
                           f"the 65,408- and 65,664-column ladders, "
                           f"{smi_line}", keep, EDGE_CLASSES, dev, bound)
    rows = kept_kernel_rows("edgecheck, the uint16 bracket", kk, launches)

    # ---- [lifecheck] and [fscrash] at small ----
    t0 = time.perf_counter()
    zero_all_counts()
    lc = run_lifecheck(small=True, device=dev)
    launches = read_all_counts("lifecheck")
    launched("lifecheck", launches)
    if lc["leaked"] or lc["unattributed"] or not all(
            lc["machines"].get(m) for m in ("doc", "row", "session",
                                            "stream")):
        fail(f"lifecheck: {lc}")
    print(f"[lifecheck] small, {smi_line}: 0 leaks, 0 unattributed; "
          f"machines {lc['machines']}, resources {lc['resources']}; "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    zero_all_counts()
    fc = enumerate_crash_points(small=True, device=dev)
    launches = read_all_counts("fscrash")
    launched("fscrash", launches)
    if not (fc["verified"] == fc["mutations"] > 0 and all(
            fc["per_protocol"].get(t) for t in
            fs_sanitizer.KNOWN_PROTOCOLS)):
        fail(f"fscrash: {fc}")
    print(f"[fscrash] small, {smi_line}: {fc['verified']} of "
          f"{fc['mutations']} crash points recovered byte-identical to the "
          f"oracle, per protocol {fc['per_protocol']}; launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def kept_kernel_check(tag, label, keep, classes, dev, bound) -> dict:
    """``[serve tier kernels]`` and ``[serve stream kernels]``: the kept
    first operands of each (class, rows) pair a drain launched (host op
    arrays and a device copy of the tier's rows) through one K1 per-row
    launch and one K4 launch, held against ``resolve_range_rows_plain``
    (the pairs' rows stacked, :func:`k1_rows_plain_stacked`) and
    ``serve_macro_plain``; every class of ``classes`` must appear.  K1's
    per-row form is timed at the pair with the most rows, K4 at every pair
    and its plain round at the largest class's widest tier.  Returns the
    errors, times and bounds for :func:`kept_kernel_rows`."""
    import numpy as np
    import torch

    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops import serve_fused as sf
    from crdt_benches_tpu_torch.ops.packing import widen_ops

    t0 = time.perf_counter()
    err = {"k1": 0, "k4": 0}
    at: dict[tuple[int, int], tuple] = {}
    pairs = sorted(keep)
    operands = {}
    for C, Rt in pairs:
        ops, st = keep[C, Rt]
        kd, pd, ld, sd = torch.from_numpy(
            np.stack(widen_ops(*ops))).to(dev).unbind(0)
        operands[C, Rt] = (kd, pd, ld, sd, st.nvis)
    # the plain version on every pair at once, their rows stacked
    wants = dict(zip(pairs, k1_rows_plain_stacked(
        [operands[p] for p in pairs])))
    for C, Rt in pairs:
        st = keep[C, Rt][1]
        args = operands[C, Rt]
        got = rr.resolve_range_rows(*args)
        want = wants[C, Rt]
        e1 = max_err((*got[0], *got[1], got[2]),
                     (*want[0], *want[1], want[2]))
        tokens, dints, _ = got
        inputs = sf.serve_round_inputs(tokens, dints, st.length, st.nvis)
        new = sf.serve_macro_fused(st, tokens, dints, inputs=inputs)
        ref = sf.serve_macro_plain(st, tokens, dints)
        e4 = max_err((new.doc, new.length, new.nvis),
                     (ref.doc, ref.length, ref.nvis))
        if e1 or e4:
            fail(f"{tag} at (C, Rt) = {(C, Rt)}: K1 rows "
                 f"error {e1}, K4 error {e4}")
        err["k1"], err["k4"] = max(err["k1"], e1), max(err["k4"], e4)
        at[C, Rt] = (args, st, tokens, dints, inputs)
    del wants
    if {C for C, _ in pairs} != set(classes):
        fail(f"{tag}: classes {sorted({C for C, _ in pairs})}")
    # K1's per-row form timed at the pair with the most rows, K4 at every
    # pair, its row at the largest class's widest tier
    C1, R1 = max(pairs, key=lambda p: (p[1], p[0]))
    args = at[C1, R1][0]
    K1r, _, B1r = args[0].shape
    T1r = rr.effective_token_list_size(B1r, None)
    k1_ms = elapsed_ms(lambda: rr.resolve_range_rows(*args), 10)
    k1_plain_ms = elapsed_ms(lambda: rr.resolve_range_rows_plain(*args), 1)
    k1_bound = bound(4 * args[0].numel() * 4 + R1 * 4
                     + K1r * R1 * (4 * T1r + 3 * B1r + 1) * 4,
                     k1_rows_ops(*args))
    k4_at = {}
    for C, Rt in pairs:
        _, st, tokens, dints, inputs = at[C, Rt]
        sf.serve_macro_fused(st, tokens, dints, inputs=inputs)  # warm-up
        ms = elapsed_ms(lambda: sf.serve_macro_fused(st, tokens, dints,
                                                     inputs=inputs), 20)
        k4_at[C, Rt] = (tokens[0].shape[0], ms, k4_bound(
            bound, st.length, inputs[5], dints[0].shape[2],
            tokens[0].shape[2], C))
    top = max(C for C, _ in pairs)
    wtop = max(Rt for C, Rt in pairs if C == top)
    _, st, tokens, dints, _ = at[top, wtop]
    k4_plain_ms = elapsed_ms(lambda: sf.serve_macro_plain(st, tokens, dints),
                             3)
    print(f"[{tag}] {label}: K1 per-row and K4 equal "
          f"resolve_range_rows_plain and serve_macro_plain (max abs error "
          f"{err['k1']}, {err['k4']}) at all {len(pairs)} (class, rows) "
          f"pairs the drain launched: "
          + ", ".join(f"C={C} Rt={Rt}: K={v[0]}, K4 {v[1]:.4f} ms, bound "
                      f"{v[2][0]:.4f} ms ({v[2][1]})"
                      for (C, Rt), v in sorted(k4_at.items()))
          + f"; K1 per-row at (K, R, B, T) = {(K1r, R1, B1r, T1r)}: "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms, bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}); K4 plain at (Rt, C) = "
          f"{(wtop, top)}: {k4_plain_ms:.3f} ms "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    K4, k4_ms, k4_bnd = k4_at[top, wtop]
    return {"err": err, "k1": ((K1r, R1, B1r), k1_ms, k1_plain_ms, k1_bound),
            "k4": ((K4, wtop, top), k4_ms, k4_plain_ms, k4_bnd)}


def kept_kernel_rows(label, kk, launches) -> list[dict]:
    """The two kernels' rows of the ``kernels`` line from
    :func:`kept_kernel_check`, with a drain's ``launches``."""
    shape1, k1_ms, k1_plain_ms, k1_bound = kk["k1"]
    shape4, k4_ms, k4_plain_ms, k4_bnd = kk["k4"]
    return [
        kernel_row(f"resolve_range_rows ({label}, (K, R, B) = {shape1})",
                   "resolve_range.cu", "resolve_range_pallas.py:255",
                   launches["resolve_range_rows"], kk["err"]["k1"], k1_ms,
                   k1_plain_ms, k1_bound),
        kernel_row(f"serve_macro_fused ({label}, (K, Rt, C) = {shape4})",
                   "serve_macro.cu", "serve_fused.py:685",
                   launches["serve_macro_fused"], kk["err"]["k4"], k4_ms,
                   k4_plain_ms, k4_bnd),
    ]


def zero_counts(_pool=None) -> None:
    """A ``pool_hook``: every count set to 0 once the card is idle."""
    import torch

    torch.cuda.synchronize()
    zero_all_counts()


def add_counts(counts, launches) -> None:
    """Sum a drain's ``launches`` into ``counts`` (its keys only)."""
    for k in counts:
        counts[k] += launches.get(k, 0)

def keep_tier_operands(keep, hook=None):
    """A ``pool_hook`` that keeps each (class, rows) pair's first macro-step
    operands (host op arrays and a device copy of the tier's rows, gathered
    over the shards by ``DocPool.tier_rows``) in ``keep`` for
    :func:`kept_kernel_check`, then runs ``hook`` (the counts' reset)."""
    from crdt_benches_tpu_torch.ops.apply2 import PackedState

    def install(p):
        step = p.macro_step

        def kept_step(cls, kind, pos, rlen, slot0, nbits):
            Rt = kind.shape[1]
            if (cls, Rt) not in keep:
                t = p.tier_rows(cls, Rt)
                keep[cls, Rt] = ((kind.copy(), pos.copy(), rlen.copy(),
                                  slot0.copy()),
                                 PackedState(t.doc.clone(), t.length.clone(),
                                             t.nvis.clone()))
            return step(cls, kind, pos, rlen, slot0, nbits)

        p.macro_step = kept_step
        if hook is not None:
            hook(p)
    return install


def serve_tier_phases(dev, bound, cell=TIER_CELL,
                      ab_pairs=TIER_AB_PAIRS) -> tuple[float, list[dict]]:
    """Three-tier residency on the card.

    ``[serve tier]``: ``cell`` through ``run_serve_bench`` with every count
    set to 0 just before the drain and read just after, verified against
    the oracle, its residency block, host phases and CUDA-event spans (as
    ``[serve]``); the timed drain only notes each dispatch's (class, rows)
    pair and the host clock at ``TIER_PROFILED``'s edges.  A second drain
    of the same fleet keeps each pair's first operands and runs the
    profiler over ``TIER_PROFILED``: the device's idle share is its busy
    time over the timed drain's wall time across the same dispatches.
    ``[serve tier kernels]``: the kept operands of each pair through one
    K1 per-row launch and one K4 launch held against
    ``resolve_range_rows_plain`` and ``serve_macro_plain``, and timed.
    ``[serve tier ab]``: SERVE_CELL's fleet cut to ``TIER_AB_DOCS`` at
    ``TIER_AB``'s slots, ``ab_pairs`` pairs of drains with the warm tier and
    the prefetcher and with the warm tier and no prefetcher, in turns (the
    first of each pair alternates), then once through the two-tier pool:
    each side's median, least and largest rate and moves; every tiered drain
    agrees with the first on every fact no thread timing can move, and the
    first pair and the two-tier drain verify byte-identical.  Returns the
    tier drain's rate and the two kernels' rows of the ``kernels`` line for
    it."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
    from crdt_benches_tpu_torch.serve import bench as bench_mod
    from crdt_benches_tpu_torch.serve import pool as pool_mod
    from crdt_benches_tpu_torch.serve import prefetch as prefetch_mod
    from crdt_benches_tpu_torch.serve import scheduler as sched_mod
    from crdt_benches_tpu_torch.serve.bench import (
        parse_tier_spec,
        run_serve_bench,
    )
    from crdt_benches_tpu_torch.serve.workload import build_fleet

    label = f"serve/tier/{cell['mix']}/{cell['n_docs']}"
    tier_slots, tier_warm = parse_tier_spec(cell["serve_tiers"],
                                            cell["slots"])

    @contextlib.contextmanager
    def fleet(sessions, cfg, slots, warm, prefetch=True):
        """A pool (``warm`` docs warm, the prefetch thread if ``prefetch``)
        and a scheduler over ``sessions``; the pool is closed on exit."""
        pool = pool_mod.DocPool(classes=cfg["classes"], slots=slots,
                                device=dev, warm_docs=warm,
                                prefetch=prefetch)
        try:
            streams = sched_mod.prepare_streams(
                sessions, pool, batch=cfg["batch"],
                batch_chars=cfg["batch_chars"])
            yield pool, sched_mod.FleetScheduler(
                pool, streams, batch=cfg["batch"], macro_k=cfg["macro_k"],
                batch_chars=cfg["batch_chars"])
        finally:
            pool.close()

    # ---- [serve tier]: the tier cell through the bench's entry point ----
    t0 = time.perf_counter()
    lo, hi = TIER_PROFILED
    held: dict = {}
    used: set[tuple[int, int]] = set()  # the timed drain's (class, rows)
    stamps: dict[int, float] = {}  # its host clock at the window's edges

    def arm(p):
        """Spans on; each dispatch's (class, rows) pair noted and the host
        clock read at the window's edges (no copy, no synchronize, no
        profiler); counts to 0."""
        p.spans = []
        held["pool"] = p
        step, n = p.macro_step, [0]

        def noted_step(cls, kind, *rest, **kw):
            if n[0] in TIER_PROFILED:
                stamps[n[0]] = time.perf_counter()
            n[0] += 1
            used.add((cls, kind.shape[1]))
            return step(cls, kind, *rest, **kw)

        p.macro_step = noted_step
        torch.cuda.synchronize()
        zero_all_counts()

    build = bench_mod.build_fleet

    def kept_fleet(*a, **kw):
        """The bench's fleet, kept for the second drain."""
        held["sessions"] = build(*a, **kw)
        return held["sessions"]

    bench_mod.build_fleet = kept_fleet
    try:
        rep = run_serve_bench(**cell, device=dev, pool_hook=arm,
                              log=lambda m: print(f"[serve tier] {m}",
                                                  flush=True))
    finally:
        bench_mod.build_fleet = build
    launches = read_all_counts("serve tier drain")
    n = rep["dispatches"]
    if launches != {"resolve_range_rows": n, "serve_macro_fused": n}:
        fail(f"serve tier drain: launches {launches} for {n} dispatches")
    res = rep["residency"]
    if not (rep["verify_ok"] and set(rep["verified_per_class"]) == set(map(
            str, cell["classes"])) and (cell["verify_sample"] or (
                rep["verified_docs"] == cell["n_docs"]))):
        fail(f"serve tier drain: verify {rep['verify']} ok "
             f"{rep['verify_ok']} on {rep['verified_docs']} docs, per class "
             f"{rep['verified_per_class']}")
    if tuple(rep["slots"]) != tier_slots or res["prefetch_errors"] or not (
            rep["evictions"] and rep["promotions"] and res["warm_hits"]
            and res["warm_evictions"] and res["prefetch_submitted"]):
        fail(f"serve tier drain: slots {rep['slots']}, evictions "
             f"{rep['evictions']}, promotions {rep['promotions']}, "
             f"residency {res}")
    if len(stamps) != 2:
        fail(f"serve tier drain: {n} dispatches, the profiled window "
             f"{TIER_PROFILED} runs past them")
    tpool = held.pop("pool")
    spans: dict[str, float] = {}
    for name, a, b in tpool.spans:
        spans[name] = spans.get(name, 0.0) + a.elapsed_time(b)
    del tpool
    timed_s = time.perf_counter() - t0

    # the second drain: each pair's first operands kept (host op arrays
    # and a device copy of the tier's rows, taken before the step), the
    # profiler over dispatches lo to hi - 1, each edge after a synchronize
    t0 = time.perf_counter()
    keep: dict[tuple[int, int], tuple] = {}
    prof = profile(activities=[ProfilerActivity.CUDA])
    win = {"n": 0}

    def instrument(p):
        keep_tier_operands(keep)(p)
        step = p.macro_step

        def windowed_step(*args, **kw):
            i = win["n"]
            if i in TIER_PROFILED:
                torch.cuda.synchronize()
                win[i] = time.perf_counter()
                (prof.start if i == lo else prof.stop)()
            if i >= hi and used <= keep.keys():
                raise _WindowEnd
            win["n"] = i + 1
            return step(*args, **kw)

        p.macro_step = windowed_step

    try:
        with fleet(held.pop("sessions"), cell, tier_slots,
                   tier_warm) as (pool, sched):
            instrument(pool)
            sched.run()
    except _WindowEnd:
        pass
    read_all_counts("serve tier instrumented drain")  # no plain version
    if hi not in win or not used <= keep.keys():
        fail(f"serve tier instrumented drain: window {TIER_PROFILED}, "
             f"kept {sorted(keep)} of {sorted(used)}")
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    wall = (stamps[hi] - stamps[lo]) * 1e3
    idle = (f"device busy {busy:.2f} ms over dispatches {lo}-{hi - 1} of a "
            f"second, profiled drain (its window {1e3 * (win[hi] - win[lo]):.2f}"
            f" ms wall), of {wall:.2f} ms wall over the same dispatches of "
            f"the timed drain: idle {100 * (1 - busy / wall):.1f}%"
            if busy > 0 else "idle not measured (no device time in the "
            "window)")
    lat = rep["batch_latency"]
    print(f"[serve tier] {label} ({cell['serve_tiers']}, slots "
          f"{tier_slots}, zipf arrivals over {cell['arrival_span']} rounds):"
          f" {rep['patches_per_sec']:.1f} patches/s ({rep['patches']} "
          f"patches in {rep['wall_time']:.4f} s); macro-round latency p50 "
          f"{lat['p50'] * 1e3:.2f} ms, p95 {lat['p95'] * 1e3:.2f}, p99 "
          f"{lat['p99'] * 1e3:.2f}; {rep['rounds']} rounds, "
          f"{rep['device_rounds']} slices, {n} dispatches, pad fraction "
          f"{rep['pad_fraction']:.4f}; evictions {rep['evictions']}, "
          f"restores {rep['restores']}, promotions {rep['promotions']}, "
          f"admissions {rep['admissions']}, fresh admits "
          f"{rep['fresh_admits']}, limbo pulls {rep['limbo_pulls']}; "
          f"verify {rep['verify']} ok on {rep['verified_docs']} docs "
          f"({rep['verified_per_class']}, {rep['verify_seconds']:.1f} s); "
          f"launches {launches}, plain calls 0; set-up "
          f"{rep['setup_seconds']:.1f} s; host phase s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rep["phase_seconds"].items())
          + "; device span ms (CUDA events, include device waits on the "
          "host): " + ", ".join(f"{k} {v:.2f}" for k, v in spans.items())
          + f"; {idle} ({timed_s:.1f} s, second drain to dispatch "
          f"{win['n']}: {time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[serve tier] residency: {json.dumps(res)}", flush=True)

    # ---- [serve tier kernels]: every (class, tier) pair of the drain ----
    kk = kept_kernel_check("serve tier kernels", label, keep, cell["classes"],
                           dev, bound)
    del keep

    # ---- [serve tier ab]: one slot table, pairs in turns, two tiers ----
    t0 = time.perf_counter()
    ab = dict(SERVE_CELL, n_docs=TIER_AB_DOCS)
    ab_slots, ab_warm = parse_tier_spec(TIER_AB, ab["slots"])
    sessions = build_fleet(ab["n_docs"], mix=ab["mix"], seed=ab["seed"],
                           arrival_span=ab["arrival_span"])
    oracle: dict[int, str] = {}  # id(trace) -> content
    io = {"writes": 0, "reads": 0, "thread_reads": 0}
    loads = (sched_mod.load_state, pool_mod.load_state,
             prefetch_mod.load_state)

    def counted(key):
        real = loads[1]

        def load(path):
            io[key] += 1  # the thread's key has one writer: the thread
            return real(path)
        return load

    def ab_drain(tag, warm, prefetch, verify):
        """One drain of the A/B fleet at ``ab_slots``: spool writes and
        reads counted, every count set to 0 just before it and read just
        after, every doc verified if ``verify``; returns its numbers and
        the facts no thread timing moves."""
        with fleet(sessions, ab, ab_slots, warm, prefetch) as (pool, sched):
            save = pool.spool_save

            def spool_save(*a, **kw):
                io["writes"] += 1
                return save(*a, **kw)

            pool.spool_save = spool_save
            io.update(writes=0, reads=0, thread_reads=0)
            sched_mod.load_state = pool_mod.load_state = counted("reads")
            prefetch_mod.load_state = counted("thread_reads")
            torch.cuda.synchronize()
            zero_all_counts()
            try:
                stats = sched.run()
            finally:
                (sched_mod.load_state, pool_mod.load_state,
                 prefetch_mod.load_state) = loads
            got = read_all_counts(f"serve tier ab {tag}")
            if not sched.done or got != {
                    "resolve_range_rows": stats.dispatches,
                    "serve_macro_fused": stats.dispatches}:
                fail(f"serve tier ab {tag}: done {sched.done}, launches "
                     f"{got} for {stats.dispatches} dispatches")
            pf = pool.prefetcher
            if pf is not None and pf.errors:
                fail(f"serve tier ab {tag}: prefetch errors {pf.errors}")
            bad = []
            for s in sessions if verify else ():
                want = oracle.get(id(s.trace))
                if want is None:
                    want = oracle[id(s.trace)] = replay_trace(s.trace)
                if pool.decode(s.doc_id) != want:
                    bad.append(s.doc_id)
            if bad:
                fail(f"serve tier ab {tag}: docs {bad[:16]} differ from the "
                     "oracle")
            hits = pool.warm_hits
            return {
                "rate": stats.patches / stats.wall_time,
                "wall": stats.wall_time, "phases": dict(stats.phase_seconds),
                "io": dict(io), "restores": pool.restores,
                "hit_rate": (hits / (hits + pool.restores) if warm and (
                    hits + pool.restores) else None),
                "facts": {
                    "rounds": stats.rounds, "slices": stats.slices,
                    "dispatches": stats.dispatches, "range ops": stats.ops,
                    "evictions": pool.evictions,
                    "promotions": pool.promotions,
                    "admissions": stats.admissions,
                    "fresh admits": pool.fresh_admits,
                    "limbo pulls": sched.limbo_pulls,
                    "warm hits + restores": hits + pool.restores,
                    "doc records": {d: (r.cls, r.row, r.length, r.last_sched)
                                for d, r in pool.docs.items()},
                    "buckets": {c: (list(b.rows), b.state.doc.clone(),
                                    b.state.length.clone(),
                                    b.state.nvis.clone())
                                for c, b in pool.buckets.items()},
                },
            }

    def differ(a, b):
        """The facts in which two drains differ."""
        out = [k for k in a if k != "buckets" and a[k] != b[k]]
        for c, (rows, *st) in a["buckets"].items():
            rows_b, *st_b = b["buckets"][c]
            if rows != rows_b or not all(map(torch.equal, st, st_b)):
                out.append(f"bucket c{c}")
        return out

    sides = {True: "warm+prefetch", False: "warm, no prefetch"}
    runs: dict[bool, list[dict]] = {True: [], False: []}
    first = None
    for k in range(ab_pairs):
        for prefetch in ((True, False) if k % 2 == 0 else (False, True)):
            r = ab_drain(f"{sides[prefetch]} {k}", ab_warm, prefetch,
                         verify=k == 0)
            first = first or r["facts"]
            if differ(first, r["facts"]):
                fail(f"serve tier ab: pair {k}, {sides[prefetch]}, differs "
                     f"from the first drain in {differ(first, r['facts'])}")
            del r["facts"]
            runs[prefetch].append(r)
        on, off = runs[True][-1], runs[False][-1]
        print(f"[serve tier ab] pair {k} ("
              + ("prefetch first" if k % 2 == 0 else "no prefetch first")
              + f"): warm+prefetch {on['rate']:.1f} patches/s (moves "
              f"{on['phases']['moves']:.4f} s), no prefetch "
              f"{off['rate']:.1f} (moves {off['phases']['moves']:.4f} s)",
              flush=True)
    two = ab_drain("two-tier", 0, False, verify=True)
    for tag, r in ((sides[True], runs[True][0]), (sides[False],
                   runs[False][0]), ("two-tier", two)):
        io_ = r["io"]
        print(f"[serve tier ab] {ab['mix']}/{ab['n_docs']} at slots "
              f"{ab_slots}, {tag}" + (" (pair 0)" if r is not two else "")
              + f": {r['rate']:.1f} patches/s ({r['wall']:.4f} s), phases "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["phases"].items())
              + f"; spool writes {io_['writes']}, reads {io_['reads']} "
              f"(prefetch thread {io_['thread_reads']}); restores "
              f"{r['restores']}; hit rate "
              + (f"{r['hit_rate']:.4f}" if r["hit_rate"] is not None
                 else "n/a") + f"; {ab['n_docs']} docs byte-identical to "
              "the oracle", flush=True)

    def spread(xs):
        return (f"median {statistics.median(xs):.4f} (least {min(xs):.4f}, "
                f"largest {max(xs):.4f})")

    ratio = [a["rate"] / b["rate"] for a, b in zip(runs[True], runs[False])]
    print(f"[serve tier ab] {ab_pairs} pairs in turns: "
          + "; ".join(f"{sides[p]}: patches/s "
                      + spread([r["rate"] for r in runs[p]]) + ", moves s "
                      + spread([r["phases"]["moves"] for r in runs[p]])
                      + ", hit rate "
                      + spread([r["hit_rate"] for r in runs[p]])
                      for p in (True, False))
          + f"; prefetch over no prefetch, per pair: {spread(ratio)}, "
          f"the prefetch drain faster in {sum(x > 1 for x in ratio)} of "
          f"{ab_pairs}; every tiered drain agrees with the first on "
          f"{', '.join(k for k in first if k != 'buckets')}, every bucket "
          f"state and row map ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return rep["patches_per_sec"], kept_kernel_rows(label, kk, launches)


#: The journal's cadence on SERVE_CELL (the README's journal row): a
#: snapshot barrier every 4 macro-rounds, every 4th of them full.
JOURNAL = dict(snapshot_every=4, snapshot_full_every=4)
#: ``[serve journal]``'s fleet: SERVE_CELL cut to half its documents to
#: fit the script's time (the whole cell until the runtime tooling phases
#: came); it drains in 9 macro-rounds, a full barrier and a delta.
JOURNAL_DOCS = 2048
#: ``[serve crash]``'s crash: SERVE_CELL drains in 14 macro-rounds, with
#: barriers after rounds 4 (full), 8 (delta) and 12 (delta); stopped after
#: round 10 it recovers from the delta at chain depth 2 and redoes rounds 9
#: and 10 from the WAL (at JOURNAL_DOCS the drain ends after round 9).
CRASH_ROUND = 10
#: ``[journal rebuild]``'s seeded sample: documents of each final class.
REBUILD_PER_CLASS = 8
#: ``[serve journal]``'s seeded verify sample (the bench's per-class rule),
#: checked after the clean drain and again after its recovery: the
#: crash-recovered fleets verify every document.
JOURNAL_VERIFY_SAMPLE = 512


def rebuild_slice_check(dev, bound, st, C, base, n_init, B, chars, tag):
    """K1's per-row form (R = 1) and K4 (K = 1, Rt = 1) on the first slice
    a ``rebuild_doc`` of stream ``st`` at class ``C`` replays from ``base``
    (``(row, length, nvis, cursor)``, or None: a fresh row at cursor 0):
    each held against its plain version (fails on any difference) and
    timed, queued behind a device sleep and back to back, beside its
    bound; one line printed after ``tag``.  Returns (K1 error, K4 error,
    K1's (queued ms, plain ms, bound), K4's)."""
    import numpy as np
    import torch

    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops import serve_fused as sf
    from crdt_benches_tpu_torch.ops.apply2 import PackedState
    from crdt_benches_tpu_torch.serve import journal as journal_mod
    from crdt_benches_tpu_torch.serve.pool import _fresh_row_np
    from crdt_benches_tpu_torch.traces.tensorize import PAD

    row, L, nv, c = ((_fresh_row_np(C, n_init), n_init, n_init, 0)
                     if base is None else base)
    state = PackedState(
        torch.as_tensor(journal_mod._pad_row(row, C)[None], device=dev),
        torch.tensor([L], dtype=torch.int32, device=dev),
        torch.tensor([nv], dtype=torch.int32, device=dev))
    e = st.slice_end(c, B, chars, st.n_total)
    ops = np.zeros((4, 1, 1, B), np.int32)
    ops[0], ops[3] = PAD, -1
    for i, lane in enumerate((st.kind, st.pos, st.rlen, st.slot0)):
        ops[i, 0, 0, :e - c] = lane[c:e]
    kd, pd, ld, sd = torch.from_numpy(ops).to(dev)
    args = (kd, pd, ld, sd, state.nvis)
    k1 = rr.resolve_range_rows(*args)
    k1p = rr.resolve_range_rows_plain(*args)
    err1 = max_err((*k1[0], *k1[1], k1[2]), (*k1p[0], *k1p[1], k1p[2]))
    tokens, dints, _ = k1
    inputs = sf.serve_round_inputs(tokens, dints, state.length, state.nvis)
    k4 = sf.serve_macro_fused(state, tokens, dints, inputs=inputs)
    k4p = sf.serve_macro_plain(state, tokens, dints)
    err4 = max_err(tuple(k4), tuple(k4p))
    if err1 or err4:
        fail(f"{tag}: K1 per-row error {err1}, K4 error {err4}")
    T = tokens[0].shape[2]
    k1_fn = lambda: rr.resolve_range_rows(*args)
    k4_fn = lambda: sf.serve_macro_fused(state, tokens, dints, inputs=inputs)
    k1_q, k1_b2b = queued_ms(k1_fn, 20), elapsed_ms(k1_fn, 20)
    k1_plain = elapsed_ms(lambda: rr.resolve_range_rows_plain(*args), 3)
    k4_q, k4_b2b = queued_ms(k4_fn, 20), elapsed_ms(k4_fn, 20)
    k4_plain = elapsed_ms(lambda: sf.serve_macro_plain(state, tokens, dints),
                          3)
    k1_b = bound(4 * kd.numel() * 4 + 4 + (4 * T + 3 * B + 1) * 4,
                 k1_rows_ops(*args))
    k4_b = k4_bound(bound, state.length, inputs[5], B, T, C)
    print(f"{tag} (C = {C}, {e - c} ops from cursor {c}, length {L}): K1 "
          f"per-row at (K, R, B, T) = (1, 1, {B}, {T}) equal to its plain "
          f"version, {k1_q:.4f} ms queued ({k1_b2b:.4f} back to back), "
          f"plain {k1_plain:.3f} ms, bound {k1_b[0]:.6f} ms ({k1_b[1]}); K4 "
          f"at (K, Rt, C) = (1, 1, {C}) equal, {k4_q:.4f} ms queued "
          f"({k4_b2b:.4f} back to back), plain {k4_plain:.3f} ms, bound "
          f"{k4_b[0]:.6f} ms ({k4_b[1]}), geometry (n, slice, smem bytes, "
          f"resident, active clusters) "
          f"{sf.serve_macro_launch_geometry(1, C)}", flush=True)
    return err1, err4, (k1_q, k1_plain, k1_b), (k4_q, k4_plain, k4_b)


def journal_phases(dev, bound) -> list[dict]:
    """The write-ahead journal and crash recovery on the card.

    ``[serve journal]``: SERVE_CELL at ``JOURNAL_DOCS`` documents through
    ``run_serve_bench`` with the
    journal (``JOURNAL``) and the measured recovery leg, every count set to
    0 just before the drain and read after the run: K1's per-row form and
    K4 once per dispatch of the drain and of the resumed drain, no plain
    version; the barrier counts and times, the WAL's records and bytes,
    the drain's rate, and
    the recovery's ``recover_ms``, ``redo_ms``, ``redo_ops`` and chain
    depth; a seeded sample (``JOURNAL_VERIFY_SAMPLE``, every class)
    byte-identical to the oracle after the drain and after the recovery.
    ``[serve crash]``: the same on the whole SERVE_CELL with the crash after
    ``CRASH_ROUND`` macro-rounds (a delta at chain depth 2 and a redo
    tail); every recovered document byte-identical to the oracle (the
    uninterrupted drain of ``[serve]`` verified every document too, so
    the two fleets agree document by document).  ``[serve tier
    crash]``: ``TIER_CRASH_DOCS`` docs at the ``[serve tier ab]`` tiers
    (``TIER_AB``, prefetcher on) with the same journal and crash: warm
    members restored, every doc byte-identical.  ``[journal rebuild]``:
    on ``[serve crash]``'s journal, a seeded sample of ``REBUILD_PER_CLASS``
    documents of each class rebuilt to their final cursor at K = 8, B = 64
    (``rebuild_doc``), once from their ``SnapshotBases`` base and once
    from nothing: K1's per-row form and K4 once per slice, no plain
    version, each document byte-identical to the oracle, the ms per
    document and its dispatches; on the first slice of the largest
    class's longest stream, K1's per-row form (R = 1) and K4 (K = 1, Rt =
    1) held against their plain versions and timed, queued behind a
    device sleep and back to back, beside their bounds.  Returns those two
    kernels' rows of the ``kernels`` line."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
    from crdt_benches_tpu_torch.serve import journal as journal_mod
    from crdt_benches_tpu_torch.serve.bench import run_serve_bench
    from crdt_benches_tpu_torch.serve.pool import DocPool, decode_row_np
    from crdt_benches_tpu_torch.serve.scheduler import prepare_streams
    from crdt_benches_tpu_torch.serve.workload import build_fleet

    cell = SERVE_CELL
    n_docs = cell["n_docs"]

    def bench(tag, **kw):
        """One bench run with the journal, its launches checked: K1's
        per-row form and K4 once per dispatch of the drain and of the
        resumed drain, no plain version; every doc verified after the
        recovery (and after the drain, when it was not crashed)."""
        t0 = time.perf_counter()
        rep = run_serve_bench(**{**cell, **kw}, **JOURNAL, device=dev,
                              pool_hook=zero_counts,
                              log=lambda m: print(f"[{tag}] {m}", flush=True))
        launches = read_all_counts(tag)
        rec, redo = rep["recovery"], rep["recovery_drain"]
        n = rep["dispatches"] + redo["dispatches"]
        if launches != {"resolve_range_rows": n, "serve_macro_fused": n}:
            fail(f"{tag}: launches {launches} for {rep['dispatches']} + "
                 f"{redo['dispatches']} dispatches")
        want = (kw.get("n_docs", n_docs) if rep["crashed"]
                else rep["verified_docs"])
        if not (rep["verify_ok"] and rec["verify_ok"]
                and rec["verified_docs"] == want > 0
                and set(rep["verified_per_class"]) == (
                    set() if rep["crashed"] else set(map(str,
                                                         cell["classes"])))):
            fail(f"{tag}: verify {rep['verify_ok']} on "
                 f"{rep['verified_docs']} docs, recovered "
                 f"{rec['verify_ok']} on {rec['verified_docs']}")
        return rep, rec, redo, launches, time.perf_counter() - t0

    def recovery_line(rep, rec, redo):
        return (f"recover_ms {rec['recover_ms']:.3f} (snapshot round "
                f"{rec['snapshot_round']}, chain depth {rec['chain_depth']},"
                f" {rec['chain_fallbacks']} fallbacks; restored "
                f"{rec['docs_restored']} resident, {rec['spools_restored']} "
                f"spooled, {rec['warm_restored']} warm), redo_ms "
                f"{rec['redo_ms']:.3f} for {rec['redo_ops']} redo ops over "
                f"{redo['rounds']} rounds and {redo['dispatches']} "
                f"dispatches (resumed drain's host phase s: "
                + ", ".join(f"{k} {v:.4f}"
                            for k, v in redo["phase_seconds"].items())
                + f"); journal on disk {rec['journal_disk_bytes']} B; "
                + ("all " if rep["crashed"] else "the sample's ")
                + f"{rec['verified_docs']} recovered docs byte-identical to "
                "the oracle")

    # ---- [serve journal]: the journaled drain and its recovery ----
    rep, rec, redo, launches, secs = bench(
        "serve journal", n_docs=JOURNAL_DOCS, journal_dir="auto",
        measure_recovery=True, verify_sample=JOURNAL_VERIFY_SAMPLE)
    j = rep["journal"]
    if not (j["snapshots_full"] and j["snapshots_delta"]):
        fail(f"serve journal: barriers {j}")
    lat, ph = rep["batch_latency"], rep["phase_seconds"]
    print(f"[serve journal] serve/{cell['mix']}/{JOURNAL_DOCS} journaled (a barrier"
          f" every {JOURNAL['snapshot_every']} rounds, full every "
          f"{JOURNAL['snapshot_full_every']}): {rep['patches_per_sec']:.1f} "
          f"patches/s ({rep['wall_time']:.4f} s); "
          f"{rep['rounds']} rounds, {rep['dispatches']} dispatches; "
          f"barriers {j['snapshots']} ({j['snapshots_full']} full, "
          f"{j['snapshots_delta']} delta), snapshot_time "
          f"{j['snapshot_time']:.4f} s, barrier rounds' time "
          f"{rep['barrier_time']:.4f} s over {rep['barrier_rounds']} rounds;"
          f" WAL {j['records']} records, {j['bytes']} B, "
          f"{j['segments_sealed']} segments sealed, {j['gc_segments']} "
          f"collected, {j['disk_bytes']} B on disk; steady macro-round "
          f"latency p50 {lat['p50'] * 1e3:.2f} ms, p95 {lat['p95'] * 1e3:.2f}"
          f", p99 {lat['p99'] * 1e3:.2f}; host phase s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ph.items())
          + f"; a seeded sample of {rep['verified_docs']} docs "
          f"({rep['verified_per_class']}) byte-identical to the oracle; "
          f"launches {launches}, plain calls 0; recovery leg: "
          + recovery_line(rep, rec, redo) + f" ({secs:.1f} s)", flush=True)

    jd = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    try:
        # ---- [serve crash]: stopped between two barriers, recovered ----
        rep, rec, redo, launches, secs = bench(
            "serve crash", journal_dir=jd, crash_after=CRASH_ROUND)
        if not (rep["crashed"] and rep["rounds"] == CRASH_ROUND
                and rec["chain_depth"] == 2 and rec["snapshot_round"] >= 0
                and rec["redo_ops"] > 0 and rec["chain_fallbacks"] == 0):
            fail(f"serve crash: crashed {rep['crashed']} after "
                 f"{rep['rounds']} rounds, recovery {rec}")
        print(f"[serve crash] serve/{cell['mix']}/{n_docs} stopped after "
              f"{rep['rounds']} macro-rounds ({rep['dispatches']} "
              f"dispatches, {rep['journal']['snapshots']} barriers); "
              + recovery_line(rep, rec, redo) + f"; launches {launches}, "
              f"plain calls 0 ({secs:.1f} s)", flush=True)

        # ---- [serve tier crash]: the tier A/B tiers, warm members ----
        trep, trec, tredo, tlaunches, tsecs = bench(
            "serve tier crash", n_docs=TIER_CRASH_DOCS, serve_tiers=TIER_AB,
            journal_dir="auto", crash_after=CRASH_ROUND)
        if not (trep["crashed"] and trec["warm_restored"] > 0
                and trec["redo_ops"] > 0):
            fail(f"serve tier crash: crashed {trep['crashed']}, recovery "
                 f"{trec}")
        print(f"[serve tier crash] serve/{cell['mix']}/{TIER_CRASH_DOCS} at "
              f"slots {tuple(trep['slots'])}, {TIER_AB}, prefetcher on, stopped "
              f"after {trep['rounds']} macro-rounds; "
              + recovery_line(trep, trec, tredo) + f"; launches "
              f"{tlaunches}, plain calls 0 ({tsecs:.1f} s)", flush=True)

        # ---- [journal rebuild]: rebuild_doc on [serve crash]'s journal --
        t0 = time.perf_counter()
        B, chars, K = cell["batch"], cell["batch_chars"], cell["macro_k"]
        sessions = build_fleet(n_docs, mix=cell["mix"], seed=cell["seed"],
                               arrival_span=cell["arrival_span"])
        pool = DocPool(classes=cell["classes"], slots=cell["slots"],
                       device=dev)
        try:
            streams = prepare_streams(sessions, pool, batch=B,
                                      batch_chars=chars)
            records = dict(pool.docs)
        finally:
            pool.close()
        by_class: dict[int, list[int]] = {}
        for d, r in records.items():
            by_class.setdefault(pool.class_for(r.capacity_need), []).append(d)
        rng = np.random.default_rng(cell["seed"] + 3)
        picks = {C: sorted(int(x) for x in rng.choice(
                     ids, size=min(REBUILD_PER_CLASS, len(ids)),
                     replace=False))
                 for C, ids in sorted(by_class.items())}
        if set(picks) != set(cell["classes"]) or min(
                map(len, picks.values())) < REBUILD_PER_CLASS:
            fail(f"journal rebuild: sample {picks}")
        bases = journal_mod.SnapshotBases(jd)
        base_of = {d: bases.base(d) for ids in picks.values() for d in ids}
        bases.release()

        def n_slices(st, c):
            n = 0
            while c < st.n_total:
                c = st.slice_end(c, B, chars, st.n_total)
                n += 1
            return n

        session_of = {s.doc_id: s for s in sessions}
        # each doc rebuilt from its newest snapshot base (a doc finished
        # at the barrier has nothing to replay) and from nothing (a doc
        # that no snapshot holds): the repair's two ends
        n_sl = 0
        modes = {}
        torch.cuda.synchronize()
        zero_all_counts()
        for mode in ("snapshot", "fresh"):
            per_class: dict[int, tuple[float, int, int]] = {}
            for C, ids in picks.items():
                for d in ids:
                    base = base_of[d] if mode == "snapshot" else None
                    n_sl += n_slices(streams[d], 0 if base is None
                                     else base[3])
                    t1 = time.perf_counter()
                    row, L, nv, disp = journal_mod.rebuild_doc(
                        streams[d], C, base, streams[d].n_total,
                        n_init=records[d].n_init, batch=B,
                        batch_chars=chars, macro_k=K, device=dev)
                    dt = time.perf_counter() - t1
                    if decode_row_np(row, L, nv, records[d].chars) != \
                            replay_trace(session_of[d].trace):
                        fail(f"journal rebuild: doc {d} ({mode}) differs "
                             "from the oracle")
                    ms, n, k = per_class.get(C, (0.0, 0, 0))
                    per_class[C] = (ms + dt * 1e3, n + 1, k + disp)
            modes[mode] = per_class
        rlaunches = read_all_counts("journal rebuild")
        if rlaunches != {"resolve_range_rows": n_sl,
                         "serve_macro_fused": n_sl}:
            fail(f"journal rebuild: launches {rlaunches} for {n_sl} slices")
        n_docs_r = sum(map(len, picks.values()))
        for mode, per_class in modes.items():
            ms = sum(v[0] for v in per_class.values())
            disp = sum(v[2] for v in per_class.values())
            print(f"[journal rebuild] {n_docs_r} docs ({REBUILD_PER_CLASS} "
                  f"of each class) from {'their newest snapshot base' if mode == 'snapshot' else 'nothing (cursor 0)'}"
                  f" to their final cursor at K = {K}, B = {B}: {ms:.2f} ms,"
                  f" {ms / n_docs_r:.3f} ms and {disp / n_docs_r:.2f} "
                  f"dispatches a document; by class (ms a document, "
                  f"dispatches): " + ", ".join(
                      f"C={C} {v[0] / v[1]:.3f}, {v[2]}"
                      for C, v in per_class.items())
                  + "; every doc byte-identical to the oracle", flush=True)
        print(f"[journal rebuild] launches {rlaunches} for {n_sl} slices, "
              f"plain calls 0 ({time.perf_counter() - t0:.1f} s)",
              flush=True)

        # one slice of the largest class (the first slice of its longest
        # stream): K1 per-row at R = 1 and K4 at K = 1
        top = max(picks)
        d0 = max(picks[top], key=lambda d: streams[d].n_total)
        err1, err4, k1_t, k4_t = rebuild_slice_check(
            dev, bound, streams[d0], top, None, records[d0].n_init, B, chars,
            f"[journal rebuild] one slice of doc {d0}")
    finally:
        shutil.rmtree(jd, ignore_errors=True)
    return [
        kernel_row(f"resolve_range_rows (rebuild_doc, K = 1, (R, B) = "
                   f"(1, {B}), C = {top})", "resolve_range.cu",
                   "resolve_range_pallas.py:255",
                   rlaunches["resolve_range_rows"], err1, *k1_t),
        kernel_row(f"serve_macro_fused (rebuild_doc, K = 1, (Rt, C) = "
                   f"(1, {top}))", "serve_macro.cu", "serve_fused.py:685",
                   rlaunches["serve_macro_fused"], err4, *k4_t),
    ]


#: ``[serve chaos]``'s cell, the README's chaos run: serve/mixed/512 at
#: slots (256, 64, 16, 8, 4) (SERVE_CELL otherwise: B = 64, K = 8), the
#: journal with a barrier every 4 macro-rounds, a queue cap of 512 and the
#: README's seeded fault spec; every document that is not lossy verified.
CHAOS_CELL = dict(SERVE_CELL, n_docs=512, slots=(256, 64, 16, 8, 4))
CHAOS = dict(journal_dir="auto", snapshot_every=4, snapshot_full_every=4,
             queue_cap=512,
             faults="seed=7,span=8,spool_corrupt=1,spool_truncate=1,"
                    "device_loss=1,queue_overflow=1,dup_batch=2,stall=1")
#: ``[serve chaos durability]``: the JAX bench smoke's longhaul crash
#: recipe (``tools/bench_smoke.sh``): the GC pass torn at the barrier of
#: round 2, the newest delta damaged there, the drain killed after round 4.
CHAOS_DURABILITY = dict(
    mix="mixed", n_docs=16, batch=16, macro_k=4, batch_chars=64,
    slots=(16, 6, 2, 2, 2), arrival_span=2, verify_sample=6,
    journal_dir="auto", snapshot_every=2, snapshot_full_every=2,
    wal_segment_bytes=256, longhaul=4, crash_after=4,
    faults="seed=3,crash_compact@2=1,delta_corrupt@2=1")
#: ``[serve tier chaos]``: the JAX bench smoke's tier recipe: zipf
#: arrivals, warm-tier pressure and a dropped prefetch batch, the
#: prefetcher on and the journal composing warm shadows.
CHAOS_TIER = dict(
    mix="mixed", n_docs=40, batch=16, macro_k=4, batch_chars=64,
    slots=(16, 6, 2, 2, 2), serve_tiers="hot=14,warm=6",
    arrival_dist="zipf", arrival_span=4, verify_sample=6,
    journal_dir="auto", snapshot_every=3,
    faults="seed=3,span=4,tier_evict_pressure=1,prefetch_miss=1")


def chaos_phases(dev, bound) -> list[dict]:
    """Fault injection and in-run repair on the card (``serve/faults.py``,
    the scheduler's repair paths, the bench's chaos gate).

    ``[serve chaos]``: ``CHAOS_CELL`` drained clean (the same journal and
    queue cap, no faults) and then under ``CHAOS``'s seeded plan through
    ``run_serve_bench``, every count set to 0 just before each drain.
    Each rebuild the scheduler makes (``journal.rebuild_doc``, a spool heal
    or a device-loss rebuild) is counted apart: K1's per-row form and K4
    must launch once per dispatch of the drain plus once per slice of the
    rebuilds, both in the drain and in the rebuilds, with no plain version.
    It fails unless ``faults_ok`` and ``verify_ok`` hold, or on any
    quarantine (the plan has no ``poison_rebuild``: a quarantine there
    means a rebuild raised, a kernel's failure included).  It prints the
    fired and recovered counts, recoveries, ops replayed, MTTR, degraded
    rounds, the chaos and clean rates and their ratio, and the ms of each
    repair by kind; K1's per-row form and K4 are held against their plain
    versions and timed on the first slice of the first rebuild.
    ``[serve chaos durability]`` (``CHAOS_DURABILITY``): both events fired
    and closed by the recovery leg, ``chain_fallbacks`` >= 1, the recovered
    sample byte-identical.  ``[serve tier chaos]`` (``CHAOS_TIER``): both
    tier events fired and recovered, the sample byte-identical.  Returns
    the two kernels' rows, their launches summed over the three phases."""
    import torch

    from crdt_benches_tpu_torch.serve import scheduler as sched_mod
    from crdt_benches_tpu_torch.serve.bench import run_serve_bench

    counts = {"resolve_range_rows": 0, "serve_macro_fused": 0}
    rebuilds = []  # (why, docs, ms, launches) per repair
    first = []  # the first rebuild with ops to replay: (stream, C, base,
    # n_init)

    def launches_now():
        kernels, _ = port_counters()
        return {f.__name__: f.launches for f in kernels}

    real_rebuild = sched_mod.rebuild_doc

    def rebuild_counted(stream, C, base, target, **kw):
        if not first and target > (0 if base is None else base[3]):
            first.append((stream, C, base, kw["n_init"]))
        return real_rebuild(stream, C, base, target, **kw)

    real_heal = sched_mod.FleetScheduler._heal_spool
    real_class = sched_mod.FleetScheduler._recover_class

    def timed(why, fn, docs):
        def run(self, *a):
            n_docs, before = docs(self, a), launches_now()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = launches_now()
            rebuilds.append((why, n_docs, ms, {
                k: after[k] - before[k] for k in counts}))
            return out
        return run

    def bench(tag, faults_expected=True, **kw):
        t0 = time.perf_counter()
        del rebuilds[:]
        rep = run_serve_bench(**kw, device=dev, pool_hook=zero_counts,
                              log=lambda m: print(f"[{tag}] {m}", flush=True))
        launches = read_all_counts(tag)
        in_rebuilds = {k: sum(r[3][k] for r in rebuilds) for k in counts}
        n = rep["dispatches"] + (rep["recovery_drain"] or {}).get(
            "dispatches", 0)
        want = {k: n + in_rebuilds[k] for k in counts}
        if launches != {k: v for k, v in want.items() if v}:
            fail(f"{tag}: launches {launches}, want {want} ({n} dispatches,"
                 f" {in_rebuilds} in {len(rebuilds)} rebuilds)")
        if faults_expected and not (rep["faults_ok"] and rep["verify_ok"]):
            fail(f"{tag}: faults_ok {rep['faults_ok']}, verify_ok "
                 f"{rep['verify_ok']}: {json.dumps(rep['faults'])}")
        if not rep["verify_ok"] or rep["quarantines"]:
            fail(f"{tag}: verify_ok {rep['verify_ok']}, quarantines "
                 f"{rep['quarantines']} (the plan has no poison_rebuild)")
        for k in counts:
            counts[k] += launches.get(k, 0)
        return rep, launches, in_rebuilds, time.perf_counter() - t0

    def faults_line(rep):
        f = rep["faults"]
        return (f"{f['injected']} injected, {f['recovered']} recovered, "
                f"{f['unrecovered']} unrecovered, {f['not_fired']} not fired"
                f"; events " + "; ".join(
                    f"{e['kind']} r{e['fired_round']} {e['detail']}"
                    for e in f["events"]))

    sched_mod.rebuild_doc = rebuild_counted
    sched_mod.FleetScheduler._heal_spool = timed(
        "spool heal", real_heal, lambda self, a: 1)
    sched_mod.FleetScheduler._recover_class = timed(
        "device loss", real_class,
        lambda self, a: len(self.pool.residents(a[0])))
    try:
        # ---- [serve chaos]: the README's chaos run, clean then chaos ----
        clean = {k: v for k, v in CHAOS.items() if k != "faults"}
        crep, _, _, csecs = bench("serve chaos", faults_expected=False,
                                  **CHAOS_CELL, **clean)
        rep, launches, in_rebuilds, secs = bench("serve chaos", **CHAOS_CELL,
                                                 **CHAOS)
        if not (rebuilds and first and all(in_rebuilds.values())
                and rep["lossy_docs"] == []
                and rep["verified_docs"] == CHAOS_CELL["n_docs"]):
            fail(f"serve chaos: rebuilds {rebuilds}, lossy "
                 f"{rep['lossy_docs']}, verified {rep['verified_docs']}")
        ratio = rep["patches_per_sec"] / crep["patches_per_sec"]
        by_kind: dict[str, list] = {}
        for why, docs, ms, _ in rebuilds:
            by_kind.setdefault(why, []).append((docs, ms))
        print(f"[serve chaos] serve/{CHAOS_CELL['mix']}/"
              f"{CHAOS_CELL['n_docs']} at slots {CHAOS_CELL['slots']}, "
              f"journal (a barrier every {CHAOS['snapshot_every']} rounds), "
              f"queue cap {rep['queue_cap']}, faults {CHAOS['faults']}: "
              + faults_line(rep) + f"; recoveries {rep['recoveries']}, ops "
              f"replayed {rep['ops_replayed']} over "
              f"{rep['replay_dispatches']} dispatches, MTTR rounds "
              f"{rep['mttr_rounds']}, degraded rounds "
              f"{rep['degraded_rounds']}, deferred ops "
              f"{rep['deferred_ops']} over {rep['backpressure_rounds']} "
              f"backpressure rounds, dup ops dropped "
              f"{rep['dup_ops_dropped']}, stall rounds {rep['stall_rounds']}"
              f", quarantines 0; {rep['patches_per_sec']:.1f} patches/s "
              f"({rep['wall_time']:.4f} s, {rep['rounds']} rounds, "
              f"{rep['dispatches']} dispatches) against the clean drain's "
              f"{crep['patches_per_sec']:.1f} ({crep['wall_time']:.4f} s, "
              f"{crep['rounds']} rounds) in this run: ratio {ratio:.4f}; "
              f"repairs: " + "; ".join(
                  f"{why} x{len(v)}: {sum(d for d, _ in v)} docs in "
                  f"{sum(m for _, m in v):.3f} ms ("
                  f"{sum(m for _, m in v) / max(1, sum(d for d, _ in v)):.3f}"
                  f" ms a doc)" for why, v in by_kind.items())
              + f"; host phase s: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in rep["phase_seconds"].items())
              + f"; all {rep['verified_docs']} docs byte-identical to the "
              f"oracle; launches {launches} ({in_rebuilds} in the "
              f"rebuilds), plain calls 0 ({csecs + secs:.1f} s)",
              flush=True)
        stream, C, base, n_init = first[0]
        err1, err4, k1_t, k4_t = rebuild_slice_check(
            dev, bound, stream, C, base, n_init, CHAOS_CELL["batch"],
            CHAOS_CELL["batch_chars"],
            f"[serve chaos] the first slice of the first rebuild with ops to "
            f"replay (doc "
            f"{stream.doc_id}, from "
            + ("nothing" if base is None else f"a base at cursor {base[3]}")
            + ")")

        # ---- [serve chaos durability]: torn GC, damaged delta, crash ----
        drep, dlaunches, _, dsecs = bench("serve chaos durability",
                                          **CHAOS_DURABILITY)
        rec = drep["recovery"]
        if not (drep["crashed"] and rec["chain_fallbacks"] >= 1 and all(
                e["fired"] and e["recovered"]
                for e in drep["faults"]["events"])):
            fail(f"serve chaos durability: crashed {drep['crashed']}, "
                 f"recovery {rec}, faults {drep['faults']}")
        print(f"[serve chaos durability] serve/longhaul/"
              f"{CHAOS_DURABILITY['mix']}/{CHAOS_DURABILITY['n_docs']}, "
              f"faults {CHAOS_DURABILITY['faults']}, stopped after "
              f"{drep['rounds']} macro-rounds: " + faults_line(drep)
              + f"; recover_ms {rec['recover_ms']:.3f} (snapshot round "
              f"{rec['snapshot_round']}, chain depth {rec['chain_depth']}, "
              f"{rec['chain_fallbacks']} fallbacks, "
              f"{rec['gc_segments_completed']} torn GC segments completed),"
              f" redo_ms {rec['redo_ms']:.3f} for {rec['redo_ops']} ops; "
              f"{rec['verified_docs']} recovered docs byte-identical to the "
              f"oracle; launches {dlaunches}, plain calls 0 "
              f"({dsecs:.1f} s)", flush=True)

        # ---- [serve tier chaos]: warm-tier pressure, a dropped prefetch --
        trep, tlaunches, _, tsecs = bench("serve tier chaos", **CHAOS_TIER)
        res = trep["residency"]
        if not (res["prefetch_missed"] >= 1 and all(
                e["fired"] and e["recovered"]
                for e in trep["faults"]["events"])):
            fail(f"serve tier chaos: residency {res}, faults "
                 f"{trep['faults']}")
        print(f"[serve tier chaos] serve/tier/{CHAOS_TIER['mix']}/"
              f"{CHAOS_TIER['n_docs']} ({CHAOS_TIER['serve_tiers']}, zipf, "
              f"prefetcher on), faults {CHAOS_TIER['faults']}: "
              + faults_line(trep) + f"; warm to cold "
              f"{res['warm_evictions']}, prefetch missed "
              f"{res['prefetch_missed']}, hit rate {res['hit_rate']}; "
              f"{trep['patches_per_sec']:.1f} patches/s; "
              f"{trep['verified_docs']} docs byte-identical to the oracle; "
              f"launches {tlaunches}, plain calls 0 ({tsecs:.1f} s)",
              flush=True)
    finally:
        sched_mod.rebuild_doc = real_rebuild
        sched_mod.FleetScheduler._heal_spool = real_heal
        sched_mod.FleetScheduler._recover_class = real_class
    B = CHAOS_CELL["batch"]
    return [
        kernel_row(f"resolve_range_rows (chaos rebuild slice, K = 1, "
                   f"(R, B) = (1, {B}), C = {C}; launches over the chaos "
                   f"phases)", "resolve_range.cu",
                   "resolve_range_pallas.py:255",
                   counts["resolve_range_rows"], err1, *k1_t),
        kernel_row(f"serve_macro_fused (chaos rebuild slice, K = 1, "
                   f"(Rt, C) = (1, {C}); launches over the chaos phases)",
                   "serve_macro.cu", "serve_fused.py:685",
                   counts["serve_macro_fused"], err4, *k4_t),
    ]


#: The README's streamed drain, serve/tier/mixed/262144 (its "Streaming
#: fleet construction" section: the ``mixed`` table, zipf arrivals over 32
#: rounds, ``hot=1024,warm=16384``: a fleet 256 times its device-row budget
#: and a warm tier 16 times it; the serve cell's batch, macro depth, slice
#: and kernel), built lazily.  ``python3 chip_smoke.py --stream-only
#: --stream-full`` drains it, verifying a seeded sample of 4096 docs.
STREAM_FULL = dict(SERVE_CELL, n_docs=262144, arrival_span=32,
                   arrival_dist="zipf", serve_tiers="hot=1024,warm=16384",
                   verify_sample=4096)
#: ``[serve stream]``'s cell in the default run: STREAM_FULL cut to 1,024
#: docs at ``hot=16,warm=256`` (slots (12, 3, 2, 2, 2)), a fleet 64 times
#: its device rows (2,048 docs, 128 times, until the runtime tooling phases
#: came; 4,096, 256 times, until the telemetry phases; the warm tier keeps
#: its 16:1); every doc verified.
STREAM_CELL = dict(STREAM_FULL, n_docs=1024, serve_tiers="hot=16,warm=256",
                   verify_sample=0)
#: ``[serve stream trickle]``: STREAM_CELL's tiers with 512 docs arriving
#: uniformly over 4,096 rounds (about one a macro-round of depth 8), so the
#: rotation stays shorter than the prefetcher's 32-doc look-ahead and the
#: thread builds the streams of docs about to arrive.  On STREAM_CELL the
#: selection materializes every doc the look-ahead could reach first (the
#: JAX package's policy; the same on its CPU drains), so no stream is built
#: by the thread there.
STREAM_TRICKLE = dict(STREAM_CELL, n_docs=512, arrival_span=4096,
                      arrival_dist="uniform")
#: ``[serve stream evict]``: the same recipe at 1,024 docs, ``hot=16,
#: warm=64`` (``hot`` cannot go below 2 rows a class), with record eviction.
STREAM_EVICT = dict(STREAM_CELL, n_docs=1024, serve_tiers="hot=16,warm=64")
#: ``[serve construction]``'s fleet sizes (stream rows) and the eager rows'
#: limit, each cell a fresh process on the card at the uncut recipe's tiers
#: (65,536 too until the telemetry phases came); ``--stream-full`` adds the
#: 65,536 row and the eager 16,384 and 65,536 rows.
SCALING_SIZES = (4096, 1048576)
SCALING_EAGER_LIMIT = 4096
SCALING_FULL_SIZES = (4096, 16384, 65536, 1048576)
SCALING_FULL_EAGER_LIMIT = 65536


class ConstructionTable:
    """``[serve construction]``'s ``scaling_table`` running in a thread:
    its cells are fresh processes, so they overlap the phases that run
    meanwhile.  Their log lines are kept for :meth:`result`."""

    def __init__(self, full: bool):
        import threading

        from crdt_benches_tpu_torch.serve.construction import scaling_table

        self.sizes = SCALING_FULL_SIZES if full else SCALING_SIZES
        self.limit = SCALING_FULL_EAGER_LIMIT if full else SCALING_EAGER_LIMIT
        self.logs: list[str] = []
        self.rows: list[dict] | None = None
        self.secs = 0.0
        self.error: BaseException | None = None

        def run():
            t0 = time.perf_counter()
            try:
                self.rows = scaling_table(
                    self.sizes, mix=STREAM_FULL["mix"],
                    seed=STREAM_FULL["seed"],
                    arrival_span=STREAM_FULL["arrival_span"],
                    arrival_dist=STREAM_FULL["arrival_dist"],
                    serve_tiers=STREAM_FULL["serve_tiers"],
                    eager_limit=self.limit, device="cuda", timeout=600,
                    log=self.logs.append)
            except BaseException as e:  # reported by result()
                self.error = e
            self.secs = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, name="construction")
        self.thread.start()

    def result(self) -> tuple[list[dict], list[str], float]:
        """The table's rows, its log lines and its seconds, once done."""
        self.thread.join()
        if self.error is not None:
            fail(f"serve construction: {self.error!r}")
        return self.rows, self.logs, self.secs


def stream_phases(dev, bound, full=False, tier_rate=None,
                  construction=None) -> list[dict]:
    """Streaming fleet construction and drained-doc record eviction on the
    card (``serve/scheduler.py LazyStreams``, genesis residency, the
    prefetcher's construct kind, ``DocPool.gc_drained_docs``,
    ``serve/construction.py``).

    ``[serve stream]``: ``STREAM_CELL`` (``STREAM_FULL`` when ``full``)
    through ``run_serve_bench(stream=True)`` with the prefetcher on, every
    count set to 0 just before the drain and read just after: K1's per-row
    form and K4 once per dispatch, no plain version; every doc materialized
    (``materialized_docs`` and ``released_docs`` the fleet, no genesis doc
    left), no prefetch payload back with an error; every document (a sample
    when ``full``) byte-identical to the oracle.  ``[serve stream
    trickle]``: ``STREAM_TRICKLE`` the same way, where at least one stream
    must be built by the prefetch thread.  The drain keeps the first
    operands of each (class, rows) pair it launches (a host copy of the op
    arrays and a device copy of the tier's rows, taken before the step) for
    ``[serve stream kernels]`` (:func:`kept_kernel_check`).  It prints the
    ``construction`` and ``residency`` blocks, the rate (against
    ``tier_rate``, ``[serve tier]``'s in this run, when it ran) and the
    construct prefetch's share of first admissions.  ``[serve stream
    evict]``: ``STREAM_EVICT`` with record eviction: records reclaimed, the
    records left at most the hot rows plus the warm budget plus one GC batch
    of 32, every surviving record's document byte-identical to the oracle.
    ``[serve construction]``: ``scaling_table`` on the card, a fresh process
    a cell, from ``construction`` (a :class:`ConstructionTable` started
    earlier) or started here; any error row fails.  Returns the two
    kernels' rows for the streamed drain."""
    from crdt_benches_tpu_torch.serve.bench import (
        parse_tier_spec,
        run_serve_bench,
    )

    # ---- [serve stream]: the streamed drain through the bench ----
    cell = STREAM_FULL if full else STREAM_CELL
    label = f"serve/tier/{cell['mix']}/{cell['n_docs']} streamed"
    t0 = time.perf_counter()
    keep: dict[tuple[int, int], tuple] = {}
    payloads = {"construct": 0, "construct errors": 0, "spool": 0,
                "spool errors": 0}

    def arm(p):
        """Each (class, rows) pair's first operands kept; the prefetch
        payloads tallied by kind; counts to 0."""
        keep_tier_operands(keep)(p)
        pf = p.prefetcher
        if pf is None:
            fail("serve stream: the tiered pool has no prefetcher")
        drain = pf.drain

        def tallied():
            out = drain()
            for x in out:
                payloads[x["kind"]] += 1
                if x["error"] is not None:
                    payloads[x["kind"] + " errors"] += 1
            return out

        pf.drain = tallied
        zero_counts()

    def streamed(tag, cfg, hook):
        """One streamed drain through the bench, checked as the docstring
        says; returns its report and launches."""
        r = run_serve_bench(**cfg, stream=True, device=dev, pool_hook=hook,
                            log=lambda m: print(f"[{tag}] {m}", flush=True))
        got = read_all_counts(f"{tag} drain")
        nd = r["dispatches"]
        if got != {"resolve_range_rows": nd, "serve_macro_fused": nd}:
            fail(f"{tag} drain: launches {got} for {nd} dispatches")
        cc, docs = r["construction"], cfg["n_docs"]
        if not (cc["mode"] == "stream" and cc["materialized_docs"] == docs
                and cc["released_docs"] == docs
                and cc["genesis_docs_end"] == 0
                and not payloads["construct errors"]
                and not payloads["spool errors"]):
            fail(f"{tag} drain: construction {cc}, payloads {payloads}")
        if not (r["verify_ok"] and r["lossy_docs"] == [] and (
                cfg["verify_sample"] or r["verified_docs"] == docs)):
            fail(f"{tag} drain: verify {r['verify']} ok {r['verify_ok']} "
                 f"on {r['verified_docs']} docs")
        return r, got

    rep, launches = streamed("serve stream", cell, arm)
    n = rep["dispatches"]
    c, res = rep["construction"], rep["residency"]
    share = c["prefetch_built"] / c["materialized_docs"]
    lat = rep["batch_latency"]
    print(f"[serve stream] {label} ({cell['serve_tiers']}, slots "
          f"{tuple(rep['slots'])}, zipf arrivals over "
          f"{cell['arrival_span']} rounds, prefetcher on): "
          f"{rep['patches_per_sec']:.1f} patches/s ({rep['patches']} "
          f"patches in {rep['wall_time']:.4f} s)"
          + (f", {rep['patches_per_sec'] / tier_rate:.4f} of [serve "
             f"tier]'s {tier_rate:.1f} in this run" if tier_rate else "")
          + f"; macro-round latency p50 {lat['p50'] * 1e3:.2f} ms, p99 "
          f"{lat['p99'] * 1e3:.2f}; {rep['rounds']} rounds, {n} "
          f"dispatches; construction {c['construction_ms']:.1f} ms, rss "
          f"after {c['rss_after_construction_bytes'] / 2**20:.1f} MiB, peak "
          f"{c['peak_rss_bytes'] / 2**20:.1f} MiB; {c['prefetch_built']} of "
          f"{c['materialized_docs']} first admissions built by the prefetch "
          f"thread (share {share:.4f}); payloads {payloads}; host phase s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rep["phase_seconds"].items())
          + f"; verify {rep['verify']} ok on {rep['verified_docs']} docs "
          f"({rep['verify_seconds']:.1f} s); launches {launches}, plain "
          f"calls 0 ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[serve stream] construction: {json.dumps(c)}", flush=True)
    print(f"[serve stream] residency: {json.dumps(res)}", flush=True)
    kk = kept_kernel_check("serve stream kernels", label, keep,
                           cell["classes"], dev, bound)
    keep.clear()

    # ---- [serve stream trickle]: the construct prefetch at work ----
    t0 = time.perf_counter()
    for k in payloads:
        payloads[k] = 0
    trep, tlaunches = streamed("serve stream trickle", STREAM_TRICKLE, arm)
    tc = trep["construction"]
    if not (tc["prefetch_built"] > 0 and payloads["construct"] > 0):
        fail(f"serve stream trickle: construction {tc}, payloads {payloads}")
    print(f"[serve stream trickle] serve/tier/{STREAM_TRICKLE['mix']}/"
          f"{STREAM_TRICKLE['n_docs']} streamed, uniform arrivals over "
          f"{STREAM_TRICKLE['arrival_span']} rounds "
          f"({STREAM_TRICKLE['serve_tiers']}): {tc['prefetch_built']} of "
          f"{tc['materialized_docs']} first admissions built by the prefetch "
          f"thread (share {tc['prefetch_built'] / tc['materialized_docs']:.4f}"
          f"), payloads {payloads}, prefetch wasted "
          f"{trep['residency']['prefetch_wasted']}; "
          f"{trep['patches_per_sec']:.1f} patches/s, {trep['rounds']} rounds;"
          f" every doc byte-identical to the oracle; launches {tlaunches}, "
          f"plain calls 0 ({time.perf_counter() - t0:.1f} s)", flush=True)
    del keep

    # ---- [serve stream evict]: record eviction on a streamed drain ----
    t0 = time.perf_counter()
    ev_slots, ev_warm = parse_tier_spec(STREAM_EVICT["serve_tiers"],
                                        STREAM_EVICT["slots"])

    erep = run_serve_bench(**STREAM_EVICT, stream=True, record_evict=True,
                           device=dev, pool_hook=zero_counts,
                           log=lambda m: print(f"[serve stream evict] {m}",
                                               flush=True))
    elaunches = read_all_counts("serve stream evict drain")
    en = erep["dispatches"]
    ec = erep["construction"]
    rec_bound = sum(ev_slots) + ev_warm + 32
    if elaunches != {"resolve_range_rows": en, "serve_macro_fused": en}:
        fail(f"serve stream evict: launches {elaunches} for {en} dispatches")
    if not (ec["spool_gc_docs"] > 0 and ec["records_end"] <= rec_bound
            and ec["records_end"] + ec["spool_gc_docs"]
            == STREAM_EVICT["n_docs"] and erep["verify_ok"]
            and erep["lossy_docs"] == []
            and erep["verified_docs"] == ec["records_end"]
            and ec["genesis_docs_end"] == 0):
        fail(f"serve stream evict: construction {ec}, bound {rec_bound}, "
             f"verify_ok {erep['verify_ok']} on {erep['verified_docs']}")
    print(f"[serve stream evict] serve/tier/{STREAM_EVICT['mix']}/"
          f"{STREAM_EVICT['n_docs']} streamed ({STREAM_EVICT['serve_tiers']},"
          f" slots {ev_slots}) with record eviction: {ec['spool_gc_docs']} "
          f"drained docs' records and spool members reclaimed, "
          f"{ec['records_end']} records left (bound {rec_bound}: hot rows "
          f"{sum(ev_slots)} + warm {ev_warm} + one GC batch of 32), all "
          f"{erep['verified_docs']} byte-identical to the oracle; "
          f"{erep['patches_per_sec']:.1f} patches/s, {erep['rounds']} rounds;"
          f" launches {elaunches}, plain calls 0 "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- [serve construction]: the fleet-size table, on the card ----
    t0 = time.perf_counter()
    table = construction or ConstructionTable(full)
    rows, logs, secs = table.result()
    for m in logs:
        print(f"[serve construction] {m}", flush=True)
    sizes, limit = table.sizes, table.limit
    bad = [r for r in rows if "error" in r]
    want = {(n, "stream") for n in sizes} | {
        (n, "eager") for n in sizes if n <= limit}
    if bad or {(r["n_docs"], r["mode"]) for r in rows} != want:
        fail(f"serve construction: rows {rows}")
    print(f"[serve construction] {STREAM_FULL['mix']}, zipf over "
          f"{STREAM_FULL['arrival_span']} rounds, "
          f"{STREAM_FULL['serve_tiers']}, a fresh process a cell, the pool "
          f"on the card: " + "; ".join(
              f"{r['mode']} {r['n_docs']}: {r['construction_ms']:.1f} ms, "
              f"peak rss {r['peak_rss_bytes'] / 2**20:.1f} MiB, rss before "
              f"{r['rss_before_bytes'] / 2**20:.1f} MiB and after "
              f"{r['rss_after_bytes'] / 2**20:.1f} MiB, genesis "
              f"{r['genesis_docs']}" for r in rows)
          + f" ({secs:.1f} s in a thread started "
          + ("with the script" if construction else "here")
          + f", {time.perf_counter() - t0:.1f} s waited here)", flush=True)
    return kept_kernel_rows(
        f"{label}; launches over the three streamed drains", kk,
        {k: launches[k] + tlaunches[k] + elaunches[k] for k in launches})


#: The K5 worst cases (each also in ``tests/test_torch_resolve_unit.py``):
#: inserts at 0 move the whole live list every op; deletes at 0 grow a run
#: of zero-length tokens at the head and run past the end of a short
#: document; alternating ends land on the FREE sentinel every other op.
K5_WORST = ("ins_at_0", "del_at_0", "alternate")
#: ``[k5 R=8]`` holds one sveltecomponent batch in this many against the
#: plain version, which runs on the CPU and sets the phase's time
K5_STRIDE = 32


#: ``[serve telemetry chaos]``: the JAX bench smoke's chaos recipe under the
#: soak detectors (``tools/bench_smoke.sh --family serve-faults``): a
#: pinned 800 ms stall against a 250 ms watchdog with the other kinds, the
#: journal and a queue cap, one drain.  The stall is pinned at round 12,
#: not the recipe's 7: round 7's stall fires in the third macro-round
#: (base round 8), a snapshot-barrier round, which the watchdog exempts, so
#: it trips nothing in either package.
TELEMETRY_CHAOS = dict(
    mix="mixed", n_docs=24, batch=16, macro_k=4, batch_chars=64,
    slots=(16, 6, 2, 2, 2), arrival_span=2, verify_sample=6,
    journal_dir="auto", snapshot_every=3, queue_cap=128,
    faults="seed=5,span=5,stall_ms=800,spool_corrupt=1,device_loss=1,"
           "queue_overflow=1,dup_batch=1,stall@12=1", reqtrace_samples=16)
#: ``[serve soak]``: the JAX bench smoke's soak recipe (``--family
#: serve-soak``) for 5 s instead of 25 (10 until the replication and
#: reshard phases came): the status server, the
#: time-series, an SLO and request tracing, re-seeded drains back to back.
SOAK = dict(mix="mixed", n_docs=24, batch=16, macro_k=4, batch_chars=64,
            slots=(16, 6, 2, 2, 2), arrival_span=2, verify_sample=6,
            slo_spec="default=p99:60000", reqtrace_samples=16)
SOAK_SECONDS = 5.0
#: a Prometheus text exposition sample line: name, labels, number
_PROM_LINE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="'
              r'([^"\\]|\\.)*",?)*\})? -?([0-9.eE+-]+|NaN|\+Inf)$')


class Scraper:
    """A thread that GETs ``/healthz``, ``/status.json`` and ``/metrics``
    of a status server over and over until stopped.  A pass counts as mid-
    run when ``/status.json`` reads ``phase`` "serving" before and after
    it.  It records the passes, the answers mid-run by endpoint, the rounds
    ``/status.json`` reported (they must never go back within a drain) and
    any error or unparsable ``/metrics`` line."""

    def __init__(self, port: int):
        import re
        import threading

        self.base = f"http://127.0.0.1:{port}"
        self.mid = {"/healthz": 0, "/status.json": 0, "/metrics": 0}
        self.passes = 0
        self.rounds: list[int] = []
        self.errors: list[str] = []
        self.closed = False  # the server went away (its run ended)
        self._line = re.compile(_PROM_LINE)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=5) as r:
            return r.status, r.read()

    def _status(self):
        s = json.loads(self._get("/status.json")[1])
        if "rounds" in s:
            self.rounds.append(s["rounds"])
        return s.get("phase") == "serving"

    def _run(self):
        while not self._stop.is_set():
            try:
                before = self._status()
                h, _ = self._get("/healthz")
                m, text = self._get("/metrics")
                bad = [ln for ln in text.decode().splitlines()
                       if ln and not ln.startswith("#")
                       and not self._line.match(ln)]
                if bad:
                    self.errors.append(f"/metrics lines {bad[:3]}")
                if before and self._status():
                    self.mid["/status.json"] += 1
                    self.mid["/healthz"] += h == 200
                    self.mid["/metrics"] += m == 200
                self.passes += 1
            except (ConnectionError, OSError) as e:
                if isinstance(getattr(e, "reason", e), ConnectionError):
                    self.closed = True  # the run closed its server: done
                    return
                self.errors.append(f"{type(e).__name__}: {e}")
            except Exception as e:  # noqa: BLE001 (reported by the phase)
                self.errors.append(f"{type(e).__name__}: {e}")
            self._stop.wait(0.25)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def check(self, tag: str, one_drain: bool = True) -> None:
        """Fail unless every endpoint answered mid-run and nothing errored,
        and for ``one_drain`` unless the reported rounds never went
        back (a soak's drains each restart them)."""
        back = one_drain and self.rounds != sorted(self.rounds)
        if self.errors or back or not all(self.mid.values()):
            fail(f"{tag}: scrapes mid-run {self.mid} of {self.passes} "
                 f"passes, errors {self.errors[:4]}, rounds "
                 f"{self.rounds[:16]}")


def telemetry_phases(dev, bound, serve_ref=None) -> list[dict]:
    """The telemetry (``obs/``) on the card.

    ``[serve telemetry]``: ``SERVE_CELL`` through ``run_serve_bench`` with
    everything armed (the span tracer, the time-series stream, the status
    server on an ephemeral port with a :class:`Scraper` on it, request
    tracing of 16 samples, the SLO ``default=p99:60000``, the flight
    recorder), every count set to 0 just before the drain and read just
    after.  It fails unless every document equals the oracle; the drain's
    rounds, device rounds, dispatches, range and unit ops, evictions,
    restores, promotions, admissions and K1 per-row and K4 launches equal
    ``[serve]``'s (``serve_ref``: its report and launches; with
    ``--telemetry-only`` a plain drain of the cell here); no plain version
    ran; the trace passes the port's validator; the windows cover every
    round; every endpoint answered mid-run, ``/metrics`` as Prometheus text
    and the rounds never going back; the ``doc_drain_latency`` counts add
    up to the fleet; the flight recorder stayed quiet.  It prints the armed
    rate over the plain one.  The drain's first operands of each (class,
    rows) pair go through :func:`kept_kernel_check`.
    ``[serve telemetry chaos]`` (``TELEMETRY_CHAOS``): a stuck round fires
    and clears, none is left active, the flight recorder dumped with an
    ``anomaly:stuck_round`` reason, the dump validates and holds the
    stalled round and request traces, ``faults_ok`` and the verify hold.
    ``[serve soak]`` (``SOAK``, ``SOAK_SECONDS``): every drain verified, a
    scrape of the three endpoints mid-run, no anomaly fired.  Returns the
    two kernels' rows, their launches summed over the three phases."""
    import shutil
    import tempfile

    from crdt_benches_tpu_torch.obs.flight import validate_flight_file
    from crdt_benches_tpu_torch.obs.status import render_prometheus
    from crdt_benches_tpu_torch.obs.trace import validate_trace_file
    from crdt_benches_tpu_torch.serve.bench import (
        build_telemetry,
        run_serve_bench,
        run_serve_soak,
    )

    cell = SERVE_CELL
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    counts = {"resolve_range_rows": 0, "serve_macro_fused": 0}
    keep: dict[tuple[int, int], tuple] = {}

    try:
        t0 = time.perf_counter()
        if serve_ref is None:
            ref = run_serve_bench(**cell, device=dev, pool_hook=zero_counts,
                                  log=lambda m: None)
            serve_ref = (ref, read_all_counts("serve telemetry reference"))
            print(f"[serve telemetry] the plain reference drain of "
                  f"serve/{cell['mix']}/{cell['n_docs']}: "
                  f"{ref['patches_per_sec']:.1f} patches/s "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        ref, ref_launches = serve_ref
        # ---- [serve telemetry]: the cell with everything armed ----
        t0 = time.perf_counter()
        flight = os.path.join(tmp, "flight.json")
        trace = os.path.join(tmp, "trace.json")
        telemetry = build_telemetry(
            status_port=0, timeseries_path=os.path.join(tmp, "ts.jsonl"),
            flight_path=flight,
            log=lambda m: print(f"[serve telemetry] {m}", flush=True))
        scraper = Scraper(telemetry.status.port)
        try:
            rep = run_serve_bench(
                **cell, device=dev,
                pool_hook=keep_tier_operands(keep, zero_counts),
                trace_path=trace, telemetry=telemetry, reqtrace_samples=16,
                slo_spec="default=p99:60000",
                log=lambda m: print(f"[serve telemetry] {m}", flush=True))
            launches = read_all_counts("serve telemetry drain")
        finally:
            scraper.stop()
            telemetry.close()
        add_counts(counts, launches)
        scraper.check("serve telemetry")
        same = ("rounds", "device_rounds", "dispatches", "range_ops",
                "unit_ops", "evictions", "restores", "promotions",
                "admissions")
        differ = {k: (rep[k], ref[k]) for k in same if rep[k] != ref[k]}
        if launches != ref_launches:
            differ["launches"] = (launches, ref_launches)
        if differ:
            fail(f"serve telemetry: differs from [serve] in {differ}")
        if not (rep["verify_ok"] and rep["verify"] == "all"
                and rep["verified_docs"] == cell["n_docs"]):
            fail(f"serve telemetry: verify {rep['verify']} ok "
                 f"{rep['verify_ok']} on {rep['verified_docs']} docs")
        ts = rep["timeseries"]
        drained = sum(v["count"] for v in rep["doc_drain_latency"].values())
        problems = []
        if not (rep["trace_valid"] and validate_trace_file(trace) == []):
            problems.append("trace invalid")
        if not (ts["rounds_seen"] == rep["rounds"] == sum(
                w["rounds"] for w in ts["windows"])
                and not ts["dropped_windows"]):
            problems.append(f"windows cover {ts['rounds_seen']} of "
                            f"{rep['rounds']} rounds")
        if drained != cell["n_docs"]:
            problems.append(f"doc_drain_latency counts {drained}")
        if rep["flight"]["dumps"] or os.path.exists(flight):
            problems.append(f"flight dumped {rep['flight']}")
        bad = [ln for ln in render_prometheus(rep["metrics"]).splitlines()
               if ln and not ln.startswith("#")
               and not __import__("re").match(_PROM_LINE, ln)]
        if bad:
            problems.append(f"/metrics text {bad[:3]}")
        if problems:
            fail(f"serve telemetry: {problems}")
        lat = rep["batch_latency"]
        n_events = len(json.load(open(trace))["traceEvents"])
        print(f"[serve telemetry] serve/{cell['mix']}/{cell['n_docs']} armed: "
              f"{rep['patches_per_sec']:.1f} patches/s, "
              f"{rep['patches_per_sec'] / ref['patches_per_sec']:.4f} of "
              f"[serve]'s {ref['patches_per_sec']:.1f} in this run; "
              f"macro-round p50 {lat['p50'] * 1e3:.2f} ms, p95 "
              f"{lat['p95'] * 1e3:.2f}, p99 {lat['p99'] * 1e3:.2f} "
              f"(histogram); {rep['rounds']} rounds, {rep['dispatches']} "
              f"dispatches, counters and launches {launches} equal "
              f"[serve]'s, plain calls 0; every doc byte-identical to the "
              f"oracle; trace valid ({n_events} events); "
              f"{len(ts['windows'])} windows cover all rounds; scrapes "
              f"mid-run {scraper.mid} of {scraper.passes} passes, rounds "
              f"never back; reqtrace {rep['reqtrace']['requests_closed']} "
              f"closed; slo compliance "
              f"{rep['slo']['classes']['default']['compliance']:.4f}; "
              f"flight quiet; host phase s: "
              + ", ".join(f"{k} {v:.4f}"
                          for k, v in rep["phase_seconds"].items())
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        label = f"serve telemetry, serve/{cell['mix']}/{cell['n_docs']}"
        kk = kept_kernel_check("serve telemetry kernels", label, keep,
                               cell["classes"], dev, bound)
        per_phase = {"serve telemetry": dict(launches)}

        # ---- [serve telemetry chaos]: the stall under the watchdog ----
        t0 = time.perf_counter()
        flight = os.path.join(tmp, "chaos_flight.json")
        crep = run_serve_soak(
            0.0, watchdog_s=0.25, flight_path=flight, device=dev,
            pool_hook=zero_counts, **TELEMETRY_CHAOS,
            log=lambda m: print(f"[serve telemetry chaos] {m}", flush=True))
        launches = read_all_counts("serve telemetry chaos")
        add_counts(counts, launches)
        per_phase["serve telemetry chaos"] = dict(launches)
        an, fb = crep["anomalies"], crep["flight"]
        stuck = [e for e in an["events"] if e["kind"] == "stuck_round"]
        dump = json.load(open(flight)) if os.path.exists(flight) else None
        problems = []
        if not (stuck and all(e["cleared"] for e in stuck)
                and an["uncleared"] == 0):
            problems.append(f"watchdog {an}")
        if not (fb["dumps"] >= 1 and any(
                r.startswith("anomaly:stuck_round") for r in fb["reasons"])):
            problems.append(f"flight {fb}")
        if dump is None or validate_flight_file(flight):
            problems.append("flight dump invalid")
        elif not (any(r["round"] >= stuck[0]["round"]
                      for r in dump["rounds"]) and dump["requests"]):
            problems.append("dump rounds (round, s) "
                            f"{[(r['round'], r['seconds']) for r in dump['rounds']]}"
                            f", {len(dump['requests'])} request traces")
        if not (crep["faults_ok"] and crep["verify_ok"]):
            problems.append(f"faults_ok {crep['faults_ok']} verify_ok "
                            f"{crep['verify_ok']}")
        if launches.get("resolve_range_rows", 0) < crep["dispatches"] or (
                launches.get("resolve_range_rows")
                != launches.get("serve_macro_fused")):
            problems.append(f"launches {launches} for {crep['dispatches']} "
                            "dispatches")
        if problems:
            fail(f"serve telemetry chaos: {problems}")
        stall = max(stuck, key=lambda e: e["value"])
        print(f"[serve telemetry chaos] stall -> stuck_round at round "
              f"{stall['round']} ({stall['value'] * 1e3:.1f} ms against "
              f"{stall['threshold'] * 1e3:.0f}) -> cleared at round "
              f"{stall['cleared_round']}; {an['fired']} fired "
              f"({[(e['round'], round(e['value'] * 1e3, 1)) for e in stuck]}"
              f"), 0 left active; flight dump ({dump['reason']!r}, dump "
              f"{dump['dump_index']}) valid, holding the fire's round, "
              f"{len(dump['rounds'])} rounds + {len(dump['requests'])} "
              f"request traces; faults_ok, verify_ok; "
              f"{crep['faults']['injected']} events; launches {launches} "
              f"({crep['dispatches']} dispatches, the rest rebuilds) "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

        # ---- [serve soak]: drains back to back under the detectors ----
        t0 = time.perf_counter()
        soak = {}

        def soak_log(m):
            if "status server on http://127.0.0.1:" in m and not soak:
                soak["scraper"] = Scraper(int(m.split(":")[-1].split()[0]))
            if "soak" in m or "status server" in m:  # not every drain's
                print(f"[serve soak] {m}", flush=True)

        try:
            srep = run_serve_soak(
                SOAK_SECONDS, status_port=0,
                timeseries_path=os.path.join(tmp, "soak.jsonl"),
                device=dev, pool_hook=zero_counts, log=soak_log, **SOAK)
            launches = read_all_counts("serve soak (the last drain)")
        finally:
            if "scraper" in soak:
                soak["scraper"].stop()
        add_counts(counts, launches)
        per_phase["serve soak (last drain)"] = dict(launches)
        if "scraper" not in soak:
            fail("serve soak: no status server started")
        soak["scraper"].check("serve soak", one_drain=False)
        an = srep["anomalies"]
        if not (srep["verify_ok"] and srep["anomalies_ok"]
                and an["fired"] == 0):
            fail(f"serve soak: verify_ok {srep['verify_ok']}, "
                 f"{srep['iterations']} drains, anomalies {an}")
        ts = srep["timeseries"]
        print(f"[serve soak] {srep['iterations']} drains of "
              f"serve/{SOAK['mix']}/{SOAK['n_docs']} in "
              f"{time.perf_counter() - t0:.1f} s, every drain verified; "
              f"{len(ts['windows'])} windows over {ts['rounds_seen']} rounds; "
              f"scrapes mid-run {soak['scraper'].mid} of "
              f"{soak['scraper'].passes} passes; anomalies 0 fired; "
              f"launches by phase {per_phase}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return kept_kernel_rows(
        "serve telemetry phases; the launches of [serve telemetry], [serve "
        "telemetry chaos] and the last drain of [serve soak]", kk, counts)


#: ``[serve repl]``: the README's replicated cell serve/repl/mixed/512x4
#: uncut: 512 logical docs of the ``mixed`` table, 4 writers each (2,048
#: replica rows), seed 0, arrivals over 8 rounds, the serve cell's slots,
#: B = 64, K = 8, 256 chars a slice, turns of 64 ops, the fused kernel.
REPL_CELL = dict(mix="mixed", n_docs=512, writers=4, batch=64, macro_k=8,
                 batch_chars=256, classes=(256, 1024, 4096, 8192, 49152),
                 slots=(2048, 512, 128, 32, 16), arrival_span=8, seed=0,
                 turn_ops=64, serve_kernel="fused")
#: ``[serve repl chaos]``: the JAX bench smoke's replicated chaos leg
#: (``tools/bench_smoke.sh`` ``--family serve-faults``): 12 docs x 2
#: writers, a journal with a barrier every 4 rounds, a partition and a
#: reorder.
REPL_CHAOS = dict(REPL_CELL, n_docs=12, writers=2, batch=16, macro_k=4,
                  batch_chars=64, slots=(16, 6, 2, 2, 2), arrival_span=2,
                  turn_ops=16, journal_dir="auto", snapshot_every=4,
                  faults="seed=7,span=4,replica_partition=1,merge_reorder=1")
#: The macro-rounds after which ``[serve repl chaos]``'s journaled fleet
#: is stopped before ``recover_replicated_fleet`` resumes it.
REPL_CRASH_ROUNDS = 8
#: ``[serve reshard]``: the README's reshard acceptance recipe uncut:
#: serve/mixed/4096 on 8 logical shards, the journal with a barrier every
#: 8 rounds (every 4th full), ``shrink:8:6@16,batch=64`` under
#: ``reshard_crash@16``, a seeded verify sample of 64 (65 docs: 13 a class).
RESHARD_CELL = dict(SERVE_CELL, journal_dir="auto", snapshot_every=8,
                    snapshot_full_every=4, verify_sample=64,
                    reshard_spec="shrink:8:6@16,batch=64",
                    faults="seed=7,reshard_crash@16=1")
#: The ``reshard`` block's counts ``[serve reshard]`` must equal, as the
#: JAX package's CPU run of the same recipe wrote them.
RESHARD_ARTIFACT = os.path.join(REPO, "bench_results",
                                "serve_reshard_accept.json")
RESHARD_COUNTS = ("migrated", "evicted", "deferred_lanes", "deferred_ops",
                  "resumes", "begin_round", "commit_round", "rounds_active")
#: ``[serve reshard crash]``: the JAX bench smoke's reshard leg (``--family
#: serve-reshard``): 24 docs on 2 logical shards, ``shrink:2:1@4,batch=2``
#: under ``reshard_crash@4``, the status server and an SLO.
RESHARD_SMOKE = dict(
    mix="mixed", n_docs=24, batch=16, macro_k=4, batch_chars=64,
    slots=(16, 6, 2, 2, 2), arrival_span=2, verify_sample=6,
    journal_dir="auto", snapshot_every=3,
    reshard_spec="shrink:2:1@4,batch=2", faults="seed=5,reshard_crash@4=1")
#: The macro-rounds after which ``[serve reshard crash]``'s second drain
#: stops: the reshard began at round 4 and is mid-move (manifest
#: committed, no commit record).
RESHARD_CRASH_ROUNDS = 3



def repl_phases(dev, bound) -> list[dict]:
    """Multi-writer replication (``serve/replicate/``) on the card.

    ``[serve repl]`` (``REPL_CELL``): ``run_serve_repl_bench``, every count
    set to 0 just before the drain and read just after: K1's per-row form
    and K4 once per dispatch, no plain version; all 2,048 replicas
    byte-identical to the oracle and the RA-linearizability axioms on the
    16 sampled histories; remote:local 3.00 (4 writers).  Its first
    operands of each (class, rows) pair go through
    :func:`kept_kernel_check`.  ``[serve repl chaos]`` (``REPL_CHAOS``):
    both replication faults fire and recover and every replica converges;
    then the same fleet journaled, stopped after ``REPL_CRASH_ROUNDS``
    macro-rounds and resumed by ``recover_replicated_fleet`` on fresh pools
    to convergence, the RA axioms holding on the recovered histories.
    Returns the two kernels' rows, their launches summed over the drains."""
    import shutil
    import tempfile

    from crdt_benches_tpu_torch.serve.journal import OpJournal
    from crdt_benches_tpu_torch.serve.pool import DocPool
    from crdt_benches_tpu_torch.serve.replicate import (
        ReplicatedScheduler,
        build_writer_groups,
        check_convergence,
        check_ra_linearizability,
        recover_replicated_fleet,
    )
    from crdt_benches_tpu_torch.serve.replicate.bench import (
        run_serve_repl_bench,
    )
    from crdt_benches_tpu_torch.serve.scheduler import prepare_streams
    from crdt_benches_tpu_torch.serve.workload import build_fleet

    counts = {"resolve_range_rows": 0, "serve_macro_fused": 0}
    keep: dict[tuple[int, int], tuple] = {}

    def once_a_dispatch(tag, launches, dispatches):
        if not (launches.get("resolve_range_rows") == dispatches
                == launches.get("serve_macro_fused")):
            fail(f"{tag}: launches {launches} for {dispatches} dispatches")

    cell = REPL_CELL
    t0 = time.perf_counter()
    rep = run_serve_repl_bench(
        **cell, device=dev, pool_hook=keep_tier_operands(keep, zero_counts),
        log=lambda m: print(f"[serve repl] {m}", flush=True))
    launches = read_all_counts("serve repl")
    add_counts(counts, launches)
    once_a_dispatch("serve repl", launches, rep["dispatches"])
    rb, conv = rep["replication"], rep["convergence"]
    rows = cell["n_docs"] * cell["writers"]
    if not (rep["verify_ok"] and rep["ra_ok"]
            and conv["replicas_checked"] == rows
            and conv["ra_groups_checked"] == 16):
        fail(f"serve repl: verify {rep['verify_ok']} ra {rep['ra_ok']} "
             f"{conv}")
    ratio = rb["merged_ops"] / rb["local_ops"]
    print(f"[serve repl] serve/repl/{cell['mix']}/{cell['n_docs']}x"
          f"{cell['writers']}: {rep['patches_per_sec']:.1f} replica-patches/s"
          f", merge {rep['merge_unit_ops_per_sec']:.1f} unit-ops/s over "
          f"{rep['wall_time']:.3f} s, {rep['rounds']} rounds, "
          f"{rep['dispatches']} dispatches; merged {rb['merged_ops']} remote "
          f"/ {rb['local_ops']} local range ops (remote:local {ratio:.4f}), "
          f"{rb['merged_unit_ops']} merged unit ops; broadcast "
          f"{rb['broadcast_bytes']} B over {rb['broadcast_deliveries']} "
          f"deliveries of {rb['broadcast_blocks']} blocks; divergence max "
          f"{rb['divergence_depth_max']} blocks, convergence rounds max "
          f"{rb['convergence_rounds_max']} mean "
          f"{rb['convergence_rounds_mean']:.4f}; all {rows} replicas "
          f"byte-identical to the oracle, RA axioms hold on "
          f"{conv['ra_groups_checked']} histories; launches {launches}, "
          f"plain calls 0; macro-round p50 "
          f"{rep['batch_latency']['p50'] * 1e3:.2f} ms p99 "
          f"{rep['batch_latency']['p99'] * 1e3:.2f}; evictions "
          f"{rep['evictions']}, restores {rep['restores']}, promotions "
          f"{rep['promotions']}; host phase s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rep["phase_seconds"].items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    label = f"serve repl, serve/repl/{cell['mix']}/{cell['n_docs']}x4"
    kk = kept_kernel_check("serve repl kernels", label, keep,
                           cell["classes"], dev, bound)

    # ---- [serve repl chaos]: the smoke's chaos leg, then a crash ----
    t0 = time.perf_counter()
    crep = run_serve_repl_bench(
        **REPL_CHAOS, device=dev, pool_hook=zero_counts,
        log=lambda m: print(f"[serve repl chaos] {m}", flush=True))
    launches = read_all_counts("serve repl chaos")
    add_counts(counts, launches)
    once_a_dispatch("serve repl chaos", launches, crep["dispatches"])
    evs = {e["kind"]: e for e in crep["faults"]["events"]}
    if not (crep["verify_ok"] and crep["ra_ok"] and crep["faults_ok"]
            and all(evs[k]["fired"] and evs[k]["recovered"] for k in
                    ("replica_partition", "merge_reorder"))):
        fail(f"serve repl chaos: verify {crep['verify_ok']} ra "
             f"{crep['ra_ok']} faults {crep['faults']}")
    c = REPL_CHAOS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_repl_")
    try:
        jd = os.path.join(tmp, "journal")
        sched_kw = dict(turn_ops=c["turn_ops"], batch=c["batch"],
                        macro_k=c["macro_k"], batch_chars=c["batch_chars"],
                        snapshot_every=c["snapshot_every"])

        def fleet(spool):
            sessions = build_fleet(c["n_docs"], mix=c["mix"], seed=c["seed"],
                                   arrival_span=c["arrival_span"])
            reps, table = build_writer_groups(sessions, c["writers"])
            pool = DocPool(classes=c["classes"], slots=c["slots"],
                           device=dev, spool_dir=os.path.join(tmp, spool))
            streams = prepare_streams(reps, pool, batch=c["batch"],
                                      batch_chars=c["batch_chars"])
            return sessions, table, pool, streams

        zero_counts()
        _s, table, pool, streams = fleet("a")
        j = OpJournal(jd)
        first = ReplicatedScheduler(pool, streams, table, journal=j,
                                    **sched_kw)
        first.run(max_rounds=REPL_CRASH_ROUNDS)
        if first.done:
            fail("serve repl chaos: the fleet drained before its stop")
        j.close()
        pool.close()
        sessions, table, pool, streams = fleet("b")
        t_rec = time.perf_counter()
        j = OpJournal(jd)
        sched, rrep, replayed = recover_replicated_fleet(
            pool, streams, table, jd, journal=j, **sched_kw)
        pool.block()
        recover_ms = (time.perf_counter() - t_rec) * 1e3
        stats = sched.run()
        j.close()
        report = check_convergence(pool, table, sessions, streams)
        check_ra_linearizability(sched.bus, table, report)
        pool.close()
        launches = read_all_counts("serve repl chaos recovery")
        add_counts(counts, launches)
        if not (sched.done and report.converged and report.ra_ok
                and replayed > 0 and rrep.snapshot_round >= 0):
            fail(f"serve repl chaos recovery: done {sched.done}, "
                 f"{report.to_dict()}, {replayed} blocks replayed, snapshot "
                 f"round {rrep.snapshot_round}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[serve repl chaos] serve/repl/{c['mix']}/{c['n_docs']}x"
          f"{c['writers']} under {c['faults']}: "
          + "; ".join(f"{k} fired round {e['fired_round']}, recovered "
                      f"({e['detail']})" for k, e in sorted(evs.items()))
          + f"; {crep['replication']['partitions_healed']} partition healed, "
          f"{crep['replication']['reordered_rounds']} round reordered, "
          f"divergence max {crep['replication']['divergence_depth_max']}; "
          f"all {crep['convergence']['replicas_checked']} replicas converged,"
          f" RA axioms hold; {crep['patches_per_sec']:.1f} replica-patches/s"
          f"; stopped after {REPL_CRASH_ROUNDS} macro-rounds and recovered "
          f"by recover_replicated_fleet in {recover_ms:.1f} ms (snapshot "
          f"round {rrep.snapshot_round}, {replayed} bcast blocks replayed, "
          f"resume round {rrep.resume_round}), resumed over {stats.rounds} "
          f"rounds: all {report.replicas_checked} replicas byte-identical "
          f"to the oracle, RA axioms hold on {report.ra_groups_checked} "
          f"histories; launches {launches} in the recovered drain "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return kept_kernel_rows(
        "serve repl phases; the launches of [serve repl] and every drain of "
        "[serve repl chaos]", kk, counts)


def reshard_phases(dev, bound, serve_rate=None) -> list[dict]:
    """Live resharding (``serve/reshard.py``) on the card.

    ``[serve reshard]`` (``RESHARD_CELL``): every count set to 0 just
    before the drain and read just after, K1's per-row form and K4 once per
    dispatch and no plain version; ``reshard_crash`` fired and recovered by
    the coordinator's resume, shards 6 and 7 retired, no partition error,
    the seeded sample byte-identical; the ``reshard`` block and the rate
    against ``[serve]``'s (``serve_rate``; a plain drain here when None);
    the block's ``RESHARD_COUNTS`` equal to ``RESHARD_ARTIFACT``'s.  Its
    first operands of each (class, rows) pair, the tiers gathered over
    the 8 shards, go through :func:`kept_kernel_check`.  ``[serve reshard
    crash]`` (``RESHARD_SMOKE``): the status server armed, ``/metrics``
    read from the coordinator's every out-of-window publish (and by a
    :class:`Scraper` thread), which must show ``serve_reshard_active 1``
    with ``serve_reshard_pending_docs`` counting down; then the fleet
    stopped after ``RESHARD_CRASH_ROUNDS`` macro-rounds, mid-move, and
    ``recover_fleet`` rolling the reshard forward: every document
    byte-identical and the partition invariant holding.  Returns the two
    kernels' rows, their launches summed over the drains."""
    import re
    import urllib.request

    from crdt_benches_tpu_torch.serve.bench import (
        build_telemetry,
        run_serve_bench,
    )

    counts = {"resolve_range_rows": 0, "serve_macro_fused": 0}
    keep: dict[tuple[int, int], tuple] = {}

    if serve_rate is None:
        t0 = time.perf_counter()
        ref = run_serve_bench(**SERVE_CELL, device=dev, log=lambda m: None)
        serve_rate = ref["patches_per_sec"]
        print(f"[serve reshard] the plain reference drain of "
              f"serve/{SERVE_CELL['mix']}/{SERVE_CELL['n_docs']}: "
              f"{serve_rate:.1f} patches/s "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cell = RESHARD_CELL
    t0 = time.perf_counter()
    rep = run_serve_bench(
        **cell, device=dev, pool_hook=keep_tier_operands(keep, zero_counts),
        log=lambda m: print(f"[serve reshard] {m}", flush=True))
    launches = read_all_counts("serve reshard")
    add_counts(counts, launches)
    rs, ev = rep["reshard"], rep["faults"]["events"]
    if not (launches.get("resolve_range_rows") == rep["dispatches"]
            == launches.get("serve_macro_fused")):
        fail(f"serve reshard: launches {launches} for {rep['dispatches']} "
             "dispatches")
    if not (rep["verify_ok"] and rep["faults_ok"] and rs["state"] == "done"
            and rs["shards"] == [6, 7] and rs["live_shards"] == 6
            and not rs["partition_errors"] and rs["resumes"] >= 1
            and ev[0]["fired"] and ev[0]["recovered"]
            and ev[0]["detail"]["via"] == "coordinator_resume"):
        fail(f"serve reshard: verify {rep['verify_ok']} faults "
             f"{rep['faults']} reshard {rs}")
    with open(RESHARD_ARTIFACT) as f:
        want = json.load(f)[0]["extra"]["reshard"]
    differ = {k: (rs[k], want[k]) for k in RESHARD_COUNTS if rs[k] != want[k]}
    if differ:
        fail(f"serve reshard: (port, JAX's artifact) differ in {differ}")
    mid, lat = rs["mid_latency"], rep["batch_latency"]
    print(f"[serve reshard] serve/reshard/{cell['mix']}/{cell['n_docs']} "
          f"{cell['reshard_spec']} under {cell['faults']}: "
          f"{rep['patches_per_sec']:.1f} patches/s, "
          f"{rep['patches_per_sec'] / serve_rate:.4f} of [serve]'s "
          f"{serve_rate:.1f} in this run; reshard_crash fired round "
          f"{ev[0]['fired_round']} ({ev[0]['detail']['docs']} docs on the "
          f"draining shards), recovered by the coordinator's resume at round "
          f"{ev[0]['detail']['round']}; shards {rs['shards']} retired (begin "
          f"r{rs['begin_round']}, commit r{rs['commit_round']}, "
          f"{rs['rounds_active']} rounds active), {rs['migrated']} row "
          f"moves + {rs['evicted']} evictions, {rs['deferred_lanes']} lanes "
          f"deferred ({rs['deferred_ops']} ops), {rs['resumes']} resumes, "
          f"live shards {rs['live_shards']}/8, no partition error, the "
          f"counts equal to {os.path.basename(RESHARD_ARTIFACT)}'s; "
          f"mid-reshard round p50 {mid['p50'] * 1e3:.2f} ms p99 "
          f"{mid['p99'] * 1e3:.2f} max {mid['max'] * 1e3:.2f} (every round "
          f"p50 {lat['p50'] * 1e3:.2f} p99 {lat['p99'] * 1e3:.2f}); "
          f"{rep['rounds']} rounds, {rep['dispatches']} dispatches, "
          f"launches {launches}, plain calls 0; the seeded sample of "
          f"{rep['verified_docs']} docs byte-identical to the oracle; "
          f"{rep['journal']['snapshots']} barriers; host phase s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rep["phase_seconds"].items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    label = (f"serve reshard, serve/reshard/{cell['mix']}/{cell['n_docs']} "
             "on 8 shards")
    kk = kept_kernel_check("serve reshard kernels", label, keep,
                           cell["classes"], dev, bound)

    # ---- [serve reshard crash]: the mid-move scrape, then a crash ----
    t0 = time.perf_counter()
    seen: list[tuple[int, int]] = []  # (active, pending) at each publish
    telemetry = build_telemetry(
        status_port=0, log=lambda m: print(f"[serve reshard crash] {m}",
                                           flush=True))
    base = f"http://127.0.0.1:{telemetry.status.port}"
    publish = telemetry.publish_metrics_now
    gauge = re.compile(r"^serve_reshard_(active|pending_docs) (\S+)$", re.M)

    def publish_and_scrape():
        publish()
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            got = dict(gauge.findall(r.read().decode()))
        seen.append((int(float(got["active"])),
                     int(float(got["pending_docs"]))))

    telemetry.publish_metrics_now = publish_and_scrape
    scraper = Scraper(telemetry.status.port)
    try:
        srep = run_serve_bench(
            **RESHARD_SMOKE, device=dev, pool_hook=zero_counts,
            telemetry=telemetry, slo_spec="default=p99:60000",
            log=lambda m: print(f"[serve reshard crash] {m}", flush=True))
        launches = read_all_counts("serve reshard crash (live)")
    finally:
        scraper.stop()
        telemetry.close()
    add_counts(counts, launches)
    scraper.check("serve reshard crash")
    moving = [p for a, p in seen if a == 1]
    if not (srep["verify_ok"] and srep["faults_ok"]
            and srep["reshard"]["state"] == "done" and len(moving) >= 2
            and moving == sorted(moving, reverse=True)
            and moving[0] > moving[-1] and seen[-1] == (0, 0)):
        fail(f"serve reshard crash: verify {srep['verify_ok']} faults "
             f"{srep['faults_ok']} reshard {srep['reshard']}, /metrics "
             f"(active, pending) {seen}")
    zero_counts()
    crep = run_serve_bench(
        **dict(RESHARD_SMOKE, verify_sample=0), device=dev,
        crash_after=RESHARD_CRASH_ROUNDS,
        log=lambda m: print(f"[serve reshard crash] {m}", flush=True))
    launches = read_all_counts("serve reshard crash (recovered)")
    add_counts(counts, launches)
    rec = crep["recovery"]
    if not (crep["crashed"] and crep["reshard"]["state"] in
            ("active", "crashed") and rec["reshard_completed"]
            and rec["reshard_retired"] == [1] and rec["verify_ok"]
            and rec["verified_docs"] == RESHARD_SMOKE["n_docs"]
            and crep["verify_ok"]):
        fail(f"serve reshard crash: crashed {crep['crashed']} reshard "
             f"{crep['reshard']} recovery {rec}")
    print(f"[serve reshard crash] serve/reshard/mixed/"
          f"{RESHARD_SMOKE['n_docs']} {RESHARD_SMOKE['reshard_spec']} under "
          f"{RESHARD_SMOKE['faults']} with the status server: /metrics "
          f"(active, pending_docs) at each of the coordinator's publishes "
          f"{seen}: serve_reshard_active 1 while pending_docs counted "
          f"{moving[0]} -> {moving[-1]} mid-move; scrapes mid-run "
          f"{scraper.mid} of {scraper.passes} passes; "
          f"{srep['reshard']['migrated']} row moves + "
          f"{srep['reshard']['evicted']} evictions, "
          f"{srep['reshard']['resumes']} resume, the sample verified; then "
          f"stopped after {RESHARD_CRASH_ROUNDS} macro-rounds with the "
          f"reshard {crep['reshard']['state']} (manifest committed, no "
          f"commit record) and recovered: recover_fleet rolled it forward "
          f"(retired {rec['reshard_retired']}, {rec['reshard_docs_moved']} "
          f"docs moved off, recover_ms {rec['recover_ms']:.1f}, redo_ms "
          f"{rec['redo_ms']:.1f}), every one of {rec['verified_docs']} docs "
          f"byte-identical to the oracle, the partition invariant held; "
          f"launches {launches} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return kept_kernel_rows(
        "serve reshard phases; the launches of [serve reshard] and every "
        "drain of [serve reshard crash]", kk, counts)


#: ``[serve open]``: the README's open-loop cell (``serve/open/mixed/4096``:
#: ``--serve-batch 64 --serve-macro 8 --serve-open 16384 --serve-deadline
#: --serve-tenants "gold=12288:49152,free=4096:8192:32768"``), drained
#: uncut by ``chip_smoke.py --open-full``.
OPEN_FULL = dict(SERVE_CELL, open_spec="16384", deadline=True,
                 tenants_spec="gold=12288:49152,free=4096:8192:32768")
#: The documents ``[serve open]`` drains by default: the cell cut by
#: :func:`open_cell`, the offered rate and the tenants' rates, bursts and
#: budgets scaled by the same factor (uncut, the wire's 70,932 frames took
#: the drain 48.1 s, the phase 73.6 s, on an NVIDIA H100 80GB HBM3 at
#: 700.00 W; PERF.md section 4).
OPEN_DOCS = 1024
#: ``[serve open sweep]``: the cut fleet (512 docs until the runtime tooling
#: phases came), and the probes' offered rates in ops a round, fixed so
#: that every run drives the same traffic: the README cell's 16,384 scaled
#: to the fleet (1,024, the configured rate, run again with the knee
#: attached), half and twice it.
OPEN_SWEEP_DOCS = 256
OPEN_SWEEP_RATES = (512, 1024, 2048)
#: ``[serve open chaos]``: the JAX bench smoke's open chaos leg
#: (``tools/bench_smoke.sh --family serve-open``, its second leg) uncut.
OPEN_CHAOS = dict(mix="mixed", n_docs=24, batch=16, macro_k=4,
                  batch_chars=64, classes=(256, 1024, 4096, 8192, 49152),
                  slots=(16, 6, 2, 2, 2), arrival_span=2, seed=0,
                  verify_sample=6, open_spec="64",
                  tenants_spec="gold=48:192,free=16:32:128", deadline=True,
                  snapshot_every=3,
                  faults="seed=5,conn_churn@6=1,tenant_flood@10=1")


def open_cell(n_docs: int) -> dict:
    """``OPEN_FULL`` cut to ``n_docs``: the offered rate and every tenant's
    rate, burst and budget scaled by ``n_docs / 4096``."""
    f = n_docs / OPEN_FULL["n_docs"]
    return dict(OPEN_FULL, n_docs=n_docs, open_spec=f"{16384 * f:g}",
                tenants_spec=f"gold={12288 * f:g}:{49152 * f:g},"
                f"free={4096 * f:g}:{8192 * f:g}:{int(32768 * f)}")


def open_phases(dev, bound, n_docs=OPEN_DOCS) -> list[dict]:
    """The live ingest front (``serve/ingest/``) on the card.

    ``[serve open]`` (:func:`open_cell` of ``n_docs``): ops arrive over the
    loopback TCP front at the offered load while the fleet drains, through
    the per-tenant admission and EDF, every count set to 0 just before the
    drain and read just after: K1's per-row form and K4 once per dispatch,
    no plain version; every document verified, every planned op delivered
    over the wire, no client error, every document scored met or missed;
    its served rate (ops a round), p50/p99, hit rate, per-tenant
    admit/defer/shed, and the device's idle share over the drain
    (``torch.profiler``, CUDA activity, from the pool hook to the drain's
    fence).  Its first operands of each (class, rows) pair go through
    :func:`kept_kernel_check`.  ``[serve open sweep]``:
    ``run_serve_open_sweep`` with burst arrivals on ``OPEN_SWEEP_DOCS``
    docs at ``OPEN_SWEEP_RATES``, every probe and the final drain
    verified, the knee printed.  ``[serve open chaos]`` (``OPEN_CHAOS``): ``conn_churn`` and
    ``tenant_flood`` fired and recovered, connections dropped and resumed,
    the sample verified; then its journal recovered by ``recover_fleet``
    into a fresh pool and its redo tail drained, every document equal to
    the drained fleet's and, lossy ones aside, to the oracle.  Returns the
    two kernels' rows, their launches summed over the drains."""
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
    from crdt_benches_tpu_torch.serve.bench import (
        run_serve_bench,
        run_serve_open_sweep,
    )
    from crdt_benches_tpu_torch.serve.journal import recover_fleet
    from crdt_benches_tpu_torch.serve.pool import DocPool
    from crdt_benches_tpu_torch.serve.scheduler import (
        FleetScheduler,
        prepare_streams,
    )
    from crdt_benches_tpu_torch.serve.workload import build_fleet

    counts = {"resolve_range_rows": 0, "serve_macro_fused": 0}
    keep: dict[tuple[int, int], tuple] = {}

    def ingest_line(rep):
        ing = rep["ingest"]
        fr, cl, dl = ing["front"], ing["client"], ing["deadline"]
        lat = rep["batch_latency"]
        return (f"{ing['open']['total_ops']} ops in "
                f"{ing['open']['total_frames']} frames over "
                f"{ing['open']['sessions']} sessions (horizon "
                f"{ing['open']['horizon']} rounds) at "
                f"{ing['open']['rate']:g} ops/round {ing['open']['process']}"
                f"; served {rep['range_ops'] / max(1, rep['rounds']):.3f} "
                f"ops/round over {rep['rounds']} rounds, "
                f"{rep['dispatches']} dispatches, {rep['wall_time']:.3f} s; "
                f"macro-round p50 {lat['p50'] * 1e3:.2f} ms p99 "
                f"{lat['p99'] * 1e3:.2f}; deadline hit rate "
                f"{dl['hit_rate']:.4f} ({dl['met']} met, {dl['missed']} "
                f"missed, {'EDF' if dl['edf'] else 'round-robin'}, budget "
                f"{dl['default_budget']}); "
                + "; ".join(f"{t}: admit {d['admitted_ops']} defer "
                            f"{d['deferred_ops']} shed {d['shed_ops']}"
                            for t, d in sorted(
                                ing["admission"]["tenants"].items()))
                + f"; front {fr['ops_delivered']} ops, {fr['ops_frames']} op"
                f" frames, {fr['sessions_opened']} sessions opened "
                f"({fr['sessions_resumed']} resumed, {fr['churn_drops']} "
                f"churn drops); client {cl['sent_frames']} frames sent, "
                f"{cl['retries']} retries, {cl['reconnects']} reconnects, "
                f"{cl['errors']} errors; late frames {ing['late_frames']}, "
                f"dup frames {ing['dup_frames']}, shed docs "
                f"{ing['shed_docs']}")

    def gates(tag, rep, n):
        ing = rep["ingest"]
        if not (rep["verify_ok"]
                and ing["front"]["ops_delivered"] == ing["open"]["total_ops"]
                and ing["client"]["errors"] == 0
                and ing["deadline"]["met"] + ing["deadline"]["missed"] == n):
            fail(f"{tag}: verify {rep['verify_ok']}, ingest {ing}")

    # ---- [serve open]: the README's cell over the live wire ----
    cell = open_cell(n_docs)
    t0 = time.perf_counter()
    prof = profile(activities=[ProfilerActivity.CUDA])
    window = {}

    def start(p):
        block = p.block

        def fenced():
            block()
            if "stop" not in window:  # the drain's fence ends the window
                torch.cuda.synchronize()
                prof.stop()
                window["stop"] = time.perf_counter()
            p.block = block

        p.block = fenced
        torch.cuda.synchronize()
        zero_all_counts()
        prof.start()
        window["start"] = time.perf_counter()

    rep = run_serve_bench(
        **cell, device=dev, pool_hook=keep_tier_operands(keep, start),
        log=lambda m: print(f"[serve open] {m}", flush=True))
    launches = read_all_counts("serve open")
    add_counts(counts, launches)
    n = rep["dispatches"]
    if not (launches.get("resolve_range_rows") == n
            == launches.get("serve_macro_fused")):
        fail(f"serve open: launches {launches} for {n} dispatches")
    gates("serve open", rep, cell["n_docs"])
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    span = (window["stop"] - window["start"]) * 1e3
    idle = (f"device busy {busy:.2f} of {span:.2f} ms from the pool hook "
            f"to the drain's fence, idle {100 * (1 - busy / span):.1f}%"
            if busy > 0 else "idle not measured (no device time)")
    print(f"[serve open] {rep['bench_id']} ("
          + ("uncut" if n_docs == OPEN_FULL["n_docs"] else
             f"cut from 4096 docs, rate and tenants scaled by "
             f"{n_docs / OPEN_FULL['n_docs']:g}")
          + f", tenants {cell['tenants_spec']}): " + ingest_line(rep)
          + f"; every one of {rep['verified_docs']} docs byte-identical to "
          f"the oracle ({len(rep['lossy_docs'])} lossy left out); "
          f"launches {launches}, plain calls 0; evictions "
          f"{rep['evictions']}, restores {rep['restores']}, promotions "
          f"{rep['promotions']}; host phase s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rep["phase_seconds"].items())
          + f"; {idle} ({time.perf_counter() - t0:.1f} s)", flush=True)
    classes = sorted({C for C, _ in keep})
    label = f"serve open, {rep['bench_id']}"
    kk = kept_kernel_check("serve open kernels", label, keep, classes, dev,
                           bound)
    del keep

    # ---- [serve open sweep]: the knee on a cut fleet ----
    t0 = time.perf_counter()
    sweep = open_cell(OPEN_SWEEP_DOCS)
    rates = list(OPEN_SWEEP_RATES)
    mid = rates[len(rates) // 2]
    sweep.update(open_spec=f"{mid}:burst", tenants_spec=None, deadline=False)
    zero_all_counts()
    srep = run_serve_open_sweep(
        rates, **sweep, device=dev,
        log=lambda m: print(f"[serve open sweep] {m}", flush=True))
    launches = read_all_counts("serve open sweep")
    add_counts(counts, launches)
    knee = srep["knee"]
    if not (srep["verify_ok"] and all(p["verify_ok"] for p in knee["points"])
            and len(knee["points"]) == len(set(rates))
            and launches.get("resolve_range_rows")
            == launches.get("serve_macro_fused") >= srep["dispatches"] > 0):
        fail(f"serve open sweep: verify {srep['verify_ok']}, knee {knee}, "
             f"launches {launches}")
    gates("serve open sweep", srep, OPEN_SWEEP_DOCS)
    print(f"[serve open sweep] serve/open/mixed/{OPEN_SWEEP_DOCS} burst at "
          f"{rates} ops/round (the uncut cell's rate scaled to the fleet, "
          f"half and twice it; the wire, not the card, bounds what is "
          f"served): "
          f"knee capacity {knee['capacity_ops_per_round']:.3f} ops/round; "
          + ", ".join(f"offered {p['offered_rate']:g} served "
                      f"{p['served_rate']:.3f} u={p['utilization']:.4f} p50 "
                      f"{p['p50_ms']:.2f} ms p99 {p['p99_ms']:.2f} ms "
                      f"({p['rounds']} rounds, deferred {p['deferred_ops']}, "
                      f"shed {p['shed_ops']})" for p in knee["points"])
          + f"; every probe and the final drain verified; the final drain at"
          f" {mid}: " + ingest_line(srep)
          + f"; launches over the {len(knee['points']) + 1} drains "
          f"{launches}, plain calls 0 ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # ---- [serve open chaos]: the smoke's chaos leg, then its journal ----
    t0 = time.perf_counter()
    c = OPEN_CHAOS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_open_")
    drained: dict[int, str] = {}

    def keep_decodes(p):
        close = p.close

        def closing():
            drained.update({d: p.decode(d) for d in p.docs
                            if p.docs[d].length})
            close()

        p.close = closing
        zero_counts()

    try:
        jd = os.path.join(tmp, "journal")
        crep = run_serve_bench(
            **c, journal_dir=jd, device=dev, pool_hook=keep_decodes,
            log=lambda m: print(f"[serve open chaos] {m}", flush=True))
        launches = read_all_counts("serve open chaos")
        add_counts(counts, launches)
        evs = {e["kind"]: e for e in crep["faults"]["events"]}
        fr = crep["ingest"]["front"]
        if not (crep["faults_ok"] and fr["churn_drops"] >= 1
                and fr["sessions_resumed"] >= 1
                and all(evs[k]["fired"] and evs[k]["recovered"]
                        for k in ("conn_churn", "tenant_flood"))
                and launches.get("resolve_range_rows")
                == launches.get("serve_macro_fused")
                >= crep["dispatches"] > 0):
            fail(f"serve open chaos: faults {crep['faults']}, front {fr}, "
                 f"launches {launches}")
        gates("serve open chaos", crep, c["n_docs"])
        zero_all_counts()
        sessions = build_fleet(c["n_docs"], mix=c["mix"], seed=c["seed"],
                               arrival_span=c["arrival_span"])
        pool = DocPool(classes=c["classes"], slots=c["slots"], device=dev)
        try:
            streams = prepare_streams(sessions, pool, batch=c["batch"],
                                      batch_chars=c["batch_chars"])
            t_rec = time.perf_counter()
            rec = recover_fleet(pool, streams, jd)
            pool.block()
            recover_ms = (time.perf_counter() - t_rec) * 1e3
            sched = FleetScheduler(pool, streams, batch=c["batch"],
                                   macro_k=c["macro_k"],
                                   batch_chars=c["batch_chars"],
                                   start_round=rec.resume_round)
            rstats = sched.run()
            got = {d: pool.decode(d) for d in pool.docs
                   if pool.docs[d].length}
            lossy = sorted(d for d, st in streams.items() if st.lossy)
            wrong = [s.doc_id for s in sessions
                     if s.doc_id not in lossy
                     and got.get(s.doc_id) != replay_trace(s.trace)]
        finally:
            pool.close()
        rlaunches = read_all_counts("serve open chaos recovery")
        add_counts(counts, rlaunches)
        if not (sched.done and got == drained and not wrong
                and lossy == crep["lossy_docs"] and rec.snapshot_round >= 0):
            fail(f"serve open chaos recovery: done {sched.done}, "
                 f"{len(got)} docs against {len(drained)} drained, "
                 f"{[d for d in drained if got.get(d) != drained[d]][:8]} "
                 f"differ, oracle mismatches {wrong[:8]}, lossy {lossy} "
                 f"against {crep['lossy_docs']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[serve open chaos] {crep['bench_id']} under {c['faults']}: "
          + "; ".join(f"{k} fired round {e['fired_round']}, recovered "
                      f"({e['detail']})" for k, e in sorted(evs.items()))
          + "; " + ingest_line(crep)
          + f"; the sample of {crep['verified_docs']} verified; launches "
          f"{launches}; the journal ({crep['journal']['records']} records, "
          f"{crep['journal']['snapshots']} barriers) recovered by "
          f"recover_fleet in {recover_ms:.1f} ms (snapshot round "
          f"{rec.snapshot_round}, {rec.shed_ops} shed ops replayed, resume "
          f"round {rec.resume_round}) and its redo tail drained over "
          f"{rstats.rounds} rounds (launches {rlaunches}): all "
          f"{len(got)} docs equal to the drained fleet's, "
          f"{len(sessions) - len(lossy)} byte-identical to the oracle "
          f"({len(lossy)} lossy) ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return kept_kernel_rows(
        "serve open phases; the launches of [serve open], every drain of "
        "[serve open sweep] and [serve open chaos] and its recovery", kk,
        counts)


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
    outputs) on the worst-case batches at B = ``rt.batch``, at R = 1, 5 and
    1024, one plain call at R = 1024 a case (its first rows are R = 1's and
    5's: each replica is walked on its own, and the plain version's time is
    its loop over the ops, whatever R).  Replica 0 starts at the case's
    own length (1000, or automerge-paper's before batch 3), then 0, 7, 300,
    then seeded lengths below twice that.  Returns the max abs error (0; any
    other fails) and, per case at R = 1024, K1's ms per launch and its bound
    (``bound(bytes, ops)``, ops from the token walk of all 1024
    replicas)."""
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
        v0 = np.concatenate([[v_first, 0, 7, 300],
                             rng.integers(0, 2 * v_first, 1020)])
        # one plain call at R = 1024: it walks each replica on its own, so
        # its first R rows are the plain result at R = 1 and 5
        want = rr.resolve_range_plain(*(
            torch.as_tensor(a, dtype=torch.int32, device=dev)
            for a in (kind, pos, rlen, slot0, v0)))
        for R in (1, 5, 1024):
            args = [torch.as_tensor(a, dtype=torch.int32, device=dev)
                    for a in (kind, pos, rlen, slot0, v0[:R])]
            got = rr.resolve_range(*args)
            e = max_err((*got[0], *got[1], got[2]),
                        (*(t[:R] for t in want[0]),
                         *(t[:R] for t in want[1]), want[2][:R]))
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


def window_wall_ms(run, module, name, lo, hi) -> float:
    """Host wall time (ms) of :func:`window_busy_ms`'s window in an
    unprofiled call of ``run()``, which stops at the window's end, each
    edge after a device synchronize."""
    import torch

    edges = {}

    def edge(k):
        def mark():
            torch.cuda.synchronize()
            edges[k] = time.perf_counter()
            if k == "hi":
                raise _WindowEnd
        return mark

    with Hooks(module, name, {lo: edge("lo"), hi: edge("hi")}):
        try:
            run()
        except _WindowEnd:
            pass
    return (edges["hi"] - edges["lo"]) * 1e3


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
#: merge/adversarial's delivered ops (``--merge-ops``): 625,000, a sixteenth
#: of the config's 10,000,000 (half since the replication and reshard
#: phases came, an eighth since the open-loop phases did, a sixteenth since
#: the runtime tooling phases)
MERGE_ADVERSARIAL_OPS = 625_000


def merge_phases(dev, bound) -> tuple[list[dict], dict]:
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
    the profiler (on the unit merges over batches 128-383, whose wall
    time the timed run takes between two synchronizes: a whole profiled
    unit merge takes minutes, and the profiled run stops at the window's
    end).  The engines' documents must be identical to each
    other.  K7 is held against its plain version on one unit-merge batch's
    operands at 64 replicas.  Returns the rows of the ``kernels`` line (K7
    on the merge, K5 in the generation), and merge/traces' simulation with
    the native treap's merge of it (for ``[mesh]``)."""
    import torch

    from crdt_benches_tpu_torch.bench import merge as bm
    from crdt_benches_tpu_torch.engine import downstream as dsm
    from crdt_benches_tpu_torch.engine import downstream_flat as dfl
    from crdt_benches_tpu_torch.engine import downstream_range as drg
    from crdt_benches_tpu_torch.engine import merge as mg
    from crdt_benches_tpu_torch.engine import merge_range as mrg
    from crdt_benches_tpu_torch.engine import replay as urep
    from crdt_benches_tpu_torch.ops import expand as ex
    from crdt_benches_tpu_torch.ops import resolve as rs

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
    kept = {}
    k7_err = k5_err = 0
    for config, paths in MERGE_PATHS.items():
        merge_ops = MERGE_ADVERSARIAL_OPS if config == "adversarial" else (
            1_000_000)
        t0 = time.perf_counter()
        zero_all_counts()
        gen = Spans([(urep, "resolve_batch", "K5")], keep={"K5": 40})
        with gen:
            sim = bm.merge_sim(config, merge_ops, batch=256, device=dev)
        la = read_all_counts(f"merge/{config} generation")
        want_k5 = sum(max(1, -(-len(lg) // 256)) for lg in sim.agent_logs)
        if la != {"resolve_batch": want_k5}:
            fail(f"merge/{config} generation: launches {la} for {want_k5} "
                 "batches")
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
            # the unit merge's idle-share window: 256 batches after the
            # first 128, timed here between two synchronizes (the profiled
            # run stops at its end; the middle of the merge cost ~30 s
            # more on the script's clock)
            lo = min(128, want_k7 // 4)
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
            zero_all_counts()
            with sp, hooks:
                t1 = time.perf_counter()
                st = cell.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            la = read_all_counts(f"merge/{config} {engine} R={R}")
            if la != ({"apply_fused_blocked": want_k7} if want_k7 else {}):
                fail(f"merge/{config} {engine} R={R}: launches {la}, want "
                     f"K7 {want_k7}")
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
        if config == "traces":
            kept = {"sim": sim, "want": want}
        del sim
    return rows, kept


#: Batches [lo, hi) of a v5 ``replay_once`` at 64 replicas over which
#: ``[down stages]`` takes the device's idle share (the whole replay until
#: its profiled run took ~37 s on an H100 host; batches 128-383 until the
#: runtime tooling phases came).
DOWN_IDLE_WINDOW = (128, 256)


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
    from crdt_benches_tpu_torch.ops import expand as ex
    from crdt_benches_tpu_torch.traces import load_testing_data

    trace = load_testing_data("automerge-paper")
    end = trace.end_content
    rows = []
    for label, engine, schedule in DOWN_RUN_COLUMNS:
        if engine == "range":
            bk = drg.TorchRangeDownstreamBackend(n_replicas=64, device=dev)
        else:
            bk = TorchRunDownstreamBackend(
                n_replicas=64, device=dev, schedule=schedule,
                granularity={"runs": "coalesced", "patch": "patch",
                             "unitwire": "unit"}[engine])
        zero_all_counts()
        t0 = time.perf_counter()
        bk.prepare(trace)
        gen_s = time.perf_counter() - t0
        gen = read_all_counts(f"[down {label}] generation")
        eng = bk.engine
        if engine == "range":
            nb, want_gen, want_k7 = eng.n_batches, 0, eng.n_batches
            run = eng.run
        else:
            nb = len(eng.lamport) // eng.batch
            want_gen = -(-len(eng.sim.log) // 512)
            want_k7 = nb if schedule == "batched" else 0
            run = bk._merge
        if gen != ({"resolve_batch": want_gen} if want_gen else {}):
            fail(f"[down {label}] generation: launches {gen}, want K5 "
                 f"{want_gen}")
        gen_k5 = gen.get("resolve_batch", 0)
        bk.replay_once()  # warm-up
        secs = []
        for _ in range(3):
            zero_all_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n = bk.replay_once()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            la = read_all_counts(f"[down {label}]")
            if la != ({"apply_fused_blocked": want_k7} if want_k7 else {}):
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


#: The ``[mesh]`` paths' width: the run downstream column's replicas
#: (``bench_results/down_r5.json``, R = 64) and the unit replay's batch.
MESH_REPLICAS, MESH_BATCH = 64, 256


def mesh_phases(dev, bound, traces) -> list[dict]:
    """``[mesh]``: the replica mesh (``parallel/mesh.py``) over NCCL at
    world size 1 (``parallel/launch.py run_ranks``: one group, created on
    a ``HashStore`` and destroyed after), on the card at full width, each
    path with every count set to 0 just before and read just after:

    - ``sharded_downstream_runs`` on automerge-paper, 64 subscribers: K7
      once a batch; every digest equal to ``TorchRunDownstreamBackend``'s
      at R = 64 (its flat schedule, no kernel);
    - ``sharded_merge_runs`` on merge/traces (``traces``: the merge
      phases' simulation and the native treap's merge): K7 once a batch,
      replica 0 byte-identical to the native merge;
    - ``sharded_replay_and_digest`` on the whole automerge-paper trace,
      B = 256, R = 64 (K5 once a batch, the v1 apply): every digest equal
      to the one-replica v1 ``ReplayEngine``'s, every length the trace's;
      K5 held against its plain version on batch N - 2 and timed there;
    - the v1 and packed sharded merges of the dry run's synthetic streams
      (``entry.dryrun_rank``'s parts).

    Each path's seconds and the converged flag read from the collective
    are printed.  ``[dryrun]``: ``entry.dryrun_multichip(1)`` on the card;
    its three digests must equal the same call's on the CPU (gloo).
    Returns the rows of K5 (the sharded replay) and K7 (the sharded
    downstream, launches over every mesh and dry-run path)."""
    import torch

    from crdt_benches_tpu_torch.engine import downstream_range as drg
    from crdt_benches_tpu_torch.engine import replay as urep
    from crdt_benches_tpu_torch.engine.merge_range import (
        RunMergeSimulation,
        TorchRunDownstreamBackend,
    )
    from crdt_benches_tpu_torch.entry import (
        _pad_to,
        dryrun_multichip,
        dryrun_rank,
    )
    from crdt_benches_tpu_torch.ops import expand as ex
    from crdt_benches_tpu_torch.ops import resolve as rs
    from crdt_benches_tpu_torch.parallel import mesh as pm
    from crdt_benches_tpu_torch.parallel.launch import run_ranks
    from crdt_benches_tpu_torch.traces import load_testing_data, tensorize
    from crdt_benches_tpu_torch.utils.digest import (
        doc_digest,
        doc_digest_packed,
    )

    R, B = MESH_REPLICAS, MESH_BATCH
    trace = load_testing_data("automerge-paper")
    end = len(trace.end_content)
    t0 = time.perf_counter()
    # untimed set-up: the run wire and its single-device digests, the
    # unit ops and the one-replica v1 replay's digest, merge/traces' wire
    bk = TorchRunDownstreamBackend(n_replicas=R, device=dev)
    bk.prepare(trace)
    rm = bk.engine
    ref = bk._merge()
    down_want = doc_digest_packed(ref.doc, ref.length, rm.sim.chars)
    del ref
    tt = tensorize(trace, batch=B)
    eng = urep.ReplayEngine(tt, n_replicas=1, engine="v1", device=dev)
    st1 = eng.run()
    replay_want = doc_digest(st1.order, st1.visible, st1.length, eng.chars)
    del st1
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    kind_b, pos_b, _, slot_b = (i32(a) for a in tt.batched())
    sim = traces["sim"]
    trm = RunMergeSimulation(sim, batch=512, epoch=8)
    if not trm.fast_ok:
        fail("[mesh] merge/traces: the run merge's precondition fails")
    neg = (i32([-1]), i32([-2]))
    print(f"[mesh] set-up {time.perf_counter() - t0:.1f} s (run wire, "
          f"single-device digests, merge/traces' run wire)", flush=True)

    def timed(tag, fn, targets=(), keep=None):
        sp = Spans(targets, keep=keep)
        torch.cuda.synchronize()
        zero_all_counts()
        t1 = time.perf_counter()
        with sp:
            out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        return out, secs, read_all_counts(f"[mesh] {tag}"), sp.kept

    kept_ops = {}  # device operands; a rank's results come back as numpy

    def rank(mesh):
        got = {}
        nb = len(rm.lamport) // rm.batch
        step = pm.sharded_downstream_runs(
            mesh, rm.sim.capacity, rm.sim.n_base, batch=rm.batch,
            epoch=rm.epoch_eff, r_per_shard=R)
        (st, d, conv), secs, la, kept = timed(
            "downstream", lambda: step(*rm._dev, *(rm._dev_del or neg),
                                       rm.sim.chars),
            [(drg, "apply_fused_blocked", "K7")], {"K7": nb - 2})
        if not (conv and torch.equal(d, down_want)
                and bool((st.nvis == end).all())
                and la == {"apply_fused_blocked": nb}):
            fail(f"[mesh] downstream: converged {conv}, digests equal "
                 f"{torch.equal(d, down_want)}, launches {la} for {nb} "
                 "batches")
        got["downstream"] = (secs, conv, la, d[0].tolist(), nb)
        kept_ops["k7"] = kept["K7"]
        del st

        nb = len(trm.lamport) // trm.batch
        wire = [_pad_to(a, mesh.world, f) for a, f in (
            (trm.lamport, 0), (trm.agent, 0), (trm.slot0, -1),
            (trm.rlen, 0), (trm.origin, -2), (trm.dlo, -1), (trm.dhi, -2))]
        step = pm.sharded_merge_runs(mesh, sim.capacity, sim.n_base,
                                     batch=trm.batch, epoch=trm.epoch_eff)
        local = [pm.shard_rows(mesh, a) for a in wire]
        (st, d, conv), secs, la, _ = timed(
            "merge runs", lambda: step(*local, sim.chars))
        if not (conv and la == {"apply_fused_blocked": nb}
                and sim.decode(st, 0) == traces["want"]):
            fail(f"[mesh] merge/traces runs: converged {conv}, launches "
                 f"{la} for {nb} batches, or replica 0 differs from the "
                 "native treap's merge")
        got["merge runs"] = (secs, conv, la, d[0].tolist(), nb)
        del st, local

        nb = tt.n_batches
        state = pm.make_sharded_state(mesh, R, eng.capacity, eng.n_init)
        step = pm.sharded_replay_and_digest(mesh)
        (st, d, conv), secs, la, kept = timed(
            "replay", lambda: step(state, kind_b, pos_b, slot_b, eng.chars),
            [(urep, "resolve_batch", "K5")], {"K5": nb - 2})
        if not (conv and bool((d == replay_want).all())
                and bool((st.nvis == end).all())
                and la == {"resolve_batch": nb}):
            fail(f"[mesh] replay: converged {conv}, digests equal the "
                 f"one-replica engine's {bool((d == replay_want).all())}, "
                 f"lengths {st.nvis[:4].tolist()} (want {end}), launches "
                 f"{la} for {nb} batches")
        got["replay"] = (secs, conv, la, d[0].tolist(), nb)
        kept_ops["k5"] = kept["K5"]
        del st, state

        out, secs, la, _ = timed("dry-run merges", lambda: dryrun_rank(mesh))
        for part in ("merge", "packed"):
            if not out[part][2]:
                fail(f"[mesh] the dry run's {part} merge did not converge")
        got["dry-run merges"] = (secs, True, la,
                                 out["merge"][1][0].tolist(),
                                 out["packed"][1][0].tolist())
        return got

    (got,) = run_ranks(rank, 1, device=dev)
    if torch.distributed.is_initialized():
        fail("[mesh] the process group outlived its phase")
    launches = {}
    for path in ("downstream", "merge runs", "replay", "dry-run merges"):
        secs, conv, la, d0, extra = got[path]
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[mesh] {path}: {secs:.4f} s, converged {conv} (from the "
              f"collective, NCCL, world size 1), launches {la}, plain calls "
              f"0, digest {d0}"
              + (f", {extra} batches" if path != "dry-run merges"
                 else f", packed digest {extra}"), flush=True)
    print(f"[mesh] downstream automerge-paper R={R}: digests equal "
          f"TorchRunDownstreamBackend's; merge/traces runs: replica 0 "
          f"byte-identical to the native treap; replay automerge-paper "
          f"R={R} B={B}: digests equal the one-replica v1 engine's, all "
          f"lengths {end}", flush=True)

    # ---- [dryrun]: entry.dryrun_multichip(1) on the card and the CPU ----
    t0 = time.perf_counter()
    zero_all_counts()
    card = dryrun_multichip(1, device=dev)
    la = read_all_counts("[dryrun]")
    if not (la.get("resolve_batch") and la.get("apply_fused_blocked")):
        fail(f"[dryrun] launches {la}: K5 and K7 must both launch")
    cpu = dryrun_multichip(1, device="cpu")
    if card != cpu or torch.distributed.is_initialized():
        fail(f"[dryrun] card digests {card} != CPU digests {cpu}")
    for k, v in la.items():
        launches[k] = launches.get(k, 0) + v
    print(f"[dryrun] dryrun_multichip(1) on {dev} (NCCL) and on the CPU "
          f"(gloo): the same three digests {card}; card launches {la} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # the kernels' rows at the mesh paths' shapes
    args = kept_ops["k5"]
    e = max_err(tuple(rs.resolve_batch(*args, emit_origin=True)),
                tuple(rs.resolve_batch_plain(*args, emit_origin=True)))
    if e:
        fail(f"K5 != plain on the [mesh] replay's batch {tt.n_batches - 2}:"
             f" {e}")
    out = rs.resolve_batch(*args, emit_origin=True)
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + sum(t.numel() * t.element_size() for t in out))
    k5 = kernel_row(
        f"resolve_batch ([mesh] v1 replay, (R, B) = ({R}, {B}), batch "
        f"{tt.n_batches - 2}; launches over [mesh] and [dryrun])",
        "resolve_unit.cu", "resolve_pallas.py:282",
        launches["resolve_batch"], e,
        elapsed_ms(lambda: rs.resolve_batch(*args, emit_origin=True), 10),
        elapsed_ms(lambda: rs.resolve_batch_plain(*args, emit_origin=True),
                   1),
        bound(nbytes, k5_ops(*args)))
    ops = kept_ops["k7"]
    e = max_err(ex.apply_fused_blocked(*ops),
                ex.apply_fused_blocked_plain(*ops))
    if e:
        fail(f"K7 != plain on the [mesh] downstream's batch: {e}")
    k7 = k7_row("[mesh] downstream R=64; launches over [mesh] and "
                "[dryrun]", ops, launches["apply_fused_blocked"], e, bound)
    return [k5, k7]


def port_counters():
    """Every kernel wrapper of the port (its ``launches``) and every plain
    version (its ``calls``)."""
    from crdt_benches_tpu_torch.ops import apply_range_fused as arf
    from crdt_benches_tpu_torch.ops import expand as ex
    from crdt_benches_tpu_torch.ops import resolve as rs
    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops import serve_fused as sf

    kernels = (rr.resolve_range, rr.resolve_range_rows, arf.range_apply,
               arf.range_apply_blocked, sf.serve_macro_fused,
               rs.resolve_batch, arf.apply_fused2, ex.apply_fused_blocked,
               ex.expand_packed, ex.expand_fill_zero)
    plains = (rr.resolve_range_plain, rr.resolve_range_rows_plain,
              arf.range_apply_plain, sf.serve_macro_plain,
              rs.resolve_batch_plain, arf.apply_fused2_plain,
              ex.apply_fused_blocked_plain, ex.expand_packed_plain,
              ex.expand_fill_zero_plain)
    return kernels, plains


def zero_all_counts() -> None:
    kernels, plains = port_counters()
    for f in kernels:
        f.launches = 0
    for f in plains:
        f.calls = 0


def read_all_counts(tag: str) -> dict[str, int]:
    """The launches since :func:`zero_all_counts`, by kernel; fails if a
    plain version ran."""
    kernels, plains = port_counters()
    called = {f.__name__: f.calls for f in plains if f.calls}
    if called:
        fail(f"{tag}: plain versions called on the path: {called}")
    return {f.__name__: f.launches for f in kernels if f.launches}


#: The runner cells ``[runner]`` drives (``bench/runner.py`` flags, then
#: the kernels each call must launch): the upstream columns at the width
#: of ``bench_results/up_r5_*.json`` (R = 1024; batch 1536 for ``torch``,
#: 256 for ``torch-unit``), the downstream columns at the width of
#: ``down_r5.json`` (R = 64) and the merge columns of
#: ``merge_traces_r5_jax.json`` (R = 64).
RUNNER_CALLS = (
    (["--filter", "upstream", "--traces", "sveltecomponent",
      "--backends", "cpp-rope,cpp-crdt,cpp-cola,torch", "--replicas", "1024",
      "--batch", "1536"], ("resolve_range", "range_apply")),
    (["--filter", "upstream", "--traces", "sveltecomponent",
      "--backends", "torch-unit", "--replicas", "1024", "--batch", "256"],
     ("resolve_batch", "apply_fused2")),
    (["--filter", "downstream", "--traces", "sveltecomponent", "--backends",
      "cpp-crdt,torch,torch-range,torch-runs", "--replicas", "64",
      "--batch", "256"], ("resolve_batch", "apply_fused_blocked")),
    # merge/adversarial at [merge]'s cut (merge/traces until the open-loop
    # phases came: its generation took ~16 s of the call on an H100 host)
    (["--filter", "merge", "--merge-configs", "adversarial", "--merge-ops",
      str(MERGE_ADVERSARIAL_OPS), "--backends", "cpp-crdt,torch-flat",
      "--replicas", "64"], ("resolve_batch",)),
)


def runner_phase(dev) -> dict[str, int]:
    """``[runner]``: the port's bench matrix runner in-process with
    ``--verify``, ``--samples 1 --warmup 0`` (every kernel is built and
    was launched by the earlier phases), on ``RUNNER_CALLS``.  Each
    call runs with every count set to 0 just before and read just after
    (its kernels launched, no plain version called); a verify mismatch, a
    skipped cell, a cell left unverified (every cell but the merge's
    ``cpp-crdt`` reference is verified) or a missing record fails.  Prints each cell's id and
    median and writes every record to ``bench_results/torch_chip.json``.
    Returns the launches by kernel over all calls."""
    import io

    from crdt_benches_tpu_torch.backends.native import native_available
    from crdt_benches_tpu_torch.bench import harness, runner

    if not native_available():
        fail("[runner] the native library does not build: its columns "
             "would be skipped")
    records, launches = [], {}
    for argv, want_kernels in RUNNER_CALLS:
        argv = argv + ["--samples", "1", "--warmup", "0", "--verify"]
        err = io.StringIO()
        t0 = time.perf_counter()
        zero_all_counts()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            rc = runner.main(argv)
        secs = time.perf_counter() - t0
        la = read_all_counts(f"[runner] {' '.join(argv[:2])}")
        lines = err.getvalue().splitlines()
        if rc or any(ln.startswith(("skip", "verify FAILED")) or
                     "MISMATCH" in ln for ln in lines):
            fail(f"[runner] {' '.join(argv)}: exit {rc}; " + "; ".join(
                ln for ln in lines if ln.startswith(("skip", "verify"))))
        missing = [k for k in want_kernels if not la.get(k)]
        if missing:
            fail(f"[runner] {' '.join(argv)}: {missing} never launched "
                 f"({la})")
        with open(os.path.join(harness.RESULTS_DIR, "torch_latest.json")) \
                as fh:
            got = json.load(fh)
        names = argv[argv.index("--merge-configs" if "--merge-configs"
                                in argv else "--traces") + 1].split(",")
        cols = argv[argv.index("--backends") + 1].split(",")
        if len(got) != len(names) * len(cols):
            fail(f"[runner] {' '.join(argv)}: {len(got)} records for "
                 f"{len(names)} x {len(cols)} cells")
        verified = sum(ln.startswith("verify ") and ln.endswith(": ok")
                       for ln in lines)
        # every cell is verified but the merge's reference column
        want_verified = len(names) * len(
            [c for c in cols if c in runner.MERGE_TORCH]
            if "--merge-configs" in argv else cols)
        if verified != want_verified:
            fail(f"[runner] {' '.join(argv)}: {verified} cells verified, "
                 f"want {want_verified}")
        for r in got:
            print(f"[runner] {r['group']}/{r['trace']}/{r['backend']}: "
                  f"median {r['median']:.6f} s ({len(r['samples'])} "
                  f"samples), {r['elements_per_sec']:.1f} elements/s",
                  flush=True)
        print(f"[runner] {' '.join(argv[:8])} ...: {verified} cells "
              f"verified byte-identical, launches {la}, plain calls 0 "
              f"({secs:.1f} s)", flush=True)
        records += got
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v
    runner._merge_sim.cache_clear()  # free the merge cell's device logs
    path = os.path.join(harness.RESULTS_DIR, "torch_chip.json")
    with open(path, "w") as fh:
        json.dump(records, fh, indent=2)
    print(f"[runner] {len(records)} records written to "
          f"{os.path.relpath(path, REPO)}", flush=True)
    return launches


#: The headline width (``models/flagship.py``) the v3 range replay runs at.
V3_REPLICAS = 1024


def range_v3_phase(dev, bound) -> dict:
    """``[range v3]``: automerge-paper through the v3 range engine at the
    headline width (``TorchReplayBackend(1024, batch 1536, layout="range",
    range_engine="v3")``): K1's shared form, then ``apply_range_batch``, K4
    at K = 1 (its scratch path at this capacity).  One counted replay (K1
    and K4 once a batch, K2, K3 and every plain version never), three
    timed;
    every length the trace's, replicas 0 and R-1 byte-identical.  K4's
    output is held against ``serve_apply_round_plain`` on the card at
    every batch of a batch-by-batch walk at R = 1024 (the main path's
    launch geometry) and every other batch at R = 8.  K4 is timed at
    batch 3 of the R = 1024 walk (the rounds' inputs precomputed, CUDA
    events) beside its plain round and bound.  Returns K4's row at this
    shape."""
    import torch

    from crdt_benches_tpu_torch.backends.torch_backend import (
        TorchReplayBackend,
    )
    from crdt_benches_tpu_torch.engine.replay_range import (
        RangeReplayEngine,
        _grow_state3,
    )
    from crdt_benches_tpu_torch.ops import apply_range as ar
    from crdt_benches_tpu_torch.ops import resolve_range as rr
    from crdt_benches_tpu_torch.ops import serve_fused as sf
    from crdt_benches_tpu_torch.ops.apply2 import init_state3
    from crdt_benches_tpu_torch.traces import load_testing_data

    t_all = time.perf_counter()
    trace = load_testing_data("automerge-paper")
    end = trace.end_content
    R = V3_REPLICAS
    bk = TorchReplayBackend(n_replicas=R, batch=1536, layout="range",
                            range_engine="v3", device=dev)
    bk.prepare(trace)
    eng = bk.engine
    nb = eng.rt.n_batches
    zero_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = bk.replay_once()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    la = read_all_counts("[range v3]")
    if la != {"resolve_range": nb, "serve_macro_fused": nb}:
        fail(f"[range v3] launches {la}, want K1 and K4 {nb} each")
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = bk.replay_once()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if n != len(end):
        fail(f"[range v3] replay length {n} != {len(end)}")
    st = eng.run()
    if not bool((st.nvis == len(end)).all()):
        fail("[range v3] replica lengths differ from the trace's")
    for r in (0, R - 1):
        if eng.decode(st, r) != end:
            fail(f"[range v3] replica {r} differs from the end content")
    C = st.doc.shape[1]
    del st

    def walk(Rw, check, time_at=None):
        """The v3 replay batch by batch at ``Rw`` replicas: K4 held
        against the plain round where ``check(i)``; K4 and the plain
        round timed at batch ``time_at``."""
        e = RangeReplayEngine(eng.rt, n_replicas=Rw, engine="v3",
                              device=dev)
        st = init_state3(Rw, e.stage_caps[0], e.n_init, device=dev)
        worst, timed, i = 0, {}, 0
        for cap, (kind, pos, rlen, slot0) in zip(e.stage_caps, e.chunks):
            st = _grow_state3(st, cap)
            for j in range(kind.shape[0]):
                tok, dints, _ = rr.resolve_range(kind[j], pos[j], rlen[j],
                                                 slot0[j], st.nvis)
                new = ar.apply_range_batch(st, tok, dints)
                if check(i):
                    want = sf.serve_apply_round_plain(st, tok, dints)
                    err = max_err(tuple(new), tuple(want))
                    if err:
                        fail(f"[range v3] K4 != plain round at batch {i}, "
                             f"R={Rw}: {err}")
                    worst = max(worst, err)
                if i == time_at:
                    one = lambda xs: tuple(x.unsqueeze(0).contiguous()
                                           for x in xs)
                    t1, d1 = one(tok), one(dints)
                    inputs = sf.serve_round_inputs(t1, d1, st.length,
                                                   st.nvis)
                    timed = {
                        "ms": elapsed_ms(lambda: sf.serve_macro_fused(
                            st, t1, d1, inputs=inputs), 10),
                        "plain_ms": elapsed_ms(
                            lambda: sf.serve_apply_round_plain(st, tok,
                                                               dints), 3),
                        "bound": k4_bound(bound, st.length, inputs[5],
                                          d1[0].shape[2], t1[0].shape[2],
                                          st.doc.shape[1]),
                        "shape": (Rw, d1[0].shape[2], t1[0].shape[2],
                                  st.doc.shape[1]),
                        "geometry": sf.serve_macro_launch_geometry(
                            Rw, st.doc.shape[1], dev)[:4],
                    }
                st = new
                i += 1
        return worst, timed

    t0 = time.perf_counter()
    err8, _ = walk(8, lambda i: i % 2 == 0)
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    err_r, timed = walk(R, lambda i: True, time_at=3)
    check_r_s = time.perf_counter() - t0
    med = sorted(secs)[1]
    print(f"[range v3] automerge-paper R={R} B=1536 C={C}: {nb} batches, "
          f"all {R} lengths {len(end)}, replicas 0 and {R - 1} "
          f"byte-identical; counted replay {first_s:.4f} s, timed "
          f"{[round(x, 4) for x in secs]} s, median {med:.4f} s = "
          f"{len(trace) * R / med:.1f} elements/s; launches per "
          f"replay {la}, plain calls 0; K4 equals serve_apply_round_plain "
          f"at every batch at R={R} (max abs error {err_r}, "
          f"{check_r_s:.1f} s with the timing) and every other batch at R=8 "
          f"(max abs error {err8}, {check_s:.1f} s)"
          f"; K4 at (R, B, T, C) = {timed['shape']}, geometry (n, slice, "
          f"smem, resident) {timed['geometry']}: {timed['ms']:.4f} ms a "
          f"launch, plain round {timed['plain_ms']:.4f} ms, bound "
          f"{timed['bound'][0]:.4f} ms ({timed['bound'][1]}) "
          f"({time.perf_counter() - t_all:.1f} s)", flush=True)
    return kernel_row(
        "serve_macro_fused (v3 range replay, K = 1, (R, B, T, C) = "
        f"{timed['shape']})", "serve_macro.cu", "serve_fused.py:685",
        la["serve_macro_fused"], max(err_r, err8), timed["ms"],
        timed["plain_ms"],
        timed["bound"])


def entry_phase(dev) -> None:
    """``[entry]``: ``entry()``'s step on the card against the same step
    at ``device="cpu"`` (all five outputs, max abs error 0), with every
    count set to 0 just before: K1 and the range apply the dispatch takes
    at R = 4 once each."""
    from crdt_benches_tpu_torch.entry import entry

    step, args = entry(device=dev)
    cstep, cargs = entry(device="cpu")
    zero_all_counts()
    out = step(*args)
    la = read_all_counts("[entry]")
    want = cstep(*cargs)
    err = max_err(tuple(o.cpu() for o in out), tuple(want))
    if err or la.get("resolve_range") != 1 or sum(la.values()) != 2:
        fail(f"[entry] max abs error {err}, launches {la}")
    print(f"[entry] entry() step on {dev} equals device='cpu' in all five "
          f"outputs (max abs error {err}); launches {la}; doc "
          f"{tuple(out[0].shape)}, lengths {out[3].cpu().tolist()}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive the PyTorch port on one NVIDIA GPU; with no "
        "arguments, every phase.")
    ap.add_argument("--tier-only", action="store_true",
                    help="run only the device, build and three-tier phases "
                    "([serve tier], [serve tier kernels], [serve tier ab])")
    ap.add_argument("--tier-full", action="store_true",
                    help="[serve tier] on TIER_FULL (65,536 docs, "
                    "hot=1024,warm=16384) instead of TIER_CELL")
    ap.add_argument("--chaos-only", action="store_true",
                    help="run only the device, build and fault phases "
                    "([serve chaos], [serve chaos durability], [serve tier "
                    "chaos])")
    ap.add_argument("--stream-only", action="store_true",
                    help="run only the device, build and streaming phases "
                    "([serve stream], [serve stream evict], [serve "
                    "construction])")
    ap.add_argument("--telemetry-only", action="store_true",
                    help="run only the device, build and telemetry phases "
                    "([serve telemetry] after a plain drain of its cell, "
                    "[serve telemetry chaos], [serve soak])")
    ap.add_argument("--repl-only", action="store_true",
                    help="run only the device, build and replication phases "
                    "([serve repl], [serve repl kernels], [serve repl "
                    "chaos])")
    ap.add_argument("--reshard-only", action="store_true",
                    help="run only the device, build and reshard phases "
                    "([serve reshard] after a plain drain of its cell, "
                    "[serve reshard kernels], [serve reshard crash])")
    ap.add_argument("--open-only", action="store_true",
                    help="run only the device, build and open-loop phases "
                    "([serve open], [serve open kernels], [serve open "
                    "sweep], [serve open chaos])")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run only the device, build and serve mesh phases "
                    "(a plain drain of serve/mixed/4096 for the reference "
                    "rate, then [serve mesh])")
    ap.add_argument("--tooling-only", action="store_true",
                    help="run only the device, build and runtime tooling "
                    "phases (a plain drain of serve/mixed/4096 for the "
                    "reference rate, then [serve profile], [serve "
                    "sanitized], [edgecheck], [lifecheck], [fscrash])")
    ap.add_argument("--open-full", action="store_true",
                    help="[serve open] on the uncut OPEN_FULL cell (4,096 "
                    "docs at 16,384 ops/round)")
    ap.add_argument("--stream-full", action="store_true",
                    help="[serve stream] on STREAM_FULL (262,144 docs, "
                    "hot=1024,warm=16384) instead of STREAM_CELL, and the "
                    "eager 16,384 and 65,536 rows in [serve construction]")
    ap.add_argument("--ab-pairs", type=int, default=TIER_AB_PAIRS,
                    help="prefetch and no-prefetch drain pairs of [serve "
                    "tier ab] (default %(default)s)")
    opts = ap.parse_args(argv)
    tier_cell = TIER_FULL if opts.tier_full else TIER_CELL
    open_docs = OPEN_FULL["n_docs"] if opts.open_full else OPEN_DOCS

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

    t_start = time.perf_counter()
    sys.stdout = Timeline(sys.stdout, t_start)
    faulthandler.dump_traceback_later(STACKS_AFTER_S)
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
    fleet = share_serve_fleet()
    if opts.mesh_only or opts.tooling_only:
        from crdt_benches_tpu_torch.serve.bench import run_serve_bench

        ref = run_serve_bench(**SERVE_CELL, device=dev, log=lambda m: None)
        print(f"[serve] serve/mixed/4096 (the reference): "
              f"{ref['patches_per_sec']:.1f} patches/s", flush=True)
        rows = (serve_mesh_phase if opts.mesh_only else tooling_phases)(
            dev, bound, ref["patches_per_sec"], smi_line)
        print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"kernels": rows}))
        print(smi_line)
        return 0
    if (opts.tier_only or opts.chaos_only or opts.stream_only
            or opts.telemetry_only or opts.repl_only or opts.reshard_only
            or opts.open_only):
        rows = (serve_tier_phases(dev, bound, tier_cell, opts.ab_pairs)[1]
                if opts.tier_only else open_phases(dev, bound, open_docs)
                if opts.open_only else chaos_phases(dev, bound)
                if opts.chaos_only else telemetry_phases(dev, bound)
                if opts.telemetry_only else repl_phases(dev, bound)
                if opts.repl_only else reshard_phases(dev, bound)
                if opts.reshard_only else stream_phases(dev, bound,
                                                        opts.stream_full))
        print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"kernels": rows}))
        print(smi_line)
        return 0

    # its fresh processes overlap the phases up to [serve stream]
    construction = ConstructionTable(opts.stream_full)
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
                held = []  # at time_at the checked plain call is the timed one
                ms = elapsed_ms(
                    lambda: held.append(rr.resolve_range_plain(*args)), 1)
                if i == time_at:
                    times[f"k1{tag}_plain_ms"] = ms
                want = held[0]
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
                if not check_k1(i):
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
    # every sixteenth batch (every other until the streaming phases came,
    # every fourth until the telemetry phases, every eighth until the
    # runtime tooling phases)
    sixteenth = lambda i: i % 16 == 0
    cap_am = 183_296
    t0 = time.perf_counter()
    k3_also = ((arf.range_apply_blocked, "k3"),)
    walk("sveltecomponent", 8, 94_208, sixteenth, sixteenth, also=k3_also)
    walk("automerge-paper", 8, cap_am, sixteenth, sixteenth,
         also=k3_also)
    print(f"[k1+k2 R=8] sveltecomponent and automerge-paper, every "
          f"sixteenth "
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
          "outputs equal at R = 1, 5 and 1024 (one plain call a case, at R = "
          "1024); at R = 1024, K1 ms, bound ms "
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

    def main_path(bk, trace, counters, tag, absent=()):
        """Drive ``bk`` on ``trace``: 1 warm-up and 3 timed replays, each
        with every count set to 0 just before and read just after; every
        kernel in ``counters`` must launch once per batch, every kernel in
        ``absent`` never, and no plain version run; all lengths must be
        the trace's and replicas 0 and R-1 decode to its end content (the
        last timed replay's state, kept from the engine's ``run``).
        Returns the launches per replay."""
        R = bk.n_replicas
        eng = bk.engine
        nb = (eng.rt.n_batches if hasattr(eng, "rt") else
              eng.tt.n_batches if hasattr(eng, "tt") else eng.n_batches)
        bk.replay_once()  # warm-up
        samples = []
        launches = {}
        last = {}
        run = eng.run

        def kept_run():
            last["st"] = run()
            return last["st"]

        eng.run = kept_run
        for _ in range(3):
            zero_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = bk.replay_once()
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
            la = read_all_counts(tag)
            launches = {f.__name__: la.get(f.__name__, 0) for f in counters}
            if any(v != nb for v in launches.values()):
                fail(f"{tag}: launches per replay {launches}, want {nb} each")
            if any(la.get(f.__name__) for f in absent):
                fail(f"{tag}: launched " + ", ".join(
                    f"{f.__name__} {la[f.__name__]}x" for f in absent
                    if la.get(f.__name__)) + " on this path")
        if n != len(trace.end_content):
            fail(f"{tag}: replay length {n} != {len(trace.end_content)}")
        del eng.run
        st = last.pop("st")
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
        bk, trace, (rr.resolve_range, k_main), "main",
        absent=(k_off,),
    )
    del bk

    # ---- the reference's own configuration: one replica, through K3 ----
    bk = TorchReplayBackend(n_replicas=1, batch=1536, layout="range",
                            device=dev)
    bk.prepare(trace)
    r1_launches = main_path(
        bk, trace, (rr.resolve_range, arf.range_apply_blocked), "range R=1",
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
    # every thirty-second batch (every fourth until the streaming phases
    # came, every eighth until the open-loop phases did, every sixteenth
    # until the runtime tooling phases: the plain version on the CPU sets
    # this phase's time; every batch of the main paths runs K5 at full
    # width)
    k5_log = k5_log[::K5_STRIDE]
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
            fail(f"K5 != plain on sveltecomponent batch "
                 f"{K5_STRIDE * (i // 2)}, "
                 f"emit_origin {tasks[i][3]}: {e}")
        uerr["k5"] = max(uerr["k5"], e)
    print(f"[k5 R=8] sveltecomponent: one batch in {K5_STRIDE} "
          f"({len(k5_log)} "
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
        zero_all_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = e64.run()
        lengths_ok(st, f"{eng} R=64")
        secs = time.perf_counter() - t1
        la = read_all_counts(f"{eng} replay")
        if la != {"resolve_batch": am.n_batches, kern.__name__: am.n_batches}:
            fail(f"{eng} replay: launches {la}, want K5 and "
                 f"{kern.__name__} {am.n_batches} each")
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
        bk, trace, (rs.resolve_batch, arf.apply_fused2), "unit main")
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

    derr = {"k7": 0, "k6nocv": 0}

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
        over its wall time (host clock, one unprofiled call; both windows
        measured here ran just before, so no warm-up), None when the
        profiler shows no device time; with the wall and busy ms and the
        seconds the measurement took."""
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
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
    zero_all_counts()
    dbk = dsm.TorchDownstreamBackend(n_replicas=64, batch=256, device=dev)
    dbk.prepare(trace)
    deng = dbk.engine
    gen = read_all_counts("downstream generation")
    gen_k5 = gen.get("resolve_batch", 0)
    if gen != {"resolve_batch": deng.n_batches}:
        fail(f"downstream generation: launches {gen} for {deng.n_batches} "
             "batches, want K5 once a batch")
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
                         check=half, time_at=late, tag="_long")
    lengths_ok(st, "K7 long")
    # every other batch (every batch until the open-loop phases came) and
    # the timed one
    checked_all(n, "K7 long", (am.n_batches + 1) // 2 + late % 2)
    del st
    print(f"[k7] automerge-paper downstream: all {am.n_batches} batches' v5 "
          f"operands, K7 and K6 (emit_cv off) equal their plain versions "
          f"and each other at R=8 (C={dcap}), every other batch's and batch "
          f"{late}'s at R=2, C={long_c}; batch "
          f"{late} at R=2: K7 {times['k7_long_ms']:.4f} ms, plain "
          f"{times['k7_long_plain_ms']:.4f} ms "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # the downstream path at the recorded width: K7 once per batch
    down_launches = main_path(
        dbk, trace, (ex.apply_fused_blocked,), "down main",
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
    t0 = time.perf_counter()
    lo, hi = DOWN_IDLE_WINDOW
    w64 = window_wall_ms(dbk.replay_once, dsm, "_apply_update_batch5", lo, hi)
    b64 = window_busy_ms(dbk.replay_once, dsm, "_apply_update_batch5", lo,
                         hi)
    idle64 = ((1 - b64 / w64 if b64 > 0 else None), w64, b64,
              time.perf_counter() - t0)
    print("[down stages] automerge-paper v5 R=64 B=256, all batches, span "
          "ms (CUDA events, include device waits on the host): "
          + ", ".join(f"{k} {v:.2f}" for k, v in dstages.items())
          + f"; sum {sum(dstages.values()):.2f} of {wall:.2f} ms wall "
          f"(wall includes state init, not the check); batches {lo}-"
          f"{hi - 1} of a replay_once: " + fmt_idle(*idle64), flush=True)
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
    zero_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = feng.run()
    torch.cuda.synchronize()
    rep_s = time.perf_counter() - t0
    fl = read_all_counts("flagship downstream")
    if fl.get("apply_fused_blocked") != feng.n_batches or fl.get(
            "apply_fused2"):
        fail(f"flagship downstream: launches {fl} for {feng.n_batches} "
             "batches")
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
        zero_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = e.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        la = read_all_counts(f"downstream {ename}")
        want = {"expand_packed": e.n_batches} if ename == "v3" else {}
        if la != want:
            fail(f"downstream {ename}: launches {la}, want {want}")
        lengths_ok(st, f"downstream {ename}")
        for r in (0, 63):
            if e.decode(st, r) != trace.end_content:
                fail(f"downstream {ename}: replica {r} differs from the end "
                     "content")
        del st, e
        print(f"[down {ename}] automerge-paper R=64 B=256: all lengths "
              f"{end_am}, replicas 0 and 63 byte-identical; launches "
              f"{la or 'none (no kernel)'}"
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
    serve_rate, serve_rows, serve_ref = serve_phases(dev, bound)
    rows += serve_rows
    # ---- the serve mesh through the runner's serve family ----
    t0 = time.perf_counter()
    rows += serve_mesh_phase(dev, bound, serve_rate, smi_line)
    print(f"[serve mesh] all mesh phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    # ---- the runtime tooling: profiler, sanitizers, the harnesses ----
    t0 = time.perf_counter()
    rows += tooling_phases(dev, bound, serve_rate, smi_line)
    print(f"[tooling] all tooling phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    # ---- the telemetry (obs/) against [serve]'s drain ----
    t0 = time.perf_counter()
    rows += telemetry_phases(dev, bound, serve_ref)
    print(f"[serve telemetry] all telemetry phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # ---- multi-writer replication and live resharding ----
    t0 = time.perf_counter()
    rows += repl_phases(dev, bound)
    print(f"[serve repl] all replication phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows += reshard_phases(dev, bound, serve_rate)
    print(f"[serve reshard] all reshard phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows += open_phases(dev, bound, open_docs)
    print(f"[serve open] all open-loop phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tier_rate, tier_rows = serve_tier_phases(dev, bound, tier_cell,
                                             opts.ab_pairs)
    rows += tier_rows
    print(f"[serve tier] all tier phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    # ---- the journal, crash recovery and rebuild_doc ----
    t0 = time.perf_counter()
    rows += journal_phases(dev, bound)
    print(f"[serve journal] all journal phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # ---- fault injection and in-run repair ----
    t0 = time.perf_counter()
    rows += chaos_phases(dev, bound)
    print(f"[serve chaos] all chaos phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    # ---- streaming construction and drained-doc record eviction ----
    t0 = time.perf_counter()
    rows += stream_phases(dev, bound, opts.stream_full, tier_rate,
                          construction)
    print(f"[serve stream] all streaming phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # ---- the concurrent merges and the run-granular downstream ----
    t0 = time.perf_counter()
    merge_rows, traces = merge_phases(dev, bound)
    rows += merge_rows
    print(f"[merge] all merge phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    rows += run_down_phases(dev, bound)
    print(f"[down runs] all run-granular downstream phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # ---- the bench matrix runner, the v3 range engine, entry() ----
    t0 = time.perf_counter()
    runner_launches = runner_phase(dev)
    print(f"[runner] all runner calls {time.perf_counter() - t0:.1f} s; "
          f"launches {runner_launches}", flush=True)
    rows.append(range_v3_phase(dev, bound))
    entry_phase(dev)
    # ---- the replica mesh at world size 1 (NCCL) and the dry run ----
    t0 = time.perf_counter()
    rows += mesh_phases(dev, bound, traces)
    del traces
    print(f"[mesh] all mesh and dry-run phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[fleet] serve/mixed/4096's sessions built once: "
          f"{fleet['builds_saved']} builds and {fleet['replays_saved']} "
          f"oracle replays saved", flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
