"""The serve family's flags and refusals, in one place for both entry
points: ``bench/runner.py --family serve`` (the JAX runner's serve family)
and ``bench/__main__.py --group serve`` (one JSON line).

:data:`SERVE_FLAGS` holds every flag the two share, with the JAX runner's
defaults and help; :func:`add_serve_flags` adds them to a parser.
:func:`serve_refusal` is the JAX runner's refusal matrix: the message of a
flag combination the serve family refuses (exit 2), or None.
"""

from __future__ import annotations

from ..serve.pool import SERVE_KERNELS

#: (flag, type, default, metavar, choices, help); type ``bool`` is a switch
SERVE_FLAGS = (
    ("--serve-docs", int, 4096, "N", None, "documents in the fleet"),
    ("--serve-mix", str, "mixed", "MIX", None,
     "workload mix name (serve/workload.py MIXES)"),
    ("--serve-batch", int, 64, "N", None,
     "coalesced range ops per doc per device round"),
    ("--serve-macro", int, 8, "K", None,
     "macro-round depth: K staged rounds per device dispatch"),
    ("--serve-batch-chars", int, 256, "N", None,
     "inserted chars per doc per device round (insert runs are pre-split "
     "to fit)"),
    ("--serve-classes", str, "256,1024,4096,8192,49152", "C1,C2,...", None,
     "capacity classes (slots per doc, ascending; the largest must hold the "
     "biggest workload doc)"),
    ("--serve-slots", str, "2048,512,128,32,16", "R1,R2,...", None,
     "resident rows per capacity class"),
    ("--serve-arrival-span", int, 8, "ROUNDS", None,
     "session arrivals staggered over this many rounds"),
    ("--serve-verify-sample", int, 8, "N", None,
     "docs byte-verified vs the oracle, spread across every capacity class "
     "(0 = every doc)"),
    ("--serve-kernel", str, "fused", None, SERVE_KERNELS,
     "serve-step kernel: 'fused' = K1's per-row form then one K4 launch a "
     "dispatch, 'scan' = the rounds one after another through "
     "engine/merge_fleet.py (the differential baseline)"),
    ("--serve-tiers", str, None, "SPEC", None,
     "tiered state residency, 'hot=ROWS,warm=DOCS': scale the device rows "
     "to ~ROWS and keep up to DOCS evicted docs in a host warm tier with a "
     "prefetch thread and a compressed cold spool (serve/tier/<mix>/<fleet>)"),
    ("--serve-arrival-dist", str, "uniform", None, ("uniform", "zipf"),
     "session arrival staggering: 'uniform' or 'zipf' (a dense early head "
     "and a long tail)"),
    ("--serve-writers", int, 0, "W", None,
     "replicate every served doc across W writer replicas "
     "(serve/replicate/; serve/repl/<mix>/<fleet>xW, gated on every "
     "replica's convergence and the RA-linearizability checker)"),
    ("--serve-turn-ops", int, 64, "N", None,
     "coalesced ops per writer turn block"),
    ("--serve-reshard", str, None, "SPEC", None,
     "live shard-map change mid-drain (serve/reshard.py): "
     "'shrink:FROM:TO[@R]', 'grow:FROM:TO[@R]' or 'drain:S[,of=N]'; "
     "requires --serve-journal (serve/reshard/<mix>/<fleet>)"),
    ("--serve-journal", str, None, "DIR", None,
     "enable the write-ahead op journal + snapshot barriers in DIR ('auto' "
     "= an owned temp dir, removed after the run)"),
    ("--serve-snapshot-every", int, 32, "N", None,
     "fleet snapshot barrier period in macro-rounds (journal mode only)"),
    ("--serve-snapshot-keep", int, 2, "N", None,
     "retained snapshot CHAINS (a delta's base links always survive with "
     "it; <=0 = never prune).  Also the WAL GC floor: segments are kept "
     "back to the oldest retained barrier so chain fallback always finds "
     "its redo tail"),
    ("--serve-full-every", int, 4, "N", None,
     "every Nth barrier is a chain-rooting FULL snapshot; the barriers "
     "between persist only rows dirty since the previous one as a "
     "CRC-chained DELTA (1 = every barrier full, the pre-delta behavior)"),
    ("--serve-wal-segment-bytes", int, 1 << 20, "BYTES", None,
     "roll the active WAL file into a sealed numbered segment past this "
     "size; segments fully covered by a committed snapshot are "
     "garbage-collected crash-safely (0 = never roll, the "
     "pre-segmentation behavior)"),
    ("--serve-longhaul", int, 0, "H", None,
     "the serve/longhaul/<mix>/<fleet> durability family: synthetic "
     "streams carry H-times the band op count (days-of-edits scale), the "
     "journal is required, and the run ends with a measured recovery leg "
     "(recover_ms + redo span + chain depth in the report)"),
    ("--serve-recover", bool, False, None, None,
     "measure the recovery-time objective after the drain: drop the live "
     "fleet, recover a fresh one from the journal directory, resume the "
     "redo tail, byte-verify vs the oracle (requires --serve-journal)"),
    ("--serve-crash-round", int, 0, "N", None,
     "inject a crash: kill the drain after N macro-rounds and gate the run "
     "on the recovered fleet's oracle byte-verify (implies --serve-recover)"),
    ("--serve-faults", str, None, "SPEC", None,
     "seeded chaos drain: serve/faults.py spec, e.g. "
     "'seed=7,span=8,spool_corrupt=1,device_loss=1,queue_overflow=1,"
     "dup_batch=1,stall=1'"),
    ("--serve-queue-cap", int, 0, "N", None,
     "bound each doc's pending op queue (0 = unbounded legacy behavior; "
     "overflow past the cap is an explicit defer/shed decision)"),
    ("--serve-overflow-policy", str, "defer", None, ("defer", "shed"),
     "decision at a queue-cap overflow: backpressure the producer (defer) "
     "or tail-drop the session's remaining ops (shed; surfaced as shed_ops "
     "+ lossy_docs)"),
    ("--serve-stream", bool, False, None, None,
     "streaming fleet construction: the fleet is a lazy FleetSpec, each "
     "doc's trace tensorized at its first admission (off the drain by the "
     "prefetcher with --serve-tiers); set-up cost and host memory scale "
     "with the active set"),
    ("--serve-record-evict", bool, False, None, None,
     "reclaim drained docs' pool records and spool members mid-drain "
     "(two-phase GC, serve/pool.py gc_drained_docs): the footprint tracks "
     "the active set.  Journal-less drains only (recovery re-adopts spool "
     "members)"),
    ("--serve-stream-scaling", str, None, "N1,N2,...", None,
     "construction probe table: one fresh process per (fleet size, mode) "
     "cell (serve/construction.py), run before the drain and carried in "
     "its construction block"),
    ("--serve-profile", int, 0, "N", None,
     "capture a torch.profiler trace of N steady macro-rounds (CUDA "
     "activity on the card, CPU activity with --device cpu; barrier rounds "
     "excluded) and embed its top-ops table in the report's 'profile' "
     "block"),
    ("--serve-sanitize", str, None, "LIST", None,
     "arm the runtime sanitizers (lint/) for the drain, a comma-separated "
     "subset of syncs,races,fs,lifecycle,ranges,boundaries: 'syncs' raises "
     "at an undeclared host sync on the hot path (with the CUDA sync debug "
     "tripwire on the card), the others check publish points, durable "
     "protocols, state machines, staged index bounds and boundary "
     "contracts; the report carries every sanitizer's counters armed or "
     "not"),
    ("--serve-trace", str, None, "PATH", None,
     "arm the obs/trace.py span tracer for the drain and write "
     "Perfetto-loadable Chrome trace JSON to PATH (validated after)"),
    ("--serve-status", int, None, "PORT", None,
     "start the obs/status.py live status server on 127.0.0.1:PORT (0 = "
     "ephemeral, bound port logged): /healthz, /status.json, and /metrics "
     "in Prometheus text exposition"),
    ("--serve-timeseries", str, None, "PATH", None,
     "stream closed obs/timeseries.py windows as JSONL to PATH (also arms "
     "the windowed recorder: the report gains a versioned 'timeseries' "
     "block)"),
    ("--serve-timeseries-window", int, 8, "N", None,
     "macro-rounds folded per time-series window"),
    ("--serve-reqtrace", int, 0, "N", None,
     "arm obs/reqtrace.py request tracing, keeping the last N sampled "
     "request traces (0 = disarmed; the report gains a versioned "
     "'reqtrace' block with per-request segments and exemplars)"),
    ("--serve-slo", str, None, "SPEC", None,
     "per-class latency objectives, class=pQ:MS[,class=pQ:MS...], e.g. "
     "'default=p99:250,c4096=p99.9:1500'; arms request tracing, exports "
     "burn-rate gauges on /metrics and /status.json, and adds a versioned "
     "'slo' block (a malformed spec exits 2)"),
    ("--serve-flight", str, None, "PATH", None,
     "arm the obs/flight.py flight recorder: recent rounds, request traces "
     "and the registry, dumped atomically to PATH on an anomaly, an "
     "unrecovered fault or a crash (python -m "
     "crdt_benches_tpu_torch.obs.flight PATH validates it)"),
    ("--serve-soak", float, None, "SECONDS", None,
     "soak mode: drain re-seeded fleets back to back for SECONDS (0 = one "
     "drain) under one telemetry bundle with the obs/anomaly.py detectors "
     "armed; exits 1 when an anomaly is still active at the end"),
    ("--serve-watchdog", float, 0.0, "SECONDS", None,
     "stuck-round watchdog threshold for soak mode (0 = auto: 25x the "
     "rolling median steady-round latency, floored at 1 s)"),
    ("--serve-open", str, None, "RATE", None,
     "open-loop live serving (serve/ingest/): start the sessioned TCP "
     "ingest front and offer RATE ops/macro-round over seeded arrivals "
     "('RATE' or 'RATE:poisson' / 'RATE:burst'); the family becomes "
     "serve/open/<mix>/<fleet>, the per-doc queue cap defaults on "
     "(8*batch) and delivery flows only through per-tenant admission"),
    ("--serve-tenants", str, None, "SPEC", None,
     "ingest admission tenants, 'name=RATE[:BURST[:BUDGET]],...': token "
     "refill per round, bucket depth (default 4*RATE), in-queue op budget "
     "(default unbounded); e.g. 'gold=256:1024,free=16:32:256' (requires "
     "--serve-open)"),
    ("--serve-deadline", bool, False, None, None,
     "earliest-deadline-first selection over per-class latency budgets "
     "(serve/ingest/deadline.py) instead of round-robin (requires "
     "--serve-open)"),
    ("--serve-deadline-budget", int, 0, "N", None,
     "default per-doc deadline budget in macro-rounds past arrival (0 = "
     "derived from the offered load)"),
    ("--serve-open-sweep", str, None, "RATES", None,
     "offered-load sweep: probe the open-loop drain at each "
     "comma-separated rate, then run --serve-open's rate as the final "
     "drain with the p99-vs-utilization knee curve attached (requires "
     "--serve-open)"),
)


def add_serve_flags(ap, unset: bool = False) -> None:
    """Add every flag of :data:`SERVE_FLAGS` to ``ap``.  ``unset`` leaves
    every default None, so the caller sees which flags were given (and
    fills the defaults from :func:`serve_defaults`)."""
    for flag, typ, default, metavar, choices, text in SERVE_FLAGS:
        if typ is bool:
            ap.add_argument(flag, action="store_true",
                            default=None if unset else default, help=text)
        else:
            ap.add_argument(flag, type=typ, metavar=metavar, choices=choices,
                            default=None if unset else default,
                            help=f"{text} (default {default})")


def serve_defaults(overrides: dict) -> dict[str, object]:
    """``{attribute: default}`` of every flag of :data:`SERVE_FLAGS`, a
    flag of ``overrides`` taking its value there."""
    return {flag[2:].replace("-", "_"): overrides.get(flag, default)
            for flag, _typ, default, *_ in SERVE_FLAGS}


#: The flags that shape a bench drain, which the edge harness refuses: it
#: builds its own fleets (JAX's runner's list, in its order).
_EDGECHECK_REFUSED = (
    ("--serve-writers", lambda a: a.serve_writers > 1),
    ("--serve-open", lambda a: a.serve_open is not None),
    ("--serve-soak", lambda a: a.serve_soak is not None),
    ("--serve-longhaul", lambda a: a.serve_longhaul > 0),
    ("--serve-recover", lambda a: a.serve_recover),
    ("--serve-crash-round", lambda a: a.serve_crash_round > 0),
    ("--serve-reshard", lambda a: a.serve_reshard is not None),
    ("--serve-record-evict", lambda a: a.serve_record_evict),
    ("--serve-mesh", lambda a: getattr(a, "serve_mesh", 0) > 1),
    ("--serve-tiers", lambda a: a.serve_tiers is not None),
    ("--serve-stream", lambda a: a.serve_stream),
    ("--serve-journal", lambda a: a.serve_journal is not None),
    ("--serve-faults", lambda a: a.serve_faults is not None),
)


def edgecheck_refusal(args) -> str | None:
    """The JAX runner's refusal of ``--serve-edgecheck`` with a flag that
    shapes a bench drain (exit 2), or None."""
    bad = [flag for flag, hit in _EDGECHECK_REFUSED if hit(args)]
    if not bad:
        return None
    return (f"{', '.join(bad)} not supported with --serve-edgecheck (the "
            "harness builds its own adversarial fleets and drains them "
            "through BOTH kernels, sanitizer armed)")


def serve_refusal(args) -> str | None:
    """The JAX runner's refusals, in its order: the message of a flag
    combination the serve family refuses (exit 2), or None.  ``args`` may
    lack the runner's own flags (``--serve-mesh``, ``--serve-profile``)."""
    mesh = getattr(args, "serve_mesh", 0) > 1
    profile = getattr(args, "serve_profile", 0) > 0
    if args.serve_writers > 1:
        # the replicated family verifies the whole fleet; mesh, telemetry
        # and profiling of it are not built
        unsupported = [
            ("--serve-soak", args.serve_soak is not None),
            ("--serve-longhaul", args.serve_longhaul > 0),
            ("--serve-recover", args.serve_recover),
            ("--serve-crash-round", args.serve_crash_round > 0),
            ("--serve-reshard", args.serve_reshard is not None),
            ("--serve-record-evict", args.serve_record_evict),
            ("--serve-mesh", mesh),
            ("--serve-tiers", args.serve_tiers is not None),
            ("--serve-queue-cap", args.serve_queue_cap > 0),
            ("--serve-status", args.serve_status is not None),
            ("--serve-timeseries", args.serve_timeseries is not None),
            ("--serve-trace", args.serve_trace is not None),
            ("--serve-profile", profile),
            ("--serve-flight", args.serve_flight is not None),
            ("--serve-open", args.serve_open is not None),
            ("--serve-stream", args.serve_stream),
            ("--serve-stream-scaling", args.serve_stream_scaling is not None),
        ]
        bad = [flag for flag, hit in unsupported if hit]
        if bad:
            return (f"{', '.join(bad)} not supported with --serve-writers "
                    "(the replicated family verifies the FULL fleet; "
                    "delivery pacing is the broadcast bus's)")
        return None
    if args.serve_open is not None:
        # recovery and longhaul replay a closed-loop journal tail, the
        # tiered, streamed and reshard families are bench ids of their
        # own, and the ingest pump feeds one scheduler's bounded queues
        unsupported = [
            ("--serve-longhaul", args.serve_longhaul > 0),
            ("--serve-recover", args.serve_recover),
            ("--serve-crash-round", args.serve_crash_round > 0),
            ("--serve-reshard", args.serve_reshard is not None),
            ("--serve-mesh", mesh),
            ("--serve-tiers", args.serve_tiers is not None),
            ("--serve-stream", args.serve_stream),
        ]
        bad = [flag for flag, hit in unsupported if hit]
        if bad:
            return (f"{', '.join(bad)} not supported with --serve-open (the "
                    "open-loop family serves live wire arrivals; see "
                    "serve/ingest/)")
        if args.serve_open_sweep is not None and args.serve_soak is not None:
            return ("--serve-open-sweep probes are one-shot drains; "
                    "--serve-soak does not compose with the sweep")
    else:
        orphaned = [
            ("--serve-tenants", args.serve_tenants is not None),
            ("--serve-deadline", args.serve_deadline),
            ("--serve-deadline-budget", args.serve_deadline_budget > 0),
            ("--serve-open-sweep", args.serve_open_sweep is not None),
        ]
        bad = [flag for flag, hit in orphaned if hit]
        if bad:
            return (f"{', '.join(bad)} configure the live ingest front: "
                    "--serve-open RATE is required")
    if args.serve_record_evict and args.serve_journal is not None:
        return ("--serve-record-evict requires a journal-less drain: "
                "recovery re-adopts the spool members the GC reclaims")
    if args.serve_stream_scaling is not None and (
            args.serve_soak is not None
            or args.serve_open_sweep is not None):
        return ("--serve-stream-scaling attaches the fleet-size probe table "
                "to ONE serve run's artifact; it does not compose with "
                "--serve-soak / --serve-open-sweep")
    return None
