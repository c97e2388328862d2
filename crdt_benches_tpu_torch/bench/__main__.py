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
        [--serve-kernel fused|scan] [--serve-tiers hot=ROWS,warm=DOCS]
        [--serve-arrival-dist uniform|zipf]
        [--serve-journal DIR|auto] [--serve-snapshot-every 32]
        [--serve-snapshot-keep 2] [--serve-full-every 4]
        [--serve-wal-segment-bytes 1048576] [--serve-longhaul H]
        [--serve-recover] [--serve-crash-round N]
        [--serve-faults SPEC] [--serve-queue-cap N]
        [--serve-overflow-policy defer|shed] [--serve-stream]
        [--serve-stream-scaling N1,N2,...] [--serve-record-evict]
        [--serve-trace PATH] [--serve-status PORT]
        [--serve-timeseries PATH] [--serve-timeseries-window 8]
        [--serve-reqtrace N] [--serve-slo SPEC] [--serve-flight PATH]
        [--serve-soak SECONDS] [--serve-watchdog SECONDS]
        [--serve-writers W] [--serve-turn-ops 64]
        [--serve-reshard SPEC] [--serve-open RATE[:poisson|burst]]
        [--serve-open-sweep R1,R2,...] [--serve-tenants SPEC]
        [--serve-deadline] [--serve-deadline-budget N]  (serve)

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
N spread over the classes; ``--serve-kernel scan`` applies the rounds one
after another through ``engine/merge_fleet.py`` instead of the fused macro
apply; ``--serve-tiers hot=ROWS,warm=DOCS`` scales the device rows to about
ROWS and keeps up to DOCS evicted documents in a host warm tier, with a
prefetch thread and a compressed cold spool, under the id
``serve/tier/<mix>/<fleet>``; ``--serve-arrival-dist zipf`` skews the
arrivals toward the start of the span; ``--serve-journal`` arms the
write-ahead journal and snapshot barriers, ``--serve-recover`` adds the
measured recovery leg, ``--serve-crash-round N`` stops the drain after N
macro-rounds and gates the run on the recovered fleet, and
``--serve-longhaul H`` is the ``serve/longhaul/<mix>/<fleet>`` family;
``--serve-faults SPEC`` makes the drain a seeded chaos run
(``serve/faults.py``), ``--serve-queue-cap N`` bounds each document's
pending ops and ``--serve-overflow-policy`` decides at the cap;
``--serve-stream`` builds the fleet lazily, each document's stream at its
first admission, ``--serve-stream-scaling N1,N2,...`` adds the
construction probe's fleet-size table (a fresh process a cell, run before
the drain) and ``--serve-record-evict`` reclaims drained documents' records
and spool files during a journal-less drain; the telemetry flags arm the
span tracer, the loopback status server, the time-series stream, request
tracing, SLOs and the flight recorder (``obs/``), and ``--serve-soak S``
drains re-seeded fleets back to back for S seconds under the anomaly
detectors; ``--serve-writers W`` (W >= 2) serves every document through W
writer replicas, ``--serve-turn-ops N`` ops a writer's turn
(``serve/repl/<mix>/<fleet>xW``, gated on every replica's convergence and
the RA-linearizability checker), and ``--serve-reshard SPEC`` changes the
pool's logical shard map mid-drain (``serve/reshard/<mix>/<fleet>``, the
journal required); ``--serve-open RATE`` serves the fleet open-loop
(``serve/open/<mix>/<fleet>``: ops arrive over a live loopback TCP front at
RATE ops a macro-round, pass the per-tenant admission of
``--serve-tenants`` into bounded queues, and ``--serve-deadline`` selects
earliest-deadline-first over ``--serve-deadline-budget`` rounds), and
``--serve-open-sweep R1,R2,...`` probes those offered rates first and
attaches the p99-against-utilization knee to the run at RATE);
its metric is fleet patches/sec over the drain's wall time, and it exits
non-zero when verification fails, in a chaos run when a fault event went
unfired or unrecovered, or when an anomaly is still active at the end (2
when the flags are refused).  A flag
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

from ..serve.pool import SERVE_KERNELS
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

    native, _ = CppCrdtDownstream.upstream_updates(trace)  # untimed
    return {"cpp_downstream_els_per_sec":
            _native_rate(trace, native.apply_all_native, samples)}


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


def _serve_repl(args) -> int:
    """The replicated family: one drain, one JSON line; 1 if a replica
    diverged, an RA axiom failed or a fault went unfired or unrecovered, 2
    for a flag it does not take (the JAX runner's refusals)."""
    from ..serve.replicate.bench import run_serve_repl_bench

    unsupported = [
        ("--serve-soak", args.serve_soak is not None),
        ("--serve-longhaul", args.serve_longhaul > 0),
        ("--serve-recover", args.serve_recover),
        ("--serve-crash-round", args.serve_crash_round > 0),
        ("--serve-reshard", args.serve_reshard is not None),
        ("--serve-record-evict", args.serve_record_evict),
        ("--serve-tiers", args.serve_tiers is not None),
        ("--serve-queue-cap", args.serve_queue_cap > 0),
        ("--serve-status", args.serve_status is not None),
        ("--serve-timeseries", args.serve_timeseries is not None),
        ("--serve-trace", args.serve_trace is not None),
        ("--serve-flight", args.serve_flight is not None),
        ("--serve-open", args.serve_open is not None),
        ("--serve-stream", args.serve_stream),
        ("--serve-stream-scaling", args.serve_stream_scaling is not None),
    ]
    bad = [flag for flag, hit in unsupported if hit]
    if bad:
        print(f"{', '.join(bad)} not supported with --serve-writers (the "
              "replicated family verifies the FULL fleet; delivery pacing "
              "is the broadcast bus's)", file=sys.stderr)
        return 2
    try:
        rep = run_serve_repl_bench(
            mix=args.serve_mix, n_docs=args.serve_docs,
            writers=args.serve_writers, batch=args.serve_batch,
            classes=_ints(args.serve_classes), slots=_ints(args.serve_slots),
            seed=args.seed, arrival_span=args.serve_arrival_span,
            macro_k=args.serve_macro, batch_chars=args.serve_batch_chars,
            serve_kernel=args.serve_kernel, turn_ops=args.serve_turn_ops,
            journal_dir=args.serve_journal,
            snapshot_every=args.serve_snapshot_every,
            faults=args.serve_faults, reqtrace_samples=args.serve_reqtrace,
            slo_spec=args.serve_slo, device=args.device,
            log=lambda m: print(m, file=sys.stderr))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out = {
        "metric": (f"serve/repl/{args.serve_mix}/{args.serve_docs}x"
                   f"{args.serve_writers} replica patches/sec, "
                   f"K={args.serve_macro}, torch-"
                   f"{torch.device(args.device).type} ({rep['device']})"),
        "value": round(rep["patches_per_sec"], 1),
        "unit": "elements/sec",
    }
    out.update(rep)
    print(json.dumps(out))
    return 0 if (rep["verify_ok"] and rep["ra_ok"]
                 and rep["faults_ok"]) else 1


def _open_refusals(args) -> str | None:
    """The JAX runner's refusals of the open-loop flags: the message of a
    refused combination, or None."""
    if args.serve_open is not None:
        # recovery and longhaul replay a closed-loop journal tail, the
        # tiered, streamed and reshard families are bench ids of their own
        unsupported = [
            ("--serve-longhaul", args.serve_longhaul > 0),
            ("--serve-recover", args.serve_recover),
            ("--serve-crash-round", args.serve_crash_round > 0),
            ("--serve-reshard", args.serve_reshard is not None),
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
        return None
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
    return None


def _serve(args) -> int:
    """Drain the serving fleet once (or soak it, or sweep its offered load);
    one JSON line; 1 if verify or the chaos gate fails or an anomaly is
    still active."""
    from ..serve.bench import run_serve_bench

    if args.serve_writers > 1:
        return _serve_repl(args)
    why = _open_refusals(args)
    if why:
        print(why, file=sys.stderr)
        return 2
    if args.serve_record_evict and args.serve_journal is not None:
        print("--serve-record-evict requires a journal-less drain: "
              "recovery re-adopts the spool members the GC reclaims",
              file=sys.stderr)
        return 2
    if args.serve_stream_scaling and (args.serve_soak is not None
                                      or args.serve_open_sweep is not None):
        print("--serve-stream-scaling attaches the fleet-size probe table "
              "to ONE serve run's report; it does not compose with "
              "--serve-soak / --serve-open-sweep", file=sys.stderr)
        return 2
    rates = None
    if args.serve_open_sweep is not None:
        try:
            rates = [float(x) for x in args.serve_open_sweep.split(",")
                     if x.strip()]
        except ValueError:
            print(f"--serve-open-sweep: bad rate list "
                  f"{args.serve_open_sweep!r}", file=sys.stderr)
            return 2
    scaling = None
    if args.serve_stream_scaling:
        # the fleet-size probe table: one fresh process a (size, mode)
        # cell (ru_maxrss only grows in a process), riding this run's
        # report as construction.scaling
        from ..serve.construction import scaling_table

        try:
            sizes = _ints(args.serve_stream_scaling)
        except ValueError:
            print(f"--serve-stream-scaling: bad size list "
                  f"{args.serve_stream_scaling!r}", file=sys.stderr)
            return 2
        scaling = scaling_table(
            sizes, mix=args.serve_mix, seed=args.seed,
            arrival_span=args.serve_arrival_span,
            arrival_dist=args.serve_arrival_dist,
            serve_tiers=args.serve_tiers, device=args.device,
            log=lambda m: print(m, file=sys.stderr))
    try:
        run, extra = run_serve_bench, dict(
            construction_scaling=scaling, status_port=args.serve_status,
            timeseries_path=args.serve_timeseries,
            timeseries_window=args.serve_timeseries_window)
        if args.serve_soak is not None:
            from ..serve.bench import run_serve_soak

            run, extra = run_serve_soak, dict(
                soak_seconds=args.serve_soak,
                status_port=args.serve_status,
                timeseries_path=args.serve_timeseries,
                timeseries_window=args.serve_timeseries_window,
                watchdog_s=args.serve_watchdog)
        elif rates is not None:
            # the knee sweep: each offered rate probed, then the configured
            # rate drained with the knee attached
            from functools import partial

            from ..serve.bench import run_serve_open_sweep

            run = partial(run_serve_open_sweep, rates)
        rep = run(
            mix=args.serve_mix, n_docs=args.serve_docs,
            batch=args.serve_batch, classes=_ints(args.serve_classes),
            slots=_ints(args.serve_slots), seed=args.seed,
            arrival_span=args.serve_arrival_span, macro_k=args.serve_macro,
            batch_chars=args.serve_batch_chars,
            verify_sample=args.serve_verify_sample,
            serve_kernel=args.serve_kernel, serve_tiers=args.serve_tiers,
            arrival_dist=args.serve_arrival_dist,
            journal_dir=args.serve_journal,
            snapshot_every=args.serve_snapshot_every,
            snapshot_keep=args.serve_snapshot_keep,
            snapshot_full_every=args.serve_full_every,
            wal_segment_bytes=args.serve_wal_segment_bytes,
            longhaul=args.serve_longhaul,
            measure_recovery=bool(args.serve_recover),
            crash_after=args.serve_crash_round,
            faults=args.serve_faults, queue_cap=args.serve_queue_cap,
            overflow_policy=args.serve_overflow_policy,
            stream=bool(args.serve_stream),
            record_evict=bool(args.serve_record_evict),
            trace_path=args.serve_trace,
            reqtrace_samples=args.serve_reqtrace, slo_spec=args.serve_slo,
            flight_path=args.serve_flight, reshard_spec=args.serve_reshard,
            open_spec=args.serve_open, tenants_spec=args.serve_tenants,
            deadline=bool(args.serve_deadline),
            deadline_budget=args.serve_deadline_budget, device=args.device,
            log=lambda m: print(m, file=sys.stderr), **extra,
        )
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    family = ("serve/reshard" if args.serve_reshard
              else "serve/longhaul" if args.serve_longhaul
              else "serve/tier" if args.serve_tiers
              else "serve/open" if args.serve_open else "serve")
    ing = rep.get("ingest")
    if ing is not None:
        # the ingest and knee summaries (stderr: stdout is the one line)
        fr, dl = ing["front"], ing["deadline"]
        print(f"  ingest: {fr['ops_delivered']} ops / {fr['ops_frames']} "
              f"frames over {fr['sessions_opened']} sessions "
              f"({fr['sessions_resumed']} resumed, {fr['churn_drops']} churn "
              "drops); "
              + "; ".join(f"{t}: admit {d['admitted_ops']} defer "
                          f"{d['deferred_ops']} shed {d['shed_ops']}"
                          for t, d in sorted(
                              ing["admission"]["tenants"].items()))
              + f"; deadline hit rate {dl['hit_rate']:.3f} "
              f"({'EDF' if dl['edf'] else 'rr'})", file=sys.stderr)
    knee = rep.get("knee")
    if knee is not None:
        print(f"  knee: capacity {knee['capacity_ops_per_round']:.1f} "
              f"ops/round over {len(knee['points'])} probes: "
              + ", ".join(f"u={p['utilization']:.2f}:p99 "
                          f"{p['p99_ms']:.1f}ms" for p in knee["points"]),
              file=sys.stderr)
    out = {
        "metric": (f"{family}/{args.serve_mix}/{args.serve_docs} fleet "
                   f"patches/sec, K={args.serve_macro}, torch-"
                   f"{torch.device(args.device).type} ({rep['device']})"),
        "value": round(rep["patches_per_sec"], 1),
        "unit": "elements/sec",
    }
    out.update(rep)
    print(json.dumps(out))
    return 0 if (rep["verify_ok"] and rep["faults_ok"]
                 and rep["anomalies_ok"]) else 1


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
        ("--serve-kernel", str, "fused", SERVE_KERNELS),
        ("--serve-tiers", str, None),
        ("--serve-arrival-dist", str, "uniform", ("uniform", "zipf")),
        ("--serve-writers", int, 0), ("--serve-turn-ops", int, 64),
        ("--serve-reshard", str, None),
    )
    for flag, typ, default, *choices in serve_flags:
        ap.add_argument(flag, type=typ, choices=choices[0] if choices else None,
                        help=f"serve (default {default})")
    # the journal's flags, with the JAX runner's defaults and help
    journal_flags = (
        ("--serve-journal", str, None, "DIR",
         "enable the write-ahead op journal + snapshot barriers in DIR "
         "('auto' = an owned temp dir, removed after the run)"),
        ("--serve-snapshot-every", int, 32, "N",
         "fleet snapshot barrier period in macro-rounds (journal mode "
         "only)"),
        ("--serve-snapshot-keep", int, 2, "N",
         "retained snapshot CHAINS (a delta's base links always survive "
         "with it; <=0 = never prune).  Also the WAL GC floor: segments "
         "are kept back to the oldest retained barrier so chain fallback "
         "always finds its redo tail"),
        ("--serve-full-every", int, 4, "N",
         "every Nth barrier is a chain-rooting FULL snapshot; the "
         "barriers between persist only rows dirty since the previous "
         "one as a CRC-chained DELTA (1 = every barrier full, the "
         "pre-delta behavior)"),
        ("--serve-wal-segment-bytes", int, 1 << 20, "BYTES",
         "roll the active WAL file into a sealed numbered segment past "
         "this size; segments fully covered by a committed snapshot are "
         "garbage-collected crash-safely (0 = never roll, the "
         "pre-segmentation behavior)"),
        ("--serve-longhaul", int, 0, "H",
         "the serve/longhaul/<mix>/<fleet> durability family: synthetic "
         "streams carry H-times the band op count (days-of-edits "
         "scale), the journal is required, and the run ends with a "
         "measured recovery leg (recover_ms + redo span + chain depth "
         "in the report)"),
        ("--serve-crash-round", int, 0, "N",
         "inject a crash: kill the drain after N macro-rounds and gate "
         "the run on the recovered fleet's oracle byte-verify (implies "
         "--serve-recover)"),
    )
    for flag, typ, _default, metavar, text in journal_flags:
        ap.add_argument(flag, type=typ, metavar=metavar, help=text)
    # the chaos run's flags, with the JAX runner's defaults and help
    fault_flags = (
        ("--serve-faults", str, None, "SPEC", None,
         "seeded chaos drain: serve/faults.py spec, e.g. "
         "'seed=7,span=8,spool_corrupt=1,device_loss=1,queue_overflow=1,"
         "dup_batch=1,stall=1'"),
        ("--serve-queue-cap", int, 0, "N", None,
         "bound each doc's pending op queue (0 = unbounded legacy "
         "behavior; overflow past the cap is an explicit defer/shed "
         "decision)"),
        ("--serve-overflow-policy", str, "defer", None, ("defer", "shed"),
         "decision at a queue-cap overflow: backpressure the producer "
         "(defer) or tail-drop the session's remaining ops (shed; surfaced "
         "as shed_ops + lossy_docs)"),
    )
    for flag, typ, _default, metavar, choices, text in fault_flags:
        ap.add_argument(flag, type=typ, metavar=metavar, choices=choices,
                        help=text)
    stream_flags = (
        ("--serve-stream", "streaming fleet construction: the fleet is a "
         "lazy FleetSpec, each doc's trace tensorized at its first "
         "admission (off the drain by the prefetcher with --serve-tiers); "
         "set-up cost and host memory scale with the active set"),
        ("--serve-record-evict", "reclaim drained docs' pool records and "
         "spool members mid-drain (two-phase GC, serve/pool.py "
         "gc_drained_docs): the footprint tracks the active set.  "
         "Journal-less drains only (recovery re-adopts spool members)"),
    )
    for flag, text in stream_flags:
        ap.add_argument(flag, action="store_true", default=None, help=text)
    ap.add_argument("--serve-stream-scaling", default=None,
                    metavar="N1,N2,...",
                    help="construction probe table: one fresh process per "
                    "(fleet size, mode) cell (serve/construction.py), run "
                    "before the drain and carried in its construction block")
    # the telemetry's flags, with the JAX runner's help
    telemetry_flags = (
        ("--serve-trace", str, None, "PATH",
         "arm the obs/trace.py span tracer for the drain and write "
         "Perfetto-loadable Chrome trace JSON to PATH (validated after)"),
        ("--serve-status", int, None, "PORT",
         "start the obs/status.py live status server on 127.0.0.1:PORT (0 "
         "= ephemeral, bound port logged): /healthz, /status.json, and "
         "/metrics in Prometheus text exposition"),
        ("--serve-timeseries", str, None, "PATH",
         "stream closed obs/timeseries.py windows as JSONL to PATH (also "
         "arms the windowed recorder: the report gains a versioned "
         "'timeseries' block)"),
        ("--serve-timeseries-window", int, 8, "N",
         "macro-rounds folded per time-series window"),
        ("--serve-reqtrace", int, 0, "N",
         "arm obs/reqtrace.py request tracing, keeping the last N sampled "
         "request traces (0 = disarmed; the report gains a versioned "
         "'reqtrace' block with per-request segments and exemplars)"),
        ("--serve-slo", str, None, "SPEC",
         "per-class latency objectives, class=pQ:MS[,class=pQ:MS...], e.g. "
         "'default=p99:250,c4096=p99.9:1500'; arms request tracing, exports "
         "burn-rate gauges on /metrics and /status.json, and adds a "
         "versioned 'slo' block (a malformed spec exits 2)"),
        ("--serve-flight", str, None, "PATH",
         "arm the obs/flight.py flight recorder: recent rounds, request "
         "traces and the registry, dumped atomically to PATH on an anomaly, "
         "an unrecovered fault or a crash (python -m "
         "crdt_benches_tpu_torch.obs.flight PATH validates it)"),
        ("--serve-soak", float, None, "SECONDS",
         "soak mode: drain re-seeded fleets back to back for SECONDS (0 = "
         "one drain) under one telemetry bundle with the obs/anomaly.py "
         "detectors armed; exits 1 when an anomaly is still active at the "
         "end"),
        ("--serve-watchdog", float, 0.0, "SECONDS",
         "stuck-round watchdog threshold for soak mode (0 = auto: 25x the "
         "rolling median steady-round latency, floored at 1 s)"),
    )
    for flag, typ, _default, metavar, text in telemetry_flags:
        ap.add_argument(flag, type=typ, metavar=metavar, help=text)
    # the open-loop family's flags, with the JAX runner's help
    ingest_flags = (
        ("--serve-open", str, None, "RATE",
         "open-loop live serving (serve/ingest/): start the sessioned TCP "
         "ingest front and offer RATE ops/macro-round over seeded arrivals "
         "('RATE' or 'RATE:poisson' / 'RATE:burst'); the family becomes "
         "serve/open/<mix>/<fleet>, the per-doc queue cap defaults on "
         "(8*batch) and delivery flows only through per-tenant admission"),
        ("--serve-tenants", str, None, "SPEC",
         "ingest admission tenants, 'name=RATE[:BURST[:BUDGET]],...': token "
         "refill per round, bucket depth (default 4*RATE), in-queue op "
         "budget (default unbounded); e.g. 'gold=256:1024,free=16:32:256' "
         "(requires --serve-open)"),
        ("--serve-deadline-budget", int, 0, "N",
         "default per-doc deadline budget in macro-rounds past arrival (0 "
         "= derived from the offered load)"),
        ("--serve-open-sweep", str, None, "RATES",
         "offered-load sweep: probe the open-loop drain at each "
         "comma-separated rate, then run --serve-open's rate as the final "
         "drain with the p99-vs-utilization knee curve attached (requires "
         "--serve-open)"),
    )
    for flag, typ, _default, metavar, text in ingest_flags:
        ap.add_argument(flag, type=typ, metavar=metavar, help=text)
    ap.add_argument("--serve-deadline", action="store_true", default=None,
                    help="earliest-deadline-first selection over per-class "
                    "latency budgets (serve/ingest/deadline.py) instead of "
                    "round-robin (requires --serve-open)")
    ap.add_argument("--serve-recover", action="store_true", default=None,
                    help="measure the recovery-time objective after the "
                    "drain: drop the live fleet, recover a fresh one from "
                    "the journal directory, resume the redo tail, "
                    "byte-verify vs the oracle (requires --serve-journal)")
    serve_flags += tuple((flag, typ, default)
                         for flag, typ, default, *_ in journal_flags)
    serve_flags += tuple((flag, typ, default)
                         for flag, typ, default, *_ in fault_flags)
    serve_flags += tuple((flag, typ, default)
                         for flag, typ, default, *_ in telemetry_flags)
    serve_flags += tuple((flag, typ, default)
                         for flag, typ, default, *_ in ingest_flags)
    serve_flags += (("--serve-recover", bool, False),
                    ("--serve-deadline", bool, False),
                    ("--serve-stream", bool, False),
                    ("--serve-record-evict", bool, False),
                    ("--serve-stream-scaling", str, None))
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
        for flag, _, default, *_ in serve_flags:
            key = flag[2:].replace("-", "_")
            if getattr(args, key) is None:
                setattr(args, key, default)
        if args.serve_tiers is not None:
            from ..serve.bench import parse_tier_spec

            try:
                parse_tier_spec(args.serve_tiers, _ints(args.serve_slots))
            except ValueError as e:
                ap.error(f"--serve-tiers: {e}")
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
