"""The ``serve/repl`` bench family: writer groups at fleet scale.

Bench id ``serve/repl/<mix>/<fleet>x<writers>``: ``fleet`` logical
documents, each served by ``writers`` writer replicas (``fleet * writers``
pool rows).  Beside the plain serve figures the report holds the merge
throughput (peers' unit ops merged into replica rows a second of drain
wall time: the paper's downstream family at fleet scale), the broadcast
fan-out (packed op-lane bytes delivered to remote replicas), the divergence
and convergence windows, and the ``replication`` block
(``ReplicatedScheduler.replication_block``).

The gate is the verification tier: after the drain every replica of every
logical doc decodes byte-identical to the oracle (convergence), and the
sampled broadcast histories satisfy the RA-linearizability axioms
(``checker.py``).  ``faults`` arms the two replication kinds
(``replica_partition``, ``merge_reorder``) through the plain family's
seeded ``FaultPlan`` grammar.
"""

from __future__ import annotations

import shutil
import tempfile

import torch

from ..._build import kernels
from ...device import resolve_device
from ...lint import race_sanitizer
from ..bench import (
    _arm_sanitizers,
    _disarm_sanitizers,
    arm_reqtrace,
    parse_sanitize,
    parse_slo,
)
from ..faults import FaultInjector, FaultPlan
from ..journal import OpJournal
from ..pool import DocPool
from ..scheduler import prepare_streams
from ..workload import build_fleet
from .broadcast import REMOTE_LAG
from .checker import (
    ConvergenceReport,
    check_convergence,
    check_ra_linearizability,
)
from .group import build_writer_groups
from .scheduler import ReplicatedScheduler


def run_serve_repl_bench(
    mix="mixed",
    n_docs: int = 512,
    writers: int = 4,
    batch: int = 64,
    classes=(256, 1024, 4096, 8192, 49152),
    slots=(2048, 512, 128, 32, 16),
    seed: int = 0,
    arrival_span: int = 8,
    bands: dict | None = None,
    macro_k: int = 8,
    batch_chars: int = 256,
    serve_kernel: str = "fused",
    turn_ops: int = 64,
    history_sample: int = 16,
    spool_dir: str | None = None,
    journal_dir: str | None = None,
    snapshot_every: int = 32,
    faults=None,
    reqtrace_samples: int = 0,
    slo_spec: str | None = None,
    sanitize=(),
    device: str | torch.device = "cuda",
    pool_hook=None,
    log=print,
) -> dict:
    """Build a replicated fleet, drain it, run the convergence and
    RA-linearizability checks; returns the report, with ``verify_ok``
    (every replica byte-identical to the oracle), ``ra_ok`` and
    ``faults_ok``.  ``journal_dir`` (``"auto"``: an owned temp dir) arms
    the journal with a barrier every ``snapshot_every`` rounds;
    ``sanitize`` arms sanitizers as ``run_serve_bench``'s does; the report
    carries the race sanitizer's ``thread_crossings`` block (this family
    alone drives the broadcast bus's publish point).  ``pool_hook(pool)``
    runs just before the drain."""
    sanitize = parse_sanitize(sanitize)
    if writers < 1:
        raise ValueError(f"writers must be >= 1, got {writers}")
    classes, slots = tuple(classes), tuple(slots)
    mix_name = mix if isinstance(mix, str) else "custom"
    plan = None
    if faults is not None:
        plan = (faults if isinstance(faults, FaultPlan)
                else FaultPlan.from_spec(faults))
        if any(e.kind == "queue_overflow" for e in plan.events):
            # the replicated family has no bounded producer queue (the bus
            # paces delivery), so the event could never fire
            raise ValueError(
                "queue_overflow needs the plain family's bounded queue "
                "(--serve-queue-cap); the replicated family's delivery "
                "pacing is the broadcast bus's")
    slo = parse_slo(slo_spec)  # before any resource is taken
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels()  # built and loaded before the clock starts
    owns_journal = journal_dir == "auto"
    if owns_journal:
        journal_dir = tempfile.mkdtemp(prefix="crdt_repl_journal_")
    journal = OpJournal(journal_dir) if journal_dir else None
    reqtrace = arm_reqtrace(reqtrace_samples, slo, slo_spec, log,
                            prefix="serve/repl")
    pool = None
    armed_here = _arm_sanitizers(sanitize, dev, log)
    try:
        # the publish-point counters start before the first publish
        race_sanitizer.reset_counters()
        log(f"serve/repl: building fleet n_docs={n_docs} x writers="
            f"{writers} mix={mix_name} seed={seed}")
        sessions = build_fleet(n_docs, mix=mix, seed=seed,
                               arrival_span=arrival_span, bands=bands)
        replica_sessions, table = build_writer_groups(sessions, writers)
        pool = DocPool(classes=classes, slots=slots, spool_dir=spool_dir,
                       serve_kernel=serve_kernel, device=dev)
        streams = prepare_streams(replica_sessions, pool, batch=batch,
                                  batch_chars=batch_chars)
        total_ops = sum(s.remaining for s in streams.values())
        log(f"serve/repl: {len(table)} groups, {len(replica_sessions)} "
            f"replica rows, {total_ops} range ops staged fleet-wide, "
            f"turn_ops={turn_ops} lag={REMOTE_LAG} K={macro_k} "
            f"kernel={serve_kernel} on {dev}")
        sched = ReplicatedScheduler(
            pool, streams, table, turn_ops=turn_ops,
            history_sample=history_sample, seed=seed, batch=batch,
            macro_k=macro_k, batch_chars=batch_chars,
            faults=FaultInjector(plan) if plan else None, journal=journal,
            snapshot_every=snapshot_every, reqtrace=reqtrace, slo=slo)
        if pool_hook is not None:
            pool_hook(pool)
        stats = sched.run()
        if not sched.done:
            raise RuntimeError(
                "replicated scheduler stopped with pending work")
        rate = stats.patches / stats.wall_time
        merge_rate = sched.merged_unit_ops / stats.wall_time
        bus = sched.bus
        log(f"serve/repl: drained in {stats.wall_time:.2f}s over "
            f"{stats.rounds} macro-rounds -> {rate:,.0f} replica-patches/s,"
            f" merge {merge_rate:,.0f} unit-ops/s ({sched.merged_ops} "
            f"remote / {sched.local_ops} local range ops), broadcast "
            f"{bus.bytes_broadcast / 1024:.1f} KiB over "
            f"{bus.blocks_delivered_remote} deliveries, divergence max "
            f"{bus.divergence_max} blocks")
        report = ConvergenceReport()
        check_convergence(pool, table, sessions, streams, report)
        check_ra_linearizability(bus, table, report)
        log(f"serve/repl: convergence — {report.replicas_checked} replicas "
            f"across {report.groups_checked} groups "
            + ("all byte-identical to oracle" if report.converged
               else f"MISMATCH x{len(report.byte_mismatches)}: "
                    f"{report.byte_mismatches[:4]}")
            + (f" ({len(report.lossy_groups)} lossy groups excluded)"
               if report.lossy_groups else ""))
        log(f"serve/repl: RA-linearizability — {report.ra_groups_checked} "
            "sampled histories "
            + ("all axioms hold" if report.ra_ok
               else f"VIOLATIONS: {report.ra_violations[:4]}"))
        fault_summary = plan.summary() if plan is not None else None
        faults_ok = fault_summary is None or (
            fault_summary["unrecovered"] == 0
            and fault_summary["not_fired"] == 0)
        if not faults_ok:
            log(f"serve/repl: FAULTS NOT CLEARED — "
                f"{fault_summary['unrecovered']} unrecovered, "
                f"{fault_summary['not_fired']} never fired")
        return {
            "family": "serve-repl",
            "mix": mix_name,
            "fleet_docs": n_docs,
            "writers": writers,
            "replica_rows": n_docs * writers,
            "seed": seed,
            "batch": batch,
            "batch_chars": batch_chars,
            "macro_k": macro_k,
            "serve_kernel": serve_kernel,
            "classes": list(classes),
            "slots": list(slots),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "patches": stats.patches,
            "wall_time": stats.wall_time,
            "rounds": stats.rounds,
            "device_rounds": stats.slices,
            "dispatches": stats.dispatches,
            "range_ops": stats.ops,
            "unit_ops": stats.unit_ops,
            "patches_per_sec": rate,
            "merge_unit_ops_per_sec": merge_rate,
            "batch_latency": stats.latency_quantiles(),
            "compile_time": stats.compile_time,
            "compile_rounds": stats.compile_rounds,
            "steady_rounds": stats.steady_rounds,
            "occupancy_mean": stats.occupancy.mean,
            "evictions": stats.evictions,
            "restores": stats.restores,
            "promotions": stats.promotions,
            "coalesce_ratio": stats.coalesce_ratio,
            "pad_fraction": stats.pad_fraction,
            "phase_seconds": dict(stats.phase_seconds),
            "replication": sched.replication_block(),
            "convergence": report.to_dict(),
            "faults": fault_summary,
            "faults_ok": faults_ok,
            "journal": None if journal is None else {
                "records": journal.records,
                "bytes": journal.bytes_written,
                "snapshots": stats.snapshots,
                "snapshot_every": snapshot_every,
            },
            "metrics": stats.metrics.to_dict(),
            # the family that drives the bus's publish point; the surfaces
            # it never arms are recorded False
            "thread_crossings": {
                "sanitized": "races" in sanitize,
                "status": False,  # the family refuses --serve-status
                "journal": journal is not None,
                "bus": True,
                "prefetch": False,  # a flat pool, no tiers
                "ingest": False,  # the family refuses --serve-open
                "publishes": race_sanitizer.counters()["publishes"],
                "crossings": (race_sanitizer.counters()["crossings"]
                              if "races" in sanitize else None),
            },
            "reqtrace": reqtrace.block() if reqtrace.armed else None,
            "slo": slo.block() if slo is not None else None,
            "verify_ok": report.converged,
            "ra_ok": report.ra_ok,
        }
    finally:
        _disarm_sanitizers(armed_here)
        reqtrace.release()
        if journal is not None:
            journal.close()
        if owns_journal:
            shutil.rmtree(journal_dir, ignore_errors=True)
        if pool is not None:
            pool.close()
