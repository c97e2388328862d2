"""The serving fleet's benchmark (the JAX package's ``serve/bench.py``
``run_serve_bench``, its core, its tiered residency and its journal):
build the fleet, construct the pool, prepare the streams, drain once,
verify against the oracle, report.  ``serve_tiers`` (``hot=ROWS,warm=DOCS``,
:func:`parse_tier_spec`) scales the device rows and arms the warm tier
and its prefetcher; the report then gains a ``residency`` block and the
metric id is ``serve/tier/<mix>/<fleet>``.

``journal_dir`` arms the write-ahead journal and snapshot barriers (the
report's ``journal`` block).  ``measure_recovery`` adds the recovery
leg: a fresh pool recovers from the journal directory alone
(``recover_ms``), resumes the redo tail (``redo_ms``) and is verified
against the oracle (the ``recovery`` block).  ``crash_after`` stops the
drain after that many macro-rounds, and the verdict then rides on the
recovered fleet alone; ``longhaul`` (``serve/longhaul/<mix>/<fleet>``)
multiplies the synthetic streams' op counts and implies the leg.

``faults`` (a ``serve/faults.py`` spec or FaultPlan) makes the drain a
seeded chaos run; ``queue_cap`` bounds each doc's pending ops with
``overflow_policy`` (defer or shed) deciding at the cap.  The report then
carries the fault events and the robustness counters, and ``faults_ok``
holds when every event fired and recovered.  Docs whose ops were shed by
an explicit decision (overflow shed, quarantine) are lossy: verification
leaves them out, and an empty verify set fails the gate.

``stream`` builds the fleet lazily (streaming construction): a
``FleetSpec`` and ``LazyStreams`` in place of ``build_fleet`` and
``prepare_streams``, every doc born in genesis and its stream tensorized at
first admission (off the drain by the prefetcher when a warm tier arms it);
it refuses the journal and the durability legs.  ``record_evict`` reclaims
drained docs' pool records and spool members mid-drain (journal-less
drains only); the verify then covers the docs whose records survive.  The
report's ``construction`` block (both modes) holds the construction time
(fleet build to a ready scheduler), the RSS after it and at its peak, the
materialized, released and prefetch-built docs, the genesis docs left and
``construction_scaling`` (``serve/construction.py scaling_table``'s rows).

``open_spec`` (``RATE[:poisson|burst]``, ``serve/ingest/``) makes the drain
open-loop (``serve/open/<mix>/<fleet>``): the ops arrive over a live
loopback TCP front at that offered load while the fleet drains, pass the
per-tenant admission (``tenants_spec``, ``serve/ingest/admission.py``
grammar; one ``default`` tenant at twice the rate otherwise) into bounded
queues (``8 * batch`` unless ``queue_cap`` says), and are selected by
``DeadlineScheduler`` (earliest-deadline-first with ``deadline``, over a
budget of ``deadline_budget`` rounds or one derived from the load).  The
report then carries the ``ingest`` block, and the ``conn_churn`` and
``tenant_flood`` fault kinds are polled.  :func:`run_serve_open_sweep`
probes the drain at several offered rates and attaches the
p99-against-utilization ``knee`` block to the configured rate's run.

Telemetry (``obs/``; each report block is None when disarmed):
``trace_path`` arms the span tracer for the drain and writes (and
validates) the Chrome trace there; ``status_port`` starts the loopback
status server (0: an ephemeral port; ``/healthz``, ``/status.json``,
``/metrics``), ``timeseries_path`` streams the closed time-series windows
as JSON lines (either arms the windowed recorder: the ``timeseries``
block); ``reqtrace_samples`` and ``slo_spec`` (``class=pQ:MS``, parsed
before any resource is taken) arm request tracing and the SLO accounting
(the ``reqtrace`` and ``slo`` blocks); ``flight_path`` arms the flight
recorder, dumped on an anomaly, an unrecovered fault or a crash out of the
drain (the ``flight`` block).  The ``metrics`` block (the drain's whole
registry) and ``doc_drain_latency`` (per cause tag) are always there.
:func:`run_serve_soak` drains re-seeded fleets back to back under one
telemetry bundle with the anomaly detectors armed (the ``anomalies``
block); ``anomalies_ok`` fails when an anomaly is still active at the end.

Timed region: the drain, from the first macro-round to the final device
fence (``FleetScheduler.run``).  The metric is fleet patches per second
(every session's trace patches over the drain's wall time).  Verification
replays each verified doc's trace through the oracle and compares the
decoded document byte for byte: every document by default, or a seeded
per-class sample of ``verify_sample`` docs.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .._build import kernels
from ..bench.harness import summarize
from ..device import resolve_device
from ..lint import (
    SANITIZERS,
    boundary,
    fs_sanitizer,
    lifecycle_sanitizer,
    race_sanitizer,
    range_sanitizer,
    sanitizer,
)
from ..obs import trace as obs_trace
from ..obs.anomaly import AnomalyDetector
from ..obs.flight import FlightRecorder
from ..obs.profiler import DeviceProfiler
from ..obs.reqtrace import RequestTracker
from ..obs.slo import SloTracker
from ..obs.status import StatusServer
from ..obs.timeseries import ServeTelemetry, TimeseriesRecorder
from ..oracle.text_oracle import replay_trace
from .construction import current_rss_bytes, peak_rss_bytes
from .faults import (
    INGEST_KINDS,
    JOURNAL_KINDS,
    REPLICATION_KINDS,
    RESHARD_KINDS,
    TIER_KINDS,
    FaultInjector,
    FaultPlan,
)
from .ingest.admission import (
    DEFAULT_TENANT,
    AdmissionController,
    TenantPolicy,
    parse_tenant_spec,
)
from .ingest.deadline import DeadlineScheduler
from .ingest.front import IngestFront
from .ingest.loadgen import (
    IngestPump,
    OpenLoadClient,
    build_open_plan,
    drive_open_loop,
    parse_open_spec,
)
from ..parallel.mesh import fleet_mesh
from .journal import DEFAULT_SEGMENT_BYTES, OpJournal, recover_fleet
from .pool import DocPool
from .reshard import (
    ReshardCoordinator,
    check_shard_partition,
    parse_reshard_spec,
)
from .scheduler import FleetScheduler, LazyStreams, prepare_streams
from .workload import FleetSpec, build_fleet


def parse_slo(slo_spec):
    """The fail-fast parse of a ``--serve-slo`` spec (None when unset): the
    only raising step of arming request tracing, called before any
    resource is taken, so a malformed spec fails with nothing to
    release."""
    return SloTracker.from_spec(slo_spec) if slo_spec else None


def arm_reqtrace(samples, slo, slo_spec, log, prefix="serve"):
    """Construct (and log) the request tracker; nothing here raises (the
    spec was parsed by :func:`parse_slo`)."""
    reqtrace = RequestTracker(samples=samples, slo=slo)
    if reqtrace.armed:
        log(f"{prefix}: request tracing ARMED (samples="
            f"{reqtrace.samples_cap}"
            + (f", slo={slo_spec}" if slo_spec else "") + ")")
    return reqtrace


def build_telemetry(*, status_port: int | None = None,
                    timeseries_path: str | None = None,
                    timeseries_window: int = 8, anomaly: bool = False,
                    watchdog_s: float = 0.0,
                    stale_after: float | None = None,
                    flight_path: str | None = None,
                    log=print) -> ServeTelemetry | None:
    """The continuous-telemetry bundle a serve run threads through its
    scheduler(s): the windowed time-series recorder (armed by any of
    these), the status server (started here; ``stale_after`` seconds
    without a publish turn ``/healthz`` 503), the soak anomaly detectors
    (``watchdog_s`` 0: the stuck-round threshold is 25x the rolling steady
    median) and the flight recorder.  None when nothing is armed."""
    if status_port is None and not timeseries_path and not anomaly \
            and not flight_path:
        return None
    telemetry = ServeTelemetry(
        recorder=TimeseriesRecorder(window_rounds=timeseries_window,
                                    stream_path=timeseries_path),
        anomaly=AnomalyDetector(watchdog_s=watchdog_s) if anomaly else None,
        status=(StatusServer(port=status_port, stale_after=stale_after)
                if status_port is not None else None),
        flight=FlightRecorder(flight_path) if flight_path else None,
    )
    if telemetry.flight is not None:
        log(f"serve: flight recorder armed -> {flight_path} (dumped on an "
            "anomaly, an unrecovered fault or a crash)")
    if telemetry.status is not None:
        port = telemetry.status.start()
        log(f"serve: status server on http://127.0.0.1:{port} "
            "(/healthz /status.json /metrics)")
    if timeseries_path:
        log(f"serve: time-series stream -> {timeseries_path}")
    return telemetry


def parse_tier_spec(spec: str, slots: tuple[int, ...]
                    ) -> tuple[tuple[int, ...], int]:
    """The ``--serve-tiers hot=ROWS,warm=DOCS`` grammar.

    ``hot=ROWS`` scales the per-class slot table proportionally so the
    total device-row budget lands at ~ROWS (each class keeps >= 2 rows
    so every capacity class stays servable); ``warm=DOCS`` bounds the
    host warm tier (and arms the prefetcher).  ``hot`` may be omitted:
    ``warm=256`` alone keeps ``slots``.  Returns ``(slots, warm_docs)``."""
    hot = None
    warm = None
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"tier spec token {tok!r}: expected k=v")
        key, val = tok.split("=", 1)
        key = key.strip()
        if key == "hot":
            hot = int(val)
        elif key == "warm":
            warm = int(val)
        else:
            raise ValueError(
                f"tier spec: unknown key {key!r} (expected hot/warm)"
            )
    if warm is None or warm <= 0:
        raise ValueError(
            f"tier spec {spec!r}: warm=DOCS (> 0) is required — the "
            "three-tier pool IS the warm tier"
        )
    if hot is not None:
        if hot < 2 * len(slots):
            raise ValueError(
                f"tier spec: hot={hot} below the floor of 2 rows per "
                f"capacity class ({2 * len(slots)})"
            )
        total = sum(slots)
        slots = tuple(
            max(2, round(s * hot / total)) for s in slots
        )
    return slots, warm


def _verify_ids(pool: DocPool, doc_ids, verify_sample: int,
                vseed: int, lossy: set[int]) -> list[int]:
    """Every id of ``doc_ids`` not in ``lossy`` (``verify_sample`` 0), or a
    sample of about ``verify_sample`` of them spread over every final class,
    drawn with seed ``vseed`` (the JAX bench's rule: ceil(sample / classes)
    per class)."""
    if verify_sample <= 0:
        return [d for d in doc_ids if d not in lossy]
    by_class: dict[int, list[int]] = {}
    for d in doc_ids:
        if d in lossy:
            continue
        rec = pool.docs[d]
        cls = rec.cls or pool.class_for(max(rec.length, 1))
        by_class.setdefault(cls, []).append(d)
    per_class = max(1, -(-verify_sample // max(1, len(by_class))))
    rng = np.random.default_rng(vseed)
    out: list[int] = []
    for cls in sorted(by_class):
        ids = by_class[cls]
        out.extend(int(x) for x in rng.choice(
            ids, size=min(per_class, len(ids)), replace=False))
    return out


def _check_fault_plan(plan: FaultPlan, *, warm_docs: int, journal_dir,
                      snapshot_every: int, snapshot_full_every: int,
                      wal_segment_bytes: int, queue_cap: int, batch: int,
                      log, reshard: bool = False,
                      open_loop: bool = False) -> int:
    """Refuse a plan whose kinds this drain never polls, or whose
    injection points it cannot reach, with the JAX bench's messages: a
    loud configuration error up front instead of a drain that ends with
    ``not_fired`` events (the reshard kinds are polled when ``reshard``
    is armed, the ingest kinds when ``open_loop`` is).  Returns the queue
    cap (``8 * batch`` for a ``queue_overflow`` plan without one)."""
    kinds = {e.kind for e in plan.events}
    hit = sorted(kinds & set(REPLICATION_KINDS))
    if hit:
        raise ValueError(
            f"fault kinds {hit} need a replicated fleet (--serve-writers >= "
            "2, serve/replicate/); a plain serve drain never polls them")
    hit = sorted(kinds & set(INGEST_KINDS))
    if hit and not open_loop:
        raise ValueError(
            f"fault kinds {hit} target the live ingest front: --serve-open "
            "is required — a closed-loop replay never polls them")
    hit = sorted(kinds & set(RESHARD_KINDS))
    if hit and not reshard:
        raise ValueError(
            f"fault kinds {hit} kill the live-reshard coordinator between "
            "its manifest commit and the per-doc moves: --serve-reshard is "
            "required — a fixed shard map never reaches the injection "
            "point")
    tier_kinds = sorted(kinds & set(TIER_KINDS))
    if tier_kinds and not warm_docs:
        raise ValueError(
            f"fault kinds {tier_kinds} target the warm tier / prefetcher: "
            "--serve-tiers is required — a two-tier drain never reaches "
            "their injection points")
    if queue_cap <= 0 and "queue_overflow" in kinds:
        queue_cap = 8 * batch
        log(f"serve: queue_overflow faults need a bounded queue; "
            f"defaulting queue_cap={queue_cap}")
    journal_kinds = sorted(kinds & set(JOURNAL_KINDS))
    if journal_kinds:
        if not journal_dir:
            raise ValueError(
                f"fault kinds {journal_kinds} target the durability "
                "subsystem (WAL GC / delta chains): --serve-journal is "
                "required — a journal-less drain never reaches their "
                "injection points")
        if snapshot_every <= 0:
            raise ValueError(
                f"fault kinds {journal_kinds} fire at snapshot barriers: "
                "--serve-snapshot-every must be > 0")
        if "delta_corrupt" in journal_kinds and snapshot_full_every <= 1:
            raise ValueError(
                "delta_corrupt needs delta barriers: --serve-full-every "
                "must be > 1 (1 = every barrier full, so no delta ever "
                "exists)")
        if "crash_compact" in journal_kinds and wal_segment_bytes <= 0:
            raise ValueError(
                "crash_compact needs sealed WAL segments to collect: "
                "--serve-wal-segment-bytes must be > 0")
    return queue_cap


def parse_sanitize(sanitize) -> tuple[str, ...]:
    """The words of a ``sanitize`` argument (a tuple or a comma-separated
    string), each one of ``lint.SANITIZERS``; ValueError otherwise."""
    words = (tuple(w.strip() for w in sanitize.split(",") if w.strip())
             if isinstance(sanitize, str) else tuple(sanitize or ()))
    bad = [w for w in words if w not in SANITIZERS]
    if bad:
        raise ValueError(f"--serve-sanitize: unknown sanitizer(s) {bad}; "
                         f"choose from {','.join(SANITIZERS)}")
    return words


#: ``sanitize`` word -> the module its ``arm()`` and ``disarm()`` belong to
#: (``lint.boundary`` is the decorator there, its module is here)
_SANITIZER_MODULES = {
    "syncs": sanitizer, "races": race_sanitizer, "fs": fs_sanitizer,
    "lifecycle": lifecycle_sanitizer, "ranges": range_sanitizer,
    "boundaries": sys.modules[boundary.__module__],
}


def _arm_sanitizers(words, dev, log) -> list:
    """Arm the sanitizers of ``words`` that are not armed already (the
    sync sanitizer adds the native tripwire on a CUDA device: the drain
    thread is the only one issuing CUDA work in every serve family);
    returns the modules armed here, for :func:`_disarm_sanitizers`."""
    armed = []
    for w in words:
        mod = _SANITIZER_MODULES[w]
        if mod.armed():
            continue
        mod.arm()
        armed.append(mod)
    if words:
        log(f"serve: sanitizers ARMED: {','.join(words)}"
            + (" (native sync tripwire on)"
               if "syncs" in words and dev.type == "cuda" else ""))
    return armed


def _disarm_sanitizers(mods) -> None:
    for mod in mods:
        mod.disarm()


def sanitizer_blocks(sanitize, *, stats, pool, journal, chaos: bool, coord,
                     stream: bool, front, serve_kernel: str, flight: bool,
                     status: bool, log=print) -> dict:
    """The report's sanitizer blocks, JAX's keys: ``boundary_syncs`` (fence
    entries, and the syncs in each while armed), ``thread_crossings``
    (publish-point entries and, armed, the cross-thread reads),
    ``fs_ops`` (protocol entries and, armed, their operations),
    ``lifecycle`` (machine edges, resource pairs) and ``ranges`` (staged
    checks and masks).  Each block's surface flags say which parts of
    the stack the run exercised."""
    words = set(sanitize)
    sync_counts = sanitizer.counters()
    syncs_armed = "syncs" in words
    boundary_syncs = {
        "sanitized": syncs_armed,
        "chaos": chaos,
        "journal": journal is not None,
        # FlightRecorder.trigger is a fence crossed only by a drain that
        # dumped; the reshard fences only by a reshard run
        "flight": flight,
        "reshard": coord is not None,
        "entries": sync_counts["entries"],
        "syncs": sync_counts["syncs"] if syncs_armed else None,
    }
    log("serve: boundary syncs — "
        + (", ".join(f"{k.split('.')[-1]}={v}"
                     for k, v in sync_counts["entries"].items()) or "none")
        + (f"; observed {sum(sync_counts['syncs'].values())} fenced "
           "transfers" if syncs_armed else ""))
    race_counts = race_sanitizer.counters()
    races_armed = "races" in words
    thread_crossings = {
        "sanitized": races_armed,
        "status": status,
        "journal": journal is not None,
        "bus": False,  # only the replicated family drives the bus
        "prefetch": pool.prefetcher is not None,
        "ingest": front is not None,
        "publishes": race_counts["publishes"],
        "crossings": race_counts["crossings"] if races_armed else None,
    }
    log("serve: thread crossings — publishes "
        + (", ".join(f"{k.split('.')[-1]}={v}"
                     for k, v in race_counts["publishes"].items())
           or "none")
        + (f"; {sum(race_counts['crossings'].values())} cross-thread "
           "accesses attributed" if races_armed else ""))
    fs_counts = fs_sanitizer.counters()
    fs_armed = "fs" in words
    spool = (stats.evictions + stats.restores + pool.warm_evictions) > 0
    reshard_began = coord is not None and coord.state != "idle"
    fs_ops = {
        "version": 1,
        "sanitized": fs_armed,
        "journal": journal is not None,
        "spool": spool,
        "flight": flight,
        "reshard": reshard_began,
        "protocols": fs_counts["protocols"],
        "ops": fs_counts["ops"] if fs_armed else None,
        "unattributed": fs_counts["unattributed"] if fs_armed else None,
    }
    lc_counts = lifecycle_sanitizer.counters()
    lifecycle = {
        "version": 1,
        "sanitized": "lifecycle" in words,
        "pool": spool,
        "reshard": reshard_began,
        "stream": stream,
        "ingest": front is not None,
        "journal": journal is not None,
        "prefetch": pool.prefetcher is not None,
        "machines": lc_counts["machines"],
        "resources": lc_counts["resources"],
        "unattributed": lc_counts["unattributed"],
    }
    range_counts = range_sanitizer.counters()
    ranges = {
        "version": 1,
        "sanitized": "ranges" in words,
        "staging": True,
        "fused": serve_kernel == "fused",
        "scan": serve_kernel == "scan",
        "checks": range_counts["checks"],
        "masks": range_counts["masks"],
    }
    log("serve: fs protocols — entries "
        + (", ".join(f"{k}={v}" for k, v in fs_counts["protocols"].items())
           or "none")
        + (f"; {sum(n for t in fs_counts['ops'].values() for n in t.values())}"
           " fs ops attributed" if fs_armed else ""))
    return {"boundary_syncs": boundary_syncs,
            "thread_crossings": thread_crossings, "fs_ops": fs_ops,
            "lifecycle": lifecycle, "ranges": ranges}


def run_serve_bench(
    mix: str = "mixed",
    n_docs: int = 4096,
    batch: int = 64,
    classes: tuple[int, ...] = (256, 1024, 4096, 8192, 49152),
    slots: tuple[int, ...] = (2048, 512, 128, 32, 16),
    seed: int = 0,
    arrival_span: int = 8,
    arrival_dist: str = "uniform",
    mesh_devices: int = 0,
    sample_seed: int | None = None,
    bands: dict | None = None,
    macro_k: int = 8,
    batch_chars: int = 256,
    verify_sample: int = 0,
    serve_kernel: str = "fused",
    serve_tiers: str | None = None,
    journal_dir: str | None = None,
    snapshot_every: int = 32,
    snapshot_keep: int = 2,
    snapshot_full_every: int = 4,
    wal_segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    journal_fsync: bool = False,
    longhaul: int = 0,
    measure_recovery: bool = False,
    crash_after: int = 0,
    faults=None,
    queue_cap: int = 0,
    overflow_policy: str = "defer",
    delivery: str | None = None,
    stream: bool = False,
    record_evict: bool = False,
    construction_scaling: list | None = None,
    trace_path: str | None = None,
    status_port: int | None = None,
    timeseries_path: str | None = None,
    timeseries_window: int = 8,
    telemetry: ServeTelemetry | None = None,
    reqtrace_samples: int = 0,
    slo_spec: str | None = None,
    flight_path: str | None = None,
    reshard_spec: str | None = None,
    open_spec: str | None = None,
    tenants_spec: str | None = None,
    deadline: bool = False,
    deadline_budget: int = 0,
    knee_block: dict | None = None,
    profile_rounds: int = 0,
    sanitize=(),
    device: str | torch.device = "cuda",
    pool_hook=None,
    log=print,
) -> dict:
    """Build, drain and verify one fleet through ``serve_kernel``
    (``serve/pool.py SERVE_KERNELS``), with three-tier residency when
    ``serve_tiers`` is given (:func:`parse_tier_spec`); returns the
    report.  ``journal_dir`` (``"auto"``: an owned temp dir, removed after
    the run) arms the journal with a barrier every ``snapshot_every``
    macro-rounds (a full one every ``snapshot_full_every``-th, keeping
    ``snapshot_keep`` chains) and WAL segments of ``wal_segment_bytes``;
    ``measure_recovery``, ``crash_after`` and ``longhaul`` as the module
    says.  ``faults``, ``queue_cap`` and ``overflow_policy`` as the module
    says (a plan with ``queue_overflow`` and no cap gets ``8 * batch``);
    ``delivery="banded"`` paces each session's producer (``workload.py
    DELIVERY_BURST``); ``bands`` overrides the band sizing table.
    ``stream``, ``record_evict`` and ``construction_scaling`` as the
    module says, and the telemetry arguments too; a ``telemetry`` bundle
    given by the caller (the soak's) is used as it is and not closed.
    ``reshard_spec`` (``serve/reshard.py`` grammar, e.g.
    ``shrink:8:6@16,batch=64``) changes the shard map mid-drain on a pool
    of the spec's logical shards (the ``serve/reshard/<mix>/<fleet>``
    family, journal required): the report gains a ``reshard`` block, and
    the shard partition invariant joins the verify gate.
    ``open_spec``, ``tenants_spec``, ``deadline``, ``deadline_budget`` and
    ``knee_block`` (the sweep's, attached to the report) as the module
    says.  ``mesh_devices`` (> 1) shards every bucket's rows over a
    ``fleet_mesh`` of that many shards (the report's ``mesh_devices``; the
    placement is logged), which refuses the warm tier, the recovery leg and
    the open loop, as JAX does.  ``sample_seed`` draws the verify sample
    (default ``seed + 1``; the construction block records it).
    ``profile_rounds`` (> 0) captures that many steady rounds under the
    device profiler (``obs/profiler.py``: the ``profile`` block).
    ``sanitize`` (words of ``lint.SANITIZERS``, or a comma-separated
    string: ``syncs``, ``races``, ``fs``, ``lifecycle``, ``ranges``,
    ``boundaries``) arms those sanitizers for the run (``syncs`` on a CUDA
    device with the native sync tripwire, ``lint/sanitizer.py``); each
    is disarmed again at the end.  Armed or not, the report carries their
    counters: the ``boundary_syncs``, ``thread_crossings``, ``fs_ops``,
    ``lifecycle`` and ``ranges`` blocks.
    ``pool_hook(pool)``, if given, runs on the pool just before the
    drain (``chip_smoke.py`` arms the pool's CUDA-event spans or zeroes
    the kernels' counts there)."""
    sanitize = parse_sanitize(sanitize)
    warm_docs = 0
    if serve_tiers:
        slots, warm_docs = parse_tier_spec(serve_tiers, slots)
        if mesh_devices > 1:
            raise ValueError(
                "--serve-tiers is single-host for now (the warm tier "
                "composes through host boundary moves; the mesh form "
                "is the silicon-campaign item, see ROADMAP)"
            )
    longhaul = max(0, int(longhaul))
    if longhaul or crash_after:
        measure_recovery = True
    if measure_recovery and not journal_dir:
        raise ValueError(
            "the recovery leg (--serve-recover / --serve-longhaul / "
            "--serve-crash-round) measures journal recovery: "
            "--serve-journal is required"
        )
    if measure_recovery and mesh_devices > 1:
        raise ValueError(
            "--serve-mesh is not supported with the measured recovery "
            "leg (the recovered fleet is rebuilt single-host)"
        )
    if warm_docs and longhaul:
        raise ValueError(
            "--serve-tiers and --serve-longhaul are separate bench "
            "families (serve/tier/* vs serve/longhaul/*); pick one"
        )
    # open-loop serving (serve/open/<mix>/<fleet>): the live ingest front,
    # per-tenant admission and the deadline-aware scheduler; the arrivals
    # come over the wire at an offered load, not from the trace replay
    open_rate, open_process = 0.0, ""
    policies = None
    if open_spec:
        open_rate, open_process = parse_open_spec(open_spec)
        if longhaul or warm_docs:
            raise ValueError(
                "--serve-open is its own bench family (serve/open/*); "
                "--serve-longhaul / --serve-tiers do not compose with it"
            )
        if measure_recovery or crash_after:
            raise ValueError(
                "--serve-open does not support the measured recovery "
                "leg (--serve-recover / --serve-crash-round): the "
                "open-loop drain has no resumable closed-loop replay"
            )
        if mesh_devices > 1:
            raise ValueError(
                "--serve-open is single-host for now (the ingest pump "
                "feeds one scheduler's bounded queues)"
            )
        if queue_cap <= 0:
            # the pump delivers through the bounded-queue rule; unbounded
            # queues would make admission meaningless
            queue_cap = 8 * batch
            log(f"serve: open-loop needs a bounded queue; "
                f"defaulting queue_cap={queue_cap}")
        # parsed before any resource is taken, as the SLO spec is
        policies = (parse_tenant_spec(tenants_spec) if tenants_spec
                    else {DEFAULT_TENANT: TenantPolicy(
                        DEFAULT_TENANT, rate=max(1.0, 2.0 * open_rate))})
    if tenants_spec and not open_spec:
        raise ValueError(
            "--serve-tenants configures the ingest admission "
            "controller: --serve-open is required"
        )
    if deadline and not open_spec:
        raise ValueError(
            "--serve-deadline selects EDF over the ingest deadline "
            "budgets: --serve-open is required"
        )
    # streaming construction rides the closed-loop families (serve/ and
    # serve/tier/); the legs that replay eagerly built streams refuse it
    if stream:
        if longhaul or measure_recovery or crash_after:
            raise ValueError(
                "--serve-stream does not compose with the durability "
                "legs (--serve-longhaul / --serve-recover / "
                "--serve-crash-round): journal recovery rebuilds "
                "eagerly prepared streams"
            )
        if journal_dir:
            raise ValueError(
                "--serve-stream does not compose with --serve-journal: "
                "the lazy path releases drained streams, which the "
                "journal's replay window would still reference"
            )
        if open_spec:
            raise ValueError(
                "--serve-stream does not compose with --serve-open: "
                "the open-loop plan tensorizes every stream up front"
            )
    # a live shard-map change (the serve/reshard/* family): every migration
    # decision is journaled, so the journal is required
    rplan = parse_reshard_spec(reshard_spec) if reshard_spec else None
    if rplan is not None:
        if not journal_dir:
            raise ValueError(
                "--serve-reshard journals every migration decision (the "
                "RESHARD_MANIFEST commit point lives in the journal dir): "
                "--serve-journal is required")
        if longhaul or warm_docs or open_spec or stream:
            raise ValueError(
                "--serve-reshard is its own bench family "
                "(serve/reshard/*); --serve-longhaul / --serve-tiers / "
                "--serve-open / --serve-stream do not compose with it")
        if mesh_devices <= 1 and rplan.n_shards < 2:
            raise ValueError(
                f"reshard spec {reshard_spec!r} does not determine a shard "
                "count: pass --serve-mesh, or drain:S,of=N for single-host "
                "logical sharding")
    mix_name = mix if isinstance(mix, str) else "custom"
    mix_label = (f"reshard/{mix_name}" if rplan is not None
                 else f"longhaul/{mix_name}" if longhaul
                 else f"tier/{mix_name}" if warm_docs
                 else f"open/{mix_name}" if open_rate else mix_name)
    plan = None
    if faults is not None:
        plan = (faults if isinstance(faults, FaultPlan)
                else FaultPlan.from_spec(faults))
        queue_cap = _check_fault_plan(
            plan, warm_docs=warm_docs, journal_dir=journal_dir,
            snapshot_every=snapshot_every,
            snapshot_full_every=snapshot_full_every,
            wal_segment_bytes=wal_segment_bytes, queue_cap=queue_cap,
            batch=batch, log=log, reshard=rplan is not None,
            open_loop=bool(open_spec))
    # a malformed --serve-slo spec fails here, before the journal's temp
    # dir or the telemetry's threads exist: nothing to release yet
    slo = parse_slo(slo_spec)
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels()  # build and load the kernels before the clock starts
    # the serve mesh: N shards placed by fleet_mesh (printed, never dropped)
    mesh = fleet_mesh(mesh_devices, dev) if mesh_devices > 1 else None
    owns_journal = journal_dir == "auto"
    if owns_journal:
        journal_dir = tempfile.mkdtemp(prefix="crdt_journal_")
    journal = (OpJournal(journal_dir, fsync=journal_fsync,
                         segment_bytes=wal_segment_bytes)
               if journal_dir else None)
    owns_telemetry = telemetry is None
    if owns_telemetry:
        telemetry = build_telemetry(
            status_port=status_port, timeseries_path=timeseries_path,
            timeseries_window=timeseries_window, flight_path=flight_path,
            log=log)  # None when nothing is armed
    # last before the try that releases it
    reqtrace = arm_reqtrace(reqtrace_samples, slo, slo_spec, log)
    pool = None
    # a live front is stopped on every exit path: a failed drain or verify
    # leaves no listening socket behind
    front = None
    armed_here = _arm_sanitizers(sanitize, dev, log)
    try:
        # the sanitizers' counters start before the first status publish
        # (the note_phase below publishes): each run owns its window
        race_sanitizer.reset_counters()
        fs_sanitizer.reset_counters()
        lifecycle_sanitizer.reset_counters()
        range_sanitizer.reset_counters()
        if journal_dir:
            fs_sanitizer.watch_root(journal_dir)
        if telemetry is not None:
            telemetry.note_phase("building")  # the staleness heartbeat
        # the construction window: the fleet (spec or sessions), the pool,
        # the streams and a ready scheduler, all before round 0 could run
        t0 = time.perf_counter()
        fleet_kw = dict(mix=mix, seed=seed, arrival_span=arrival_span,
                        arrival_dist=arrival_dist, bands=bands,
                        horizon=max(1, longhaul), delivery=delivery)
        spec = sessions = None
        if stream:
            spec = FleetSpec.build(n_docs, **fleet_kw)
        else:
            sessions = build_fleet(n_docs, **fleet_kw)
        # a reshard without a mesh runs on logical shards: the pool is
        # built with the spec's count; with a mesh the device count is the
        # shard count and the coordinator checks the spec against it
        pool_shards = (rplan.n_shards if rplan is not None and mesh is None
                       else None)
        pool = DocPool(classes=classes, slots=slots,
                       serve_kernel=serve_kernel, device=dev,
                       warm_docs=warm_docs, shards=pool_shards, mesh=mesh)
        fs_sanitizer.watch_root(pool.spool_dir)
        if mesh is not None:
            log(f"serve: mesh={mesh.size} ({mesh.describe()})")
        if stream:
            streams = LazyStreams(spec, pool, batch=batch,
                                  batch_chars=batch_chars)
            if mesh is not None:
                # the lazy fleet over a mesh: each shard's doc range is
                # arithmetic on the spec, no other shard's sessions read
                log("serve: streaming doc range over mesh — " + ", ".join(
                    "{}:[{},{})".format(s, *spec.shard_range(s, pool.n_sh))
                    for s in range(pool.n_sh)))
        else:
            streams = prepare_streams(sessions, pool, batch=batch,
                                      batch_chars=batch_chars)
        injector = FaultInjector(plan) if plan is not None else None
        profiler = (DeviceProfiler(profile_rounds, device=dev.type)
                    if profile_rounds > 0 else None)
        coord = None
        if rplan is not None:
            coord = ReshardCoordinator(pool, journal, rplan, faults=injector,
                                       telemetry=telemetry)
            log(f"serve: reshard ARMED: {rplan.kind} shards "
                f"{list(coord._shards)} of {pool.n_sh} (batch "
                f"{rplan.batch}/round; trigger "
                + (f"round {rplan.at_round}" if rplan.at_round is not None
                   else f"imbalance > {rplan.imbalance:g}"
                   if rplan.imbalance is not None else "round 2") + ")")
        sched_kw = dict(batch=batch, macro_k=macro_k,
                        batch_chars=batch_chars, queue_cap=queue_cap,
                        overflow_policy=overflow_policy, faults=injector,
                        journal=journal, snapshot_every=snapshot_every,
                        snapshot_keep=snapshot_keep,
                        snapshot_full_every=snapshot_full_every,
                        telemetry=telemetry, reqtrace=reqtrace, slo=slo,
                        drained_gc=record_evict, reshard=coord,
                        profiler=profiler)
        open_plan = admission = pump = load_client = None
        if open_rate:
            # delivery belongs to the ingest pump alone: burst 0 makes the
            # scheduler's own per-round delivery a no-op, so every op
            # reaches the bounded queues through the admission
            for st in streams.values():
                st.burst = 0
            admission = AdmissionController(policies, slo=slo,
                                            journal=journal)
            open_plan = build_open_plan(
                streams, rate=open_rate, process=open_process, seed=seed,
                tenant_names=tuple(policies))
            expected = -(-open_plan.total_ops // max(1, int(open_rate)))
            sched = DeadlineScheduler(
                pool, streams, edf=deadline,
                default_budget=deadline_budget or max(
                    64, 2 * expected + arrival_span),
                **sched_kw)
            log(f"serve: open-loop {open_process} arrivals at "
                f"{open_rate:g} ops/round over {len(open_plan.sessions)} "
                f"sessions ({open_plan.total_frames} frames, horizon "
                f"{open_plan.horizon} rounds); tenants "
                f"{','.join(sorted(policies))}; selection "
                f"{'EDF' if deadline else 'round-robin'}")
        else:
            sched = FleetScheduler(pool, streams, **sched_kw)
        setup_s = time.perf_counter() - t0
        rss_setup = current_rss_bytes()
        if stream:
            log(f"serve: {n_docs} docs ({mix}, seed {seed}) born in genesis "
                "(streaming construction): each stream tensorized at first "
                "admission" + (", off the drain by the prefetcher"
                               if pool.prefetcher is not None else "")
                + f"; classes {classes} slots {slots} batch {batch} chars "
                f"{batch_chars} K {macro_k} kernel {serve_kernel} on {dev}; "
                f"construction {setup_s * 1e3:.1f} ms, rss "
                f"{rss_setup / 2**20:.1f} MiB")
        else:
            total_ops = sum(s.remaining for s in streams.values())
            log(f"serve: {n_docs} docs ({mix}, seed {seed}"
                + (f", horizon x{longhaul}" if longhaul else "")
                + f"), {total_ops} range "
                f"ops, classes {classes} slots {slots} batch {batch} chars "
                f"{batch_chars} K {macro_k} kernel {serve_kernel} on {dev}, "
                f"mesh={mesh.size if mesh else 'off'}; "
                f"set-up {setup_s:.1f} s (construction "
                f"{setup_s * 1e3:.1f} ms, rss {rss_setup / 2**20:.1f} MiB)")
        if record_evict:
            log("serve: drained-doc record eviction: drained docs' records "
                "and spool members reclaimed in batches of 32")
        if warm_docs:
            log(f"serve: tiered residency: hot {sum(slots)} rows "
                f"({'/'.join(map(str, slots))}), warm {warm_docs} docs, "
                f"cold spool compressed, prefetch "
                f"{'armed' if pool.prefetcher is not None else 'off'}")
        if journal is not None:
            log(f"serve: journal {'(owned temp dir)' if owns_journal else journal_dir}"
                f": a barrier every {snapshot_every} macro-rounds, full "
                f"every {snapshot_full_every}, keep {snapshot_keep}, WAL "
                f"segments {wal_segment_bytes} B, fsync "
                f"{'on' if journal_fsync else 'off'}")
        if plan is not None or queue_cap:
            log(f"serve: faults {plan.spec if plan is not None else 'none'}"
                f" ({len(plan.events) if plan is not None else 0} events);"
                f" queue cap {queue_cap or 'unbounded'}, overflow policy "
                f"{overflow_policy}")
        # the fence counters cover the drain and the verify; armed, a sync
        # outside a declared fence raises inside run() at its callsite
        sanitizer.reset_counters()
        # the flight recorder may outlive a drain (the soak's bundle): the
        # boundary_syncs block keys on this drain's dumps
        flight_dumps0 = (telemetry.flight.dumps if telemetry is not None
                         and telemetry.flight is not None else 0)
        if pool_hook is not None:
            pool_hook(pool)
        if open_rate:
            # the front goes live last, just before the drain
            front = IngestFront(set(streams), tuple(admission.policies))
            admission.bind(sched.stats.metrics)
            port = front.start()
            log(f"serve: ingest front on 127.0.0.1:{port} "
                f"({len(open_plan.sessions)} sessions inbound)")
            pump = IngestPump(sched, front, admission,
                              tenant_of=open_plan.tenant_of,
                              faults=sched.faults)
            sched.ingest_status = pump.status_fields
            load_client = OpenLoadClient(port, open_plan)
        tracer, traced_here = None, False
        if trace_path:
            obs_trace.arm()
            traced_here = True
            log(f"serve: span tracer ARMED -> {trace_path}")
        profile_block = None
        try:
            if open_rate:
                load_client.start()
                stats = drive_open_loop(sched, pump, load_client)
                load_client.join()
                front.stop()
            else:
                # crash_after > 0: the injected crash stops the drain
                # after that many macro-rounds; the recovery leg resumes
                # from the journal
                stats = sched.run(max_rounds=crash_after or None)
        except BaseException as e:
            # the crash post-mortem: the flight window is dumped before
            # the exception leaves the drain (best effort: a failure here
            # must never replace the crash it documents)
            if telemetry is not None and telemetry.flight is not None:
                try:
                    telemetry.flight_dump(f"crash: {type(e).__name__}: {e}",
                                          status=sched.status_fields())
                except Exception:
                    pass
            raise
        finally:
            if traced_here:  # release only what this run armed
                tracer = obs_trace.disarm()
            if profiler is not None:
                # an open capture is closed (the device fenced first), also
                # when the drain raised
                profile_block = profiler.finalize(fence=pool.block)
        trace_errors = None
        if tracer is not None:
            tracer.write(trace_path)
            trace_errors = obs_trace.validate_trace_file(trace_path)
            log(f"serve: wrote {len(tracer.events)} trace events to "
                f"{trace_path} ("
                + ("valid" if not trace_errors
                   else f"INVALID: {trace_errors[:4]}") + ")")
        if profiler is not None:
            if profile_block is None:
                log("serve: profiler captured no steady rounds (drain too "
                    "short?)")
            else:
                log(f"serve: profiled {profile_block['rounds']} steady "
                    "rounds; top ops: " + ", ".join(
                        f"{o['name']} {o['total_ms']:.1f}ms"
                        for o in profile_block["top_ops"][:3]))
        if front is not None:
            ff = front.status_fields()
            dl = sched.deadline_fields()
            log(f"serve: ingest: {ff['ops_frames']} op frames / "
                f"{ff['ops_delivered']} ops over {ff['sessions_opened']} "
                f"sessions ({ff['sessions_resumed']} resumed, "
                f"{ff['churn_drops']} churn drops); "
                + "; ".join(
                    f"{t}: admit {d['admitted_ops']} defer "
                    f"{d['deferred_ops']} shed {d['shed_ops']}"
                    for t, d in sorted(
                        admission.status_fields()["tenants"].items()))
                + f"; deadline hit rate {dl['hit_rate']:.3f} ("
                + ("EDF" if dl["edf"] else "round-robin") + ")")
        crashed = crash_after > 0 and not sched.done
        if crash_after:
            log(f"serve: CRASH injected after {stats.rounds} macro-rounds "
                f"({'work pending' if crashed else 'drained'}); the "
                "recovery leg resumes from the journal")
        elif not sched.done:
            raise RuntimeError("scheduler stopped with pending work")
        if telemetry is not None:
            telemetry.drain_end(status={**sched.status_fields(),
                                        "phase": "done", "done": True})
            if telemetry.anomaly is not None:
                a = telemetry.anomaly
                log(f"serve: anomalies: {a.fired} fired, {a.uncleared} "
                    "uncleared" + (f" (active: {', '.join(a.active_kinds())})"
                                   if a.uncleared else ""))
        lat = stats.latency_quantiles()
        rate = stats.patches / stats.wall_time
        if plan is not None or stats.recoveries or stats.shed_ops:
            log(f"serve: faults: injected {stats.faults_injected}, "
                f"recoveries {stats.recoveries} (replayed "
                f"{stats.ops_replayed} ops over {stats.replay_dispatches} "
                f"dispatches), shed {stats.shed_ops} deferred "
                f"{stats.deferred_ops} dup-dropped {stats.dup_ops_dropped}, "
                f"quarantines {len(stats.quarantines)}, degraded rounds "
                f"{stats.degraded_rounds}, snapshots {stats.snapshots}")

        partition_errors: list[str] = []
        if coord is not None:
            rs = coord.summary()
            mid = rs["mid_latency"]
            log(f"serve: reshard: {rs['kind']} {rs['shards']} {rs['state']} "
                f"(begin r{rs['begin_round']} commit r{rs['commit_round']}, "
                f"{rs['rounds_active']} rounds); {rs['migrated']} row moves "
                f"+ {rs['evicted']} evictions, {rs['deferred_lanes']} lanes "
                f"deferred ({rs['deferred_ops']} ops), {rs['resumes']} "
                f"resumes; live shards {rs['live_shards']}/{pool.n_sh}"
                + (f"; mid-reshard round p99 {mid['p99'] * 1e3:.1f} ms"
                   if mid else ""))
            if not crashed:
                # every doc on exactly one shard, none on a retired one:
                # part of the gate, as the oracle is
                partition_errors = check_shard_partition(pool)
                if partition_errors:
                    log("serve: SHARD PARTITION VIOLATED: "
                        + "; ".join(partition_errors[:8]))

        t1 = time.perf_counter()
        session_of = {} if stream else {s.doc_id: s for s in sessions}
        oracle: dict = {}  # id(trace) or (band, source) -> content

        def mismatches(p: DocPool, ids) -> list[int]:
            out = []
            for d in ids:
                if stream:
                    # a lazy fleet derives the doc's session again from
                    # the spec (seed-stable: the trace its first admission
                    # tensorized); a synth trace is one a doc and
                    # transient, so only a band's shared window is cached
                    s = spec.session(d)
                    key = None if s.source == "synth" else (s.band, s.source)
                    tr = s.trace
                else:
                    tr = session_of[d].trace
                    key = id(tr)
                want = oracle.get(key) if key is not None else None
                if want is None:
                    want = replay_trace(tr)
                    if key is not None:
                        oracle[key] = want
                if p.decode(d) != want:
                    out.append(d)
            return out

        # docs whose ops an explicit decision shed cannot match a full
        # oracle replay: left out and listed.  An interrupted drain's pool
        # is mid-stream by design: the recovered fleet carries the gate.
        # A streamed fleet (every doc materialized by now) and record
        # eviction (the reclaimed docs have no record) walk the records
        lossy = sorted(d for d, st in streams.items() if st.lossy)
        cand = (sorted(pool.docs) if stream or record_evict
                else [s.doc_id for s in sessions])
        vseed = seed + 1 if sample_seed is None else int(sample_seed)
        ids = [] if crashed else _verify_ids(pool, cand, verify_sample,
                                             vseed, set(lossy))
        failures = mismatches(pool, ids)
        verify_s = time.perf_counter() - t1
        docs_per_class: dict[int, int] = {}
        for d in ids:
            rec = pool.docs[d]
            cls = rec.cls or pool.class_for(max(rec.length, 1))
            docs_per_class[cls] = docs_per_class.get(cls, 0) + 1
        # every verify candidate's final class (JAX's docs_per_class)
        fleet_per_class: dict[int, int] = {}
        lossy_set = set(lossy)
        for d in cand:
            if d not in lossy_set:
                rec = pool.docs[d]
                cls = rec.cls or pool.class_for(max(rec.length, 1))
                fleet_per_class[cls] = fleet_per_class.get(cls, 0) + 1
        verify_ok = bool(ids) and not failures and not partition_errors
        log(f"serve: drained in {stats.wall_time:.3f} s over {stats.rounds} "
            f"macro-rounds ({stats.slices} device rounds, "
            f"{stats.dispatches} dispatches) -> {rate:,.0f} patches/s; "
            + ("in-run verify skipped (injected crash)" if crashed else
               f"verified {len(ids)} docs in {verify_s:.1f} s: "
               + ("all byte-identical to the oracle" if verify_ok
                  else "EMPTY SAMPLE (all docs lossy?)" if not ids
                  else f"MISMATCH on docs {failures[:16]}")
               + (f" ({len(lossy)} lossy docs left out: {lossy[:16]})"
                  if lossy else "")
               + (f"; {sched.spool_gc_docs} drained docs' records "
                  f"reclaimed, {len(pool.docs)} left, the verify covers "
                  "those" if record_evict else "")))
        pf = pool.prefetcher
        hits, restores = pool.warm_hits, pool.restores
        residency = None if not warm_docs else {
            "version": 1,
            "tiers": serve_tiers,
            "hot_rows_budget": sum(slots),
            "warm_budget": warm_docs,
            "arrival_dist": arrival_dist,
            "hot_rows_final": pool.hot_rows,
            "warm_docs_final": len(pool.warm),
            "cold_docs_final": pool.cold_docs,
            "evictions": stats.evictions,
            "warm_hits": hits,
            "warm_evictions": pool.warm_evictions,
            "cold_restores": restores,
            "prefetch_hits": pool.prefetch_hits,
            "prefetch_submitted": pf.submitted if pf is not None else 0,
            "prefetch_harvested": pf.harvested if pf is not None else 0,
            "prefetch_dropped": pf.dropped if pf is not None else 0,
            "prefetch_errors": pf.errors if pf is not None else 0,
            "prefetch_wasted": sched.prefetch_wasted,
            "prefetch_missed": sched.prefetch_missed,
            # of the admissions that needed a doc's state back, the
            # share that avoided the synchronous cold read
            "hit_rate": (hits / (hits + restores)
                         if hits + restores else None),
        }
        if residency is not None:
            log(f"serve: residency: hot {pool.hot_rows}/{sum(slots)} rows, "
                f"warm {len(pool.warm)}/{warm_docs} docs, cold "
                f"{pool.cold_docs}; warm hits {hits} (prefetched "
                f"{pool.prefetch_hits}), cold restores {restores}, warm to "
                f"cold {pool.warm_evictions}, limbo pulls "
                f"{sched.limbo_pulls}; hit rate "
                + (f"{residency['hit_rate']:.3f}" if hits + restores
                   else "n/a"))
        journal_block = None
        if journal is not None:
            journal_block = {
                "dir": None if owns_journal else journal_dir,
                "records": journal.records,
                "bytes": journal.bytes_written,
                "fsync": journal_fsync,
                "snapshots": stats.snapshots,
                "snapshots_full": stats.snapshots_full,
                "snapshots_delta": stats.snapshots_delta,
                "snapshot_every": snapshot_every,
                "snapshot_full_every": snapshot_full_every,
                "snapshot_time": stats.snapshot_time,
                "segment_bytes": wal_segment_bytes,
                "segments_sealed": journal.segments_sealed,
                "gc_segments": journal.gc_segments,
                "disk_bytes": journal.on_disk_bytes(),
            }
            log(f"serve: journal: {journal.records} records, "
                f"{journal.bytes_written} B; {stats.snapshots} barriers "
                f"({stats.snapshots_full} full, {stats.snapshots_delta} "
                f"delta) in {stats.snapshot_time:.3f} s, barrier rounds "
                f"{stats.barrier_time:.3f} s; {journal.segments_sealed} "
                f"segments sealed, {journal.gc_segments} collected, "
                f"{journal_block['disk_bytes']} B of WAL on disk")

        # ---- the measured recovery leg: a fresh fleet recovers from the
        # journal directory alone, resumes the redo tail, is verified ----
        recovery_block = None
        recovery_drain = None
        if measure_recovery:
            if telemetry is not None:
                telemetry.note_phase("recovering")
            journal.close()  # flushed: the host state is disk-only now
            rpool = DocPool(classes=classes, slots=slots,
                            serve_kernel=serve_kernel, device=dev,
                            warm_docs=warm_docs, shards=pool_shards)
            try:
                rstreams = prepare_streams(sessions, rpool, batch=batch,
                                           batch_chars=batch_chars)
                t_rec = time.perf_counter()
                rep = recover_fleet(rpool, rstreams, journal_dir)
                if dev.type == "cuda":
                    # the restored buckets are on the device (a timing
                    # wait, not a fence of the drain's)
                    torch.cuda.synchronize(dev)
                recover_ms = (time.perf_counter() - t_rec) * 1e3
                rsched = FleetScheduler(rpool, rstreams, batch=batch,
                                        macro_k=macro_k,
                                        batch_chars=batch_chars,
                                        start_round=rep.resume_round)
                t_redo = time.perf_counter()
                rstats = rsched.run()
                redo_ms = (time.perf_counter() - t_redo) * 1e3
                if not rsched.done:
                    raise RuntimeError(
                        "recovered scheduler left pending work")
                rlossy = {d for d, st in rstreams.items() if st.lossy}
                rsample = [d for d in (ids or [s.doc_id for s in sessions])
                           if d not in rlossy]
                if crashed and verify_sample > 0:
                    cand = sorted(rsample)
                    rsample = [int(x) for x in np.random.default_rng(
                        seed + 2).choice(cand, size=min(verify_sample,
                                                        len(cand)),
                                         replace=False)] if cand else []
                rfail = mismatches(rpool, rsample)
                rpartition = (check_shard_partition(rpool)
                              if rplan is not None else [])
                if rpartition:
                    log("serve: recovered fleet SHARD PARTITION VIOLATED: "
                        + "; ".join(rpartition[:8]))
                recovered_ok = not rfail and bool(rsample) and not rpartition
                if plan is not None and recovered_ok:
                    # the durability kinds close on a proven recovery, and
                    # after a crash (the in-run sweep never ran) a full
                    # journal recovery repairs every fired fault: the dead
                    # pool's damage is irrelevant to the rebuilt fleet
                    for e in plan.events:
                        if e.fired and not e.recovered and (
                                crashed or e.kind in JOURNAL_KINDS):
                            e.recover(via="recovery_leg",
                                      fallbacks=rep.chain_fallbacks,
                                      gc_completed=rep.gc_segments_completed)
                wal_disk = journal.on_disk_bytes()
                recovery_block = {
                    "version": 1,
                    "recover_ms": recover_ms,
                    "redo_ms": redo_ms,
                    "redo_ops": rep.ops_replayed,
                    "chain_depth": rep.chain_depth,
                    "chain_fallbacks": rep.chain_fallbacks,
                    "snapshot_round": rep.snapshot_round,
                    "resume_round": rep.resume_round,
                    "torn_records": rep.torn_records,
                    "gc_segments_completed": rep.gc_segments_completed,
                    "staging_removed": rep.staging_removed,
                    "cold_start": rep.snapshot_round < 0,
                    "docs_restored": rep.docs_restored,
                    "spools_restored": rep.spools_restored,
                    "warm_restored": rep.warm_restored,
                    "journal_disk_bytes": wal_disk,
                    "verified_docs": len(rsample),
                    "verify_ok": recovered_ok,
                    "reshard_retired": rep.reshard_retired,
                    "reshard_docs_moved": rep.reshard_docs_moved,
                    "reshard_completed": rep.reshard_completed,
                }
                recovery_drain = {
                    "rounds": rstats.rounds,
                    "device_rounds": rstats.slices,
                    "dispatches": rstats.dispatches,
                    "range_ops": rstats.ops,
                    "wall_time": rstats.wall_time,
                    "phase_seconds": dict(rstats.phase_seconds),
                }
            finally:
                rpool.close()
            log(f"serve: recovery: {recover_ms:.1f} ms to restore "
                f"(snapshot round {rep.snapshot_round}, chain depth "
                f"{rep.chain_depth}, {rep.chain_fallbacks} fallbacks, "
                f"{rep.docs_restored} resident, {rep.spools_restored} "
                f"spooled, {rep.warm_restored} warm), {rep.ops_replayed} "
                f"redo ops in {redo_ms:.1f} ms ({rstats.rounds} rounds, "
                f"{rstats.dispatches} dispatches), WAL on disk {wal_disk} "
                f"B; {len(rsample)} recovered docs "
                + ("byte-identical to the oracle" if recovered_ok
                   else f"MISMATCH on {rfail[:16] or 'EMPTY SAMPLE'}"))
            verify_ok = recovered_ok if crashed else (verify_ok
                                                      and recovered_ok)
        construction = {
            "version": 1,
            "mode": "stream" if stream else "eager",
            "construction_ms": setup_s * 1e3,
            "rss_after_construction_bytes": rss_setup,
            "peak_rss_bytes": peak_rss_bytes(),
            "fleet_docs": n_docs,
            "materialized_docs": streams.materialized if stream else n_docs,
            "released_docs": streams.released if stream else 0,
            "prefetch_built": streams.prefetch_built if stream else 0,
            "genesis_docs_end": pool.genesis_docs,
            "verify_sample_seed": vseed,
            "scaling": construction_scaling,
            # record eviction: what it reclaimed, and the docs the verify
            # covered (the reclaimed ones have no record to decode)
            "spool_gc_docs": sched.spool_gc_docs,
            "records_end": len(pool.docs),
            "verified_docs": len(ids),
        }
        log(f"serve: construction ({construction['mode']}): "
            f"{construction['construction_ms']:.1f} ms, rss after "
            f"{rss_setup / 2**20:.1f} MiB, peak "
            f"{construction['peak_rss_bytes'] / 2**20:.1f} MiB; materialized "
            f"{construction['materialized_docs']} of {n_docs} docs ("
            f"{construction['prefetch_built']} built by the prefetcher), "
            f"released {construction['released_docs']}, genesis left "
            f"{construction['genesis_docs_end']}")
        fault_summary = plan.summary() if plan is not None else None
        faults_ok = fault_summary is None or (
            fault_summary["unrecovered"] == 0
            and fault_summary["not_fired"] == 0)
        if not faults_ok:
            log(f"serve: FAULTS NOT CLEARED: "
                f"{fault_summary['unrecovered']} unrecovered, "
                f"{fault_summary['not_fired']} never fired")
            if telemetry is not None and telemetry.flight is not None:
                # a fault that fired and stuck, or one that never fired:
                # both fail the run
                telemetry.flight_dump(
                    "unrecovered_fault" if fault_summary["unrecovered"]
                    else "unfired_fault",
                    status={**sched.status_fields(), "done": True})
        if reqtrace.armed:
            log(f"serve: requests: {reqtrace.requests_closed} closed "
                f"({reqtrace.reopened} re-admissions opened fresh "
                "contexts)")
        if slo is not None:
            for name, st_cls in sorted(slo.classes.items()):
                d = st_cls.to_dict()
                log(f"serve: slo {name}: compliance {d['compliance']:.4f} "
                    f"over {d['requests']} requests (objective "
                    f"p{st_cls.objective.quantile * 100:g} <= "
                    f"{st_cls.objective.threshold_s * 1e3:.0f} ms, burn "
                    f"fast {d['burn_rate_fast']:.2f} / slow "
                    f"{d['burn_rate_slow']:.2f})")
        anomalies_ok = (telemetry is None or telemetry.anomaly is None
                        or telemetry.anomaly.uncleared == 0)
        lint_blocks = sanitizer_blocks(
            sanitize, stats=stats, pool=pool, journal=journal,
            chaos=plan is not None, coord=coord, stream=stream,
            front=front, serve_kernel=serve_kernel,
            flight=(telemetry is not None and telemetry.flight is not None
                    and telemetry.flight.dumps > flight_dumps0),
            status=telemetry is not None and telemetry.status is not None,
            log=log)
        return {
            "bench_id": f"serve/{mix_label}/{n_docs}",
            "fleet_docs": n_docs, "mix": mix, "seed": seed,
            "batch": batch, "batch_chars": batch_chars, "macro_k": macro_k,
            "serve_kernel": serve_kernel,
            "classes": list(classes), "slots": list(slots),
            "mesh_devices": mesh.size if mesh else 0,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "patches": stats.patches,
            "wall_time": stats.wall_time,
            "patches_per_sec": rate,
            "batch_latency": lat,
            "compile_time": stats.compile_time,
            "compile_rounds": stats.compile_rounds,
            "barrier_time": stats.barrier_time,
            "barrier_rounds": stats.barrier_rounds,
            "rounds": stats.rounds,
            "device_rounds": stats.slices,
            "dispatches": stats.dispatches,
            "range_ops": stats.ops,
            "unit_ops": stats.unit_ops,
            "coalesce_ratio": stats.coalesce_ratio,
            "pad_fraction": stats.pad_fraction,
            "evictions": stats.evictions,
            "restores": stats.restores,
            "promotions": stats.promotions,
            "admissions": stats.admissions,
            "fresh_admits": pool.fresh_admits,
            "phase_seconds": dict(stats.phase_seconds),
            "setup_seconds": setup_s,
            "op_dtypes": [str(d) for d in pool.op_dtypes],
            "steady_rounds": stats.steady_rounds,
            "occupancy_mean": stats.occupancy.mean,
            "queue_depth_mean": stats.queue_depth.mean,
            "queue_depth_max": int(stats.queue_depth.vmax or 0),
            "docs_per_class": {str(c): n for c, n in
                               sorted(fleet_per_class.items())},
            "verify": "all" if verify_sample <= 0 else "sample",
            "verified_docs": len(ids),
            "verified_ids": sorted(ids),
            "verified_per_class": {str(c): n for c, n in
                                   sorted(docs_per_class.items())},
            "verify_seconds": verify_s,
            "verify_ok": verify_ok,
            "longhaul": longhaul,
            "crashed": crashed,
            # the robustness surface (JAX's artifact keys)
            "faults": fault_summary,
            "faults_ok": faults_ok,
            "fault_counts": None if injector is None else {
                "fired": dict(injector.fired_counts),
                "recovered": dict(injector.recovered_counts)},
            "queue_cap": queue_cap,
            "overflow_policy": overflow_policy,
            "shed_ops": stats.shed_ops,
            "deferred_ops": stats.deferred_ops,
            "overflow_events": stats.overflow_events,
            "backpressure_rounds": stats.backpressure_rounds,
            "dup_ops_dropped": stats.dup_ops_dropped,
            "stall_rounds": stats.stall_rounds,
            "quarantines": stats.quarantines,
            "recoveries": stats.recoveries,
            "ops_replayed": stats.ops_replayed,
            "replay_dispatches": stats.replay_dispatches,
            "mttr_rounds": summarize(stats.mttr_rounds),
            "degraded_rounds": stats.degraded_rounds,
            "lossy_docs": lossy,
            "reshard": (None if coord is None else {
                **coord.summary(), "partition_errors": partition_errors}),
            # the live ingest (None without open_spec): the offered load,
            # the front's and the client's counters, the per-tenant
            # admit/defer/shed, the deadline hit rate
            "ingest": None if front is None else {
                "version": 1,
                "open": open_plan.to_dict(),
                "front": front.status_fields(),
                "client": load_client.to_dict(),
                "admission": admission.to_dict(),
                "deadline": sched.deadline_fields(),
                "late_frames": pump.late_frames,
                "admitted_frames": pump.admitted_frames,
                "dup_frames": pump.dup_frames,
                "shed_docs": pump.shed_docs,
                "drained_frames": pump.drained_frames,
            },
            # the offered-load sweep's p99-against-utilization curve
            # (run_serve_open_sweep's final run only)
            "knee": knee_block,
            "journal": journal_block,
            "construction": construction,
            "recovery": recovery_block,
            "recovery_drain": recovery_drain,
            **({} if residency is None else {
                "arrival_dist": arrival_dist,
                "limbo_pulls": sched.limbo_pulls,
                "residency": residency}),
            # the telemetry (obs/): the registry and the per-cause drain
            # latency always; the rest None when disarmed
            "metrics": stats.metrics.to_dict(),
            "doc_drain_latency": {
                tag: {"count": h.count,
                      "quantiles": (h.quantiles((0.5, 0.99, 0.999))
                                    if h.count else None)}
                for tag, h in sorted(stats.doc_latency.items())},
            "timeseries": (telemetry.recorder.block()
                           if telemetry is not None
                           and telemetry.recorder is not None else None),
            "anomalies": (telemetry.anomaly.block()
                          if telemetry is not None
                          and telemetry.anomaly is not None else None),
            "reqtrace": reqtrace.block() if reqtrace.armed else None,
            "slo": slo.block() if slo is not None else None,
            "flight": (telemetry.flight.summary()
                       if telemetry is not None
                       and telemetry.flight is not None else None),
            "status_port": (telemetry.status.port
                            if telemetry is not None
                            and telemetry.status is not None else None),
            "trace": trace_path if tracer is not None else None,
            "trace_valid": (None if tracer is None
                            else not trace_errors),
            "anomalies_ok": anomalies_ok,
            # the device profiler's steady rounds (None without
            # profile_rounds) and the sanitizers' blocks
            "profile": profile_block,
            **lint_blocks,
        }
    finally:
        if front is not None:
            front.stop()  # idempotent: ends the handler threads on a crash
        reqtrace.release()
        if pool is not None:
            pool.close()
        if journal is not None:
            journal.close()
            if owns_journal:
                shutil.rmtree(journal_dir, ignore_errors=True)
        if owns_telemetry and telemetry is not None:
            telemetry.close()  # stop the status server, close the stream
        # last: the release of the run's files is the fs sanitizer's too
        _disarm_sanitizers(armed_here)


def run_serve_open_sweep(sweep_rates, *, open_spec: str, log=print,
                         **kw) -> dict:
    """The offered-load sweep: probe the open-loop drain at each rate of
    ``sweep_rates``, then run the configured rate (``open_spec``) as the
    final drain, its report carrying the measured knee curve as its
    ``knee`` block.

    Each probe is a whole open-loop drain (live front, real wire) at its
    rate with the heavy side-channels stripped (faults, the status
    server, the time-series, the profiler, the tracer, the journal: the
    probes measure latency against load and nothing else).  A probe
    records its offered rate, its served rate (``range_ops / rounds``),
    its p50/p99 round latency and its defer and shed tallies;
    ``capacity`` is the highest served rate any probe sustained, each
    point's utilization is ``offered / capacity``, and p99 against
    utilization is the knee curve."""
    rate, process = parse_open_spec(open_spec)
    rates = sorted({float(r) for r in sweep_rates} | {rate})
    points = []
    for probe_rate in rates:
        probe_kw = dict(kw)
        for heavy in ("faults", "status_port", "timeseries_path",
                      "profile_rounds", "trace_path", "journal_dir"):
            probe_kw.pop(heavy, None)
        rep = run_serve_bench(open_spec=f"{probe_rate:g}:{process}",
                              log=lambda *_a, **_k: None, **probe_kw)
        lat = rep["batch_latency"]
        served = rep["range_ops"] / max(1, rep["rounds"])
        points.append({
            "offered_rate": probe_rate,
            "served_rate": round(served, 3),
            "rounds": rep["rounds"],
            "p50_ms": round(lat["p50"] * 1e3, 4),
            "p99_ms": round(lat["p99"] * 1e3, 4),
            "deferred_ops": rep["deferred_ops"],
            "shed_ops": rep["shed_ops"],
            "verify_ok": bool(rep["verify_ok"]),
        })
        log(f"serve: sweep probe {probe_rate:g} ops/round: served "
            f"{served:.1f}, p99 {lat['p99'] * 1e3:.2f} ms, deferred "
            f"{rep['deferred_ops']} shed {rep['shed_ops']}")
    capacity = max(p["served_rate"] for p in points) or 1.0
    for p in points:
        p["utilization"] = round(p["offered_rate"] / capacity, 4)
    knee_block = {
        "version": 1,
        "process": process,
        "capacity_ops_per_round": capacity,
        "points": points,
    }
    log(f"serve: knee: capacity {capacity:.1f} ops/round over "
        f"{len(points)} probes; final run at {rate:g} (utilization "
        f"{rate / capacity:.2f})")
    return run_serve_bench(open_spec=open_spec, knee_block=knee_block,
                           log=log, **kw)


def run_serve_soak(soak_seconds: float = 0.0, *, seed: int = 0,
                   status_port: int | None = None,
                   timeseries_path: str | None = None,
                   timeseries_window: int = 8, watchdog_s: float = 0.0,
                   flight_path: str | None = None, log=print,
                   **kw) -> dict:
    """The soak harness: drain fleets back to back until ``soak_seconds``
    of wall time have passed (0: exactly one drain), each re-seeded
    (``seed + i``) and verified, under ONE telemetry bundle with the
    anomaly detectors armed (the time-series, detectors and status server
    run on across the drains; ``/healthz`` turns stale after 120 s without
    a publish; ``kw`` goes to every drain, the open-loop arguments among
    it).  Returns the last drain's report, its ``timeseries`` and
    ``anomalies`` blocks the whole soak's, with ``verify_ok`` and
    ``faults_ok`` the AND over every drain, ``anomalies_ok`` False when an
    anomaly is still active at the end, and ``iterations``."""
    telemetry = build_telemetry(
        status_port=status_port, timeseries_path=timeseries_path,
        timeseries_window=timeseries_window, anomaly=True,
        watchdog_s=watchdog_s, stale_after=120.0, flight_path=flight_path,
        log=log)
    t0 = time.perf_counter()
    i = 0
    verify_ok = faults_ok = True
    try:
        while True:
            rep = run_serve_bench(seed=seed + i, telemetry=telemetry,
                                  log=log, **kw)
            verify_ok &= rep["verify_ok"]
            faults_ok &= rep["faults_ok"]
            i += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= soak_seconds:
                break
            log(f"serve: soak {elapsed:.1f}/{soak_seconds:.0f} s: "
                f"iteration {i} done, draining again")
        a = telemetry.anomaly
        log(f"serve: soak done: {i} drain(s) in "
            f"{time.perf_counter() - t0:.1f} s; anomalies {a.fired} fired / "
            f"{a.uncleared} uncleared")
        return dict(rep, verify_ok=verify_ok, faults_ok=faults_ok,
                    anomalies_ok=a.uncleared == 0, iterations=i)
    finally:
        telemetry.close()
