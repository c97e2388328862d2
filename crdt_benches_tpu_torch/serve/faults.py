"""Deterministic fault injection for the serving engine (the JAX
package's ``serve/faults.py``).

A :class:`FaultPlan` is a seeded schedule of fault events parsed from a
compact spec string (the ``--serve-faults`` grammar); a
:class:`FaultInjector` is its runtime half — the scheduler polls hooks
at fixed points of every macro-round and the injector fires each event
exactly once, deterministically.  Everything is seeded: the same spec +
workload seed reproduces the same faults at the same rounds against the
same targets, so a chaos run is as replayable as a clean one.

Spec grammar (comma-separated ``key=value`` tokens)::

    seed=7,span=8,spool_corrupt=1,device_loss=1,queue_overflow=1

- ``seed``  — RNG seed for fire rounds / target picks (default 0)
- ``span``  — random fire rounds are drawn from ``[2, span]`` macro-
  rounds (default 8; events whose round never arrives before the drain
  ends are reported as not fired)
- ``stall_ms`` — host stall duration (default 40)
- ``burst``    — queue-overflow burst size in ops (default 4x the cap)
- fault kinds, each with an event count (``kind=N``) or an explicit
  fire round (``kind@round=N``):

  =================  ======================================================
  ``spool_corrupt``  flip bytes inside an existing eviction spool .npz
  ``spool_truncate`` truncate an existing spool to ~60% of its bytes
  ``device_loss``    clobber one capacity class's device state right
                     after a macro dispatch (mid-macro-round loss)
  ``dup_batch``      redeliver an op batch the doc already applied
                     (duplicated/reordered delivery; the cursor
                     high-water mark must drop it)
  ``stall``          sleep the host staging path for ``stall_ms``
  ``queue_overflow`` burst-deliver past a doc's bounded queue cap,
                     forcing an explicit shed/defer decision
  ``poison_rebuild`` make the targeted doc's rebuild fail (tests the
                     quarantine path; normally test-constructed)
  ``crash_compact``  kill the WAL segment GC pass mid-flight — between
                     its crash-safe manifest write and the unlinks
                     (journal mode only); the torn pass must be
                     completed by the next barrier, open, or recovery
  ``delta_corrupt``  flip bytes inside the newest delta snapshot's
                     member (journal mode with delta barriers only);
                     recovery must fall back down the CRC chain and
                     still byte-verify against the oracle
  ``replica_partition`` drop one replica's broadcast deliveries for a
                     span of rounds (serve/replicate/ only): the
                     replica's divergence window grows while its
                     writer-group peers advance, and the bus's
                     heal-time backlog flush must reconverge it
                     (``param`` = partition span in rounds, default 3)
  ``merge_reorder``  deliver one round's remote broadcast batches in a
                     permuted writer order (serve/replicate/ only);
                     sequence-keyed reassembly makes delivery order
                     commute, so byte-verify must stay green
  ``tier_evict_pressure`` force warm-tier churn under load (tiered
                     pool only): LRU warm entries are demoted to the
                     compressed cold spool mid-drain, so following
                     admissions pay the cold path (``param`` = entries
                     demoted, default half the tier)
  ``prefetch_miss``  drop one round's planned prefetch batch (tiered
                     pool only): the rehydrates never start, admission
                     takes the synchronous cold path and must stay
                     verify-green — the prefetcher is opportunism,
                     never a dependency
  ``conn_churn``     drop every live ingest connection at its next
                     frame (open-loop front only): clients must
                     reconnect-and-resume, and the idempotent delivery
                     high-water mark must absorb any redelivery —
                     recovery is a resumed session delivering ops
                     again
  ``tenant_flood``   one tenant's offered load is treated as inflated
                     by ``param``x (default 8) for a fixed window of
                     macro-rounds
                     (open-loop front only): admission must defer/shed
                     the flooder while other tenants keep admitting —
                     recovery is the flood window closing with the
                     pressure absorbed
  ``reshard_crash``  kill the reshard coordinator at its worst window:
                     AFTER the migration-manifest commit, BEFORE the
                     first per-doc move (reshard runs only): the next
                     round's tick (or ``recover_fleet``'s roll-forward)
                     must complete the reshard from the manifest alone
                     — recovery is the resumed coordinator committing
  =================  ======================================================

Every event records whether it fired and whether the engine recovered
from it; the bench artifact carries the full event list, and the chaos
smoke exits nonzero when any event goes unfired or unrecovered.

The port's scheduler polls the kinds of a single-host serve drain
(spool, device loss, duplicates, stalls, queue overflow, poisoned
rebuilds, the journal's and the warm tier's kinds); the replicated
scheduler (``serve/replicate/``) polls the replication kinds, the reshard
coordinator (``serve/reshard.py``) the reshard kind and the open-loop
ingest pump (``serve/ingest/loadgen.py``) the ingest kinds, and
``run_serve_bench`` refuses up front a kind its drain never polls.
Each firing is an instant on the span tracer's timeline
(``obs/trace.py``), and
:meth:`FaultInjector.bind_metrics` registers the per-kind
``serve.faults.fired.<kind>`` / ``serve.faults.recovered.<kind>`` counters
in a drain's registry (``fired_counts`` / ``recovered_counts`` read them).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..obs.metrics import MetricsRegistry
from ..obs.trace import instant


KINDS = (
    "spool_corrupt",
    "spool_truncate",
    "device_loss",
    "dup_batch",
    "stall",
    "queue_overflow",
    "poison_rebuild",
    "crash_compact",
    "delta_corrupt",
    "replica_partition",
    "merge_reorder",
    "tier_evict_pressure",
    "prefetch_miss",
    "conn_churn",
    "tenant_flood",
    "reshard_crash",
)

#: Kinds that need the write-ahead journal armed (``--serve-journal``):
#: they target the durability subsystem itself — a journal-less drain
#: never reaches their injection points, so ``run_serve_bench`` rejects
#: the combination up front instead of failing the chaos gate with a
#: confusing not_fired at drain end.
JOURNAL_KINDS = ("crash_compact", "delta_corrupt")

#: Kinds only the replicated scheduler (serve/replicate/) polls.  A
#: plain serve drain never fires them, so ``run_serve_bench`` rejects a
#: spec that arms them without ``--serve-writers`` up front — a loud
#: configuration error instead of a whole drain ending in a confusing
#: not_fired chaos-gate failure.
REPLICATION_KINDS = ("replica_partition", "merge_reorder")

#: Kinds that need the tiered pool (``--serve-tiers`` / warm_docs > 0):
#: they target the warm tier and the prefetcher — a two-tier drain
#: never reaches their injection points, so ``run_serve_bench`` rejects
#: the combination up front instead of ending in a confusing not_fired.
TIER_KINDS = ("tier_evict_pressure", "prefetch_miss")

#: Kinds only the open-loop ingest pump polls (``--serve-open``): they
#: target the live front and the admission controller — a closed-loop
#: replay has neither, so ``run_serve_bench`` rejects a spec that arms
#: them without the open-loop family up front instead of ending in a
#: confusing not_fired chaos-gate failure.
INGEST_KINDS = ("conn_churn", "tenant_flood")

#: Kinds only the reshard coordinator polls (``--serve-reshard``): they
#: target the live-migration state machine — a static-topology drain
#: never reaches the injection point, so ``run_serve_bench`` rejects a
#: spec that arms them without a reshard up front instead of ending in
#: a confusing not_fired chaos-gate failure.  (The reshard itself also
#: requires the journal: the manifest lives in the journal dir.)
RESHARD_KINDS = ("reshard_crash",)


@dataclass
class FaultEvent:
    kind: str
    round: int  # earliest macro-round the event may fire
    target: int | None = None  # doc id (or class) pin; None = pick live
    param: int = 0  # stall ms / burst ops / dup depth (0 = default)
    fired: bool = False
    fired_round: int = -1
    recovered: bool = False
    detail: dict = field(default_factory=dict)
    # per-kind fired/recovered registry counters, shared across a plan's
    # events (set by FaultInjector.bind_metrics; None outside an
    # instrumented drain)
    counters: dict | None = field(
        default=None, repr=False, compare=False
    )
    rec_counters: dict | None = field(
        default=None, repr=False, compare=False
    )

    def fire(self, rnd: int, **detail) -> None:
        self.fired = True
        self.fired_round = rnd
        self.detail.update(detail)
        if self.counters is not None:
            self.counters[self.kind].inc()
        # timeline marker (no-op unless span tracing is armed); the
        # constant event name keeps G012 happy — kind rides in args
        instant("serve.fault", kind=self.kind, round=rnd)

    def recover(self, **detail) -> None:
        """Mark the event recovered (idempotent), counting it once in the
        per-kind recovered counter."""
        if detail:
            self.detail.update(detail)
        if not self.recovered:
            self.recovered = True
            if self.rec_counters is not None:
                self.rec_counters[self.kind].inc()

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "round": self.round,
            "fired": self.fired,
            "fired_round": self.fired_round,
            "recovered": self.recovered,
            "target": self.target,
            "detail": self.detail,
        }


class FaultPlan:
    """A seeded, ordered fault schedule."""

    def __init__(self, events: list[FaultEvent], seed: int = 0,
                 stall_ms: int = 40, burst: int = 0, spec: str = ""):
        self.events = sorted(events, key=lambda e: (e.round, e.kind))
        self.seed = seed
        self.stall_ms = stall_ms
        self.burst = burst
        self.spec = spec

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        seed, span, stall_ms, burst = 0, 8, 40, 0
        counts: list[tuple[str, int | None, int]] = []  # (kind, round, n)
        for tok in str(spec).split(","):
            tok = tok.strip()
            if not tok:
                continue
            if "=" not in tok:
                raise ValueError(f"fault spec token {tok!r}: expected k=v")
            key, val = tok.split("=", 1)
            key, val = key.strip(), int(val)
            if key == "seed":
                seed = val
            elif key == "span":
                span = max(2, val)
            elif key == "stall_ms":
                stall_ms = val
            elif key == "burst":
                burst = val
            else:
                rnd = None
                if "@" in key:
                    key, at = key.split("@", 1)
                    rnd = int(at)
                if key not in KINDS:
                    raise ValueError(
                        f"fault spec: unknown kind {key!r} "
                        f"(expected one of {KINDS})"
                    )
                counts.append((key, rnd, val))
        rng = np.random.default_rng(seed)
        events = []
        for kind, rnd, n in counts:
            for _ in range(max(0, n)):
                r = rnd if rnd is not None else int(rng.integers(2, span + 1))
                events.append(FaultEvent(kind=kind, round=r))
        return cls(events, seed=seed, stall_ms=stall_ms, burst=burst,
                   spec=spec)

    def summary(self) -> dict:
        fired = [e for e in self.events if e.fired]
        return {
            "spec": self.spec,
            "seed": self.seed,
            "events": [e.to_dict() for e in self.events],
            "injected": len(fired),
            "recovered": sum(e.recovered for e in fired),
            "unrecovered": sum(not e.recovered for e in fired),
            "not_fired": sum(not e.fired for e in self.events),
        }


class FaultInjector:
    """The runtime half: the scheduler polls these hooks at fixed points
    of each macro-round; every pending event fires at the first poll at
    or after its scheduled round where a valid target exists."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed ^ 0x9E3779B9)
        self._fired: dict | None = None
        self._recovered: dict | None = None

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        """Pre-register the fired/recovered counters of every kind in
        ``registry`` (constant names, off the hot path) and hand the tables
        to every event so ``FaultEvent.fire`` / ``recover`` count through
        them."""
        self._fired = {
            k: registry.counter("serve.faults.fired." + k) for k in KINDS}
        self._recovered = {
            k: registry.counter("serve.faults.recovered." + k)
            for k in KINDS}
        for e in self.plan.events:
            e.counters = self._fired
            e.rec_counters = self._recovered

    @property
    def fired_counts(self) -> dict[str, int] | None:
        """Per-kind fired counts (None before :meth:`bind_metrics`)."""
        if self._fired is None:
            return None
        return {k: c.value for k, c in self._fired.items()}

    @property
    def recovered_counts(self) -> dict[str, int] | None:
        """Per-kind recovered counts (None before :meth:`bind_metrics`)."""
        if self._recovered is None:
            return None
        return {k: c.value for k, c in self._recovered.items()}

    def _pending(self, rnd: int, *kinds: str) -> FaultEvent | None:
        for e in self.plan.events:
            if e.kind in kinds and not e.fired and rnd >= e.round:
                return e
        return None

    # ---- hooks (each returns the event to fire, or None) ----

    def stall_event(self, rnd: int) -> tuple[FaultEvent, float] | None:
        e = self._pending(rnd, "stall")
        if e is None:
            return None
        return e, (e.param or self.plan.stall_ms) / 1e3

    def overflow_event(self, rnd: int) -> FaultEvent | None:
        return self._pending(rnd, "queue_overflow")

    def reshard_crash_event(self, rnd: int) -> FaultEvent | None:
        """Polled by the reshard coordinator exactly once per reshard,
        in the window between the committed migration manifest and the
        first per-doc move — the worst crash point the recovery
        protocol must absorb."""
        return self._pending(rnd, "reshard_crash")

    def dup_event(self, rnd: int, doc_id: int,
                  cursor: int) -> FaultEvent | None:
        """A redelivered batch for ``doc_id``: only docs that already
        applied ops are meaningful dup targets."""
        if cursor <= 0:
            return None
        e = self._pending(rnd, "dup_batch")
        if e is None or (e.target is not None and e.target != doc_id):
            return None
        return e

    def device_loss_event(self, rnd: int, cls: int) -> FaultEvent | None:
        e = self._pending(rnd, "device_loss")
        if e is None or (e.target is not None and e.target != cls):
            return None
        return e

    def spool_event(self, rnd: int) -> FaultEvent | None:
        return self._pending(rnd, "spool_corrupt", "spool_truncate")

    def compact_crash_event(self, rnd: int) -> FaultEvent | None:
        """Kill the WAL GC pass between its manifest write and the
        unlinks (polled by the journal's crash hook at each barrier;
        pending until a pass actually has victims to delete)."""
        return self._pending(rnd, "crash_compact")

    def delta_corrupt_event(self, rnd: int) -> FaultEvent | None:
        """Flip bytes in the newest delta snapshot member (polled after
        each barrier; pending until a delta link exists)."""
        return self._pending(rnd, "delta_corrupt")

    def tier_pressure_event(self, rnd: int) -> FaultEvent | None:
        """Force warm-tier churn (polled each macro-round by the
        tiered scheduler; pending until the warm tier holds entries)."""
        return self._pending(rnd, "tier_evict_pressure")

    def prefetch_miss_event(self, rnd: int) -> FaultEvent | None:
        """Drop one round's planned prefetch batch (polled at prefetch
        planning; pending until a round actually plans prefetches)."""
        return self._pending(rnd, "prefetch_miss")

    def conn_churn_event(self, rnd: int) -> FaultEvent | None:
        """Drop every live ingest connection (polled by the open-loop
        pump each macro-round; the front's churn generation bump does
        the dropping)."""
        return self._pending(rnd, "conn_churn")

    def tenant_flood_event(self, rnd: int) -> FaultEvent | None:
        """Inflate one tenant's offered load by ``param``x for a fixed
        window (polled by the open-loop pump; admission must absorb
        the pressure)."""
        return self._pending(rnd, "tenant_flood")

    def partition_event(self, rnd: int) -> FaultEvent | None:
        """A replica's broadcast link drops for a span (polled by the
        replicated scheduler's bus tick; ``param`` = span rounds)."""
        return self._pending(rnd, "replica_partition")

    def reorder_event(self, rnd: int) -> FaultEvent | None:
        """One round's remote broadcast batches delivered in permuted
        writer order (polled by the replicated scheduler's bus tick)."""
        return self._pending(rnd, "merge_reorder")

    def poisoned(self, doc_id: int) -> bool:
        """Fire-once: is this doc's REBUILD poisoned?  (Exercises the
        quarantine path — recovery itself failing.)"""
        for e in self.plan.events:
            if e.kind == "poison_rebuild" and not e.fired and (
                e.target is None or e.target == doc_id
            ):
                e.fire(-1, doc=doc_id)
                e.recovered = False  # a poisoned rebuild ends in quarantine
                return True
        return False

    # ---- corruption primitives ----

    def corrupt_file(self, path: str, kind: str) -> dict:
        """Damage an on-disk checkpoint: truncate to ~60% or flip a run
        of bytes in the middle.  The damaged bytes land in a NEW file
        swapped over ``path`` (never an in-place mutation): snapshot
        barriers hard-link live spools on the immutability guarantee
        that every spool write goes through ``os.replace``, and fault
        injection must honor the same contract — the fault hits THIS
        file, not a committed snapshot member sharing its inode.
        Returns detail for the event record."""
        data = bytearray(open(path, "rb").read())
        size = len(data)
        if kind == "spool_truncate" or size < 64:
            keep = max(1, int(size * 0.6))
            data = data[:keep]
            detail = {"mode": "truncate", "bytes": size, "kept": keep}
        else:
            off = int(self.rng.integers(size // 4, max(size // 4 + 1,
                                                       size - 16)))
            for i in range(off, min(off + 8, size)):
                data[i] ^= 0xFF
            detail = {"mode": "bitflip", "bytes": size, "offset": off}
        tmp = path + ".fault"
        with open(tmp, "wb") as f:
            f.write(bytes(data))
        os.replace(tmp, path)
        return detail

    def pick(self, candidates: list[int]) -> int:
        """Seeded target selection among live candidates."""
        return int(candidates[int(self.rng.integers(len(candidates)))])
