"""Live reconfiguration of the fleet's shard map (the JAX package's
``serve/reshard.py``).

A pool built with ``shards=N`` splits every bucket's rows over N logical
shards (``serve/pool.py``).  This module changes that map while the fleet
serves:

- a **shard-map change** (``shrink:FROM:TO``, ``grow:FROM:TO`` or
  ``drain:S``) moves shards from ``live`` to ``draining`` to ``retired``
  (or back to ``live`` on a grow); allocation stops on a draining shard at
  once, but its residents take ops until their migration round;
- **migrations** are batched doc moves through the round's boundary: a
  migrated doc is a row-to-row ``("pull", cls, src_row)`` install onto a
  live shard (it stays hot) or, with no free live row in its class, an
  eviction (admitted again on a live shard when next scheduled).  A
  migrating doc's lane is pulled from its round: it defers, it is never
  shed;
- **every migration decision is durable before it runs**: the commit point
  is ``RESHARD_MANIFEST.json`` (a ``.tmp`` written and fsynced, then
  ``os.replace`` and a directory fsync), each round's moves are journaled
  ``reshard``/``phase=move`` records ahead of the boundary, and the commit
  record is followed by the manifest's read-witnessed unlink.  A crash at
  any point leaves a state :func:`recover_torn_reshard` resolves: a
  manifest rolls the reshard forward (its shards retire, restored docs
  move off), no manifest leaves the journal's ``phase=commit`` records as
  the truth (a staged ``.tmp`` never committed and rolls back);
- the fault kind ``reshard_crash`` kills the coordinator between the
  manifest commit and the first move; the next round's tick resumes from
  the manifest on disk (recovery's roll-forward), so the event always
  closes recovered.

:func:`check_shard_partition` checks that every doc lives on exactly one
shard.  The manifest's and the records' bytes are the JAX package's, so
either package recovers the other's journal.  The coordinator's states are
the lifecycle sanitizer's ``row`` machine, the manifest's commit and retire
run inside the fs sanitizer's ``reshard`` protocol, and :meth:`tick` and
:meth:`finalize` are fences of the sync sanitizer (``lint/``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..lint import lifecycle_sanitizer as lifecycle
from ..lint.fs_sanitizer import fs_protocol
from ..lint.sanitizer import fenced
from ..utils.fsdur import fsync_dir

#: The migration manifest, the reshard's commit point, in the journal
#: directory beside ``GC_MANIFEST.json``.
RESHARD_MANIFEST = "RESHARD_MANIFEST.json"

#: The errors a manifest read absorbs: a damaged manifest reads as absent.
_MANIFEST_ERRORS = (OSError, json.JSONDecodeError, KeyError, TypeError,
                    ValueError)


# ---------------------------------------------------------------------------
# the spec grammar
# ---------------------------------------------------------------------------


@dataclass
class ReshardPlan:
    """One parsed ``--serve-reshard`` spec::

        shrink:FROM:TO[@ROUND][,batch=N][,imbalance=X]
        grow:FROM:TO[@ROUND][,batch=N]
        drain:SHARD[@ROUND][,of=N][,batch=N][,imbalance=X]

    ``@ROUND`` arms a round trigger and ``imbalance=X`` the live shards'
    occupancy imbalance as another (the reshard begins at the first round
    where either holds); with neither it begins at round 2.  ``batch``
    bounds the doc moves a macro-round (default 8): migration length
    against mid-reshard tail latency.  ``drain`` takes its physical shard
    count from the mesh when the pool has one; logical shards need ``of=N``
    (drain shard S of N)."""

    kind: str  # "shrink" | "grow" | "drain"
    from_sh: int  # live shards before the change
    to_sh: int  # live shards after it
    shards: tuple[int, ...]  # the shards changing state
    at_round: int | None = None
    imbalance: float | None = None
    batch: int = 8
    spec: str = ""

    @property
    def n_shards(self) -> int:
        """The shards the pool must be built with."""
        return max(self.from_sh, self.to_sh)

    @property
    def initial_live(self) -> int:
        """Live shards at construction (a grow starts below the pool's)."""
        return self.from_sh


def parse_reshard_spec(spec: str) -> ReshardPlan:
    """Parse a ``--serve-reshard`` spec (:class:`ReshardPlan`'s grammar)."""
    head, *opts = str(spec).split(",")
    head = head.strip()
    at_round: int | None = None
    if "@" in head:
        head, at = head.rsplit("@", 1)
        at_round = int(at)
    parts = head.split(":")
    kind = parts[0].strip()
    try:
        if kind in ("shrink", "grow"):
            if len(parts) != 3:
                raise ValueError("expected KIND:FROM:TO")
            from_sh, to_sh = int(parts[1]), int(parts[2])
        elif kind == "drain":
            if len(parts) != 2:
                raise ValueError("expected drain:SHARD")
            shard = int(parts[1])
            from_sh, to_sh = shard + 1, shard  # lower bounds; set below
        else:
            raise ValueError(f"unknown reshard kind {kind!r}")
    except ValueError as e:
        raise ValueError(
            f"reshard spec {spec!r}: {e} "
            "(grammar: shrink:FROM:TO[@R] | grow:FROM:TO[@R] | "
            "drain:SHARD[@R], options batch=N, imbalance=X)"
        ) from None
    imbalance: float | None = None
    batch = 8
    of = 0
    for tok in opts:
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(
                f"reshard spec option {tok!r}: expected key=value")
        key, val = tok.split("=", 1)
        key = key.strip()
        if key == "batch":
            batch = max(1, int(val))
        elif key == "imbalance":
            imbalance = float(val)
        elif key == "of":
            if kind != "drain":
                raise ValueError(
                    "reshard spec: of=N only applies to drain:SHARD")
            of = int(val)
        else:
            raise ValueError(
                f"reshard spec: unknown option {key!r} "
                "(expected batch, imbalance or of)")
    if kind == "shrink":
        if not 1 <= to_sh < from_sh:
            raise ValueError(
                f"reshard spec {spec!r}: shrink needs FROM > TO >= 1")
        shards = tuple(range(to_sh, from_sh))
    elif kind == "grow":
        if not 1 <= from_sh < to_sh:
            raise ValueError(
                f"reshard spec {spec!r}: grow needs TO > FROM >= 1")
        shards = tuple(range(from_sh, to_sh))
    else:  # drain one shard
        shard = int(parts[1])
        if shard < 0:
            raise ValueError(f"reshard spec {spec!r}: negative shard id")
        shards = (shard,)
        if of:
            if not 0 <= shard < of or of < 2:
                raise ValueError(
                    f"reshard spec {spec!r}: drain:{shard},of={of} "
                    "needs 0 <= SHARD < N and N >= 2")
            from_sh, to_sh = of, of - 1
        else:
            from_sh, to_sh = 0, 0  # resolved against the pool at bind
    return ReshardPlan(kind=kind, from_sh=from_sh, to_sh=to_sh,
                       shards=shards, at_round=at_round, imbalance=imbalance,
                       batch=batch, spec=str(spec))


# ---------------------------------------------------------------------------
# the manifest (the commit point)
# ---------------------------------------------------------------------------


def commit_manifest(journal_dir: str, manifest: dict) -> str:  # graftlint: durable=reshard
    """Commit the migration manifest, the reshard's point of no return:
    written to a ``.tmp`` sibling and fsynced, installed by ``os.replace``,
    the directory fsynced.  After the replace the reshard completes, by
    the coordinator, its in-run resume or recovery's roll-forward."""
    path = os.path.join(journal_dir, RESHARD_MANIFEST)
    tmp = path + ".tmp"
    with fs_protocol("reshard"):
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # the commit point
        fsync_dir(journal_dir)
    return path


def read_manifest(journal_dir: str) -> dict | None:
    """The committed manifest, or None (absent or damaged: either rolls
    back, since nothing was promised)."""
    path = os.path.join(journal_dir, RESHARD_MANIFEST)
    try:
        with open(path, encoding="utf-8") as f:
            m = json.load(f)
        return {
            "id": int(m["id"]),
            "kind": str(m["kind"]),
            "shards": [int(s) for s in m["shards"]],
            "round": int(m["round"]),
            "docs": int(m.get("docs", 0)),
        }
    except _MANIFEST_ERRORS:
        return None


def retire_manifest(journal_dir: str) -> bool:  # graftlint: durable=reshard
    """Retire a completed reshard's manifest (idempotent): the committed
    file is read, then unlinked; a staged ``.tmp`` (a crash before the
    commit) is discarded too.  Returns whether a manifest was removed."""
    path = os.path.join(journal_dir, RESHARD_MANIFEST)
    with fs_protocol("reshard"):
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        if not os.path.exists(path):
            return False
        try:
            with open(path, encoding="utf-8") as f:
                json.load(f)  # the read that witnesses the committed record
        except _MANIFEST_ERRORS:
            pass  # a damaged manifest is still ours to retire
        try:
            os.unlink(path)
        except OSError:
            return False
    return True


# ---------------------------------------------------------------------------
# the partition invariant
# ---------------------------------------------------------------------------


def check_shard_partition(pool) -> list[str]:
    """Every doc lives on exactly one shard (or on none: warm, cold or in
    genesis).  Checked against the bucket row tables and free sets, not the
    records alone, so a half-applied move shows from either side: a doc on
    two rows, a row naming a doc whose record points elsewhere, a record
    naming a row the bucket holds free, a resident on a retired shard, a
    resident with a cold-spool claim, and per-shard occupancy that does
    not sum to the residents.  Returns the violations (empty: it holds)."""
    problems: list[str] = []
    owner: dict[int, tuple[int, int]] = {}  # doc -> (cls, row)
    occupied = 0
    for cls, b in pool.buckets.items():
        free = set(b.free)
        for row, doc_id in enumerate(b.rows):
            if doc_id is None:
                continue
            occupied += 1
            if row in free:
                problems.append(
                    f"c{cls} row {row}: doc {doc_id} occupies a row "
                    "the free set also lists")
            if doc_id in owner:
                o_cls, o_row = owner[doc_id]
                problems.append(
                    f"doc {doc_id}: resident on two shards/rows "
                    f"(c{o_cls} r{o_row} and c{cls} r{row})")
            owner[doc_id] = (cls, row)
            rec = pool.docs.get(doc_id)
            if rec is None:
                problems.append(
                    f"c{cls} row {row}: doc {doc_id} has no pool record")
            elif (rec.cls, rec.row) != (cls, row):
                problems.append(
                    f"doc {doc_id}: bucket says c{cls} r{row}, record "
                    f"says c{rec.cls} r{rec.row}")
            shard = row // b.Rg
            if pool.shard_state[shard] == "retired":
                problems.append(
                    f"doc {doc_id}: resident on RETIRED shard {shard} "
                    f"(c{cls} r{row})")
    for doc_id, rec in pool.docs.items():
        if rec.cls is not None and doc_id not in owner:
            problems.append(
                f"doc {doc_id}: record claims c{rec.cls} r{rec.row} but "
                "no bucket row names it")
        if rec.cls is not None and rec.spool is not None:
            problems.append(
                f"doc {doc_id}: resident AND cold (spool claim "
                f"{os.path.basename(rec.spool)}) — ambiguous tier")
    if sum(pool.shard_occupancy()) != occupied:
        problems.append(
            f"shard occupancy {pool.shard_occupancy()} does not sum to "
            f"the {occupied} occupied rows")
    return problems


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------


class ReshardCoordinator:  # graftlint: state=row field=state states=idle,active,crashed,done edges=idle->active,active->crashed,crashed->active,active->done
    """Drives one shard-map change through a serving fleet.

    The scheduler ticks it once a macro-round, after the round's plan is
    placed and before its WAL record, so the round's migrations land in
    the same boundary moves as its own and the journal sees each decision
    before the bytes move.  States: ``idle`` -> (trigger) -> ``active`` ->
    ``done``, through ``crashed`` when ``reshard_crash`` kills the first
    attempt between the manifest commit and the moves (the only way out of
    ``crashed`` is a resume)."""

    def __init__(self, pool, journal, plan: ReshardPlan, faults=None,
                 telemetry=None):
        if journal is None:
            raise ValueError(
                "reshard requires the write-ahead journal "
                "(--serve-journal): migration decisions must be durable")
        self.pool = pool
        self.journal = journal
        self.plan = plan
        self.faults = faults
        self.telemetry = telemetry
        self.state = "idle"
        self.reshard_id = 0
        # the coordinator machine's legal graph (JAX's): the only way out
        # of `crashed` is a resume, which derives the pending set again
        lifecycle.declare_machine(
            "row", ("idle", "active", "crashed", "done"),
            (("idle", "active"), ("active", "crashed"),
             ("crashed", "active"), ("active", "done")))
        self._shards: tuple[int, ...] = self._resolve_shards()
        if plan.kind == "grow":
            # the target shards have rows but are not live yet: docs place
            # on the FROM set until the grow's begin revives them
            for s in self._shards:
                self.pool.drain_shard(s)
        self._crash_ev = None
        self.begin_round = -1
        self.commit_round = -1
        self.migrated = 0  # row-to-row moves (stayed hot)
        self.evicted = 0  # no free live row: evicted, admitted again live
        self.deferred_lanes = 0  # scheduled lanes pulled for a migration
        self.deferred_ops = 0  # the ops those lanes would have applied
        self.rounds_active = 0
        self.resumes = 0
        #: each round's latency while the move is in flight
        self.round_latencies: list[float] = []
        self._g = {}

    def _resolve_shards(self) -> tuple[int, ...]:
        n = self.pool.n_sh
        p = self.plan
        if p.kind == "drain":
            if p.shards[0] >= n:
                raise ValueError(
                    f"reshard drain:{p.shards[0]}: pool has {n} shards")
            if p.from_sh and p.from_sh != n:
                raise ValueError(
                    f"reshard {p.spec!r}: of={p.from_sh} but the pool "
                    f"has {n} physical shards")
            return p.shards
        if p.n_shards != n:
            raise ValueError(
                f"reshard {p.spec!r}: pool has {n} physical shards, "
                f"spec needs {p.n_shards} (pass --serve-mesh or shards=)")
        return p.shards

    def bind_metrics(self, registry) -> None:
        """Register the ``serve.reshard.*`` series on a drain's registry."""
        g, c = registry.gauge, registry.counter
        self._g = {
            "active": g("serve.reshard.active"),
            "draining": g("serve.reshard.draining_shards"),
            "pending": g("serve.reshard.pending_docs"),
            "migrated": c("serve.reshard.migrated"),
            "evicted": c("serve.reshard.evicted"),
            "deferred": c("serve.reshard.deferred_lanes"),
            "rounds": c("serve.reshard.rounds"),
            "resumes": c("serve.reshard.resumes"),
        }

    def _inc(self, name: str) -> None:
        if self._g:
            self._g[name].inc()

    # ---- helpers ----

    def _draining_docs(self) -> list[tuple[int, int, int]]:
        """(doc_id, cls, row) of every resident of a changing shard that is
        draining, in a deterministic order."""
        out = []
        for s in self._shards:
            if self.pool.shard_state[s] == "draining":
                out.extend(self.pool.docs_on_shard(s))
        out.sort()
        return out

    def _event(self, phase: str, rnd: int, **fields) -> None:
        self.journal.event("reshard", phase=phase, id=self.reshard_id,
                           r=rnd, **fields)
        if self.telemetry is not None:
            self.telemetry.note_event("reshard", phase=phase,
                                      id=self.reshard_id, round=rnd,
                                      **fields)

    def _gauge_refresh(self, pending: int) -> None:
        if not self._g:
            return
        self._g["active"].set(1 if self.active else 0)
        self._g["draining"].set(sum(
            1 for s in self._shards
            if self.pool.shard_state[s] == "draining"))
        self._g["pending"].set(pending)
        if self.telemetry is not None:
            # published out of window: a small fleet's whole migration can
            # begin and commit inside one telemetry window, and the move in
            # flight is what a scrape is for
            self.telemetry.publish_metrics_now()

    @property
    def active(self) -> bool:
        return self.state in ("active", "crashed")

    def migrating_docs(self) -> set[int]:
        """Docs mid-move (residents of a draining shard while the reshard
        is active): they defer, they are never shed."""
        if not self.active:
            return set()
        return {d for d, _cls, _row in self._draining_docs()}

    # ---- the per-round hook ----

    @fenced
    def tick(self, rnd: int, plan, imbalance: float,  # graftlint: fence=reshard
             note_deferred=None) -> None:
        """One round of coordination: trigger, resume, migrate a batch and
        commit once the draining shards are empty.  ``plan`` is the round's
        placed plan: the migrations join its installs and evictions, so
        the boundary moves them with the rest.  ``note_deferred`` gets the
        op count of every lane pulled for a migration."""
        if self.state == "done":
            return
        if self.state == "idle":
            if not self._should_begin(rnd, imbalance):
                return
            self._begin(rnd)
            if self.state != "active":
                return  # reshard_crash: the coordinator died post-commit
        elif self.state == "crashed":
            self._resume(rnd)
        self.rounds_active += 1
        self._inc("rounds")
        pending = self._draining_docs()
        if pending and plan is not None:
            self._migrate_batch(rnd, plan, pending, note_deferred)
            pending = self._draining_docs()
        if not pending:
            self._commit(rnd)
        self._gauge_refresh(len(pending))

    def _should_begin(self, rnd: int, imbalance: float) -> bool:
        p = self.plan
        if p.at_round is not None and rnd >= p.at_round:
            return True
        if p.imbalance is not None and imbalance > p.imbalance:
            return True
        return p.at_round is None and p.imbalance is None and rnd >= 2

    def _begin(self, rnd: int) -> None:  # graftlint: transition=row:idle->active,active->crashed
        """The commit point: the manifest first (the durable decision),
        then the live shard-map flip, then the begin record.  The
        ``reshard_crash`` kill point is right after."""
        self.reshard_id += 1
        self.begin_round = rnd
        docs0 = 0
        if self.plan.kind != "grow":
            for s in self._shards:
                docs0 += len(self.pool.docs_on_shard(s))
        commit_manifest(self.journal.dir, {
            "id": self.reshard_id,
            "kind": self.plan.kind,
            "shards": list(self._shards),
            "round": rnd,
            "docs": docs0,
        })
        for s in self._shards:
            if self.plan.kind == "grow":
                self.pool.revive_shard(s)
            else:
                self.pool.drain_shard(s)
        self._event("begin", rnd, change=self.plan.kind,
                    shards=list(self._shards), docs=docs0)
        lifecycle.transition("row", "idle", "active", key=id(self))
        self.state = "active"
        if self.faults is not None:
            ev = self.faults.reshard_crash_event(rnd)
            if ev is not None:
                # the coordinator dies here: its plan is gone, the manifest
                # is not, and the next tick's resume (or a recovery's
                # roll-forward) completes the reshard from it alone
                ev.fire(rnd, stage="post_manifest_pre_moves",
                        shards=list(self._shards), docs=docs0)
                self._crash_ev = ev
                lifecycle.transition("row", "active", "crashed",
                                     key=id(self))
                self.state = "crashed"
        self._gauge_refresh(docs0)

    def _resume(self, rnd: int) -> None:  # graftlint: transition=row:crashed->active
        """The in-run recovery of a crashed coordinator: what it needs to
        finish is in the committed manifest and the pool's shard map, so
        read the manifest, derive the pending set again and carry on."""
        m = read_manifest(self.journal.dir)
        if m is not None:
            self._shards = tuple(int(s) for s in m["shards"])
        self.resumes += 1
        self._inc("resumes")
        self._event("resume", rnd, shards=list(self._shards))
        if self._crash_ev is not None:
            self._crash_ev.recover(via="coordinator_resume", round=rnd)
            self._crash_ev = None
        lifecycle.transition("row", "crashed", "active", key=id(self))
        self.state = "active"

    def _migrate_batch(self, rnd: int, plan, pending,
                       note_deferred) -> None:
        """Move up to ``batch`` docs off the draining shards through the
        round's boundary moves.  A doc scheduled this round has its lane
        pulled first (it defers; its ops schedule again next round from a
        live shard)."""
        pool = self.pool
        moved: list[list[int]] = []
        # a doc admitted this very round is not movable yet: both
        # migration paths read the bucket snapshot from before the round's
        # installs land, which holds a previous tenant's row, so the next
        # tick moves it
        installing = {d for items in plan.installs.values()
                      for d, _row, _src in items}
        batch = [m for m in pending
                 if m[0] not in installing][:self.plan.batch]
        for doc_id, cls, src_row in batch:
            b = pool.buckets[cls]
            self._pull_lane(plan, cls, doc_id, note_deferred)
            rec = pool.docs[doc_id]
            if b.n_free_live > 0:
                # row to row onto a live shard: the doc stays hot
                dst = b.alloc_row()
                plan.installs.setdefault(cls, []).append(
                    (doc_id, dst, ("pull", cls, src_row)))
                plan.pull_classes.add(cls)
                b.rows[dst] = doc_id
                b.rows[src_row] = None
                b.release_row(src_row)
                rec.row = dst
                self.migrated += 1
                self._inc("migrated")
                if self.telemetry is not None:
                    self.telemetry.shards.note_relocation(dst // b.Rg)
                moved.append([doc_id, cls, src_row, dst])
            else:
                # no free live row in the class: evicted through the
                # boundary; its next admission lands on a live shard
                plan.evictions.append((doc_id, cls, src_row))
                plan.pull_classes.add(cls)
                if pool.warm.budget <= 0:
                    pool._set_spool(rec, pool.spool_path(doc_id))
                b.rows[src_row] = None
                b.release_row(src_row)
                rec.cls = rec.row = None
                pool.evictions += 1
                self.evicted += 1
                self._inc("evicted")
                moved.append([doc_id, cls, src_row, -1])
        if moved:
            # journaled before the boundary moves the bytes
            self._event("move", rnd, docs=moved)

    def _pull_lane(self, plan, cls: int, doc_id: int,
                   note_deferred) -> int:
        """Take the doc's lane out of the round, if it was scheduled.
        Returns the deferred op count."""
        lanes = plan.lanes.get(cls)
        if not lanes:
            return 0
        for i, lane in enumerate(lanes):
            if lane.stream.doc_id != doc_id:
                continue
            ops = lane.end - lane.stream.cursor
            del lanes[i]
            if not lanes:
                del plan.lanes[cls]
            self.deferred_lanes += 1
            self.deferred_ops += ops
            self._inc("deferred")
            if note_deferred is not None:
                note_deferred(ops)
            return ops
        return 0

    def _commit(self, rnd: int) -> None:  # graftlint: transition=row:active->done
        """The draining shards are empty: retire them, journal the commit
        record, retire the manifest."""
        retired: list[int] = []
        if self.plan.kind != "grow":
            for s in self._shards:
                if self.pool.shard_state[s] == "draining":
                    self.pool.retire_shard(s)
                    retired.append(s)
        self.commit_round = rnd
        self._event(
            "commit", rnd, change=self.plan.kind, retired=retired,
            revived=(list(self._shards) if self.plan.kind == "grow"
                     else []),
            migrated=self.migrated, evicted=self.evicted)
        retire_manifest(self.journal.dir)
        lifecycle.transition("row", "active", "done", key=id(self))
        self.state = "done"
        self._gauge_refresh(0)

    @fenced
    def finalize(self, rnd: int) -> None:  # graftlint: fence=reshard
        """The drain's end: a reshard still in flight completes now (the
        draining shards' remaining residents are evicted on the host:
        their streams are done and nothing admits them again) and commits.
        A crashed coordinator resumes first, closing its fault event, so a
        completed drain never leaves a manifest behind."""
        if self.state in ("done", "idle"):
            return
        if self.state == "crashed":
            self._resume(rnd)
        moved = []
        for doc_id, cls, row in self._draining_docs():
            self.pool.evict(doc_id)
            self.evicted += 1
            self._inc("evicted")
            moved.append([doc_id, cls, row, -1])
        if moved:
            self._event("move", rnd, docs=moved, finalize=True)
        self._commit(rnd)

    # ---- reporting ----

    def note_round_latency(self, seconds: float) -> None:
        if self.active:
            self.round_latencies.append(seconds)

    def status_fields(self) -> dict:
        return {
            "state": self.state,
            "kind": self.plan.kind,
            "shards": list(self._shards),
            "pending_docs": (len(self._draining_docs())
                             if self.active else 0),
            "migrated": self.migrated,
            "evicted": self.evicted,
            "deferred_lanes": self.deferred_lanes,
        }

    def summary(self) -> dict:
        """The report's ``reshard`` block."""
        lat = sorted(self.round_latencies)
        qs = {}
        if lat:
            arr = np.asarray(lat)
            qs = {"p50": float(np.quantile(arr, 0.5)),
                  "p99": float(np.quantile(arr, 0.99)),
                  "max": float(arr[-1])}
        return {
            "version": 1,
            "spec": self.plan.spec,
            "kind": self.plan.kind,
            "state": self.state,
            "shards": list(self._shards),
            "begin_round": self.begin_round,
            "commit_round": self.commit_round,
            "rounds_active": self.rounds_active,
            "migrated": self.migrated,
            "evicted": self.evicted,
            "deferred_lanes": self.deferred_lanes,
            "deferred_ops": self.deferred_ops,
            "resumes": self.resumes,
            "mid_latency": qs,
            "live_shards": self.pool.live_shard_count,
        }


# ---------------------------------------------------------------------------
# recovery: complete or roll back
# ---------------------------------------------------------------------------


def scan_reshard_records(records) -> tuple[set[int], int]:
    """Replay the journal's reshard commit records in order: the retired
    shards a recovered pool must keep retired, and the number of commits.
    A grow's commit revives, so the set is a running state."""
    retired: set[int] = set()
    commits = 0
    for rec in records:
        if rec.get("t") != "reshard" or rec.get("phase") != "commit":
            continue
        commits += 1
        for s in rec.get("retired", []):
            retired.add(int(s))
        for s in rec.get("revived", []):
            retired.discard(int(s))
    return retired, commits


def recover_torn_reshard(pool, journal_dir: str, records) -> dict:
    """Resolve the reshard state a crash left (``recover_fleet``, after the
    snapshot restore and before serving resumes):

    - the journal's ``commit`` records are settled history: their shards
      are retired again (a snapshot older than the reshard may have put
      docs back on them, and those are evicted first);
    - a committed manifest without a commit record is a torn reshard,
      rolled forward the same way (the manifest was the promise);
    - with neither, the reshard never committed and rolls back by doing
      nothing (a staged ``.tmp`` is discarded).

    Returns ``{"retired": [...], "moved": n, "completed": bool}``."""
    retired, _commits = scan_reshard_records(records)
    manifest = read_manifest(journal_dir)
    completed = False
    if manifest is not None and manifest["kind"] != "grow":
        retired |= set(manifest["shards"])
    moved = 0
    for s in sorted(retired):
        if s >= pool.n_sh:
            continue
        if pool.shard_state[s] != "retired":
            pool.drain_shard(s)
        for doc_id, _cls, _row in pool.docs_on_shard(s):
            pool.evict(doc_id)
            moved += 1
        if pool.shard_state[s] != "retired":
            pool.retire_shard(s)
    if manifest is not None or os.path.exists(
            os.path.join(journal_dir, RESHARD_MANIFEST + ".tmp")):
        completed = retire_manifest(journal_dir) or manifest is not None
    return {"retired": sorted(retired), "moved": moved,
            "completed": completed}
