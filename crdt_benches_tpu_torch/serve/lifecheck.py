"""Churn-heavy lifecycle leak check: the drain-end zero-leak gate (the
JAX package's ``serve/lifecheck.py``).

Drive a small real fleet through every lifecycle protocol the serve stack
declares — keyed doc live/cold residency churn on a hot budget a fraction
of the fleet, a live reshard (the ``row`` machine), a real ingest front
with connection churn and a resumed session (the ``session`` machine over
the wire), the warm tier's prefetch thread (``thread`` ownership), and a
second journal-less streaming drain with drained-doc record eviction (the
``stream`` machine and O(active-set) pool records) — all under
``lint/lifecycle_sanitizer.py`` armed, then require **zero unreleased
acquisitions** at drain end (:func:`assert_all_released` after an explicit
teardown: evict the residents, GC the drained records, stop the
prefetcher, stop the front) and zero unattributed transitions.  The
per-machine edge counts must be nonzero, so the harness never covers
nothing; they are the serve report's ``lifecycle`` block.

On the CPU (``--device cpu``) the kernels' plain versions run; on the card
(the default) K1's per-row form and K4 launch::

    python -m crdt_benches_tpu_torch.serve.lifecheck [--small] [--device cpu]
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import sys
import tempfile

from ..device import resolve_device
from ..lint import lifecycle_sanitizer as lifecycle
from .ingest.front import IngestFront, encode_frame
from .journal import OpJournal
from .pool import DocPool
from .reshard import ReshardCoordinator, parse_reshard_spec
from .scheduler import FleetScheduler, LazyStreams, prepare_streams
from .workload import FleetSpec, build_fleet

#: Tiny but protocol-complete AND churn-heavy: two capacity classes on
#: a 4-row hot budget against an 8-doc fleet (every round evicts and
#: restores — the keyed doc machine walks live->cold->live
#: constantly), a 3-doc warm tier with the prefetch worker armed, a
#: ``drain:1`` reshard beginning on the first round, sub-KiB WAL
#: segments, and a live ingest front churned mid-session.  ``small``
#: shrinks the streams for the CPU tests, keeping every protocol.
_BANDS = {
    "synth-small": ("synth", (10, 60)),
    "synth-medium": ("synth", (150, 360)),
}
_MIX = {"synth-small": 0.7, "synth-medium": 0.3}
_SMALL_BANDS = {"synth-small": ("synth", (8, 36))}
_SMALL_MIX = {"synth-small": 1.0}
_CLASSES = (256, 1024)
_SLOTS = (2, 2)  # % _SHARDS == 0: one row of each class per shard
_SHARDS = 2
_RESHARD = "drain:1@0,of=2,batch=2"
_WARM = 3
_DOCS = 8
_SEED = 23
_BATCH = 16
_CHARS = 64
_MACRO_K = 2


def _sessions(small: bool = False):
    if small:
        return build_fleet(5, mix=_SMALL_MIX, seed=_SEED,
                           arrival_span=1, bands=_SMALL_BANDS)
    return build_fleet(_DOCS, mix=_MIX, seed=_SEED, arrival_span=2,
                       bands=_BANDS)


# ---------------------------------------------------------------------------
# a minimal wire client (the session machine needs REAL connections)
# ---------------------------------------------------------------------------


def _speak(port: int, frames: list[dict]) -> list[dict]:
    """One connection: send each frame, collect each reply.  Stops
    early when the server ends the conversation (churn/err/closed
    peer) — the remaining frames belong to a connection that no longer
    exists, exactly the client contract."""
    replies: list[dict] = []
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        f = s.makefile("rwb")
        for frame in frames:
            f.write(encode_frame(frame))
            f.flush()
            line = f.readline()
            if not line:
                break
            reply = json.loads(line)
            replies.append(reply)
            if reply.get("t") in ("churn", "err"):
                break
    return replies


def _exercise_front(front: IngestFront, doc_id: int) -> None:
    """Three real sessions against a started front: a clean
    open/ops/close, a session dropped by connection churn mid-stream,
    and its resume — covering every edge of the session machine
    (new->open twice, open->dropped, open->closed)."""
    port = front.port
    assert port is not None
    r = _speak(port, [
        {"t": "hello", "session": "lc-a", "doc": doc_id,
         "tenant": "default"},
        {"t": "ops", "seq": 0, "start": 0, "count": 4, "round": 0},
        {"t": "bye"},
    ])
    assert [x.get("t") for x in r] == ["ack", "ack", "ack"], r
    front.drain()
    # churned session: the fault fires between the hello and the next
    # frame; the handler replies `churn` and surfaces the drop
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        f = s.makefile("rwb")
        f.write(encode_frame({"t": "hello", "session": "lc-b",
                              "doc": doc_id, "tenant": "default"}))
        f.flush()
        assert json.loads(f.readline()).get("t") == "ack"
        front.drain()
        front.churn()
        f.write(encode_frame(
            {"t": "ops", "seq": 0, "start": 0, "count": 2, "round": 0}))
        f.flush()
        assert json.loads(f.readline()).get("t") == "churn"
    front.drain()
    r = _speak(port, [
        {"t": "hello", "session": "lc-b", "doc": doc_id,
         "tenant": "default", "resume": True},
        {"t": "bye"},
    ])
    assert [x.get("t") for x in r] == ["ack", "ack"], r
    front.drain()
    assert front.sessions_opened == 3, front.status_fields()
    assert front.sessions_resumed == 1, front.status_fields()
    assert front.sessions_closed == 2, front.status_fields()
    assert front.churn_drops == 1, front.status_fields()


# ---------------------------------------------------------------------------
# the two drains
# ---------------------------------------------------------------------------


def _teardown_pool(pool: DocPool) -> int:
    """Release every residual acquisition a completed drain leaves in
    the pool: spool out still-resident docs (their rows are live
    `rows` acquisitions), reclaim every record through the two-phase
    GC, and stop the prefetch thread.  Returns the records reclaimed."""
    for doc_id, rec in sorted(pool.docs.items()):
        if rec.cls is not None:
            pool.evict(doc_id)
    reclaimed = pool.gc_drained_docs(sorted(pool.docs))
    pool.close()
    return reclaimed


def _journaled_churn_drain(base: str, small: bool, device) -> dict:
    """Drain 1: journaled residency churn + reshard + warm/prefetch +
    a live churned ingest front.  Returns the scheduler's stats
    needed by the report."""
    sp = os.path.join(base, "spool")
    jd = os.path.join(base, "journal")
    sessions = _sessions(small)
    pool = DocPool(classes=_CLASSES, slots=_SLOTS, spool_dir=sp,
                   shards=_SHARDS, warm_docs=_WARM, device=device)
    front = IngestFront({s.doc_id for s in sessions})
    journal = OpJournal(jd, segment_bytes=128 if small else 192)
    try:
        streams = prepare_streams(sessions, pool, batch=_BATCH,
                                  batch_chars=_CHARS)
        reshard = ReshardCoordinator(
            pool, journal, parse_reshard_spec(_RESHARD)
        )
        sched = FleetScheduler(
            pool, streams, batch=_BATCH, macro_k=_MACRO_K,
            batch_chars=_CHARS, journal=journal, reshard=reshard,
            snapshot_every=2, snapshot_full_every=2,
        )
        front.start()
        _exercise_front(front, sessions[0].doc_id)
        sched.run()
        assert reshard.state == "done", reshard.state
        churn = pool.evictions + pool.restores + pool.warm_evictions
        assert churn > 0, "no residency churn — the doc machine is idle"
        return {"evictions": pool.evictions, "restores": pool.restores,
                "rounds": sched.round}
    finally:
        journal.close()
        _teardown_pool(pool)
        front.stop()


def _record_evict_drain(base: str, small: bool, device) -> dict:
    """Drain 2: journal-less streaming construction with drained-doc
    record eviction — the O(active-set) footprint path.  Pool records at
    drain end are bounded by the active set (hot rows + warm budget + one
    unflushed GC batch), NOT the fleet."""
    sp = os.path.join(base, "spool")
    n = 12 if small else 3 * _DOCS
    spec = FleetSpec.build(
        n, mix=_SMALL_MIX if small else _MIX, seed=_SEED,
        arrival_span=4, bands=_SMALL_BANDS if small else _BANDS,
    )
    pool = DocPool(classes=_CLASSES, slots=_SLOTS, spool_dir=sp,
                   warm_docs=_WARM, device=device)
    try:
        streams = LazyStreams(spec, pool, batch=_BATCH,
                              batch_chars=_CHARS)
        sched = FleetScheduler(
            pool, streams, batch=_BATCH, macro_k=_MACRO_K,
            batch_chars=_CHARS, drained_gc=True,
        )
        sched.run()
        bound = sum(_SLOTS) + _WARM + 32  # active set + one GC batch
        records = len(pool.docs)
        assert records <= bound, (
            f"pool records {records} exceed the active-set bound "
            f"{bound} on a {n}-doc fleet — record eviction regressed"
        )
        assert sched.spool_gc_docs > 0, "record eviction never fired"
        return {"fleet": n, "records_at_end": records,
                "gc_docs": sched.spool_gc_docs,
                "released_streams": streams.released}
    finally:
        _teardown_pool(pool)


#: machines/resources the two drains must exercise — a zero count for
#: any of these means the harness silently stopped covering it
_REQUIRED_MACHINES = ("doc", "row", "session", "stream")
_REQUIRED_RESOURCES = ("rows", "thread", "socket")


def run_lifecheck(workdir: str | None = None, log=lambda s: None,
                  small: bool = False, device="cuda") -> dict:
    """The full check.  Returns a report dict::

        {"machines": {m: edges}, "resources": {...}, "leaked": 0,
         "unattributed": [], "churn": {...}, "record_evict": {...}}

    Both drains run ARMED in one counter window: every typed lifecycle
    error (illegal edge, wrong-state departure, double release,
    use-after-release, negative gauge) raises at its callsite, and the
    teardown gate requires zero live acquisitions + zero unattributed
    transitions at the end of each drain.  ``device``: the pools' (the
    card by default; ``"cpu"`` runs the plain versions).  The lifecycle
    sanitizer is put back as it was found.
    """
    device = resolve_device(device)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="crdt_lifecheck_")
    was_armed = lifecycle.armed()
    lifecycle.reset_counters()
    lifecycle.arm()
    try:
        base = os.path.join(workdir, "churn")
        os.makedirs(base)
        churn = _journaled_churn_drain(base, small, device)
        lifecycle.assert_all_released()
        log(f"lifecheck: churn drain clean — {churn['evictions']} "
            f"evictions, {churn['restores']} restores, zero leaks")
        base = os.path.join(workdir, "evict")
        os.makedirs(base)
        evict = _record_evict_drain(base, small, device)
        lifecycle.assert_all_released()
        log(f"lifecheck: record-evict drain clean — "
            f"{evict['gc_docs']} records reclaimed, "
            f"{evict['records_at_end']} left on a {evict['fleet']}-doc "
            "fleet, zero leaks")
        c = lifecycle.counters()
        for name in _REQUIRED_MACHINES:
            if not c["machines"].get(name):
                raise AssertionError(
                    f"machine `{name}` recorded zero transitions — "
                    "the harness no longer covers it"
                )
        for res in _REQUIRED_RESOURCES:
            t = c["resources"].get(res) or {}
            if not t.get("acquire") or t.get("acquire") != t.get("release"):
                raise AssertionError(
                    f"resource `{res}` acquire/release imbalance in a "
                    f"leak-free run: {t}"
                )
        if c["unattributed"]:
            raise AssertionError(
                f"unattributed transitions: {c['unattributed']}"
            )
        return {
            "machines": c["machines"],
            "resources": c["resources"],
            "leaked": lifecycle.live_count(),
            "unattributed": c["unattributed"],
            "churn": churn,
            "record_evict": evict,
        }
    finally:
        if not was_armed:
            lifecycle.disarm()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m crdt_benches_tpu_torch.serve.lifecheck")
    ap.add_argument("--small", action="store_true",
                    help="the small fleets (every protocol, shorter streams)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    try:
        args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    except SystemExit as e:
        return int(e.code or 0)
    report = run_lifecheck(log=lambda s: print(s, flush=True),
                           small=args.small, device=args.device)
    edges = sum(n for t in report["machines"].values()
                for n in t.values())
    acqs = sum(t.get("acquire", 0)
               for t in report["resources"].values())
    ok = report["leaked"] == 0 and not report["unattributed"]
    print(
        f"lifecheck: {'OK' if ok else 'FAILED'} — {edges} transitions "
        f"across {len(report['machines'])} machines, {acqs} "
        f"acquisitions all released, zero unattributed"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
