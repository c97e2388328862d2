"""Exhaustive crash-point enumeration over the durability stack (the JAX
package's ``serve/fscrash.py``).

Drive a small real fleet through every declared durable protocol — WAL
appends and segment seals, delta and full snapshot barriers with
hard-linked spool members, crash-safe segment GC, spool eviction and
restore churn, a live reshard (manifest commit, journaled moves,
read-witnessed retire) and a flight-recorder dump — under
``lint/fs_sanitizer.py``'s interposition, record the whole sequence of
mutating operations, then run the workload again once for each operation
with an :class:`InjectedCrash` at exactly that boundary, and require
byte-verified recovery at every one: ``recover_fleet`` into a fresh pool,
resume through the normal macro-round path, every document decoded to the
oracle's bytes.  The workload is deterministic (seeded synth streams, no
clock in the file path), so crash pass ``i`` sees the sequence the
recording pass did.  The fleet is sharded (``shards=2``) with a
``drain:1`` reshard armed, so every boundary also proves the shard
partition (:func:`serve.reshard.check_shard_partition`): after recovery
each doc lives on exactly one non-retired shard.  The per-protocol point
counts must be nonzero, so the harness never covers nothing.

On the CPU (``--device cpu``) the kernels' plain versions run; on the card
(the default) K1's per-row form and K4 launch::

    python -m crdt_benches_tpu_torch.serve.fscrash [--small] [--device cpu]
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

from ..device import resolve_device
from ..lint import fs_sanitizer
from ..obs.flight import FlightRecorder
from ..oracle.text_oracle import replay_trace
from .journal import OpJournal, recover_fleet
from .pool import DocPool
from .reshard import (
    ReshardCoordinator,
    check_shard_partition,
    parse_reshard_spec,
)
from .scheduler import FleetScheduler, prepare_streams
from .workload import build_fleet

#: Tiny but protocol-complete: two capacity classes, a 3-row device
#: budget against the fleet (forced evict/rehydrate churn = spool
#: protocol), barriers every 2 rounds with a full re-root every 2nd
#: barrier (delta chains + member adoption), sub-KiB WAL segments
#: (seals + GC victims), and a flight dump at drain end.  The default
#: config has ~80 boundaries; ``small=True`` shrinks the streams for the
#: CPU tests while keeping every protocol covered.
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
_RESHARD = "drain:1@0,of=2,batch=2"  # begins on the first round
_DOCS = 5
_SEED = 11
_BATCH = 16
_CHARS = 64
_MACRO_K = 2


def _sessions(small: bool = False):
    if small:
        return build_fleet(4, mix=_SMALL_MIX, seed=_SEED,
                           arrival_span=1, bands=_SMALL_BANDS)
    return build_fleet(_DOCS, mix=_MIX, seed=_SEED, arrival_span=2,
                       bands=_BANDS)


def _drain(base: str, small: bool, device) -> None:
    """One full protocol workload under ``base``: journaled drain to
    completion + a flight dump.  Raises :class:`InjectedCrash` midway
    when a crash point is armed."""
    jd = os.path.join(base, "journal")
    sp = os.path.join(base, "spool")
    fl = os.path.join(base, "flight")
    fs_sanitizer.clear_watch_roots()  # each pass owns fresh dirs
    fs_sanitizer.watch_root(jd)
    fs_sanitizer.watch_root(sp)
    fs_sanitizer.watch_root(fl)
    sessions = _sessions(small)
    pool = DocPool(classes=_CLASSES, slots=_SLOTS, spool_dir=sp,
                   shards=_SHARDS, device=device)
    streams = prepare_streams(sessions, pool, batch=_BATCH,
                              batch_chars=_CHARS)
    journal = OpJournal(jd, segment_bytes=128 if small else 192)
    reshard = ReshardCoordinator(
        pool, journal, parse_reshard_spec(_RESHARD)
    )
    sched = FleetScheduler(
        pool, streams, batch=_BATCH, macro_k=_MACRO_K,
        batch_chars=_CHARS, journal=journal, reshard=reshard,
        snapshot_every=2, snapshot_full_every=2,
    )
    try:
        sched.run()
        flight = FlightRecorder(os.path.join(fl, "dump.json"), ring=8)
        flight.note_round({"round": sched.round, "seconds": 0.0})
        flight.trigger("fscrash-probe")
    finally:
        journal.close()
        pool.close()


def _recover_and_verify(base: str, small: bool, device) -> None:
    """Recovery after a (possibly crashed) drain: fresh pool + streams,
    ``recover_fleet``, resume through the normal macro-round path, and
    byte-verify every document against the oracle replay."""
    jd = os.path.join(base, "journal")
    sessions = _sessions(small)
    pool = DocPool(classes=_CLASSES, slots=_SLOTS,
                   spool_dir=os.path.join(base, "spool_recover"),
                   shards=_SHARDS, device=device)
    try:
        _resume_and_verify(pool, sessions, jd)
    finally:
        pool.close()


def _resume_and_verify(pool, sessions, jd: str) -> None:
    streams = prepare_streams(sessions, pool, batch=_BATCH,
                              batch_chars=_CHARS)
    rep = recover_fleet(pool, streams, jd)
    # the shard-partition invariant holds at EVERY crash boundary: the
    # recovered map has each doc on exactly one shard, none on a
    # retired one — whether the crash tore the reshard (rolled
    # forward), preceded it (rolled back) or followed its commit
    problems = check_shard_partition(pool)
    if problems:
        raise AssertionError(
            "post-recovery shard partition violated (reshard "
            f"{'completed' if rep.reshard_completed else 'torn/absent'},"
            f" retired {rep.reshard_retired}): " + "; ".join(problems)
        )
    FleetScheduler(
        pool, streams, batch=_BATCH, macro_k=_MACRO_K,
        batch_chars=_CHARS, start_round=rep.resume_round,
    ).run()
    problems = check_shard_partition(pool)
    if problems:
        raise AssertionError(
            "post-resume shard partition violated: "
            + "; ".join(problems)
        )
    for s in sessions:
        got = pool.decode(s.doc_id)
        want = replay_trace(s.trace)
        if got != want:
            raise AssertionError(
                f"doc {s.doc_id}: post-recovery bytes diverge from the "
                f"oracle (snapshot round {rep.snapshot_round}, "
                f"{rep.chain_fallbacks} fallbacks)"
            )


def enumerate_crash_points(workdir: str | None = None,
                           log=lambda s: None,
                           small: bool = False, device="cuda") -> dict:
    """The full enumeration.  Returns a report dict::

        {"mutations": M, "per_protocol": {tag: n}, "verified": M}

    - recording pass: run the workload armed, capture the mutating-op
      count ``M`` and its per-protocol attribution (every declared
      protocol must have contributed at least one point);
    - for each ``i`` in ``range(M)``: fresh directories, crash at
      boundary ``i`` (the op raises instead of executing and the fs
      freezes — a dead process writes nothing), then recover + resume
      + byte-verify against the oracle.

    ``device``: the pools' (the card by default; ``"cpu"`` runs the plain
    versions).  The fs sanitizer is put back as it was found.
    """
    device = resolve_device(device)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="crdt_fscrash_")
    try:
        record_dir = os.path.join(workdir, "record")
        os.makedirs(record_dir)
        was_armed = fs_sanitizer.armed()
        fs_sanitizer.reset_counters()
        fs_sanitizer.arm()
        try:
            _drain(record_dir, small, device)
        finally:
            if not was_armed:
                fs_sanitizer.disarm()
        counts = fs_sanitizer.counters()
        m = fs_sanitizer.mutation_count()
        per_protocol = {
            tag: sum(n for op, n in ops.items()
                     if op in fs_sanitizer.MUTATING_OPS)
            for tag, ops in counts["ops"].items()
        }
        # the recording pass must also recover clean (crash "after the
        # last op" — the trivial boundary)
        _recover_and_verify(record_dir, small, device)
        for tag in fs_sanitizer.KNOWN_PROTOCOLS:
            if per_protocol.get(tag, 0) <= 0:
                raise AssertionError(
                    f"protocol `{tag}` contributed no mutating op — "
                    "the enumeration would silently not cover it: "
                    f"{per_protocol}"
                )
        if counts["unattributed"]:
            raise AssertionError(
                "unattributed mutating ops in the recording pass: "
                f"{counts['unattributed']}"
            )
        log(f"fscrash: {m} crash points "
            + ", ".join(f"{t}={n}" for t, n in sorted(per_protocol.items())))
        verified = 0
        for i in range(m):
            base = os.path.join(workdir, f"crash_{i:04d}")
            os.makedirs(base)
            crashed = False
            try:
                with fs_sanitizer.crash_at(i):
                    _drain(base, small, device)
            except fs_sanitizer.InjectedCrash:
                crashed = True
            if not crashed:
                raise AssertionError(
                    f"crash point {i} never fired (expected {m} "
                    "mutating ops — nondeterministic op sequence?)"
                )
            _recover_and_verify(base, small, device)
            verified += 1
            shutil.rmtree(base, ignore_errors=True)  # bound disk use
        log(f"fscrash: {verified}/{m} crash points recovered "
            "byte-verified")
        return {
            "mutations": m,
            "per_protocol": per_protocol,
            "verified": verified,
        }
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m crdt_benches_tpu_torch.serve.fscrash")
    ap.add_argument("--small", action="store_true",
                    help="the small fleet (every protocol, fewer points)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    try:
        args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    except SystemExit as e:
        return int(e.code or 0)
    report = enumerate_crash_points(
        log=lambda s: print(s, flush=True), small=args.small,
        device=args.device,
    )
    ok = report["verified"] == report["mutations"] > 0
    print(
        f"fscrash: {'OK' if ok else 'FAILED'} — "
        f"{report['verified']}/{report['mutations']} boundaries "
        f"byte-verified, per-protocol {report['per_protocol']}"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
