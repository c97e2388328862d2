"""The port's journaled drain (``FleetScheduler(journal=...)``: WAL records,
full and delta snapshot barriers, GC) and its recovery fallbacks against
the JAX package's.

Tolerance: exact.  A journaled drain of the same fleet writes a
byte-identical WAL, the same snapshot directories with equal manifests
(``delta_rows`` included) and equal members array by array, and takes the
same dirty rows at every barrier.  On one damaged directory, copied twice,
both packages' ``recover_fleet`` fall back the same way (``chain_fallbacks``,
``snapshot_round`` and every other report field) and restore the same
state; the port's resumed drain then gives the oracle's documents.  Both
sides run with ``prefetch=False``."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.reshard import RESHARD_MANIFEST
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import build_fleet
from crdt_benches_tpu_torch.utils.checkpoint import load_state

TINY_BANDS = {
    "synth-small": ("synth", (10, 60)),
    "synth-medium": ("synth", (150, 360)),
}
TINY_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
TINY = dict(n_docs=10, mix=TINY_MIX, seed=7, arrival_span=3,
            bands=TINY_BANDS)
POOL = dict(classes=(256, 1024), slots=(6, 3))
DRAIN = dict(batch=16, batch_chars=64)
#: the serve smoke fleet of tests/test_torch_serve_tiers.py
SMOKE = dict(n_docs=24, mix="mixed", seed=0, arrival_span=2)
SMOKE_POOL = dict(slots=(16, 6, 2, 2, 2))


def _pools(tmp_path, sub, fleet=TINY, pool_kw=POOL, warm_docs=0):
    """The port's and JAX's pools and streams for one fleet."""
    pool = DocPool(**pool_kw, device="cpu", warm_docs=warm_docs,
                   prefetch=False, spool_dir=str(tmp_path / f"p{sub}"))
    jpool = JaxPool(**pool_kw, warm_docs=warm_docs, prefetch=False,
                    spool_dir=str(tmp_path / f"j{sub}"))
    return (pool, prepare_streams(build_fleet(**fleet), pool, **DRAIN),
            jpool, jax_prepare(jax_build_fleet(**fleet), jpool, **DRAIN))


def _record_dirty(pool):
    """Wrap ``pool.take_dirty`` so every barrier's dirty set is kept."""
    seen = []
    take = pool.take_dirty

    def wrapped():
        seen.append(take())
        return seen[-1]

    pool.take_dirty = wrapped
    return seen


def _files(jd):
    return {f: open(os.path.join(jd, f), "rb").read()
            for f in sorted(os.listdir(jd))
            if os.path.isfile(os.path.join(jd, f))}


def _same_snapshots(a, b):
    """Snapshot directories of ``a`` (JAX's) and ``b`` (the port's): the
    same names, equal manifests, equal members array by array."""
    names = jj.list_snapshots(a)
    assert pj.list_snapshots(b) == names and names
    for n in names:
        ma = json.load(open(os.path.join(a, n, "MANIFEST.json")))
        mb = json.load(open(os.path.join(b, n, "MANIFEST.json")))
        assert mb == ma, n
        members = sorted(os.listdir(os.path.join(a, n)))
        assert sorted(os.listdir(os.path.join(b, n))) == members
        for f in members:
            if not f.endswith(".npz"):
                continue
            x = load_state(os.path.join(a, n, f))
            y = load_state(os.path.join(b, n, f))
            for k in x._fields:
                xa, ya = getattr(x, k), getattr(y, k)
                assert xa.dtype == ya.dtype and np.array_equal(xa, ya), (n, f)
    return names


def _drain_both(tmp_path, every, full, fleet=TINY, pool_kw=POOL,
                warm_docs=0, segment_bytes=300, max_rounds=None, keep=2):
    pool, streams, jpool, jstreams = _pools(tmp_path, "d", fleet, pool_kw,
                                            warm_docs)
    seen, jseen = _record_dirty(pool), _record_dirty(jpool)
    a, b = str(tmp_path / "jax_j"), str(tmp_path / "port_j")
    kw = dict(macro_k=4, **DRAIN, snapshot_every=every,
              snapshot_full_every=full, snapshot_keep=keep)
    jstats = JaxScheduler(jpool, jstreams, **kw, journal=jj.OpJournal(
        a, segment_bytes=segment_bytes)).run(max_rounds=max_rounds)
    sched = FleetScheduler(pool, streams, **kw, journal=pj.OpJournal(
        b, segment_bytes=segment_bytes))
    stats = sched.run(max_rounds=max_rounds)
    return dict(pool=pool, streams=streams, jpool=jpool, jstreams=jstreams,
                a=a, b=b, seen=seen, jseen=jseen, stats=stats, jstats=jstats,
                sched=sched)


@pytest.mark.parametrize("every,full", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_journaled_drain_equals_jax(tmp_path, every, full):
    d = _drain_both(tmp_path, every, full)
    try:
        assert _files(d["b"]) == _files(d["a"])  # WAL bytes, segments
        names = _same_snapshots(d["a"], d["b"])
        assert d["seen"] == d["jseen"] and d["seen"]
        s, js = d["stats"], d["jstats"]
        assert (s.snapshots, s.snapshots_full, s.snapshots_delta) == (
            js.snapshots, js.snapshots_full, js.snapshots_delta)
        assert s.snapshots_full >= 1
        assert (s.snapshots_delta >= 1) == (full > 1)
        assert s.barrier_rounds == s.snapshots  # JAX files some under
        # its compile rounds, which the port does not have
        assert set(s.phase_seconds) >= {"wal", "snapshot"}
        kinds = {json.load(open(os.path.join(d["b"], n, "MANIFEST.json")))
                 ["kind"] for n in names}
        assert ("delta" in kinds) == (full > 1 and len(names) > 1)
    finally:
        d["pool"].close()
        d["jpool"].close()


def test_delta_rows_are_exactly_the_touched_rows(tmp_path):
    """The pool's dirty contract: an install marks its row, an all-PAD
    dispatch marks nothing (and, on rows that are all empty, leaves the
    bucket as JAX's does), ops in one row mark that row, an upload marks
    the rows it names (every row without a list), and ``take_dirty``
    consumes the set, as in JAX's ``DocPool``."""
    from crdt_benches_tpu_torch.traces.tensorize import PAD

    bands = {"synth-small": ("synth", (10, 20))}
    fleet = dict(n_docs=2, mix={"synth-small": 1.0}, seed=1, arrival_span=1,
                 bands=bands)
    pool = DocPool(classes=(256,), slots=(4,), device="cpu",
                   spool_dir=str(tmp_path / "s"))
    jpool = JaxPool(classes=(256,), slots=(4,), spool_dir=str(tmp_path / "j"))
    streams = prepare_streams(build_fleet(**fleet), pool, batch=8,
                              batch_chars=32)
    jax_prepare(jax_build_fleet(**fleet), jpool, batch=8, batch_chars=32)
    K, Rt, B = 2, 4, 8
    st = streams[0]
    take = min(4, st.n_total)
    got = []
    for p in (pool, jpool):
        for d in (0, 1):
            p.admit(d, 16)
        trail = [p.dirty_rows(256), p.take_dirty(), p.take_dirty()]
        dts = p.op_dtypes
        ops = [np.full((K, Rt, B), PAD, dts[0])] + [
            np.zeros((K, Rt, B), dt) for dt in dts[1:]]
        p.macro_step(256, *ops, nbits=6)  # all rows empty, no insert
        trail.append(p.take_dirty())
        trail.append([np.asarray(x).tolist() for x in p.pull_bucket(256)])
        for i, lane in enumerate((st.kind, st.pos, st.rlen, st.slot0)):
            ops[i][0, 1, :take] = lane[:take]
        p.macro_step(256, *ops, nbits=6)
        trail.append(p.take_dirty())
        doc, length, nvis = p.pull_bucket(256)
        p.upload_bucket(256, doc, length, nvis, dirty_rows=[3])
        trail.append(p.take_dirty())
        p.upload_bucket(256, doc, length, nvis)
        trail.append(p.take_dirty())
        got.append(trail)
    assert got[0] == got[1]
    assert got[0][:4] + got[0][5:] == [{0, 1}, {256: [0, 1]}, {}, {},
                                       {256: [1]}, {256: [3]},
                                       {256: [0, 1, 2, 3]}]
    with pytest.raises(ValueError, match="dirty rows"):
        pool.upload_bucket(256, doc, length, nvis, dirty_rows=[4])
    pool.close()
    jpool.close()


# ---- recovery fallbacks on one damaged directory ----


def _report(rep) -> dict:
    out = dataclasses.asdict(rep)
    out.pop("snapshot_dir")
    return out


def _state(pool) -> dict:
    """Bucket states, row maps, doc records and warm entries."""
    return {
        "buckets": {c: (list(b.rows),
                        *(np.asarray(x).tolist() for x in
                          pool.pull_bucket(c)))
                    for c, b in pool.buckets.items()},
        "docs": {d: (r.cls, r.row, r.length, r.last_sched,
                     None if r.spool is None else os.path.basename(r.spool))
                 for d, r in pool.docs.items()},
        "warm": {d: (np.asarray(e.doc_row).tolist(), e.length, e.nvis,
                     e.origin, e.last_sched,
                     None if e.shadow is None else os.path.basename(e.shadow))
                 for d, e in pool.warm.entries.items()},
    }


def _streams(streams) -> dict:
    return {d: (st.cursor, st.limit, st.lossy) for d, st in streams.items()}


def recover_both(tmp_path, jd, sub, fleet=TINY, pool_kw=POOL, warm_docs=0):
    """Recover two copies of ``jd``, one with each package, into fresh
    pools; every report field, bucket state, doc record and cursor equal.
    Returns the port's pool, streams and report (JAX's pool is closed)."""
    a, b = str(tmp_path / f"{sub}_jcopy"), str(tmp_path / f"{sub}_pcopy")
    if os.path.exists(jd):  # else both recover a missing directory
        shutil.copytree(jd, a)
        shutil.copytree(jd, b)
    pool, streams, jpool, jstreams = _pools(tmp_path, sub, fleet, pool_kw,
                                            warm_docs)
    assert pj.probe_recovery(b) == jj.probe_recovery(a)
    jrep = jj.recover_fleet(jpool, jstreams, a)
    rep = pj.recover_fleet(pool, streams, b)
    try:
        assert _report(rep) == _report(jrep)
        assert _state(pool) == _state(jpool)
        assert _streams(streams) == _streams(jstreams)
        assert pool.cold_docs == jpool.cold_docs
    finally:
        jpool.close()
    return pool, streams, rep


def _resume_and_check(pool, streams, rep, want):
    FleetScheduler(pool, streams, macro_k=4, **DRAIN,
                   start_round=rep.resume_round).run()
    for d, text in want.items():
        assert pool.decode(d) == text, d
    pool.close()


def _oracle(fleet=TINY):
    return {s.doc_id: replay_trace(s.trace) for s in build_fleet(**fleet)}


def _port_drain(tmp_path, max_rounds=None, **kw):
    pool = DocPool(**POOL, device="cpu", spool_dir=str(tmp_path / "ps"))
    streams = prepare_streams(build_fleet(**TINY), pool, **DRAIN)
    jd = str(tmp_path / "j")
    sched = FleetScheduler(pool, streams, macro_k=4, **DRAIN,
                           journal=pj.OpJournal(
                               jd, segment_bytes=kw.pop("segment_bytes",
                                                        1 << 20)), **kw)
    sched.run(max_rounds=max_rounds)
    pool.close()
    return jd, sched


def _flip(path, n=16):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xff" * n)


def test_damaged_newest_snapshot_falls_back_like_jax(tmp_path):
    jd, _ = _port_drain(tmp_path, max_rounds=5, snapshot_every=2)
    snaps = pj.list_snapshots(jd)
    newest = os.path.join(jd, snaps[-1])
    _flip(os.path.join(newest, next(f for f in sorted(os.listdir(newest))
                                    if f.startswith(("class_", "delta_")))))
    pool, streams, rep = recover_both(tmp_path, jd, "r")
    assert rep.chain_fallbacks >= 1
    assert rep.snapshot_round < int(snaps[-1][len("snap_"):])
    _resume_and_check(pool, streams, rep, _oracle())


def test_corrupt_delta_then_root_fall_back_like_jax(tmp_path):
    """A corrupt delta member falls back down the chain; with every full
    root corrupt too, to a cold start.  Both steps as JAX's."""
    jd, sched = _port_drain(tmp_path, max_rounds=4, snapshot_every=1,
                            snapshot_full_every=4, segment_bytes=400)
    assert sched.stats.snapshots_delta >= 1
    manifests = {s: pj._read_manifest(os.path.join(jd, s))
                 for s in pj.list_snapshots(jd)}
    victim = [s for s, m in manifests.items() if m["kind"] == "delta"][-1]
    member = next(f for f in os.listdir(os.path.join(jd, victim))
                  if f.startswith("delta_"))
    _flip(os.path.join(jd, victim, member), 12)
    pool, streams, rep = recover_both(tmp_path, jd, "r1")
    assert rep.chain_fallbacks >= 1 and rep.snapshot_round >= 0
    _resume_and_check(pool, streams, rep, _oracle())
    for s, m in manifests.items():
        if m["kind"] == "full":
            for f in os.listdir(os.path.join(jd, s)):
                if f.startswith("class_"):
                    _flip(os.path.join(jd, s, f), 12)
    pool, streams, rep = recover_both(tmp_path, jd, "r2")
    assert rep.chain_fallbacks >= 1 and rep.snapshot_round == -1
    _resume_and_check(pool, streams, rep, _oracle())


def test_parseable_garbage_manifest_falls_back_like_jax(tmp_path):
    jd, _ = _port_drain(tmp_path, max_rounds=4, snapshot_every=1,
                        snapshot_full_every=2)
    mpath = os.path.join(jd, pj.list_snapshots(jd)[-1], "MANIFEST.json")
    m = json.load(open(mpath))
    for key in m["resident"]:
        m["resident"][key][1] = 9999  # valid JSON, an impossible row
    json.dump(m, open(mpath, "w"), separators=(",", ":"))
    pool, streams, rep = recover_both(tmp_path, jd, "r")
    assert rep.chain_fallbacks >= 1
    _resume_and_check(pool, streams, rep, _oracle())


def test_staging_dir_with_valid_manifest_is_never_a_candidate(tmp_path):
    jd, _ = _port_drain(tmp_path, snapshot_every=2)
    snaps = pj.list_snapshots(jd)
    fake = os.path.join(jd, "snap_99999990.tmp")
    shutil.copytree(os.path.join(jd, snaps[-1]), fake)
    m = json.load(open(os.path.join(fake, "MANIFEST.json")))
    m["round"] = 99999990  # using it would skip every redo op
    json.dump(m, open(os.path.join(fake, "MANIFEST.json"), "w"))
    assert "snap_99999990.tmp" not in pj.list_snapshots(jd)
    pool, streams, rep = recover_both(tmp_path, jd, "r")
    assert rep.snapshot_round < 99999990 and rep.staging_removed == 1
    assert not os.path.exists(os.path.join(tmp_path, "r_pcopy",
                                           "snap_99999990.tmp"))
    _resume_and_check(pool, streams, rep, _oracle())
    assert pj.sweep_staging(jd) == ["snap_99999990.tmp"]
    assert pj.sweep_staging(jd) == []


def test_snapshot_keep_zero_never_prunes(tmp_path):
    d = _drain_both(tmp_path, 1, 2, max_rounds=5, keep=0)
    try:
        assert d["stats"].snapshots >= 4
        assert len(_same_snapshots(d["a"], d["b"])) == d["stats"].snapshots
    finally:
        d["pool"].close()
        d["jpool"].close()


def test_gc_floor_keeps_decisions_for_fallback(tmp_path):
    """A shed decision journaled with ``journal.event`` survives WAL GC
    while any retained snapshot predates it: with every later snapshot
    damaged, recovery lands below the decision and re-applies it from the
    WAL, exactly as JAX's does; the resumed drain reproduces the shed
    document's truncation byte for byte."""
    pool = DocPool(**POOL, device="cpu", spool_dir=str(tmp_path / "ps"))
    streams = prepare_streams(build_fleet(**TINY), pool, **DRAIN)
    jd = str(tmp_path / "j")
    journal = pj.OpJournal(jd, segment_bytes=200)
    sched = FleetScheduler(pool, streams, macro_k=4, **DRAIN,
                           journal=journal, snapshot_every=1,
                           snapshot_full_every=2, snapshot_keep=0)
    for _ in range(2):
        sched.run_round()
    victim = max(streams, key=lambda d: streams[d].remaining)
    st = streams[victim]
    at = st.cursor + 2
    shed_round = sched.round
    shed = st.n_total - at
    journal.event("shed", r=shed_round, doc=victim, at=at, ops=shed)
    st.limit, st.lossy = at, True
    sched.run()
    assert sched.done and st.cursor == at
    want = {d: pool.decode(d) for d in streams}
    assert want[victim] != replay_trace(build_fleet(**TINY)[victim].trace)
    for snap in pj.list_snapshots(jd):
        if int(snap[len("snap_"):]) > shed_round:
            _flip(os.path.join(jd, snap, "MANIFEST.json"), 8)
    assert pj.wal_segments(jd)
    pool.close()
    rpool, rstreams, rep = recover_both(tmp_path, jd, "r")
    assert 0 <= rep.snapshot_round <= shed_round
    assert rep.shed_ops == shed
    assert {d for d, s in rstreams.items() if s.lossy} == {victim}
    _resume_and_check(rpool, rstreams, rep, want)


def test_cold_start_without_a_journal_directory(tmp_path):
    pool, streams, rep = recover_both(tmp_path, str(tmp_path / "none"), "r")
    assert rep.snapshot_round == -1 and rep.resume_round == 0
    _resume_and_check(pool, streams, rep, _oracle())


def test_reshard_state_is_refused(tmp_path):
    """Reshard state in a journal is no longer refused: a begin record
    without a commit settles nothing, and a damaged manifest reads as
    absent (nothing was promised), so both recover as JAX's
    ``recover_fleet`` does, with empty ``reshard_*`` fields."""
    jd = str(tmp_path / "j")
    j = pj.OpJournal(jd)
    j.event("reshard", phase="begin", id=1, r=0)
    j.close()
    jd2 = str(tmp_path / "j2")
    os.makedirs(jd2)
    open(os.path.join(jd2, RESHARD_MANIFEST), "w").write("{}")
    for i, d in enumerate((jd, jd2)):
        pool = DocPool(**POOL, device="cpu",
                       spool_dir=str(tmp_path / f"s{i}"))
        streams = prepare_streams(build_fleet(**TINY), pool, **DRAIN)
        rep = pj.recover_fleet(pool, streams, d)
        jpool = JaxPool(**POOL, spool_dir=str(tmp_path / f"js{i}"))
        jrep = jj.recover_fleet(
            jpool, jax_prepare(jax_build_fleet(**TINY), jpool, **DRAIN), d)
        assert (rep.reshard_retired, rep.reshard_docs_moved,
                rep.reshard_completed) == ([], 0, False) == (
            jrep.reshard_retired, jrep.reshard_docs_moved,
            jrep.reshard_completed)
        assert rep.resume_round == jrep.resume_round
        pool.close()
        jpool.close()


# ---- three tiers ----


@pytest.fixture(scope="module")
def tiered_journal(tmp_path_factory):
    """The smoke fleet with a warm tier of 2, journaled by both packages
    (a barrier every round, a full one every other), stopped after 6
    rounds with warm entries at the newest barrier."""
    tmp = tmp_path_factory.mktemp("tiered")
    d = _drain_both(tmp, 1, 2, fleet=SMOKE, pool_kw=SMOKE_POOL,
                    warm_docs=2, max_rounds=6)
    d["pool"].close()
    d["jpool"].close()
    return d


def test_tiered_barriers_equal_jax(tiered_journal):
    """Each barrier's ``warm`` members (the warm entries' compressed
    shadows) and every other member equal JAX's."""
    d = tiered_journal
    assert _files(d["b"]) == _files(d["a"])
    names = _same_snapshots(d["a"], d["b"])
    warm = [pj._read_manifest(os.path.join(d["b"], n))["warm"]
            for n in names]
    assert any(warm)
    assert d["seen"] == d["jseen"]


def test_warm_shadow_is_written_once(tmp_path):
    pool = DocPool(**SMOKE_POOL, device="cpu", warm_docs=2, prefetch=False,
                   spool_dir=str(tmp_path / "s"))
    sessions = build_fleet(**SMOKE)
    prepare_streams(sessions, pool, **DRAIN)
    pool.admit(0, 1)
    doc, length, nvis = pool._pull_row(pool.docs[0])
    pool._free_row(pool.docs[0])
    pool.warm_deposit(0, doc, length, nvis)
    gen = pool.spool_gen(0)
    path = pool.ensure_warm_shadow(0)
    ino = os.stat(path).st_ino
    assert pool.ensure_warm_shadow(0) == path == pool.warm.entries[0].shadow
    assert os.stat(path).st_ino == ino and pool.spool_gen(0) == gen + 1
    st = load_state(path)
    assert (int(st.length[0]), int(st.nvis[0])) == (length, nvis)
    np.testing.assert_array_equal(st.doc[0], doc[:length])
    pool.close()


@pytest.mark.parametrize("warm_docs", [2, 0])
def test_tiered_recovery_equals_jax(tmp_path, tiered_journal, warm_docs):
    """Recovery into a warm pool gives JAX's warm entries (origin
    ``recover``, shadowed by the copied member); into a pool without a
    warm tier the warm members come back as cold spools, as in JAX.  The
    resumed drain gives the oracle's documents."""
    pool, streams, rep = recover_both(
        tmp_path, tiered_journal["b"], "r", fleet=SMOKE,
        pool_kw=SMOKE_POOL, warm_docs=warm_docs)
    assert rep.warm_restored > 0
    if warm_docs:
        assert {e.origin for e in pool.warm.entries.values()} == {"recover"}
    else:
        assert not pool.warm.entries and pool.cold_docs >= rep.warm_restored
    _resume_and_check(pool, streams, rep, _oracle(SMOKE))
