"""The port's write-ahead journal (``serve/journal.py``: framing, segments,
GC, ``SnapshotBases`` and ``rebuild_doc``) against the JAX package's.

Tolerance: exact.  The same records give byte-identical files, the same
reads give the same ``(records, dropped)``, the same GC deletes the same
segments, and a rebuilt row equals JAX's in every slot, its length, its
visible count and its dispatch count.  Each package reads a directory the
other wrote.  The port's rebuild runs its kernels' plain versions here
(CPU tensors); JAX's runs its own CPU route, as its tests do."""

import os
import shutil
import zlib

import numpy as np
import pytest

from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import Session as JaxSession
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu.serve.workload import trace_prefix as jax_trace_prefix
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve.pool import DocPool, decode_row_np
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import (
    Session,
    build_fleet,
    trace_prefix,
)

TINY_BANDS = {
    "synth-small": ("synth", (10, 60)),
    "synth-medium": ("synth", (150, 360)),
}
TINY_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
POOL = dict(classes=(256, 1024), slots=(6, 3))
DRAIN = dict(batch=16, batch_chars=64)


def _sessions(bf=build_fleet, S=Session, tp=trace_prefix):
    """JAX's ``tests/test_journal.py`` fleet: synth docs and two real-trace
    windows, so the drain spans both capacity classes."""
    sessions = bf(10, mix=TINY_MIX, seed=7, arrival_span=3,
                  bands=TINY_BANDS)
    n = len(sessions)
    return sessions + [
        S(doc_id=n, band="trace-small", source="automerge-paper",
          trace=tp("automerge-paper", 240), arrival=1),
        S(doc_id=n + 1, band="trace-medium", source="sveltecomponent",
          trace=tp("sveltecomponent", 500)),
    ]


def _jax_sessions():
    return _sessions(jax_build_fleet, JaxSession, jax_trace_prefix)


def _write_records(mod, jd, segment_bytes=1 << 20, roll=False):
    """One record stream, written by package ``mod`` into ``jd``."""
    j = mod.OpJournal(jd, segment_bytes=segment_bytes)
    for r in range(14):
        j.round_record(r, {256: [[1, 4 * r, 4 * r + 4], [2, r, r + 1]],
                           1024: [[7, 0, 3 * r]]})
        if r == 5:
            j.event("quarantine", r=r, doc=2, at=8, ops=5, reason="test")
        if roll:
            j.maybe_roll()
    j.close()
    return j


def _files(jd):
    return {f: open(os.path.join(jd, f), "rb").read()
            for f in sorted(os.listdir(jd))}


def test_wal_bytes_equal_jax_and_each_reads_the_other(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    _write_records(jj, a)
    _write_records(pj, b)
    assert _files(a) == _files(b)
    assert list(_files(a)) == ["journal.log"]
    want = jj.read_journal(a)
    assert want[1] == 0 and len(want[0]) == 15
    assert pj.read_journal(a) == want  # the port reads JAX's directory
    assert jj.read_journal(b) == want  # and JAX the port's


@pytest.mark.parametrize("damage", ["torn_tail", "mid_file"])
def test_damaged_journal_reads_and_reopens_like_jax(tmp_path, damage):
    """A torn tail is dropped and reopening truncates it; mid-file damage
    stops the read.  Both packages give the same ``(records, dropped)``
    and, after a reopen and one more append, the same bytes."""
    dirs = {}
    for name, mod in (("jax", jj), ("port", pj)):
        jd = str(tmp_path / name)
        _write_records(mod, jd)
        path = os.path.join(jd, "journal.log")
        if damage == "torn_tail":
            with open(path, "a") as f:
                f.write('deadbeef {"t":"round","r":8')  # no newline
        else:
            lines = open(path).readlines()
            payload = lines[3].split(" ", 1)[1].rstrip("\n")
            lines[3] = f"{zlib.crc32(payload.encode()) ^ 1:08x} {payload}\n"
            with open(path, "w") as f:
                f.writelines(lines)
        dirs[name] = jd
    got = pj.read_journal(dirs["port"])
    assert got == jj.read_journal(dirs["jax"])
    assert got[1] >= 1 and len(got[0]) == (15 if damage == "torn_tail"
                                           else 3)
    for name, mod in (("jax", jj), ("port", pj)):
        j = mod.OpJournal(dirs[name])
        j.round_record(40, {256: [[1, 40, 44]]})
        j.close()
    assert _files(dirs["jax"]) == _files(dirs["port"])
    recs, dropped = pj.read_journal(dirs["port"])
    assert dropped == 0 and recs[-1]["r"] == 40


def test_segments_and_gc_equal_jax(tmp_path):
    """At a small ``segment_bytes`` both packages seal the same segments
    with the same bytes, and ``compact`` deletes the same victims."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    ja = _write_records(jj, a, segment_bytes=200, roll=True)
    jb = _write_records(pj, b, segment_bytes=200, roll=True)
    assert _files(a) == _files(b)
    assert len(pj.wal_segments(b)) >= 3
    assert (jb.segments_sealed, jb.bytes_written, jb.records) == (
        ja.segments_sealed, ja.bytes_written, ja.records)
    infos = []
    for mod, jd in ((jj, a), (pj, b)):
        j = mod.OpJournal(jd, segment_bytes=200)
        infos.append([j.compact(r) for r in (3, 9, 100)])
        assert j.gc_segments == sum(i["deleted"] for i in infos[-1])
        j.close()
    assert infos[0] == infos[1]
    assert any(i["deleted"] for i in infos[1])
    assert _files(a) == _files(b)
    assert pj.read_journal(b) == jj.read_journal(a)


@pytest.mark.parametrize("completion", ["open", "compact", "finish"])
def test_torn_gc_pass_is_completed_like_jax(tmp_path, completion):
    """A pass stopped by ``crash_hook`` after its manifest commit leaves
    every segment; the next open, compaction or ``finish_torn_gc``
    completes it, on both sides alike."""
    results = []
    for name, mod in (("jax", jj), ("port", pj)):
        jd = str(tmp_path / name)
        _write_records(mod, jd, segment_bytes=150, roll=True)
        n_before = len(mod.wal_segments(jd))
        j = mod.OpJournal(jd, segment_bytes=150)
        info = j.compact(12, crash_hook=lambda: True)
        assert info["crashed"]
        assert os.path.exists(os.path.join(jd, mod.GC_MANIFEST))
        assert len(mod.wal_segments(jd)) == n_before
        if completion == "open":
            j.close()
            j = mod.OpJournal(jd, segment_bytes=150)
            done = j.torn_gc_completed
        elif completion == "compact":
            done = j.compact(0)["torn_completed"]
        else:
            j.close()
            done = mod.finish_torn_gc(jd)
        j.close()
        assert done >= 1
        assert not os.path.exists(os.path.join(jd, mod.GC_MANIFEST))
        results.append((done, mod.wal_segments(jd), _files(jd)))
    assert results[0] == results[1]


def _fleet_pools(tmp_path, sub, sessions, jsessions):
    pool = DocPool(**POOL, device="cpu", spool_dir=str(tmp_path / f"p{sub}"))
    jpool = JaxPool(**POOL, spool_dir=str(tmp_path / f"j{sub}"))
    return (pool, prepare_streams(sessions, pool, **DRAIN),
            jpool, jax_prepare(jsessions, jpool, **DRAIN))


def test_resurrected_segment_is_ignored_by_recovery(tmp_path):
    """A CRC-valid segment of rounds below the snapshot, put back after GC
    deleted it, is skipped by the redo rule: the port's recovery gives
    JAX's report on the same directory and the oracle's documents."""
    sessions = _sessions()
    pool, streams, _jp, _js = _fleet_pools(tmp_path, "a", sessions,
                                           _jax_sessions())
    jd = str(tmp_path / "j")
    sched = FleetScheduler(pool, streams, macro_k=4, **DRAIN,
                           journal=pj.OpJournal(jd, segment_bytes=200),
                           snapshot_every=2, snapshot_full_every=2,
                           snapshot_keep=1)
    sched.run(max_rounds=4)
    segs = pj.wal_segments(jd)
    assert segs
    saved = str(tmp_path / "resurrect.log")
    shutil.copy2(os.path.join(jd, segs[0]), saved)
    sched.run()
    assert sched.done and segs[0] not in pj.wal_segments(jd)
    shutil.copy2(saved, os.path.join(jd, segs[0]))
    jcopy = str(tmp_path / "jcopy")
    shutil.copytree(jd, jcopy)
    pool_b, streams_b, jpool_b, jstreams_b = _fleet_pools(
        tmp_path, "b", sessions, _jax_sessions())
    rep = pj.recover_fleet(pool_b, streams_b, jd)
    jrep = jj.recover_fleet(jpool_b, jstreams_b, jcopy)
    assert rep.snapshot_round >= 0
    assert (rep.snapshot_round, rep.resume_round, rep.ops_replayed,
            rep.records) == (jrep.snapshot_round, jrep.resume_round,
                             jrep.ops_replayed, jrep.records)
    FleetScheduler(pool_b, streams_b, macro_k=4, **DRAIN,
                   start_round=rep.resume_round).run()
    for s in sessions:
        assert pool_b.decode(s.doc_id) == replay_trace(s.trace)
    for p in (pool, pool_b, jpool_b):
        p.close()


# ---- SnapshotBases and rebuild_doc ----


@pytest.fixture(scope="module")
def delta_journal(tmp_path_factory):
    """The fleet drained by the port with a barrier every round and a full
    one every third, stopped after 5 rounds: the newest snapshot is a
    delta, and docs of both classes sit in it, resident and spooled."""
    tmp = tmp_path_factory.mktemp("bases")
    sessions = _sessions()
    pool = DocPool(**POOL, device="cpu", spool_dir=str(tmp / "spool"))
    streams = prepare_streams(sessions, pool, **DRAIN)
    jd = str(tmp / "j")
    sched = FleetScheduler(pool, streams, macro_k=4, **DRAIN,
                           journal=pj.OpJournal(jd, segment_bytes=300),
                           snapshot_every=1, snapshot_full_every=3)
    sched.run(max_rounds=5)
    assert not sched.done and sched.stats.snapshots_delta >= 1
    newest = pj._read_manifest(os.path.join(jd, pj.list_snapshots(jd)[-1]))
    assert newest["kind"] == "delta" and newest["spooled"]
    pool.close()
    return dict(jd=jd, sessions=sessions, streams=streams, pool=pool)


def test_snapshot_bases_equal_jax(delta_journal):
    jd = delta_journal["jd"]
    bases, jbases = pj.SnapshotBases(jd), jj.SnapshotBases(jd)
    found = 0
    for s in delta_journal["sessions"]:
        got, want = bases.base(s.doc_id), jbases.base(s.doc_id)
        assert (got is None) == (want is None)
        if got is None:
            continue
        found += 1
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert got[1:] == tuple(int(x) for x in want[1:])
    assert found >= len(delta_journal["sessions"]) // 2
    bases.release()
    assert pj.SnapshotBases(None).base(0) is None


def _rebuild_both(streams, jstreams, doc_id, C, base, macro_k, n_init):
    st, jst = streams[doc_id], jstreams[doc_id]
    got = pj.rebuild_doc(st, C, base, st.n_total, n_init=n_init,
                         macro_k=macro_k, device="cpu", **DRAIN)
    want = jj.rebuild_doc(jst, C, base, jst.n_total, n_init=n_init,
                          macro_k=macro_k,
                          nbits=DRAIN["batch_chars"].bit_length(), **DRAIN)
    return got, want


@pytest.mark.parametrize("macro_k", [1, 4])
@pytest.mark.parametrize("from_snapshot", [False, True])
def test_rebuild_doc_equals_jax(tmp_path, delta_journal, macro_k,
                                from_snapshot):
    """Every doc of the fleet (both classes) rebuilt to its final cursor,
    from a fresh row or from its snapshot base: the port's row, length,
    visible count and dispatches equal JAX's, and the row decodes to the
    oracle's document."""
    sessions = delta_journal["sessions"]
    pool, streams, jpool, jstreams = _fleet_pools(tmp_path, "r", sessions,
                                                  _jax_sessions())
    bases = pj.SnapshotBases(delta_journal["jd"])
    classes = set()
    resumed = 0
    for s in sessions:
        rec = pool.docs[s.doc_id]
        C = pool.class_for(rec.capacity_need)
        classes.add(C)
        base = bases.base(s.doc_id) if from_snapshot else None
        resumed += base is not None and base[3] > 0
        got, want = _rebuild_both(streams, jstreams, s.doc_id, C, base,
                                  macro_k, rec.n_init)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert got[1:] == tuple(int(x) for x in want[1:])
        assert decode_row_np(got[0], got[1], got[2], rec.chars) == \
            replay_trace(s.trace)
    assert classes == {256, 1024}
    assert resumed >= (len(sessions) // 2 if from_snapshot else 0)
    pool.close()
    jpool.close()


def test_rebuild_doc_refuses_without_cuda_and_keeps_the_device(
        monkeypatch, delta_journal):
    """``rebuild_doc`` runs on the card unless asked for the CPU, and puts
    its state and every slice's operands on the device it was given (the
    kernels' wrappers pick kernel or plain version by that device): a
    stand-in device (``meta``) reaches the merge call untouched."""
    import torch

    st = delta_journal["streams"][0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pj.rebuild_doc(st, 256, None, st.n_total, n_init=0, **DRAIN)
    seen = []

    class Stop(Exception):
        pass

    def spy(state, *ops):
        seen.extend(t.device.type for t in (*state, *ops))
        raise Stop

    monkeypatch.setattr(pj, "resolve_device",
                        lambda _d: torch.device("meta"))
    monkeypatch.setattr(pj, "merge_rows_macro", spy)
    with pytest.raises(Stop):
        pj.rebuild_doc(st, 256, None, st.n_total, n_init=0, **DRAIN)
    assert seen == ["meta"] * 7


@pytest.mark.parametrize("cursor,start,end", [
    (10, 4, 12), (10, 10, 16), (10, 0, 4), (0, 0, 8), (10, -3, 20),
    (10, 12, 8)])
def test_stream_limit_and_redelivery_clamp_equal_jax(cursor, start, end):
    """``DocStream``'s truncation (``limit``: ``n_total``, ``remaining``)
    and its redelivery clamp (the cursor as the idempotence mark) give
    JAX's numbers."""
    from crdt_benches_tpu.serve.scheduler import DocStream as JaxStream
    from crdt_benches_tpu_torch.serve.scheduler import DocStream

    arrays = dict(kind=np.ones(20, np.int8), pos=np.zeros(20, np.int16),
                  rlen=np.ones(20, np.int16), slot0=np.zeros(20, np.int16),
                  ins_cum=np.arange(1, 21, dtype=np.int32),
                  unit_cum=np.arange(1, 21, dtype=np.int32), n_patches=20)
    for limit in (None, 15, 30):
        st = DocStream(doc_id=0, cursor=cursor, limit=limit, **arrays)
        jst = JaxStream(doc_id=0, cursor=cursor, limit=limit, **arrays)
        assert (st.n_total, st.remaining) == (jst.n_total, jst.remaining)
        assert st.clamp_redelivery(start, end) == \
            jst.clamp_redelivery(start, end)
        assert st.slice_end(cursor, 4, 3, st.n_total) == \
            jst.slice_end(cursor, 4, 3, jst.n_total)
