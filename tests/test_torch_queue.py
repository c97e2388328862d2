"""The port's bounded queues (``queue_cap``, ``overflow_policy``, the
producer's delivery bursts of ``build_fleet(delivery="banded")``) against
the JAX package's, mirroring the queue tests of
``tests/test_serve_faults.py`` and ``test_gc_floor_preserves_decisions_
for_fallback`` of ``tests/test_durability.py``.

Tolerance: exact, held by ``test_torch_faults.py``'s ``assert_same`` (the
same seeded fleet through both packages: events, counters, bucket states,
stream cursors, limits, delivery points, WAL bytes, decodes, the oracle).
"""

import dataclasses
import os

import pytest

from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve.bench import run_serve_bench
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.scheduler import (
    DocStream,
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import DELIVERY_BURST, build_fleet
from test_torch_faults import (
    DUR,
    TINY_BANDS,
    TINY_MIX,
    assert_same,
    close,
    drain_pair,
)


def test_bounded_queue_backpressure_defer_loses_nothing(tmp_path):
    d = drain_pair(tmp_path, queue_cap=8, overflow_policy="defer")
    assert_same(d)
    s = d["port"]["stats"]
    assert d["port"]["sched"].done
    assert s.deferred_ops > 0 and s.backpressure_rounds > 0
    assert s.shed_ops == 0
    close(d)


def test_banded_delivery_burst_flows_through(tmp_path):
    fleet = dict(n_docs=4, mix=TINY_MIX, seed=2, arrival_span=1,
                 bands=TINY_BANDS, delivery="banded")
    sessions, jsessions = build_fleet(**fleet), jax_build_fleet(**fleet)
    assert [s.burst for s in sessions] == [s.burst for s in jsessions]
    assert all(s.burst == DELIVERY_BURST[s.band] > 0 for s in sessions)
    assert all(s.burst is None for s in build_fleet(
        **{**fleet, "delivery": None}))
    d = drain_pair(tmp_path, fleet=fleet, slots=(4,), macro_k=2,
                   queue_cap=16)
    assert_same(d)
    p = d["port"]
    assert all(st.burst == s.burst
               for s, st in zip(p["sessions"], p["streams"].values()))
    assert p["sched"].done and p["stats"].deferred_ops > 0
    close(d)


def test_queue_overflow_shed_policy_is_explicit_and_surfaced(tmp_path):
    d = drain_pair(tmp_path, [("queue_overflow", 2, 64)], 9, queue_cap=8,
                   overflow_policy="shed")
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered and ev.detail["shed"] > 0
    assert p["stats"].overflow_events == 1
    assert p["stats"].shed_ops == ev.detail["shed"]
    lossy = [doc for doc, st in p["streams"].items() if st.lossy]
    assert lossy == [ev.detail["doc"]]
    st = p["streams"][lossy[0]]
    assert st.limit is not None and st.remaining == 0
    close(d)


def test_queue_overflow_defer_is_journaled_like_jax(tmp_path):
    """A deferred burst (the README chaos run's policy) with the journal
    on: the same refusal, the same WAL bytes and snapshot barriers."""
    d = drain_pair(tmp_path, [("queue_overflow", 3)], 4, queue_cap=8,
                   journal=dict(segment_bytes=300), snapshot_every=2)
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered and ev.detail["policy"] == "defer"
    assert ev.detail["deferred"] > 0 and ev.detail["shed"] == 0
    assert p["stats"].shed_ops == 0 and p["stats"].snapshots >= 1
    close(d)


def test_gc_floor_preserves_decisions_for_fallback(tmp_path):
    """A journaled shed decision survives WAL GC while a retained snapshot
    predates it: with every later snapshot damaged, recovery lands below
    the decision and re-applies it from the WAL, and the resumed drain
    reproduces the lossy doc's truncation byte for byte."""
    d = drain_pair(tmp_path, [("queue_overflow", 8)], 1, fleet=DUR["fleet"],
                   classes=DUR["classes"], slots=DUR["slots"], batch=16,
                   batch_chars=64, journal=dict(segment_bytes=200),
                   snapshot_every=1, snapshot_full_every=2, snapshot_keep=0,
                   queue_cap=8, overflow_policy="shed")
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.detail.get("shed", 0) > 0
    shed_round = ev.fired_round
    want = {s.doc_id: p["pool"].decode(s.doc_id) for s in p["sessions"]}
    lossy_docs = sorted(doc for doc, st in p["streams"].items() if st.lossy)
    assert lossy_docs
    for jd, mod in ((d["jax"]["jd"], jj), (p["jd"], pj)):
        for snap in mod.list_snapshots(jd):
            if int(snap[len("snap_"):]) > shed_round:
                mp = os.path.join(jd, snap, "MANIFEST.json")
                with open(mp, "r+b") as f:
                    f.seek(max(0, os.path.getsize(mp) // 2))
                    f.write(b"\xff" * 8)
    pool_b = DocPool(classes=DUR["classes"], slots=DUR["slots"],
                     device="cpu", spool_dir=str(tmp_path / "sb"))
    streams_b = prepare_streams(p["sessions"], pool_b, batch=16,
                                batch_chars=64)
    rep = pj.recover_fleet(pool_b, streams_b, p["jd"])
    jpool_b = JaxPool(classes=DUR["classes"], slots=DUR["slots"],
                      spool_dir=str(tmp_path / "jsb"))
    jrep = jj.recover_fleet(jpool_b, jax_prepare(
        d["jax"]["sessions"], jpool_b, batch=16, batch_chars=64),
        d["jax"]["jd"])
    mine, theirs = dataclasses.asdict(rep), dataclasses.asdict(jrep)
    mine.pop("snapshot_dir"), theirs.pop("snapshot_dir")
    assert mine == theirs
    jpool_b.close()
    assert rep.snapshot_round <= shed_round
    assert rep.shed_ops > 0
    assert sorted(doc for doc, st in streams_b.items() if st.lossy) == \
        lossy_docs
    FleetScheduler(pool_b, streams_b, batch=16, macro_k=4, batch_chars=64,
                   queue_cap=8, overflow_policy="shed",
                   start_round=rep.resume_round).run()
    for s in p["sessions"]:
        assert pool_b.decode(s.doc_id) == want[s.doc_id], s.doc_id
    pool_b.close()
    close(d)


def test_push_delivery_counts_each_refused_op_once(tmp_path):
    """THE admission rule: a push is clamped at ``queue_cap`` pending ops,
    each refused op is counted once however often it is pushed again, and
    the round is flagged as a backpressure round."""
    st = DocStream(doc_id=0, kind=[0] * 100, pos=None, rlen=None,
                   slot0=None, ins_cum=None, unit_cum=None, n_patches=0,
                   delivered=0)
    pool = DocPool(classes=(128,), slots=(1,), device="cpu",
                   spool_dir=str(tmp_path / "s"))
    sched = FleetScheduler(pool, {}, queue_cap=10)
    assert sched._push_delivery(st, 25) == 15
    assert (st.delivered, st.deferred_high, sched.stats.deferred_ops) == (
        10, 25, 15)
    assert sched._push_delivery(st, 30) == 20  # only ops 25..29 are new
    assert sched.stats.deferred_ops == 20 and sched._bp_round
    st.cursor = 10
    assert sched._push_delivery(st, 18) == 0
    assert (st.delivered, sched.stats.deferred_ops) == (18, 20)
    st.burst = 4
    sched._deliver(st)  # the producer's burst: 4 more a round
    assert st.delivered == 20 and st.n_sched == 20
    pool.close()


def test_overflow_policy_is_defer_or_shed(tmp_path):
    pool = DocPool(classes=(128,), slots=(1,), device="cpu",
                   spool_dir=str(tmp_path / "s"))
    with pytest.raises(ValueError, match="unknown overflow policy"):
        FleetScheduler(pool, {}, queue_cap=8, overflow_policy="drop")
    pool.close()
    with pytest.raises(ValueError, match="unknown overflow policy"):
        run_serve_bench(n_docs=2, overflow_policy="drop", device="cpu",
                        log=lambda *_: None)


def test_bench_queue_overflow_defaults_the_cap(tmp_path):
    """``queue_overflow`` without a cap bounds the queue at ``8 * batch``
    (logged), and the shed policy surfaces its loss in the report."""
    lines = []
    ex = run_serve_bench(mix=TINY_MIX, n_docs=6, bands=TINY_BANDS, batch=8,
                         classes=(128,), slots=(2,), seed=11,
                         arrival_span=2, macro_k=4, batch_chars=32,
                         faults="queue_overflow@2=1,burst=64",
                         overflow_policy="shed", device="cpu",
                         log=lines.append)
    assert ex["queue_cap"] == 64
    assert any("defaulting queue_cap=64" in m for m in lines)
    assert ex["faults_ok"] and ex["verify_ok"]
    (e,) = ex["faults"]["events"]
    assert ex["lossy_docs"] == ([e["detail"]["doc"]] if e["detail"]["shed"]
                                else [])
    assert ex["shed_ops"] == e["detail"]["shed"]
    assert ex["verified_docs"] == 6 - len(ex["lossy_docs"])


def test_recovery_resets_the_delivery_point(tmp_path):
    """Recovery carries a bounded stream's delivery point: back to 0 on a
    cold start, to the restored cursor from a snapshot (JAX's
    ``_reset_fleet`` and ``_restore_snapshot``)."""
    sessions = build_fleet(6, mix=TINY_MIX, seed=11, arrival_span=2,
                           bands=TINY_BANDS)
    jd = str(tmp_path / "j")
    pool = DocPool(classes=(128,), slots=(2,), device="cpu",
                   spool_dir=str(tmp_path / "a"))
    streams = prepare_streams(sessions, pool, batch=8, batch_chars=32)
    sched = FleetScheduler(pool, streams, batch=8, macro_k=4, batch_chars=32,
                           queue_cap=8, journal=pj.OpJournal(jd),
                           snapshot_every=1)
    sched.run(max_rounds=3)
    sched.journal.close()
    pool_b = DocPool(classes=(128,), slots=(2,), device="cpu",
                     spool_dir=str(tmp_path / "b"))
    streams_b = prepare_streams(sessions, pool_b, batch=8, batch_chars=32)
    for st in streams_b.values():
        st.delivered = 5
    rep = pj.recover_fleet(pool_b, streams_b, jd)
    assert rep.snapshot_round >= 0
    assert all(st.delivered == st.cursor for st in streams_b.values())
    assert any(st.cursor > 0 for st in streams_b.values())
    pj._reset_fleet(pool_b, streams_b)
    assert all(st.delivered == 0 for st in streams_b.values())
    FleetScheduler(pool_b, streams_b, batch=8, macro_k=4, batch_chars=32,
                   queue_cap=8).run()
    for s in sessions:
        assert pool_b.decode(s.doc_id) == replay_trace(s.trace)
    pool.close()
    pool_b.close()
