"""The port's live resharding (``serve/reshard.py``, the pool's logical shard
map, the scheduler's reshard hooks, ``recover_fleet``'s reshard recovery,
the bench's ``reshard_spec``) against the JAX package's, mirroring the
reshard part of ``tests/test_reshard.py``.

Tolerance: exact.  Each live reshard drains one seeded sharded fleet
through both packages (the port on the CPU with its plain versions) and
holds the port to JAX's drain counters, the coordinator's ``reshard``
block (its latency quantiles aside), the shard states, every bucket array
and row map, every doc record and cursor, the journal's files byte for byte
(the ``reshard`` records) and the manifest's bytes, with
``check_shard_partition`` empty after every round in both; then the JAX
test's own assertions run on the port and every doc equals the oracle."""

import json
import os
import shutil

import numpy as np
import pytest

from crdt_benches_tpu.serve import faults as jf
from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve import reshard as jrs
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import faults as pf
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve import reshard as prs
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.reshard import (
    RESHARD_MANIFEST,
    ReshardCoordinator,
    check_shard_partition,
    commit_manifest,
    parse_reshard_spec,
    read_manifest,
    recover_torn_reshard,
    retire_manifest,
    scan_reshard_records,
)
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import build_fleet

TINY_BANDS = {"synth-small": ("synth", (40, 120))}
TINY_MIX = {"synth-small": 1.0}
STATS = ("rounds", "slices", "ops", "unit_ops", "staged_cells", "patches",
         "evictions", "restores", "promotions", "admissions", "shed_ops",
         "deferred_ops", "faults_injected", "snapshots")


def _side_mods(side):
    if side == "jax":
        return (jf, jj, jrs, jax_build_fleet, JaxPool, jax_prepare,
                JaxScheduler)
    return pf, pj, prs, build_fleet, DocPool, prepare_streams, FleetScheduler


def _sharded(side, tmp_path, n=5, seed=11, classes=(128,), slots=(4,),
             shards=2, spec=None, faults=None, journal=True, **kw):
    """One package's ``_fleet`` of tests/test_reshard.py: a small sharded
    fleet, oversubscribed so the draining shard holds docs at the begin;
    ``faults`` a list of (kind, round) events, seed 3."""
    fmod, jmod, rmod, build, Pool, prep, Sched = _side_mods(side)
    sessions = build(n, mix=TINY_MIX, seed=seed, arrival_span=2,
                     bands=TINY_BANDS)
    pkw = dict(device="cpu") if side == "port" else {}
    pool = Pool(classes=classes, slots=slots, shards=shards,
                spool_dir=str(tmp_path / f"{side}_sp"), **pkw)
    streams = prep(sessions, pool, batch=8, batch_chars=32)
    jd = str(tmp_path / f"{side}_j")
    jr = jmod.OpJournal(jd) if journal else None
    plan = (fmod.FaultPlan([fmod.FaultEvent(kind=k, round=r)
                            for k, r in faults], seed=3)
            if faults else None)
    inj = fmod.FaultInjector(plan) if plan else None
    coord = (rmod.ReshardCoordinator(pool, jr, rmod.parse_reshard_spec(spec),
                                     faults=inj)
             if spec is not None else None)
    sched = Sched(pool, streams, batch=8, macro_k=4, batch_chars=32,
                  journal=jr, reshard=coord, faults=inj, **kw)
    return dict(sessions=sessions, pool=pool, streams=streams, sched=sched,
                coord=coord, plan=plan, jd=jd, partitions=[])


def _drain_pair(tmp_path, max_rounds=None, **kw):
    """Both packages' fleets drained round by round, the partition
    invariant read after every round."""
    out = {}
    for side in ("jax", "port"):
        d = _sharded(side, tmp_path, **kw)
        check = (jrs if side == "jax" else prs).check_shard_partition
        n = 0
        while (max_rounds is None or n < max_rounds) and \
                d["sched"].run_round():
            d["partitions"].append(check(d["pool"]))
            n += 1
        if max_rounds is None:
            d["sched"].run()  # the final fence, the finalize and sweeps
        out[side] = d
    return out


def _files(jd):
    return {f: open(os.path.join(jd, f), "rb").read()
            for f in sorted(os.listdir(jd))
            if os.path.isfile(os.path.join(jd, f))}


def _summary(coord):
    s = dict(coord.summary())
    s.pop("mid_latency")
    return s


def _same(d, oracle=True):
    j, p = d["jax"], d["port"]
    for f in STATS:
        assert getattr(p["sched"].stats, f) == getattr(j["sched"].stats, f), f
    assert p["pool"].shard_state == j["pool"].shard_state
    if j["coord"] is not None:
        assert _summary(p["coord"]) == _summary(j["coord"])
        assert p["coord"].status_fields() == j["coord"].status_fields()
    if j["plan"] is not None:
        assert p["plan"].summary() == j["plan"].summary()
    assert p["partitions"] == j["partitions"]
    assert all(x == [] for x in p["partitions"])
    for cls in j["pool"].classes:
        pb, jb = p["pool"].buckets[cls], j["pool"].buckets[cls]
        assert pb.rows == jb.rows and pb.live == jb.live
        assert sorted(pb.free) == sorted(jb.free)
        for a, b in zip(p["pool"].pull_bucket(cls),
                        j["pool"].pull_bucket(cls)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), cls
    for doc, rec in j["pool"].docs.items():
        prec = p["pool"].docs[doc]
        assert (prec.cls, prec.row, prec.length) == (rec.cls, rec.row,
                                                     rec.length), doc
    for doc, st in j["streams"].items():
        assert p["streams"][doc].cursor == st.cursor, doc
        assert p["streams"][doc].lossy == st.lossy, doc
    if j["sched"].journal is not None:
        j["sched"].journal.close()
        p["sched"].journal.close()
        assert _files(p["jd"]) == _files(j["jd"])
    if oracle:
        for s in p["sessions"]:
            got = p["pool"].decode(s.doc_id)
            assert got == j["pool"].decode(s.doc_id), s.doc_id
            assert got == replay_trace(s.trace), s.doc_id


def _records(jd):
    return pj.read_journal(jd)[0]


def _close(d):
    for side in d.values():
        side["pool"].close()


# ---- the spec grammar -------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "shrink:8:6@12,batch=4", "grow:2:4", "drain:1@3,of=2,batch=1",
    "drain:3", "shrink:2:1,imbalance=0.5", "shrink:8:6@16,batch=64"])
def test_parse_reshard_spec_matrix(spec):
    p, j = parse_reshard_spec(spec), jrs.parse_reshard_spec(spec)
    assert vars(p) == vars(j)
    assert (p.n_shards, p.initial_live) == (j.n_shards, j.initial_live)
    if spec.startswith("shrink:8"):
        assert p.shards == (6, 7) and p.n_shards == 8


@pytest.mark.parametrize("bad,msg", [
    ("shrink:2:2", "FROM > TO"),
    ("shrink:1:0", "FROM > TO"),
    ("grow:4:4", "TO > FROM"),
    ("grow:0:2", "TO > FROM"),
    ("drain:-1", "negative shard"),
    ("drain:1,of=1", "N >= 2"),
    ("drain:5,of=4", "0 <= SHARD < N"),
    ("shrink:2:1,of=2", "only applies to drain"),
    ("shrink:2:1,zap=3", "unknown option"),
    ("shrink:2:1,batch", "key=value"),
    ("explode:2:1", "unknown reshard kind"),
    ("shrink:2", "KIND:FROM:TO"),
    ("drain:1:2", "drain:SHARD"),
])
def test_parse_reshard_spec_rejects(bad, msg):
    for mod in (prs, jrs):
        with pytest.raises(ValueError, match=msg):
            mod.parse_reshard_spec(bad)


# ---- the manifest -----------------------------------------------------------


def test_manifest_bytes_round_trip_and_retire_across_packages(tmp_path):
    m = {"id": 3, "kind": "shrink", "shards": [6, 7], "round": 12,
         "docs": 40}
    pd, jd = str(tmp_path / "p"), str(tmp_path / "j")
    os.makedirs(pd)
    os.makedirs(jd)
    path = commit_manifest(pd, m)
    jrs.commit_manifest(jd, m)
    assert os.path.basename(path) == RESHARD_MANIFEST
    assert not os.path.exists(path + ".tmp")
    assert _files(pd) == _files(jd)  # the same bytes
    assert read_manifest(jd) == jrs.read_manifest(pd) == m  # crosswise
    assert retire_manifest(jd) is True and jrs.retire_manifest(pd) is True
    assert read_manifest(pd) is None and retire_manifest(pd) is False


@pytest.mark.parametrize("garbage", ["{not json", '{"id": "x"}', "[]"])
def test_manifest_garbage_reads_as_absent(tmp_path, garbage):
    p = os.path.join(str(tmp_path), RESHARD_MANIFEST)
    with open(p, "w") as f:
        f.write(garbage)
    assert read_manifest(str(tmp_path)) is None
    assert jrs.read_manifest(str(tmp_path)) is None
    assert retire_manifest(str(tmp_path)) is True
    assert not os.path.exists(p)


def test_retire_discards_staged_tmp(tmp_path):
    tmp = os.path.join(str(tmp_path), RESHARD_MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        f.write("staged, never committed")
    assert retire_manifest(str(tmp_path)) is False
    assert not os.path.exists(tmp)


# ---- the pool's shard map ----------------------------------------------------


def test_draining_shard_refuses_allocation(tmp_path):
    pools = [P(classes=(128,), slots=(8,), shards=2,
               spool_dir=str(tmp_path / n), **kw)
             for P, n, kw in ((DocPool, "p", dict(device="cpu")),
                              (JaxPool, "j", {}))]
    b, jb = (p.buckets[128] for p in pools)
    got = [b.alloc_row() for _ in range(3)]
    assert got == [jb.alloc_row() for _ in range(3)] == [0, 4, 1]
    for p in pools:
        p.drain_shard(1)
    assert b.n_free_live == jb.n_free_live == 2
    assert b.usable_rows == jb.usable_rows == 5  # shard 1 holds one doc
    assert b.live_rows == jb.live_rows == 4
    assert [b.alloc_row() // b.Rg for _ in range(2)] == [0, 0]
    with pytest.raises(RuntimeError, match="no free row"):
        b.alloc_row()
    for p in pools:
        p.revive_shard(1)
    assert b.alloc_row() // b.Rg == 1
    assert pools[0].docs_on_shard(0) == pools[1].docs_on_shard(0) == []
    for p in pools:
        p.close()


def test_pool_rejects_slots_not_divisible_by_shards(tmp_path):
    with pytest.raises(ValueError, match="not divisible by shards=3"):
        DocPool(classes=(128,), slots=(4,), shards=3, device="cpu",
                spool_dir=str(tmp_path))


def test_retire_requires_empty_shard(tmp_path):
    d = _sharded("port", tmp_path, n=2, slots=(4,))
    d["sched"].run(max_rounds=2)
    pool = d["pool"]
    victim = next(s for s in range(2) if pool.docs_on_shard(s))
    pool.drain_shard(victim)
    with pytest.raises(RuntimeError, match="cannot retire"):
        pool.retire_shard(victim)
    pool.close()


def test_coordinator_requires_journal_and_validates_shards(tmp_path):
    pool = DocPool(classes=(128,), slots=(4,), shards=2, device="cpu",
                   spool_dir=str(tmp_path / "spool"))
    with pytest.raises(ValueError, match="journal"):
        ReshardCoordinator(pool, None, parse_reshard_spec("shrink:2:1"))
    jr = pj.OpJournal(str(tmp_path / "journal"))
    try:
        with pytest.raises(ValueError, match="physical shards"):
            ReshardCoordinator(pool, jr, parse_reshard_spec("shrink:4:2"))
        with pytest.raises(ValueError, match="pool has 2 shards"):
            ReshardCoordinator(pool, jr, parse_reshard_spec("drain:5"))
        with pytest.raises(ValueError, match="of=4"):
            ReshardCoordinator(pool, jr, parse_reshard_spec("drain:1,of=4"))
    finally:
        jr.close()
        pool.close()


# ---- live reshards against JAX's ---------------------------------------------


@pytest.mark.parametrize("spec,n,slots,retired", [
    ("shrink:2:1@2,batch=2", 5, (4,), [1]),
    ("grow:1:2@2", 6, (4,), []),
    ("drain:0@2,of=2,batch=1", 4, (4,), [0]),
    ("shrink:2:1@2,batch=1", 10, (32,), [1]),  # row moves, tiers of 8 rows
])
def test_live_reshard_equals_jax(tmp_path, spec, n, slots, retired):
    d = _drain_pair(tmp_path, n=n, slots=slots, spec=spec)
    _same(d)
    p = d["port"]
    coord, pool = p["coord"], p["pool"]
    assert p["sched"].done and coord.state == "done"
    assert check_shard_partition(pool) == []
    assert [s for s in range(2) if pool.shard_state[s] == "retired"] == \
        retired
    assert pool.live_shard_count == 2 - len(retired)
    assert not os.path.exists(os.path.join(p["jd"], RESHARD_MANIFEST))
    records = _records(p["jd"])
    phases = [r["phase"] for r in records if r.get("t") == "reshard"]
    assert phases[0] == "begin" and phases[-1] == "commit"
    got_retired, commits = scan_reshard_records(records)
    assert got_retired == set(retired) and commits == 1
    s = coord.summary()
    assert s["begin_round"] >= 2 and s["commit_round"] >= s["begin_round"]
    if spec.startswith("shrink"):
        assert "move" in phases
        assert coord.migrated + coord.evicted > 0
        if slots == (32,):
            assert coord.migrated > 0  # free live rows: row-to-row moves
    _close(d)


def test_reshard_crash_resumes_from_manifest(tmp_path):
    d = _drain_pair(tmp_path, n=5, spec="shrink:2:1@2,batch=2",
                    faults=[("reshard_crash", 2)])
    _same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered
    assert ev.detail["stage"] == "post_manifest_pre_moves"
    assert ev.detail["via"] == "coordinator_resume"
    assert p["coord"].resumes >= 1 and p["pool"].live_shard_count == 1
    phases = [r["phase"] for r in _records(p["jd"])
              if r.get("t") == "reshard"]
    assert "resume" in phases and phases[-1] == "commit"
    _close(d)


def test_finalize_completes_in_flight_reshard(tmp_path):
    """A reshard still active when the last op drains completes at the
    drain's end: no manifest or draining shard is left."""
    out = {}
    for side, P, J, R, kw in (
            ("port", DocPool, pj, prs, dict(device="cpu")),
            ("jax", JaxPool, jj, jrs, {})):
        pool = P(classes=(128,), slots=(4,), shards=2,
                 spool_dir=str(tmp_path / f"{side}_sp"), **kw)
        for d in range(4):
            pool.register(d, n_init=4, capacity_need=32,
                          chars=np.arange(4, dtype=np.int32) + 97)
            pool.admit(d, need=8)
        jd = str(tmp_path / f"{side}_j")
        jr = J.OpJournal(jd)
        coord = R.ReshardCoordinator(pool, jr,
                                     R.parse_reshard_spec("shrink:2:1"))
        coord.tick(2, None, imbalance=0.0)
        assert coord.state == "active"
        assert os.path.exists(os.path.join(jd, RESHARD_MANIFEST))
        coord.finalize(3)
        jr.close()
        out[side] = (pool, coord, jd)
    pool, coord, jd = out["port"]
    assert coord.state == "done" and pool.shard_state == ["live", "retired"]
    assert check_shard_partition(pool) == []
    assert not os.path.exists(os.path.join(jd, RESHARD_MANIFEST))
    assert all(pool.decode(d) == "abcd" for d in range(4))
    assert _summary(coord) == _summary(out["jax"][1])
    assert _files(jd) == _files(out["jax"][2])
    for p, _c, _j in out.values():
        p.close()


def test_migrating_docs_defer_never_shed(tmp_path):
    d = _drain_pair(tmp_path, n=6, spec="shrink:2:1@2,batch=1",
                    overflow_policy="shed")
    _same(d)
    p = d["port"]
    assert p["coord"].state == "done" and p["sched"].stats.shed_ops == 0
    assert not any(st.lossy for st in p["streams"].values())
    assert p["sched"].stats.deferred_ops >= p["coord"].deferred_ops
    # the scheduler never picks a draining shard's resident as a victim
    pool = DocPool(classes=(128,), slots=(4,), shards=2, device="cpu",
                   spool_dir=str(tmp_path / "v"))
    fleet = _sharded("port", tmp_path / "v2", n=4, slots=(4,))
    fleet["sched"].run(max_rounds=1)
    fpool = fleet["pool"]
    on1 = [doc for doc, _c, _r in fpool.docs_on_shard(1)]
    fpool.drain_shard(1)
    if on1 and fpool.docs_on_shard(0):
        victim = fleet["sched"]._pick_victim(128, set(), set())
        assert victim not in on1
    _close(d)
    pool.close()
    fpool.close()


def test_status_view_and_gauges(tmp_path):
    """``status_fields`` carries the coordinator's view and the registry
    its ``serve.reshard.*`` series, as in JAX."""
    d = _drain_pair(tmp_path, n=5, spec="shrink:2:1@2,batch=2",
                    max_rounds=3)
    p, j = d["port"], d["jax"]
    assert p["sched"].status_fields()["reshard"] == \
        j["sched"].status_fields()["reshard"]
    pm = {k: v for k, v in p["sched"].stats.metrics.to_dict()[
        "counters"].items() if k.startswith("serve.reshard.")}
    jm = {k: v for k, v in j["sched"].stats.metrics.to_dict()[
        "counters"].items() if k.startswith("serve.reshard.")}
    assert pm == jm and pm["serve.reshard.rounds"] >= 1
    _close(d)


# ---- recovery: roll forward or back, both ways -------------------------------


def _resident_on(pool, shard):
    """Admit one registered doc onto ``shard`` (the others drained for the
    admission)."""
    for s in range(pool.n_sh):
        if s != shard:
            pool.drain_shard(s)
    doc = next(iter(pool.docs))
    pool.admit(doc, need=pool.docs[doc].length)
    for s in range(pool.n_sh):
        if s != shard:
            pool.revive_shard(s)
    assert pool.docs[doc].row // pool.buckets[pool.docs[doc].cls].Rg == shard
    return doc


def _torn_pair(tmp_path, setup):
    out = {}
    for side in ("jax", "port"):
        d = _sharded(side, tmp_path / side, n=3, journal=False)
        jd = str(tmp_path / side / "jd")
        os.makedirs(jd)
        mod = jrs if side == "jax" else prs
        out[side] = (d, jd, setup(mod, d["pool"], jd))
    return out


def test_recover_torn_reshard_rolls_forward(tmp_path):
    def setup(mod, pool, jd):
        doc = _resident_on(pool, 1)
        mod.commit_manifest(jd, {"id": 1, "kind": "shrink", "shards": [1],
                                 "round": 4, "docs": 1})
        return doc, mod.recover_torn_reshard(pool, jd, [])
    out = _torn_pair(tmp_path, setup)
    d, jd, (doc, rep) = out["port"]
    assert rep == out["jax"][2][1] == {"retired": [1], "moved": 1,
                                       "completed": True}
    pool = d["pool"]
    assert pool.shard_state[1] == "retired" and pool.docs[doc].cls is None
    assert check_shard_partition(pool) == [] and read_manifest(jd) is None
    assert pool.decode(doc) == out["jax"][0]["pool"].decode(doc)
    for d, _jd, _x in out.values():
        d["pool"].close()


def test_recover_torn_reshard_rolls_back_staged_tmp(tmp_path):
    def setup(mod, pool, jd):
        tmp = os.path.join(jd, RESHARD_MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            f.write("staged")
        return tmp, mod.recover_torn_reshard(pool, jd, [])
    out = _torn_pair(tmp_path, setup)
    d, _jd, (tmp, rep) = out["port"]
    assert rep == out["jax"][2][1] == {"retired": [], "moved": 0,
                                       "completed": False}
    assert not os.path.exists(tmp)
    assert d["pool"].shard_state == ["live", "live"]
    for d, _jd, _x in out.values():
        d["pool"].close()


def test_recover_torn_reshard_replays_commit_records(tmp_path):
    records = [{"t": "reshard", "phase": "commit", "retired": [1],
                "revived": []}]

    def setup(mod, pool, jd):
        doc = _resident_on(pool, 1)
        return doc, mod.recover_torn_reshard(pool, jd, records)
    out = _torn_pair(tmp_path, setup)
    d, _jd, (doc, rep) = out["port"]
    assert rep == out["jax"][2][1]
    assert rep["retired"] == [1] and rep["moved"] == 1
    assert rep["completed"] is False
    assert d["pool"].docs[doc].cls is None
    assert check_shard_partition(d["pool"]) == []
    for d, _jd, _x in out.values():
        d["pool"].close()


def test_scan_reshard_records_grow_revives():
    records = [
        {"t": "reshard", "phase": "begin", "shards": [1]},
        {"t": "reshard", "phase": "commit", "retired": [1], "revived": []},
        {"t": "wal", "round": 3},
        {"t": "reshard", "phase": "commit", "retired": [],
         "revived": [1]},  # a later grow opened the shard again
    ]
    for cut in (len(records), 2):
        assert scan_reshard_records(records[:cut]) == \
            jrs.scan_reshard_records(records[:cut])
    assert scan_reshard_records(records) == (set(), 2)
    assert scan_reshard_records(records[:2]) == ({1}, 1)


def test_recover_torn_reshard_ignores_out_of_range_shard(tmp_path):
    d = _sharded("port", tmp_path, n=3, journal=False)
    jd = str(tmp_path / "jd")
    os.makedirs(jd)
    commit_manifest(jd, {"id": 1, "kind": "shrink", "shards": [7],
                         "round": 2, "docs": 0})
    rep = recover_torn_reshard(d["pool"], jd, [])
    assert rep["retired"] == [7] and rep["moved"] == 0
    assert d["pool"].shard_state == ["live", "live"]
    d["pool"].close()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("spec,stop", [("shrink:2:1@2,batch=1", 2),
                                       ("grow:1:2@2", 2)])
def test_crashed_reshard_recovers_across_packages(tmp_path, writer, spec,
                                                  stop):
    """A journaled reshard drain (a barrier every round) stopped after the
    manifest commit and before the commit record, written by ``writer``,
    is recovered by both packages: the same report (a shrink rolled
    forward, its restored residents evicted; a grow's revived shards left
    live), the same resumed fleet, every doc the oracle's."""
    src = _sharded(writer, tmp_path / "w", n=6, spec=spec,
                   faults=[("reshard_crash", 2)], snapshot_every=1)
    src["sched"].run(max_rounds=stop)
    assert src["coord"].state in ("active", "crashed")
    src["sched"].journal.close()
    jd = src["jd"]
    assert os.path.exists(os.path.join(jd, RESHARD_MANIFEST))
    src["pool"].close()
    out = {}
    for side in ("jax", "port"):
        # a recovery retires the manifest: each package recovers a copy
        rjd = str(tmp_path / f"copy_{side}")
        shutil.copytree(jd, rjd)
        fmod, jmod, rmod, build, Pool, prep, Sched = _side_mods(side)
        sessions = build(6, mix=TINY_MIX, seed=11, arrival_span=2,
                         bands=TINY_BANDS)
        pkw = dict(device="cpu") if side == "port" else {}
        pool = Pool(classes=(128,), slots=(4,), shards=2,
                    spool_dir=str(tmp_path / f"r_{side}"), **pkw)
        streams = prep(sessions, pool, batch=8, batch_chars=32)
        rep = jmod.recover_fleet(pool, streams, rjd)
        state = (list(pool.shard_state), sorted(
            (d, r.cls, r.row) for d, r in pool.docs.items()))
        sched = Sched(pool, streams, batch=8, macro_k=4, batch_chars=32,
                      start_round=rep.resume_round)
        sched.run()
        assert sched.done
        assert not os.path.exists(os.path.join(rjd, RESHARD_MANIFEST))
        out[side] = dict(rep=rep, state=state, pool=pool,
                         sessions=sessions, streams=streams)
    p, j = out["port"], out["jax"]
    for f in ("snapshot_round", "resume_round", "docs_restored",
              "ops_replayed", "reshard_retired", "reshard_docs_moved",
              "reshard_completed"):
        assert getattr(p["rep"], f) == getattr(j["rep"], f), f
    assert p["state"] == j["state"]
    if spec.startswith("shrink"):
        assert p["rep"].reshard_retired == [1]
        assert p["rep"].reshard_completed and p["rep"].reshard_docs_moved > 0
        assert p["pool"].shard_state[1] == "retired"
    else:
        assert p["rep"].reshard_retired == []
        assert p["pool"].shard_state == ["live", "live"]
    assert check_shard_partition(p["pool"]) == []
    for s in p["sessions"]:
        assert p["pool"].decode(s.doc_id) == replay_trace(s.trace)
        assert p["pool"].decode(s.doc_id) == j["pool"].decode(s.doc_id)
    for x in out.values():
        x["pool"].close()


# ---- the bench -------------------------------------------------------------


def test_bench_reshard_report_and_refusals(tmp_path):
    """``run_serve_bench(reshard_spec=)``: the JAX smoke's crash recipe
    (shrink:2:1@4 under ``reshard_crash@4``) on a small fleet, the
    ``reshard`` block equal to JAX's artifact but the latencies, the
    partition clean; and JAX's refusals."""
    from crdt_benches_tpu.serve.bench import run_serve_bench as jax_bench
    from crdt_benches_tpu_torch.serve.bench import run_serve_bench

    kw = dict(mix=TINY_MIX, n_docs=8, bands=TINY_BANDS, batch=8,
              macro_k=4, batch_chars=32, classes=(128,), slots=(4,),
              arrival_span=2, journal_dir="auto", snapshot_every=3,
              reshard_spec="shrink:2:1@4,batch=2",
              faults="seed=5,reshard_crash@4=1", log=lambda *_: None)
    rep = run_serve_bench(device="cpu", **kw)
    r, _info = jax_bench(results_dir=str(tmp_path), save_name="rs", **kw)
    x = r.extra
    assert rep["verify_ok"] and rep["faults_ok"]
    blk = dict(rep["reshard"])
    jblk = dict(x["reshard"])
    assert blk.pop("mid_latency") and jblk.pop("mid_latency")
    assert blk == jblk and blk["partition_errors"] == []
    assert blk["state"] == "done" and blk["resumes"] == 1
    assert rep["faults"] == x["faults"]
    for k in ("rounds", "range_ops", "evictions", "restores"):
        assert rep[k] == x[k], k
    small = dict(mix=TINY_MIX, n_docs=2, bands=TINY_BANDS, classes=(128,),
                 slots=(4,), device="cpu", log=lambda *_: None)
    with pytest.raises(ValueError, match="--serve-journal is required"):
        run_serve_bench(reshard_spec="shrink:2:1", **small)
    with pytest.raises(ValueError, match="own bench family"):
        run_serve_bench(reshard_spec="shrink:2:1", journal_dir="auto",
                        serve_tiers="warm=4", **small)
    with pytest.raises(ValueError, match="does not determine a shard"):
        run_serve_bench(reshard_spec="drain:0", journal_dir="auto", **small)
    with pytest.raises(ValueError, match="--serve-reshard is required"):
        run_serve_bench(faults="reshard_crash=1", **small)
    assert json.dumps(rep["reshard"])  # plain data
