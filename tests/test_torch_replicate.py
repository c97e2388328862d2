"""The port's multi-writer replication (``serve/replicate/``,
``serve/workload.py split_turns``/``replicate_sessions``) against the JAX
package's, mirroring ``tests/test_serve_replicate.py``.

Tolerance: exact.  Each drain runs one seeded replicated fleet through both
packages (the port on the CPU with its plain versions; JAX on the CPU) and
holds the port to JAX's drain counters, the ``replication`` and
``convergence`` blocks (no timings are in them), the bus's sampled
histories and publish logs, every bucket array and row map, every doc
record and stream cursor and delivery point, the fault events with their
details and, with a journal, the WAL bytes (its ``bcast`` records
included); then the JAX test's own assertions run on the port and every
replica equals the oracle."""

import os

import numpy as np
import pytest

from crdt_benches_tpu.serve import faults as jf
from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve import replicate as jr
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.replicate.checker import (
    _axiom_violations as jax_axioms,
)
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu.serve.workload import replicate_sessions as jax_rs
from crdt_benches_tpu.serve.workload import split_turns as jax_split
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import faults as pf
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve import replicate as pr
from crdt_benches_tpu_torch.serve.pool import DocPool, decode_row_np
from crdt_benches_tpu_torch.serve.replicate.checker import _axiom_violations
from crdt_benches_tpu_torch.serve.replicate.group import ReplicaGroup
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import (
    build_fleet,
    replicate_sessions,
    split_turns,
)

TINY_BANDS = {"synth-small": ("synth", (10, 60)),
              "synth-medium": ("synth", (150, 360))}
TINY_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
STATS = ("rounds", "slices", "ops", "unit_ops", "staged_cells", "patches",
         "evictions", "restores", "promotions", "admissions", "shed_ops",
         "deferred_ops", "recoveries", "faults_seen", "faults_injected",
         "degraded_rounds", "snapshots")
STREAM = ("cursor", "limit", "lossy", "delivered")
COUNTS = ("merged_ops", "merged_unit_ops", "local_ops")


def _side_mods(side):
    if side == "jax":
        return jf, jj, jr, jax_build_fleet, JaxPool, jax_prepare
    return pf, pj, pr, build_fleet, DocPool, prepare_streams


def _fleet_of(side, tmp_path, n_docs, writers, *, seed=3, slots=(8, 4),
              arrival_span=2, serve_kernel="fused", spec=None, journal=None,
              **sched_kw):
    """One package's ``_fleet`` of tests/test_serve_replicate.py; ``spec``
    a fault spec, ``journal`` ``OpJournal`` keywords."""
    fmod, jmod, rmod, build, Pool, prep = _side_mods(side)
    sessions = build(n_docs, mix=TINY_MIX, seed=seed,
                     arrival_span=arrival_span, bands=TINY_BANDS)
    reps, table = rmod.build_writer_groups(sessions, writers)
    pkw = dict(device="cpu") if side == "port" else {}
    pool = Pool(classes=(128, 512), slots=slots,
                spool_dir=str(tmp_path / f"{side}_sp"),
                serve_kernel=serve_kernel, **pkw)
    streams = prep(reps, pool, batch=16)
    plan = fmod.FaultPlan.from_spec(spec) if spec else None
    jd = str(tmp_path / f"{side}_j")
    sched = rmod.ReplicatedScheduler(
        pool, streams, table, batch=16,
        faults=fmod.FaultInjector(plan) if plan else None,
        journal=jmod.OpJournal(jd, **journal) if journal is not None
        else None, **{"turn_ops": 8, "macro_k": 4, **sched_kw})
    return dict(sessions=sessions, table=table, pool=pool, streams=streams,
                sched=sched, plan=plan, jd=jd)


def _drain_pair(tmp_path, *args, max_rounds=None, **kw):
    out = {}
    for side in ("jax", "port"):
        d = _fleet_of(side, tmp_path, *args, **kw)
        d["stats"] = d["sched"].run(max_rounds=max_rounds)
        out[side] = d
    return out


def _files(jd):
    return {f: open(os.path.join(jd, f), "rb").read()
            for f in sorted(os.listdir(jd))
            if os.path.isfile(os.path.join(jd, f))}


def _same(d, oracle=True):
    """The port's replicated drain equals JAX's (module docstring)."""
    j, p = d["jax"], d["port"]
    for f in STATS:
        assert getattr(p["stats"], f) == getattr(j["stats"], f), f
    js, ps = j["sched"], p["sched"]
    for f in COUNTS:
        assert getattr(ps, f) == getattr(js, f), f
    assert ps.replication_block() == js.replication_block()
    assert ps.bus.histories == js.bus.histories
    assert ps.bus.publish_log == js.bus.publish_log
    assert (ps.replica_metrics.merged_total()
            == js.replica_metrics.merged_total())
    if j["plan"] is not None:
        assert p["plan"].summary() == j["plan"].summary()
    for cls in j["pool"].classes:
        assert p["pool"].buckets[cls].rows == j["pool"].buckets[cls].rows
        for a, b in zip(p["pool"].pull_bucket(cls),
                        j["pool"].pull_bucket(cls)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), cls
    for doc, rec in j["pool"].docs.items():
        prec = p["pool"].docs[doc]
        assert (prec.cls, prec.row, prec.length, prec.last_sched) == (
            rec.cls, rec.row, rec.length, rec.last_sched), doc
        assert (prec.spool is None) == (rec.spool is None), doc
    for doc, st in j["streams"].items():
        for f in STREAM:
            assert getattr(p["streams"][doc], f) == getattr(st, f), (doc, f)
    if js.journal is not None:
        js.journal.close()
        ps.journal.close()
        assert _files(p["jd"]) == _files(j["jd"])
    if oracle:
        rep = pr.ConvergenceReport()
        pr.check_convergence(p["pool"], p["table"], p["sessions"],
                             p["streams"], rep)
        pr.check_ra_linearizability(ps.bus, p["table"], rep)
        jrep = jr.ConvergenceReport()
        jr.check_convergence(j["pool"], j["table"], j["sessions"],
                             j["streams"], jrep)
        jr.check_ra_linearizability(js.bus, j["table"], jrep)
        assert rep.to_dict() == jrep.to_dict()
        assert rep.converged and rep.ra_ok, (rep.byte_mismatches[:3],
                                             rep.ra_violations[:3])
        return rep
    return None


def _close(d):
    for side in d.values():
        side["pool"].close()


# ---- the turn split --------------------------------------------------------


@pytest.mark.parametrize("n,w,t", [(21, 3, 4), (0, 2, 8), (64, 4, 64),
                                   (65, 4, 64), (7, 1, 3)])
def test_split_turns_partitions_round_robin(n, w, t):
    blocks = split_turns(n, w, t)
    assert blocks == jax_split(n, w, t)
    if n:
        assert blocks[0][0] == 0 and blocks[-1][1] == n
    for (lo, hi, _w), (lo2, _hi2, _w2) in zip(blocks, blocks[1:]):
        assert hi == lo2 and hi > lo
    assert [b[2] for b in blocks] == [i % w for i in range(len(blocks))]
    with pytest.raises(ValueError):
        split_turns(10, 0, 4)
    with pytest.raises(ValueError):
        split_turns(10, 2, 0)


def test_replica_sessions_and_groups_equal_jax():
    sess = build_fleet(4, mix=TINY_MIX, seed=5, arrival_span=3,
                       bands=TINY_BANDS)
    jsess = jax_build_fleet(4, mix=TINY_MIX, seed=5, arrival_span=3,
                            bands=TINY_BANDS)
    got = [(s.doc_id, s.band, s.source, s.arrival, s.burst)
           for s in replicate_sessions(sess, 3)]
    assert got == [(s.doc_id, s.band, s.source, s.arrival, s.burst)
                   for s in jax_rs(jsess, 3)]
    reps, table = pr.build_writer_groups(sess, 3)
    assert [g.replica_ids for g in table] == [
        g.replica_ids for g in jr.build_writer_groups(jsess, 3)[1]]
    assert all(r.trace is sess[r.doc_id // 3].trace for r in reps)
    assert table.group_of(7) == (table.groups[2], 1)


def test_remote_interval_attribution():
    g = ReplicaGroup(logical_id=0, writers=2, replica_ids=(0, 1),
                     blocks=split_turns(20, 2, 4), n_ops=20)
    jg = jr.ReplicaGroup(logical_id=0, writers=2, replica_ids=(0, 1),
                         blocks=jax_split(20, 2, 4), n_ops=20)
    assert g.remote_intervals(0, 0, 20) == [(4, 8), (12, 16)]
    assert g.split_local_remote(0, 2, 10) == (4, 4)
    assert g.split_local_remote(1, 2, 10) == (4, 4)
    assert g.split_local_remote(0, 5, 5) == (0, 0)
    for w in (0, 1):
        for lo, hi in ((0, 20), (3, 17), (8, 9), (19, 20)):
            assert g.remote_intervals(w, lo, hi) == jg.remote_intervals(
                w, lo, hi)
            assert g.split_local_remote(w, lo, hi) == jg.split_local_remote(
                w, lo, hi)


# ---- drains against JAX's --------------------------------------------------


@pytest.mark.parametrize("writers,slots,kernel,k", [
    (2, (8, 4), "fused", 4),
    (4, (6, 3), "fused", 4),  # eviction and restore churn on replica rows
    (2, (8, 4), "fused", 1),
    (2, (8, 4), "fused", 8),
    (2, (8, 4), "scan", 4),
])
def test_replicated_drain_equals_jax(tmp_path, writers, slots, kernel, k):
    n = 6 if writers == 2 else 5
    d = _drain_pair(tmp_path, n, writers, slots=slots, serve_kernel=kernel,
                    macro_k=k, history_sample=n)
    rep = _same(d)
    p = d["port"]
    assert p["sched"].done
    assert rep.replicas_checked == n * writers and rep.ra_groups_checked == n
    s, st = p["sched"], p["stats"]
    assert s.merged_ops + s.local_ops == st.ops
    nbytes = sum(dt.itemsize for dt in p["pool"].op_dtypes)
    assert s.bus.bytes_broadcast == s.merged_ops * nbytes
    if writers == 2:
        assert s.merged_ops == s.local_ops
        assert s.bus.divergence_max >= 1
    else:
        assert st.evictions > 0 and st.restores > 0
        assert s.merged_ops > s.local_ops
    _close(d)


def test_writers1_matches_plain_scheduler(tmp_path):
    """A one-writer group is the plain fleet: the same bytes, no merge."""
    sessions = build_fleet(5, mix=TINY_MIX, seed=11, arrival_span=2,
                           bands=TINY_BANDS)
    pool_a = DocPool(classes=(128, 512), slots=(8, 4), device="cpu",
                     spool_dir=str(tmp_path / "a"))
    st_a = prepare_streams(sessions, pool_a, batch=16)
    plain = FleetScheduler(pool_a, st_a, batch=16, macro_k=4).run()
    reps, table = pr.build_writer_groups(sessions, 1)
    pool_b = DocPool(classes=(128, 512), slots=(8, 4), device="cpu",
                     spool_dir=str(tmp_path / "b"))
    st_b = prepare_streams(reps, pool_b, batch=16)
    sched = pr.ReplicatedScheduler(pool_b, st_b, table, batch=16,
                                   macro_k=4, turn_ops=8)
    stats = sched.run()
    assert sched.done
    assert sched.merged_ops == 0 and sched.bus.bytes_broadcast == 0
    assert stats.ops == plain.ops and stats.unit_ops == plain.unit_ops
    for s in sessions:
        assert pool_a.decode(s.doc_id) == pool_b.decode(s.doc_id)
    pool_a.close()
    pool_b.close()


def test_mid_macro_evict_restore_of_diverged_replica(tmp_path):
    """A replica evicted through the spool while its group diverges keeps
    its partial merge state and converges; the same eviction in JAX's
    drain leaves the same fleet."""
    pair = {side: _fleet_of(side, tmp_path, 5, 2, macro_k=2)
            for side in ("jax", "port")}
    victim = None
    for _ in range(40):
        for d in pair.values():
            assert d["sched"].run_round()
        p = pair["port"]
        for g in p["table"]:
            for rid in g.replica_ids:
                st = p["streams"][rid]
                if not (0 < st.cursor < st.n_total
                        and p["pool"].docs[rid].cls is not None):
                    continue
                peers = [p["streams"][o].cursor for o in g.replica_ids
                         if o != rid]
                if any(c != st.cursor for c in peers):
                    victim = rid
                    break
            if victim is not None:
                break
        if victim is not None:
            break
    assert victim is not None, "no diverged resident replica found"
    for d in pair.values():
        assert d["pool"].evict(victim)
        d["stats"] = d["sched"].run()
    _same(pair)
    assert pair["port"]["pool"].restores >= 1
    _close(pair)


@pytest.mark.parametrize("spec,writers,axis", [
    ("seed=5,span=4,replica_partition=1", 2, "partitions_healed"),
    ("seed=2,span=3,merge_reorder=1", 3, "reordered_rounds"),
])
def test_replication_faults_equal_jax(tmp_path, spec, writers, axis):
    """``replica_partition``: one replica's broadcasts drop for a span and
    the heal reconverges it; ``merge_reorder``: a round's remote batches
    arrive permuted and reassembly commutes.  Both fire and recover, with
    JAX's details."""
    d = _drain_pair(tmp_path, 6, writers, spec=spec, history_sample=6)
    _same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered, ev.to_dict()
    assert getattr(p["sched"].bus, axis) >= 1
    if axis == "partitions_healed":
        assert p["sched"].bus.divergence_max > 1
    else:
        assert ev.detail.get("commuted")
    _close(d)


def test_merge_rows_macro_equals_sequential_oracle(tmp_path):
    """A three-writer group's assembled stream over a fresh replica row, K
    rounds in one ``merge_rows_macro`` call and round by round through
    ``merge_rows_round``, equals the oracle's sequential replay."""
    import torch

    from crdt_benches_tpu_torch.engine.merge_fleet import (
        merge_rows_macro,
        merge_rows_round,
    )
    from crdt_benches_tpu_torch.ops.apply2 import PackedState
    from crdt_benches_tpu_torch.ops.packing import widen_ops
    from crdt_benches_tpu_torch.serve.pool import _fresh_row_np
    from crdt_benches_tpu_torch.serve.workload import Session
    from crdt_benches_tpu_torch.traces.synth import synth_trace

    trace = synth_trace(seed=77, n_ops=120)
    reps, _table = pr.build_writer_groups(
        [Session(doc_id=0, band="synth-medium", source="synth",
                 trace=trace)], 3)
    pool = DocPool(classes=(512,), slots=(4,), device="cpu",
                   spool_dir=str(tmp_path))
    st = prepare_streams(reps, pool, batch=16)[0]
    B, n, c, cuts = 16, st.n_total, 0, []
    while c < n:
        e = st.slice_end(c, B, 256, n)
        cuts.append((c, e))
        c = e
    K = len(cuts)
    ops = np.zeros((4, K, 1, B), np.int32)
    wide = widen_ops(st.kind, st.pos, st.rlen, st.slot0)
    for k, (lo, hi) in enumerate(cuts):
        for a in range(4):
            ops[a, k, 0, :hi - lo] = wide[a][lo:hi]
    rec = pool.docs[0]

    def fresh():
        return PackedState(
            torch.from_numpy(_fresh_row_np(512, rec.n_init)[None]),
            torch.tensor([rec.n_init], dtype=torch.int32),
            torch.tensor([rec.n_init], dtype=torch.int32))

    kd, pd, ld, sd = (torch.from_numpy(a) for a in ops)
    out = merge_rows_macro(fresh(), kd, pd, ld, sd)
    got = decode_row_np(out.doc[0].numpy(), int(out.length[0]),
                        int(out.nvis[0]), rec.chars)
    assert got == replay_trace(trace)
    state = fresh()
    for k in range(K):
        state = merge_rows_round(state, kd[k], pd[k], ld[k], sd[k])
    assert decode_row_np(state.doc[0].numpy(), int(state.length[0]),
                         int(state.nvis[0]), rec.chars) == got
    pool.close()


# ---- the checker -----------------------------------------------------------


def _clean_history(group, rounds_apart=1):
    """An axiom-clean history: each block published at round seq,
    delivered locally then and remotely ``rounds_apart`` later."""
    publish_log = [(seq, seq) for seq in range(group.n_blocks)]
    hist = [[] for _ in range(group.writers)]
    for seq in range(group.n_blocks):
        owner = group.owner(seq)
        hist[owner].append((seq, seq))
        for w in range(group.writers):
            if w != owner:
                hist[w].append((seq + rounds_apart, seq))
    return hist, publish_log


def test_ra_checker_accepts_clean_and_rejects_doctored():
    g = ReplicaGroup(logical_id=7, writers=2, replica_ids=(14, 15),
                     blocks=split_turns(24, 2, 4), n_ops=24)
    hist, plog = _clean_history(g)
    assert _axiom_violations(7, g, hist, plog) == []
    doctored = {}
    bad = [list(h) for h in hist]  # A1: one writer's blocks out of order
    i = next(i for i, (_r, s) in enumerate(bad[1]) if g.owner(s) == 0)
    j = next(j for j in range(i + 1, len(bad[1]))
             if g.owner(bad[1][j][1]) == 0)
    bad[1][i], bad[1][j] = bad[1][j], bad[1][i]
    doctored["A1-session-order"] = bad
    bad = [list(h) for h in hist]  # A2: a duplicate delivery
    bad[0].append(bad[0][0])
    doctored["A2-exactly-once"] = bad
    bad = [list(h) for h in hist]  # A3: an own block seen late
    own = next(k for k, (_r, s) in enumerate(bad[0]) if g.owner(s) == 0)
    r, s = bad[0][own]
    bad[0][own] = (r + 5, s)
    doctored["A3-read-your-writes"] = bad
    bad = [list(h) for h in hist]  # A4 and A5: a block never delivered
    bad[1] = [e for e in bad[1] if e[1] != 3]
    doctored["A4-eventual-visibility"] = doctored[
        "A5-arbitration-prefix"] = bad
    for axiom, h in doctored.items():
        got = _axiom_violations(7, g, h, plog)
        assert axiom in {v["axiom"] for v in got}
        assert got == jax_axioms(7, g, h, plog)


def test_checker_reports_byte_divergence(tmp_path):
    """``check_convergence`` fails when a replica's row is damaged after
    the drain."""
    d = _fleet_of("port", tmp_path, 4, 2)
    d["sched"].run()
    pool, table = d["pool"], d["table"]
    rid = next(rid for g in table for rid in g.replica_ids
               if pool.docs[rid].cls is not None)
    rec = pool.docs[rid]
    doc, length, nvis = pool.pull_bucket(rec.cls)
    doc[rec.row, 0] ^= 1
    nvis[rec.row] += 1 if (doc[rec.row, 0] & 1) else -1
    pool.upload_bucket(rec.cls, doc, length, nvis)
    rep = pr.check_convergence(pool, table, d["sessions"], d["streams"])
    assert not rep.converged
    assert any(m["replica"] == rid for m in rep.byte_mismatches)
    pool.close()


# ---- crash recovery, both ways ---------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journaled_broadcasts_recover_to_convergence(tmp_path, writer):
    """A replicated drain crashed after 4 macro-rounds (barriers every 2):
    the WAL with its ``bcast`` records is written by ``writer`` and
    recovered by both packages, which rebuild the same bus and resume to
    the same converged fleet."""
    crashed = _fleet_of(writer, tmp_path / "w", 5, 2, seed=9,
                        arrival_span=1, slots=(6, 3), macro_k=2,
                        journal={}, snapshot_every=2)
    crashed["sched"].run(max_rounds=4)
    assert not crashed["sched"].done
    crashed["sched"].journal.close()
    crashed["pool"].close()
    jd = crashed["jd"]
    assert b'"bcast"' in b"".join(_files(jd).values())
    out = {}
    for side in ("jax", "port"):
        fmod, jmod, rmod, build, Pool, prep = _side_mods(side)
        sessions = build(5, mix=TINY_MIX, seed=9, arrival_span=1,
                         bands=TINY_BANDS)
        reps, table = rmod.build_writer_groups(sessions, 2)
        pkw = dict(device="cpu") if side == "port" else {}
        pool = Pool(classes=(128, 512), slots=(6, 3),
                    spool_dir=str(tmp_path / f"r_{side}"), **pkw)
        streams = prep(reps, pool, batch=16)
        sched, rep, replayed = rmod.recover_replicated_fleet(
            pool, streams, table, jd, turn_ops=8, batch=16, macro_k=2)
        assert rep.snapshot_round >= 0 and replayed > 0
        assert all(st.delivered >= st.cursor for st in streams.values())
        cursors = {r: (st.cursor, st.delivered) for r, st in streams.items()}
        stats = sched.run()
        assert sched.done
        out[side] = dict(sessions=sessions, table=table, pool=pool,
                         streams=streams, sched=sched, stats=stats,
                         plan=None, jd=None, replayed=replayed,
                         cursors=cursors, report=rep)
    assert out["port"]["replayed"] == out["jax"]["replayed"]
    assert out["port"]["cursors"] == out["jax"]["cursors"]
    for f in ("snapshot_round", "resume_round", "docs_restored",
              "spools_restored", "ops_replayed", "torn_records"):
        assert getattr(out["port"]["report"], f) == getattr(
            out["jax"]["report"], f), f
    rep = _same(out)
    assert rep.ra_groups_checked > 0
    _close(out)


# ---- the bench family ------------------------------------------------------


def test_plain_bench_rejects_replication_fault_kinds():
    from crdt_benches_tpu_torch.serve.bench import run_serve_bench
    from crdt_benches_tpu_torch.serve.replicate.bench import (
        run_serve_repl_bench,
    )

    with pytest.raises(ValueError, match="replica_partition"):
        run_serve_bench(mix=TINY_MIX, n_docs=2, bands=TINY_BANDS,
                        classes=(128,), slots=(4,), device="cpu",
                        faults="replica_partition=1", log=lambda *_: None)
    with pytest.raises(ValueError, match="queue_overflow"):
        run_serve_repl_bench(mix=TINY_MIX, n_docs=2, writers=2,
                             bands=TINY_BANDS, classes=(128,), slots=(4,),
                             device="cpu", faults="queue_overflow=1",
                             log=lambda *_: None)


def test_repl_bench_family_equals_jax(tmp_path):
    """``run_serve_repl_bench`` end to end under the JAX smoke's chaos
    plan on a journaled fleet: the gates hold, and the ``replication`` and
    ``convergence`` blocks, the fault events, the journal's records and
    bytes and the counters equal JAX's artifact."""
    from crdt_benches_tpu.serve.replicate.bench import (
        run_serve_repl_bench as jax_bench,
    )
    from crdt_benches_tpu_torch.serve.replicate.bench import (
        run_serve_repl_bench,
    )

    kw = dict(mix=TINY_MIX, n_docs=6, writers=2, batch=16, macro_k=4,
              batch_chars=64, classes=(128, 512), slots=(8, 4),
              bands=TINY_BANDS, arrival_span=2, turn_ops=8, seed=0,
              journal_dir="auto", snapshot_every=4,
              faults="seed=7,span=4,replica_partition=1,merge_reorder=1",
              log=lambda *_: None)
    rep = run_serve_repl_bench(device="cpu", **kw)
    r, info = jax_bench(results_dir=str(tmp_path), save_name="repl", **kw)
    assert rep["verify_ok"] and rep["ra_ok"] and rep["faults_ok"]
    assert info["verify_ok"] and info["ra_ok"] and info["faults_ok"]
    x = r.extra
    for key in ("replication", "convergence", "faults", "journal",
                "rounds", "range_ops", "unit_ops", "evictions",
                "restores", "promotions", "replica_rows"):
        assert rep[key] == x[key], key
    rb = rep["replication"]
    assert rb["writers"] == 2 and rb["groups"] == 6
    assert rb["merged_ops"] > 0 and rb["broadcast_bytes"] > 0
    assert rb["convergence_rounds_max"] >= rb["convergence_rounds_mean"]
    assert rep["convergence"]["replicas_checked"] == 12
    names = set(rep["metrics"]["counters"])
    assert any(n.startswith("serve.replica.merged_ops{") for n in names)
    assert {k: v for k, v in rep["metrics"]["counters"].items()
            if k.startswith("serve.replica.")} == {
        k: v for k, v in x["metrics"]["counters"].items()
        if k.startswith("serve.replica.")}
