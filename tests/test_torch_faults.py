"""The port's fault injection and in-run repair (``serve/faults.py``, the
scheduler's repair paths, the bench's chaos gate) against the JAX
package's, mirroring ``tests/test_serve_faults.py``, the chaos tests of
``tests/test_durability.py`` and ``tests/test_serve_tiers.py``.

Tolerance: exact.  Each test drains one seeded fleet under one seeded fault
plan through both packages (the port on the CPU, with its plain versions;
JAX on the CPU) and holds the port to JAX's event dicts (details
included: which doc a fault hit, which bytes it flipped), every fault and
drain counter, the pool's evictions, restores and promotions, every
bucket array and row map, every stream's cursor, limit, delivery point and
lossy mark, the WAL bytes where a journal is armed and every document's
decode; then the JAX test's own assertions run on the port, and every doc
that is not lossy equals the oracle.  A quarantine's reason names the
damaged spool's path, which differs by the spool directory only.  Both
sides run with ``prefetch=False``."""

import json
import os

import numpy as np
import pytest

from crdt_benches_tpu.serve import faults as jf
from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import Session as JaxSession
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu.traces.synth import synth_trace as jax_synth_trace
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import faults as pf
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve import scheduler as psched
from crdt_benches_tpu_torch.serve.bench import run_serve_bench
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import Session, build_fleet
from crdt_benches_tpu_torch.traces.synth import synth_trace

TINY_BANDS = {"synth-small": ("synth", (40, 120))}
TINY_MIX = {"synth-small": 1.0}
#: tests/test_durability.py's fleet
DUR_BANDS = {"synth-small": ("synth", (10, 60)),
             "synth-medium": ("synth", (150, 360))}
DUR_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
DUR = dict(fleet=dict(n_docs=10, mix=DUR_MIX, seed=7, arrival_span=3,
                      bands=DUR_BANDS),
           classes=(256, 1024), slots=(6, 3), batch=16, batch_chars=64)
#: every ServeStats field a drain shares with JAX's
STATS = ("rounds", "slices", "ops", "unit_ops", "staged_cells", "patches",
         "evictions", "restores", "promotions", "admissions", "shed_ops",
         "deferred_ops", "overflow_events", "backpressure_rounds",
         "dup_ops_dropped", "stall_rounds", "recoveries", "ops_replayed",
         "replay_dispatches", "mttr_rounds", "degraded_rounds",
         "faults_seen", "faults_injected", "snapshots", "snapshots_full",
         "snapshots_delta")
POOL = ("evictions", "restores", "promotions", "fresh_admits", "warm_hits",
        "warm_evictions", "cold_docs")
STREAM = ("cursor", "limit", "lossy", "delivered", "deferred_high", "burst")


def _plan(mod, events, seed):
    """One package's FaultPlan of ``(kind, round[, param[, target]])``."""
    return mod.FaultPlan([mod.FaultEvent(*e) for e in events], seed=seed)


def drain_pair(tmp_path, events=(), plan_seed=0, *, spec=None, fleet=None,
               sessions=None, classes=(128,), slots=(2,), warm_docs=0,
               batch=8, batch_chars=32, macro_k=4, journal=None,
               max_rounds=None, **kw):
    """The same fleet and fault plan drained through both packages.
    ``fleet`` is ``build_fleet``'s keywords (``_fleet``'s of
    tests/test_serve_faults.py by default), ``sessions(side)`` overrides
    it; ``journal`` is ``OpJournal``'s keywords (a journal each side);
    ``kw`` goes to both schedulers."""
    fleet = fleet or dict(n_docs=5, mix=TINY_MIX, seed=11, arrival_span=2,
                          bands=TINY_BANDS)
    out = {}
    for side, fmod, jmod, build, Pool, prep, Sched in (
            ("jax", jf, jj, jax_build_fleet, JaxPool, jax_prepare,
             JaxScheduler),
            ("port", pf, pj, build_fleet, DocPool, prepare_streams,
             FleetScheduler)):
        sess = sessions(side) if sessions else build(**fleet)
        pkw = dict(device="cpu") if side == "port" else {}
        pool = Pool(classes=classes, slots=slots, warm_docs=warm_docs,
                    prefetch=False, spool_dir=str(tmp_path / f"{side}_sp"),
                    **pkw)
        streams = prep(sess, pool, batch=batch, batch_chars=batch_chars)
        plan = (fmod.FaultPlan.from_spec(spec) if spec is not None
                else _plan(fmod, events, plan_seed))
        jd = str(tmp_path / f"{side}_j")
        sched = Sched(pool, streams, batch=batch, macro_k=macro_k,
                      batch_chars=batch_chars,
                      faults=fmod.FaultInjector(plan) if plan.events else None,
                      journal=(jmod.OpJournal(jd, **journal)
                               if journal is not None else None), **kw)
        stats = sched.run(max_rounds=max_rounds)
        out[side] = dict(sessions=sess, pool=pool, streams=streams,
                         plan=plan, sched=sched, stats=stats, jd=jd)
    return out


def _unpath(obj, pool):
    """``obj`` with the pool's spool directory replaced by a marker."""
    return json.loads(json.dumps(obj).replace(pool.spool_dir, "<spool>"))


def _files(jd):
    return {f: open(os.path.join(jd, f), "rb").read()
            for f in sorted(os.listdir(jd))
            if os.path.isfile(os.path.join(jd, f))}


def assert_same(d, wal=True):
    """The port's drain equals JAX's in every observable (module
    docstring), and every non-lossy doc equals the oracle."""
    j, p = d["jax"], d["port"]
    assert (_unpath(p["plan"].summary(), p["pool"])
            == _unpath(j["plan"].summary(), j["pool"]))
    for f in STATS:
        assert getattr(p["stats"], f) == getattr(j["stats"], f), f
    assert (_unpath(p["stats"].quarantines, p["pool"])
            == _unpath(j["stats"].quarantines, j["pool"]))
    for f in POOL:
        assert getattr(p["pool"], f) == getattr(j["pool"], f), f
    assert p["sched"].prefetch_missed == j["sched"].prefetch_missed
    assert p["sched"].effective_k == j["sched"].effective_k
    for cls in j["pool"].classes:
        assert p["pool"].buckets[cls].rows == j["pool"].buckets[cls].rows
        for a, b in zip(p["pool"].pull_bucket(cls),
                        j["pool"].pull_bucket(cls)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), cls
    assert sorted(p["pool"].warm.entries) == sorted(j["pool"].warm.entries)
    for doc, st in j["streams"].items():
        for f in STREAM:
            assert getattr(p["streams"][doc], f) == getattr(st, f), (doc, f)
    if wal and os.path.isdir(j["jd"]):
        assert _files(p["jd"]) == _files(j["jd"])
    for s in p["sessions"]:
        if p["streams"][s.doc_id].lossy and (s.doc_id in {
                q["doc"] for q in p["stats"].quarantines}):
            # a quarantined doc holds no state in either package
            for pool in (p["pool"], j["pool"]):
                with pytest.raises(ValueError, match="never admitted"):
                    pool.decode(s.doc_id)
            continue
        got = p["pool"].decode(s.doc_id)
        assert got == j["pool"].decode(s.doc_id), s.doc_id
        if not p["streams"][s.doc_id].lossy:
            assert got == replay_trace(s.trace), s.doc_id


def close(d):
    for side in d.values():
        side["pool"].close()
        if side["sched"].journal is not None:
            side["sched"].journal.close()


# ---- tests/test_serve_faults.py ----


@pytest.mark.parametrize("kind", ["spool_corrupt", "spool_truncate"])
def test_spool_damage_healed_by_rebuild(tmp_path, kind):
    d = drain_pair(tmp_path, [(kind, 2)], 3)
    assert_same(d)
    p = d["port"]
    assert p["sched"].done
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered
    assert p["stats"].recoveries >= 1 and p["stats"].ops_replayed > 0
    assert p["stats"].mttr_rounds and not p["stats"].quarantines
    assert ev.detail["mode"] == ("truncate" if kind == "spool_truncate"
                                 else "bitflip")
    close(d)


def test_spool_heal_uses_snapshot_base(tmp_path):
    d = drain_pair(tmp_path, [("spool_corrupt", 4)], 3, journal={},
                   snapshot_every=1)
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered and p["stats"].recoveries >= 1
    victim = ev.detail["doc"]
    assert p["stats"].ops_replayed < p["streams"][victim].cursor or (
        p["stats"].ops_replayed <= p["streams"][victim].n_total)
    close(d)


def test_device_loss_mid_macro_round_recovers(tmp_path):
    d = drain_pair(tmp_path, [("device_loss", 3)], 5)
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered and ev.detail["docs"] >= 1
    assert p["stats"].recoveries >= 1 and p["stats"].mttr_rounds
    close(d)


def test_duplicated_batch_clamped_not_reapplied(tmp_path):
    d = drain_pair(tmp_path, [("dup_batch", 2), ("dup_batch", 3)], 1)
    assert_same(d)
    p = d["port"]
    assert all(e.fired and e.recovered for e in p["plan"].events)
    assert p["stats"].dup_ops_dropped > 0
    close(d)


def test_poisoned_rebuild_quarantines_and_fleet_survives(tmp_path):
    d = drain_pair(tmp_path, [("spool_corrupt", 2), ("poison_rebuild", 0)],
                   3)
    assert_same(d)
    p = d["port"]
    assert len(p["stats"].quarantines) == 1
    q = p["stats"].quarantines[0]
    assert p["streams"][q["doc"]].lossy
    assert p["stats"].shed_ops >= q["shed_ops"] >= 0
    assert p["pool"].docs[q["doc"]].cls is None
    assert "rebuild poisoned by fault plan" in q["reason"]
    close(d)


def _long_sessions(side):
    synth, S = ((jax_synth_trace, JaxSession) if side == "jax"
                else (synth_trace, Session))
    return [S(doc_id=i, band="synth-small", source="synth",
              trace=synth(seed=300 + i, n_ops=600)) for i in range(3)]


def test_repeated_faults_degrade_to_k1_then_restore(tmp_path):
    d = drain_pair(tmp_path, [("stall", 2, 1), ("stall", 3, 1),
                              ("stall", 4, 1)], 0, sessions=_long_sessions,
                   classes=(1024,), slots=(3,), degrade_after=2,
                   degrade_window=8, degrade_rounds=3, journal={})
    assert_same(d)  # the WAL holds the degrade event and the K = 1 rounds
    p = d["port"]
    assert p["stats"].stall_rounds == 3
    assert p["stats"].degraded_rounds >= 3
    assert p["sched"].effective_k == 4
    assert b'"degrade"' in b"".join(_files(p["jd"]).values())
    close(d)


def test_fault_spec_grammar_equals_jax():
    spec = ("seed=7,span=6,stall_ms=5,burst=32,"
            "spool_corrupt=2,device_loss@4=1,queue_overflow=1")
    plan, jplan = pf.FaultPlan.from_spec(spec), jf.FaultPlan.from_spec(spec)
    assert [e.to_dict() for e in plan.events] == [
        e.to_dict() for e in jplan.events]
    assert sorted(e.kind for e in plan.events) == [
        "device_loss", "queue_overflow", "spool_corrupt", "spool_corrupt"]
    assert next(e for e in plan.events if e.kind == "device_loss").round == 4
    assert all(2 <= e.round <= 6 for e in plan.events)
    assert (plan.stall_ms, plan.burst, plan.seed) == (5, 32, 7)
    assert plan.summary() == jplan.summary()
    assert pf.KINDS == jf.KINDS
    for name in ("JOURNAL_KINDS", "REPLICATION_KINDS", "TIER_KINDS",
                 "INGEST_KINDS", "RESHARD_KINDS"):
        assert getattr(pf, name) == getattr(jf, name), name
    with pytest.raises(ValueError, match="unknown kind"):
        pf.FaultPlan.from_spec("meteor_strike=1")
    with pytest.raises(ValueError, match="expected k=v"):
        pf.FaultPlan.from_spec("spool_corrupt")


@pytest.mark.parametrize("kind,size", [
    ("spool_corrupt", 4306), ("spool_truncate", 3110),
    ("delta_corrupt", 40), ("spool_corrupt", 63)])
def test_corrupt_file_damages_the_bytes_jax_damages(tmp_path, kind, size):
    """Same spec, same file: the same detail and the same damaged bytes,
    written through a new file swapped in (a hard link to the old inode
    keeps the old bytes)."""
    data = np.random.default_rng(size).integers(
        0, 256, size, np.uint8).tobytes()
    out = []
    for mod, side in ((jf, "j"), (pf, "p")):
        path = str(tmp_path / f"{side}.npz")
        open(path, "wb").write(data)
        os.link(path, path + ".link")
        inj = mod.FaultInjector(mod.FaultPlan.from_spec(
            f"seed=7,span=8,{kind}=1"))
        inj.pick([3, 5, 8])  # the picks draw from the same stream
        out.append((inj.corrupt_file(path, kind), open(path, "rb").read(),
                    inj.pick(list(range(100)))))
        assert open(path + ".link", "rb").read() == data
    assert out[0] == out[1]
    assert out[1][1] != data


def test_bench_chaos_artifact_and_gates(tmp_path):
    """The port's chaos bench: ``verify_ok`` and ``faults_ok`` with the
    robustness surface in the report, and the same events, counters and
    verify sample as JAX's artifact of the same run."""
    from crdt_benches_tpu.serve.bench import run_serve_bench as jax_bench

    common = dict(mix=TINY_MIX, n_docs=8, batch=8, classes=(128, 512),
                  slots=(3, 2), seed=3, arrival_span=2, verify_sample=4,
                  bands=TINY_BANDS, macro_k=4, batch_chars=32,
                  snapshot_every=2,
                  faults="seed=5,span=4,spool_corrupt=1,device_loss=1,"
                         "queue_overflow=1,dup_batch=1,stall=1,stall_ms=1",
                  log=lambda *_: None)
    ex = run_serve_bench(**common, journal_dir=str(tmp_path / "pj"),
                         device="cpu")
    _, info = jax_bench(**common, journal_dir=str(tmp_path / "jj"),
                        spool_dir=str(tmp_path / "jspool"),
                        results_dir=str(tmp_path / "results"))
    assert ex["verify_ok"] and ex["faults_ok"]
    assert info["verify_ok"] and info["faults_ok"]
    f = ex["faults"]
    assert f["injected"] == 5 and f["unrecovered"] == 0
    assert f["not_fired"] == 0
    assert {e["kind"] for e in f["events"] if e["fired"]} == {
        "spool_corrupt", "device_loss", "queue_overflow", "dup_batch",
        "stall"}
    assert ex["queue_cap"] == 64  # defaulted to 8 * batch
    assert ex["mttr_rounds"]["n"] >= 1
    assert ex["recoveries"] >= 1 and ex["ops_replayed"] > 0
    assert ex["journal"]["records"] > 0 and ex["journal"]["snapshots"] >= 1
    assert ex["shed_ops"] == 0 and ex["lossy_docs"] == []
    assert ex["fault_counts"]["fired"]["device_loss"] == 1
    assert sum(ex["fault_counts"]["recovered"].values()) == 5
    with open(info["path"]) as fh:
        (jd,) = json.load(fh)
    jex = jd["extra"]
    assert f == jex["faults"]
    for k in ("queue_cap", "overflow_policy", "shed_ops", "deferred_ops",
              "overflow_events", "backpressure_rounds", "dup_ops_dropped",
              "stall_rounds", "quarantines", "recoveries", "ops_replayed",
              "replay_dispatches", "mttr_rounds", "degraded_rounds",
              "lossy_docs", "rounds", "range_ops", "evictions", "restores",
              "promotions"):
        assert ex[k] == jex[k], k
    assert ex["verified_docs"] == len(jex["verified_docs"])


def test_device_loss_under_tiered_pool_rebuilds_all_tiers(tmp_path):
    """JAX's tiered device-loss test on an eager fleet of the same spec
    (its lazy fleet is the next test's): the warm tier is host memory the
    loss cannot touch, and every lost hot row rebuilds at its cursor."""
    d = drain_pair(tmp_path, [("device_loss", 3)], 5,
                   fleet=dict(n_docs=8, mix=TINY_MIX, seed=9,
                              arrival_span=3, bands=TINY_BANDS),
                   warm_docs=4)
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered and ev.detail["docs"] >= 1
    assert p["stats"].recoveries >= 1
    ts = p["pool"].tier_status()
    assert ts["warm_evictions"] + ts["warm_hits"] + len(p["pool"].warm) > 0
    close(d)


def test_device_loss_under_tiered_lazy_fleet_rebuilds_all_tiers(tmp_path):
    """JAX's tiered device-loss test as it runs, on a lazy fleet
    (``LazyStreams``): a doc still in genesis has no device state to lose,
    every lost hot row rebuilds at its cursor, and the drain equals JAX's
    in its event, counters, records, buckets and bytes."""
    from crdt_benches_tpu.serve.scheduler import LazyStreams as JaxLazy
    from crdt_benches_tpu.serve.workload import FleetSpec as JaxSpec
    from crdt_benches_tpu_torch.serve.scheduler import LazyStreams
    from crdt_benches_tpu_torch.serve.workload import FleetSpec

    out = {}
    for side, fmod, Spec, Pool, Lazy, Sched in (
            ("jax", jf, JaxSpec, JaxPool, JaxLazy, JaxScheduler),
            ("port", pf, FleetSpec, DocPool, LazyStreams, FleetScheduler)):
        spec = Spec.build(8, mix=TINY_MIX, seed=9, arrival_span=3,
                          bands=TINY_BANDS)
        pkw = dict(device="cpu") if side == "port" else {}
        pool = Pool(classes=(128,), slots=(2,), warm_docs=4, prefetch=False,
                    spool_dir=str(tmp_path / f"{side}_sp"), **pkw)
        streams = Lazy(spec, pool, batch=8, batch_chars=32)
        plan = _plan(fmod, [("device_loss", 3)], 5)
        sched = Sched(pool, streams, batch=8, macro_k=4, batch_chars=32,
                      faults=fmod.FaultInjector(plan))
        assert pool.genesis_docs == 8  # a lazy fleet is born all genesis
        stats = sched.run()
        out[side] = dict(spec=spec, pool=pool, streams=streams, sched=sched,
                         stats=stats, plan=plan)
    j, p = out["jax"], out["port"]
    assert p["plan"].summary() == j["plan"].summary()
    for f in STATS:
        assert getattr(p["stats"], f) == getattr(j["stats"], f), f
    for f in POOL + ("genesis_docs",):
        assert getattr(p["pool"], f) == getattr(j["pool"], f), f
    for f in ("materialized", "released", "prefetch_built"):
        assert getattr(p["streams"], f) == getattr(j["streams"], f), f
    assert p["pool"].buckets[128].rows == j["pool"].buckets[128].rows
    for a, b in zip(p["pool"].pull_bucket(128), j["pool"].pull_bucket(128)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    sched, pool = p["sched"], p["pool"]
    assert sched.done and p["streams"].all_done
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered and ev.detail["docs"] >= 1
    assert sched.stats.recoveries >= 1
    ts = pool.tier_status()
    assert ts["genesis_docs"] == 0  # every doc materialized after the loss
    assert ts["warm_evictions"] + ts["warm_hits"] + len(pool.warm) > 0
    for d in range(8):
        got = pool.decode(d)
        assert got == j["pool"].decode(d), d
        assert got == replay_trace(p["spec"].session(d).trace), d
    for side in out.values():
        side["pool"].close()


class _Launches:
    """Count ``rebuild_doc`` calls made by the scheduler, with the device
    each ran on."""

    def __init__(self, monkeypatch):
        self.devices = []
        real = pj.rebuild_doc

        def counted(*a, **kw):
            self.devices.append(kw["device"])
            return real(*a, **kw)

        monkeypatch.setattr(psched, "rebuild_doc", counted)


@pytest.mark.parametrize("kind", ["device_loss", "spool_corrupt"])
def test_repairs_rebuild_through_rebuild_doc_on_the_pools_device(
        tmp_path, monkeypatch, kind):
    """A device loss rebuilds every resident of the class and a heal its
    doc, each through ``journal.rebuild_doc`` on the pool's device (K1's
    per-row form and K4 on a CUDA pool)."""
    calls = _Launches(monkeypatch)
    d = drain_pair(tmp_path, [(kind, 3 if kind == "device_loss" else 2)],
                   5 if kind == "device_loss" else 3)
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    n = ev.detail["docs"] if kind == "device_loss" else 1
    assert len(calls.devices) == n >= 1
    assert all(dev == p["pool"].device for dev in calls.devices)
    close(d)


# ---- tests/test_durability.py's chaos tests ----


def test_crash_compact_fires_and_recovers(tmp_path):
    d = drain_pair(tmp_path, [("crash_compact", 2)], 3,
                   fleet=DUR["fleet"], classes=DUR["classes"],
                   slots=DUR["slots"], batch=16, batch_chars=64,
                   journal=dict(segment_bytes=200), snapshot_every=1,
                   snapshot_full_every=2)
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.recovered, ev.to_dict()
    assert ev.detail["stage"] == "post_manifest_pre_unlink"
    assert not os.path.exists(os.path.join(p["jd"], pj.GC_MANIFEST))
    close(d)


def test_delta_corrupt_fires_and_recovery_falls_back(tmp_path):
    d = drain_pair(tmp_path, [("delta_corrupt", 3)], 5,
                   fleet=DUR["fleet"], classes=DUR["classes"],
                   slots=DUR["slots"], batch=16, batch_chars=64,
                   journal=dict(segment_bytes=400), snapshot_every=1,
                   snapshot_full_every=4)
    assert_same(d)
    p = d["port"]
    (ev,) = p["plan"].events
    assert ev.fired and ev.detail.get("member") and ev.recovered
    used, _ = pj.probe_recovery(p["jd"])
    assert used is not None
    assert (used, _) == jj.probe_recovery(d["jax"]["jd"])
    want = {s.doc_id: replay_trace(s.trace) for s in p["sessions"]}
    pool_b = DocPool(classes=DUR["classes"], slots=DUR["slots"],
                     device="cpu", spool_dir=str(tmp_path / "sb"))
    streams_b = prepare_streams(p["sessions"], pool_b, batch=16,
                                batch_chars=64)
    rep = pj.recover_fleet(pool_b, streams_b, p["jd"])
    FleetScheduler(pool_b, streams_b, batch=16, macro_k=4, batch_chars=64,
                   start_round=rep.resume_round).run()
    for s in p["sessions"]:
        assert pool_b.decode(s.doc_id) == want[s.doc_id]
    pool_b.close()
    close(d)


def test_journal_kinds_rejected_without_preconditions(tmp_path):
    common = dict(mix=DUR_MIX, n_docs=4, bands=DUR_BANDS, device="cpu",
                  log=lambda *_: None)
    with pytest.raises(ValueError, match="serve-journal"):
        run_serve_bench(faults="crash_compact=1", **common)
    with pytest.raises(ValueError, match="snapshot-every"):
        run_serve_bench(faults="crash_compact=1",
                        journal_dir=str(tmp_path / "j1"), snapshot_every=0,
                        **common)
    with pytest.raises(ValueError, match="full-every"):
        run_serve_bench(faults="delta_corrupt=1",
                        journal_dir=str(tmp_path / "j2"), snapshot_every=2,
                        snapshot_full_every=1, **common)
    with pytest.raises(ValueError, match="wal-segment-bytes"):
        run_serve_bench(faults="crash_compact=1",
                        journal_dir=str(tmp_path / "j3"), snapshot_every=2,
                        wal_segment_bytes=0, **common)
    with pytest.raises(ValueError, match="recovery leg"):
        run_serve_bench(longhaul=2, **common)
    assert not any(os.path.exists(tmp_path / j) for j in ("j1", "j2", "j3"))


# ---- tests/test_serve_tiers.py's chaos tests ----


def test_tier_chaos_kinds_fire_and_recover(tmp_path):
    """JAX's test with the prefetcher on (``prefetch_miss`` polls the
    prefetch plan), held to its timing-free facts and the oracle; the
    exact parity of ``tier_evict_pressure`` is the next test."""
    sessions = build_fleet(10, mix=TINY_MIX, seed=5, arrival_span=2,
                           bands=TINY_BANDS)
    pool = DocPool(classes=(128,), slots=(3,), device="cpu", warm_docs=3,
                   spool_dir=str(tmp_path / "spool"))
    streams = prepare_streams(sessions, pool, batch=8, batch_chars=32)
    plan = _plan(pf, [("tier_evict_pressure", 2), ("prefetch_miss", 2)], 3)
    sched = FleetScheduler(pool, streams, batch=8, macro_k=4, batch_chars=32,
                           faults=pf.FaultInjector(plan))
    sched.run()
    assert sched.done
    by_kind = {e.kind: e for e in plan.events}
    ev_p = by_kind["tier_evict_pressure"]
    assert ev_p.fired and ev_p.recovered and ev_p.detail["demoted"] >= 1
    ev_m = by_kind["prefetch_miss"]
    assert ev_m.fired and ev_m.recovered and ev_m.detail["dropped"] >= 1
    assert sched.prefetch_missed >= 1
    assert pool.warm_evictions >= ev_p.detail["demoted"]
    for s in sessions:
        assert pool.decode(s.doc_id) == replay_trace(s.trace)
    pool.close()


def test_tier_evict_pressure_equals_jax(tmp_path):
    d = drain_pair(tmp_path, [("tier_evict_pressure", 2)], 3,
                   fleet=dict(n_docs=10, mix=TINY_MIX, seed=5,
                              arrival_span=2, bands=TINY_BANDS),
                   slots=(3,), warm_docs=3)
    assert_same(d)
    ev = d["port"]["plan"].events[0]
    assert ev.fired and ev.recovered and ev.detail["demoted"] >= 1
    close(d)


def test_tier_fault_kinds_require_tiers(tmp_path):
    for kind in ("tier_evict_pressure", "prefetch_miss"):
        with pytest.raises(ValueError, match="serve-tiers"):
            run_serve_bench(mix=TINY_MIX, n_docs=4, bands=TINY_BANDS,
                            classes=(128,), slots=(4,), faults=f"{kind}=1",
                            device="cpu", log=lambda *_: None)


@pytest.mark.parametrize("kind", ["replica_partition", "merge_reorder",
                                  "conn_churn", "tenant_flood",
                                  "reshard_crash"])
def test_unported_kinds_are_refused_up_front(kind):
    """A plain drain refuses the kinds it never polls: the replication
    kinds need a replicated fleet, the reshard kind a reshard, and the
    ingest kinds the open-loop ingest front."""
    msg = {"replica_partition": "replicated fleet",
           "merge_reorder": "replicated fleet",
           "reshard_crash": "--serve-reshard is required"}.get(
        kind, "--serve-open is required")
    with pytest.raises(ValueError, match=msg):
        run_serve_bench(mix=TINY_MIX, n_docs=4, bands=TINY_BANDS,
                        classes=(128,), slots=(4,), faults=f"{kind}=1",
                        device="cpu", log=lambda *_: None)


def test_bench_entry_exits_nonzero_on_an_unfired_fault(tmp_path):
    """A plan whose event never fires (a round the drain never reaches) fails
    the chaos gate: ``faults_ok`` false, exit 1."""
    from crdt_benches_tpu_torch.bench.__main__ import main

    rc = main(["--group", "serve", "--device", "cpu", "--serve-docs", "4",
               "--serve-batch", "16", "--serve-macro", "4",
               "--serve-batch-chars", "64", "--serve-slots", "4,2,2,2,2",
               "--serve-arrival-span", "1",
               "--serve-faults", "stall@1000000=1"])
    assert rc == 1


def test_interrupted_drain_leaves_faults_to_the_recovery_leg():
    """The JAX bench smoke's longhaul crash recipe
    (``tools/bench_smoke.sh``, ``crash_compact@2=1,delta_corrupt@2=1``,
    crash round 4): the crash skips the in-run sweep, the GC pass is torn,
    the newest delta damaged, and the recovery leg falls back down the
    chain and closes both events once the recovered fleet verifies."""
    ex = run_serve_bench(mix="mixed", n_docs=16, batch=16, macro_k=4,
                         batch_chars=64, slots=(16, 6, 2, 2, 2),
                         arrival_span=2, verify_sample=6, journal_dir="auto",
                         snapshot_every=2, snapshot_full_every=2,
                         wal_segment_bytes=256, longhaul=4, crash_after=4,
                         faults="seed=3,crash_compact@2=1,delta_corrupt@2=1",
                         device="cpu", log=lambda *_: None)
    assert ex["crashed"] and ex["verify_ok"] and ex["faults_ok"]
    ev = {e["kind"]: e for e in ex["faults"]["events"]}
    assert ev["crash_compact"]["detail"]["stage"] == \
        "post_manifest_pre_unlink"
    assert ev["delta_corrupt"]["detail"]["via"] == "recovery_leg"
    assert ex["recovery"]["chain_fallbacks"] >= 1
    assert ex["recovery"]["verified_docs"] == 6


def test_readme_chaos_cell_equals_jax(tmp_path):
    """The README's chaos run, the cell ``chip_smoke.py [serve chaos]``
    drains on the card (serve/mixed/512 at slots (256, 64, 16, 8, 4), B =
    64, K = 8, a barrier every 4 rounds, queue cap 512, the seeded spec),
    through both packages on the CPU: the same seven events with the same
    picks and damaged bytes, counters, buckets, streams and WAL."""
    d = drain_pair(
        tmp_path, spec="seed=7,span=8,spool_corrupt=1,spool_truncate=1,"
                       "device_loss=1,queue_overflow=1,dup_batch=2,stall=1",
        fleet=dict(n_docs=512, mix="mixed", seed=0, arrival_span=8),
        classes=(256, 1024, 4096, 8192, 49152), slots=(256, 64, 16, 8, 4),
        batch=64, batch_chars=256, macro_k=8, journal={}, snapshot_every=4,
        snapshot_full_every=4, queue_cap=512)
    assert_same(d)
    p = d["port"]
    assert p["plan"].summary()["injected"] == 7
    assert all(e.recovered for e in p["plan"].events)
    assert not p["stats"].quarantines and p["stats"].degraded_rounds == 4
    close(d)


def test_device_loss_after_a_release_equals_jax(tmp_path):
    """A device loss on a lazy, journal-less fleet after some resident docs
    drained: their streams were released (cursor 0, no ops), so the
    rebuild puts back their initial text.  The JAX package does the same
    (``ROADMAP.md`` Queue 3 records it as a reference fault); the port
    equals it byte for byte, and the other docs equal the oracle."""
    from crdt_benches_tpu.serve.scheduler import LazyStreams as JaxLazy
    from crdt_benches_tpu.serve.workload import FleetSpec as JaxSpec
    from crdt_benches_tpu_torch.serve.scheduler import LazyStreams
    from crdt_benches_tpu_torch.serve.workload import FleetSpec

    out = {}
    for side, fmod, Spec, Pool, Lazy, Sched in (
            ("jax", jf, JaxSpec, JaxPool, JaxLazy, JaxScheduler),
            ("port", pf, FleetSpec, DocPool, LazyStreams, FleetScheduler)):
        spec = Spec.build(8, mix=TINY_MIX, seed=9, arrival_span=12,
                          bands=TINY_BANDS)
        pkw = dict(device="cpu") if side == "port" else {}
        pool = Pool(classes=(128,), slots=(8,), prefetch=False,
                    spool_dir=str(tmp_path / f"{side}_sp"), **pkw)
        plan = _plan(fmod, [("device_loss", 12)], 5)
        sched = Sched(pool, Lazy(spec, pool, batch=8, batch_chars=32),
                      batch=8, macro_k=4, batch_chars=32,
                      faults=fmod.FaultInjector(plan))
        sched.run()
        out[side] = (spec, pool, plan, sched)
    (spec, pool, plan, sched), (_, jpool, jplan, _) = out["port"], out["jax"]
    assert plan.summary() == jplan.summary()
    assert plan.events[0].detail["docs"] == 8
    lost = []
    for d in range(8):
        got = pool.decode(d)
        assert got == jpool.decode(d), d
        if got != replay_trace(spec.session(d).trace):
            lost.append(d)
            assert got == spec.session(d).trace.start_content, d
    assert lost == [0, 1, 7]  # drained and released before the loss
    assert sched.streams.released == 8
    for p in (pool, jpool):
        p.close()
