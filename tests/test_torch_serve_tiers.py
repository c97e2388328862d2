"""The port's three-tier residency (``serve/pool.py`` warm tier,
``serve/scheduler.py`` tiered drain, ``serve/bench.py`` ``--serve-tiers``)
against the JAX package's.

Exact parity runs with ``prefetch=False`` on both sides: whether an
admission is a warm hit or a cold restore then depends on the plan alone.
A drain with the prefetcher on is held to the facts no thread timing can
move (lanes, row placements, evictions, promotions, admissions, limbo
pulls, warm hits plus restores, every decoded byte).  The fleet is the
serve smoke shape of ``tests/test_torch_serve.py`` (24 docs of the
``mixed`` table, 16/6/2/2/2 rows) with a warm tier of 2 docs, small enough
that the tier overflows to the compressed spool and docs come back from
both."""

import json
import os
import subprocess
import sys
import time
import zipfile

import numpy as np
import pytest
import torch

from crdt_benches_tpu.oracle.text_oracle import replay_trace as jax_replay
from crdt_benches_tpu.serve.bench import parse_tier_spec as jax_parse
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.pool import WarmEntry as JaxWarmEntry
from crdt_benches_tpu.serve.pool import WarmTier as JaxWarmTier
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu.utils import checkpoint as jax_ckpt
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import pool as port_pool
from crdt_benches_tpu_torch.serve.bench import parse_tier_spec
from crdt_benches_tpu_torch.serve.pool import DocPool, WarmEntry, WarmTier
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import build_fleet
from crdt_benches_tpu_torch.utils import checkpoint as port_ckpt
from crdt_benches_tpu_torch.utils.convert import buckets_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET = dict(n_docs=24, mix="mixed", seed=0, arrival_span=2)
SLOTS = (16, 6, 2, 2, 2)
DRAIN = dict(batch=16, batch_chars=64)
MACRO_K = 4
WARM = 2
#: counters a prefetch=False drain shares with JAX's, field by field
STATS = ("rounds", "slices", "ops", "unit_ops", "evictions", "restores",
         "promotions", "admissions")
POOL = ("fresh_admits", "warm_hits", "warm_evictions", "prefetch_hits",
        "cold_docs")
#: the JAX package's limbo regression fleet (tests/test_serve_tiers.py)
LIMBO_FLEET = dict(n_docs=12, mix={"synth-medium": 1.0}, seed=4,
                   arrival_span=2,
                   bands={"synth-medium": ("synth", (300, 600))})
LIMBO_POOL = dict(classes=(128, 512, 1024), slots=(3, 2, 2), warm_docs=4,
                  prefetch=False)
LIMBO_DRAIN = dict(batch=8, batch_chars=32)


def _drain(sessions, spool, prefetch=False, warm_docs=WARM):
    pool = DocPool(slots=SLOTS, device="cpu", spool_dir=spool,
                   warm_docs=warm_docs, prefetch=prefetch)
    sched = FleetScheduler(pool, prepare_streams(sessions, pool, **DRAIN),
                           macro_k=MACRO_K, **DRAIN)
    return pool, sched, sched.run()


def _records(pool):
    return {d: (r.cls, r.row, r.length, r.last_sched)
            for d, r in pool.docs.items()}


def _cold(pool):
    return {d for d, r in pool.docs.items() if r.spool is not None}


@pytest.fixture(scope="module")
def tiered(tmp_path_factory):
    """The smoke fleet drained tiered with prefetch=False by both
    packages, and by the port with the prefetcher on (pools left open for
    decoding; closed at teardown)."""
    sessions = build_fleet(**FLEET)
    jsessions = jax_build_fleet(**FLEET)
    pools = []
    try:
        pool, sched, stats = _drain(
            sessions, str(tmp_path_factory.mktemp("port_spool")))
        pools.append(pool)
        jpool = JaxPool(slots=SLOTS, warm_docs=WARM, prefetch=False,
                        spool_dir=str(tmp_path_factory.mktemp("jax_spool")))
        pools.append(jpool)
        jsched = JaxScheduler(jpool, jax_prepare(jsessions, jpool, **DRAIN),
                              macro_k=MACRO_K, **DRAIN)
        jstats = jsched.run()
        ppool, psched, pstats = _drain(
            sessions, str(tmp_path_factory.mktemp("pf_spool")), prefetch=True)
        pools.append(ppool)
        yield dict(sessions=sessions, jsessions=jsessions, pool=pool,
                   sched=sched, stats=stats, jpool=jpool, jsched=jsched,
                   jstats=jstats, ppool=ppool, psched=psched, pstats=pstats)
    finally:
        for p in pools:
            p.close()


# ---- the tier spec and the warm tier's order ----


@pytest.mark.parametrize("spec", [
    "hot=1024,warm=16384", "hot=256,warm=1024", "hot=256,warm=4096",
    "warm=256", " hot = 40 , warm=3 ,", "hot=10,warm=1", "hot=9,warm=1",
    "hot=1024", "warm=0", "hot=64,warm=-1", "hot=64,cold=3,warm=2",
    "hot64,warm=2", "", "hot=x,warm=2",
])
def test_parse_tier_spec_equals_jax(spec):
    slots = (2048, 512, 128, 32, 16)
    try:
        want = jax_parse(spec, slots)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_tier_spec(spec, slots)
        assert str(got.value) == str(e)
        return
    assert parse_tier_spec(spec, slots) == want


def test_parse_tier_spec_scales_the_default_table():
    assert parse_tier_spec("hot=1024,warm=16384",
                           (2048, 512, 128, 32, 16)) == (
        (767, 192, 48, 12, 6), 16384)
    assert parse_tier_spec("hot=256,warm=1024",
                           (2048, 512, 128, 32, 16))[0] == (192, 48, 12, 3, 2)


def test_warm_tier_lru_order_equals_jax():
    rng = np.random.default_rng(3)
    tier, jtier = WarmTier(8), JaxWarmTier(8)
    row = np.arange(4, dtype=np.int32)
    popped, jpopped = [], []
    for step in range(200):
        d = int(rng.integers(0, 24))
        op = rng.random()
        if op < 0.6:  # deposit (again: the old heap entry goes stale)
            last = int(rng.integers(0, 50))
            tier.put(d, WarmEntry(row, 4, 4, last_sched=last))
            jtier.put(d, JaxWarmEntry(row, 4, 4, last_sched=last))
        elif op < 0.8:
            assert (tier.take(d) is None) == (jtier.take(d) is None)
        else:
            got, want = tier.pop_lru(), jtier.pop_lru()
            popped.append(None if got is None else got[0])
            jpopped.append(None if want is None else want[0])
        assert len(tier) == len(jtier) and tier.over_budget() == (
            jtier.over_budget())
    while (got := tier.pop_lru()) is not None:
        popped.append(got[0])
        jpopped.append(jtier.pop_lru()[0])
    assert jtier.pop_lru() is None
    assert popped == jpopped and len(popped) > 40


# ---- the tiered drain against JAX's (prefetch off on both sides) ----


def test_tiered_drain_counters_equal_jax(tiered):
    stats, jstats = tiered["stats"], tiered["jstats"]
    pool, jpool = tiered["pool"], tiered["jpool"]
    assert tiered["sched"].done and tiered["jsched"].done
    for name in STATS:
        assert getattr(stats, name) == getattr(jstats, name), name
    for name in POOL:
        assert getattr(pool, name) == getattr(jpool, name), name
    assert tiered["sched"].limbo_pulls == tiered["jsched"].limbo_pulls
    # the fleet exercises every tier: warm hits, overflow to cold and
    # restores from it, fresh admissions and promotions
    assert stats.evictions and stats.promotions and stats.restores
    assert pool.warm_hits and pool.warm_evictions and pool.fresh_admits
    assert pool.prefetcher is None and pool.prefetch_hits == 0
    assert pool.cold_docs == pool.recount_cold()
    assert pool.tier_status() == jpool.tier_status()


def test_tiered_drain_bucket_states_equal_jax(tiered):
    pool, jpool = tiered["pool"], tiered["jpool"]
    want = buckets_from_jax({
        c: {f: np.asarray(getattr(b.state, f))
            for f in ("doc", "length", "nvis")}
        for c, b in jpool.buckets.items()}, device="cpu")
    for c, b in pool.buckets.items():
        assert b.rows == jpool.buckets[c].rows, c
        for f in ("doc", "length", "nvis"):
            assert torch.equal(getattr(b.state, f), getattr(want[c], f)), (
                c, f)
    assert _records(pool) == _records(jpool)


def test_tiered_drain_warm_entries_and_cold_set_equal_jax(tiered):
    pool, jpool = tiered["pool"], tiered["jpool"]
    assert sorted(pool.warm.entries) == sorted(jpool.warm.entries)
    assert pool.warm.entries
    for d, e in pool.warm.entries.items():
        je = jpool.warm.entries[d]
        assert (e.length, e.nvis, e.last_sched, e.origin) == (
            je.length, je.nvis, je.last_sched, je.origin), d
        np.testing.assert_array_equal(e.doc_row, np.asarray(je.doc_row))
    assert _cold(pool) == _cold(jpool) and _cold(pool)
    for d in _cold(pool):  # each cold doc's spool holds JAX's bytes
        got = port_ckpt.load_state(pool.docs[d].spool)
        want = jax_ckpt.load_state(jpool.docs[d].spool)
        for f in ("doc", "length", "nvis"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))


def test_tiered_drain_every_doc_matches_the_oracle(tiered):
    pool, jpool, ppool = tiered["pool"], tiered["jpool"], tiered["ppool"]
    tiers = set()
    for s, js in zip(tiered["sessions"], tiered["jsessions"]):
        want = replay_trace(s.trace)
        assert want == jax_replay(js.trace)
        assert pool.decode(s.doc_id) == want == jpool.decode(s.doc_id)
        assert ppool.decode(s.doc_id) == want
        rec = pool.docs[s.doc_id]
        tiers.add("hot" if rec.cls is not None else
                  "warm" if s.doc_id in pool.warm else "cold")
        # no doc holds two tiers at once
        assert sum((rec.cls is not None, s.doc_id in pool.warm,
                    rec.spool is not None)) == 1
    assert tiers == {"hot", "warm", "cold"}


def test_prefetch_drain_keeps_the_timing_free_facts(tiered):
    pool, sched, stats = tiered["pool"], tiered["sched"], tiered["stats"]
    ppool, psched, pstats = (tiered["ppool"], tiered["psched"],
                             tiered["pstats"])
    assert psched.done
    for name in STATS:
        if name != "restores":
            assert getattr(pstats, name) == getattr(stats, name), name
    assert psched.limbo_pulls == sched.limbo_pulls
    assert ppool.fresh_admits == pool.fresh_admits
    assert (ppool.warm_hits + ppool.restores
            == pool.warm_hits + pool.restores)
    assert ppool.prefetch_hits <= ppool.warm_hits
    assert _records(ppool) == _records(pool)
    for c, b in ppool.buckets.items():
        assert b.rows == pool.buckets[c].rows, c
        for f in ("doc", "length", "nvis"):
            assert torch.equal(getattr(b.state, f),
                               getattr(pool.buckets[c].state, f)), (c, f)
    assert ppool.cold_docs == ppool.recount_cold()
    assert "prefetch" in pstats.phase_seconds
    assert "prefetch" not in stats.phase_seconds


def test_prefetch_drain_harvests_every_submission(tiered):
    ppool, psched = tiered["ppool"], tiered["psched"]
    pf = ppool.prefetcher
    assert pf is not None and pf.alive and pf.submitted > 0
    deadline = time.monotonic() + 5.0
    while pf.harvested < pf.submitted and time.monotonic() < deadline:
        psched._harvest_prefetch()
        time.sleep(0.005)
    assert pf.harvested == pf.submitted
    assert pf.published_count > 0 and pf.lost == 0
    assert pf.revealed_count == pf.harvested + pf.reap_dropped
    assert pf.inflight == 0 and not psched._prefetch_inflight
    assert ppool.cold_docs == ppool.recount_cold()


def test_limbo_pulls_equal_jax(tmp_path):
    """A doc evicted as a smaller class's victim in the round a larger
    class selects it: pulled from its old row (the JAX package's limbo
    regression), the same number of times as JAX."""
    sessions = build_fleet(**LIMBO_FLEET)
    jsessions = jax_build_fleet(**LIMBO_FLEET)
    pool = DocPool(device="cpu", spool_dir=str(tmp_path / "p"), **LIMBO_POOL)
    jpool = JaxPool(spool_dir=str(tmp_path / "j"), **LIMBO_POOL)
    try:
        sched = FleetScheduler(
            pool, prepare_streams(sessions, pool, **LIMBO_DRAIN), macro_k=4,
            **LIMBO_DRAIN)
        jsched = JaxScheduler(
            jpool, jax_prepare(jsessions, jpool, **LIMBO_DRAIN), macro_k=4,
            **LIMBO_DRAIN)
        stats, jstats = sched.run(), jsched.run()
        assert sched.done and jsched.done
        assert sched.limbo_pulls == jsched.limbo_pulls > 0
        for name in STATS:
            assert getattr(stats, name) == getattr(jstats, name), name
        for name in POOL:
            assert getattr(pool, name) == getattr(jpool, name), name
        for s in sessions:
            assert pool.decode(s.doc_id) == replay_trace(s.trace)
        assert pool.cold_docs == pool.recount_cold()
    finally:
        pool.close()
        jpool.close()


# ---- the pool's tier mechanics ----


def _deflated(path):
    with zipfile.ZipFile(path) as z:
        return {i.compress_type == zipfile.ZIP_DEFLATED for i in z.infolist()}


def _pool_with_docs(tmp_path, n, warm_docs, **kw):
    pool = DocPool(classes=(128, 1024), slots=(n, 2), device="cpu",
                   spool_dir=str(tmp_path / "spool"), warm_docs=warm_docs,
                   **kw)
    rng = np.random.default_rng(5)
    for d in range(n):
        chars = rng.integers(97, 123, 100).astype(np.int32)
        pool.register(d, n_init=40 + d, capacity_need=100, chars=chars)
        pool.admit(d, 40 + d)
    return pool


def _to_warm(pool, d):
    rec = pool.docs[d]
    doc, length, nvis = pool._pull_row(rec)
    pool._free_row(rec)
    return pool.warm_deposit(d, doc, length, nvis)


def test_cold_writes_compressed_two_tier_spools_not(tmp_path):
    pool = _pool_with_docs(tmp_path / "warm", 5, warm_docs=2,
                           prefetch=False)
    two = _pool_with_docs(tmp_path / "two", 2, warm_docs=0)
    try:
        for d in range(5):
            pool.docs[d].last_sched = 10 + d
        for d in (2, 0, 4, 3, 1):  # deposit order is not the LRU order
            _to_warm(pool, d)
        # overflow demoted the least recently scheduled first
        assert sorted(pool.warm.entries) == [3, 4]
        assert sorted(_cold(pool)) == [0, 1, 2]
        assert pool.warm_evictions == 3 == pool.cold_docs
        for d in (0, 1, 2):
            assert _deflated(pool.docs[d].spool) == {True}
        two_spool = two.evict(1)
        assert _deflated(two_spool) == {False}
        pool.admit(3, 43)  # a warm doc back, then evicted directly
        assert _deflated(pool.evict(3)) == {True}
        # every spool loads in either package and decodes the same
        for d in (0, 1, 2, 3):
            path = pool.docs[d].spool
            got = port_ckpt.load_state(path)
            want = jax_ckpt.load_state(path)
            np.testing.assert_array_equal(got.doc, np.asarray(want.doc))
            assert pool.decode(d) == "".join(
                map(chr, pool.docs[d].chars[:40 + d]))
        st = two.docs[1]
        assert jax_ckpt.load_state(st.spool).doc.shape == (1, 41)
        assert pool.cold_docs == pool.recount_cold() == 4
    finally:
        pool.close()
        two.close()


def test_warm_hit_never_touches_the_disk(tmp_path, monkeypatch):
    pool = _pool_with_docs(tmp_path, 3, warm_docs=4, prefetch=False)
    try:
        want = pool.decode(1)
        _to_warm(pool, 1)
        assert 1 in pool.warm and pool.docs[1].spool is None

        def no_disk(*a, **kw):
            raise AssertionError("the warm tier touched the disk")

        monkeypatch.setattr(port_pool, "load_state", no_disk)
        monkeypatch.setattr(port_pool, "save_state", no_disk)
        before = os.listdir(pool.spool_dir)
        assert pool.decode(1) == want  # decode reads the warm entry
        pool.admit(1, 41)
        assert pool.decode(1) == want
        assert os.listdir(pool.spool_dir) == before
        assert (pool.warm_hits, pool.restores, pool.warm_evictions) == (
            1, 0, 0)
    finally:
        monkeypatch.undo()
        pool.close()


def test_rehydrate_keeps_the_spool_until_resident(tmp_path, monkeypatch):
    """A restore that dies between the spool read and the install leaves
    the doc's spool claim and file intact (the JAX package's deferred
    unlink); a restore that lands clears the claim and leaves the file."""
    pool = _pool_with_docs(tmp_path, 2, warm_docs=0)
    try:
        want = pool.decode(0)
        spool = pool.evict(0)
        rec = pool.docs[0]

        def dead_install(*a, **kw):
            raise RuntimeError("install died mid-rehydrate")

        monkeypatch.setattr(pool, "_install", dead_install)
        with pytest.raises(RuntimeError, match="mid-rehydrate"):
            pool.admit(0, 40)
        assert rec.spool == spool and os.path.exists(spool)
        assert pool.decode(0) == want and pool.cold_docs == 1
        monkeypatch.undo()
        cls, row = pool.admit(0, 40)
        assert rec.cls == cls and rec.spool is None
        assert pool.decode(0) == want
        assert os.path.exists(spool) and pool.cold_docs == 0
    finally:
        pool.close()


def test_warm_restore_comes_back_warm_with_its_shadow(tmp_path):
    pool = _pool_with_docs(tmp_path, 3, warm_docs=1, prefetch=False)
    try:
        want = {d: pool.decode(d) for d in range(3)}
        rows = {}
        for d in (0, 1):
            rec = pool.docs[d]
            rows[d] = pool._pull_row(rec)
            pool._free_row(rec)
        shadow = pool.spool_save(0, *rows[0], compress=True)
        pool.docs[0].last_sched, pool.docs[1].last_sched = 5, 3
        pool.warm_restore(0, *rows[0], shadow=shadow)
        assert pool.warm.entries[0].origin == "recover"
        pool.warm_restore(1, *rows[1], shadow=None)
        # over budget: the least recently scheduled (doc 1) went cold
        assert sorted(pool.warm.entries) == [0] and _cold(pool) == {1}
        assert pool.decode(0) == want[0] and pool.decode(1) == want[1]
        gens = pool.spool_gen(0)
        pool.docs[2].last_sched = 9
        _to_warm(pool, 2)
        # doc 0 demoted for free: its shadow became its spool
        assert pool.docs[0].spool == shadow and pool.spool_gen(0) == gens
        assert pool.cold_docs == pool.recount_cold() == 2
    finally:
        pool.close()


def test_two_tier_pool_starts_no_thread(tmp_path):
    import threading

    before = {t.name for t in threading.enumerate()}
    pool = DocPool(device="cpu", spool_dir=str(tmp_path))
    try:
        assert pool.prefetcher is None and pool.warm.budget == 0
        assert "serve-prefetch" not in {t.name for t in threading.enumerate()
                                        } - before
        off = DocPool(device="cpu", spool_dir=str(tmp_path / "off"),
                      warm_docs=4, prefetch=False)
        assert off.prefetcher is None
        off.close()
    finally:
        pool.close()
    armed = DocPool(device="cpu", spool_dir=str(tmp_path / "on"),
                    warm_docs=4)
    pf = armed.prefetcher
    try:
        assert pf is not None and pf.alive
    finally:
        armed.close()
    assert not pf.alive and armed.prefetcher is pf


# ---- the bench entry ----


def _serve_entry(*extra):
    return subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--group",
         "serve", "--device", "cpu", "--serve-mix", "synth",
         "--serve-docs", "8", "--serve-batch", "16", "--serve-macro", "4",
         "--serve-batch-chars", "64", "--serve-slots", "2,2,2,2,2",
         "--serve-arrival-span", "4", "--seed", "1", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_serve_bench_entry_tiered_on_cpu_prints_one_json_line():
    done = _serve_entry("--serve-tiers", "hot=10,warm=2",
                        "--serve-arrival-dist", "zipf")
    assert done.returncode == 0, done.stderr
    lines = done.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"].startswith("serve/tier/synth/8 ")
    assert out["verify_ok"] is True and out["verified_docs"] == 8
    assert out["arrival_dist"] == "zipf" and out["slots"] == [2] * 5
    res = out["residency"]
    assert res["version"] == 1 and res["tiers"] == "hot=10,warm=2"
    assert (res["hot_rows_budget"], res["warm_budget"]) == (10, 2)
    assert set(res) == {
        "version", "tiers", "hot_rows_budget", "warm_budget",
        "arrival_dist", "hot_rows_final", "warm_docs_final",
        "cold_docs_final", "evictions", "warm_hits", "warm_evictions",
        "cold_restores", "prefetch_hits", "prefetch_submitted",
        "prefetch_harvested", "prefetch_dropped", "prefetch_errors",
        "prefetch_wasted", "prefetch_missed", "hit_rate"}
    assert res["evictions"] == out["evictions"] > 0
    hits, cold = res["warm_hits"], res["cold_restores"]
    assert hits + cold > 0 and res["hit_rate"] == hits / (hits + cold)
    assert "prefetch" in out["phase_seconds"]
    assert "limbo_pulls" in out and out["fresh_admits"] == 8


def test_serve_bench_entry_two_tier_record_gains_only_fresh_admits():
    done = _serve_entry()
    assert done.returncode == 0, done.stderr
    out = json.loads(done.stdout)
    assert out["metric"].startswith("serve/synth/8 ")
    assert out["fresh_admits"] == 8
    for key in ("residency", "limbo_pulls", "arrival_dist"):
        assert key not in out
    assert set(out["phase_seconds"]) == {"plan", "stage", "moves",
                                         "dispatch"}


@pytest.mark.parametrize("spec,message", [
    ("hot=10", "warm=DOCS (> 0) is required"),
    ("hot=4,warm=2", "below the floor of 2 rows per capacity class (10)"),
])
def test_serve_bench_entry_refuses_a_bad_tier_spec(spec, message, capsys):
    from crdt_benches_tpu_torch.bench.__main__ import main

    with pytest.raises(ValueError, match=r"\(> 0\)|floor"):
        jax_parse(spec, (2, 2, 2, 2, 2))
    with pytest.raises(SystemExit) as done:
        main(["--group", "serve", "--device", "cpu", "--serve-slots",
              "2,2,2,2,2", "--serve-tiers", spec])
    assert done.value.code != 0
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--serve-tiers", "hot=10,warm=2"],
    ["--serve-arrival-dist", "zipf"],
    ["--group", "merge", "--serve-tiers", "warm=2"],
    ["--group", "downstream", "--serve-arrival-dist", "uniform"],
])
def test_bench_entry_keeps_tier_flags_to_the_serve_group(argv, capsys):
    from crdt_benches_tpu_torch.bench.__main__ import main

    with pytest.raises(SystemExit) as done:
        main(argv + ["--device", "cpu"])
    assert done.value.code == 2
    assert "belong" in capsys.readouterr().err
