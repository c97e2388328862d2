"""The port's serving fleet (``serve/``) against the JAX package's: the
same sessions for a seed, the same drain of a tiny fleet (plans, counters
and final bucket states field by field, every document byte-identical to
the oracle), eviction spools that load in either package, and the
``--group serve`` bench entry on the CPU.

The tiny fleet is the serve smoke shape of the JAX package's runner: 24
docs of the ``mixed`` table over all five classes with 16/6/2/2/2 rows,
batch 16, macro depth 4, 64 chars a slice, arrivals over 2 rounds — small
enough to drain on the CPU, crowded enough to evict, restore and
promote."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from crdt_benches_tpu.oracle.text_oracle import replay_trace as jax_replay
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import FleetSpec as JaxSpec
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu.utils import checkpoint as jax_ckpt
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import pool as port_pool
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import FleetSpec, build_fleet
from crdt_benches_tpu_torch.utils import checkpoint as port_ckpt
from crdt_benches_tpu_torch.utils.convert import buckets_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET = dict(n_docs=24, mix="mixed", seed=0, arrival_span=2)
SLOTS = (16, 6, 2, 2, 2)
DRAIN = dict(batch=16, batch_chars=64)
MACRO_K = 4
COUNTERS = ("rounds", "slices", "ops", "unit_ops", "evictions", "restores",
            "promotions", "admissions")
TINY_BANDS = {"synth-small": ("synth", (10, 60)),
              "synth-medium": ("synth", (150, 360))}


def _same_sessions(port, jax):
    assert len(port) == len(jax)
    for p, j in zip(port, jax):
        assert (p.doc_id, p.band, p.source, p.arrival) == (
            j.doc_id, j.band, j.source, j.arrival)
        assert p.trace.start_content == j.trace.start_content
        assert list(p.trace.iter_patches()) == [
            tuple(x) for x in j.trace.iter_patches()]


@pytest.fixture(scope="module")
def drained(tmp_path_factory):
    """The tiny fleet drained by both packages (pools left open for
    decoding; closed at teardown)."""
    sessions = build_fleet(**FLEET)
    jsessions = jax_build_fleet(**FLEET)
    pool = DocPool(slots=SLOTS, device="cpu",
                   spool_dir=str(tmp_path_factory.mktemp("port_spool")))
    sched = FleetScheduler(pool, prepare_streams(sessions, pool, **DRAIN),
                           macro_k=MACRO_K, **DRAIN)
    stats = sched.run()
    jpool = JaxPool(slots=SLOTS,
                    spool_dir=str(tmp_path_factory.mktemp("jax_spool")))
    jsched = JaxScheduler(jpool, jax_prepare(jsessions, jpool, **DRAIN),
                          macro_k=MACRO_K, **DRAIN)
    jstats = jsched.run()
    yield dict(sessions=sessions, jsessions=jsessions, pool=pool,
               sched=sched, stats=stats, jpool=jpool, jsched=jsched,
               jstats=jstats)
    pool.close()
    jpool.close()


def test_build_fleet_sessions_equal_jax(drained):
    _same_sessions(drained["sessions"], drained["jsessions"])
    assert {s.source for s in drained["sessions"]} > {"synth"}


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_fleet_spec_draws_equal_jax(dist):
    kw = dict(mix={"synth-small": 0.7, "synth-medium": 0.3}, seed=11,
              arrival_span=6, bands=TINY_BANDS, arrival_dist=dist)
    spec, jspec = FleetSpec.build(40, **kw), JaxSpec.build(40, **kw)
    for f in ("band_of", "arrivals", "trace_ord"):
        np.testing.assert_array_equal(getattr(spec, f), getattr(jspec, f))
    _same_sessions(build_fleet(40, **kw), jax_build_fleet(40, **kw))


def test_tiny_drain_counters_equal_jax(drained):
    stats, jstats = drained["stats"], drained["jstats"]
    assert drained["sched"].done and drained["jsched"].done
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(jstats, name), name
    assert stats.evictions and stats.restores and stats.promotions
    assert stats.patches == jstats.patches
    assert stats.coalesce_ratio == jstats.coalesce_ratio
    assert stats.pad_fraction == jstats.pad_fraction
    assert stats.dispatches >= stats.rounds
    assert stats.lat_steady.count + stats.lat_skipped.count == stats.rounds
    assert set(stats.latency_quantiles()) == {"p50", "p95", "p99"}


def test_tiny_drain_fresh_admits_equal_jax(drained):
    pool, jpool = drained["pool"], drained["jpool"]
    assert pool.fresh_admits == jpool.fresh_admits == FLEET["n_docs"]
    # the two-tier pool: no warm tier, no thread, every cold doc counted
    assert pool.prefetcher is None and pool.warm_hits == 0
    assert pool.cold_docs == pool.recount_cold() == sum(
        r.spool is not None for r in jpool.docs.values())


def test_tiny_drain_bucket_states_equal_jax(drained):
    pool, jpool = drained["pool"], drained["jpool"]
    want = buckets_from_jax({
        c: {f: np.asarray(getattr(b.state, f))
            for f in ("doc", "length", "nvis")}
        for c, b in jpool.buckets.items()}, device="cpu")
    for c, b in pool.buckets.items():
        assert b.rows == jpool.buckets[c].rows, c
        for f in ("doc", "length", "nvis"):
            assert torch.equal(getattr(b.state, f), getattr(want[c], f)), (
                c, f)
    for d, rec in pool.docs.items():
        jrec = jpool.docs[d]
        assert (rec.cls, rec.row, rec.length, rec.last_sched) == (
            jrec.cls, jrec.row, jrec.length, jrec.last_sched)
        assert (rec.spool is None) == (jrec.spool is None)


def test_tiny_drain_every_doc_matches_the_oracle(drained):
    pool, jpool = drained["pool"], drained["jpool"]
    resident = spooled = 0
    for s, js in zip(drained["sessions"], drained["jsessions"]):
        got = pool.decode(s.doc_id)
        assert got == replay_trace(s.trace) == jax_replay(js.trace)
        assert got == jpool.decode(s.doc_id)
        if pool.docs[s.doc_id].cls is None:
            spooled += 1
        else:
            resident += 1
    assert resident and spooled


def test_spools_load_in_either_package(drained, tmp_path):
    pool = drained["pool"]
    d, rec = next((d, r) for d, r in pool.docs.items() if r.cls is not None)
    doc, length, nvis = pool._pull_row(rec)
    st = port_pool.PackedState(doc[None, :length],
                               np.asarray([length], np.int32),
                               np.asarray([nvis], np.int32))
    port_file, jax_file = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    for compress in (False, True):
        port_ckpt.save_state(port_file, st, compress=compress)
        jst = jax_ckpt.load_state(port_file)
        jax_ckpt.save_state(jax_file, jst, compress=compress)
        back = port_ckpt.load_state(jax_file)
        for f in ("doc", "length", "nvis"):
            np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                          getattr(st, f))
            np.testing.assert_array_equal(getattr(back, f), getattr(st, f))
    # a JAX eviction spool restores through the port's pool
    jspool = next(r.spool for r in drained["jpool"].docs.values()
                  if r.spool is not None)
    assert port_ckpt.load_state(jspool).doc.dtype == np.int32
    with open(port_file, "r+b") as fh:  # damage is refused in both
        fh.seek(-40, os.SEEK_END)
        fh.write(b"\xff" * 8)
    with pytest.raises(port_ckpt.CorruptCheckpointError):
        port_ckpt.load_state(port_file)
    with pytest.raises(jax_ckpt.CorruptCheckpointError):
        jax_ckpt.load_state(port_file)


def test_pool_evict_admit_promote_round_trip(tmp_path):
    pool = DocPool(classes=(128, 256), slots=(2, 2), device="cpu",
                   spool_dir=str(tmp_path))
    chars = np.arange(97, 97 + 200, dtype=np.int32)
    pool.register(0, n_init=100, capacity_need=200, chars=chars)
    assert pool.admit(0, 100) == (128, 0)
    assert pool.decode(0) == "".join(map(chr, chars[:100]))
    path = pool.evict(0)
    assert os.path.exists(path) and pool.docs[0].cls is None
    assert pool.decode(0) == "".join(map(chr, chars[:100]))
    assert pool.admit(0, 100) == (128, 0) and pool.restores == 1
    assert pool.admit(0, 200) == (256, 0) and pool.promotions == 1
    assert pool.decode(0) == "".join(map(chr, chars[:100]))
    assert pool.tiers(128) == [2] and pool.occupancy() == {128: 0.0,
                                                            256: 0.5}
    pool.close()


def test_pool_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="unknown serve kernel"):
        DocPool(serve_kernel="pallas", device="cpu")
    DocPool(serve_kernel="scan", device="cpu").close()  # ported
    with pytest.raises(ValueError, match="multiple of 128"):
        # the refusal under test is what the linter's G008 flags
        DocPool(classes=(100,), slots=(1,), device="cpu")  # graftlint: disable=G008
    pool = DocPool(classes=(128,), slots=(16,), device="cpu")
    assert pool.tiers(128) == [4, 16]
    z = np.zeros((1, 17, 4), np.int8)
    with pytest.raises(ValueError, match="tier"):
        pool.macro_step(128, z, z, z, z, nbits=9)
    pool.close()


def _serve_entry(*extra):
    return subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--group",
         "serve", "--device", "cpu", "--serve-mix", "synth",
         "--serve-docs", "4", "--serve-batch", "16", "--serve-macro", "4",
         "--serve-batch-chars", "64", "--serve-slots", "2,2,2,2,2",
         "--serve-arrival-span", "2", "--seed", "1", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("extra", [(), ("--serve-verify-sample", "2")],
                         ids=["verify-all", "verify-sample"])
def test_serve_bench_entry_on_cpu_prints_one_json_line(extra):
    done = _serve_entry(*extra)
    assert done.returncode == 0, done.stderr
    lines = done.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["unit"] == "elements/sec" and out["value"] > 0
    assert out["verify_ok"] is True and out["device"] == "cpu"
    for key in ("rounds", "device_rounds", "range_ops", "unit_ops",
                "coalesce_ratio", "pad_fraction", "patches_per_sec",
                "evictions", "restores", "promotions", "admissions"):
        assert key in out, key
    assert set(out["batch_latency"]) == {"p50", "p95", "p99"}
    assert out["evictions"] and out["restores"] and out["promotions"]
    if extra:
        assert out["verify"] == "sample" and out["verified_docs"] < 4
    else:
        assert out["verify"] == "all" and out["verified_docs"] == 4


@pytest.mark.parametrize("argv", [
    ["--group", "serve", "--replicas", "4"],
    ["--group", "serve", "--engine", "v3"],
    ["--serve-docs", "8"],
    ["--group", "downstream", "--seed", "1"],
])
def test_bench_entry_keeps_serve_flags_to_their_group(argv, capsys):
    from crdt_benches_tpu_torch.bench.__main__ import main

    with pytest.raises(SystemExit) as done:
        main(argv + ["--device", "cpu"])
    assert done.value.code == 2
    assert "belong" in capsys.readouterr().err
