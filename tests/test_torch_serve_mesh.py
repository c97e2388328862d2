"""The port's serve mesh (``parallel/mesh.py fleet_mesh``/``fleet_sharding``,
``DocPool(mesh=)``, the bench's ``mesh_devices``) against the JAX package's
``DocPool(mesh=replica_mesh(8))`` on the conftest's 8 virtual CPU devices,
mirroring JAX's mesh tests (``tests/test_serve.py``,
``tests/test_serve_macro.py``, ``tests/test_serve_stream.py``,
``tests/test_obs_v2.py``, ``tests/test_reshard.py``).

Tolerance: exact.  Each drain runs one tiny seeded fleet through both
packages over 8 shards (the port on the CPU, its kernels' plain versions)
and holds the port to JAX's scheduler counters, every doc record, every
bucket row map and array (the shards concatenated in row order) and every
decoded document, for both serve kernels and with the row tier cut below
the bucket (Rt < R).  A journaled mesh drain writes JAX's WAL and snapshot
bytes, and each package recovers the other's directory into a mesh pool.
The shard gauges partition the fleet totals as JAX's do; the pool's and the
bench's mesh refusals use JAX's words."""

import os
import shutil

import numpy as np
import pytest
import torch

from crdt_benches_tpu.parallel.mesh import replica_mesh
from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve.bench import run_serve_bench as jax_bench
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.obs.timeseries import (
    ServeTelemetry,
    TimeseriesRecorder,
)
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.parallel import mesh as pmesh
from crdt_benches_tpu_torch.parallel.mesh import fleet_mesh, fleet_sharding
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve.bench import run_serve_bench
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.reshard import (
    ReshardCoordinator,
    parse_reshard_spec,
)
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    LazyStreams,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import (
    FleetSpec,
    Session,
    build_fleet,
    trace_prefix,
)

TINY_BANDS = {"synth-small": ("synth", (40, 120))}
TINY_MIX = {"synth-small": 1.0}
STATS = ("rounds", "slices", "ops", "unit_ops", "patches",
         "evictions", "restores", "promotions", "admissions", "snapshots",
         "staged_cells")
DRAIN = dict(batch=8, batch_chars=32)


def _side(side, tmp_path, sub, slots, kernel="fused", n=12):
    """One package's tiny fleet on an 8-shard mesh pool."""
    if side == "jax":
        sessions = jax_build_fleet(n, mix=TINY_MIX, seed=5, arrival_span=2,
                                   bands=TINY_BANDS)
        pool = JaxPool(classes=(128,), slots=(slots,), mesh=replica_mesh(8),
                       serve_kernel=kernel,
                       spool_dir=str(tmp_path / f"j{sub}"))
        return sessions, pool, jax_prepare(sessions, pool, **DRAIN), \
            JaxScheduler
    sessions = build_fleet(n, mix=TINY_MIX, seed=5, arrival_span=2,
                           bands=TINY_BANDS)
    pool = DocPool(classes=(128,), slots=(slots,), mesh=fleet_mesh(8, "cpu"),
                   serve_kernel=kernel, device="cpu",
                   spool_dir=str(tmp_path / f"p{sub}"))
    return sessions, pool, prepare_streams(sessions, pool, **DRAIN), \
        FleetScheduler


def _state(pool, streams) -> dict:
    return {
        "buckets": {c: (list(b.rows), sorted(b.free),
                        *(np.asarray(x).tolist()
                          for x in pool.pull_bucket(c)))
                    for c, b in pool.buckets.items()},
        "docs": {d: (r.cls, r.row, r.length, r.last_sched)
                 for d, r in pool.docs.items()},
        "cursors": {d: st.cursor for d, st in streams.items()},
    }


def _same(js, ps):
    for f in STATS:
        assert getattr(ps, f) == getattr(js, f), f


@pytest.mark.parametrize("kernel", ["fused", "scan"])
@pytest.mark.parametrize("slots", [8, 128], ids=["full-tier", "sub-tier"])
def test_mesh_fleet_equals_jax(tmp_path, kernel, slots):
    """JAX's ``test_mesh_fleet_matches_unsharded`` (8 rows: one local row a
    shard, every tier the bucket) and ``test_mesh_macro_fleet_matches_
    unsharded`` (128 rows: 12 docs compact into the Rt = 32 tier)."""
    out = {}
    for side in ("jax", "port"):
        sessions, pool, streams, Sched = _side(side, tmp_path, "a", slots,
                                               kernel)
        stats = Sched(pool, streams, macro_k=4, **DRAIN).run()
        out[side] = (pool, streams, stats, sessions)
    (jpool, jst, js, _), (ppool, pst, ps, sessions) = out["jax"], out["port"]
    assert ppool.n_sh == jpool.n_sh == 8
    _same(js, ps)
    assert ps.pad_fraction == js.pad_fraction < 1.0
    assert _state(ppool, pst) == _state(jpool, jst)
    b = ppool.buckets[128]
    assert b.state is None and len(b.parts) == 8
    assert all(p.doc.shape == (slots // 8, 128) for p in b.parts)
    # a tier is the first Rt / 8 rows of every shard, gathered in order
    doc = ppool.pull_bucket(128)[0].reshape(8, slots // 8, 128)
    for Rt in ppool.tiers(128):
        assert np.array_equal(ppool.tier_rows(128, Rt).doc.numpy(),
                              doc[:, :Rt // 8].reshape(Rt, 128))
    for s in sessions:
        assert ppool.decode(s.doc_id) == jpool.decode(s.doc_id) \
            == replay_trace(s.trace)
    jpool.close()
    ppool.close()


def test_fleet_mesh_placement(monkeypatch):
    cpu = fleet_mesh(8, "cpu")
    assert fleet_sharding(cpu) == (torch.device("cpu"),) * 8
    assert cpu.size == 8 and cpu.describe() == "8 shards on the CPU"
    with pytest.raises(ValueError, match="2 or more shards"):
        fleet_mesh(1, "cpu")
    # on CUDA shard s lives on cuda:(s mod G), whatever G is
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for g, want in ((1, "8 shards on 1 GPU: cuda:0"),
                    (3, "8 shards on 3 GPUs: cuda:0, cuda:1, cuda:2")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda g=g: g)
        m = fleet_mesh(8, "cuda")
        assert fleet_sharding(m) == tuple(torch.device("cuda", s % g)
                                          for s in range(8))
        assert m.describe() == want
    # each shard's allocator stats read its own device
    seen = []
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d: seen.append(d) or {"d": str(d)})
    stats = pmesh.device_memory_stats(devices=fleet_sharding(m))
    assert seen == list(fleet_sharding(m))
    assert [s["d"] for s in stats] == [str(d) for d in fleet_sharding(m)]
    assert pmesh.device_memory_stats(devices=fleet_sharding(cpu)) == \
        [None] * 8


def test_pool_mesh_errors_are_jax_words(tmp_path):
    mesh = fleet_mesh(8, "cpu")
    for kw in (dict(slots=(12,)), dict(slots=(16,), shards=4)):
        with pytest.raises(ValueError) as pe:
            DocPool(classes=(128,), mesh=mesh, device="cpu",
                    spool_dir=str(tmp_path / "p"), **kw)
        with pytest.raises(ValueError) as je:
            JaxPool(classes=(128,), mesh=replica_mesh(8),
                    spool_dir=str(tmp_path / "j"), **kw)
        assert str(pe.value) == str(je.value)
    pool = DocPool(classes=(128,), slots=(16,), mesh=mesh, shards=8,
                   device="cpu", spool_dir=str(tmp_path / "ok"))
    assert pool.n_sh == 8 and pool.shard_devices == fleet_sharding(mesh)
    pool.close()


def test_journaled_mesh_drain_bytes_and_cross_recovery(tmp_path):
    """A journaled mesh drain killed between barriers: the WAL and snapshot
    bytes equal JAX's, and each package recovers the other's directory
    into a mesh pool with JAX's report and state, then drains to the
    oracle."""
    dirs = {}
    for side in ("jax", "port"):
        _s, pool, streams, Sched = _side(side, tmp_path, "w", 16)
        mod = jj if side == "jax" else pj
        jd = str(tmp_path / f"journal_{side}")
        sched = Sched(pool, streams, macro_k=4, **DRAIN,
                      journal=mod.OpJournal(jd), snapshot_every=2)
        sched.run(max_rounds=3)
        assert not sched.done
        sched.journal.close()
        pool.close()
        dirs[side] = jd
    files = {}
    for side, jd in dirs.items():
        files[side] = {os.path.relpath(os.path.join(r, f), jd):
                       open(os.path.join(r, f), "rb").read()
                       for r, _d, fs in os.walk(jd) for f in fs}
    assert any(k.endswith(".npz") for k in files["jax"])
    assert files["port"] == files["jax"]
    # each package recovers the other's directory
    results = {}
    for reader, writer in (("jax", "port"), ("port", "jax")):
        copy = str(tmp_path / f"{reader}_reads_{writer}")
        shutil.copytree(dirs[writer], copy)
        sessions, pool, streams, Sched = _side(reader, tmp_path,
                                               f"r{reader}", 16)
        rep = (jj if reader == "jax" else pj).recover_fleet(pool, streams,
                                                            copy)
        results[reader] = (rep, _state(pool, streams))
        Sched(pool, streams, macro_k=4, **DRAIN,
              start_round=rep.resume_round).run()
        for s in sessions:
            assert pool.decode(s.doc_id) == replay_trace(s.trace)
        pool.close()
    (jrep, jstate), (prep, pstate) = results["jax"], results["port"]
    for key, want in vars(jrep).items():
        if key != "snapshot_dir":
            assert vars(prep)[key] == want, key
    assert prep.docs_restored > 0
    assert pstate == jstate


def test_reshard_drain_resolves_against_the_mesh(tmp_path):
    """``drain:S`` without ``of=N`` takes its shard count from the mesh
    (JAX's ``tests/test_reshard.py``); a count the mesh does not have, or
    a shrink of another shard count, is refused in JAX's words."""
    pool = DocPool(classes=(128,), slots=(16,), mesh=fleet_mesh(8, "cpu"),
                   device="cpu", spool_dir=str(tmp_path / "p"))
    journal = pj.OpJournal(str(tmp_path / "j"))
    coord = ReshardCoordinator(pool, journal, parse_reshard_spec("drain:3"))
    assert coord._shards == (3,)
    with pytest.raises(ValueError, match=r"reshard drain:9: pool has 8 "):
        ReshardCoordinator(pool, journal, parse_reshard_spec("drain:9"))
    with pytest.raises(ValueError) as e:
        ReshardCoordinator(pool, journal, parse_reshard_spec("shrink:4:2"))
    assert str(e.value).endswith("(pass --serve-mesh or shards=)")
    journal.close()
    pool.close()


def test_shard_sum_parity_on_the_mesh(tmp_path):
    """JAX's ``test_shard_sum_parity_and_uniform_imbalance``: 16 identical
    docs over 8 shards; the per-shard series partition the fleet totals in
    every window, every shard carries its equal share, the imbalance gauge
    stays 1.0, and the windows equal JAX's."""
    tr = trace_prefix("automerge-paper", 240)
    sessions = [Session(doc_id=i, band="t", source="automerge-paper",
                        trace=tr) for i in range(16)]
    pool = DocPool(classes=(256,), slots=(16,), mesh=fleet_mesh(8, "cpu"),
                   device="cpu", spool_dir=str(tmp_path / "spool"))
    streams = prepare_streams(sessions, pool, batch=8, batch_chars=64)
    tel = ServeTelemetry(recorder=TimeseriesRecorder(window_rounds=2))
    sched = FleetScheduler(pool, streams, batch=8, macro_k=4,
                           batch_chars=64, telemetry=tel)
    stats = sched.run()
    assert sched.done
    tel.drain_end()
    ws = tel.recorder.block()["windows"]
    assert ws and tel.recorder.n_shards == 8
    for w in ws:
        assert len(w["shard_ops"]) == 8
        assert sum(w["shard_ops"]) == w["ops"]
        assert sum(w["shard_unit_ops"]) == w["unit_ops"]
        assert sum(w["shard_lanes"]) == w["lanes"]
        assert len(set(w["shard_ops"])) == 1
        assert len(set(w["shard_lanes"])) == 1
    assert sum(w["ops"] for w in ws) == stats.ops
    m = stats.metrics.to_dict()
    shard_ops = [m["counters"][f'serve.shard.ops{{shard="{s}"}}']
                 for s in range(8)]
    assert sum(shard_ops) == stats.ops and len(set(shard_ops)) == 1
    imb = m["gauges"]["serve.shard.imbalance"]
    assert imb["min"] == imb["max"] == 1.0
    # JAX's drain of the same fleet gives the same windows' counts
    from crdt_benches_tpu.obs.timeseries import (
        ServeTelemetry as JaxTelemetry,
        TimeseriesRecorder as JaxRecorder,
    )
    from crdt_benches_tpu.serve.workload import Session as JaxSession
    from crdt_benches_tpu.serve.workload import trace_prefix as jax_prefix

    jtr = jax_prefix("automerge-paper", 240)
    jpool = JaxPool(classes=(256,), slots=(16,), mesh=replica_mesh(8),
                    spool_dir=str(tmp_path / "jspool"))
    jstreams = jax_prepare([JaxSession(doc_id=i, band="t",
                                       source="automerge-paper", trace=jtr)
                            for i in range(16)], jpool, batch=8,
                           batch_chars=64)
    jtel = JaxTelemetry(recorder=JaxRecorder(window_rounds=2))
    JaxScheduler(jpool, jstreams, batch=8, macro_k=4, batch_chars=64,
                 telemetry=jtel).run()
    jtel.drain_end()
    keys = ("ops", "unit_ops", "lanes", "shard_ops", "shard_unit_ops",
            "shard_lanes")
    assert [{k: w[k] for k in keys} for w in ws] == \
        [{k: w[k] for k in keys} for w in jtel.recorder.block()["windows"]]
    pool.close()
    jpool.close()


def test_mesh_stream_fleet_and_shard_ranges(tmp_path):
    """JAX's ``test_shard_range_is_a_balanced_partition`` and
    ``test_mesh_stream_fleet_matches_unsharded``: a lazy fleet over the
    mesh decodes as the unsharded one, and both equal the oracle."""
    spec = FleetSpec.build(23, mix=TINY_MIX, seed=5, arrival_span=2,
                           bands=TINY_BANDS)
    for n in (1, 2, 5, 8, 23, 30):
        ids = [list(spec.shard_doc_ids(s, n)) for s in range(n)]
        assert [i for c in ids for i in c] == list(range(23))
        sizes = [len(c) for c in ids]
        assert max(sizes) - min(sizes) <= 1
    for bad in (8, -1):
        with pytest.raises(ValueError):
            spec.shard_range(bad, 8)

    def run(mesh, sub):
        spec = FleetSpec.build(12, mix=TINY_MIX, seed=5, arrival_span=2,
                               bands=TINY_BANDS)
        pool = DocPool(classes=(128,), slots=(8,), mesh=mesh, device="cpu",
                       spool_dir=str(tmp_path / sub))
        try:
            streams = LazyStreams(spec, pool, **DRAIN)
            FleetScheduler(pool, streams, macro_k=4, **DRAIN).run()
            return spec, {i: pool.decode(i) for i in range(spec.n_docs)}
        finally:
            pool.close()

    spec, plain = run(None, "plain")
    _, sharded = run(fleet_mesh(8, "cpu"), "mesh")
    assert plain == sharded
    for i in range(spec.n_docs):
        assert plain[i] == replay_trace(spec.session(i).trace)


@pytest.mark.parametrize("kw", [
    dict(serve_tiers="warm=4"),
    dict(journal_dir="auto", measure_recovery=True),
    dict(open_spec="16"),
], ids=["tiers", "recovery", "open"])
def test_bench_mesh_refusals_are_jax_words(kw):
    common = dict(mix=TINY_MIX, n_docs=4, bands=TINY_BANDS, mesh_devices=8,
                  log=lambda *_a: None)
    with pytest.raises(ValueError) as je:
        jax_bench(**common, **kw)
    with pytest.raises(ValueError) as pe:
        run_serve_bench(**common, device="cpu", **kw)
    assert str(pe.value) == str(je.value)


def test_bench_mesh_drain_logs_its_placement():
    lines = []
    rep = run_serve_bench(mix=TINY_MIX, n_docs=8, bands=TINY_BANDS,
                          classes=(128,), slots=(8,), batch=8,
                          batch_chars=32, macro_k=4, arrival_span=2,
                          mesh_devices=8, device="cpu", log=lines.append)
    assert rep["verify_ok"] and rep["mesh_devices"] == 8
    assert "serve: mesh=8 (8 shards on the CPU)" in lines
