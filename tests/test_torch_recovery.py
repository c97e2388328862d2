"""Crash recovery both ways between the packages, and the bench's recovery
leg (``serve/bench.py``, ``--serve-journal``/``--serve-crash-round``).

Tolerance: exact.  A journaled drain killed at a seeded round between two
barriers leaves a directory; two copies of it, recovered by JAX's
``recover_fleet`` and by the port's, give equal reports, bucket states,
doc records and cursors, and both resumed drains give the uninterrupted
drain's documents and the oracle's, across both capacity classes.  The
writer is JAX in one case and the port in the other.  The bench entry
prints JAX's ``journal`` and ``recovery`` keys and refuses with JAX's
messages."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve.bench import run_serve_bench as jax_bench
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import Session as JaxSession
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu.serve.workload import trace_prefix as jax_trace_prefix
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve.bench import run_serve_bench
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import (
    Session,
    build_fleet,
    trace_prefix,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_BANDS = {
    "synth-small": ("synth", (10, 60)),
    "synth-medium": ("synth", (150, 360)),
}
TINY_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
POOL = dict(classes=(256, 1024), slots=(6, 3))
DRAIN = dict(batch=16, batch_chars=64)
SCHED = dict(macro_k=4, **DRAIN)


def _sessions(bf=build_fleet, S=Session, tp=trace_prefix):
    """JAX's ``tests/test_journal.py`` fleet (both capacity classes)."""
    sessions = bf(10, mix=TINY_MIX, seed=7, arrival_span=3,
                  bands=TINY_BANDS)
    n = len(sessions)
    return sessions + [
        S(doc_id=n, band="trace-small", source="automerge-paper",
          trace=tp("automerge-paper", 240), arrival=1),
        S(doc_id=n + 1, band="trace-medium", source="sveltecomponent",
          trace=tp("sveltecomponent", 500)),
    ]


def _fresh(tmp_path, sub, jax=False):
    if jax:
        pool = JaxPool(**POOL, spool_dir=str(tmp_path / f"j{sub}"))
        return pool, jax_prepare(_sessions(jax_build_fleet, JaxSession,
                                           jax_trace_prefix), pool, **DRAIN)
    pool = DocPool(**POOL, device="cpu", spool_dir=str(tmp_path / f"p{sub}"))
    return pool, prepare_streams(_sessions(), pool, **DRAIN)


def _state(pool, streams) -> dict:
    return {
        "buckets": {c: (list(b.rows), *(np.asarray(x).tolist()
                                        for x in pool.pull_bucket(c)))
                    for c, b in pool.buckets.items()},
        "docs": {d: (r.cls, r.row, r.length, r.last_sched,
                     None if r.spool is None else os.path.basename(r.spool))
                 for d, r in pool.docs.items()},
        "streams": {d: (st.cursor, st.limit, st.lossy)
                    for d, st in streams.items()},
    }


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    pool, streams = _fresh(tmp_path_factory.mktemp("full"), "a")
    FleetScheduler(pool, streams, **SCHED).run()
    want = {d: pool.decode(d) for d in streams}
    pool.close()
    return want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_crash_recovery_both_ways(tmp_path, uninterrupted, writer):
    rng = np.random.default_rng(0xC0FFEE)
    # odd, so the kill lands between barriers (every 2) with a redo tail
    kill = 3 + 2 * int(rng.integers(0, 2))
    jd = str(tmp_path / "journal")
    pool, streams = _fresh(tmp_path, "w", jax=writer == "jax")
    mod, cls = ((jj, JaxScheduler) if writer == "jax"
                else (pj, FleetScheduler))
    sched = cls(pool, streams, **SCHED, journal=mod.OpJournal(jd),
                snapshot_every=2)
    sched.run(max_rounds=kill)
    assert not sched.done
    pool.close()
    with open(os.path.join(jd, "journal.log"), "a") as f:
        f.write('0bad0bad {"t":"round"')  # a torn final append
    a, b = str(tmp_path / "jcopy"), str(tmp_path / "pcopy")
    shutil.copytree(jd, a)
    shutil.copytree(jd, b)
    jpool, jstreams = _fresh(tmp_path, "jr", jax=True)
    ppool, pstreams = _fresh(tmp_path, "pr")
    jrep = jj.recover_fleet(jpool, jstreams, a)
    rep = pj.recover_fleet(ppool, pstreams, b)
    got, want = vars(rep), vars(jrep)
    for key in want:
        if key != "snapshot_dir":
            assert got[key] == want[key], key
    assert rep.torn_records >= 1 and rep.snapshot_round >= 0
    assert rep.docs_restored + rep.spools_restored > 0
    assert rep.ops_replayed > 0
    assert _state(ppool, pstreams) == _state(jpool, jstreams)
    JaxScheduler(jpool, jstreams, **SCHED, start_round=jrep.resume_round,
                 journal=jj.OpJournal(a), snapshot_every=2).run()
    sched = FleetScheduler(ppool, pstreams, **SCHED,
                           start_round=rep.resume_round,
                           journal=pj.OpJournal(b), snapshot_every=2)
    sched.run()
    assert sched.done
    hosted = set()
    for s in _sessions():
        text = uninterrupted[s.doc_id]
        assert ppool.decode(s.doc_id) == text == jpool.decode(s.doc_id)
        assert text == replay_trace(s.trace)
        rec = ppool.docs[s.doc_id]
        hosted.add(rec.cls or ppool.class_for(max(rec.length, 1)))
    assert hosted == {256, 1024}
    jpool.close()
    ppool.close()


def test_recovery_keeps_the_pool_device(tmp_path):
    """The restored buckets land on the pool's device, never through a CPU
    state: a pool on a stand-in device (``meta``) gets them there."""
    jd = str(tmp_path / "j")
    pool, streams = _fresh(tmp_path, "a")
    FleetScheduler(pool, streams, **SCHED, journal=pj.OpJournal(jd),
                   snapshot_every=2).run(max_rounds=3)
    pool.close()
    meta = DocPool(**POOL, device="meta", spool_dir=str(tmp_path / "m"))
    mstreams = prepare_streams(_sessions(), meta, **DRAIN)
    rep = pj.recover_fleet(meta, mstreams, jd)
    assert rep.docs_restored > 0
    for b in meta.buckets.values():
        assert {t.device.type for t in b.state} == {"meta"}
    meta.close()


# ---- the bench's recovery leg ----


def _serve_entry(*extra, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--group",
         "serve", "--device", "cpu", "--serve-mix", "synth",
         "--serve-docs", "6", "--serve-batch", "16", "--serve-macro", "4",
         "--serve-batch-chars", "64", "--serve-slots", "2,2,2,2,2",
         "--serve-arrival-span", "2", "--seed", "1", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    """The ``journal`` and ``recovery`` blocks of a JAX crash run."""
    tmp = tmp_path_factory.mktemp("jaxbench")
    r, info = jax_bench(
        mix=TINY_MIX, n_docs=6, bands=TINY_BANDS, seed=5, batch=16,
        batch_chars=64, macro_k=4, classes=(256, 1024), slots=(6, 3),
        arrival_span=2, verify_sample=6, journal_dir=str(tmp / "j"),
        snapshot_every=2, snapshot_full_every=2, crash_after=3,
        results_dir=str(tmp / "res"), save_name="recovery_keys",
        log=lambda *_: None)
    assert info["verify_ok"]
    return r.extra["journal"], r.extra["recovery"]


def test_bench_entry_crash_round_prints_the_recovery_blocks(jax_blocks):
    done = _serve_entry("--serve-journal", "auto", "--serve-snapshot-every",
                        "2", "--serve-full-every", "2",
                        "--serve-wal-segment-bytes", "64",
                        "--serve-crash-round", "3")
    assert done.returncode == 0, done.stderr
    lines = done.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    jblock, rblock = jax_blocks
    assert list(out["journal"]) == list(jblock)
    assert list(out["recovery"]) == list(rblock)
    rec = out["recovery"]
    assert out["crashed"] and out["verify_ok"] and rec["verify_ok"]
    assert rec["verified_docs"] == 6 and rec["redo_ops"] > 0
    assert rec["snapshot_round"] >= 0 and rec["chain_depth"] >= 1
    assert out["journal"]["snapshots"] >= 1
    assert out["journal"]["segments_sealed"] >= 1
    assert out["journal"]["dir"] is None  # an owned, removed temp dir
    assert out["recovery_drain"]["dispatches"] > 0
    assert out["metric"].startswith("serve/synth/6 ")


def test_bench_recovers_a_clean_drain_and_names_the_longhaul_family(
        tmp_path):
    """``--serve-recover`` after a clean drain (both verifies must pass)
    and ``--serve-longhaul``, which implies the leg and names the
    ``serve/longhaul`` family; a named journal directory stays."""
    jd = str(tmp_path / "j")
    done = _serve_entry("--serve-journal", jd, "--serve-snapshot-every",
                        "2", "--serve-longhaul", "2")
    assert done.returncode == 0, done.stderr
    out = json.loads(done.stdout)
    assert out["metric"].startswith("serve/longhaul/synth/6 ")
    assert out["longhaul"] == 2 and not out["crashed"]
    assert out["verify_ok"] and out["recovery"]["verify_ok"]
    assert out["verified_docs"] == out["recovery"]["verified_docs"] == 6
    assert out["journal"]["dir"] == jd and pj.list_snapshots(jd)


@pytest.mark.parametrize("argv,kwargs", [
    (["--serve-recover"], dict(measure_recovery=True)),
    (["--serve-crash-round", "3"], dict(crash_after=3)),
    (["--serve-journal", "auto", "--serve-longhaul", "2", "--serve-tiers",
      "warm=4"], dict(journal_dir="auto", longhaul=2,
                      serve_tiers="warm=4")),
])
def test_bench_refusals_carry_jax_messages(argv, kwargs):
    with pytest.raises(ValueError) as want:
        jax_bench(log=lambda *_: None, **kwargs)
    with pytest.raises(ValueError) as got:
        run_serve_bench(device="cpu", log=lambda *_: None, **kwargs)
    assert str(got.value) == str(want.value)
    done = _serve_entry(*argv, timeout=120)
    assert done.returncode == 2 and done.stdout == ""
    assert f"error: {want.value}" in done.stderr


@pytest.mark.parametrize("horizon", [1, 4])
def test_build_fleet_horizon_equals_jax(horizon):
    kw = dict(mix={"synth-small": 0.5, "synth-medium": 0.2,
                   "trace-small": 0.3}, seed=3, arrival_span=4,
              horizon=horizon)
    port, jax = build_fleet(12, **kw), jax_build_fleet(12, **kw)
    assert len(port) == len(jax) == 12
    for p, j in zip(port, jax):
        assert (p.doc_id, p.band, p.source, p.arrival) == (
            j.doc_id, j.band, j.source, j.arrival)
        assert p.trace.start_content == j.trace.start_content
        assert list(p.trace.iter_patches()) == [
            tuple(x) for x in j.trace.iter_patches()]
    if horizon > 1:
        base = build_fleet(12, **{**kw, "horizon": 1})
        for p, b in zip(port, base):
            n, nb = (len(list(s.trace.iter_patches())) for s in (p, b))
            assert n > nb if p.source == "synth" else n == nb
