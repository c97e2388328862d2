"""The ``scan`` serve kernel (``DocPool(serve_kernel="scan")``: the rounds
one after another through ``engine/merge_fleet.py``) against the port's
``fused`` kernel and against the JAX package's ``scan`` drain.

The fused-vs-scan twins of the JAX package's ``tests/test_serve_macro.py``
gates: the same fleet drained through both kernels is byte-identical in
every document (both capacity classes, K = 1 and 8) and also, since the
port's plan does not depend on the kernel, in every bucket state and
counter; a sub-tier (Rt < R) slice agrees too.  Then the tiny 24-doc fleet
of ``tests/test_torch_serve.py`` drained through ``scan`` in both packages:
bucket states, records, decoded documents and counters.  JAX pads the scan
kernel's depth to a power of two (its compile shapes); the port trims it
to the deepest lane, as for ``fused``, so only its ``slices`` may be
fewer."""

import numpy as np
import pytest
import torch

from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve.pool import SERVE_KERNELS, DocPool
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import (
    Session,
    build_fleet,
    trace_prefix,
)
from crdt_benches_tpu_torch.traces.synth import synth_trace
from crdt_benches_tpu_torch.utils.convert import buckets_from_jax

TINY_BANDS = {"synth-small": ("synth", (10, 60)),
              "synth-medium": ("synth", (150, 360))}
TINY_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
COUNTERS = ("rounds", "ops", "unit_ops", "evictions", "restores",
            "promotions", "admissions", "patches")


def _drain(sessions, pool, batch=16, macro_k=1, batch_chars=64):
    streams = prepare_streams(sessions, pool, batch=batch,
                              batch_chars=batch_chars)
    sched = FleetScheduler(pool, streams, batch=batch, macro_k=macro_k,
                           batch_chars=batch_chars)
    stats = sched.run()
    assert sched.done
    return stats


def _mixed_sessions():
    """A small fleet over synth and real-trace classes, arrivals
    staggered (``tests/test_serve_macro.py``'s)."""
    sessions = build_fleet(10, mix=TINY_MIX, seed=7, arrival_span=3,
                           bands=TINY_BANDS)
    nxt = len(sessions)
    sessions += [
        Session(doc_id=nxt, band="trace-small", source="automerge-paper",
                trace=trace_prefix("automerge-paper", 240), arrival=1),
        Session(doc_id=nxt + 1, band="trace-medium",
                source="sveltecomponent",
                trace=trace_prefix("sveltecomponent", 500)),
    ]
    return sessions


def _same_pools(a: DocPool, b: DocPool, sa, sb):
    for name in COUNTERS + ("slices", "dispatches"):
        assert getattr(sa, name) == getattr(sb, name), name
    for c, bk in a.buckets.items():
        assert bk.rows == b.buckets[c].rows, c
        for f in ("doc", "length", "nvis"):
            assert torch.equal(getattr(bk.state, f),
                               getattr(b.buckets[c].state, f)), (c, f)


@pytest.mark.parametrize("macro_k", [1, 8])
def test_fused_scan_byte_parity_all_classes(tmp_path, macro_k):
    sessions = _mixed_sessions()

    def run(kernel):
        pool = DocPool(classes=(256, 1024), slots=(6, 3), device="cpu",
                       spool_dir=str(tmp_path / f"{kernel}{macro_k}"),
                       serve_kernel=kernel)
        stats = _drain(sessions, pool, macro_k=macro_k)
        out = {s.doc_id: pool.decode(s.doc_id) for s in sessions}
        hosted = {pool.docs[s.doc_id].cls for s in sessions}
        return pool, stats, out, hosted

    fpool, sf, fused, hosted = run("fused")
    spool, ss, scan, _ = run("scan")
    assert fused == scan
    assert len([c for c in hosted if c]) >= 2
    for s in sessions:
        assert fused[s.doc_id] == replay_trace(s.trace), (
            f"doc {s.doc_id} ({s.band}) diverged from oracle")
    _same_pools(fpool, spool, sf, ss)
    fpool.close()
    spool.close()


def test_fused_scan_parity_row_tier_slicing(tmp_path):
    """64 rows, 12 docs: compaction picks the Rt = 16 tier, so the scan
    kernel takes and puts a sub-tier's rows."""
    sessions = build_fleet(12, mix={"synth-small": 1.0}, seed=9,
                           arrival_span=2, bands=TINY_BANDS)
    seen = {}

    def run(kernel):
        pool = DocPool(classes=(128,), slots=(64,), device="cpu",
                       spool_dir=str(tmp_path / kernel), serve_kernel=kernel)
        step = pool.macro_step

        def spy(cls, kind, *rest, **kw):
            seen.setdefault(kernel, set()).add(kind.shape[1])
            return step(cls, kind, *rest, **kw)

        pool.macro_step = spy
        stats = _drain(sessions, pool, macro_k=4)
        assert stats.pad_fraction < 1.0
        return pool, stats, {s.doc_id: pool.decode(s.doc_id)
                             for s in sessions}

    fpool, sf, fused = run("fused")
    spool, ss, scan = run("scan")
    assert min(seen["scan"]) < 64 and seen["scan"] == seen["fused"]
    assert fused == scan
    for s in sessions:
        assert fused[s.doc_id] == replay_trace(s.trace)
    _same_pools(fpool, spool, sf, ss)
    fpool.close()
    spool.close()


def test_scan_evict_restore_mid_macro_round(tmp_path):
    """A forced spool round trip between two dispatches of the scan
    kernel lands on the oracle's bytes."""
    traces = [synth_trace(seed=400 + i, n_ops=100) for i in range(3)]
    sessions = [Session(doc_id=i, band="synth-small", source="synth",
                        trace=t) for i, t in enumerate(traces)]
    pool = DocPool(classes=(128,), slots=(2,), device="cpu",
                   spool_dir=str(tmp_path), serve_kernel="scan")
    streams = prepare_streams(sessions, pool, batch=8, batch_chars=32)
    sched = FleetScheduler(pool, streams, batch=8, macro_k=4,
                           batch_chars=32)
    sched.run(max_rounds=1)
    victim = next(d for d, _row in pool.residents(128)
                  if streams[d].remaining > 0)
    pool.evict(victim)
    pool.admit(victim, need=pool.docs[victim].length)
    sched.run()
    for s in sessions:
        assert pool.decode(s.doc_id) == replay_trace(s.trace)
    assert pool.restores >= 1
    pool.close()


FLEET = dict(n_docs=24, mix="mixed", seed=0, arrival_span=2)
SLOTS = (16, 6, 2, 2, 2)
DRAIN = dict(batch=16, batch_chars=64)


def test_scan_drain_equals_jax_scan_drain(tmp_path):
    sessions = build_fleet(**FLEET)
    pool = DocPool(slots=SLOTS, device="cpu", serve_kernel="scan",
                   spool_dir=str(tmp_path / "port"))
    sched = FleetScheduler(pool, prepare_streams(sessions, pool, **DRAIN),
                           macro_k=4, **DRAIN)
    stats = sched.run()
    jsessions = jax_build_fleet(**FLEET)
    jpool = JaxPool(slots=SLOTS, serve_kernel="scan",
                    spool_dir=str(tmp_path / "jax"))
    jsched = JaxScheduler(jpool, jax_prepare(jsessions, jpool, **DRAIN),
                          macro_k=4, **DRAIN)
    jstats = jsched.run()
    assert sched.done and jsched.done
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(jstats, name), name
    assert stats.evictions and stats.restores and stats.promotions
    # JAX's scan kernel pads K to a power of two; the port never does
    assert stats.slices <= jstats.slices
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
    for s in sessions:
        got = pool.decode(s.doc_id)
        assert got == jpool.decode(s.doc_id) == replay_trace(s.trace)
    pool.close()
    jpool.close()


def test_serve_kernels_and_refusals():
    assert SERVE_KERNELS == ("fused", "scan")
    with pytest.raises(ValueError, match="unknown serve kernel"):
        DocPool(serve_kernel="pallas", device="cpu")
    pool = DocPool(classes=(128,), slots=(4,), device="cpu",
                   serve_kernel="scan")
    z = np.zeros((1, 5, 4), np.int8)
    with pytest.raises(ValueError, match="tier"):
        pool.macro_step(128, z, z, z, z, nbits=9)
    pool.close()
