"""The port's streaming fleet construction and drained-doc record eviction
(``serve/scheduler.py LazyStreams`` and its lazy branches, genesis
residency, ``DocPool.gc_drained_docs``/``finish_torn_spool_gc``, the
prefetcher's construct kind, ``serve/construction.py``, the bench's
``stream``/``record_evict``) against the JAX package's, mirroring
``tests/test_serve_stream.py`` test by test, the record bound of
``tests/test_lifecheck.py`` and the spool GC tests of
``tests/test_reshard.py``.

Tolerance: exact.  Integers, arrays and decoded bytes are compared with no
tolerance.  Drains that are compared with JAX's run with ``prefetch=False``
on both sides; with the prefetch thread on, only the facts no thread timing
can move are held (the oracle, ``all_done``, and every materialization
counted once, on the thread or on the hot path)."""

import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np
import pytest

from crdt_benches_tpu.serve import pool as jax_pool_mod
from crdt_benches_tpu.serve.bench import run_serve_bench as jax_bench
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import LazyStreams as JaxLazy
from crdt_benches_tpu.serve.scheduler import (
    build_stream_payload as jax_payload,
)
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import FleetSpec as JaxSpec
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import construction as cons
from crdt_benches_tpu_torch.serve import pool as pool_mod
from crdt_benches_tpu_torch.serve.bench import run_serve_bench
from crdt_benches_tpu_torch.serve.construction import probe, scaling_table
from crdt_benches_tpu_torch.serve.journal import OpJournal
from crdt_benches_tpu_torch.serve.pool import SPOOL_GC_MANIFEST, DocPool
from crdt_benches_tpu_torch.serve.prefetch import Prefetcher
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    LazyStreams,
    build_stream_payload,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import FleetSpec, build_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_BANDS = {"synth-small": ("synth", (40, 120))}
TINY_MIX = {"synth-small": 1.0}
TWO_BANDS = {
    "synth-small": ("synth", (40, 120)),
    "synth-medium": ("synth", (300, 600)),
}
TWO_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
#: tests/test_lifecheck.py's record-eviction fleet
GC_BANDS = {"synth-small": ("synth", (8, 36))}
GC_MIX = {"synth-small": 1.0}
#: ServeStats fields a lazy drain shares with JAX's
STATS = ("patches", "rounds", "slices", "ops", "unit_ops", "evictions",
         "restores", "promotions", "admissions", "shed_ops", "deferred_ops",
         "backpressure_rounds")
POOL = ("evictions", "restores", "promotions", "fresh_admits", "warm_hits",
        "warm_evictions", "cold_docs", "genesis_docs")
LAZY = ("materialized", "released", "prefetch_built", "patches_total")


def _spec(n=12, seed=7, arrival_span=3, **kw):
    kw.setdefault("mix", TINY_MIX)
    kw.setdefault("bands", TINY_BANDS)
    return FleetSpec.build(n, seed=seed, arrival_span=arrival_span, **kw)


def _lazy_fleet(tmp_path, n=12, seed=7, classes=(128,), slots=(3,),
                warm_docs=0, bands=TINY_BANDS, mix=TINY_MIX, **kw):
    spec = FleetSpec.build(n, mix=mix, seed=seed, arrival_span=2,
                           bands=bands)
    pool = DocPool(classes=classes, slots=slots, device="cpu",
                   spool_dir=str(tmp_path / "lspool"), warm_docs=warm_docs)
    streams = LazyStreams(spec, pool, batch=8, batch_chars=32)
    sched = FleetScheduler(pool, streams, batch=8, macro_k=4,
                           batch_chars=32, **kw)
    return spec, pool, streams, sched


def _patches(trace):
    return [(p.pos, p.del_count, p.ins) for p in trace.iter_patches()]


def _same_trace(a, b):
    return (a.start_content == b.start_content
            and a.end_content == b.end_content
            and _patches(a) == _patches(b))


def lazy_pair(tmp_path, n, spec_kw, classes, slots, warm_docs=0, batch=8,
              batch_chars=32, macro_k=4, **kw):
    """The same ``FleetSpec`` drained lazily through both packages
    (``prefetch=False``); ``kw`` goes to both schedulers."""
    out = {}
    for side, Spec, Pool, Lazy, Sched in (
            ("jax", JaxSpec, JaxPool, JaxLazy, JaxScheduler),
            ("port", FleetSpec, DocPool, LazyStreams, FleetScheduler)):
        spec = Spec.build(n, **spec_kw)
        pkw = dict(device="cpu") if side == "port" else {}
        pool = Pool(classes=classes, slots=slots, warm_docs=warm_docs,
                    prefetch=False, spool_dir=str(tmp_path / f"{side}_sp"),
                    **pkw)
        streams = Lazy(spec, pool, batch=batch, batch_chars=batch_chars)
        sched = Sched(pool, streams, batch=batch, macro_k=macro_k,
                      batch_chars=batch_chars, **kw)
        stats = sched.run()
        out[side] = dict(spec=spec, pool=pool, streams=streams, sched=sched,
                         stats=stats)
    return out


def assert_same_lazy(d):
    """The port's lazy drain equals JAX's: counters, the lazy view's
    tallies, the doc records, every bucket, and every doc with a record
    decodes to JAX's bytes and to the oracle."""
    j, p = d["jax"], d["port"]
    for f in STATS:
        assert getattr(p["stats"], f) == getattr(j["stats"], f), f
    for f in POOL:
        assert getattr(p["pool"], f) == getattr(j["pool"], f), f
    for f in LAZY:
        assert getattr(p["streams"], f) == getattr(j["streams"], f), f
    assert p["sched"].spool_gc_docs == j["sched"].spool_gc_docs
    assert p["sched"].done and j["sched"].done
    assert ({k: (r.cls, r.row, r.length, r.spool is None)
             for k, r in p["pool"].docs.items()}
            == {k: (r.cls, r.row, r.length, r.spool is None)
                for k, r in j["pool"].docs.items()})
    for cls in j["pool"].classes:
        assert p["pool"].buckets[cls].rows == j["pool"].buckets[cls].rows
        for a, b in zip(p["pool"].pull_bucket(cls),
                        j["pool"].pull_bucket(cls)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), cls
    for doc in sorted(p["pool"].docs):
        got = p["pool"].decode(doc)
        assert got == j["pool"].decode(doc), doc
        assert got == replay_trace(p["spec"].session(doc).trace), doc


def close(d):
    for side in d.values():
        side["pool"].close()


# ---- FleetSpec: the fleet as arithmetic ----


def test_fleet_spec_matches_eager_builder_exactly():
    """Same seed, same fleet: band, arrival, source and trace of every doc
    equal the eager builder's and JAX's spec's, and the per-doc arrays
    equal JAX's."""
    n, seed = 40, 13
    spec = FleetSpec.build(n, mix=TWO_MIX, seed=seed, arrival_span=4,
                           bands=TWO_BANDS)
    jspec = JaxSpec.build(n, mix=TWO_MIX, seed=seed, arrival_span=4,
                          bands=TWO_BANDS)
    for f in ("band_of", "arrivals", "trace_ord"):
        a, b = getattr(spec, f), getattr(jspec, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    eager = build_fleet(n, mix=TWO_MIX, seed=seed, arrival_span=4,
                        bands=TWO_BANDS)
    assert len(eager) == spec.n_docs == n
    for s in eager:
        lazy, js = spec.session(s.doc_id), jspec.session(s.doc_id)
        assert (lazy.band, lazy.arrival, lazy.source) == (
            s.band, s.arrival, s.source) == (js.band, js.arrival, js.source)
        assert lazy.trace == s.trace, f"doc {s.doc_id} diverged"
        assert _same_trace(lazy.trace, js.trace), s.doc_id


def test_fleet_spec_session_is_random_access():
    """Materializing docs out of order, repeatedly, gives the same
    sessions: nothing in the spec changes on access."""
    spec = _spec(n=10, seed=3)
    a = spec.session(7)
    spec.session(2), spec.session(9)
    b = spec.session(7)
    assert a.trace == b.trace and a.arrival == b.arrival
    with pytest.raises(IndexError):
        spec.session(10)
    with pytest.raises(IndexError):
        spec.session(-1)


def test_fleet_spec_arrays_are_read_only():
    """The spec crosses into the prefetch thread inside construct
    builders, so its per-doc arrays refuse writes, as JAX's do."""
    spec = _spec(n=6)
    for name in ("band_of", "arrivals", "trace_ord"):
        a = getattr(spec, name)
        assert not a.flags.writeable, name
        with pytest.raises(ValueError):
            a[0] = 1
    jspec = JaxSpec.build(6, mix=TINY_MIX, seed=7, arrival_span=3,
                          bands=TINY_BANDS)
    assert not any(getattr(jspec, f).flags.writeable
                   for f in ("band_of", "arrivals", "trace_ord"))


def test_zipf_arrivals_in_range_and_head_heavy():
    """``arrival_dist="zipf"`` keeps every arrival in ``[0, span)``, lands
    more docs in the head round than the tail, and equals the eager
    builder's and JAX's arrivals."""
    span = 8
    spec = _spec(n=600, seed=5, arrival_span=span, arrival_dist="zipf")
    arr = spec.arrivals
    assert arr.min() >= 0 and arr.max() < span
    head = int((arr == 0).sum())
    tail = int((arr == span - 1).sum())
    assert head > tail > 0
    eager = build_fleet(600, mix=TINY_MIX, seed=5, arrival_span=span,
                        bands=TINY_BANDS, arrival_dist="zipf")
    assert [int(a) for a in arr] == [s.arrival for s in eager]
    jspec = JaxSpec.build(600, mix=TINY_MIX, seed=5, arrival_span=span,
                          bands=TINY_BANDS, arrival_dist="zipf")
    assert np.array_equal(arr, jspec.arrivals)


# ---- genesis residency ----


def test_genesis_population_drains_through_register(tmp_path):
    """Every doc starts in genesis; each first registration takes one
    off, a repeat does not."""
    pool = DocPool(classes=(128,), slots=(4,), device="cpu",
                   spool_dir=str(tmp_path / "spool"))
    chars = np.full(4, ord("a"), np.int32)
    assert pool.genesis_docs == 0  # an eager pool has none
    pool.set_genesis_population(3)
    assert pool.genesis_docs == 3
    pool.register(0, n_init=4, capacity_need=16, chars=chars)
    assert pool.genesis_docs == 2
    pool.register(0, n_init=4, capacity_need=16, chars=chars)
    assert pool.genesis_docs == 2  # a repeat is not a genesis exit
    pool.register(1, n_init=4, capacity_need=16, chars=chars)
    pool.register(2, n_init=4, capacity_need=16, chars=chars)
    assert pool.genesis_docs == 0
    assert pool.tier_status()["genesis_docs"] == 0
    jpool = JaxPool(classes=(128,), slots=(4,),
                    spool_dir=str(tmp_path / "jspool"))
    assert set(pool.tier_status()) == set(jpool.tier_status())
    pool.close(), jpool.close()


def test_lazy_streams_genesis_gauge_reaches_zero(tmp_path):
    """A lazy fleet is born all genesis; a full drain materializes every
    doc, so the count ends at zero, as JAX's does."""
    spec, pool, streams, sched = _lazy_fleet(tmp_path, n=8)
    assert pool.genesis_docs == 8
    assert streams.materialized == 0
    assert sched.stats.patches == 0  # known once the docs materialized
    sched.run()
    assert sched.done and streams.all_done
    assert pool.genesis_docs == 0
    assert streams.materialized == 8
    assert sched.stats.patches == sum(
        len(spec.session(d).trace) for d in range(8))
    pool.close()


# ---- LazyStreams mechanics ----


def test_lazy_streams_mapping_surface(tmp_path):
    spec, pool, streams, _ = _lazy_fleet(tmp_path, n=6)
    assert len(streams) == 6
    assert 5 in streams and 6 not in streams
    assert list(streams.keys()) == list(range(6))
    # get() never materializes
    assert streams.get(4) is None and streams.get(None) is None
    assert streams.materialized == 0
    st = streams[4]  # [] does
    assert st.doc_id == 4 and streams.get(4) is st
    assert streams.materialized == 1
    assert pool.genesis_docs == 5 and 4 in pool.docs
    assert dict(streams.items()) == {4: st}
    assert list(streams.values()) == [st]
    pool.close()


def test_lazy_builder_is_pure_and_matches_sync_path(tmp_path):
    """The construct callable is a ``partial`` over the pure payload
    builder; its payload equals JAX's array by array (numpy only) and
    installs a stream equal to the synchronous materialization."""
    spec, pool, streams, _ = _lazy_fleet(tmp_path, n=6)
    b = streams.builder(2)
    assert isinstance(b, partial) and b.func is build_stream_payload
    payload = b()
    jspec = JaxSpec.build(6, mix=TINY_MIX, seed=7, arrival_span=2,
                          bands=TINY_BANDS)
    want = jax_payload(jspec, 2, 32, max(pool.classes))
    assert set(payload) == set(want)
    for k, v in want.items():
        got = payload[k]
        if isinstance(v, np.ndarray):
            assert type(got) is np.ndarray, k
            assert got.dtype == v.dtype and np.array_equal(got, v), k
        else:
            assert got == v, k
    assert streams.adopt(2, payload)
    assert streams.prefetch_built == 1 and streams.materialized == 1
    sync = prepare_streams([spec.session(2)], pool, batch=8,
                           batch_chars=32)[2]
    got = streams[2]
    for f in ("kind", "pos", "rlen", "slot0", "ins_cum", "unit_cum"):
        np.testing.assert_array_equal(getattr(got, f), getattr(sync, f))
    assert (got.n_patches, got.arrival, got.burst) == (
        sync.n_patches, sync.arrival, sync.burst)
    pool.close()


def test_lazy_adopt_superseded_by_sync_materialization(tmp_path):
    """A built payload landing after the hot thread materialized the doc
    is dropped (False), not installed twice."""
    spec, pool, streams, _ = _lazy_fleet(tmp_path, n=6)
    payload = streams.builder(3)()
    st = streams[3]  # the synchronous path wins
    assert streams.adopt(3, payload) is False
    assert streams[3] is st
    assert streams.prefetch_built == 0 and streams.materialized == 1
    pool.close()


def test_lazy_release_drops_arrays_idempotently(tmp_path):
    spec, pool, streams, _ = _lazy_fleet(tmp_path, n=6)
    st = streams[1]
    assert st.kind.size > 0
    streams.release(1)
    assert st.kind.size == 0 and st.ins_cum.size == 0
    assert streams.released == 1
    streams.release(1)  # idempotent
    streams.release(5)  # never materialized: nothing to do
    assert streams.released == 1
    # the stub keeps its identity for the victim picker and fault paths
    assert streams.get(1) is st and st.remaining == 0
    pool.close()


def test_lazy_materialize_does_not_reuse_recycled_trace_ids(tmp_path):
    """Synth traces are transient on the lazy path, so each doc must
    tensorize its own stream (an id(trace) cache would be poisoned once
    CPython recycles a freed trace's id)."""
    spec, pool, streams, _ = _lazy_fleet(tmp_path, n=30, seed=11)
    for d in range(30):
        st = streams[d]  # one at a time: each trace freed before the next
        assert st.n_patches == len(spec.session(d).trace), f"doc {d}"
    pool.close()


def test_lazy_all_done_requires_full_materialization(tmp_path):
    spec, pool, streams, _ = _lazy_fleet(tmp_path, n=3)
    for d in (0, 1):
        streams[d].cursor = streams[d].n_total
    assert not streams.all_done  # doc 2 still genesis
    streams[2].cursor = streams[2].n_total
    assert streams.all_done
    pool.close()


# ---- the drains: eager against lazy, the port against JAX ----


def test_eager_vs_lazy_drain_byte_parity_under_eviction(tmp_path):
    """The same fleet drained eagerly and lazily through the port, with
    the rows oversubscribed so docs evict and restore mid-run, applies the
    same ops and ends byte-identical per doc and equal to the oracle; the
    lazy drain equals
    JAX's lazy drain of the same spec in every counter, record, bucket
    and byte."""
    n, seed = 18, 11
    kw = dict(mix=TWO_MIX, seed=seed, arrival_span=3, bands=TWO_BANDS)
    sessions = build_fleet(n, **kw)
    epool = DocPool(classes=(128, 1024), slots=(3, 2), device="cpu",
                    spool_dir=str(tmp_path / "espool"), warm_docs=2,
                    prefetch=False)
    estreams = prepare_streams(sessions, epool, batch=8, batch_chars=32)
    esched = FleetScheduler(epool, estreams, batch=8, macro_k=4,
                            batch_chars=32)
    esched.run()
    assert esched.done and epool.evictions > 0

    d = lazy_pair(tmp_path, n, kw, (128, 1024), (3, 2), warm_docs=2)
    assert_same_lazy(d)
    lpool, lsched = d["port"]["pool"], d["port"]["sched"]
    assert lpool.evictions > 0 and d["port"]["streams"].all_done
    # the plans differ (a fed rotation, released stubs as victims); the
    # work and every byte do not
    for f in ("patches", "ops", "unit_ops"):
        assert getattr(lsched.stats, f) == getattr(esched.stats, f), f
    for s in sessions:
        want = replay_trace(s.trace)
        assert epool.decode(s.doc_id) == want, f"eager doc {s.doc_id}"
        assert lpool.decode(s.doc_id) == want, f"lazy doc {s.doc_id}"
    epool.close()
    close(d)


def test_lazy_bounded_queue_drain_equals_jax(tmp_path):
    """A lazy fleet under a bounded queue (banded delivery, defer): each
    stream is born with ``delivered = cursor``, and the drain equals
    JAX's in the backpressure counters too."""
    kw = dict(mix=TWO_MIX, seed=3, arrival_span=2, bands=TWO_BANDS,
              delivery="banded")
    d = lazy_pair(tmp_path, 10, kw, (128, 1024), (3, 2), queue_cap=48)
    assert_same_lazy(d)
    assert d["port"]["stats"].deferred_ops > 0
    for doc, st in d["jax"]["streams"].items():
        pst = d["port"]["streams"].get(doc)
        assert (pst.cursor, pst.delivered, pst.deferred_high) == (
            st.cursor, st.delivered, st.deferred_high), doc
    close(d)


def test_drained_gc_drain_equals_jax_and_keeps_records_bounded(tmp_path):
    """``drained_gc`` on a lazy drain (tests/test_lifecheck.py's record
    fleet): the port reclaims the records JAX reclaims, and the records
    left at the drain's end stay under hot rows + warm budget + one GC
    batch at 3 times the fleet, while the reclaimed count grows."""
    got = {}
    for n in (12, 36):
        d = lazy_pair(tmp_path / f"n{n}", n,
                      dict(mix=GC_MIX, seed=7, arrival_span=4,
                           bands=GC_BANDS),
                      (256,), (2,), warm_docs=2, batch=16, batch_chars=64,
                      macro_k=2, drained_gc=True)
        assert_same_lazy(d)
        p = d["port"]
        assert len(p["pool"].docs) == len(d["jax"]["pool"].docs)
        assert p["streams"].released == n  # every drained stream dropped
        got[n] = (len(p["pool"].docs), p["sched"].spool_gc_docs)
        close(d)
    bound = 2 + 2 + 32  # slots + warm docs + one GC batch
    (rec_small, gc_small), (rec_big, gc_big) = got[12], got[36]
    assert gc_small > 0 and gc_big > gc_small
    assert rec_small <= bound and rec_big <= bound
    assert rec_big <= rec_small + 32


def test_drained_gc_keep_and_journal_refusal(tmp_path):
    """``gc_keep`` docs keep their records; a journaled drain refuses
    ``drained_gc`` with JAX's message."""
    spec, pool, streams, sched = _lazy_fleet(
        tmp_path, n=8, slots=(2,), drained_gc=True, gc_keep=(0, 3))
    sched.run()
    assert sched.done and sched.spool_gc_docs > 0
    assert {0, 3} <= set(pool.docs)
    for d in (0, 3):
        assert pool.decode(d) == replay_trace(spec.session(d).trace)
    pool.close()
    jdir = str(tmp_path / "j")
    with pytest.raises(ValueError) as port_err:
        _lazy_fleet(tmp_path / "p", n=2, drained_gc=True,
                    journal=OpJournal(jdir))
    jspec = JaxSpec.build(2, mix=TINY_MIX, seed=7, arrival_span=2,
                          bands=TINY_BANDS)
    jp = JaxPool(classes=(128,), slots=(3,),
                 spool_dir=str(tmp_path / "jsp"))
    from crdt_benches_tpu.serve.journal import OpJournal as JaxJournal
    with pytest.raises(ValueError) as jax_err:
        JaxScheduler(jp, JaxLazy(jspec, jp, batch=8, batch_chars=32),
                     batch=8, batch_chars=32, drained_gc=True,
                     journal=JaxJournal(str(tmp_path / "jj")))
    assert str(port_err.value) == str(jax_err.value)
    assert "journal-less" in str(port_err.value)
    jp.close()


def test_eager_record_eviction_with_the_prefetcher_drains(tmp_path):
    """An eager tiered fleet with ``drained_gc`` and the prefetch thread:
    the prefetch plan meets drained docs whose records were reclaimed and
    skips them (JAX's drain raises KeyError there, ``ROADMAP.md`` Queue
    3); every doc whose record survives equals the oracle."""
    fleet = dict(mix=GC_MIX, seed=7, arrival_span=4, bands=GC_BANDS)
    from crdt_benches_tpu.serve.workload import build_fleet as jax_fleet
    jpool = JaxPool(classes=(256,), slots=(2,), warm_docs=2,
                    spool_dir=str(tmp_path / "jsp"))
    jsched = JaxScheduler(jpool, jax_prepare(jax_fleet(36, **fleet), jpool,
                                             batch=16, batch_chars=64),
                          batch=16, macro_k=2, batch_chars=64,
                          drained_gc=True)
    with pytest.raises(KeyError):
        jsched.run()
    jpool.close()
    sessions = build_fleet(36, **fleet)
    pool = DocPool(classes=(256,), slots=(2,), warm_docs=2, device="cpu",
                   spool_dir=str(tmp_path / "sp"))
    sched = FleetScheduler(pool, prepare_streams(sessions, pool, batch=16,
                                                 batch_chars=64),
                           batch=16, macro_k=2, batch_chars=64,
                           drained_gc=True)
    sched.run()
    assert sched.done and sched.spool_gc_docs > 0
    assert len(pool.docs) + sched.spool_gc_docs == 36
    for s in sessions:
        if s.doc_id in pool.docs:
            assert pool.decode(s.doc_id) == replay_trace(s.trace)
    pool.close()


# ---- the spool GC (tests/test_reshard.py) ----


def _spool_bytes(pool):
    return sum(os.path.getsize(os.path.join(pool.spool_dir, f))
               for f in os.listdir(pool.spool_dir))


def _eager(tmp_path, n, slots, side="port"):
    fleet = dict(mix=TINY_MIX, seed=11, arrival_span=2, bands=TINY_BANDS)
    if side == "port":
        sessions = build_fleet(n, **fleet)
        pool = DocPool(classes=(128,), slots=slots, device="cpu",
                       spool_dir=str(tmp_path / "spool"))
        streams = prepare_streams(sessions, pool, batch=8, batch_chars=32)
        return sessions, pool, FleetScheduler(pool, streams, batch=8,
                                              macro_k=4, batch_chars=32)
    from crdt_benches_tpu.serve.workload import build_fleet as jax_fleet
    sessions = jax_fleet(n, **fleet)
    pool = JaxPool(classes=(128,), slots=slots,
                   spool_dir=str(tmp_path / "jspool"))
    streams = jax_prepare(sessions, pool, batch=8, batch_chars=32)
    return sessions, pool, JaxScheduler(pool, streams, batch=8, macro_k=4,
                                        batch_chars=32)


def test_gc_drained_docs_reclaims_spool_bytes(tmp_path):
    """A drained doc's whole footprint (its record and its spool file) is
    reclaimed, in spool-directory bytes, as JAX reclaims it."""
    out = {}
    for side in ("port", "jax"):
        sessions, pool, sched = _eager(tmp_path, 5, (2,), side)
        sched.run()
        assert sched.done
        cold = [d for d, r in pool.docs.items() if r.cls is None]
        assert cold, "expected evicted docs in an oversubscribed drain"
        before = _spool_bytes(pool)
        assert before > 0
        n = pool.gc_drained_docs(cold)
        out[side] = (sorted(cold), n, before, _spool_bytes(pool),
                     sorted(pool.docs), sorted(os.listdir(pool.spool_dir)))
        assert n == len(cold)
        assert out[side][3] < before
        for d in cold:
            assert d not in pool.docs
            assert not os.path.exists(os.path.join(pool.spool_dir,
                                                   f"doc{d}.npz"))
        # a second pass has nothing to do
        assert pool.gc_drained_docs(cold) == 0
        assert not os.path.exists(os.path.join(pool.spool_dir,
                                               SPOOL_GC_MANIFEST))
        if side == "port":
            for s in sessions:
                if s.doc_id in pool.docs:
                    assert pool.decode(s.doc_id) == replay_trace(s.trace)
            assert pool.cold_docs == 0
        pool.close()
    assert out["port"] == out["jax"]


def test_gc_skips_resident_docs(tmp_path):
    sessions, pool, sched = _eager(tmp_path, 2, (4,))
    sched.run(max_rounds=3)
    resident = [d for d, r in pool.docs.items() if r.cls is not None]
    assert resident
    assert pool.gc_drained_docs(resident) == 0
    assert pool.gc_drained_docs([999]) == 0  # unknown ids too
    for d in resident:
        assert d in pool.docs
    pool.close()


def test_gc_reclaims_warm_entries_and_their_shadows(tmp_path):
    """A warm doc's entry goes with its record, and its shadow file (the
    same bytes on disk) goes with its spool, as in JAX."""
    out = {}
    for side, Pool, kw in (("port", DocPool, dict(device="cpu")),
                           ("jax", JaxPool, {})):
        pool = Pool(classes=(128,), slots=(2,), warm_docs=4, prefetch=False,
                    spool_dir=str(tmp_path / f"{side}_sp"), **kw)
        chars = np.full(8, ord("x"), np.int32)
        for d in (1, 2):
            pool.register(d, n_init=4, capacity_need=8, chars=chars)
            pool.warm_deposit(d, np.full(8, 2, np.int32), 0, 0)
        shadow = pool.ensure_warm_shadow(1)
        assert os.path.exists(shadow)
        assert pool.gc_drained_docs([1, 2]) == 2
        out[side] = (len(pool.warm), sorted(pool.docs),
                     sorted(os.listdir(pool.spool_dir)))
        pool.close()
    assert out["port"] == out["jax"] == (0, [], [])


def _torn_dir(sp, staged=False):
    """A spool directory a crash left mid-GC: two members, one named by a
    committed manifest (or by a staged ``.tmp`` when ``staged``)."""
    os.makedirs(sp)
    with open(os.path.join(sp, "doc42.npz"), "wb") as f:
        f.write(b"x" * 512)
    with open(os.path.join(sp, "doc7.npz"), "wb") as f:
        f.write(b"y" * 512)
    name = SPOOL_GC_MANIFEST + (".tmp" if staged else "")
    with open(os.path.join(sp, name), "w") as f:
        json.dump({"version": 1, "members": ["doc42.npz"]}, f)


def test_finish_torn_spool_gc_completes_committed_manifest(tmp_path):
    """A committed manifest is finished by the next pool on the directory
    before any member is read: the named member goes, the others stay."""
    sp = str(tmp_path / "spool")
    _torn_dir(sp)
    pool = DocPool(classes=(128,), slots=(2,), device="cpu", spool_dir=sp)
    assert sorted(os.listdir(sp)) == ["doc7.npz"]
    assert pool.finish_torn_spool_gc() == 0
    pool.close()


def test_finish_torn_spool_gc_rolls_back_tmp(tmp_path):
    """A staged ``.tmp`` never committed: it rolls back, no member goes."""
    sp = str(tmp_path / "spool")
    _torn_dir(sp, staged=True)
    pool = DocPool(classes=(128,), slots=(2,), device="cpu", spool_dir=sp)
    assert sorted(os.listdir(sp)) == ["doc42.npz", "doc7.npz"]
    assert pool.finish_torn_spool_gc() == 0
    pool.close()


def _torn_by(pool, victims, monkeypatch, mod):
    """``gc_drained_docs`` on ``pool`` killed right after its commit point
    (the manifest replaced in, before any unlink): the torn directory."""
    real = os.replace

    class _Crash(Exception):
        pass

    def replace(src, dst):
        real(src, dst)
        if dst.endswith(SPOOL_GC_MANIFEST):
            raise _Crash

    monkeypatch.setattr(mod.os, "replace", replace)
    with pytest.raises(_Crash):
        pool.gc_drained_docs(victims)
    monkeypatch.setattr(mod.os, "replace", real)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_spool_gc_completes_across_packages(tmp_path, monkeypatch,
                                                 writer):
    """A pass torn in one package (manifest committed, no member unlinked)
    is completed by the other package's pool constructor: the manifests
    carry the same bytes, and the members both passes name are gone."""
    manifests = {}
    for side in ("jax", "port"):
        _s, pool, sched = _eager(tmp_path / side, 5, (2,), side)
        sched.run()
        cold = sorted(d for d, r in pool.docs.items() if r.cls is None)
        mod = jax_pool_mod if side == "jax" else pool_mod
        _torn_by(pool, cold, monkeypatch, mod)
        with open(os.path.join(pool.spool_dir, SPOOL_GC_MANIFEST),
                  "rb") as f:
            manifests[side] = (f.read(), pool.spool_dir,
                               sorted(os.listdir(pool.spool_dir)), cold)
        pool._owns_spool = False
        pool.close()
    assert manifests["jax"][0] == manifests["port"][0]
    data, sp, before, cold = manifests[writer]
    assert SPOOL_GC_MANIFEST in before
    reader = (DocPool(classes=(128,), slots=(2,), device="cpu",
                      spool_dir=sp) if writer == "jax"
              else JaxPool(classes=(128,), slots=(2,), spool_dir=sp))
    left = sorted(os.listdir(sp))
    assert SPOOL_GC_MANIFEST not in left
    assert not any(f"doc{d}.npz" in left for d in cold)
    assert left == sorted(f for f in before if f != SPOOL_GC_MANIFEST
                          and f not in json.loads(data)["members"])
    reader.close()


# ---- the prefetcher's construct kind ----


def test_prefetch_inflight_never_underflows_after_reap(tmp_path):
    """A construct submission reaped by ``note_lost`` whose payload lands
    later is dropped without a second ``inflight`` decrement."""
    pf = Prefetcher(capacity=4)
    pf.start()
    try:
        spec = _spec(n=4, seed=1)
        pool = DocPool(classes=(128,), slots=(4,), device="cpu",
                       spool_dir=str(tmp_path / "sp"))
        streams = LazyStreams(spec, pool, batch=8, batch_chars=32)
        seqs = [pf.submit_construct(d, streams.builder(d))
                for d in range(3)]
        assert all(seqs) and pf.inflight == 3
        pf.note_lost([seqs[0]])  # the scheduler reaps one
        assert pf.inflight == 2
        harvested = []
        deadline = time.monotonic() + 30
        while len(harvested) + pf.reap_dropped < 3:
            assert time.monotonic() < deadline
            harvested.extend(pf.drain())
            time.sleep(0.01)
        assert pf.reap_dropped == 1
        assert {p["doc"] for p in harvested} == {1, 2}
        assert all(p["kind"] == "construct" and p["error"] is None
                   for p in harvested)
        assert pf.inflight == 0
        for p in harvested:
            assert streams.adopt(p["doc"], p)
        assert streams.prefetch_built == 2
        pool.close()
    finally:
        pf.stop()


def test_construct_builder_error_comes_back_as_payload():
    """A builder that raises comes back as an error payload (the hot
    thread then materializes the doc itself), never kills the thread."""
    pf = Prefetcher(capacity=4)
    pf.start()
    try:
        def boom():
            raise RuntimeError("no trace")

        seq = pf.submit_construct(5, boom)
        ok = pf.submit_construct(6, lambda: {"x": np.zeros(2)})
        out = []
        deadline = time.monotonic() + 30
        while len(out) < 2:
            assert time.monotonic() < deadline
            out.extend(pf.drain())
            time.sleep(0.01)
        by = {p["seq"]: p for p in out}
        assert by[seq]["error"] == "RuntimeError: no trace"
        assert by[seq]["kind"] == "construct" and by[seq]["doc"] == 5
        assert by[ok]["error"] is None and by[ok]["doc"] == 6
        assert pf.errors == 1 and pf.inflight == 0 and pf.alive
    finally:
        pf.stop()


def test_prefetch_drain_holds_the_timing_free_facts(tmp_path):
    """A lazy tiered drain with the prefetch thread on: every doc equals
    the oracle, the view is all done, and each doc materialized exactly
    once, on the thread or on the hot path."""
    spec, pool, streams, sched = _lazy_fleet(
        tmp_path, n=24, seed=5, classes=(128, 1024), slots=(3, 2),
        warm_docs=4, bands=TWO_BANDS, mix=TWO_MIX)
    assert pool.prefetcher is not None
    built = {"sync": 0}
    real = streams._materialize

    def counted(s):
        built["sync"] += 1
        return real(s)

    streams._materialize = counted
    sched.run()
    assert sched.done and streams.all_done
    assert streams.materialized == spec.n_docs == len(pool.docs)
    assert streams.prefetch_built + built["sync"] == streams.materialized
    assert pool.genesis_docs == 0
    assert pool.prefetcher.errors == 0
    for d in range(spec.n_docs):
        assert pool.decode(d) == replay_trace(spec.session(d).trace), d
    pool.close()


# ---- construction accounting: probe, scaling table, the bench ----


def test_construction_probe_both_modes():
    kw = dict(mix=TINY_MIX, seed=0, arrival_span=2, classes=(4096,),
              slots=(8,), device="cpu")
    stream = probe(32, **kw)
    assert stream["mode"] == "stream" and stream["n_docs"] == 32
    assert stream["construction_ms"] > 0
    assert stream["genesis_docs"] == 32  # nothing materialized
    eager = probe(32, stream=False, **kw)
    assert eager["mode"] == "eager" and eager["genesis_docs"] == 0
    assert eager["peak_rss_bytes"] > 0 and eager["rss_before_bytes"] > 0
    assert set(stream) == set(eager) == {
        "n_docs", "mode", "construction_ms", "rss_before_bytes",
        "rss_after_bytes", "peak_rss_bytes", "genesis_docs"}
    tiered = probe(16, serve_tiers="hot=2,warm=4", **kw)
    assert tiered["genesis_docs"] == 16


def test_scaling_table_rows_and_eager_limit(monkeypatch):
    """One fresh cell per (size, mode), the device passed as a flag, eager
    rows capped at ``eager_limit``, failures and timeouts error rows."""
    import subprocess as sp
    calls = []

    class _Out:
        def __init__(self, payload, rc=0, err=""):
            self.stdout = json.dumps(payload)
            self.returncode = rc
            self.stderr = err

    def fake_run(cmd, **kw):
        n = int(cmd[cmd.index("--n-docs") + 1])
        mode = cmd[cmd.index("--mode") + 1]
        calls.append((n, mode, cmd[cmd.index("--device") + 1]))
        assert "crdt_benches_tpu_torch.serve.construction" in cmd
        if n == 64 and mode == "eager":
            raise sp.TimeoutExpired(cmd, kw.get("timeout", 0))
        if n == 256:
            return _Out({}, rc=1, err="boom")
        return _Out({"n_docs": n, "mode": mode, "construction_ms": 1.0,
                     "rss_before_bytes": 1, "rss_after_bytes": 2,
                     "peak_rss_bytes": 3, "genesis_docs": 0})

    monkeypatch.setattr(sp, "run", fake_run)
    rows = scaling_table([64, 16, 256, 16], eager_limit=64, device="cpu",
                         log=lambda *_: None)
    assert calls == [(16, "stream", "cpu"), (16, "eager", "cpu"),
                     (64, "stream", "cpu"), (64, "eager", "cpu"),
                     (256, "stream", "cpu")]
    by = {(r["n_docs"], r["mode"]): r for r in rows}
    assert "timeout" in by[(64, "eager")]["error"]
    assert by[(256, "stream")]["error"] == "boom"
    assert by[(16, "stream")]["construction_ms"] == 1.0
    calls.clear()
    scaling_table([8], eager_limit=0, log=lambda *_: None)
    assert calls == [(8, "stream", "cuda")]  # the card by default


def test_construction_cli_runs_one_cell():
    """The module's CLI is a table cell: one JSON line of a probe."""
    out = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.serve.construction",
         "--n-docs", "64", "--mode", "stream", "--device", "cpu",
         "--arrival-span", "4"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert (row["n_docs"], row["mode"], row["genesis_docs"]) == (
        64, "stream", 64)
    assert cons._ROOT == REPO


def test_peak_rss_is_the_cells_own():
    """A table cell's peak RSS is its own: a cell that ``run_fresh``
    starts from a process holding 256 MiB reports far less (Linux folds
    the spawning process's peak into a child's ``ru_maxrss`` at exec, so
    the cell is started by a small launcher), and a cell past its time
    limit is killed and reported."""
    held = bytearray(256 * 2**20)
    held[::4096] = b"x" * len(held[::4096])  # touch every page
    out = cons.run_fresh(
        [sys.executable, "-c",
         "from crdt_benches_tpu_torch.serve.construction import *; "
         "print(peak_rss_bytes(), current_rss_bytes())"], timeout=300)
    assert out.returncode == 0, out.stderr
    peak, now = map(int, out.stdout.split())
    assert 0 < now < 200 * 2**20 and 0 < peak < 200 * 2**20
    del held
    late = cons.run_fresh([sys.executable, "-c",
                           "import time; time.sleep(60)"], timeout=1)
    assert late.returncode != 0 and "timed out" in late.stderr


BENCH = dict(mix=TINY_MIX, batch=8, classes=(128,), slots=(4,), seed=5,
             arrival_span=2, bands=TINY_BANDS, macro_k=4, batch_chars=32,
             log=lambda *_: None)


def _jax_extra(tmp_path, name, **kw):
    _, info = jax_bench(**BENCH, **kw, spool_dir=str(tmp_path / f"{name}_sp"),
                        results_dir=str(tmp_path / f"{name}_r"))
    with open(info["path"]) as f:
        (d,) = json.load(f)
    return info, d["extra"]


def test_bench_artifact_construction_block_stream(tmp_path):
    """A streamed serve run: verify green, and the ``construction`` block
    has JAX's keys with JAX's values for everything but time and memory,
    and the sample JAX's artifact names."""
    rep = run_serve_bench(**BENCH, n_docs=10, verify_sample=4, stream=True,
                          device="cpu")
    info, jex = _jax_extra(tmp_path, "s", n_docs=10, verify_sample=4,
                           stream=True)
    assert rep["verify_ok"] and info["verify_ok"]
    c, jc = rep["construction"], jex["construction"]
    assert set(jc) <= set(c)
    assert c["mode"] == "stream" and c["version"] == 1
    assert c["construction_ms"] > 0 and c["peak_rss_bytes"] > 0
    assert c["rss_after_construction_bytes"] > 0
    assert c["fleet_docs"] == 10 == c["materialized_docs"]
    assert c["genesis_docs_end"] == 0 and c["scaling"] is None
    for k in ("mode", "fleet_docs", "materialized_docs", "released_docs",
              "prefetch_built", "genesis_docs_end", "verify_sample_seed",
              "scaling", "version"):
        assert c[k] == jc[k], k
    ids = jex["verified_docs"]
    assert rep["verified_docs"] == c["verified_docs"] == len(ids) == 4
    rng = np.random.default_rng(c["verify_sample_seed"])
    assert ids == sorted(int(x) for x in rng.choice(list(range(10)), size=4,
                                                    replace=False))
    for k in ("rounds", "range_ops", "evictions", "restores", "promotions"):
        assert rep[k] == jex[k], k


def test_bench_stream_rejects_incompatible_modes(tmp_path):
    """The streaming refusals, with JAX's messages."""
    kw = dict(BENCH, n_docs=4, stream=True)
    cases = (dict(journal_dir=str(tmp_path / "j")),
             dict(longhaul=4, measure_recovery=True,
                  journal_dir=str(tmp_path / "j2")),
             dict(measure_recovery=True, journal_dir=str(tmp_path / "j3")))
    for extra in cases:
        with pytest.raises(ValueError) as port_err:
            run_serve_bench(**kw, **extra, device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jax_bench(**kw, **extra, results_dir=str(tmp_path / "r"))
        assert str(port_err.value) == str(jax_err.value), extra
    with pytest.raises(ValueError, match="journal"):
        run_serve_bench(**kw, journal_dir=str(tmp_path / "j"), device="cpu")
    with pytest.raises(ValueError, match="longhaul|durability"):
        run_serve_bench(**kw, longhaul=4, measure_recovery=True,
                        device="cpu")


def test_bench_artifact_construction_block_eager(tmp_path):
    """The block is always there: an eager run carries ``mode="eager"``,
    with JAX's values."""
    rep = run_serve_bench(**BENCH, n_docs=6, verify_sample=2, device="cpu")
    _, jex = _jax_extra(tmp_path, "e", n_docs=6, verify_sample=2)
    c, jc = rep["construction"], jex["construction"]
    assert set(jc) <= set(c)
    assert c["mode"] == "eager"
    assert c["fleet_docs"] == 6 and c["genesis_docs_end"] == 0
    for k in ("mode", "fleet_docs", "materialized_docs", "released_docs",
              "prefetch_built", "genesis_docs_end", "verify_sample_seed"):
        assert c[k] == jc[k], k
    assert c["spool_gc_docs"] == 0 and c["records_end"] == 6


def test_bench_stream_record_evict_verifies_the_surviving_records(tmp_path):
    """A streamed, tiered drain with record eviction through the bench:
    the reclaimed docs have no record, the verify covers every surviving
    one (all equal the oracle) and the block says how many."""
    rep = run_serve_bench(**dict(BENCH, mix=GC_MIX, bands=GC_BANDS,
                                 classes=(256,), slots=(2,), batch=16,
                                 batch_chars=64, macro_k=2,
                                 arrival_span=4),
                          n_docs=36, stream=True,
                          record_evict=True, device="cpu")
    c = rep["construction"]
    assert rep["verify_ok"]
    assert c["spool_gc_docs"] > 0
    assert c["records_end"] + c["spool_gc_docs"] == 36
    assert rep["verified_docs"] == c["verified_docs"] == c["records_end"]
    assert c["released_docs"] == 36 == c["materialized_docs"]


def test_bench_entry_stream_flags_and_refusals(tmp_path):
    """``--serve-stream`` drains through the entry point; record eviction
    with a journal and a bad scaling size list exit 2, as JAX's runner
    does."""
    from crdt_benches_tpu_torch.bench.__main__ import main

    small = ["--group", "serve", "--device", "cpu", "--serve-docs", "6",
             "--serve-batch", "16", "--serve-macro", "4",
             "--serve-batch-chars", "64", "--serve-slots", "16,6,2,2,2",
             "--serve-arrival-span", "2"]
    assert main(small + ["--serve-record-evict", "--serve-journal",
                         str(tmp_path / "j")]) == 2
    assert main(small + ["--serve-stream-scaling", "8,x"]) == 2
    assert main(small + ["--serve-stream", "--serve-record-evict"]) == 0
    with pytest.raises(SystemExit):
        main(["--group", "replay", "--serve-stream"])
