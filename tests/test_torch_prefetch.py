"""The port's prefetch thread (``serve/prefetch.py``) and the pool's
prefetch adoption against the JAX package's: the same payloads from the
same spool, the same bytes through the prefetch path as through the
synchronous restore in two classes, stale generations dropped, reaping by
sequence number, refusals when the queue is full, load errors carried in
the payload, and bounded stops that leave no thread behind.  Every wait on the worker polls with a
deadline, and every pool that starts a thread is closed in ``finally``."""

import threading
import time

import numpy as np
import pytest

from crdt_benches_tpu.serve.prefetch import Prefetcher as JaxPrefetcher
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import prefetch as prefetch_mod
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.prefetch import Prefetcher
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import build_fleet

#: two capacity classes hosting docs (the JAX package's tier tests' bands)
TWO_BANDS = {"synth-small": ("synth", (40, 120)),
             "synth-medium": ("synth", (300, 600))}
TWO_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
DRAIN = dict(batch=8, batch_chars=32)


def _drain_prefetcher(pf, want: int, timeout: float = 5.0) -> list[dict]:
    """Poll the non-blocking harvest until ``want`` payloads arrived or the
    deadline passed."""
    out: list[dict] = []
    t0 = time.monotonic()
    while len(out) < want and time.monotonic() - t0 < timeout:
        out.extend(pf.drain())
        time.sleep(0.005)
    return out


@pytest.fixture
def drained_pool(tmp_path):
    """Eight docs over classes 128 and 1024, drained with a warm tier and
    the prefetcher on; closed at teardown."""
    sessions = build_fleet(8, mix=TWO_MIX, seed=7, arrival_span=1,
                           bands=TWO_BANDS)
    pool = DocPool(classes=(128, 1024), slots=(8, 4), device="cpu",
                   spool_dir=str(tmp_path / "spool"), warm_docs=8)
    try:
        sched = FleetScheduler(pool, prepare_streams(sessions, pool, **DRAIN),
                               macro_k=4, **DRAIN)
        sched.run()
        assert sched.done
        yield sessions, pool
    finally:
        pool.close()


def test_prefetch_equals_the_synchronous_restore_in_two_classes(
        drained_pool):
    sessions, pool = drained_pool
    by_cls = {}
    for cls in (128, 1024):
        for d, _row in pool.residents(cls):
            by_cls.setdefault(cls, d)
    assert len(by_cls) == 2, "both classes must host docs"
    pf = pool.prefetcher
    jpf = JaxPrefetcher(capacity=8)
    jpf.start()
    try:
        for cls, doc_id in sorted(by_cls.items()):
            rec = pool.docs[doc_id]
            want = pool.decode(doc_id)
            assert want == replay_trace(sessions[doc_id].trace)
            pool.evict(doc_id)
            pool.admit(doc_id, need=rec.length)  # the synchronous restore
            got_sync = pool.decode(doc_id)
            spool = pool.evict(doc_id)
            gen = pool.spool_gen(doc_id)
            assert pf.submit(doc_id, spool, gen)
            assert jpf.submit(doc_id, spool, gen)
            (payload,) = _drain_prefetcher(pf, 1)
            (jpayload,) = _drain_prefetcher(jpf, 1)
            assert payload["error"] is None and payload["doc"] == doc_id
            for key in ("kind", "doc", "gen", "length", "nvis", "error"):
                assert payload[key] == jpayload[key], key
            np.testing.assert_array_equal(payload["row"],
                                          np.asarray(jpayload["row"]))
            # the worker hands back numpy and ints only: no tensor crosses
            assert isinstance(payload["row"], np.ndarray)
            assert all(type(payload[k]) is int
                       for k in ("seq", "doc", "gen", "length", "nvis"))
            assert pool.store_prefetched(
                payload["doc"], payload["row"], payload["length"],
                payload["nvis"], round_no=0, gen=payload["gen"])
            assert doc_id in pool.warm and rec.spool is None
            assert pool.warm.entries[doc_id].shadow == spool
            pool.admit(doc_id, need=rec.length)
            assert got_sync == pool.decode(doc_id) == want
            assert rec.cls == cls
    finally:
        jpf.stop()
    assert pool.prefetch_hits == 2
    assert pool.cold_docs == pool.recount_cold()


def test_stale_and_superseded_payloads_are_refused(drained_pool):
    _, pool = drained_pool
    doc_id = pool.residents(128)[0][0]
    rec = pool.docs[doc_id]
    spool = pool.evict(doc_id)
    gen = pool.spool_gen(doc_id)
    pf = pool.prefetcher
    assert pf.submit(doc_id, spool, gen)
    (payload,) = _drain_prefetcher(pf, 1)
    assert payload["gen"] == gen
    pool.admit(doc_id, need=rec.length)  # back to hot: refused
    assert not pool.store_prefetched(doc_id, payload["row"],
                                     payload["length"], payload["nvis"],
                                     round_no=0, gen=payload["gen"])
    pool.evict(doc_id)  # a new spool generation: stale
    assert pool.spool_gen(doc_id) == gen + 1
    assert not pool.store_prefetched(doc_id, payload["row"],
                                     payload["length"], payload["nvis"],
                                     round_no=0, gen=payload["gen"])
    assert doc_id not in pool.warm and rec.spool is not None
    pool.admit(doc_id, need=rec.length)
    other = pool.residents(128)[1][0]
    orec = pool.docs[other]
    o_doc, o_len, o_nvis = pool._pull_row(orec)
    pool._free_row(orec)
    pool.warm_deposit(other, o_doc, o_len, o_nvis)  # already warm: refused
    assert not pool.store_prefetched(other, o_doc, o_len, o_nvis,
                                     round_no=0)
    assert pool.cold_docs == pool.recount_cold()


def test_reaped_payload_is_dropped_without_a_second_decrement(tmp_path):
    path = str(tmp_path / "missing.npz")
    pf = Prefetcher(capacity=4)
    try:
        seqs = [pf.submit(d, path, 0) for d in range(3)]
        assert seqs == [1, 2, 3] and pf.inflight == 3
        pf.note_lost([seqs[0], seqs[1]])  # reaped before the worker ran
        assert pf.inflight == 1 and pf.lost == 2
        pf.start()
        got = _drain_prefetcher(pf, 1)
        deadline = time.monotonic() + 5.0
        while pf.revealed_count < 3 and time.monotonic() < deadline:
            got.extend(pf.drain())
            time.sleep(0.005)
        assert [p["seq"] for p in got] == [3]
        assert pf.reap_dropped == 2 and pf.harvested == 1
        assert pf.inflight == 0 and pf.revealed_count == 3
        assert pf.published_count == 3
        # a missing spool rides back as an error, never raised
        assert got[0]["error"].startswith("CorruptCheckpointError")
        assert got[0]["row"] is None and pf.errors == 1
        pf.note_lost([7, 8])  # reaping more than is in flight
        assert pf.inflight == 0 and pf.lost == 4
    finally:
        pf.stop()
    assert not pf.alive


def test_full_queue_refuses_without_blocking(tmp_path):
    pf = Prefetcher(capacity=1)  # clamped to 4
    assert pf.capacity == 4
    t0 = time.monotonic()
    seqs = [pf.submit(d, str(tmp_path / f"{d}.npz"), 0) for d in range(6)]
    assert time.monotonic() - t0 < 1.0
    assert seqs == [1, 2, 3, 4, 0, 0]
    assert (pf.submitted, pf.dropped, pf.inflight) == (4, 2, 4)
    pf.stop()  # never started: nothing to join
    assert not pf.alive


def test_stop_with_a_full_queue_leaves_no_thread(tmp_path, monkeypatch):
    """A stop while the worker is busy and the request queue is full: the
    queued requests are dropped (counted), the sentinel finds room, and
    the worker exits once its load ends, so no thread is left parked on
    an empty queue."""
    gate = threading.Event()
    taken = threading.Event()

    def slow_load(path):
        taken.set()
        gate.wait(10.0)
        raise FileNotFoundError(path)

    monkeypatch.setattr(prefetch_mod, "load_state", slow_load)
    pf = Prefetcher(capacity=4)
    pf.start()
    try:
        assert pf.submit(0, str(tmp_path / "0.npz"), 0)
        assert taken.wait(5.0)  # the worker holds request 1
        assert all(pf.submit(d, str(tmp_path / f"{d}.npz"), 0)
                   for d in range(1, 5))
        assert pf.submit(5, str(tmp_path / "5.npz"), 0) == 0  # full
        # the load outlasts the old one-second sentinel put
        threading.Timer(1.5, gate.set).start()
        thread = pf._thread
        pf.stop()
        thread.join(5.0)
        assert not thread.is_alive() and not pf.alive
        assert pf.dropped == 5  # one refused, four never taken
        assert (pf.submitted, pf.inflight) == (5, 1)
        assert pf.published_count == 1  # only the load in progress
    finally:
        gate.set()
        pf.stop()


def test_scheduler_harvest_leaves_errors_to_the_synchronous_restore(
        drained_pool, tmp_path):
    sessions, pool = drained_pool
    doc_id = pool.residents(128)[0][0]
    rec = pool.docs[doc_id]
    want = pool.decode(doc_id)
    spool = pool.evict(doc_id)
    pf = pool.prefetcher
    bogus = str(tmp_path / "not_a_spool.npz")
    with open(bogus, "wb") as fh:
        fh.write(b"torn")
    sched = FleetScheduler(pool, {}, macro_k=4, **DRAIN)
    assert pf.submit(doc_id, bogus, pool.spool_gen(doc_id))
    sched._prefetch_inflight[doc_id] = (0, pf._seq - 1)
    deadline = time.monotonic() + 5.0
    while pf.inflight and time.monotonic() < deadline:
        sched._harvest_prefetch()
        time.sleep(0.005)
    assert pf.inflight == 0 and pf.errors == 1
    assert not sched._prefetch_inflight and sched.prefetch_wasted == 0
    assert doc_id not in pool.warm and rec.spool == spool
    pool.admit(doc_id, need=rec.length)  # reads the spool itself
    assert pool.decode(doc_id) == want and pool.restores >= 1
