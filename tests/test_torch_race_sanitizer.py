"""The port's race sanitizer (``crdt_benches_tpu_torch/lint/race_sanitizer.py``)
against the JAX package's (``crdt_benches_tpu/lint/race_sanitizer.py``).

A lockstep drain (``prefetch=False``: no thread picks a read) with the
status server and the journal runs in both packages with the race
sanitizer armed (JAX's by its environment variable through
``monkeypatch``, the port's by ``run_serve_bench(sanitize=("races",))``):
the ``thread_crossings`` block is equal, publish point by publish point.
A replicated drain under request tracing carries the broadcast bus's hop
(``BroadcastBus._cross_block``) into its request traces, with the same hop
counts in both packages.  The ingest front publishes on its handler
threads, and the tracker keeps only the hops entered on its own thread, so
an open drain's traces carry no ingest hop in either package while the
race sanitizer still counts every ingest publish.  The proxy's rules: an
unpublished cross-thread read raises, a published read counts against its
point, a mutation after the publish raises.  Nothing here is timed."""

import threading

import pytest

from crdt_benches_tpu.serve import bench as jbench
from crdt_benches_tpu.serve import workload as jworkload
from crdt_benches_tpu.serve.replicate import bench as jrbench
from crdt_benches_tpu_torch.lint import race_sanitizer as race
from crdt_benches_tpu_torch.serve import bench as pbench
from crdt_benches_tpu_torch.serve import workload as pworkload
from crdt_benches_tpu_torch.serve.replicate import bench as prbench

TINY = dict(mix="tiny", n_docs=16, batch=8, macro_k=4, batch_chars=32,
            classes=(128, 512), slots=(8, 4), arrival_span=2,
            verify_sample=4)


@pytest.fixture
def tiny_mix(monkeypatch):
    for mixes in (jworkload.MIXES, pworkload.MIXES):
        monkeypatch.setitem(mixes, "tiny", {"synth-small": 1.0})


def _jax(monkeypatch, run, **kw):
    monkeypatch.setenv("CRDT_BENCH_SANITIZE_RACES", "1")
    try:
        return run(log=lambda *a, **k: None, **kw)
    finally:
        monkeypatch.delenv("CRDT_BENCH_SANITIZE_RACES")


def test_thread_crossings_equal_jax_on_a_lockstep_drain(
        tmp_path, monkeypatch, tiny_mix):
    kw = dict(TINY, journal_dir="auto", snapshot_every=3, status_port=0,
              timeseries_path=None)
    r, _ = _jax(monkeypatch, jbench.run_serve_bench,
                results_dir=str(tmp_path / "jax"), **kw)
    rep = pbench.run_serve_bench(device="cpu", sanitize=("races",),
                                 log=lambda *a, **k: None, **kw)
    jt, pt = r.extra["thread_crossings"], rep["thread_crossings"]
    assert pt == jt
    assert pt["sanitized"] and pt["status"] and pt["journal"]
    assert {"StatusServer.publish_status",
            "OpJournal.round_record"} <= set(pt["publishes"])
    assert not race.armed()


def test_bus_hops_reach_request_traces_as_in_jax(tmp_path, monkeypatch,
                                                 tiny_mix):
    kw = dict(mix="tiny", n_docs=4, writers=2, batch=16, macro_k=4,
              batch_chars=64, classes=(128,), slots=(8,), arrival_span=2,
              turn_ops=8, seed=3, reqtrace_samples=64)
    r, info = _jax(monkeypatch, jrbench.run_serve_repl_bench,
                   spool_dir=str(tmp_path / "jsp"),
                   results_dir=str(tmp_path / "jax"), **kw)
    rep = prbench.run_serve_repl_bench(device="cpu", sanitize=("races",),
                                       spool_dir=str(tmp_path / "psp"),
                                       log=lambda *a, **k: None, **kw)
    hops = rep["reqtrace"]["hops"]
    assert hops.get("BroadcastBus._cross_block", 0) >= 1
    assert hops == r.extra["reqtrace"]["hops"]
    assert rep["thread_crossings"] == r.extra["thread_crossings"]
    assert rep["thread_crossings"]["bus"]


def test_ingest_publishes_are_counted_but_no_ingest_hop_is_traced(
        tmp_path, monkeypatch, tiny_mix):
    kw = dict(TINY, open_spec="64", reqtrace_samples=16)
    r, _ = _jax(monkeypatch, jbench.run_serve_bench,
                results_dir=str(tmp_path / "jax"), **kw)
    rep = pbench.run_serve_bench(device="cpu", sanitize=("races",),
                                 log=lambda *a, **k: None, **kw)
    for tc, hops in ((r.extra["thread_crossings"],
                      r.extra["reqtrace"]["hops"]),
                     (rep["thread_crossings"], rep["reqtrace"]["hops"])):
        assert tc["ingest"] and tc["publishes"]["IngestFront._publish"] > 0
        # the handler threads' publishes cross into the pump's drain
        assert tc["crossings"]["IngestFront._publish"] > 0
        assert "IngestFront._publish" not in hops


def test_the_proxy_rules():
    race.reset_counters()
    race.arm()
    try:
        box = race.share({"n": 1}, "probe")  # owner-confined until published
        err = []

        def read(obj):
            try:
                err.append(race.reveal(obj)["n"])
            except race.UndeclaredCrossThreadAccess as e:
                err.append(type(e).__name__)

        t = threading.Thread(target=read, args=(box,))
        t.start()
        t.join()
        assert err == ["UndeclaredCrossThreadAccess"]
        with race.publish_point("probe.publish"):
            box = race.share(box)
        t = threading.Thread(target=read, args=(box,))
        t.start()
        t.join()
        assert err[-1] == 1
        with pytest.raises(race.UndeclaredCrossThreadAccess, match="AFTER"):
            box["n"] = 2
        assert race.counters() == {"publishes": {"probe.publish": 1},
                                   "crossings": {"probe.publish": 1}}
    finally:
        race.disarm()
        race.reset_counters()
    plain = {"n": 1}
    assert race.share(plain) is plain and race.reveal(plain) is plain
