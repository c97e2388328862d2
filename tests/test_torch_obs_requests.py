"""The port's request-scoped telemetry (``obs/reqtrace.py``,
``obs/slo.py``, ``obs/flight.py``) and the serve bench's telemetry flags,
against the JAX package's.

The SLO grammar accepts and rejects the specs JAX's does, and burn rates
and compliance are equal on the same request sequence; a disarmed
tracker is the admission-timestamp table; a re-admission opens a fresh
episode; exemplars agree with their histogram buckets; the flight
recorder dumps atomically and each package's validator accepts the
other's dumps.  The port has no race sanitizer, so a port drain records
no publish hops; ``_on_publish`` is held directly."""

import json
import os
import time
from bisect import bisect_left
from pathlib import Path

import pytest

from crdt_benches_tpu.obs import flight as jax_flight
from crdt_benches_tpu.obs import reqtrace as jax_reqtrace
from crdt_benches_tpu.obs import slo as jax_slo
from crdt_benches_tpu_torch.obs.anomaly import AnomalyDetector
from crdt_benches_tpu_torch.obs.flight import (
    FlightRecorder,
    validate_flight,
    validate_flight_file,
)
from crdt_benches_tpu_torch.obs.flight import main as flight_main
from crdt_benches_tpu_torch.obs.reqtrace import (
    NOOP_SEGMENT,
    SEGMENTS,
    RequestTracker,
)
from crdt_benches_tpu_torch.obs.slo import (
    SloSpecError,
    SloTracker,
    parse_slo_spec,
)
from crdt_benches_tpu_torch.obs.timeseries import ServeTelemetry
from crdt_benches_tpu_torch.obs.trace import NOOP_SPAN
from crdt_benches_tpu_torch.serve import bench as serve_bench
from crdt_benches_tpu_torch.serve.bench import run_serve_bench
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import build_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_BANDS = {"synth-small": ("synth", (40, 120))}
TINY_MIX = {"synth-small": 1.0}
#: the run_serve_bench keywords of a tiny CPU drain
TINY = dict(mix=TINY_MIX, bands=TINY_BANDS, n_docs=8, batch=16,
            classes=(128,), slots=(4,), seed=2, arrival_span=2, macro_k=4,
            batch_chars=32, device="cpu", log=lambda *_: None)


def _fleet(tmp_path, n=8, **kw):
    pool = DocPool(classes=(128,), slots=(4,), device="cpu",
                   spool_dir=str(tmp_path / "spool"))
    streams = prepare_streams(
        build_fleet(n, mix=TINY_MIX, seed=11, arrival_span=2,
                    bands=TINY_BANDS), pool, batch=8, batch_chars=32)
    return pool, FleetScheduler(pool, streams, batch=8, macro_k=4,
                                batch_chars=32, **kw)


# ---------------------------------------------------------------------------
# the --serve-slo grammar and the burn-rate math, against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "default=p99:250,c4096=p99.9:1500", " default=p90:10 , ",
    "c256=p99:100", "default=p50:0.5",
])
def test_slo_grammar_accepts_what_jax_accepts(spec):
    ours, theirs = parse_slo_spec(spec), jax_slo.parse_slo_spec(spec)
    assert {k: v.to_dict() for k, v in ours.items()} == {
        k: v.to_dict() for k, v in theirs.items()}
    assert all(o.budget == theirs[k].budget for k, o in ours.items())


@pytest.mark.parametrize("bad", [
    "", "default", "default=99:250", "default=p99", "default=pXX:250",
    "default=p0:250", "default=p100:250", "default=p99:-5",
    "default=p99:nan", "default=p99:inf", "default=pnan:250", "=p99:250",
    "default=p99:250,default=p95:100",
])
def test_slo_grammar_rejects_what_jax_rejects(bad):
    with pytest.raises(jax_slo.SloSpecError):
        jax_slo.parse_slo_spec(bad)
    with pytest.raises(SloSpecError):
        parse_slo_spec(bad)


def _requests(slo):
    """One request sequence: 60 compliant, a spike of 16 violations, 8
    dropped, an unclassified one, then a mix."""
    for _ in range(60):
        slo.note_request("default", 0.010, doc_id=0)
    for i in range(16):
        slo.note_request("default", 0.500, doc_id=1 + i,
                         segments={"queue": 0.1 * i})
    for i in range(8):
        slo.note_request("c4096", 0.001, doc_id=20 + i, dropped=i % 2 == 0)
    slo.note_request("c9999", 0.001, doc_id=99)
    for i in range(600):
        slo.note_request("default" if i % 3 else "c4096",
                         0.05 * (i % 7), doc_id=100 + i)
    return slo


def test_burn_rates_and_compliance_equal_jax():
    spec = "default=p90:100,c4096=p99:200"
    ours = _requests(SloTracker.from_spec(spec, top_k=4))
    theirs = _requests(jax_slo.SloTracker.from_spec(spec, top_k=4))
    assert ours.block() == theirs.block()
    assert ours.status_fields() == theirs.status_fields()
    slo = SloTracker.from_spec("default=p90:100")  # a 10% budget
    for _ in range(60):
        slo.note_request("default", 0.010, doc_id=0)
    assert slo.classes["default"].compliance == 1.0
    for _ in range(16):
        slo.note_request("default", 0.500, doc_id=1)
    d = slo.classes["default"].to_dict()
    # the spike reads hotter on the fast window (64) than the slow (512)
    assert d["burn_rate_fast"] == pytest.approx((16 / 64) / 0.10)
    assert d["burn_rate_slow"] == pytest.approx((16 / 76) / 0.10)
    for cls, want in ((4096, "c4096"), (256, "default"), (None, "default")):
        assert ours.classify(cls) == theirs.classify(cls) == want
    named = SloTracker.from_spec("c256=p99:100")
    assert named.classify(1024) == "c1024"


# ---------------------------------------------------------------------------
# the request tracker
# ---------------------------------------------------------------------------


def test_disarmed_tracker_is_the_timestamp_table():
    rt = RequestTracker()
    assert not rt.armed
    assert rt.segment("plan") is NOOP_SEGMENT is NOOP_SPAN
    with rt.segment("dispatch"):
        pass
    rt.open_request(7, 0, cap_cls=128)
    rt.round_begin()
    rt.fold_round(0, [(7, 5)])
    dt = rt.close_request(7, "ok")
    assert dt is not None and dt >= 0
    assert rt.close_request(7, "ok") is None
    assert rt.requests_opened == 0 and rt.sampled() == [] and not rt._active
    rt.release()


def _episodes(mod):
    rt = mod.RequestTracker(samples=4)
    try:
        rt.open_request(3, 0, cap_cls=128)
        rt.open_request(3, 1, cap_cls=128)  # already active: no-op
        time.sleep(0.01)
        dt1 = rt.close_request(3, "quarantined", round_no=2)
        assert rt.close_request(3, "quarantined") is None
        t_re = time.perf_counter()
        rt.open_request(3, 5, cap_cls=128)
        assert rt._active[3].admit_t >= t_re
        dt2 = rt.close_request(3, "ok", round_no=6)
        assert dt2 < dt1
        return [{k: v for k, v in t.items() if k not in ("latency_s",
                                                         "segments")}
                for t in rt.sampled()], (rt.requests_opened,
                                         rt.requests_closed, rt.reopened)
    finally:
        rt.release()


def test_readmission_opens_a_fresh_episode_as_jax_does():
    ours, theirs = _episodes(
        __import__("crdt_benches_tpu_torch.obs.reqtrace", fromlist=["x"])), \
        _episodes(jax_reqtrace)
    assert ours == theirs
    traces, (opened, closed, reopened) = ours
    assert [t["episode"] for t in traces] == [1, 2]
    assert [t["cause"] for t in traces] == ["quarantined", "ok"]
    assert (opened, closed, reopened) == (2, 2, 1)


def test_scheduler_observes_each_episode_once(tmp_path):
    rt = RequestTracker(samples=8)
    pool, sched = _fleet(tmp_path, reqtrace=rt)
    try:
        doc = next(iter(sched.streams))
        st = sched.streams[doc]
        rt.open_request(doc, 0, cap_cls=128)
        sched._note_doc_drained(st, tag="quarantined")
        sched._note_doc_drained(st, tag="quarantined")  # no double count
        h_q = sched.stats.doc_latency["quarantined"]
        assert h_q.count == 1 and rt.requests_closed == 1
        rt.open_request(doc, 3, cap_cls=128)
        sched._note_doc_drained(st, tag="ok")
        assert sched.stats.doc_latency["ok"].count == 1
        assert rt.requests_closed == 2 and rt.reopened == 1
        assert sum(h.count for h in sched.stats.doc_latency.values()) == 2
    finally:
        pool.close()


def test_dropped_requests_burn_error_budget():
    slo = SloTracker.from_spec("default=p90:60000")
    rt = RequestTracker(samples=8, slo=slo)
    for doc, cause in ((1, "ok"), (2, "shed"), (3, "quarantined"),
                       (4, "deferred")):
        rt.open_request(doc, 0)
        rt.close_request(doc, cause, round_no=1)
    st = slo.classes["default"]
    assert st.requests == 4 and st.violations == 2
    assert slo.block()["classes"]["default"]["compliance"] == 0.5


def test_publish_hops_attach_only_to_scheduled_docs():
    """``_on_publish`` (the observer the JAX race sanitizer calls; the
    port's drains never call it): hops scope to the round's lane set, and
    a trailing publish joins the prior lane set's open requests."""
    out = []
    for mod in (__import__("crdt_benches_tpu_torch.obs.reqtrace",
                           fromlist=["x"]), jax_reqtrace):
        rt = mod.RequestTracker(samples=8)
        try:
            rt.open_request(1, 0, cap_cls=128)
            rt.open_request(2, 0, cap_cls=128)
            rt.round_begin()
            rt.note_scheduled([1])
            rt._on_publish("OpJournal.round_record")
            rt.close_request(2, "quarantined", round_no=0)
            rt._on_publish("StatusServer.publish_status")
            rt.round_begin()
            rt.close_request(1, "ok", round_no=1)
            out.append({t["doc"]: t["hops"] for t in rt.sampled()})
        finally:
            rt.release()
    assert out[0] == out[1] == {
        1: ["OpJournal.round_record", "StatusServer.publish_status"],
        2: []}


def test_armed_drain_traces_requests_and_exemplars(tmp_path):
    slo = SloTracker.from_spec("default=p99:60000")
    rt = RequestTracker(samples=64, slo=slo)
    pool, sched = _fleet(tmp_path, reqtrace=rt, slo=slo)
    try:
        stats = sched.run()
        assert sched.done
        n = len(sched.streams)
        assert rt.requests_opened == rt.requests_closed == n
        traces = rt.sampled()
        assert len(traces) == n and not rt._active
        for t in traces:
            assert t["cause"] == "ok" and t["rounds"] >= 1 and t["ops"] >= 1
            assert set(t["segments"]) <= set(SEGMENTS)
            assert sum(t["segments"].values()) > 0
            assert t["hops"] == []  # no race sanitizer: no hops
        assert sum(t["ops"] for t in traces) == stats.ops
        blk = slo.block()["classes"]["default"]
        assert blk["requests"] == n and blk["compliance"] == 1.0
        assert rt.exemplars
        for tag, buckets in rt.exemplars.items():
            h = stats.doc_latency[tag]
            for i, ex in buckets.items():
                assert bisect_left(h.bounds, float(ex["latency_s"])) == i
                assert h.counts[i] >= 1
        rb = json.loads(json.dumps(rt.block()))
        assert rb["version"] == 1 and rb["armed"] is True
        assert all(isinstance(k, str) for b in rb["exemplars"].values()
                   for k in b)
        assert sched.status_fields()["slo"]["classes"]["default"][
            "requests"] == n
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def test_flight_dump_round_trip_and_cross_validation(tmp_path, capsys):
    path = str(tmp_path / "flight.json")
    rec = FlightRecorder(path, ring=4)
    for i in range(10):
        rec.note_round({"round": i, "seconds": 0.01})
    rec.note_event("snapshot", round=3)
    rec.trigger("anomaly:stuck_round",
                requests=[{"doc": 3, "request": 0, "segments": {}}],
                anomalies=["stuck_round"])
    assert validate_flight_file(path) == []
    assert jax_flight.validate_flight_file(path) == []
    d = json.load(open(path))
    assert d["dump_index"] == 1 and d["metrics"] is None
    assert [r["round"] for r in d["rounds"]] == [6, 7, 8, 9]
    assert d["events"] == [{"kind": "snapshot", "round": 3}]
    rec.note_round({"round": 10, "seconds": 0.5})
    rec.trigger("unrecovered_fault")
    d2 = json.load(open(path))
    assert d2["dump_index"] == 2 and d2["reasons"] == [
        "anomaly:stuck_round", "unrecovered_fault"]
    assert rec.summary()["dumps"] == 2 and not os.path.exists(path + ".tmp")
    assert flight_main([path]) == 0 and "valid flight dump" in (
        capsys.readouterr().out)
    assert flight_main([]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert flight_main([str(bad)]) == 1
    jpath = str(tmp_path / "jax_flight.json")
    jrec = jax_flight.FlightRecorder(jpath)
    jrec.note_round({"round": 0, "seconds": 0.1})
    jrec.trigger("crash: RuntimeError: x", requests=[{"doc": 1}])
    assert validate_flight_file(jpath) == []


def test_flight_dump_is_best_effort(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    rec = FlightRecorder(str(blocker / "flight.json"))
    rec.note_round({"round": 0, "seconds": 0.1})
    rec.trigger("anomaly:stuck_round")  # must not raise
    s = rec.summary()
    assert s["dumps"] == 0 and s["dump_failures"] == 1 and s["last_error"]
    ok = FlightRecorder(str(tmp_path / "flight.json"))
    ok.note_round({"round": 0, "seconds": 0.1})
    ok.trigger("x", status={"bad": object()})
    assert ok.summary()["dump_failures"] == 1
    ok.trigger("y")
    d = json.load(open(tmp_path / "flight.json"))
    assert d["dump_index"] == 1 and d["reasons"] == ["x", "y"]


def test_flight_validator_rejects_what_jax_rejects():
    good = {"version": 1, "reason": "x", "dump_index": 1,
            "rounds": [{"round": 0, "seconds": 0.1}], "requests": [],
            "metrics": None, "anomalies": []}
    assert validate_flight(good) == [] == jax_flight.validate_flight(good)
    assert validate_flight([]) == jax_flight.validate_flight([])
    for mutate in (
            lambda d: d.update(version=2), lambda d: d.update(reason=""),
            lambda d: d.update(dump_index=0), lambda d: d.update(rounds=[]),
            lambda d: d.update(rounds=[{"seconds": 1.0}]),
            lambda d: d.update(rounds=[{"round": 1}]),
            lambda d: d.update(requests=[{"nope": 1}]),
            lambda d: d.update(metrics={"no": "version"}),
            lambda d: d.update(anomalies=None),
            lambda d: d.update(events=[{"x": 1}])):
        d = json.loads(json.dumps(good))
        mutate(d)
        errs = validate_flight(d)
        assert errs and errs == jax_flight.validate_flight(d)


def test_anomaly_fire_dumps_through_the_telemetry(tmp_path):
    path = str(tmp_path / "flight.json")
    tel = ServeTelemetry(anomaly=AnomalyDetector(watchdog_s=0.05),
                         flight=FlightRecorder(path))

    def round_(i, secs):
        tel.note_round(round_no=i, seconds=secs, compiled=False,
                       barrier=False, occupancy=0.5, queue_depth=0,
                       cum={"ops": 100 * (i + 1)}, shard_lanes=[1],
                       shard_ops=[100], shard_units=[100],
                       status={"round": i})

    for i in range(5):
        round_(i, 0.01)
    assert not Path(path).exists()
    round_(5, 0.2)
    d = json.load(open(path))
    assert d["reason"].startswith("anomaly:stuck_round")
    assert [r["round"] for r in d["rounds"]] == list(range(6))
    assert d["status"]["round"] == 5 and d["anomalies"] == ["stuck_round"]
    round_(6, 0.01)
    assert json.load(open(path))["dump_index"] == 1
    round_(7, 0.3)
    tel.drain_end({"phase": "done"})
    d = json.load(open(path))
    assert d["dump_index"] == 3
    assert d["reason"].startswith("drain_end_active_anomaly:")


# ---------------------------------------------------------------------------
# the bench: blocks, dumps, flags, refusals, exit codes
# ---------------------------------------------------------------------------


def test_disarmed_report_carries_no_telemetry_blocks(tmp_path):
    rep = run_serve_bench(**TINY)
    assert rep["verify_ok"] and rep["anomalies_ok"]
    for k in ("timeseries", "anomalies", "reqtrace", "slo", "flight",
              "status_port", "trace", "trace_valid"):
        assert rep[k] is None, k
    assert rep["metrics"]["version"] == 1
    assert sum(v["count"] for v in rep["doc_drain_latency"].values()) == 8


def test_armed_report_and_quiet_flight(tmp_path):
    flight = str(tmp_path / "flight.json")
    rep = run_serve_bench(**TINY, flight_path=flight, reqtrace_samples=8,
                          slo_spec="default=p99:60000",
                          trace_path=str(tmp_path / "t.json"),
                          timeseries_path=str(tmp_path / "ts.jsonl"))
    assert rep["verify_ok"] and not Path(flight).exists()
    assert rep["flight"]["path"] == flight and rep["flight"]["dumps"] == 0
    assert rep["flight"]["rounds_seen"] == rep["rounds"]
    assert rep["reqtrace"]["requests_closed"] == 8
    assert rep["slo"]["classes"]["default"]["requests"] == 8
    assert rep["trace_valid"] is True and rep["status_port"] is None
    assert sum(w["rounds"] for w in rep["timeseries"]["windows"]) == (
        rep["rounds"])


def test_malformed_slo_fails_before_resources(tmp_path, monkeypatch):
    acquired = []
    monkeypatch.setattr(serve_bench.tempfile, "mkdtemp",
                        lambda *a, **k: acquired.append("journal")
                        or str(tmp_path / "j"))
    monkeypatch.setattr(serve_bench, "build_telemetry",
                        lambda **k: acquired.append("telemetry"))
    with pytest.raises(SloSpecError):
        run_serve_bench(**dict(TINY, n_docs=2), journal_dir="auto",
                        status_port=0, slo_spec="default=99:250")
    assert acquired == []


def test_unfired_fault_and_crash_dump_the_flight_window(tmp_path,
                                                        monkeypatch):
    flight = str(tmp_path / "f1.json")
    rep = run_serve_bench(**TINY, faults="stall@999=1", flight_path=flight)
    assert not rep["faults_ok"] and rep["flight"]["dumps"] == 1
    assert json.load(open(flight))["reason"] == "unfired_fault"
    assert validate_flight_file(flight) == []
    calls = []
    real = FleetScheduler._advance

    def crash(self, plan):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected")
        return real(self, plan)

    monkeypatch.setattr(FleetScheduler, "_advance", crash)
    flight = str(tmp_path / "f2.json")
    with pytest.raises(RuntimeError, match="injected"):
        run_serve_bench(**TINY, flight_path=flight, reqtrace_samples=4)
    d = json.load(open(flight))
    assert d["reason"] == "crash: RuntimeError: injected"
    assert len(d["rounds"]) == 2 and d["requests"]
    assert validate_flight_file(flight) == []


def test_chaos_drain_under_the_watchdog(tmp_path):
    """The JAX chaos smoke's recipe at a tiny size: a pinned 800 ms stall
    against a 250 ms watchdog under the soak's detectors — a stuck round
    fires and clears, the flight recorder dumps a valid post-mortem that
    holds the stalled round and request traces, and the chaos gate and the
    verify pass."""
    flight = str(tmp_path / "flight.json")
    rep = serve_bench.run_serve_soak(
        0.0, watchdog_s=0.25, flight_path=flight,
        **dict(TINY, n_docs=10, classes=(128, 256), slots=(3, 2)),
        faults="seed=5,span=5,stall_ms=800,dup_batch=1,stall@4=1",
        reqtrace_samples=16)
    assert rep["verify_ok"] and rep["faults_ok"] and rep["anomalies_ok"]
    stuck = [e for e in rep["anomalies"]["events"]
             if e["kind"] == "stuck_round"]
    assert stuck and all(e["cleared"] for e in stuck)
    assert rep["flight"]["dumps"] >= 1
    assert any(r.startswith("anomaly:stuck_round")
               for r in rep["flight"]["reasons"])
    dump = json.load(open(flight))
    assert validate_flight_file(flight) == []
    assert jax_flight.validate_flight_file(flight) == []
    assert any(r["round"] >= stuck[0]["round"] for r in dump["rounds"])
    assert dump["requests"]


def _main(args, capsys):
    """``python -m crdt_benches_tpu_torch.bench --group serve`` on a tiny
    CPU fleet, in this process: (exit code, the JSON line or None)."""
    from crdt_benches_tpu_torch.bench.__main__ import main

    rc = main(["--group", "serve", "--device", "cpu", "--serve-docs", "4",
               "--serve-mix", "synth", "--serve-classes", "256,1024,4096",
               "--serve-slots", "2,2,2", "--serve-batch", "16",
               "--serve-macro", "4", *args])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


def test_bench_flags_refusals_and_exit_codes(tmp_path, capsys):
    """The nine telemetry flags in one run (exit 0); ``--serve-soak`` with
    ``--serve-stream-scaling`` and a malformed ``--serve-slo`` exit 2; an
    anomaly still active at the end (a watchdog below every round's time)
    exits 1."""
    rc, rep = _main(["--serve-trace", str(tmp_path / "t.json"),
                     "--serve-status", "0",
                     "--serve-timeseries", str(tmp_path / "ts.jsonl"),
                     "--serve-timeseries-window", "2",
                     "--serve-reqtrace", "4",
                     "--serve-slo", "default=p99:60000",
                     "--serve-flight", str(tmp_path / "f.json"),
                     "--serve-soak", "0", "--serve-watchdog", "30"], capsys)
    assert rc == 0
    assert rep["iterations"] == 1 and rep["anomalies"]["fired"] == 0
    assert rep["trace_valid"] and rep["status_port"] > 0
    assert rep["timeseries"]["window_rounds"] == 2
    for args in (["--serve-soak", "0", "--serve-stream-scaling", "8"],
                 ["--serve-slo", "default=99:250"]):
        assert _main(args, capsys) == (2, None), args
    rc, rep = _main(["--serve-soak", "0", "--serve-watchdog", "1e-9"], capsys)
    assert rc == 1
    assert rep["verify_ok"] and not rep["anomalies_ok"]
    assert rep["anomalies"]["uncleared"] == 1
