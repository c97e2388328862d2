"""The port's live telemetry (``obs/timeseries.py``, ``obs/shard.py``,
``obs/status.py``, ``obs/anomaly.py``) against the JAX package's.

A tiny fleet (24 synthetic docs over the five classes at 16/6/2/2/2
rows, batch 16, macro depth 4) is drained once per package with the
windowed recorder armed: the windows equal JAX's in every field but the
wall time, the RSS, the compile counts and the fence entries (the port
has no sync sanitizer to count them).  The detectors' events on the same
synthetic series equal JAX's; the status server runs on ephemeral ports
with timeouts of at most 5 s; a stall drain trips the stuck-round
watchdog, which recovery clears."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from crdt_benches_tpu.obs import anomaly as jax_anomaly
from crdt_benches_tpu.obs import metrics as jax_metrics
from crdt_benches_tpu.obs import shard as jax_shard
from crdt_benches_tpu.obs import status as jax_status
from crdt_benches_tpu.obs import timeseries as jax_ts
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.obs.anomaly import AnomalyDetector
from crdt_benches_tpu_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    MetricsRegistry,
)
from crdt_benches_tpu_torch.obs.shard import (
    MEM_KEY,
    ReplicaMetrics,
    ShardMetrics,
    class_labeled,
    labeled,
)
from crdt_benches_tpu_torch.obs.status import (
    StatusServer,
    escape_label_value,
    render_prometheus,
    split_labeled_name,
)
from crdt_benches_tpu_torch.obs.status import main as status_main
from crdt_benches_tpu_torch.obs.timeseries import (
    CUM_KEYS,
    ServeTelemetry,
    TimeseriesRecorder,
)
from crdt_benches_tpu_torch.serve import faults as pf
from crdt_benches_tpu_torch.serve.bench import run_serve_soak
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.scheduler import (
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import build_fleet

BANDS = {"synth-small": ("synth", (10, 60)),
         "synth-medium": ("synth", (200, 520))}
MIX = {"synth-small": 0.5, "synth-medium": 0.5}
FLEET = dict(n_docs=24, mix=MIX, seed=0, arrival_span=2, bands=BANDS)
SLOTS = (16, 6, 2, 2, 2)
DRAIN = dict(batch=16, batch_chars=64, macro_k=4)
SIDES = {
    "jax": (jax_build_fleet, JaxPool, jax_prepare, JaxScheduler, jax_ts, {}),
    "port": (build_fleet, DocPool, prepare_streams, FleetScheduler,
             __import__("crdt_benches_tpu_torch.obs.timeseries",
                        fromlist=["x"]), dict(device="cpu")),
}
#: window fields that depend on the wall clock, the process or the
#: package (compiles; the JAX sanitizer's fence entries)
NOT_COMPARED = {"seconds", "throughput", "rss_bytes", "compile_rounds",
                "fence_entries"}


def drain_fleet(side, tmp, fleet=FLEET, slots=SLOTS, drain_kw=DRAIN, **kw):
    build, Pool, prep, Sched, _ts, pkw = SIDES[side]
    pool = Pool(slots=slots, prefetch=False,
                spool_dir=str(tmp / f"{side}_spool"), **pkw)
    streams = prep(build(**fleet), pool, batch=drain_kw["batch"],
                   batch_chars=drain_kw["batch_chars"])
    sched = Sched(pool, streams, **drain_kw, **kw)
    stats = sched.run()
    assert sched.done
    return sched, stats, pool


@pytest.fixture(scope="module")
def windowed(tmp_path_factory):
    """Both packages' drains under a 2-round window recorder streaming to
    a JSONL file."""
    tmp = tmp_path_factory.mktemp("ts")
    out = {}
    for side, (*_, tsmod, _pkw) in SIDES.items():
        path = tmp / f"{side}.jsonl"
        tel = tsmod.ServeTelemetry(recorder=tsmod.TimeseriesRecorder(
            window_rounds=2, stream_path=str(path)))
        sched, stats, pool = drain_fleet(side, tmp, telemetry=tel)
        tel.drain_end()
        out[side] = dict(tel=tel, sched=sched, stats=stats, pool=pool,
                         path=path)
    yield out
    for d in out.values():
        d["tel"].close()
        d["pool"].close()


# ---------------------------------------------------------------------------
# the time-series recorder
# ---------------------------------------------------------------------------


def test_windows_partition_the_drain_and_stream(windowed):
    d = windowed["port"]
    blk, stats = d["tel"].recorder.block(), d["stats"]
    assert blk["version"] == 1 and blk["drains"] == 1
    ws = blk["windows"]
    assert ws and blk["rounds_seen"] == stats.rounds
    assert sum(w["rounds"] for w in ws) == stats.rounds
    assert sum(w["ops"] for w in ws) == stats.ops
    assert sum(w["unit_ops"] for w in ws) == stats.unit_ops
    assert sum(w["evictions"] for w in ws) == stats.evictions
    for w in ws:
        assert 0.0 <= w["occupancy"] <= 1.0 and w["seconds"] > 0
        assert w["full"] == (w["rounds"] >= 2)
        assert sum(w["shard_ops"]) == w["ops"]
        assert sum(w["shard_lanes"]) == w["lanes"]
        # the sync sanitizer's fence crossings: the boundary moves' at
        # least, one a round
        assert w["fence_entries"] >= w["rounds"]
    assert all(w["full"] for w in ws[:-1])
    assert [json.loads(ln) for ln in
            d["path"].read_text().splitlines()] == ws


def test_windows_equal_jax(windowed):
    ours = windowed["port"]["tel"].recorder.block()
    theirs = windowed["jax"]["tel"].recorder.block()
    assert len(ours["windows"]) == len(theirs["windows"])
    for k in ("version", "window_rounds", "n_shards", "drains",
              "rounds_seen", "dropped_windows"):
        assert ours[k] == theirs[k], k
    for w, jw in zip(ours["windows"], theirs["windows"]):
        assert set(w) == set(jw)
        assert {k: v for k, v in w.items() if k not in NOT_COMPARED} == {
            k: v for k, v in jw.items() if k not in NOT_COMPARED}


def test_shard_series_and_registry_equal_jax(windowed):
    """With one shard the per-shard series are the fleet's: they equal
    JAX's registry entries (the memory gauge stays unset on the CPU)."""
    m = windowed["port"]["stats"].metrics.to_dict()
    jm = windowed["jax"]["stats"].metrics.to_dict()
    assert m["counters"] == jm["counters"]
    shard_gauges = {k: v for k, v in m["gauges"].items()
                    if k.startswith("serve.shard.")}
    assert shard_gauges == {k: v for k, v in jm["gauges"].items()
                            if k.startswith("serve.shard.")}
    assert m["counters"][labeled("serve.shard.ops", 0)] == (
        windowed["port"]["stats"].ops)
    assert m["gauges"]["serve.shard.imbalance"]["max"] == 1.0
    assert m["gauges"][labeled("serve.shard.mem_bytes_in_use", 0)][
        "updates"] == 0


def test_ring_is_bounded_with_counted_drops():
    out = []
    for mod in (jax_ts, __import__("crdt_benches_tpu_torch.obs.timeseries",
                                   fromlist=["x"])):
        rec = mod.TimeseriesRecorder(window_rounds=1, capacity=2)
        rec.rebase(n_shards=1)
        cum = dict.fromkeys(CUM_KEYS, 0)
        for i in range(5):
            cum["ops"] = (i + 1) * 10
            assert rec.note_round(round_no=i, seconds=0.01, compiled=False,
                                  barrier=False, occupancy=0.5,
                                  queue_depth=i, cum=cum) is not None
        blk = rec.block()
        assert len(blk["windows"]) == 2 and blk["dropped_windows"] == 3
        assert [w["ops"] for w in blk["windows"]] == [10, 10]
        out.append([{k: v for k, v in w.items() if k != "rss_bytes"}
                    for w in blk["windows"]])
    assert out[0] == out[1]
    assert jax_ts.CUM_KEYS == CUM_KEYS


def test_imbalance_gauge_reads_skew():
    class _B:
        Rg, n_sh = 4, 4

        def free_locals(self, s):
            return set()

    class _P:
        n_sh = 4
        buckets = {0: _B()}
        device = "cpu"

        def shard_occupancy(self):
            return [4, 4, 4, 4]

    sm = ShardMetrics(_P(), MetricsRegistry())
    for lanes, want in (([4, 0, 0, 0], 4.0), ([1, 1, 1, 1], 1.0),
                        ([0, 0, 0, 0], 1.0)):
        sm.note_round(lanes, [8 * x for x in lanes], [8 * x for x in lanes])
        assert sm.imbalance.value == want
    sm.sample_memory()  # the CPU reports nothing: the gauges stay unset
    assert all(g.updates == 0 for g in sm._mem)
    assert MEM_KEY == "allocated_bytes.all.current"


def test_replica_metrics_partition_and_names_equal_jax():
    reg, jreg = MetricsRegistry(), jax_metrics.MetricsRegistry()
    rm = ReplicaMetrics(reg, (256, 1024))
    jrm = jax_shard.ReplicaMetrics(jreg, (256, 1024))
    for m in (rm, jrm):
        m.note_merged(256, 10, 40)
        m.note_merged(1024, 5, 7)
        m.note_local(3)
        m.note_divergence(2)
        m.note_broadcast(128, 2)
    assert rm.merged_total() == jrm.merged_total() == (15, 47)
    assert reg.to_dict() == jreg.to_dict()
    assert class_labeled("a", 4) == jax_shard.class_labeled("a", 4)
    assert labeled("a", 3) == jax_shard.labeled("a", 3)


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve.pool.evictions").inc(7)
    for s in range(3):
        reg.counter(f'serve.shard.ops{{shard="{s}"}}').inc(10 * (s + 1))
    reg.counter('serve.x{host="a\\b"}').inc()
    reg.gauge("serve.shard.imbalance").set(1.25)
    reg.gauge('serve.slo.burn_rate{class="default",window="fast"}').set(0.5)
    h = reg.histogram("serve.round.latency.steady", mod.LATENCY_BUCKETS_S)
    for v in (0.001, 0.01, 0.01, 0.5, 999.0):
        h.observe(v)
    return reg


def test_prometheus_text_equals_jax_byte_for_byte(windowed):
    import crdt_benches_tpu_torch.obs.metrics as port_metrics

    blobs = [_registry(port_metrics).to_dict(),
             windowed["jax"]["stats"].metrics.to_dict(),
             windowed["port"]["stats"].metrics.to_dict()]
    for blob in blobs:
        assert render_prometheus(blob) == jax_status.render_prometheus(blob)
    text = render_prometheus(blobs[0])
    lines = text.splitlines()
    assert "# TYPE serve_pool_evictions_total counter" in lines
    assert "serve_pool_evictions_total 7" in lines
    assert lines.count("# TYPE serve_shard_ops_total counter") == 1
    assert 'serve_shard_ops_total{shard="1"} 20' in lines
    assert 'serve_x_total{host="a\\\\b"} 1' in lines
    buckets = [ln for ln in lines
               if ln.startswith("serve_round_latency_steady_bucket")]
    assert len(buckets) == len(LATENCY_BUCKETS_S) + 1
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert counts == sorted(counts) and counts[-1] == 5
    assert "serve_round_latency_steady_count 5" in lines
    for ln in lines:
        if not ln.startswith("#"):
            name = ln.split("{")[0].split(" ")[0]
            assert name.replace("_", "a").isalnum(), ln


def test_label_parsing_and_escaping():
    assert split_labeled_name('a.b{shard="3"}') == ("a.b", {"shard": "3"})
    assert split_labeled_name("a.b") == ("a.b", {})
    assert escape_label_value('a\\b"c\nd') == 'a\\\\b\\"c\\nd'


# ---------------------------------------------------------------------------
# the status server
# ---------------------------------------------------------------------------


def _get(url):
    return urllib.request.urlopen(url, timeout=5)


def test_status_advances_during_a_live_drain(tmp_path):
    """The drain runs on a worker thread; this thread scrapes
    ``/status.json`` mid-run and sees the rounds advance monotonically,
    then ``/healthz`` 200, ``/metrics`` as Prometheus text, a final done
    snapshot and the ``--watch`` CLI's line."""
    status = StatusServer(port=0)
    port = status.start()
    tel = ServeTelemetry(recorder=TimeseriesRecorder(window_rounds=1),
                         status=status)
    big = dict(n_docs=6, mix={"synth-big": 1.0}, seed=11, arrival_span=2,
               bands={"synth-big": ("synth", (300, 420))})
    errors, box = [], {}

    def run():
        try:
            sched, stats, pool = drain_fleet(
                "port", tmp_path, fleet=big, slots=(2, 2, 2, 2, 2),
                drain_kw=dict(batch=4, batch_chars=32, macro_k=2),
                telemetry=tel)
            box["pool"] = pool
            tel.drain_end(status={**sched.status_fields(), "phase": "done",
                                  "done": True})
        except Exception as e:  # noqa: BLE001 (surfaced by the assert)
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    base = f"http://127.0.0.1:{port}"
    samples = []
    try:
        for _ in range(2000):
            s = json.load(_get(base + "/status.json"))
            if "ops" in s:
                samples.append((s["rounds"], s["ops"]))
            if len(samples) >= 3 and samples[-1][0] > samples[0][0]:
                break
            if not t.is_alive():
                break
            time.sleep(0.01)
        assert _get(base + "/healthz").status == 200
    finally:
        t.join(timeout=120)
    assert not errors, errors
    box["pool"].close()
    assert len(samples) >= 2 and samples == sorted(samples)
    assert samples[-1] > samples[0], samples
    final = json.load(_get(base + "/status.json"))
    assert final["done"] is True and final["phase"] == "done"
    text = _get(base + "/metrics").read().decode()
    assert "serve_pool_evictions_total" in text
    assert "serve_round_occupancy_bucket" in text
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/nope")
    assert ei.value.code == 404
    assert status_main(["--watch", "--url", base, "--count", "1",
                        "--interval", "0.01"]) == 0
    tel.close()


def test_healthz_degrades_on_staleness_and_anomaly():
    srv = StatusServer(port=0, stale_after=0.05)
    port = srv.start()
    try:
        srv.publish_status({"rounds": 1})
        assert _get(f"http://127.0.0.1:{port}/healthz").status == 200
        srv.set_health(False, "stuck_round")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{port}/healthz")
        assert ei.value.code == 503 and b"stuck_round" in ei.value.read()
        srv.set_health(True)
        time.sleep(0.1)  # silent past stale_after
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{port}/healthz")
        assert ei.value.code == 503 and b"stale" in ei.value.read()
    finally:
        srv.stop()
    assert srv.port == 0


# ---------------------------------------------------------------------------
# the anomaly detectors, event for event against JAX's
# ---------------------------------------------------------------------------


def _window(i, *, tput=100.0, occ=0.5, rss=None, jbytes=0, ops=1000,
            full=True):
    return {"end_round": i, "full": full, "throughput": tput,
            "occupancy": occ, "rss_bytes": rss, "journal_bytes": jbytes,
            "ops": ops}


def _series(det):
    """One synthetic series through a detector: watchdog fire and clear,
    degradation fire, drain-down skip and clear, leak growth and plateau,
    journal bytes-per-op growth."""
    for i in range(5):
        det.note_round(0.01, skip=False, round_no=i)
    det.note_round(10.0, skip=True, round_no=5)  # exempt
    det.note_round(0.2, skip=False, round_no=6)
    det.note_round(0.01, skip=False, round_no=7)
    for i in range(6):
        det.note_window(_window(i, tput=100.0 + i % 3))
    det.note_window(_window(6, tput=30.0))
    det.note_window(_window(7, tput=100.0))
    det.note_window(_window(8, tput=30.0, occ=0.05))  # draining down
    det.note_window(_window(9, tput=1.0, full=False))
    rss = 100_000_000
    for i in range(10, 14):
        rss = int(rss * 1.08)
        det.note_window(_window(i, rss=rss))
    det.note_window(_window(14, rss=rss))
    for i in range(15, 19):
        det.note_window(_window(i, jbytes=1000 * int(1.1 ** i * 100)))
    return det.block()


@pytest.mark.parametrize("kw", [
    dict(watchdog_s=0.05, min_windows=4, leak_windows=4, leak_frac=0.2),
    dict(min_windows=4, leak_windows=3, leak_frac=0.1),
])
def test_detector_events_equal_jax(kw):
    ours = _series(AnomalyDetector(**kw))
    theirs = _series(jax_anomaly.AnomalyDetector(**kw))
    assert ours == theirs
    assert ours["fired"] >= 3
    kinds = {e["kind"] for e in ours["events"]}
    assert {"throughput_degradation", "rss_leak"} <= kinds


def test_auto_watchdog_threshold_equals_jax():
    ours, theirs = AnomalyDetector(), jax_anomaly.AnomalyDetector()
    for det in (ours, theirs):
        for i in range(10):
            det.note_round(0.5, skip=False, round_no=i)
        det.note_round(20.0, skip=False, round_no=10)  # 25 x 0.5 = 12.5
        det.note_round(0.5, skip=False, round_no=11)
    assert ours.block() == theirs.block()
    (ev,) = ours.events
    assert ev["kind"] == "stuck_round" and ev["threshold"] == 12.5
    assert ev["cleared_round"] == 11


def test_stall_trips_the_watchdog_and_recovery_clears_it(tmp_path):
    """An injected 250 ms stall against a 100 ms watchdog: a
    ``stuck_round`` fires and the next healthy round clears it."""
    plan = pf.FaultPlan([pf.FaultEvent(kind="stall", round=6, param=250)],
                        seed=3)
    tel = ServeTelemetry(recorder=TimeseriesRecorder(window_rounds=2),
                         anomaly=AnomalyDetector(watchdog_s=0.1))
    big = dict(n_docs=6, mix={"synth-big": 1.0}, seed=11, arrival_span=1,
               bands={"synth-big": ("synth", (500, 700))})
    sched, stats, pool = drain_fleet(
        "port", tmp_path, fleet=big, slots=(2, 2, 2, 2, 2),
        drain_kw=dict(batch=4, batch_chars=32, macro_k=4),
        faults=pf.FaultInjector(plan), telemetry=tel)
    pool.close()
    tel.drain_end()
    assert stats.stall_rounds == 1
    blk = tel.anomaly.block()
    stuck = [e for e in blk["events"] if e["kind"] == "stuck_round"]
    assert stuck and all(e["cleared"] for e in stuck)
    assert blk["uncleared"] == 0 and blk["watchdog_s"] == 0.1


def test_soak_of_one_drain(tmp_path):
    """``run_serve_soak(0)``: one drain under the detectors, the status
    server and the time-series; no anomaly fires."""
    rep = run_serve_soak(0.0, seed=3, status_port=0, timeseries_window=2,
                         mix={"synth-small": 1.0},
                         bands={"synth-small": ("synth", (40, 120))},
                         n_docs=8, batch=8,
                         classes=(128,), slots=(4,), arrival_span=2,
                         macro_k=2, batch_chars=32, device="cpu",
                         log=lambda m: None)
    assert rep["verify_ok"] and rep["anomalies_ok"] and rep["faults_ok"]
    assert rep["iterations"] == 1
    assert rep["timeseries"]["windows"] and rep["timeseries"]["drains"] == 1
    assert rep["anomalies"]["fired"] == 0 and rep["status_port"] > 0
    assert sum(w["ops"] for w in rep["timeseries"]["windows"]) == (
        rep["range_ops"])
