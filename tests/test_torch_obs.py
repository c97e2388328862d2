"""The port's telemetry core (``obs/metrics.py``, ``obs/trace.py`` and
``ServeStats`` on the registry) against the JAX package's.

The tiny fleet of ``tests/test_torch_serve.py`` (24 docs over the five
classes at 16/6/2/2/2 rows, batch 16, macro depth 4, 64 chars a slice),
cut to small synthetic bands so a drain takes a second or two, is drained
once per configuration and package in a module-scoped fixture: plain,
tiered (``prefetch=False``), journaled, and under the tiny chaos plan of
the port README's CPU chaos command.  The registry's counters and gauges,
the occupancy and queue-depth histograms, the per-cause drain-latency
counts and every round's ``plan.waiting`` equal JAX's; the latency
histograms match on bounds and total count (JAX's CPU drains flag the
rounds that compile a shape, the port compiles nothing per shape)."""

import json
import math
import random

import pytest

from crdt_benches_tpu.obs import metrics as jax_metrics
from crdt_benches_tpu.obs import trace as jax_trace
from crdt_benches_tpu.serve import faults as jf
from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import FleetScheduler as JaxScheduler
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.bench.harness import steady_quantiles
from crdt_benches_tpu_torch.obs import trace as obs_trace
from crdt_benches_tpu_torch.obs.metrics import (
    DEPTH_BUCKETS,
    LATENCY_BUCKETS_S,
    OCCUPANCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    geometric_bounds,
)
from crdt_benches_tpu_torch.obs.trace import (
    NOOP_SPAN,
    arm,
    disarm,
    instant,
    span,
    validate_trace,
    validate_trace_file,
)
from crdt_benches_tpu_torch.serve import faults as pf
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.scheduler import (
    DOC_CAUSE_TAGS,
    FleetScheduler,
    prepare_streams,
)
from crdt_benches_tpu_torch.serve.workload import build_fleet

BANDS = {"synth-small": ("synth", (10, 60)),
         "synth-medium": ("synth", (200, 520))}
FLEET = dict(n_docs=24, mix={"synth-small": 0.5, "synth-medium": 0.5},
             seed=0, arrival_span=2, bands=BANDS)
SLOTS = (16, 6, 2, 2, 2)
DRAIN = dict(batch=16, batch_chars=64, macro_k=4)
#: the port README's CPU chaos drain (its journal: a barrier every 2)
CHAOS = ("seed=5,span=4,spool_corrupt=1,device_loss=1,queue_overflow=1,"
         "dup_batch=1,stall=1,stall_ms=1")
CONFIGS = {
    "plain": {},
    "tiered": dict(warm_docs=6),
    "journaled": dict(journal=True, snapshot_every=2),
    "chaos": dict(journal=True, snapshot_every=2, faults=CHAOS,
                  queue_cap=8 * DRAIN["batch"]),
}
SIDES = {
    "jax": (jax_build_fleet, JaxPool, jax_prepare, JaxScheduler, jf, jj, {}),
    "port": (build_fleet, DocPool, prepare_streams, FleetScheduler, pf, pj,
             dict(device="cpu")),
}


def drain_fleet(side, tmp, *, warm_docs=0, journal=False, faults=None,
          fleet=FLEET, journal_kw=None, **kw):
    """One drain of ``fleet`` through ``side``'s package: its scheduler,
    stats, pool and every round's ``plan.waiting``."""
    build, Pool, prep, Sched, fmod, jmod, pkw = SIDES[side]
    pool = Pool(slots=SLOTS, warm_docs=warm_docs, prefetch=False,
                spool_dir=str(tmp / f"{side}_spool"), **pkw)
    streams = prep(build(**fleet), pool, batch=DRAIN["batch"],
                   batch_chars=DRAIN["batch_chars"])
    if isinstance(faults, str):
        faults = fmod.FaultInjector(fmod.FaultPlan.from_spec(faults))
    sched = Sched(pool, streams, **DRAIN, faults=faults,
                  journal=(jmod.OpJournal(str(tmp / f"{side}_wal"),
                                          **(journal_kw or {}))
                           if journal else None), **kw)
    waits = []
    plan = sched._plan

    def recorded():
        p = plan()
        if p is not None:
            waits.append(p.waiting)
        return p

    sched._plan = recorded
    stats = sched.run()
    assert sched.done
    if sched.journal is not None:
        sched.journal.close()
    return dict(sched=sched, stats=stats, pool=pool, waits=waits)


@pytest.fixture(scope="module")
def drains(tmp_path_factory):
    out = {}
    for name, kw in CONFIGS.items():
        tmp = tmp_path_factory.mktemp(name)
        out[name] = {side: drain_fleet(side, tmp, **kw) for side in SIDES}
    yield out
    for pair in out.values():
        for d in pair.values():
            d["pool"].close()


# ---------------------------------------------------------------------------
# the tracer: disarmed identity, armed schema, validators across packages
# ---------------------------------------------------------------------------


def test_disarmed_span_is_the_shared_noop():
    assert not obs_trace.armed()
    s1, s2 = span("serve.plan"), span("serve.dispatch", round=7)
    assert s1 is NOOP_SPAN and s2 is NOOP_SPAN
    with s1:
        pass
    instant("serve.fault", kind="stall")  # no-op, no error


def test_armed_tracer_nests_spans_and_validates():
    tracer = arm()
    try:
        with span("outer", round=1):
            with span("inner"):
                instant("tick", n=3)
    finally:
        assert disarm() is tracer
    doc = tracer.to_dict()
    assert validate_trace(doc) == [] and jax_trace.validate_trace(doc) == []
    assert [e["name"] for e in doc["traceEvents"]] == ["tick", "inner",
                                                       "outer"]
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["outer"]["ts"] <= ev["inner"]["ts"]
    assert (ev["inner"]["ts"] + ev["inner"]["dur"]
            <= ev["outer"]["ts"] + ev["outer"]["dur"] + 1e-6)
    assert ev["tick"]["args"]["span"] == "inner"
    assert span("outer") is NOOP_SPAN


@pytest.mark.parametrize("doc,frag", [
    ([], "top level"),
    ({"traceEvents": [{"ph": "X"}]}, "missing"),
    ({"traceEvents": [
        {"ph": "X", "name": "a", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
        {"ph": "X", "name": "b", "ts": 5, "dur": 10, "pid": 1, "tid": 1}]},
     "overlap"),
    ({"traceEvents": [
        {"ph": "X", "name": "a", "ts": 0, "dur": 5, "pid": 1, "tid": 1},
        {"ph": "i", "s": "t", "name": "f", "cat": "fence", "ts": 50,
         "pid": 1, "tid": 1}]}, "inside no span"),
])
def test_validator_rejects_what_jax_rejects(doc, frag):
    errs = validate_trace(doc)
    assert errs == jax_trace.validate_trace(doc)
    assert any(frag in e for e in errs), errs


def test_traced_drain_validates_in_both_packages(tmp_path):
    """A tiny drain under the armed tracer: every macro-round phase is a
    span, the file passes the port's validator and the JAX package's, and
    a JAX trace passes the port's (the port has no fence instants: its
    sync sanitizer is not ported)."""
    tracer = arm()
    try:
        d = drain_fleet("port", tmp_path, journal=True, snapshot_every=2)
    finally:
        disarm()
    d["pool"].close()
    path = tracer.write(str(tmp_path / "port_trace.json"))
    assert validate_trace_file(path) == []
    assert jax_trace.validate_trace_file(path) == []
    names = {e["name"] for e in tracer.events if e["ph"] == "X"}
    assert {"serve.round", "serve.plan", "serve.journal.wal", "serve.stage",
            "serve.moves", "serve.dispatch", "serve.snapshot",
            "serve.drain_fence"} <= names
    assert not [e for e in tracer.events if e.get("cat") == "fence"]
    jt = jax_trace.arm()
    try:
        with jax_trace.span("serve.round"):
            jax_trace.instant("serve.fault", kind="stall")
    finally:
        jax_trace.disarm()
    jpath = jt.write(str(tmp_path / "jax_trace.json"))
    assert validate_trace_file(jpath) == []
    assert obs_trace.main([jpath]) == 0 and obs_trace.main([]) == 2


# ---------------------------------------------------------------------------
# the registry: round trip, merge, quantiles, blocks across packages
# ---------------------------------------------------------------------------


def test_bucket_bounds_are_jax_bounds():
    assert LATENCY_BUCKETS_S == jax_metrics.LATENCY_BUCKETS_S
    assert OCCUPANCY_BUCKETS == jax_metrics.OCCUPANCY_BUCKETS
    assert DEPTH_BUCKETS == jax_metrics.DEPTH_BUCKETS
    assert geometric_bounds(0.5, 9.0, 3) == jax_metrics.geometric_bounds(
        0.5, 9.0, 3)
    with pytest.raises(ValueError):
        geometric_bounds(2.0, 1.0)


def _registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("a.count").inc(7)
    reg.gauge("a.gauge").set(1.5)
    reg.gauge("a.gauge").set(-2.0)
    h = reg.histogram("a.lat", mod.LATENCY_BUCKETS_S)
    for v in (0.001, 0.01, 0.01, 0.5, 3.0, 999.0):
        h.observe(v)
    return reg, h


def test_registry_round_trip_and_jax_equality():
    reg, h = _registry(__import__("crdt_benches_tpu_torch.obs.metrics",
                                  fromlist=["x"]))
    jreg, _ = _registry(jax_metrics)
    blob = reg.to_dict()
    assert blob == jreg.to_dict() and blob["version"] == 1
    back = MetricsRegistry.from_dict(json.loads(json.dumps(blob)))
    assert back.to_dict() == blob
    assert back.gauges["a.gauge"].vmax == 1.5
    assert back.histograms["a.lat"].quantile(0.5) == pytest.approx(
        h.quantile(0.5))
    for p in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert h.quantile(p) == jreg.histograms["a.lat"].quantile(p)
    stale = dict(blob, version=999)
    with pytest.raises(ValueError):
        MetricsRegistry.from_dict(stale)
    with pytest.raises(ValueError):
        reg.histogram("a.lat", OCCUPANCY_BUCKETS)
    c, g = Counter("x.c"), Gauge("x.g")
    reg.attach(c)
    reg.attach(g)
    c.inc(2)
    g.set(4)
    assert reg.counters["x.c"] is c and reg.to_dict()["counters"]["x.c"] == 2
    assert reg.to_dict()["gauges"]["x.g"]["updates"] == 1


def test_histogram_merge_associative_and_quantiles_within_a_bucket():
    rng = random.Random(7)
    hs = []
    for i in range(3):
        h = Histogram(f"h{i}", LATENCY_BUCKETS_S)
        for _ in range(200):
            h.observe(rng.lognormvariate(-4, 1.5))
        hs.append(h)
    a, b, c = hs
    left = Histogram.merged(Histogram.merged(a, b), c)
    right = Histogram.merged(a, Histogram.merged(b, c))
    assert left.counts == right.counts and left.count == 600
    assert (left.vmin, left.vmax) == (min(h.vmin for h in hs),
                                      max(h.vmax for h in hs))
    assert left.total == pytest.approx(a.total + b.total + c.total)
    with pytest.raises(ValueError):
        a.merge(Histogram("o", OCCUPANCY_BUCKETS))
    with pytest.raises(ValueError):
        Histogram.merged()
    xs = [rng.lognormvariate(-5, 1.0) for _ in range(3000)]
    h = Histogram("lat", LATENCY_BUCKETS_S)
    for x in xs:
        h.observe(x)
    xs.sort()
    factor = 2.0 ** 0.25
    for p in (0.5, 0.95, 0.99, 0.999):
        exact = xs[int(p * (len(xs) - 1))]
        assert exact / factor <= h.quantile(p) <= exact * factor


def test_jax_metrics_block_loads_through_the_port(drains):
    """JAX's ``metrics`` block of a real drain loads through the port's
    ``MetricsRegistry.from_dict`` and serializes back identical."""
    for pair in drains.values():
        blob = json.loads(json.dumps(pair["jax"]["stats"].metrics.to_dict()))
        assert MetricsRegistry.from_dict(blob).to_dict() == blob


# ---------------------------------------------------------------------------
# ServeStats on the registry, drained in both packages
# ---------------------------------------------------------------------------

LAT = ("serve.round.latency.steady", "serve.round.latency.skipped")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_registry_equals_jax(drains, config):
    """Counters and gauges (value, extrema, updates) and the occupancy and
    queue-depth histograms equal JAX's on the same drain; the latency
    histograms share bounds and their total count."""
    port = drains[config]["port"]["stats"].metrics.to_dict()
    jax = drains[config]["jax"]["stats"].metrics.to_dict()
    assert port["counters"] == jax["counters"]
    assert port["gauges"] == jax["gauges"]
    assert set(port["histograms"]) == set(jax["histograms"])
    for name in ("serve.round.occupancy", "serve.round.queue_depth"):
        assert port["histograms"][name] == jax["histograms"][name], name
    for name in LAT:
        assert port["histograms"][name]["bounds"] == jax["histograms"][
            name]["bounds"]
    assert (sum(port["histograms"][n]["count"] for n in LAT)
            == sum(jax["histograms"][n]["count"] for n in LAT)
            == drains[config]["port"]["stats"].rounds)
    assert port["counters"]["serve.pool.evictions"] > 0
    if config == "chaos":
        assert port["counters"]["serve.faults.seen"] >= 5
        assert port["counters"]["serve.faults.fired.device_loss"] == 1
        assert port["counters"]["serve.faults.recovered.spool_corrupt"] == 1
    if config in ("journaled", "chaos"):
        assert port["counters"]["serve.journal.records"] > 0
        assert port["gauges"]["serve.durability.chain_depth"]["updates"] > 0
    if config == "tiered":
        assert port["counters"]["serve.tier.warm_hits"] > 0
        assert port["counters"]["serve.tier.warm_evictions"] > 0
        assert port["counters"]["serve.pool.restores"] > 0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_waiting_and_cause_counts_equal_jax(drains, config):
    port, jax = drains[config]["port"], drains[config]["jax"]
    assert port["waits"] == jax["waits"] and any(port["waits"])
    assert {t: h.count for t, h in port["stats"].doc_latency.items()} == {
        t: h.count for t, h in jax["stats"].doc_latency.items()}
    s, js = port["stats"], jax["stats"]
    assert (s.rounds, s.occupancy.count, s.queue_depth.count) == (
        js.rounds, js.occupancy.count, js.queue_depth.count)
    # a barrier round is a barrier round on the port; JAX files the ones
    # that also compiled a shape under its compile rounds
    assert s.barrier_rounds == s.snapshots == js.snapshots
    assert js.barrier_rounds <= s.barrier_rounds <= (js.barrier_rounds
                                                    + js.compile_rounds)
    # every admitted doc is closed exactly once, under one cause tag
    assert sum(h.count for h in s.doc_latency.values()) == FLEET["n_docs"]


def test_compile_flag_is_never_raised_on_the_port(drains):
    for pair in drains.values():
        s = pair["port"]["stats"]
        assert s.compile_rounds == 0 and s.compile_time == 0.0
        assert s.lat_skipped.count == s.barrier_rounds


def test_drain_quantiles_within_a_bucket_of_the_raw_lists(tmp_path):
    """``keep_raw`` keeps the raw rounds: the histogram quantiles sit
    within one bucket of the exact order statistics, under the same
    classification (barrier rounds left out)."""
    build, Pool, prep, Sched, _f, _j, pkw = SIDES["port"]
    pool = Pool(slots=SLOTS, spool_dir=str(tmp_path / "sp"), **pkw)
    sched = Sched(pool, prep(build(**FLEET), pool, batch=16, batch_chars=64),
                  **DRAIN, journal=pj.OpJournal(str(tmp_path / "j")),
                  snapshot_every=3)
    sched.stats.keep_raw = True
    stats = sched.run()
    pool.close()
    sched.journal.close()
    raw = stats.raw_round_latencies
    assert len(raw) == stats.rounds > 0 and stats.barrier_rounds > 0
    skip = stats.raw_barrier_flags
    exact, _, skipped = steady_quantiles(raw, skip)
    assert skipped == stats.barrier_rounds
    kept = sorted(x for x, b in zip(raw, skip) if not b) or sorted(raw)
    got = stats.latency_quantiles()
    factor = 2.0 ** 0.25
    for key, p in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
        rank = p * (len(kept) - 1)
        lo, hi = kept[math.floor(rank)] / factor, kept[math.ceil(rank)] * factor
        assert lo <= got[key] <= hi and lo <= exact[key] <= hi
    assert stats.barrier_time == pytest.approx(
        sum(x for x, b in zip(raw, skip) if b))
    assert len(stats.lat_steady.counts) == len(LATENCY_BUCKETS_S) + 1


def test_cause_tags_under_shed_and_quarantine_equal_jax(tmp_path):
    """An overflow shed, a spool damage and a poisoned rebuild: the per-
    cause drain counts (``shed``, ``quarantined``, ``deferred``, ``ok``)
    equal JAX's, every doc counted once."""
    out = {}
    for side, (_b, _P, _p, _S, fmod, _j, _k) in SIDES.items():
        plan = fmod.FaultPlan([
            fmod.FaultEvent(kind="queue_overflow", round=3),
            fmod.FaultEvent(kind="spool_corrupt", round=2),
            fmod.FaultEvent(kind="poison_rebuild", round=0)], seed=3)
        d = drain_fleet(side, tmp_path, faults=fmod.FaultInjector(plan),
                  queue_cap=16, overflow_policy="shed")
        d["pool"].close()
        out[side] = d
    by = {side: {t: h.count for t, h in d["stats"].doc_latency.items()}
          for side, d in out.items()}
    assert by["port"] == by["jax"]
    assert set(by["port"]) == set(DOC_CAUSE_TAGS)
    assert by["port"]["quarantined"] == len(out["port"]["stats"].quarantines)
    assert by["port"]["quarantined"] >= 1 and by["port"]["shed"] >= 1
    assert sum(by["port"].values()) == FLEET["n_docs"]
    assert (out["port"]["stats"].metrics.to_dict()["counters"]
            == out["jax"]["stats"].metrics.to_dict()["counters"])


def test_armed_drain_equals_disarmed_in_every_counter(drains, tmp_path):
    """Tracer, request tracing, the SLO and a time-series bundle armed: the
    registry's counters and gauges and the stats' counters equal the
    disarmed drain's."""
    from crdt_benches_tpu_torch.obs.reqtrace import RequestTracker
    from crdt_benches_tpu_torch.obs.slo import SloTracker
    from crdt_benches_tpu_torch.obs.timeseries import (
        ServeTelemetry,
        TimeseriesRecorder,
    )

    slo = SloTracker.from_spec("default=p99:60000")
    arm()
    try:
        d = drain_fleet("port", tmp_path, reqtrace=RequestTracker(16, slo=slo),
                  slo=slo, telemetry=ServeTelemetry(
                      recorder=TimeseriesRecorder(window_rounds=2)))
    finally:
        disarm()
    d["pool"].close()
    plain = drains["plain"]["port"]["stats"]
    armed = d["stats"].metrics.to_dict()
    base = plain.metrics.to_dict()
    # the armed drain adds only the per-shard series and the SLO's gauges
    assert {k: v for k, v in armed["counters"].items()
            if not k.startswith("serve.shard.")} == base["counters"]
    assert {k: v for k, v in armed["gauges"].items()
            if k in base["gauges"]} == base["gauges"]
    for name in ("rounds", "slices", "ops", "unit_ops", "staged_cells",
                 "evictions", "restores", "promotions", "admissions",
                 "dispatches", "patches"):
        assert getattr(d["stats"], name) == getattr(plain, name), name
    assert d["waits"] == drains["plain"]["port"]["waits"]


def test_pool_counters_are_registry_counters(tmp_path):
    pool = DocPool(classes=(256,), slots=(2,), device="cpu",
                   spool_dir=str(tmp_path / "sp"))
    jpool = JaxPool(classes=(256,), slots=(2,),
                    spool_dir=str(tmp_path / "jsp"))
    try:
        reg, jreg = MetricsRegistry(), jax_metrics.MetricsRegistry()
        pool.bind_metrics(reg)
        jpool.bind_metrics(jreg)
        pool.evictions += 3
        jpool.evictions += 3
        pool.update_tier_gauges()
        jpool.update_tier_gauges()
        assert reg.to_dict() == jreg.to_dict()
        assert pool.shard_occupancy() == jpool.shard_occupancy() == [0]
        assert (pool.n_sh, pool.buckets[256].Rg) == (
            jpool.n_sh, jpool.buckets[256].Rg)
    finally:
        pool.close()
        jpool.close()


def test_durability_chaos_registry_equals_jax(tmp_path):
    """A torn WAL GC pass (``crash_compact``) and a damaged delta
    (``delta_corrupt``) on 200-byte segments, a barrier every round: the
    journal's counters (``gc_passes``, ``gc_segments`` after the torn pass
    is completed) and gauges equal JAX's."""
    out = {}
    for side in SIDES:
        d = drain_fleet(side, tmp_path, journal=True,
                  journal_kw=dict(segment_bytes=200),
                  faults="seed=3,span=4,crash_compact=1,delta_corrupt=1",
                  snapshot_every=1, snapshot_full_every=2)
        d["pool"].close()
        out[side] = d
    port = out["port"]["stats"].metrics.to_dict()
    jax = out["jax"]["stats"].metrics.to_dict()
    assert port["counters"]["serve.faults.fired.crash_compact"] == 1
    assert port["counters"]["serve.faults.recovered.crash_compact"] == 1
    assert port["counters"]["serve.journal.gc_segments"] > 0
    assert port["counters"] == jax["counters"]
    assert port["gauges"] == jax["gauges"]
    assert (out["port"]["sched"].journal.gc_segments
            == out["jax"]["sched"].journal.gc_segments)
