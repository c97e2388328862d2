"""The port's open-loop drains (``serve/ingest/``: the pump, the deadline
scheduler and the drive loop, and their wiring in ``serve/bench.py``)
against the JAX package's, mirroring the drain tests of
``tests/test_ingest.py``.

Tolerance: exact, wherever the wire's timing is taken out.  The lockstep
tests replace the TCP front with one stub (test code, the same for both
packages) that releases a plan's frames at their planned rounds, and a
stub client that is finished once every frame is out; JAX's and the
port's ``drive_open_loop`` then drain the same fleet with tenants and EDF
(no SLO: its burn rates read wall time), and every scheduler counter, the
``ingest`` block, the deadline fields, every bucket, stream cursor and
delivery point and the WAL bytes must be equal, also under ``conn_churn``
and ``tenant_flood``.  The live drains over a real socket are held to the
invariants JAX's tests hold (every planned op delivered, every admitted
op served, the oracle), since latencies, late frames and retries differ
run to run in both packages."""

import json
import os
import socket
import threading

import numpy as np
import pytest

from crdt_benches_tpu.serve import faults as jf
from crdt_benches_tpu.serve import journal as jj
from crdt_benches_tpu.serve.ingest import admission as jadm
from crdt_benches_tpu.serve.ingest import deadline as jdl
from crdt_benches_tpu.serve.ingest import loadgen as jload
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve import faults as pf
from crdt_benches_tpu_torch.serve import journal as pj
from crdt_benches_tpu_torch.serve.bench import (
    run_serve_bench,
    run_serve_open_sweep,
)
from crdt_benches_tpu_torch.serve.ingest import admission as padm
from crdt_benches_tpu_torch.serve.ingest import deadline as pdl
from crdt_benches_tpu_torch.serve.ingest import loadgen as pload
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.scheduler import prepare_streams
from crdt_benches_tpu_torch.serve.workload import build_fleet

#: tests/test_ingest.py's tiny bands
TINY_BANDS = {
    "synth-small": ("synth", (10, 60)),
    "synth-medium": ("synth", (150, 360)),
}
TINY_MIX = {"synth-small": 0.6, "synth-medium": 0.4}
SIDES = {
    "jax": dict(build=jax_build_fleet, Pool=JaxPool, prep=jax_prepare,
                faults=jf, journal=jj, adm=jadm, dl=jdl, load=jload,
                pool_kw={}),
    "port": dict(build=build_fleet, Pool=DocPool, prep=prepare_streams,
                 faults=pf, journal=pj, adm=padm, dl=pdl, load=pload,
                 pool_kw={"device": "cpu"}),
}
#: every ServeStats field an open drain shares with JAX's
STATS = ("rounds", "slices", "ops", "unit_ops", "staged_cells", "patches",
         "evictions", "restores", "promotions", "admissions", "shed_ops",
         "deferred_ops", "overflow_events", "backpressure_rounds",
         "dup_ops_dropped", "stall_rounds", "recoveries", "faults_seen",
         "faults_injected", "snapshots", "snapshots_full",
         "snapshots_delta")
STREAM = ("cursor", "limit", "lossy", "delivered", "deferred_high", "burst")


class StubFront:
    """The live front's hot-thread surface without the wire: each drain
    releases, session by session in plan order, a session's ``hello``,
    every frame planned at or before ``now + pace_slack`` (what the live
    front admits), and its ``bye`` after the last frame.  ``churn()`` drops
    every open session at the next drain: a ``churn_drop``, a resumed
    ``hello`` and the session's last released frame again (a redelivery),
    as a client reconnecting after a drop sends them."""

    def __init__(self, plan, pace_slack=2):
        self.plan = plan
        self.pace_slack = pace_slack
        self.now = 0
        self.churn_gen = 0
        self._seen_gen = 0
        self._next = [0] * len(plan.sessions)
        self._state = ["new"] * len(plan.sessions)
        self._last = [None] * len(plan.sessions)
        self._seq = [0] * len(plan.sessions)
        self.frames = self.ops_frames = self.ops_delivered = 0
        self.bad_frames = self.sessions_opened = self.sessions_resumed = 0
        self.sessions_closed = self.churn_drops = 0

    @property
    def idle(self):
        return True  # every due payload leaves in the drain that finds it

    @property
    def finished(self):
        return all(s == "closed" for s in self._state)

    def churn(self):
        self.churn_gen += 1

    def _ops(self, i, frame):
        s = self.plan.sessions[i]
        rnd, start, count = frame
        self._seq[i] += 1
        self.ops_frames += 1
        self.ops_delivered += count
        return {"kind": "ops", "session": s.session, "doc": s.doc,
                "tenant": s.tenant, "seq": self._seq[i] - 1,
                "start": start, "count": count, "round": rnd}

    def drain(self):
        out = []
        churned = self.churn_gen != self._seen_gen
        self._seen_gen = self.churn_gen
        for i, s in enumerate(self.plan.sessions):
            hello = {"kind": "hello", "session": s.session, "doc": s.doc,
                     "tenant": s.tenant, "resume": False}
            if self._state[i] == "open" and churned:
                out.append({"kind": "churn_drop", "session": s.session,
                            "doc": s.doc, "tenant": s.tenant})
                self.churn_drops += 1
                out.append(dict(hello, resume=True))
                self.sessions_opened += 1
                self.sessions_resumed += 1
                if self._last[i] is not None:
                    out.append(self._ops(i, self._last[i]))
            if self._state[i] == "new":
                out.append(hello)
                self.sessions_opened += 1
                self._state[i] = "open"
            if self._state[i] != "open":
                continue
            while (self._next[i] < len(s.frames)
                   and s.frames[self._next[i]][0]
                   <= self.now + self.pace_slack):
                self._last[i] = s.frames[self._next[i]]
                out.append(self._ops(i, self._last[i]))
                self._next[i] += 1
            if self._next[i] == len(s.frames):
                out.append({"kind": "bye", "session": s.session})
                self.sessions_closed += 1
                self._state[i] = "closed"
        self.frames += len(out)
        return out

    def status_fields(self):
        return {"port": None, "frames": self.frames,
                "ops_frames": self.ops_frames,
                "ops_delivered": self.ops_delivered,
                "bad_frames": self.bad_frames,
                "sessions_opened": self.sessions_opened,
                "sessions_resumed": self.sessions_resumed,
                "sessions_closed": self.sessions_closed,
                "churn_drops": self.churn_drops, "queue_depth": 0}


def _files(jd):
    return {f: open(os.path.join(jd, f), "rb").read()
            for f in sorted(os.listdir(jd))
            if os.path.isfile(os.path.join(jd, f))}


def lockstep(tmp_path, side, *, n_docs=16, rate=48.0, process="poisson",
             tenants="gold=48:192,free=12:24:96", edf=True, faults=None,
             journal=True, batch=16, macro_k=4, queue_cap=0):
    """One package's open drain of the fleet behind a :class:`StubFront`,
    wired as ``run_serve_bench`` wires the live one."""
    m = SIDES[side]
    sessions = m["build"](n_docs, mix=TINY_MIX, seed=3, arrival_span=2,
                          bands=TINY_BANDS)
    pool = m["Pool"](classes=(128, 512), slots=(8, 4), prefetch=False,
                     spool_dir=str(tmp_path / f"{side}_sp"), **m["pool_kw"])
    streams = m["prep"](sessions, pool, batch=batch, batch_chars=64)
    for st in streams.values():
        st.burst = 0
    jd = str(tmp_path / f"{side}_j")
    jour = m["journal"].OpJournal(jd) if journal else None
    policies = m["adm"].parse_tenant_spec(tenants)
    admission = m["adm"].AdmissionController(policies, journal=jour)
    plan = m["load"].build_open_plan(streams, rate=rate, process=process,
                                     seed=3, tenant_names=tuple(policies))
    expected = -(-plan.total_ops // int(rate))
    injector = (m["faults"].FaultInjector(m["faults"].FaultPlan.from_spec(
        faults)) if faults else None)
    sched = m["dl"].DeadlineScheduler(
        pool, streams, edf=edf, default_budget=max(64, 2 * expected + 2),
        batch=batch, macro_k=macro_k, batch_chars=64,
        queue_cap=queue_cap or 8 * batch, faults=injector, journal=jour,
        snapshot_every=3 if journal else 0)
    front = StubFront(plan)
    admission.bind(sched.stats.metrics)
    pump = m["load"].IngestPump(sched, front, admission,
                                tenant_of=plan.tenant_of,
                                faults=sched.faults)
    sched.ingest_status = pump.status_fields
    stats = m["load"].drive_open_loop(sched, pump, front)
    if jour is not None:
        jour.close()
    return dict(sessions=sessions, pool=pool, streams=streams, sched=sched,
                stats=stats, pump=pump, admission=admission, plan=plan,
                injector=injector, jd=jd)


def assert_same(j, p, wal=True):
    for f in STATS:
        assert getattr(p["stats"], f) == getattr(j["stats"], f), f
    assert (p["stats"].lat_steady.count + p["stats"].lat_skipped.count
            == j["stats"].lat_steady.count + j["stats"].lat_skipped.count)
    assert p["sched"].round == j["sched"].round
    assert p["pump"].to_dict() == j["pump"].to_dict()
    assert p["admission"].to_dict() == j["admission"].to_dict()
    assert p["sched"].deadline_fields() == j["sched"].deadline_fields()
    for key in ("deadline", "ingest"):
        assert (p["sched"].status_fields()[key]
                == j["sched"].status_fields()[key])
    assert (p["stats"].metrics.to_dict()["counters"]
            == {k: v for k, v in j["stats"].metrics.to_dict()[
                "counters"].items()
                if k in p["stats"].metrics.to_dict()["counters"]})
    if p["injector"] is not None:
        assert p["injector"].plan.summary() == j["injector"].plan.summary()
    for f in ("evictions", "restores", "promotions", "fresh_admits"):
        assert getattr(p["pool"], f) == getattr(j["pool"], f), f
    for cls in j["pool"].classes:
        assert p["pool"].buckets[cls].rows == j["pool"].buckets[cls].rows
        for a, b in zip(p["pool"].pull_bucket(cls),
                        j["pool"].pull_bucket(cls)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), cls
    for doc, st in j["streams"].items():
        for f in STREAM:
            assert getattr(p["streams"][doc], f) == getattr(st, f), (doc, f)
    if wal:
        assert _files(p["jd"]) == _files(j["jd"])
    for s in p["sessions"]:
        if p["pool"].docs[s.doc_id].length == 0 and p["streams"][
                s.doc_id].lossy:
            # shed before its first op: never admitted, in both packages
            for pool in (p["pool"], j["pool"]):
                with pytest.raises(ValueError, match="never admitted"):
                    pool.decode(s.doc_id)
            continue
        got = p["pool"].decode(s.doc_id)
        assert got == j["pool"].decode(s.doc_id), s.doc_id
        if not p["streams"][s.doc_id].lossy:
            assert got == replay_trace(s.trace), s.doc_id


def close(*runs):
    for r in runs:
        r["pool"].close()


CASES = {
    "edf_journal": dict(),
    "rr_burst": dict(edf=False, process="burst", journal=False),
    "chaos": dict(faults="seed=5,conn_churn@6=1,tenant_flood@10=1"),
    "defer_limit_shed": dict(tenants="gold=3:8,free=2:4:16", rate=96.0,
                             faults="seed=2,tenant_flood@3=1"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_open_drain_equals_jax(tmp_path, case):
    kw = CASES[case]
    j = lockstep(tmp_path, "jax", **kw)
    p = lockstep(tmp_path, "port", **kw)
    assert_same(j, p, wal=kw.get("journal", True))
    ing = p["pump"].to_dict()
    total = p["plan"].total_ops
    assert ing["ops_delivered"] >= total
    assert p["sched"].done
    dl = p["sched"].deadline_fields()
    assert dl["met"] + dl["missed"] == 16 and dl["edf"] == kw.get("edf",
                                                                  True)
    if kw.get("faults"):
        evs = p["injector"].plan.events
        assert all(e.fired and e.recovered for e in evs), [
            e.to_dict() for e in evs]
    if case == "chaos":
        assert ing["churn_drops"] >= 1 and ing["sessions_resumed"] >= 1
        assert ing["dup_frames"] >= 1
    if case == "defer_limit_shed":
        dec = ing["admission"]["decisions"]
        assert dec.get("shed:defer_limit", 0) >= 1
        assert ing["shed_docs"] >= 1 and p["stats"].shed_ops > 0
        assert any(st.lossy for st in p["streams"].values())
    close(j, p)


def test_lockstep_wal_recovers_across_packages(tmp_path):
    """The WAL of a lockstep open drain with admission sheds recovers
    through either package's ``recover_fleet`` to the same streams and
    buckets."""
    kw = CASES["defer_limit_shed"]
    runs = {side: lockstep(tmp_path, side, **kw) for side in SIDES}
    assert _files(runs["port"]["jd"]) == _files(runs["jax"]["jd"])
    rec = {}
    for side, other in (("port", "jax"), ("jax", "port")):
        m = SIDES[side]
        sessions = m["build"](16, mix=TINY_MIX, seed=3, arrival_span=2,
                              bands=TINY_BANDS)
        pool = m["Pool"](classes=(128, 512), slots=(8, 4), prefetch=False,
                         spool_dir=str(tmp_path / f"{side}_rsp"),
                         **m["pool_kw"])
        streams = m["prep"](sessions, pool, batch=16, batch_chars=64)
        rep = m["journal"].recover_fleet(pool, streams, runs[other]["jd"])
        rec[side] = (rep.shed_ops, rep.snapshot_round, rep.resume_round,
                     rep.records, {d: (st.cursor, st.limit, st.lossy)
                                   for d, st in streams.items()},
                     {c: [np.asarray(a) for a in pool.pull_bucket(c)]
                      for c in pool.classes})
        pool.close()
    assert rec["port"][:5] == rec["jax"][:5]
    assert rec["port"][0] > 0
    for c in rec["port"][5]:
        for a, b in zip(rec["port"][5][c], rec["jax"][5][c]):
            assert np.array_equal(a, b)
    close(*runs.values())


def test_refused_tail_is_decided_again_in_both_packages(tmp_path):
    """The reference behaviour under a tight queue cap, the same in both
    packages: a frame whose tail ``_push_delivery`` refuses is held, and
    the held tail goes through ``decide`` again in a later round, so the
    tenants' ``admitted_ops`` count admission decisions, more than the
    ops the plan offers, while every op is served once."""
    kw = dict(n_docs=12, rate=96.0, queue_cap=8, journal=False,
              tenants="gold=4096:65536,free=4096:65536:65536")
    j = lockstep(tmp_path, "jax", **kw)
    p = lockstep(tmp_path, "port", **kw)
    assert_same(j, p, wal=False)
    total = p["plan"].total_ops
    admitted = sum(d["admitted_ops"] for d in
                   p["admission"].to_dict()["tenants"].values())
    assert p["sched"].done and p["stats"].deferred_ops > 0
    assert p["stats"].shed_ops == 0 and p["stats"].ops == total
    assert admitted > total
    close(j, p)


def _deadline_drain(tmp_path, side, edf):
    m = SIDES[side]
    sessions = m["build"](12, mix=TINY_MIX, seed=5, arrival_span=3,
                          bands=TINY_BANDS)
    pool = m["Pool"](classes=(128, 512), slots=(6, 3), prefetch=False,
                     spool_dir=str(tmp_path / f"{side}_{edf}"),
                     **m["pool_kw"])
    streams = m["prep"](sessions, pool, batch=16)
    sched = m["dl"].DeadlineScheduler(pool, streams, batch=16, edf=edf,
                                      deadline_budgets={128: 5, 512: 9},
                                      default_budget=7)
    plans = []
    plan_of = sched._plan

    def recorded():
        plan = plan_of()
        if plan is not None:
            plans.append((plan.base_round, {
                c: [(ln.stream.doc_id, ln.end) for ln in lanes]
                for c, lanes in sorted(plan.lanes.items())}))
        return plan

    sched._plan = recorded
    deadlines = {d: sched.deadline_for(d) for d in streams}
    # the budget resolves through the doc's capacity class at arrival
    for doc, st in streams.items():
        cls = pool.class_for(max(pool.docs[doc].length, 1))
        assert deadlines[doc] == st.arrival + {128: 5, 512: 9}[cls]
    stats = sched.run()
    return dict(sched=sched, pool=pool, stats=stats, plans=plans,
                deadlines=deadlines, streams=streams, sessions=sessions)


@pytest.mark.parametrize("edf", [True, False])
def test_deadline_scheduler_closed_loop_equals_jax(tmp_path, edf):
    """tests/test_ingest.py::test_deadline_budgets_and_scoring through
    both packages: every plan, the deadlines and met/missed equal."""
    j = _deadline_drain(tmp_path, "jax", edf)
    p = _deadline_drain(tmp_path, "port", edf)
    assert p["plans"] == j["plans"] and p["plans"]
    assert p["deadlines"] == j["deadlines"]
    assert p["sched"].deadline_fields() == j["sched"].deadline_fields()
    for f in STATS:
        assert getattr(p["stats"], f) == getattr(j["stats"], f), f
    pool = p["pool"]
    fields = p["sched"].deadline_fields()
    assert fields["edf"] is edf and fields["budgets"] == {"128": 5,
                                                          "512": 9}
    assert fields["met"] + fields["missed"] == 12
    assert p["sched"].status_fields()["deadline"] == fields
    assert "ingest" not in p["sched"].status_fields()
    for s in p["sessions"]:
        assert pool.decode(s.doc_id) == replay_trace(s.trace)
    close(j, p)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_admission_shed_recovery_parity(tmp_path, writer):
    """tests/test_ingest.py::test_admission_shed_recovery_parity across the
    packages: an admission shed journaled by one package's controller
    recovers through the other's ``recover_fleet`` (and its own) as an
    overflow shed does; the journal bytes are the same."""
    reader = "jax" if writer == "port" else "port"
    files = {}
    for side in SIDES:
        m = SIDES[side]
        sessions = m["build"](6, mix=TINY_MIX, seed=7, arrival_span=2,
                              bands=TINY_BANDS)
        jd = str(tmp_path / f"{side}_journal")
        journal = m["journal"].OpJournal(jd)
        adm = m["adm"].AdmissionController(
            m["adm"].parse_tenant_spec("free=4:8"), journal=journal)
        pool = m["Pool"](classes=(128, 512), slots=(6, 3), prefetch=False,
                         spool_dir=str(tmp_path / f"{side}_sp"),
                         **m["pool_kw"])
        streams = m["prep"](sessions, pool, batch=16)
        doc = max(streams, key=lambda d: streams[d].n_total)
        total = streams[doc].n_total
        adm.journal_shed(doc, keep=5, shed=total - 5, tenant="free", rnd=2)
        journal.close()
        pool.close()
        files[side] = (_files(jd), jd, doc, total)
    assert files["port"][0] == files["jax"][0]
    _, jd, doc, total = files[writer]
    records, dropped = SIDES[reader]["journal"].read_journal(jd)
    assert dropped == 0
    assert records == [{"t": "shed", "r": 2, "doc": doc, "at": 5,
                        "ops": total - 5, "tenant": "free",
                        "why": "admission"}]
    for side in (reader, writer):
        m = SIDES[side]
        sessions = m["build"](6, mix=TINY_MIX, seed=7, arrival_span=2,
                              bands=TINY_BANDS)
        pool = m["Pool"](classes=(128, 512), slots=(6, 3), prefetch=False,
                         spool_dir=str(tmp_path / f"{side}_b"),
                         **m["pool_kw"])
        streams = m["prep"](sessions, pool, batch=16)
        rep = m["journal"].recover_fleet(pool, streams, jd)
        st = streams[doc]
        assert st.lossy and st.limit == 5
        assert rep.shed_ops == total - 5 and rep.records == 1
        assert rep.snapshot_round == -1 and rep.resume_round == 0
        pool.close()


TINY = dict(mix=TINY_MIX, n_docs=12, batch=16, classes=(128, 512),
            slots=(8, 4), seed=3, arrival_span=2, bands=TINY_BANDS,
            device="cpu", log=lambda *_: None)


def test_open_loop_drain_end_to_end():
    """tests/test_ingest.py::test_open_loop_drain_end_to_end on the port:
    a tiny fleet served through the real TCP front under Poisson arrivals
    with tenants and EDF: every doc byte-identical to the oracle, every op
    accounted for from the wire through the admission to the scheduler,
    and the report's ingest block."""
    rep = run_serve_bench(**TINY, open_spec="48", deadline=True,
                          tenants_spec="gold=48:192,free=12:24:96")
    assert rep["verify_ok"] and rep["verified_docs"] == 12
    assert rep["bench_id"] == "serve/open/custom/12"
    assert rep["queue_cap"] == 8 * 16 and rep["knee"] is None
    ing = rep["ingest"]
    assert ing["version"] == 1
    assert ing["open"]["rate"] == 48.0
    assert ing["open"]["process"] == "poisson"
    assert ing["front"]["ops_delivered"] == ing["open"]["total_ops"]
    assert ing["front"]["sessions_closed"] == 12
    assert ing["client"]["errors"] == 0
    assert ing["client"]["sent_frames"] >= ing["open"]["total_frames"]
    adm = ing["admission"]["tenants"]
    assert set(adm) == {"gold", "free"}
    admitted = sum(t["admitted_ops"] for t in adm.values())
    shed = sum(t["shed_ops"] for t in adm.values())
    # >= because a refused tail is held and decided again
    assert admitted + shed >= ing["open"]["total_ops"]
    assert ing["dup_frames"] == 0
    assert ing["deadline"]["met"] + ing["deadline"]["missed"] == 12
    assert ing["deadline"]["edf"] is True
    assert ing["drained_frames"] == ing["front"]["frames"]
    assert rep["range_ops"] == ing["open"]["total_ops"] - rep["shed_ops"]
    counters = rep["metrics"]["counters"]
    assert counters['serve.ingest.admitted_ops{tenant="gold"}'] == adm[
        "gold"]["admitted_ops"]


def test_open_sweep_attaches_a_knee_block_of_jax_shape():
    """``run_serve_open_sweep`` probes each rate (every probe verified),
    then drains the configured rate with the knee block attached, in the
    shape of JAX's (``crdt_benches_tpu/serve/bench.py``
    ``run_serve_open_sweep``)."""
    logs = []
    rep = run_serve_open_sweep([24, 96], open_spec="48:burst",
                               **dict(TINY, n_docs=8, log=logs.append))
    knee = rep["knee"]
    assert rep["verify_ok"] and rep["ingest"]["open"]["rate"] == 48.0
    assert set(knee) == {"version", "process", "capacity_ops_per_round",
                         "points"}
    assert knee["version"] == 1 and knee["process"] == "burst"
    assert [p["offered_rate"] for p in knee["points"]] == [24.0, 48.0, 96.0]
    for p in knee["points"]:
        assert set(p) == {"offered_rate", "served_rate", "rounds", "p50_ms",
                          "p99_ms", "deferred_ops", "shed_ops", "verify_ok",
                          "utilization"}
        assert p["verify_ok"] and p["rounds"] > 0
        assert p["utilization"] == round(
            p["offered_rate"] / knee["capacity_ops_per_round"], 4)
    assert knee["capacity_ops_per_round"] == max(
        p["served_rate"] for p in knee["points"])
    assert sum("sweep probe" in m for m in logs) == 3
    assert any(m.startswith("serve: knee: capacity") for m in logs)


def test_front_is_released_when_the_drain_raises():
    """A drain that raises leaves no listening socket and no front
    thread: the bench stops the front on every exit path."""
    logs = []

    def broken(pool):
        def macro_step(*_a, **_k):
            raise RuntimeError("injected dispatch failure")
        pool.macro_step = macro_step

    with pytest.raises(RuntimeError, match="injected dispatch failure"):
        run_serve_bench(**dict(TINY, n_docs=4, log=logs.append),
                        open_spec="32", pool_hook=broken)
    (line,) = [m for m in logs if m.startswith("serve: ingest front on")]
    port = int(line.split(":")[2].split(" ")[0])
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1.0)
    assert "serve-ingest" not in {t.name for t in threading.enumerate()}


@pytest.mark.parametrize("kw,msg", [
    (dict(open_spec="32", longhaul=1, journal_dir="auto"),
     "--serve-open is its own bench family"),
    (dict(open_spec="32", serve_tiers="warm=4"),
     "--serve-open is its own bench family"),
    (dict(open_spec="32", measure_recovery=True, journal_dir="auto"),
     "does not support the measured recovery"),
    (dict(open_spec="32", crash_after=3, journal_dir="auto"),
     "does not support the measured recovery"),
    (dict(open_spec="32", stream=True), "does not compose with --serve-open"),
    (dict(open_spec="32", reshard_spec="shrink:2:1", journal_dir="auto"),
     "--serve-open / --serve-stream do not compose"),
    (dict(tenants_spec="gold=8"), "--serve-tenants configures"),
    (dict(deadline=True), "--serve-deadline selects EDF"),
    (dict(open_spec="32:steady"), "unknown arrival process"),
    (dict(open_spec="32", tenants_spec="gold=0"), "rate must be"),
    (dict(faults="conn_churn=1"), "--serve-open is required"),
    (dict(faults="tenant_flood=1"), "--serve-open is required"),
])
def test_bench_refusals_equal_jax_messages(kw, msg):
    """``run_serve_bench`` refuses what JAX's refuses, with its words,
    before any resource is taken (so the device is never asked)."""
    with pytest.raises(ValueError, match=msg):
        run_serve_bench(n_docs=4, device="cuda", log=lambda *_: None, **kw)


def test_open_chaos_drain_recovers_through_the_journal(tmp_path):
    """The JAX bench smoke's open chaos leg at the tiny bands: both ingest
    kinds fire and recover over the live wire, the fleet verifies, and the
    journal recovers through ``recover_fleet`` (and its redo tail) to the
    drained fleet, doc for doc."""
    drained = {}

    def keep_decodes(pool):
        close = pool.close

        def closing():
            drained.update({d: pool.decode(d) for d in pool.docs
                            if pool.docs[d].length})
            close()
        pool.close = closing

    jd = str(tmp_path / "journal")
    rep = run_serve_bench(**dict(TINY, n_docs=16), open_spec="64",
                          tenants_spec="gold=48:192,free=16:32:128",
                          deadline=True, journal_dir=jd, snapshot_every=3,
                          faults="seed=5,conn_churn@6=1,tenant_flood@10=1",
                          pool_hook=keep_decodes)
    assert rep["verify_ok"] and rep["faults_ok"]
    evs = {e["kind"]: e for e in rep["faults"]["events"]}
    assert all(evs[k]["fired"] and evs[k]["recovered"]
               for k in ("conn_churn", "tenant_flood"))
    front = rep["ingest"]["front"]
    assert front["churn_drops"] >= 1 and front["sessions_resumed"] >= 1
    assert rep["ingest"]["client"]["errors"] == 0
    sessions = build_fleet(16, mix=TINY_MIX, seed=3, arrival_span=2,
                           bands=TINY_BANDS)
    pool = DocPool(classes=(128, 512), slots=(8, 4), device="cpu")
    streams = prepare_streams(sessions, pool, batch=16)
    rec = pj.recover_fleet(pool, streams, jd)
    from crdt_benches_tpu_torch.serve.scheduler import FleetScheduler

    sched = FleetScheduler(pool, streams, batch=16, macro_k=8,
                           start_round=rec.resume_round)
    sched.run()
    assert sched.done and rec.snapshot_round >= 0
    assert sorted(d for d, st in streams.items() if st.lossy) == rep[
        "lossy_docs"]
    assert {d: pool.decode(d) for d in pool.docs
            if pool.docs[d].length} == drained
    pool.close()
