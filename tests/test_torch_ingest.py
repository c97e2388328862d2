"""The port's live ingest front (``serve/ingest/``: wire framing, the spec
parsers, the open-loop plan, per-tenant admission, the live front and the
wire client) against the JAX package's, mirroring ``tests/test_ingest.py``.

Tolerance: exact.  The frame bytes, the parsers' values and messages, every
plan frame, every admission verdict with the controller's state after it,
and the Prometheus text of a bound registry equal JAX's; the live front is
driven over loopback through the protocol JAX's tests pin, and each
package's wire client delivers a whole plan to the other package's front.
A live socket never waits more than a few seconds here."""

import json
import socket
import threading
import time
import zlib

import pytest

from crdt_benches_tpu.obs import metrics as jax_metrics
from crdt_benches_tpu.obs import status as jax_status
from crdt_benches_tpu.serve.ingest import admission as jadm
from crdt_benches_tpu.serve.ingest import front as jfront
from crdt_benches_tpu.serve.ingest import loadgen as jload
from crdt_benches_tpu.serve.pool import DocPool as JaxPool
from crdt_benches_tpu.serve.scheduler import prepare_streams as jax_prepare
from crdt_benches_tpu.serve.workload import build_fleet as jax_build_fleet
from crdt_benches_tpu_torch.obs import metrics as port_metrics
from crdt_benches_tpu_torch.obs import status as port_status
from crdt_benches_tpu_torch.serve.ingest import admission as padm
from crdt_benches_tpu_torch.serve.ingest import front as pfront
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


def _outcome(fn, *a, **k):
    """A call's value, or its exception's type name and message."""
    try:
        return ("ok", fn(*a, **k))
    except Exception as e:  # noqa: BLE001 (the outcome is compared)
        return (type(e).__name__, str(e))


# ---- wire framing ----

FRAMES = [
    {"t": "hello", "session": "s7", "doc": 7, "tenant": "gold",
     "resume": False},
    {"t": "ops", "seq": 3, "start": 0, "count": 8, "round": 2},
    {"t": "bye", "session": "sé中", "z": [1, {"b": 2, "a": None}],
     "f": 0.5},
    {"t": "ops", "seq": 2 ** 40, "start": -1, "count": 0, "round": 10 ** 9},
]


@pytest.mark.parametrize("obj", FRAMES, ids=["hello", "ops", "bye", "big"])
def test_encode_frame_bytes_equal_jax(obj):
    raw = pfront.encode_frame(obj)
    assert raw == jfront.encode_frame(obj)
    assert pfront.decode_frame(raw) == obj == jfront.decode_frame(raw)
    assert raw.endswith(b"\n") and raw[8:9] == b" "


def _framed(body: bytes) -> bytes:
    return f"{zlib.crc32(body):08x} ".encode() + body + b"\n"


BAD_LINES = {
    "short": b"deadbeef\n",
    "empty": b"\n",
    "no_space": b"0123456789{}\n",
    "bad_crc_field": b"nothexx! {}\n",
    "crc_mismatch": bytes(pfront.encode_frame({"t": "ops", "seq": 1}))[:-3]
    + b"X}\n",
    "list": _framed(b"[1,2]"),
    "no_t": _framed(b'{"x":1}'),
    "string": _framed(b'"t"'),
    "not_json": _framed(b"{broken"),
}


@pytest.mark.parametrize("name", sorted(BAD_LINES))
def test_decode_frame_rejects_what_jax_rejects(name):
    line = BAD_LINES[name]
    got = _outcome(pfront.decode_frame, line)
    want = _outcome(jfront.decode_frame, line)
    assert got[0] != "ok"
    assert got == want


def test_decode_frame_accepts_crlf_and_keeps_the_constants():
    line = pfront.encode_frame({"t": "ops", "seq": 0})[:-1] + b"\r\n"
    assert pfront.decode_frame(line) == jfront.decode_frame(line)
    assert pfront.FRAME_KINDS == jfront.FRAME_KINDS
    assert pfront.DEFAULT_CAPACITY == jfront.DEFAULT_CAPACITY == 1024


# ---- spec parsers ----

OPEN_SPECS = ["32", "64:burst", "12.5:poisson", " 8 : burst", "1e3",
              "", "0", "-4", "32:steady", "x", "32:poisson:extra", "nan",
              "inf", "4:"]


@pytest.mark.parametrize("spec", OPEN_SPECS)
def test_parse_open_spec_equals_jax(spec):
    assert (_outcome(pload.parse_open_spec, spec)
            == _outcome(jload.parse_open_spec, spec))


TENANT_SPECS = ["gold=48:192,free=8:16:64", "t=10", " a = 4 , b=2:0:3 ,",
                "", "=4", "t=", "t=0", "t=-3", "t=4:x", "t=4:8:2:9",
                "a=4,a=8", "t=inf", "t=4:-1", "t=4:8:-2", "t=4:8:2.5", ",",
                "noeq"]


def _policies(mod, spec):
    return {n: (p.name, p.rate, p.burst, p.budget, p.to_dict())
            for n, p in mod.parse_tenant_spec(spec).items()}


@pytest.mark.parametrize("spec", TENANT_SPECS)
def test_parse_tenant_spec_equals_jax(spec):
    got = _outcome(_policies, padm, spec)
    want = _outcome(_policies, jadm, spec)
    assert got == want
    if got[0] != "ok":
        assert got[0] == "TenantSpecError"


def test_tenant_policy_refusals_equal_jax():
    for args in ((("", 4.0), {}), (("t", 4.0), {"burst": -1.0}),
                 (("t", 0.0), {}), (("t", 4.0), {"budget": -2})):
        got = _outcome(padm.TenantPolicy, *args[0], **args[1])
        want = _outcome(jadm.TenantPolicy, *args[0], **args[1])
        assert got == want and got[0] == "TenantSpecError"
    assert padm.DEFAULT_TENANT == jadm.DEFAULT_TENANT == "default"


# ---- the open-loop plan ----


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The same 12-doc fleet prepared by each package (B = 16)."""
    tmp = tmp_path_factory.mktemp("ingest_fleets")
    out = {}
    for side, build, Pool, prep, kw in (
            ("jax", jax_build_fleet, JaxPool, jax_prepare, {}),
            ("port", build_fleet, DocPool, prepare_streams,
             {"device": "cpu"})):
        sessions = build(12, mix=TINY_MIX, seed=5, arrival_span=3,
                         bands=TINY_BANDS)
        pool = Pool(classes=(128, 512), slots=(6, 3), prefetch=False,
                    spool_dir=str(tmp / side), **kw)
        out[side] = prep(sessions, pool, batch=16)
        pool.close()
    return out


def _plan_facts(plan):
    return (plan.to_dict(), plan.tenant_of, plan.total_frames,
            [(s.session, s.doc, s.tenant, s.frames) for s in plan.sessions])


@pytest.mark.parametrize("process", ["poisson", "burst"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rate", [6.0, 48.0])
def test_build_open_plan_equals_jax_frame_for_frame(fleets, process, seed,
                                                     rate):
    tenants = ("gold", "free", "bronze")
    p = pload.build_open_plan(fleets["port"], rate=rate, process=process,
                              seed=seed, tenant_names=tenants)
    j = jload.build_open_plan(fleets["jax"], rate=rate, process=process,
                              seed=seed, tenant_names=tenants)
    assert _plan_facts(p) == _plan_facts(j)
    total = sum(st.n_total for st in fleets["port"].values())
    assert p.total_ops == total
    for s in p.sessions:
        # start-sorted, contiguous, covering the whole stream
        cum = 0
        for _rnd, start, count in s.frames:
            assert start == cum and count > 0
            cum += count
        assert cum == fleets["port"][s.doc].n_total
    assert set(p.tenant_of.values()) <= set(tenants)


def test_build_open_plan_refusals_equal_jax(fleets):
    class _Empty:
        n_total = 0
        arrival = 0

    got = _outcome(pload.build_open_plan, {0: _Empty()}, rate=4.0)
    assert got == _outcome(jload.build_open_plan, {0: _Empty()}, rate=4.0)
    assert got[0] == "ValueError"
    # the default tenant when none is named
    p = pload.build_open_plan(fleets["port"], rate=8.0)
    j = jload.build_open_plan(fleets["jax"], rate=8.0)
    assert _plan_facts(p) == _plan_facts(j)
    assert set(p.tenant_of.values()) == {"default"}


# ---- admission ----


class _FakeSlo:
    """``status_fields()`` stand-in: exact per-class burn rates."""

    def __init__(self, classes):
        self.classes = classes

    def status_fields(self):
        return {"classes": self.classes}


BURNS = {
    "c128": {"burn_fast": 2.0, "burn_slow": 1.5},
    "c512": {"burn_fast": 1.8, "burn_slow": 0.4},
    "c4096": {"burn_fast": 0.2, "burn_slow": 0.1},
    "c8192": {"burn_fast": 1.0, "burn_slow": 3.0},
}


def _adm_state(adm):
    return (adm.to_dict(), dict(adm.tokens), dict(adm.decisions),
            {k: adm.burn(k) for k in (*BURNS, "nope")})


@pytest.mark.parametrize("spec", ["gold=16:32,free=4:8:24",
                                  "a=1.5,b=40:40:40,c=7:100"])
@pytest.mark.parametrize("slo", [False, True])
def test_admission_decisions_equal_jax(spec, slo):
    """A decision matrix over tokens, budgets, burns and the defer limit,
    with refills between passes: every verdict and the controller's state
    after it equal JAX's."""
    ctl = {side: mod.AdmissionController(
        mod.parse_tenant_spec(spec),
        slo=_FakeSlo(dict(BURNS)) if slo else None)
        for side, mod in (("port", padm), ("jax", jadm))}
    for c in ctl.values():
        c.refill()
    tenants = sorted(ctl["port"].policies)
    n = 0
    for rnd in range(6):
        for tenant in tenants:
            for klass in (*BURNS, "nope"):
                for ops in (1, 8, 24):
                    for pending in (0, 20, 60):
                        for defers in (0, padm.AdmissionController.MAX_DEFERS
                                       - 1, 64):
                            got = ctl["port"].decide(tenant, ops, klass,
                                                     pending, defers)
                            want = ctl["jax"].decide(tenant, ops, klass,
                                                     pending, defers)
                            assert got == want, (rnd, tenant, klass, ops,
                                                 pending, defers)
                            n += 1
        assert _adm_state(ctl["port"]) == _adm_state(ctl["jax"])
        for c in ctl.values():
            c.refill()
    assert n > 1000
    assert (padm.AdmissionController.MAX_DEFERS
            == jadm.AdmissionController.MAX_DEFERS == 64)
    verdicts = {k.split(":")[0] for k in ctl["port"].decisions}
    assert verdicts == {"admit", "defer", "shed"}
    for c in ctl.values():
        with pytest.raises(KeyError, match="unknown tenant"):
            c.decide("mystery", 1, "c128", 0)


def test_admission_matrix_of_jax_tests_on_the_port():
    """tests/test_ingest.py's admission assertions, run on the port."""
    adm = padm.AdmissionController(
        padm.parse_tenant_spec("gold=16:32,free=4:8:24"),
        slo=_FakeSlo({k: BURNS[k] for k in ("c128", "c512", "c4096")}))
    adm.refill()
    assert adm.decide("gold", 8, "c128", pending=0) == ("shed",
                                                        "burn_sustained")
    assert adm.decide("gold", 8, "c512", pending=0) == ("defer",
                                                        "burn_spike")
    assert adm.decide("gold", 8, "c4096", pending=0) == ("admit", "ok")
    adm = padm.AdmissionController(
        padm.parse_tenant_spec("gold=16:32,free=4:8:24"))
    adm.refill()
    assert adm.decide("free", 8, "c128", pending=20) == ("defer",
                                                         "queue_budget")
    assert adm.decide("free", 8, "c128", pending=0) == ("admit", "ok")
    assert adm.decide("free", 8, "c128", pending=0) == ("defer", "tokens")
    adm.refill()
    assert adm.decide("free", 8, "c128", pending=0) == ("defer", "tokens")
    adm.refill()
    assert adm.decide("free", 8, "c128", pending=0) == ("admit", "ok")
    assert adm.admitted_ops["free"] == 16 and adm.deferred_ops["free"] == 24
    assert adm.tokens["gold"] == 32.0


def test_bound_registry_prometheus_text_equals_jax():
    """``bind`` registers the labelled per-tenant series; after the same
    decisions each package's registry renders JAX's Prometheus text."""
    text = {}
    for side, mod, metrics, status in (
            ("port", padm, port_metrics, port_status),
            ("jax", jadm, jax_metrics, jax_status)):
        reg = metrics.MetricsRegistry()
        adm = mod.AdmissionController(
            mod.parse_tenant_spec("gold=16:32,free=4:8:24"))
        adm.bind(reg)
        for _ in range(3):
            adm.refill()
            for t in ("gold", "free"):
                adm.decide(t, 8, "c128", 0)
                adm.decide(t, 30, "c128", 0)
        adm.decide("free", 8, "c128", 0, defers=64)
        text[side] = status.render_prometheus(reg.to_dict())
    assert text["port"] == text["jax"]
    lines = text["port"].splitlines()
    for want in ('serve_ingest_admitted_ops_total{tenant="gold"} 24',
                 'serve_ingest_shed_ops_total{tenant="free"} 8',
                 'serve_ingest_tokens{tenant="gold"} 32',
                 "# TYPE serve_ingest_deferred_ops_total counter"):
        assert want in lines, want


# ---- the live front over loopback ----


def _connect(port):
    sk = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    return sk, sk.makefile("rwb")


def _xchg(f, obj):
    f.write(pfront.encode_frame(obj))
    f.flush()
    return json.loads(f.readline())


def test_live_front_session_protocol():
    """tests/test_ingest.py::test_live_front_session_protocol on the
    port's front."""
    front = pfront.IngestFront({7}, ("gold",))
    port = front.start()
    try:
        for hello, why in (
            ({"t": "hello", "session": "s0", "doc": 9, "tenant": "gold"},
             "unknown doc"),
            ({"t": "hello", "session": "s0", "doc": 7, "tenant": "x"},
             "unknown tenant"),
        ):
            sk, f = _connect(port)
            r = _xchg(f, hello)
            assert r["t"] == "err" and why in r["why"]
            sk.close()
        sk, f = _connect(port)
        r = _xchg(f, {"t": "ops", "seq": 0, "count": 4})
        assert r["t"] == "err" and "before hello" in r["why"]
        sk.close()
        sk, f = _connect(port)
        r = _xchg(f, {"t": "hello", "session": "s1", "doc": 7,
                      "tenant": "gold"})
        assert r == {"t": "ack", "seq": -1}
        r = _xchg(f, {"t": "hello", "session": "s1", "doc": 7,
                      "tenant": "gold"})
        assert r == {"t": "err", "why": "double hello"}
        sk.close()
        sk, f = _connect(port)
        _xchg(f, {"t": "hello", "session": "s1", "doc": 7, "tenant": "gold"})
        # a frame planned past now + PACE_SLACK is retried, not acked
        r = _xchg(f, {"t": "ops", "seq": 0, "start": 0, "count": 4,
                      "round": 9})
        assert r == {"t": "retry", "seq": 0}
        front.now = 7  # the pump's clock publish
        r = _xchg(f, {"t": "ops", "seq": 0, "start": 0, "count": 4,
                      "round": 9})
        assert r == {"t": "ack", "seq": 0}
        r = _xchg(f, {"t": "ops", "seq": 0, "start": 4, "count": 4,
                      "round": 9})
        assert r["t"] == "err" and "seq" in r["why"]
        sk.close()
        sk, f = _connect(port)
        _xchg(f, {"t": "hello", "session": "s2", "doc": 7, "tenant": "gold"})
        r = _xchg(f, {"t": "what"})
        assert r == {"t": "err", "why": "unknown kind 'what'"}
        sk.close()
        sk, f = _connect(port)
        _xchg(f, {"t": "hello", "session": "s3", "doc": 7, "tenant": "gold"})
        assert _xchg(f, {"t": "bye"})["t"] == "ack"
        sk.close()
        sk, f = _connect(port)
        f.write(b"00000000 {broken\n")
        f.flush()
        assert json.loads(f.readline())["t"] == "err"
        sk.close()
        deadline = time.monotonic() + 5
        payloads = []
        while time.monotonic() < deadline:
            payloads += front.drain()
            if [p["kind"] for p in payloads].count("bad_frame") >= 2:
                break
            time.sleep(0.01)
        kinds = [p["kind"] for p in payloads]
        assert kinds.count("hello") == 4
        assert kinds.count("ops") == 1
        assert kinds.count("bye") == 1
        assert kinds.count("bad_frame") == 2  # the seq regression, the CRC
        assert front.sessions_opened == 4 and front.sessions_closed == 1
        assert front.ops_delivered == 4 and front.bad_frames == 2
        fields = front.status_fields()
        assert fields["port"] == port and fields["queue_depth"] == 0
        assert fields["frames"] == len(payloads)
    finally:
        front.stop()
    front.stop()  # idempotent
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1.0)


def test_live_front_churn_drops_and_resume():
    """tests/test_ingest.py::test_live_front_churn_drops_connection on
    the port's front, and a full queue turning into a client retry."""
    front = pfront.IngestFront({3}, ("default",), capacity=8,
                               put_timeout=0.05)
    port = front.start()
    try:
        sk, f = _connect(port)
        _xchg(f, {"t": "hello", "session": "s0", "doc": 3,
                  "tenant": "default"})
        front.now = 10
        front.churn()
        assert front.churn_gen == 1
        r = _xchg(f, {"t": "ops", "seq": 0, "count": 2, "round": 0})
        assert r == {"t": "churn"}
        sk.close()
        got = front.drain()
        assert [p["kind"] for p in got] == ["hello", "churn_drop"]
        assert got[1] == {"kind": "churn_drop", "session": "s0", "doc": 3,
                          "tenant": "default"}
        assert front.churn_drops == 1
        sk, f = _connect(port)
        r = _xchg(f, {"t": "hello", "session": "s0", "doc": 3,
                      "tenant": "default", "resume": True})
        assert r["t"] == "ack"
        # fill the bounded queue (8): the next ops frame is a retry
        seq = 0
        replies = []
        for _ in range(9):
            replies.append(_xchg(f, {"t": "ops", "seq": seq, "start": seq,
                                     "count": 1, "round": 0}))
            if replies[-1]["t"] == "ack":
                seq += 1
        assert replies[-1] == {"t": "retry", "seq": 7}
        assert sum(r["t"] == "ack" for r in replies) == 7
        sk.close()
        front.drain()
        assert front.sessions_resumed == 1 and front.sessions_opened == 2
        assert front.ops_delivered == 7 and front.idle
    finally:
        front.stop()


def test_dead_listener_exhausts_retry_budget_with_typed_error():
    """A client pointed at a port nobody listens on burns its capped,
    jittered retry budget and raises ``RetryBudgetExceeded``."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    plan = pload.OpenLoadPlan(
        [pload._SessionLoad("s0", 0, "default", [(0, 0, 4)]),
         pload._SessionLoad("s1", 1, "default", [(0, 0, 4)])],
        rate=8.0, process="poisson", seed=3, total_ops=8, horizon=1)
    client = pload.OpenLoadClient(port, plan, shards=1, connect_timeout=0.2,
                                  retry_base=0.0005, retry_cap=0.002,
                                  retry_budget=6)
    t0 = time.monotonic()
    client.start()
    with pytest.raises(pload.RetryBudgetExceeded) as ei:
        client.join(timeout=30.0)
    assert time.monotonic() - t0 < 10.0
    err = ei.value
    assert err.session == "s0" and err.doc == 0
    assert err.attempts == 6 and err.last_error
    assert "retry budget exhausted" in str(err)
    assert client.sent_frames == 0 and client.errors == 1
    assert client.to_dict() == {"shards": 1, "sent_frames": 0,
                                "retries": 0, "reconnects": 0, "errors": 1,
                                "retry_budget": 6}


def test_backoff_jitter_equals_jax(monkeypatch):
    """The per-session seeded jitter ``(seed << 20) ^ (doc + 1)`` and the
    capped exponent: the same sleeps as JAX's ``_Backoff``."""
    import numpy as np

    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    out = {}
    for side, mod in (("port", pload), ("jax", jload)):
        slept.clear()
        bo = mod._Backoff(np.random.default_rng((5 << 20) ^ (3 + 1)),
                          base=0.005, cap=0.05, budget=7)
        ok = [bo.sleep() for _ in range(4)]
        bo.progress()
        ok += [bo.sleep() for _ in range(5)]
        out[side] = (ok, list(slept), bo.attempts)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [True] * 7 + [False] * 2


def _pump_front(front, done, stop_at):
    """The hot side of a wire test: the clock far ahead (nothing is
    paced), the queue drained until the client is done."""
    front.now = 10 ** 9
    while not done() and time.monotonic() < stop_at:
        front.drain()
        time.sleep(0.002)
    front.drain()


@pytest.mark.parametrize("direction", ["port_client_jax_front",
                                       "jax_client_port_front"])
def test_cross_package_wire_delivers_the_whole_plan(fleets, direction):
    """Each package's wire client against the other package's front:
    every planned frame acked, every op delivered, no error."""
    cmod, fmod, streams = ((pload, jfront, fleets["port"])
                           if direction == "port_client_jax_front"
                           else (jload, pfront, fleets["jax"]))
    plan = cmod.build_open_plan(streams, rate=48.0, seed=3,
                                tenant_names=("gold", "free"))
    front = fmod.IngestFront(set(streams), ("gold", "free"))
    port = front.start()
    try:
        client = cmod.OpenLoadClient(port, plan, shards=2)
        client.start()
        _pump_front(front, lambda: client.finished, time.monotonic() + 30)
        client.join(timeout=10)
    finally:
        front.stop()
    assert client.errors == 0 and client.reconnects == 0
    assert client.sent_frames == plan.total_frames
    f = front.status_fields()
    assert f["ops_delivered"] == plan.total_ops
    assert f["ops_frames"] == plan.total_frames
    assert f["sessions_opened"] == f["sessions_closed"] == len(plan.sessions)
    assert f["bad_frames"] == f["churn_drops"] == 0


def test_wire_client_resumes_after_churn(fleets):
    """A churn while the client's first session waits on a frame planned
    ahead of the clock: the port's client reconnects with ``resume`` and
    re-sends, and the front still sees every op."""
    streams = fleets["port"]
    plan = pload.build_open_plan(streams, rate=48.0, seed=1)
    assert plan.sessions[0].frames[-1][0] > 2  # the clock holds it back
    front = pfront.IngestFront(set(streams))
    port = front.start()
    try:
        client = pload.OpenLoadClient(port, plan, shards=1)
        client.start()
        stop_at = time.monotonic() + 30
        while front.ops_frames < 1:  # the first session is open
            assert time.monotonic() < stop_at
            front.drain()
            time.sleep(0.002)
        front.churn()
        _pump_front(front, lambda: client.finished, stop_at)
        client.join(timeout=10)
    finally:
        front.stop()
    assert client.errors == 0 and client.reconnects >= 1
    assert client.retries >= 1
    assert front.churn_drops >= 1 and front.sessions_resumed >= 1
    assert front.ops_delivered >= plan.total_ops
    assert front.sessions_closed == len(plan.sessions)


def test_no_thread_left_after_stop():
    before = {t.name for t in threading.enumerate()}
    front = pfront.IngestFront({0})
    front.start()
    assert "serve-ingest" in {t.name for t in threading.enumerate()}
    front.stop()
    assert {t.name for t in threading.enumerate()} <= before


def test_many_shards_under_a_short_switch_interval(fleets):
    """A stress of the front's one crossing: more client shards than
    cores, a 1 us switch interval, a small queue (so full-queue retries
    happen) and the hot side draining concurrently: every op arrives
    once, no session is lost, within a time bound."""
    import os
    import sys

    streams = fleets["port"]
    plan = pload.build_open_plan(streams, rate=48.0, seed=9)
    front = pfront.IngestFront(set(streams), capacity=8, put_timeout=0.01)
    port = front.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        client = pload.OpenLoadClient(
            port, plan, shards=max(len(plan.sessions), 2 * os.cpu_count()))
        client.start()
        _pump_front(front, lambda: client.finished, time.monotonic() + 60)
        client.join(timeout=10)
    finally:
        sys.setswitchinterval(old)
        front.stop()
    assert all(not t.is_alive() for t in client._threads)
    assert client.errors == 0
    assert client.sent_frames == plan.total_frames
    assert front.ops_delivered == plan.total_ops
    assert front.sessions_closed == len(plan.sessions)
