"""The open-loop load family (the JAX package's
``serve/ingest/loadgen.py``): arrival plans, the wire client, the hot
pump, and the drive loop that takes ``FleetScheduler.run``'s place for
``serve/open/<mix>/<fleet>``.

**Open loop** means arrivals do not wait for the system: each session's
ops arrive on a seeded Poisson (or burst) process at a configured offered
load (total ops a macro-round over the fleet), whether or not the
scheduler keeps up.  A closed-loop replay measures how fast the engine
drains; the open loop measures what latency it holds at THIS offered load,
which is why the knee curve (p99 against utilization) exists.

The moving parts and their threads:

- :func:`build_open_plan` (the bench) turns the fleet's sessions into
  per-session frame schedules, ``(round, start, count)`` triples drawn
  from the seeded arrival process; immutable once built;
- :class:`OpenLoadClient` (its shard threads): real TCP clients speaking
  the CRC frame protocol against the live front, one connection a
  session, a synchronous ack a frame (the session's order by
  construction), reconnect-and-resume on churn;
- :class:`IngestPump` (the hot thread) drains the front's queue, runs the
  per-tenant admission and feeds admitted batches into the scheduler's
  bounded per-doc queues through ``_push_delivery`` (the bounded-admission
  rule every producer uses).  Frames carry their planned round, and the
  pump releases none earlier: the wire is transport, the plan is the
  arrival process;
- :func:`drive_open_loop` (the hot thread): the macro-round loop of pump,
  ``run_round`` and an explicit clock tick for rounds where the queues are
  empty but producers still owe ops (the base scheduler's idle jump only
  knows the static arrival schedule).
"""

from __future__ import annotations

import json
import math
import queue
import socket
import threading
import time

import numpy as np

from ...obs.trace import span
from .admission import DEFAULT_TENANT
from .front import encode_frame

__all__ = [
    "parse_open_spec",
    "OpenLoadPlan",
    "build_open_plan",
    "OpenLoadClient",
    "RetryBudgetExceeded",
    "IngestPump",
    "drive_open_loop",
]

#: target ops per frame: sessions whose per-round rate is tiny batch
#: several rounds into one frame (the wire stays cheap; the pump still
#: releases at the planned round).
TARGET_FRAME_OPS = 8

#: rounds a tenant flood inflates admission pressure for.
FLOOD_SPAN = 4

#: seconds the drive loop sleeps on a round in which only the wire is
#: live (waiting on the client, not the CPU)
WIRE_SLEEP = 0.0005

#: consecutive dead clock ticks (client done, nothing held, nothing
#: draining) before the drive loop declares the drain stuck.
STUCK_TICKS = 64


def parse_open_spec(spec: str) -> tuple[float, str]:
    """``RATE`` or ``RATE:poisson`` / ``RATE:burst`` → (rate, process).

    ``RATE`` is total offered ops per macro-round across the fleet.
    """
    s = str(spec).strip()
    rate_s, _, proc = s.partition(":")
    proc = proc.strip() or "poisson"
    if proc not in ("poisson", "burst"):
        raise ValueError(
            f"--serve-open: unknown arrival process {proc!r} "
            "(expected poisson or burst)"
        )
    try:
        rate = float(rate_s)
    except ValueError:
        raise ValueError(
            f"--serve-open: bad rate {rate_s!r} (want ops/round)"
        ) from None
    if rate <= 0 or not math.isfinite(rate):
        raise ValueError(f"--serve-open: rate must be positive, got {rate}")
    return rate, proc


class _SessionLoad:
    """One session's immutable send schedule."""

    __slots__ = ("session", "doc", "tenant", "frames")

    def __init__(self, session: str, doc: int, tenant: str,
                 frames: list[tuple[int, int, int]]):
        self.session = session
        self.doc = doc
        self.tenant = tenant
        self.frames = frames  # [(round, start, count)] — start-sorted


class OpenLoadPlan:
    """The whole fleet's arrival schedule (immutable after build)."""

    def __init__(self, sessions: list[_SessionLoad], *, rate: float,
                 process: str, seed: int, total_ops: int, horizon: int):
        self.sessions = sessions
        self.rate = rate
        self.process = process
        self.seed = seed
        self.total_ops = total_ops
        self.horizon = horizon
        self.tenant_of = {s.doc: s.tenant for s in sessions}
        self.total_frames = sum(len(s.frames) for s in sessions)

    def to_dict(self) -> dict:
        return {
            "rate": self.rate,
            "process": self.process,
            "seed": self.seed,
            "sessions": len(self.sessions),
            "total_ops": self.total_ops,
            "total_frames": self.total_frames,
            "horizon": self.horizon,
        }


def build_open_plan(streams, *, rate: float, process: str = "poisson",
                    seed: int = 0,
                    tenant_names=(DEFAULT_TENANT,)) -> OpenLoadPlan:
    """Draw every session's frame schedule from the seeded arrival
    process.

    The fleet's offered load ``rate`` (ops/round) is split across
    sessions proportionally to their stream lengths; each session's
    ops then arrive Poisson (per-quantum counts) or in bursts
    (geometric gaps, Poisson burst sizes) starting at its existing
    arrival round.  Tenants are assigned round-robin over the sorted
    tenant names (deterministic given the doc order).
    """
    rng = np.random.default_rng(seed)
    tenants = sorted(tenant_names) or [DEFAULT_TENANT]
    docs = sorted(streams)
    total = sum(max(0, streams[d].n_total) for d in docs)
    if total <= 0:
        raise ValueError("open plan: fleet has no ops to offer")
    sessions: list[_SessionLoad] = []
    horizon = 0
    duration = max(1, int(math.ceil(total / rate)))
    for i, doc in enumerate(docs):
        st = streams[doc]
        n = st.n_total
        if n <= 0:
            continue
        lam = rate * n / total
        arrival = int(st.arrival)
        # flush anything still unsent past this point: a straggler tail
        # must not stretch the drain unboundedly (counted in the frame
        # schedule, not silently dropped)
        flush_at = arrival + max(64, 8 * duration)
        tenant = tenants[i % len(tenants)]
        frames: list[tuple[int, int, int]] = []
        cum = 0
        if process == "burst":
            burst = max(4.0, lam * 8.0)
            p = min(1.0, lam / burst)
            r = arrival
            while cum < n:
                r += int(rng.geometric(p))
                if r >= flush_at:
                    frames.append((flush_at, cum, n - cum))
                    cum = n
                    break
                k = 1 + int(rng.poisson(burst - 1.0))
                k = min(k, n - cum)
                frames.append((r, cum, k))
                cum += k
        else:
            q = 1 if lam >= TARGET_FRAME_OPS else min(
                16, int(math.ceil(TARGET_FRAME_OPS / lam)))
            r = arrival
            while cum < n:
                if r >= flush_at:
                    frames.append((flush_at, cum, n - cum))
                    cum = n
                    break
                k = int(rng.poisson(lam * q))
                k = min(k, n - cum)
                if k > 0:
                    frames.append((r, cum, k))
                    cum += k
                r += q
        if frames:
            horizon = max(horizon, frames[-1][0])
        sessions.append(_SessionLoad(f"s{doc}", doc, tenant, frames))
    return OpenLoadPlan(sessions, rate=rate, process=process, seed=seed,
                        total_ops=total, horizon=horizon)


class RetryBudgetExceeded(RuntimeError):
    """A session burned its whole retry budget without progress — the
    front is unreachable (dead listener) or permanently refusing.  The
    typed error carries enough to act on: silent ``errors`` counters
    made a dead listener look like load-shedding."""

    def __init__(self, session: str, doc: int, attempts: int,
                 elapsed_s: float, last_error: str):
        super().__init__(
            f"session {session} (doc {doc}): retry budget exhausted "
            f"after {attempts} attempts over {elapsed_s:.2f}s "
            f"(last error: {last_error})"
        )
        self.session = session
        self.doc = doc
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last_error = last_error


class _Backoff:
    """Capped exponential backoff with seeded jitter and a TOTAL retry
    budget.  ``sleep()`` returns False once the budget is spent —
    progress (an acked frame) resets the exponent, never the budget,
    so a flapping front still terminates."""

    def __init__(self, rng, *, base: float, cap: float, budget: int):
        self.rng = rng
        self.base = float(base)
        self.cap = float(cap)
        self.budget = int(budget)
        self.attempts = 0  # total, never reset
        self._streak = 0  # consecutive failures, reset on progress

    def sleep(self) -> bool:
        self.attempts += 1
        if self.attempts > self.budget:
            return False
        delay = min(self.cap, self.base * (2.0 ** self._streak))
        self._streak += 1
        # full jitter (seeded): uniform over (0.5, 1.0] * delay keeps
        # the expected wait near delay while decorrelating shards
        time.sleep(delay * (0.5 + 0.5 * float(self.rng.random())))
        return True

    def progress(self) -> None:
        self._streak = 0


class OpenLoadClient:
    """Sharded wire clients replaying an :class:`OpenLoadPlan` against
    a live front.

    Each shard thread walks its sessions
    sequentially: connect, ``hello``, synchronous ``ops`` frames (ack
    per frame — in-session order by construction), ``bye``.  A
    ``retry`` reply (pump backpressure) re-sends the same frame; a
    ``churn`` reply or socket error reconnects with ``resume`` —
    delivery is idempotent downstream, so redelivery is safe.  Shard
    results cross back through a plain results queue read only after
    the shards finish.

    Every retry path — connect refusals, socket drops, ``retry``
    backpressure — shares one per-session :class:`_Backoff`: capped
    exponential delays with seeded jitter and a total budget of
    ``retry_budget`` attempts.  A session that exhausts the budget
    raises :class:`RetryBudgetExceeded`; ``join()`` re-raises the
    first such failure on the joining thread.
    """

    RETRY_BASE_S = 0.005
    RETRY_CAP_S = 0.25
    RETRY_BUDGET = 128

    def __init__(self, port: int, plan: OpenLoadPlan, *, shards: int = 2,
                 connect_timeout: float = 10.0,
                 retry_base: float | None = None,
                 retry_cap: float | None = None,
                 retry_budget: int | None = None):
        self.port = int(port)
        self.plan = plan
        self.shards = max(1, min(int(shards), len(plan.sessions) or 1))
        self.connect_timeout = float(connect_timeout)
        self.seed = int(plan.seed)
        self.retry_base = float(self.RETRY_BASE_S if retry_base is None
                                else retry_base)
        self.retry_cap = float(self.RETRY_CAP_S if retry_cap is None
                               else retry_cap)
        self.retry_budget = int(self.RETRY_BUDGET if retry_budget is None
                                else retry_budget)
        self._threads: list[threading.Thread] = []
        self._done_q: queue.Queue = queue.Queue()
        self._failures: queue.Queue = queue.Queue()
        # aggregated by join() after every shard reported
        self.sent_frames = 0
        self.retries = 0
        self.reconnects = 0
        self.errors = 0

    # ---- the caller's lifecycle ----

    def start(self) -> None:
        for i in range(self.shards):
            t = threading.Thread(
                target=self._run_shard, args=(i,),
                name=f"serve-ingest-load-{i}", daemon=True,
            )
            self._threads.append(t)
            t.start()

    @property
    def finished(self) -> bool:
        """True once every shard reported (safe on the hot thread: a qsize)."""
        return self._done_q.qsize() >= self.shards

    def join(self, timeout: float = 60.0) -> None:
        for t in self._threads:
            t.join(timeout=timeout)
        while True:
            try:
                sent, retries, reconnects, errors = self._done_q.get_nowait()
            except queue.Empty:
                break
            self.sent_frames += sent
            self.retries += retries
            self.reconnects += reconnects
            self.errors += errors
        try:
            raise self._failures.get_nowait()
        except queue.Empty:
            pass

    def to_dict(self) -> dict:
        return {
            "shards": self.shards,
            "sent_frames": self.sent_frames,
            "retries": self.retries,
            "reconnects": self.reconnects,
            "errors": self.errors,
            "retry_budget": self.retry_budget,
        }

    # ---- the load threads ----

    def _run_shard(self, shard: int) -> None:  # graftlint: thread=load
        sent = retries = reconnects = errors = 0
        try:
            for sess in self.plan.sessions[shard::self.shards]:
                try:
                    s, r, rc, e = self._run_session(sess)
                except RetryBudgetExceeded as exc:
                    # surface the TYPED failure to join() instead of
                    # burying it in a counter; remaining sessions on
                    # this shard are abandoned (the front is dead)
                    self._failures.put(exc)
                    errors += 1
                    break
                sent += s
                retries += r
                reconnects += rc
                errors += e
        finally:
            self._done_q.put((sent, retries, reconnects, errors))

    def _run_session(self, sess: _SessionLoad  # graftlint: thread=load
                     ) -> tuple[int, int, int, int]:
        sent = retries = reconnects = 0
        seq = 0
        idx = 0
        resume = False
        t0 = time.perf_counter()
        # one backoff per session, seeded from (client seed, doc): the
        # jitter sequence is deterministic given the plan, and distinct
        # sessions never sleep in lockstep
        bo = _Backoff(
            np.random.default_rng((self.seed << 20) ^ (sess.doc + 1)),
            base=self.retry_base, cap=self.retry_cap,
            budget=self.retry_budget,
        )

        def _spend(last: str) -> None:
            if not bo.sleep():
                raise RetryBudgetExceeded(
                    sess.session, sess.doc, bo.attempts - 1,
                    time.perf_counter() - t0, last,
                )

        while idx < len(sess.frames) or not resume:
            try:
                sk = socket.create_connection(
                    ("127.0.0.1", self.port), timeout=self.connect_timeout)
            except OSError as e:
                _spend(f"connect: {e}")
                continue
            try:
                f = sk.makefile("rwb")
                resp = self._xchg(f, {
                    "t": "hello", "session": sess.session,
                    "doc": sess.doc, "tenant": sess.tenant,
                    "resume": resume,
                })
                if resp.get("t") == "churn":
                    # churn fired between accept and hello: the handler
                    # saw a stale generation — reconnect like any drop
                    raise _Churned()
                if resp.get("t") != "ack":
                    return sent, retries, reconnects, 1
                while idx < len(sess.frames):
                    rnd, start, count = sess.frames[idx]
                    resp = self._xchg(f, {
                        "t": "ops", "seq": seq, "start": start,
                        "count": count, "round": rnd,
                    })
                    t = resp.get("t")
                    if t == "ack":
                        seq += 1
                        idx += 1
                        sent += 1
                        bo.progress()
                    elif t == "retry":
                        retries += 1
                        _spend("pump backpressure (retry)")
                    elif t == "churn":
                        raise _Churned()
                    else:
                        return sent, retries, reconnects, 1
                self._xchg(f, {"t": "bye", "session": sess.session})
                return sent, retries, reconnects, 0
            except _Churned:
                reconnects += 1
                resume = True
            except (OSError, ValueError) as e:
                reconnects += 1
                resume = True
                _spend(f"{type(e).__name__}: {e}")
            finally:
                try:
                    sk.close()
                except OSError:
                    pass
        return sent, retries, reconnects, 0

    @staticmethod
    def _xchg(f, obj: dict) -> dict:
        f.write(encode_frame(obj))
        f.flush()
        line = f.readline()
        if not line:
            raise OSError("connection closed")
        out = json.loads(line)
        if not isinstance(out, dict):
            raise ValueError("bad reply")
        return out


class _Churned(Exception):
    """Server dropped us (conn_churn): reconnect and resume."""


class IngestPump:
    """Hot-side glue: front → admission → bounded per-doc queues.

    Owns all cross-layer accounting (the ingest block of /status.json
    and the artifact).  Everything here runs on the hot thread; the
    only upstream contact is ``front.drain()`` (non-blocking) and the
    only downstream contact is the scheduler's own bounded-admission
    rule ``_push_delivery``."""

    def __init__(self, sched, front, admission, *, tenant_of,
                 faults=None):
        self.sched = sched
        self.front = front
        self.admission = admission
        self.tenant_of = dict(tenant_of)
        self.faults = faults
        self._holding: list[list] = []  # [payload, due_round, defers]
        self._klass: dict[int, str] = {}
        # counters (hot-owned)
        self.late_frames = 0
        self.admitted_frames = 0
        self.dup_frames = 0
        self.shed_docs = 0
        self.drained_frames = 0
        # chaos bookkeeping
        self._churn_ev = None
        self._churn_mark = 0
        self._flood_ev = None
        self._flood_tenant: str | None = None
        self._flood_factor = 1
        self._flood_until = -1
        self._flood_deferred = 0
        self._flood_shed = 0

    @property
    def idle(self) -> bool:
        return not self._holding and self.front.idle

    def _slo_class(self, doc: int) -> str:
        k = self._klass.get(doc)
        if k is None:
            rec = self.sched.pool.docs[doc]
            cls = self.sched.pool.class_for(max(rec.length, 1))
            slo = self.admission.slo
            k = slo.classify(cls) if slo is not None else "default"
            self._klass[doc] = k
        return k

    def step(self, rnd: int) -> bool:  # graftlint: thread=hot
        """One macro-round of intake: chaos hooks, bucket refill,
        drain the front, admit everything due.  Returns True while the
        pump still holds (or the front still buffers) work."""
        self._fault_hooks(rnd)
        self.front.now = rnd  # publish the clock (immutable int swap)
        self.admission.refill()
        for payload in self.front.drain():
            self.drained_frames += 1
            kind = payload.get("kind")
            if kind == "ops":
                due = int(payload.get("round", 0))
                if due < rnd:
                    self.late_frames += 1
                self._holding.append([payload, max(due, rnd), 0])
            elif kind == "hello":
                ev = self._churn_ev
                if (payload.get("resume") and ev is not None and ev.fired
                        and not ev.recovered
                        and self.front.churn_drops > 0):
                    ev.recover(resumed=payload.get("session"), round=rnd)
        self._admit(rnd)
        return bool(self._holding) or not self.front.idle

    def _fault_hooks(self, rnd: int) -> None:
        f = self.faults
        if f is None:
            return
        if self._churn_ev is None:
            ev = f.conn_churn_event(rnd)
            if ev is not None:
                self.front.churn()
                ev.fire(rnd, gen=self.front.churn_gen)
                self._churn_ev = ev
                self._churn_mark = self.front.ops_delivered
                self.sched.stats.faults_injected += 1
                self.sched._note_fault()
        else:
            ev = self._churn_ev
            # fallback recovery: traffic flowing again after the drop
            # (a resumed hello is the usual evidence; ops resuming is
            # just as conclusive when the hello raced the drain)
            if (ev.fired and not ev.recovered
                    and self.front.churn_drops > 0
                    and self.front.ops_delivered > self._churn_mark):
                ev.recover(via="traffic_resumed", round=rnd)
        flood = self._flood_ev
        if flood is not None and not flood.recovered and rnd > self._flood_until:
            flood.recover(round=rnd, deferred_ops=self._flood_deferred,
                          shed_ops=self._flood_shed)
        if flood is None or flood.recovered:
            ev = f.tenant_flood_event(rnd)
            if ev is not None:
                tenant = sorted(self.admission.policies)[0]
                factor = ev.param or 8
                self._flood_ev = ev
                self._flood_tenant = tenant
                self._flood_factor = factor
                self._flood_until = rnd + FLOOD_SPAN
                self._flood_deferred = 0
                self._flood_shed = 0
                ev.fire(rnd, tenant=tenant, factor=factor,
                        until=self._flood_until)
                self.sched.stats.faults_injected += 1
                self.sched._note_fault()

    def _flooding(self, tenant: str, rnd: int) -> bool:
        return (self._flood_ev is not None and self._flood_ev.fired
                and tenant == self._flood_tenant
                and rnd <= self._flood_until)

    def _admit(self, rnd: int) -> None:  # graftlint: thread=hot
        sched = self.sched
        adm = self.admission
        # per-tenant in-queue ops, computed once per round
        pending: dict[str, int] = {}
        for doc, st in sched.streams.items():
            if st.delivered is None:
                continue
            t = self.tenant_of.get(doc, DEFAULT_TENANT)
            pending[t] = pending.get(t, 0) + max(0, st.n_sched - st.cursor)
        keep: list[list] = []
        blocked: set[int] = set()  # docs whose earlier frame stalled
        for item in self._holding:
            payload, due, defers = item
            doc = payload["doc"]
            if due > rnd or doc in blocked:
                keep.append(item)
                continue
            st = sched.streams[doc]
            start = int(payload["start"])
            count = int(payload["count"])
            want = start + count
            if st.lossy:
                want = min(want, st.n_total)
            delivered = st.delivered or 0
            if want <= delivered:
                # redelivery (resume) or post-shed tail: idempotent drop
                sched.stats.dup_ops_dropped += st.clamp_redelivery(
                    start, min(want, st.cursor))
                self.dup_frames += 1
                continue
            tenant = payload.get("tenant", DEFAULT_TENANT)
            eff = count * self._flood_factor if self._flooding(tenant, rnd) \
                else count
            verb, _reason = adm.decide(
                tenant, eff, self._slo_class(doc),
                pending.get(tenant, 0), defers)
            if verb == "defer":
                item[1] = rnd + 1
                item[2] = defers + 1
                blocked.add(doc)
                keep.append(item)
                if self._flooding(tenant, rnd):
                    self._flood_deferred += count
                continue
            if verb == "shed":
                keep_at = max(st.cursor, delivered)
                prev = st.n_total
                st.limit = keep_at if st.limit is None \
                    else min(st.limit, keep_at)
                st.lossy = True
                shed = prev - st.n_total
                sched.stats.shed_ops += shed
                adm.journal_shed(doc, keep_at, shed, tenant, rnd)
                self.shed_docs += 1
                blocked.add(doc)
                if self._flooding(tenant, rnd):
                    self._flood_shed += shed
                continue
            # admit: the scheduler's bounded-queue rule owns the clamp
            before = st.delivered or 0
            excess = sched._push_delivery(st, want)
            pending[tenant] = pending.get(tenant, 0) + max(
                0, (st.delivered or 0) - before)
            if excess:
                # hold the refused tail; the accepted prefix is already
                # in (delivery is an offset high-water mark)
                item[0] = {**payload, "start": int(st.delivered),
                           "count": int(want - st.delivered)}
                item[1] = rnd + 1
                blocked.add(doc)
                keep.append(item)
            else:
                self.admitted_frames += 1
        self._holding = keep

    def status_fields(self) -> dict:  # graftlint: thread=hot
        """The ``ingest`` sub-block for /status.json: front gauges,
        admission totals, pump counters, chaos state."""
        out = self.front.status_fields()
        out["admission"] = self.admission.status_fields()
        out["holding_frames"] = len(self._holding)
        out["late_frames"] = self.late_frames
        out["admitted_frames"] = self.admitted_frames
        out["dup_frames"] = self.dup_frames
        out["shed_docs"] = self.shed_docs
        return out

    def to_dict(self) -> dict:
        out = self.status_fields()
        out["drained_frames"] = self.drained_frames
        return out


def drive_open_loop(sched, pump, client):  # graftlint: thread=hot
    """The open-loop drain: pump → ``run_round`` → explicit clock tick
    when the queues are empty but producers still owe ops (the base
    idle-jump only understands the static arrival schedule).  Epilogue
    mirrors ``FleetScheduler.run`` — final device fence, pending-round
    fold, fault sweep — so the stats and artifact shapes match the
    closed-loop path exactly."""
    t0 = time.perf_counter()
    dead_ticks = 0
    while True:
        live = pump.step(sched.round)
        progressed = sched.run_round()
        if progressed:
            dead_ticks = 0
            continue
        wire_live = not client.finished
        if sched.done and not live and not wire_live:
            break
        if not live and not wire_live:
            # queues drained, nothing held, client done — yet streams
            # still owe ops: give the front's buffer a bounded chance
            # to surface stragglers, then call it stuck
            dead_ticks += 1
            if dead_ticks > STUCK_TICKS:
                missing = sorted(
                    d for d, s in sched.streams.items() if s.remaining
                )[:8]
                raise RuntimeError(
                    "open-loop drain stuck: client finished but docs "
                    f"still owe ops (first: {missing})"
                )
        else:
            dead_ticks = 0
        # the open-loop clock ticks whether or not anything scheduled
        sched.round += 1
        if wire_live and not live:
            time.sleep(WIRE_SLEEP)  # waiting on the wire, not the CPU
    tail0 = time.perf_counter()
    with span("serve.drain_fence"):
        sched.pool.block()
    if sched._pending_round is not None:
        dt, c, b = sched._pending_round
        sched._pending_round = (dt + time.perf_counter() - tail0, c, b)
    sched._flush_round()
    if sched.faults is not None and sched.done:
        with span("serve.finalize_faults"):
            sched.finalize_faults()
    sched.stats.wall_time += time.perf_counter() - t0
    sched.stats.evictions = sched.pool.evictions
    sched.stats.restores = sched.pool.restores
    sched.stats.promotions = sched.pool.promotions
    return sched.stats
