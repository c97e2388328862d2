"""Request-scoped causal tracing: where each doc request's time went (the
JAX package's ``obs/reqtrace.py``).

The round telemetry sees *rounds*; an SLO-aware admission scheduler needs
to see *requests*: one *request* = one admission-to-drain episode of one
document — opened when the FleetScheduler first schedules the doc,
closed when its stream ends (drained / shed / quarantined).  The
:class:`RequestTracker` owns that lifecycle:

- **context** — doc id, request id, episode number (a doc re-admitted
  after a close opens a FRESH context: two episodes are two requests,
  each counted once — a table of admission timestamps keyed by doc
  identity would double-count a re-admitted doc under one identity),
  admission round/wall time, and its **latency budget class**
  (``obs/slo.py`` classification of the admission capacity class);
- **segments** — per-request time breakdown folded once per macro-round
  from the scheduler's phase timings (``plan`` / ``wal`` / ``stage`` /
  ``moves`` / ``dispatch``), plus ``queue`` (inter-round wait the
  phases do not cover) and ``drain`` (close-time residual tail).
  Disarmed, :meth:`segment` returns one shared no-op context manager —
  the same zero-cost contract as ``obs/trace.py span``;
- **publish-point hops** — every declared publish point entered during
  a round (:meth:`RequestTracker._on_publish`) is folded into the
  round's active contexts, so a request trace records exactly which
  cross-thread propagation edges its data rode (status snapshot,
  journal WAL record, broadcast-bus block, ingest delivery).  The race
  sanitizer (``lint/race_sanitizer.py``) calls the observer at every
  publish-point entry while the tracker is armed;
- **exemplars** — at close, the request is attached to the
  ``doc_drain_latency`` histogram bucket its latency lands in (last
  request per bucket wins), so a p99.9 outlier in the artifact links
  to the exact request's segment breakdown;
- **remote-merge attribution** — on a replicated fleet, the remote ops
  a replica merges are attributed to their ORIGINATING writer
  (``remote_ops`` keyed by writer index).

Discipline: contexts are opened and
exemplars sampled at admission/drain EDGES — never in per-op inner
loops — and the tracker/flight lifecycle (construction, arming) belongs
to the bench driver, not the hot path.

Thread confinement: the tracker is owned by the **hot** thread; readers
see request data through the status server's published snapshots, never
the tracker.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque

from .trace import NOOP_SPAN

#: Bump when the ``reqtrace`` artifact block changes shape.
REQTRACE_VERSION = 1

#: The fixed per-request segment vocabulary.  ``queue`` and ``drain``
#: are derived (inter-round wait / close-time tail); ``faults`` is
#: injected stall time (so a chaos post-mortem points at the stall,
#: not at phantom queuing); the rest mirror the macro-round phases the
#: scheduler times.
SEGMENTS = ("queue", "plan", "wal", "stage", "moves", "dispatch",
            "faults", "drain")

#: Default sampled-trace ring size when armed without an explicit cap.
DEFAULT_SAMPLES = 16


#: The disarmed segment IS the disarmed span — one shared no-op
#: context manager across obs/, so the two identity contracts cannot
#: drift apart.
NOOP_SEGMENT = NOOP_SPAN


class _Segment:
    """One armed phase timing: accumulates into the tracker's
    per-round segment table on exit."""

    __slots__ = ("_tracker", "_name", "_t0")

    def __init__(self, tracker: "RequestTracker", name: str):
        self._tracker = tracker
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        segs = self._tracker._round_segs
        segs[self._name] = segs.get(self._name, 0.0) + (
            time.perf_counter() - self._t0
        )
        return False


class RequestContext:
    """One admission-to-drain episode of one document."""

    __slots__ = ("doc_id", "request_id", "episode", "budget_class",
                 "admit_round", "admit_t", "last_t", "rounds", "ops",
                 "segments", "hops", "remote_ops", "cause", "latency",
                 "close_round")

    def __init__(self, doc_id: int, request_id: int, episode: int,
                 budget_class: str, admit_round: int):
        self.doc_id = doc_id
        self.request_id = request_id
        self.episode = episode
        self.budget_class = budget_class
        self.admit_round = admit_round
        self.admit_t = time.perf_counter()
        self.last_t = self.admit_t
        self.rounds = 0
        self.ops = 0
        self.segments: dict[str, float] = {}
        self.hops: set[str] = set()
        self.remote_ops: dict[int, int] = {}
        self.cause: str | None = None
        self.latency: float | None = None
        self.close_round: int | None = None

    def to_dict(self) -> dict:
        return {
            "request": self.request_id,
            "doc": self.doc_id,
            "episode": self.episode,
            "class": self.budget_class,
            "admit_round": self.admit_round,
            "close_round": self.close_round,
            "cause": self.cause,
            "latency_s": self.latency,
            "rounds": self.rounds,
            "ops": self.ops,
            "segments": {k: self.segments[k] for k in sorted(self.segments)},
            "hops": sorted(self.hops),
            "remote_ops": {
                str(w): n for w, n in sorted(self.remote_ops.items())
            },
        }


class RequestTracker:
    """Request lifecycle owner (module docstring has the model).

    Disarmed (``samples=0`` and no SLO tracker — the default every
    plain drain gets), the tracker is exactly an admission-timestamp
    table: ``open_request`` stores one float, ``close_request`` pops it,
    :meth:`segment` is the shared no-op — identity asserted by tests.
    Armed, every open creates a full :class:`RequestContext`.
    """

    def __init__(self, samples: int = 0, slo=None):
        self.samples_cap = int(samples)
        self.slo = slo  # obs/slo.py SloTracker (or None)
        self.armed = self.samples_cap > 0 or slo is not None
        if self.armed and self.samples_cap <= 0:
            self.samples_cap = DEFAULT_SAMPLES
        # disarmed: the bare admission-timestamp table
        self._t0: dict[int, float] = {}
        # armed state
        self._active: dict[int, RequestContext] = {}
        self._episodes: dict[int, int] = {}
        self._samples: deque[RequestContext] = deque(
            maxlen=max(1, self.samples_cap)
        )
        self._round_segs: dict[str, float] = {}
        self._round_hops: set[str] = set()
        self._round_docs: set[int] = set()
        self.hop_counts: dict[str, int] = {}
        self.exemplars: dict[str, dict[int, dict]] = {}
        self._bounds: dict[str, tuple] = {}
        self.requests_opened = 0
        self.requests_closed = 0
        self.reopened = 0  # episodes > 1: fresh contexts on re-admission
        self._next_id = 0
        # the tracker's owning (hot) thread: the publish observer fires
        # on the PUBLISHING thread, and the prefetch thread has a publish
        # point of its own (serve/prefetch.py) — see _on_publish
        self._owner = threading.get_ident()
        self._installed = False
        if self.armed:
            from ..lint import race_sanitizer

            race_sanitizer.add_publish_observer(self._on_publish)
            self._installed = True

    # ---- driver-side lifecycle ----

    def bind(self, stats) -> None:
        """Adopt the drain's cause-tagged drain-latency histograms as
        the exemplar target (their bounds define the buckets)."""
        if not self.armed:
            return
        self._bounds = {
            tag: h.bounds for tag, h in stats.doc_latency.items()
        }

    def release(self) -> None:
        """Remove the publish observer (each bench run owns its window).
        Idempotent."""
        if self._installed:
            from ..lint import race_sanitizer

            race_sanitizer.remove_publish_observer(self._on_publish)
            self._installed = False

    # ---- the publish-hop observer (fires on the publishing thread,
    # which for every declared point in this stack is the hot thread) --

    def _on_publish(self, point: str) -> None:
        if threading.get_ident() != self._owner:
            # a publisher-side entry from ANOTHER thread (the prefetch
            # worker's result swap): by definition not part of any
            # request's causal path — prefetch runs BEFORE admission
            # opens a context — and folding it here would mutate
            # hot-owned accumulators cross-thread.  Dropped by design;
            # the race sanitizer's own counters still record the entry.
            return
        self._round_hops.add(point)
        self.hop_counts[point] = self.hop_counts.get(point, 0) + 1

    # ---- admission / close edges ----

    def open_request(self, doc_id: int, round_no: int,
                     cap_cls: int | None = None) -> None:
        """Open a request at admission — a no-op while one is already
        active for the doc.  A doc whose previous request CLOSED
        (drained / shed / quarantined) and that is scheduled again gets
        a FRESH context with a new request id and episode number: the
        two episodes are two requests, never one double-counted doc."""
        if not self.armed:
            if doc_id not in self._t0:
                self._t0[doc_id] = time.perf_counter()
            return
        if doc_id in self._active:
            return
        ep = self._episodes.get(doc_id, 0) + 1
        self._episodes[doc_id] = ep
        if ep > 1:
            self.reopened += 1
        budget = (
            self.slo.classify(cap_cls) if self.slo is not None
            else (f"c{cap_cls}" if cap_cls is not None else "default")
        )
        self._active[doc_id] = RequestContext(
            doc_id, self._next_id, ep, budget, round_no
        )
        self._next_id += 1
        self.requests_opened += 1

    def close_request(self, doc_id: int, cause: str,
                      round_no: int | None = None) -> float | None:
        """Close the doc's active request under its cause tag.  Returns
        the admission-to-drain latency in seconds, or None when no
        request is open (never admitted, or already closed — the first
        close wins, exactly once per episode)."""
        now = time.perf_counter()
        if not self.armed:
            t0 = self._t0.pop(doc_id, None)
            return None if t0 is None else now - t0
        ctx = self._active.pop(doc_id, None)
        if ctx is None:
            return None
        if doc_id in self._round_docs:
            # closed mid-round AFTER riding this round's publishes (a
            # scheduled doc quarantined post-WAL): its lane was in the
            # journaled set, so the round's hops are its hops.  A doc
            # closed while NOT in this round's lane set (deferred off a
            # lost shard, drained at selection) must not be stamped
            # with edges its data never rode.
            ctx.hops |= self._round_hops
        ctx.cause = cause
        ctx.close_round = round_no
        ctx.latency = now - ctx.admit_t
        tail = now - ctx.last_t
        if tail > 0:
            ctx.segments["drain"] = ctx.segments.get("drain", 0.0) + tail
        self.requests_closed += 1
        self.sample_exemplar(cause, ctx.latency, ctx)
        if self.slo is not None:
            # a dropped request (shed / quarantined) BURNS error
            # budget regardless of how fast it was dropped — dropped
            # traffic reading as SLO-compliant would let a mass-shed
            # regression sail through the compliance gate
            self.slo.note_request(
                ctx.budget_class, ctx.latency, doc_id, ctx.segments,
                dropped=cause in ("shed", "quarantined"),
            )
        self._samples.append(ctx)
        return ctx.latency

    def sample_exemplar(self, tag: str, latency_s: float,
                        ctx: RequestContext) -> None:
        """Attach ``ctx`` to the drain-latency histogram bucket its
        latency lands in (``bisect_left`` over the same bounds the
        histogram observes with, so exemplar and count always agree;
        the LAST request per bucket wins).  An admission/drain-edge
        call, never one of a per-op inner loop."""
        bounds = self._bounds.get(tag)
        if bounds is None:
            return
        i = bisect_left(bounds, float(latency_s))
        self.exemplars.setdefault(tag, {})[i] = ctx.to_dict()

    # ---- per-round folding (hot path; armed-only by the caller) ----

    def round_begin(self) -> None:
        """Reset the round's segment/hop accumulators (no-op
        disarmed)."""
        if not self.armed:
            return
        # trailing attribution: publishes observed AFTER the round's
        # fold — the end-of-round status snapshot (telemetry.note_round
        # enters StatusServer.publish_*) — still carry the folded
        # round's data, so they union into the prior lane set's
        # still-active contexts before the accumulators reset (without
        # this, the status edge would be unreachable by any trace on a
        # clean drain: every other publish fires between note_scheduled
        # and fold_round)
        if self._round_hops and self._round_docs:
            for doc_id in self._round_docs:
                ctx = self._active.get(doc_id)
                if ctx is not None:
                    ctx.hops |= self._round_hops
        self._round_segs = {}
        self._round_hops = set()
        self._round_docs = set()

    def note_scheduled(self, doc_ids) -> None:
        """Register this round's lane set — the docs whose data rides
        this round's publish points.  Hops observed during the round
        attribute only to these docs' contexts (see
        :meth:`close_request`); called once per round right after the
        plan is final, before the WAL publish fires."""
        if not self.armed:
            return
        self._round_docs = set(doc_ids)

    def segment(self, name: str):
        """Time one macro-round phase: ``with rt.segment("plan"):``.
        Disarmed this is the shared :data:`NOOP_SEGMENT`."""
        if not self.armed:
            return NOOP_SEGMENT
        return _Segment(self, name)

    def fold_round(self, round_no: int,
                   docs: list[tuple[int, int]]) -> None:
        """Fold this round's phase timings, publish hops, and per-doc
        op counts into every scheduled doc's active context.  The
        causal attribution rule: a doc scheduled this round spent this
        round's phases; time since its last fold NOT covered by phases
        is ``queue`` wait."""
        now = time.perf_counter()
        segs = self._round_segs
        seg_total = sum(segs.values())
        hops = self._round_hops
        for doc_id, ops in docs:
            ctx = self._active.get(doc_id)
            if ctx is None:
                continue
            elapsed = now - ctx.last_t
            gap = elapsed - seg_total
            scale = 1.0
            if gap > 0:
                ctx.segments["queue"] = (
                    ctx.segments.get("queue", 0.0) + gap
                )
            elif seg_total > 0:
                # admitted mid-round (its clock started inside a
                # phase): credit only its share of the phases, so
                # sum(segments) never exceeds the request's latency
                scale = max(0.0, elapsed) / seg_total
            for k, v in segs.items():
                ctx.segments[k] = ctx.segments.get(k, 0.0) + v * scale
            if hops:
                ctx.hops |= hops
            ctx.ops += ops
            ctx.rounds += 1
            ctx.last_t = now

    def note_remote(self, doc_id: int, by_writer: dict[int, int]) -> None:
        """Attribute remote-merged ops to their originating writers
        (replicated fleets; armed-only by the caller)."""
        ctx = self._active.get(doc_id)
        if ctx is None:
            return
        for w, n in by_writer.items():
            ctx.remote_ops[w] = ctx.remote_ops.get(w, 0) + n

    # ---- surfaces ----

    def sampled(self) -> list[dict]:
        """The ring of most recently closed request traces, oldest
        first."""
        return [ctx.to_dict() for ctx in self._samples]

    def dump_requests(self) -> list[dict]:
        """Flight-recorder material: the sampled ring PLUS every still-
        open request (a crash post-mortem wants the in-flight set)."""
        out = self.sampled()
        for doc_id in sorted(self._active):
            out.append(self._active[doc_id].to_dict())
        return out

    def block(self) -> dict:
        """The versioned ``reqtrace`` artifact block."""
        return {
            "version": REQTRACE_VERSION,
            "armed": self.armed,
            "samples_cap": self.samples_cap,
            "requests_opened": self.requests_opened,
            "requests_closed": self.requests_closed,
            "reopened": self.reopened,
            "active": len(self._active),
            "hops": dict(sorted(self.hop_counts.items())),
            "exemplars": {
                tag: {str(i): ex for i, ex in sorted(buckets.items())}
                for tag, buckets in sorted(self.exemplars.items())
            },
            "traces": self.sampled(),
        }
