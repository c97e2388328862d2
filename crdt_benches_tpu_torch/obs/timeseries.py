"""Continuous serve telemetry: ring-buffered per-round time-series (the
JAX package's ``obs/timeseries.py``).

The metric registry answers "what did the whole drain look like" — one
aggregate per series, visible only after the run.  This module answers
"what is happening NOW, and when did it change": every macro-round the
scheduler hands :class:`TimeseriesRecorder` a sample (round latency,
occupancy, queue depth, cumulative counters), the recorder folds
``window_rounds`` consecutive rounds into one **window** (delta-encoded
against the cumulative counters, so each window stands alone), and the
closed windows live in a bounded ring — a million-round soak holds
``capacity`` windows, never a million samples.  Consumers:

- the artifact's versioned ``timeseries`` block (:meth:`block`);
- an optional JSONL stream file (``--serve-timeseries PATH``): one line
  per closed window, appended live, so an external tail follows the run;
- :mod:`crdt_benches_tpu_torch.obs.anomaly` detectors (windows are their
  input);
- :mod:`crdt_benches_tpu_torch.obs.status`'s ``/status.json`` + ``/metrics``
  (the facade publishes a fresh registry snapshot at every window
  close).

:class:`ServeTelemetry` is the facade the scheduler threads through the
drain: it fans one ``note_round`` out to the recorder, the per-shard
series (:mod:`obs.shard`), the anomaly detectors and the status server,
and re-bases per drain so a soak run (``--serve-soak``) accumulates one
continuous series across many fleet drains.

Hot-path discipline: everything called per
round here is pure host arithmetic on pre-registered metric objects —
no registry get-or-create, no socket/server work, no device traffic.

Thread confinement: both classes here are owned by the **hot** thread — the
recorder's ring, the delta baseline, and the facade's re-basing state
are never touched from another thread.  The only state that leaves the
hot thread is what :class:`ServeTelemetry` pushes through the status
server's publish points (fresh ``to_dict()`` / status-field
snapshots, never live objects); the status threads read those
snapshots, never the recorder.
"""

from __future__ import annotations

import json
import os
from collections import deque
from dataclasses import dataclass, field

#: Bump when the ``timeseries`` artifact block changes shape.
TIMESERIES_VERSION = 1

#: Cumulative counter keys a round sample carries (delta-encoded into
#: windows).  Fixed set: a window is self-describing in the artifact.
CUM_KEYS = (
    "ops", "unit_ops", "shed", "deferred", "quarantines", "dup_dropped",
    "evictions", "restores", "promotions", "recoveries",
    "journal_bytes", "fence_entries",
)


def read_rss_bytes() -> int | None:
    """Current resident set size, or None where /proc is unavailable.
    (``ru_maxrss`` is a high-water mark — useless for detecting that
    growth *stopped* — so the leak detector wants the live value.)"""
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return None
    return pages * (os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf")
                    else 4096)


class TimeseriesRecorder:  # graftlint: thread=hot
    """Fold per-round samples into bounded, delta-encoded windows.

    One window = up to ``window_rounds`` macro-rounds: wall seconds,
    op/unit-op deltas, occupancy mean, queue-depth max, shed / defer /
    quarantine / eviction / journal-byte / fence-entry deltas, compile
    and barrier round counts, and (under a mesh) per-shard op / lane
    sums.  Closed windows land in a ring of ``capacity`` (oldest
    dropped, counted, never silently) and — when ``stream_path`` is set
    — are appended as one JSON line each.
    """

    def __init__(self, window_rounds: int = 8, capacity: int = 512,
                 stream_path: str | None = None):
        self.window_rounds = max(1, int(window_rounds))
        self.capacity = max(1, int(capacity))
        self.windows: deque[dict] = deque(maxlen=self.capacity)
        self.dropped = 0
        self.stream_path = stream_path
        self._stream = None
        self._cur: dict | None = None
        self._cum: dict[str, int] = {}
        self._index = 0  # windows ever closed (stable window ids)
        self.rounds_seen = 0
        self.drains = 0
        self.n_shards = 1

    # ---- drain lifecycle ----

    def rebase(self, n_shards: int = 1) -> None:
        """A new drain begins: its ServeStats counters restart at zero,
        so the delta baseline must too.  The window ring persists — a
        soak's series is continuous across drains."""
        self._cum = {}
        self.n_shards = max(1, int(n_shards))
        self.drains += 1

    # ---- per-round sampling (hot path: pure host arithmetic) ----

    def note_round(self, *, round_no: int, seconds: float, compiled: bool,
                   barrier: bool, occupancy: float, queue_depth: int,
                   cum: dict, shard_ops=None, shard_lanes=None,
                   shard_units=None) -> dict | None:
        """Fold one macro-round into the current window.  Returns the
        window dict if this round CLOSED it, else None."""
        self.rounds_seen += 1
        w = self._cur
        if w is None:
            w = self._cur = {
                "index": self._index,
                "drain": self.drains,
                "start_round": round_no,
                "rounds": 0,
                "seconds": 0.0,
                "occ_sum": 0.0,
                "queue_depth_max": 0,
                "compile_rounds": 0,
                "barrier_rounds": 0,
                "shard_ops": [0] * self.n_shards,
                "shard_unit_ops": [0] * self.n_shards,
                "shard_lanes": [0] * self.n_shards,
            }
            for k in CUM_KEYS:
                w[k] = 0
        w["end_round"] = round_no
        w["rounds"] += 1
        w["seconds"] += seconds
        w["occ_sum"] += occupancy
        if queue_depth > w["queue_depth_max"]:
            w["queue_depth_max"] = queue_depth
        if compiled:
            w["compile_rounds"] += 1
        if barrier:
            w["barrier_rounds"] += 1
        for k in CUM_KEYS:
            v = int(cum.get(k, 0))
            w[k] += v - self._cum.get(k, 0)
            self._cum[k] = v
        if shard_ops is not None:
            so, su, sl = (w["shard_ops"], w["shard_unit_ops"],
                          w["shard_lanes"])
            for s in range(min(self.n_shards, len(shard_ops))):
                so[s] += shard_ops[s]
                su[s] += shard_units[s]
                sl[s] += shard_lanes[s]
        if w["rounds"] >= self.window_rounds:
            return self._close()
        return None

    def close_partial(self) -> dict | None:
        """End of a drain: flush the in-progress window (marked
        ``full: false`` so rate detectors can skip it)."""
        if self._cur is None or self._cur["rounds"] == 0:
            self._cur = None
            return None
        return self._close()

    # ---- window close ----

    def _close(self) -> dict:
        w = self._cur
        self._cur = None
        self._index += 1
        rounds = w["rounds"]
        occ_sum = w.pop("occ_sum")
        w["occupancy"] = occ_sum / rounds
        w["lanes"] = sum(w["shard_lanes"])
        w["full"] = rounds >= self.window_rounds
        # throughput in unit ops (the elements/s analog) per wall second
        w["throughput"] = (
            w["unit_ops"] / w["seconds"] if w["seconds"] > 0 else 0.0
        )
        w["rss_bytes"] = read_rss_bytes()
        if len(self.windows) == self.windows.maxlen:
            self.dropped += 1
        self.windows.append(w)
        if self.stream_path:
            if self._stream is None:
                d = os.path.dirname(self.stream_path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._stream = open(self.stream_path, "w",
                                    encoding="utf-8")
            self._stream.write(json.dumps(w, separators=(",", ":")))
            self._stream.write("\n")
            self._stream.flush()
        return w

    # ---- artifact surface ----

    def block(self) -> dict:
        """The versioned ``timeseries`` artifact block (non-destructive:
        callable per soak iteration, the last call sees everything)."""
        return {
            "version": TIMESERIES_VERSION,
            "window_rounds": self.window_rounds,
            "n_shards": self.n_shards,
            "drains": self.drains,
            "rounds_seen": self.rounds_seen,
            "dropped_windows": self.dropped,
            "stream": self.stream_path,
            "windows": list(self.windows),
        }

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None


@dataclass
class ServeTelemetry:  # graftlint: thread=hot
    """The continuous-telemetry bundle one serve run threads through
    its scheduler(s).  Any piece may be None; a soak run shares one
    bundle across every drain it spins up."""

    recorder: TimeseriesRecorder | None = None
    anomaly: object | None = None  # obs/anomaly.py AnomalyDetector
    status: object | None = None  # obs/status.py StatusServer
    flight: object | None = None  # obs/flight.py FlightRecorder
    shards: object | None = field(default=None, init=False)
    registry: object | None = field(default=None, init=False)
    reqtrace: object | None = field(default=None, init=False)
    _flight_fired_seen: int = field(default=0, init=False)
    _drain_done: bool = field(default=False, init=False)

    def bind(self, pool, registry, reqtrace=None) -> None:
        """A drain's scheduler calls this once at construction: build
        the per-shard series against the drain's registry, re-base the
        recorder's delta baseline, and publish an initial snapshot so
        a scrape BEFORE the first window close already answers.
        ``reqtrace`` is the drain's RequestTracker — the flight
        recorder dumps its sampled/in-flight traces on a trigger."""
        from .shard import ShardMetrics

        self.registry = registry
        self.shards = ShardMetrics(pool, registry)
        self.reqtrace = reqtrace
        self._drain_done = False
        if self.recorder is not None:
            self.recorder.rebase(n_shards=pool.n_sh)
        if self.status is not None:
            self.status.publish_metrics(registry.to_dict())
            self.status.publish_status({"phase": "starting", "rounds": 0})

    def _flight_requests(self) -> list:
        if self.reqtrace is None:
            return []
        return self.reqtrace.dump_requests()

    def flight_dump(self, reason: str, status: dict | None = None) -> None:
        """Trigger a flight-recorder dump with everything the bundle
        holds (no-op without a recorder)."""
        if self.flight is None:
            return
        self.flight.trigger(
            reason,
            registry=self.registry,
            status=status,
            requests=self._flight_requests(),
            anomalies=(
                self.anomaly.active_kinds()
                if self.anomaly is not None else []
            ),
        )

    # -- per-round fan-out (hot path; pre-registered objects only) --

    def note_round(self, *, round_no: int, seconds: float, compiled: bool,
                   barrier: bool, occupancy: float, queue_depth: int,
                   cum: dict, shard_lanes, shard_ops, shard_units,
                   status: dict) -> None:
        if self.shards is not None:
            self.shards.note_round(shard_lanes, shard_ops, shard_units)
        closed = None
        if self.recorder is not None:
            closed = self.recorder.note_round(
                round_no=round_no, seconds=seconds, compiled=compiled,
                barrier=barrier, occupancy=occupancy,
                queue_depth=queue_depth, cum=cum, shard_ops=shard_ops,
                shard_lanes=shard_lanes, shard_units=shard_units,
            )
        if self.anomaly is not None:
            self.anomaly.note_round(
                seconds, skip=compiled or barrier, round_no=round_no
            )
        if self.flight is not None:
            # one small dict per round into the bounded ring; a NEW
            # anomaly fire triggers the atomic dump (the post-mortem
            # window this recorder exists to keep)
            self.flight.note_round({
                "round": round_no,
                "seconds": seconds,
                "compiled": compiled,
                "barrier": barrier,
                "occupancy": occupancy,
                "queue_depth": queue_depth,
                "ops": cum.get("ops", 0),
                "shed": cum.get("shed", 0),
                "deferred": cum.get("deferred", 0),
                "quarantines": cum.get("quarantines", 0),
                "recoveries": cum.get("recoveries", 0),
            })
        if closed is not None:
            if self.anomaly is not None:
                self.anomaly.note_window(closed)
            if self.shards is not None:
                self.shards.sample_memory()
            if self.status is not None and self.registry is not None:
                self.status.publish_metrics(self.registry.to_dict())
        if self.status is not None:
            if self.anomaly is not None:
                status["anomalies_active"] = self.anomaly.active_kinds()
                self.status.set_health(
                    not status["anomalies_active"],
                    ",".join(status["anomalies_active"]),
                )
            self.status.publish_status(status)
        # flight trigger LAST, after both the per-round and per-window
        # detectors had their look: a NEW fire (per-round watchdog OR
        # window-level degradation/leak) dumps the post-mortem window
        if (self.flight is not None and self.anomaly is not None
                and self.anomaly.fired > self._flight_fired_seen):
            self._flight_fired_seen = self.anomaly.fired
            self.flight_dump(
                "anomaly:" + ",".join(self.anomaly.active_kinds()),
                status=status,
            )

    def note_event(self, kind: str, **fields) -> None:
        """Durability/recovery lifecycle marker (snapshot barrier,
        compaction pass, in-run recovery): lands in the flight
        recorder's event ring so a post-mortem dump says when the
        subsystem last acted.  Hot-thread only; pure host append."""
        if self.flight is not None:
            self.flight.note_event(kind, **fields)

    def note_phase(self, phase: str) -> None:
        """Driver-side heartbeat between drains (fleet build, verify):
        no round is running, but the publisher is alive — resets the
        status server's staleness clock."""
        if self.status is not None:
            self.status.publish_status({"phase": phase})

    def publish_metrics_now(self) -> None:
        """Out-of-window registry publish for rare operator-visible
        state transitions (a reshard begin/resume/commit).  The normal
        cadence publishes only at window closes — a migration that
        begins AND commits inside one window would never render on
        /metrics while in flight without this."""
        if self.status is not None and self.registry is not None:
            self.status.publish_metrics(self.registry.to_dict())

    # -- drain end (driver side, off the hot path) --

    def drain_end(self, status: dict | None = None) -> None:
        """Close the partial window, push it through the detectors, and
        publish the final snapshots.  Idempotent per drain."""
        if self._drain_done:
            return
        self._drain_done = True
        if self.recorder is not None:
            tail = self.recorder.close_partial()
            if tail is not None and self.anomaly is not None:
                self.anomaly.note_window(tail)
        if self.shards is not None:
            self.shards.sample_memory()
        if self.status is not None and self.registry is not None:
            self.status.publish_metrics(self.registry.to_dict())
        if self.status is not None and status is not None:
            if self.anomaly is not None:
                status["anomalies_active"] = self.anomaly.active_kinds()
            self.status.publish_status(status)
        if (self.flight is not None and self.anomaly is not None
                and self.anomaly.uncleared > 0):
            # an anomaly still ACTIVE at drain end fails the run — the
            # dump is the post-mortem that exit code used to discard
            self.flight_dump(
                "drain_end_active_anomaly:"
                + ",".join(self.anomaly.active_kinds()),
                status=status,
            )

    def close(self) -> None:
        """Release owned resources (stream file, status server)."""
        if self.recorder is not None:
            self.recorder.close()
        if self.status is not None:
            self.status.stop()
