"""Anomaly flight recorder: a bounded ring dumped atomically on fire (the
JAX package's ``obs/flight.py``).

A soak failure today leaves an exit code and whatever the artifact
recorded *after* the drain; the window that actually explains the
failure — the rounds right before the anomaly — is gone.  The
:class:`FlightRecorder` keeps exactly that window in memory:

- a ring of the last ``ring`` per-round event samples (round number,
  wall seconds, occupancy, queue depth, compile/barrier flags, fault
  counters — the ``obs/timeseries.py`` sample vocabulary, pre-window
  granularity);
- the last N sampled request traces from ``obs/reqtrace.py`` (plus
  every still-open request at dump time — the in-flight set is what a
  crash post-mortem wants);
- the full metric-registry snapshot and the latest status fields.

On a trigger — anomaly fire (``obs/anomaly.py`` via the telemetry
facade), an unrecovered fault at drain end, or a crash escaping the
drain — the whole picture is dumped as ONE JSON document, written
atomically (tmp + ``os.replace``): a reader never sees a half dump, and
a repeated trigger replaces the file with a fresh, more complete one
(``dump_index`` says which trigger wrote it; every reason is retained).

The module doubles as the dump validator a chaos run gates on::

    python -m crdt_benches_tpu_torch.obs.flight DUMP.json

exits nonzero unless the file is a schema-valid flight dump.

Lifecycle discipline: the recorder is CONSTRUCTED by
the bench driver, never on the hot path; the hot path only appends to
the ring and — rarely, on an anomaly trigger — writes the dump (a
post-mortem beats purity exactly once, when the run is already sick).
Thread confinement: owned by the **hot** thread end to end.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque

from ..lint.fs_sanitizer import fs_protocol
from ..lint.sanitizer import fenced
from ..utils.fsdur import fsync_dir as _fsync_dir

#: Bump when the dump document changes shape.
FLIGHT_VERSION = 1

#: Default per-round event ring depth.
DEFAULT_RING = 256


class FlightRecorder:  # graftlint: thread=hot
    """Bounded pre-anomaly window + atomic dump (module docstring)."""

    def __init__(self, path: str, ring: int = DEFAULT_RING,
                 event_ring: int = 64):
        self.path = path
        self.rounds: deque[dict] = deque(maxlen=max(1, int(ring)))
        self.events: deque[dict] = deque(maxlen=max(1, int(event_ring)))
        self.rounds_seen = 0
        self.events_seen = 0
        self.dumps = 0
        self.dump_failures = 0
        self.last_error: str | None = None
        self.reasons: list[str] = []

    # ---- hot path: one small dict append per macro-round ----

    def note_round(self, sample: dict) -> None:
        self.rounds_seen += 1
        self.rounds.append(sample)

    def note_event(self, kind: str, **fields) -> None:
        """Record a durability/recovery lifecycle event (snapshot
        barrier committed, WAL compaction pass, in-run recovery) into
        its own bounded ring — the post-mortem wants 'when did the
        subsystem last act', which round samples alone cannot answer."""
        self.events_seen += 1
        self.events.append({"kind": str(kind), **fields})

    # ---- triggers (anomaly fire / unrecovered fault / crash) ----

    @fenced
    def trigger(self, reason: str, *, registry=None, status=None,  # graftlint: fence=flight  # graftlint: durable=flight
                requests=None, anomalies=None) -> str:
        """Dump the recorder's state atomically and return the path.
        Later triggers replace the file (each dump is a superset-in-
        time of the last; ``reasons`` accumulates).

        The dump is host JSON + file I/O that runs exactly when the
        drain is already sick (anomaly fire / unrecovered fault /
        crash) — the one place a post-mortem beats hot-path purity.  It
        is a fence of the sync sanitizer (its entry lands in the
        report's ``boundary_syncs``) and its file operations are the fs
        sanitizer's ``flight`` protocol (``lint/``).

        BEST-EFFORT by contract: a dump that cannot be written (typo'd
        path, full disk, unserializable snapshot) must never kill a
        run the anomaly would have cleared, nor — on the crash path —
        replace the exception it is documenting.  Failures are counted
        (``dump_failures`` / ``last_error``, surfaced in the
        artifact's ``flight`` block) and a chaos run's validator
        gate catches a silently-missing dump."""
        self.reasons.append(str(reason))
        doc = {
            "version": FLIGHT_VERSION,
            "reason": str(reason),
            "reasons": list(self.reasons),
            "dump_index": self.dumps + 1,
            "time_unix": time.time(),
            "rounds_seen": self.rounds_seen,
            "rounds": list(self.rounds),
            "events_seen": self.events_seen,
            "events": list(self.events),
            "requests": list(requests) if requests else [],
            "metrics": registry.to_dict() if registry is not None
            else None,
            "status": dict(status) if status else None,
            "anomalies": list(anomalies) if anomalies else [],
        }
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = self.path + ".tmp"
            with fs_protocol("flight"):
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(doc, f, separators=(",", ":"))
                    # a post-mortem that evaporates with the page cache
                    # explains nothing: fsync before the commit rename,
                    # and the directory entry after
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)  # commit: never half a dump
                if d:
                    _fsync_dir(d)
        except (OSError, TypeError, ValueError) as e:
            self.dump_failures += 1
            self.last_error = f"{type(e).__name__}: {e}"
            try:  # a half-written .tmp must not outlive the failure
                os.unlink(self.path + ".tmp")
            except OSError:
                pass
            return self.path
        self.dumps += 1
        return self.path

    def summary(self) -> dict:
        """The artifact's ``flight`` block: where the dump lives and
        why it was (or was not) written."""
        return {
            "path": self.path,
            "ring": self.rounds.maxlen,
            "rounds_seen": self.rounds_seen,
            "events_seen": self.events_seen,
            "dumps": self.dumps,
            "dump_failures": self.dump_failures,
            "last_error": self.last_error,
            "reasons": list(self.reasons),
        }


# ---------------------------------------------------------------------------
# schema validation (a chaos run gates on this)
# ---------------------------------------------------------------------------


def validate_flight(data) -> list[str]:
    """Structural checks on one flight dump.  Returns problems (empty
    = valid)."""
    errors: list[str] = []
    if not isinstance(data, dict):
        return ["top level must be an object"]
    if data.get("version") != FLIGHT_VERSION:
        errors.append(
            f"version {data.get('version')!r} != {FLIGHT_VERSION}"
        )
    if not data.get("reason") or not isinstance(data["reason"], str):
        errors.append("reason must be a non-empty string")
    if not isinstance(data.get("dump_index"), int) or \
            data.get("dump_index", 0) < 1:
        errors.append("dump_index must be a positive integer")
    rounds = data.get("rounds")
    if not isinstance(rounds, list):
        errors.append("rounds must be a list")
        rounds = []
    if not rounds:
        errors.append("rounds is empty — the recorder saw no round "
                      "before the trigger")
    for i, r in enumerate(rounds):
        if not isinstance(r, dict):
            errors.append(f"rounds[{i}]: not an object")
            continue
        if not isinstance(r.get("round"), int):
            errors.append(f"rounds[{i}]: missing integer 'round'")
        if not isinstance(r.get("seconds"), (int, float)):
            errors.append(f"rounds[{i}]: missing numeric 'seconds'")
    reqs = data.get("requests")
    if not isinstance(reqs, list):
        errors.append("requests must be a list")
        reqs = []
    for i, r in enumerate(reqs):
        if not isinstance(r, dict) or "doc" not in r:
            errors.append(f"requests[{i}]: not a request trace (no "
                          "'doc')")
    events = data.get("events", [])
    if not isinstance(events, list):
        errors.append("events must be a list")
        events = []
    for i, e in enumerate(events):
        if not isinstance(e, dict) or not isinstance(e.get("kind"), str):
            errors.append(f"events[{i}]: not an event (no 'kind')")
    m = data.get("metrics")
    if m is not None and not (
        isinstance(m, dict) and isinstance(m.get("version"), int)
    ):
        errors.append("metrics must be null or a versioned registry "
                      "snapshot")
    if not isinstance(data.get("anomalies"), list):
        errors.append("anomalies must be a list")
    return errors


def validate_flight_file(path: str) -> list[str]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable flight dump: {e}"]
    return validate_flight(data)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m crdt_benches_tpu_torch.obs.flight DUMP.json",
              file=sys.stderr)
        return 2
    errors = validate_flight_file(argv[0])
    for e in errors:
        print(f"{argv[0]}: {e}", file=sys.stderr)
    if not errors:
        with open(argv[0], encoding="utf-8") as f:
            d = json.load(f)
        print(
            f"{argv[0]}: valid flight dump — reason {d['reason']!r}, "
            f"{len(d['rounds'])} rounds, {len(d['requests'])} request "
            f"traces, dump {d['dump_index']}"
        )
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
