"""Phase-span tracer: Chrome trace events, zero overhead when disarmed
(the JAX package's ``obs/trace.py``).

The serving hot path is instrumented with ``with span("serve.plan"):``
blocks.  Disarmed (the default), :func:`span` returns one shared no-op
context manager — no allocation, no clock read, no branch beyond a
module-global ``is None`` test.  Armed (:func:`arm`, driven by the serve
bench's ``--serve-trace PATH``, the only way to arm it: options are
arguments, never environment variables), every span records one Chrome
trace-event ``"X"`` (complete) entry and every :func:`instant` a ``"i"``
event inside the span that owns it — load the file in Perfetto (or
``chrome://tracing``).

Armed, the tracer is also a fence observer of the sync sanitizer
(``lint/sanitizer.py``): every declared-fence crossing lands on the
timeline as a ``cat="fence"`` instant inside the span that owns it, as
in the JAX package.

Naming convention: span and metric names are **registered constants** —
dotted lowercase (``serve.plan``, ``serve.dispatch``), never f-strings.
Dynamic context goes in the ``args`` payload, where it belongs.

The module doubles as the trace schema validator::

    python -m crdt_benches_tpu_torch.obs.trace TRACE.json

exits nonzero unless the file is well-formed Chrome trace JSON, spans
nest properly per thread, and every fence instant lies inside its
owning span.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

#: Chrome trace "cat" for declared-fence instant events.
FENCE_CAT = "fence"


class _NoopSpan:
    """The disarmed span: one shared instance, nothing in enter/exit."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """One armed span: records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer.now_us()
        self._tracer._stack().append(self._name)
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = tr.now_us()
        tr._stack().pop()
        ev = {
            "ph": "X",
            "name": self._name,
            "ts": self._t0,
            "dur": t1 - self._t0,
            "pid": tr.pid,
            "tid": threading.get_ident() & 0xFFFF,
        }
        if self._args:
            ev["args"] = self._args
        tr.events.append(ev)
        return False


class SpanTracer:
    """Collects Chrome trace events for one armed window.

    Spans nest via a per-thread name stack (used to attribute fence
    instants to their owning span); events are buffered in memory and
    written once by :meth:`write` — a drain emits a few events per
    macro-round, so the buffer stays tiny next to the fleet state.
    """

    def __init__(self):
        self.events: list[dict] = []
        self.pid = os.getpid() & 0xFFFF
        self._origin = time.perf_counter()
        self._tls = threading.local()

    def now_us(self) -> float:
        return (time.perf_counter() - self._origin) * 1e6

    def _stack(self) -> list[str]:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, cat: str | None = None, **args) -> None:
        stack = self._stack()
        if stack:
            args = dict(args, span=stack[-1])
        ev = {
            "ph": "i",
            "s": "t",
            "name": name,
            "ts": self.now_us(),
            "pid": self.pid,
            "tid": threading.get_ident() & 0xFFFF,
        }
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def _on_fence(self, qualname: str) -> None:
        """A fence-entry observer: one instant per crossing (the sync
        sanitizer calls it while the tracer is armed)."""
        self.instant(qualname, cat=FENCE_CAT)

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f)
        return path


#: The armed tracer, or None (disarmed).  Module-global on purpose: the
#: hot path pays exactly one load + None test when disarmed.
_tracer: SpanTracer | None = None


def armed() -> bool:
    return _tracer is not None


def arm() -> SpanTracer:
    """Install a fresh tracer (a bench driver's call, before the drain
    starts; never from a hot scope)."""
    global _tracer
    from ..lint import sanitizer

    disarm()
    _tracer = SpanTracer()
    sanitizer.add_fence_observer(_tracer._on_fence)
    return _tracer


def disarm() -> SpanTracer | None:
    """Remove the tracer; returns it so the caller can
    :meth:`SpanTracer.write` the collected events."""
    global _tracer
    t, _tracer = _tracer, None
    if t is not None:
        from ..lint import sanitizer

        sanitizer.remove_fence_observer(t._on_fence)
    return t


def span(name: str, **args):
    """A phase span: ``with span("serve.plan"):``.  Disarmed this is
    the shared :data:`NOOP_SPAN`; armed it records one "X" event."""
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return t.span(name, **args)  # graftlint: disable=G012 (API plumbing)


def instant(name: str, **args) -> None:
    """A point event on the current span (no-op when disarmed)."""
    t = _tracer
    if t is not None:
        t.instant(name, **args)


# ---------------------------------------------------------------------------
# schema validation (chip_smoke.py's traced drain gates on this)
# ---------------------------------------------------------------------------

_REQUIRED = ("ph", "name", "ts", "pid", "tid")


def validate_trace(data) -> list[str]:
    """Structural checks on a Chrome trace document: every event
    well-formed, "X" spans properly nested per (pid, tid) — partial
    overlap means a corrupted stack — and every ``cat=fence`` instant
    inside its owning span.  Returns a list of problems (empty = valid).
    """
    errors: list[str] = []
    if not isinstance(data, dict) or not isinstance(
        data.get("traceEvents"), list
    ):
        return ["top level must be a dict with a traceEvents list"]
    events = data["traceEvents"]
    if not events:
        errors.append("traceEvents is empty")
    spans_by_tid: dict[tuple, list[dict]] = {}
    instants: list[dict] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            errors.append(f"event {i}: missing {missing}")
            continue
        if not isinstance(ev["name"], str) or not ev["name"]:
            errors.append(f"event {i}: name must be a non-empty string")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            errors.append(f"event {i}: bad ts {ev['ts']!r}")
            continue
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({ev['name']}): bad dur {dur!r}")
                continue
            spans_by_tid.setdefault(
                (ev["pid"], ev["tid"]), []
            ).append(ev)
        elif ev["ph"] == "i":
            instants.append(ev)
        elif ev["ph"] not in ("I", "M", "C"):
            errors.append(f"event {i}: unknown ph {ev['ph']!r}")
    # span nesting: on one thread, two spans either nest or are disjoint
    for tid, spans in spans_by_tid.items():
        spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
        open_stack: list[dict] = []
        for ev in spans:
            while open_stack and (
                open_stack[-1]["ts"] + open_stack[-1]["dur"] <= ev["ts"]
            ):
                open_stack.pop()
            if open_stack:
                top = open_stack[-1]
                if ev["ts"] + ev["dur"] > top["ts"] + top["dur"] + 1e-6:
                    errors.append(
                        f"span `{ev['name']}` (ts={ev['ts']:.1f}) "
                        f"partially overlaps `{top['name']}` on tid "
                        f"{tid} — corrupted span stack"
                    )
            open_stack.append(ev)
    # fence instants must land inside their owning span
    for ev in instants:
        if ev.get("cat") != FENCE_CAT:
            continue
        key = (ev["pid"], ev["tid"])
        owner = (ev.get("args") or {}).get("span")
        hits = [
            s for s in spans_by_tid.get(key, [])
            if s["ts"] - 1e-6 <= ev["ts"] <= s["ts"] + s["dur"] + 1e-6
        ]
        if not hits:
            errors.append(
                f"fence instant `{ev['name']}` (ts={ev['ts']:.1f}) lies "
                "inside no span — crossings must be owned by a phase"
            )
        elif owner is not None and owner not in {
            s["name"] for s in hits
        }:
            errors.append(
                f"fence instant `{ev['name']}` claims owning span "
                f"`{owner}` but lies inside {sorted(s['name'] for s in hits)}"
            )
    return errors


def validate_trace_file(path: str) -> list[str]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable trace file: {e}"]
    return validate_trace(data)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m crdt_benches_tpu_torch.obs.trace TRACE.json",
              file=sys.stderr)
        return 2
    errors = validate_trace_file(argv[0])
    for e in errors:
        print(f"{argv[0]}: {e}", file=sys.stderr)
    n_ev = 0
    if not errors:
        with open(argv[0], encoding="utf-8") as f:
            n_ev = len(json.load(f)["traceEvents"])
        print(f"{argv[0]}: valid ({n_ev} events)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
