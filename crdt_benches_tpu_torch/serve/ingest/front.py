"""The thread-confined TCP ingest front (the JAX package's
``serve/ingest/front.py``).

A sibling of ``obs/status.py``'s HTTP server with the confinement turned
round: status flows from the hot thread to the handlers, ingest from the
handlers to the hot thread.

**Wire format**, one frame a line::

    <crc32:08x> <json>\\n

where the checksum covers the JSON bytes exactly (the journal's line
convention).  Frame kinds, all JSON objects with a ``t`` field:

- ``hello`` ``{t, session, doc, tenant, resume?}`` binds this connection
  to ONE session writing ONE doc.  ``resume`` marks a reconnect after a
  drop (connection churn): delivery is idempotent downstream
  (``delivered`` is monotonic, a redelivery is clamped), so a resumed
  session re-sends from its last acked offset;
- ``ops`` ``{t, seq, start, count, round}`` delivers the next ``count``
  ops of the session's stream from absolute op offset ``start``.  ``seq``
  rises strictly a connection; the server acks each frame
  (``{"t":"ack","seq":n}``) before the client sends the next, so the
  session's order reaches the scheduler's bounded per-doc queue intact;
- ``bye`` ``{t, session}`` closes cleanly.

Server replies are unframed JSON lines: ``ack``; ``retry`` (the delivery
queue is full, or the frame's planned round is still ahead of the server's
clock: re-send the same frame, so the wire itself paces the open-loop
arrivals); ``err`` (a protocol violation: the connection closes); ``churn``
(the chaos fault dropped you: reconnect and resume).

**Confinement**: handler threads own nothing but their connection's
state; every payload crosses to the hot pump through ONE point,
:meth:`IngestFront._publish`, a bounded ``put`` and a publish point of the
race sanitizer (``lint/race_sanitizer.py``), and the pump's
:meth:`IngestFront.drain` reads it through the ``reveal`` gate.  Every counter belongs to the hot
thread: handler-side events (a bad CRC, a churn drop) ride the published
payloads and are tallied at the drain.  The hot thread signals the
handlers only through :meth:`churn`'s generation bump and the clock
``now``, each an int swap.  A session walks the lifecycle sanitizer's
``session`` machine (new, open, closed or dropped, its edges counted at the
drain) and the listening socket is a ``socket`` resource.
"""

from __future__ import annotations

import json
import queue
import socketserver
import threading
import zlib

from ...lint import lifecycle_sanitizer as lifecycle
from ...lint.race_sanitizer import published, reveal, share

__all__ = ["IngestFront", "encode_frame", "decode_frame", "FRAME_KINDS"]

FRAME_KINDS = ("hello", "ops", "bye")

#: the delivery queue's bound: deep enough to absorb a macro-round of
#: frames from every live connection, small enough that a stalled pump
#: turns into client-visible ``retry`` backpressure, not memory growth
DEFAULT_CAPACITY = 1024

#: the longest frame line a handler reads (bytes)
MAX_FRAME = 1 << 16

#: rounds ahead of the hot thread's clock a frame's planned arrival may be
#: and still be acked; a frame planned later gets a ``retry``
PACE_SLACK = 2


def encode_frame(obj: dict) -> bytes:
    """One CRC-framed wire line for ``obj`` (the client's side, tests)."""
    body = json.dumps(obj, separators=(",", ":"), sort_keys=True)
    raw = body.encode("utf-8")
    return f"{zlib.crc32(raw):08x} ".encode("ascii") + raw + b"\n"


def decode_frame(line: bytes) -> dict:
    """Parse and verify one wire line; ``ValueError`` on a short line, a
    CRC mismatch or JSON that is not an object with ``t``."""
    line = line.rstrip(b"\r\n")
    if len(line) < 10 or line[8:9] != b" ":
        raise ValueError("short frame")
    try:
        want = int(line[:8], 16)
    except ValueError:
        raise ValueError("bad crc field") from None
    raw = line[9:]
    got = zlib.crc32(raw)
    if got != want:
        raise ValueError(f"crc mismatch (want {want:08x} got {got:08x})")
    obj = json.loads(raw.decode("utf-8"))
    if not isinstance(obj, dict) or "t" not in obj:
        raise ValueError("frame is not an object with 't'")
    return obj


class _IngestHandler(socketserver.StreamRequestHandler):
    """One connection = one session = one doc.  Connection-local state
    only; everything leaving this thread goes through the front's publish
    point."""

    def handle(self) -> None:
        front: IngestFront = self.server.owner  # type: ignore[attr-defined]
        churn_gen = front.churn_gen  # the generation at accept
        session = doc = tenant = None
        last_seq = -1
        while True:
            try:
                line = self.rfile.readline(MAX_FRAME)
            except OSError:
                return
            if not line:
                return  # the peer closed
            if front.churn_gen != churn_gen:
                # the chaos fault dropped this connection: tell the client
                # to reconnect and resume, and show the drop to the pump
                # (the fault's evidence of firing; session is None when
                # the churn raced the hello: still a drop)
                front.publish({"kind": "churn_drop",
                               "session": session, "doc": doc,
                               "tenant": tenant})
                self._reply({"t": "churn"})
                return
            try:
                frame = decode_frame(line)
            except ValueError as e:
                front.publish({"kind": "bad_frame", "why": str(e)})
                self._reply({"t": "err", "why": str(e)})
                return
            kind = frame.get("t")
            if kind == "hello":
                if session is not None:
                    self._reply({"t": "err", "why": "double hello"})
                    return
                session = frame.get("session")
                doc = frame.get("doc")
                tenant = frame.get("tenant", "default")
                if doc not in front.valid_docs:
                    self._reply({"t": "err", "why": f"unknown doc {doc!r}"})
                    return
                if tenant not in front.tenant_names:
                    self._reply(
                        {"t": "err", "why": f"unknown tenant {tenant!r}"})
                    return
                front.publish({"kind": "hello", "session": session,
                               "doc": doc, "tenant": tenant,
                               "resume": bool(frame.get("resume"))})
                self._reply({"t": "ack", "seq": -1})
            elif kind == "ops":
                if session is None:
                    self._reply({"t": "err", "why": "ops before hello"})
                    return
                seq = int(frame.get("seq", -1))
                if seq <= last_seq:
                    front.publish({"kind": "bad_frame",
                                   "why": f"seq regression {seq}"})
                    self._reply({"t": "err",
                                 "why": f"seq {seq} <= {last_seq}"})
                    return
                rnd = int(frame.get("round", 0))
                if rnd > front.now + PACE_SLACK:
                    # the planned arrival is still ahead: the wire paces
                    # the open loop with a full queue's retry contract
                    # (the frame is not acked, the client re-sends it)
                    self._reply({"t": "retry", "seq": seq})
                    continue
                payload = {
                    "kind": "ops", "session": session, "doc": doc,
                    "tenant": tenant, "seq": seq,
                    "start": int(frame.get("start", 0)),
                    "count": int(frame.get("count", 0)),
                    "round": rnd,
                }
                if not front.publish(payload, timeout=front.put_timeout):
                    # the bounded queue is full: client-visible
                    # backpressure, the frame not acked; the client
                    # re-sends it, so no op is lost and order holds
                    self._reply({"t": "retry", "seq": seq})
                    continue
                last_seq = seq
                self._reply({"t": "ack", "seq": seq})
            elif kind == "bye":
                front.publish({"kind": "bye", "session": session})
                self._reply({"t": "ack", "seq": last_seq})
                return
            else:
                self._reply({"t": "err", "why": f"unknown kind {kind!r}"})
                return

    def _reply(self, obj: dict) -> None:
        try:
            self.wfile.write(
                json.dumps(obj, separators=(",", ":")).encode() + b"\n")
        except OSError:
            pass  # the peer vanished mid-reply: its redelivery is idempotent


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    owner: "IngestFront"


class IngestFront:
    """The sessioned op-intake server (the module docstring has the wire
    and confinement contracts).

    Hot thread: :meth:`drain`, :meth:`churn`, :attr:`idle` (none blocks).
    Handlers: :meth:`publish`.  The bench: :meth:`start`, :meth:`stop`."""

    def __init__(self, valid_docs, tenant_names=("default",), *,
                 capacity: int = DEFAULT_CAPACITY,
                 put_timeout: float = 2.0):
        # written once here, before any handler thread exists, and only
        # read after
        self.valid_docs = frozenset(valid_docs)
        self.tenant_names = frozenset(tenant_names)
        self.put_timeout = float(put_timeout)
        #: the hot thread's clock, published to the handlers as an int
        #: swap: a frame planned more than ``PACE_SLACK`` rounds ahead
        #: gets a ``retry``, so the wire enforces the open-loop arrivals
        #: and connections stay live across the drain (what conn_churn
        #: drops)
        self.now = 0
        self._q: queue.Queue = queue.Queue(maxsize=max(8, int(capacity)))
        self._srv: _Server | None = None
        self._thread: threading.Thread | None = None
        self.port: int | None = None
        #: the churn generation: bumped by the hot thread, compared by the
        #: handlers
        self.churn_gen = 0
        # the hot thread's counters (tallied in drain(), never by handlers)
        self.frames = 0
        self.ops_frames = 0
        self.ops_delivered = 0
        self.bad_frames = 0
        self.sessions_opened = 0
        self.sessions_resumed = 0
        self.sessions_closed = 0
        self.churn_drops = 0
        # the session machine's legal graph (JAX's).  Its edges are
        # counted unkeyed: a resumed session enters new->open again under
        # its name, and per-session order is the client protocol's
        lifecycle.declare_machine(
            "session", ("new", "open", "closed", "dropped"),
            (("new", "open"), ("open", "closed"), ("open", "dropped")))

    # ---- the bench ----

    def start(self) -> int:
        """Listen on an ephemeral loopback port; returns it."""
        if self._srv is not None:
            return self.port  # type: ignore[return-value]
        srv = _Server(("127.0.0.1", 0), _IngestHandler)
        srv.owner = self
        self._srv = srv
        self.port = srv.server_address[1]
        self._thread = threading.Thread(
            target=srv.serve_forever, name="serve-ingest", daemon=True,
            kwargs={"poll_interval": 0.05},
        )
        self._thread.start()
        lifecycle.acquire("socket", id(self))
        return self.port

    def stop(self) -> None:
        """Stop serving and release the port (idempotent)."""
        if self._srv is None:
            return
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._srv = None
        self._thread = None
        lifecycle.release("socket", id(self))

    # ---- the handlers ----

    def publish(self, payload: dict, timeout: float | None = None
                ) -> bool:
        """Hand one payload to the hot pump.  Control payloads use a short
        default timeout; ``ops`` frames pass the configured backpressure
        timeout and get False on a full queue, which the handler turns
        into a client ``retry``."""
        try:
            self._publish(payload, 1.0 if timeout is None else timeout)
        except queue.Full:
            return False
        return True

    @published
    def _publish(self, payload: dict, timeout: float) -> None:
        """THE crossing point: one frame's payload leaves the handler
        thread.  The bounded ``put`` makes a stalled pump show as client
        backpressure, never as an unbounded buffer."""
        self._q.put(share(payload, "IngestFront.delivery"), timeout=timeout)

    # ---- the hot thread (non-blocking) ----

    @property
    def idle(self) -> bool:
        return self._q.empty()

    def churn(self) -> None:
        """Drop every live connection at its next frame (the
        ``conn_churn`` chaos fault): a generation bump the handlers
        poll."""
        self.churn_gen = self.churn_gen + 1

    def drain(self) -> list[dict]:
        """Harvest every pending payload (never blocks), tallying the
        counters on the hot thread that owns them."""
        out: list[dict] = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            payload = reveal(item)
            self.frames += 1
            kind = payload.get("kind")
            if kind == "ops":
                self.ops_frames += 1
                self.ops_delivered += payload.get("count", 0)
            elif kind == "hello":
                self.sessions_opened += 1
                if payload.get("resume"):
                    self.sessions_resumed += 1
                lifecycle.transition("session", "new", "open")
            elif kind == "bye":
                self.sessions_closed += 1
                lifecycle.transition("session", "open", "closed")
            elif kind == "bad_frame":
                self.bad_frames += 1
            elif kind == "churn_drop":
                self.churn_drops += 1
                lifecycle.transition("session", "open", "dropped")
            out.append(payload)
        return out

    def status_fields(self) -> dict:
        """The hot thread's gauges for ``/status.json`` and the report."""
        return {
            "port": self.port,
            "frames": self.frames,
            "ops_frames": self.ops_frames,
            "ops_delivered": self.ops_delivered,
            "bad_frames": self.bad_frames,
            "sessions_opened": self.sessions_opened,
            "sessions_resumed": self.sessions_resumed,
            "sessions_closed": self.sessions_closed,
            "churn_drops": self.churn_drops,
            "queue_depth": self._q.qsize(),
        }
