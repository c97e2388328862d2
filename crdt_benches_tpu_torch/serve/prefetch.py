"""Predictive prefetch: the cold-to-warm rehydrate thread (the JAX
package's ``serve/prefetch.py``: its spool kind and its construct kind).

The tiered ``DocPool`` (``serve/pool.py``) keeps a bounded host **warm**
tier between the device rows (hot) and the compressed spool (cold).  A
cold doc the scheduler is about to admit would pay a synchronous spool
read (inflate and CRC check) on the hot thread; this module moves that
read off the drain.  The scheduler submits the cold docs at the front of
its round-robin rotation, one worker thread loads their spools, and the
rows come back through one publish point on a bounded queue, so by the
time the scheduler selects such a doc it is a warm hit.  A streamed fleet
(``serve/scheduler.py LazyStreams``) also submits **construct** requests:
the tensorization of a genesis doc's stream the rotation is about to reach,
built on the thread by a pure builder over the frozen ``FleetSpec``.

Thread confinement:

- a request is an immutable ``("spool", seq, doc_id, spool_path, gen)``
  or ``("construct", seq, doc_id, builder)`` tuple holding all the work
  needs: the worker touches nothing the hot thread owns (no pool, no
  stream, no bucket), and never torch or CUDA — ``load_state`` is numpy
  and zlib, a builder is numpy tensorization (``build_stream_payload``),
  and a payload is a dict of numpy arrays and ints;
- loaded rows cross back only through :meth:`Prefetcher._publish`, a
  bounded ``put`` and a publish point of the race sanitizer
  (``lint/race_sanitizer.py``: ``published``, ``share``) that counts its
  entries (``published_count``, written by the worker alone); the hot
  thread's :meth:`drain` is the reader gate (``reveal``) and counts its
  own (``revealed_count``).  The worker thread is a ``thread`` resource
  and ``inflight`` a gauge of the lifecycle sanitizer;
- the hot thread never blocks on the worker: :meth:`submit` is
  ``put_nowait`` (a full queue refuses the prefetch and counts it),
  :meth:`drain` is ``get_nowait``, and an admission that misses the warm
  tier takes the synchronous spool read it always had.

Staleness is the hot thread's to judge: a payload carries the doc's spool
generation at submit time (``DocPool.spool_gen``), and the pool drops a
payload whose generation moved (the doc was re-admitted and re-evicted
while the read ran).  ``save_state`` lands spools with ``os.replace``, so
a read races only a complete old file, never a torn one.

Every submission is stamped with an increasing **sequence number**, and
reaping is by sequence: :meth:`note_lost` remembers the reaped seqs, and
a payload that outlived its reaping is dropped at harvest without a
second ``inflight`` decrement.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable

import numpy as np

from ..lint import lifecycle_sanitizer as lifecycle
from ..lint.race_sanitizer import published, reveal, share
from ..utils.checkpoint import load_state

#: Default bound of the request and result queues: deep enough for one
#: macro-round's admissions, small enough that a wedged worker shows as
#: refused submissions, not unbounded memory.
DEFAULT_CAPACITY = 256


class Prefetcher:
    """The cold-to-warm rehydrate worker (the module docstring has the
    model).  Hot-thread surface: :meth:`submit`, :meth:`submit_construct`,
    :meth:`note_lost`, :meth:`drain`, :meth:`start` and :meth:`stop` (none
    blocks, or each wait is bounded).  Worker surface: :meth:`_run` and
    :meth:`_publish`.  Every counter but ``published_count`` belongs to the
    hot thread."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        cap = max(4, int(capacity))
        #: the submission bound the scheduler keeps: never more reads
        #: outstanding than the result queue (same size) can absorb
        self.capacity = cap
        self._req: queue.Queue = queue.Queue(maxsize=cap)
        self._res: queue.Queue = queue.Queue(maxsize=cap)
        self._thread: threading.Thread | None = None
        self.submitted = 0
        self.dropped = 0  # request queue full: prefetch refused
        self.harvested = 0
        self.errors = 0  # payloads that came back with a load error
        self.lost = 0  # reaped by the scheduler
        self.reap_dropped = 0  # payloads that arrived after their reap
        self.inflight = 0
        #: payloads through the reader gate (hot thread)
        self.revealed_count = 0
        #: payloads through the publish point (worker thread)
        self.published_count = 0
        #: the next submission's sequence number; from 1, so an accepted
        #: :meth:`submit` is truthy and 0 means refused
        self._seq = 1
        #: reaped seqs whose payloads may still arrive
        self._reaped: set[int] = set()

    def note_lost(self, seqs: Iterable[int]) -> None:
        """The scheduler reaped in-flight submissions whose results never
        arrived.  ``inflight`` drops once for each, here; the seqs are
        remembered so a payload that merely outlived its reaping is
        discarded at harvest without a second decrement."""
        seqs = [int(s) for s in seqs]
        self._reaped.update(seqs)
        self.lost += len(seqs)
        self.inflight = max(0, self.inflight - len(seqs))
        lifecycle.gauge("prefetch_inflight", self.inflight)

    # ---- lifetime (the pool's constructor and close) ----

    def start(self) -> None:  # graftlint: acquire=thread
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="serve-prefetch", daemon=True)
        self._thread.start()
        lifecycle.acquire("thread", id(self))

    def stop(self) -> None:  # graftlint: release=thread
        """Stop the worker.  Requests not yet taken are dropped (counted),
        so the sentinel always finds room and the worker always exits
        once its current load ends.  The join is bounded: a worker wedged
        in a load is left behind as a daemon thread, never joined
        forever."""
        if self._thread is None:
            return
        while True:
            try:
                self._req.get_nowait()
            except queue.Empty:
                break
            self.dropped += 1
            self.inflight = max(0, self.inflight - 1)
        self._req.put_nowait(None)  # only this thread puts: room for it
        self._thread.join(timeout=5.0)
        self._thread = None
        lifecycle.release("thread", id(self))

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ---- hot-thread surface (never blocks) ----

    def submit(self, doc_id: int, spool_path: str, gen: int) -> int:
        """Queue one cold-to-warm rehydrate.  A full queue refuses it
        (counted: the admission takes the synchronous read).  Returns the
        submission's sequence number (>= 1), or 0 when refused."""
        return self._enqueue(
            ("spool", self._seq, int(doc_id), str(spool_path), int(gen)))

    def submit_construct(self, doc_id: int,
                         builder: Callable[[], dict]) -> int:
        """Queue one first-admission stream construction.  ``builder`` must
        be pure (a ``functools.partial`` over immutable inputs): it runs on
        the thread, and its dict comes back through :meth:`_publish` like
        a rehydrate.  The same sequence and refusal contract as
        :meth:`submit`."""
        return self._enqueue(("construct", self._seq, int(doc_id), builder))

    def _enqueue(self, item: tuple) -> int:
        try:
            self._req.put_nowait(item)
        except queue.Full:
            self.dropped += 1
            return 0
        self._seq += 1
        self.submitted += 1
        self.inflight += 1
        return item[1]

    def drain(self) -> list[dict]:
        """Every completed rehydrate (never blocks): the reader gate.  A
        payload whose seq was reaped is discarded without a second
        ``inflight`` decrement."""
        out: list[dict] = []
        while True:
            try:
                item = self._res.get_nowait()
            except queue.Empty:
                break
            payload = reveal(item)
            self.revealed_count += 1
            seq = payload["seq"]
            if seq in self._reaped:
                self._reaped.discard(seq)
                self.reap_dropped += 1
                continue
            self.inflight -= 1
            lifecycle.gauge("prefetch_inflight", self.inflight)
            self.harvested += 1
            if payload["error"] is not None:
                self.errors += 1
            out.append(payload)
        return out

    # ---- the prefetch thread ----

    def _run(self) -> None:  # graftlint: thread=prefetch
        """Worker loop: wait on the request queue, load the spool or build
        the stream, publish the result.  A damaged or vanished spool, or a
        builder that raised, is not this thread's to repair: the error
        rides back in the payload, and the hot thread's synchronous path
        reads the spool or materializes the stream itself."""
        while True:
            item = self._req.get()
            if item is None:
                return
            kind, seq, doc_id = item[:3]
            if kind == "spool":
                path, gen = item[3:]
                try:
                    st = load_state(path)
                    payload = {
                        "kind": "spool", "seq": seq, "doc": doc_id,
                        "gen": gen, "row": np.asarray(st.doc[0], np.int32),
                        "length": int(st.length[0]),
                        "nvis": int(st.nvis[0]), "error": None,
                    }
                except Exception as e:  # CRC damage, vanished file, ...
                    payload = {
                        "kind": "spool", "seq": seq, "doc": doc_id,
                        "gen": gen, "row": None, "length": 0, "nvis": 0,
                        "error": f"{type(e).__name__}: {e}",
                    }
            else:  # construct: a genesis doc's tensorization, off the drain
                try:
                    payload = dict(item[3]())
                    payload.update(kind="construct", seq=seq, doc=doc_id,
                                   error=None)
                except Exception as e:
                    payload = {"kind": "construct", "seq": seq,
                               "doc": doc_id,
                               "error": f"{type(e).__name__}: {e}"}
            try:
                self._publish(payload)
            except queue.Full:
                continue  # the hot thread stopped draining: dropped

    @published
    def _publish(self, payload: dict) -> None:  # graftlint: publish=prefetch  # graftlint: thread=prefetch
        """The one publish point: a loaded row leaves the worker.  The
        ``put`` is bounded, so a consumer that stopped draining can never
        park the worker forever.  Counted on entry, as the reader gate
        counts on its own."""
        self.published_count += 1
        self._res.put(share(payload, "Prefetcher.result"), timeout=30.0)
