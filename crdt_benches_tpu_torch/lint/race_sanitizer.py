"""Runtime race sanitizer (the JAX package's ``lint/race_sanitizer.py``).

A publish point is a function that hands an object from the thread that
built it to another (the status server's snapshots, the prefetcher's
results, the ingest front's deliveries, the journal's records, the
broadcast bus's blocks).  Every declared point routes through
:func:`publish_point` (usually the :func:`published` decorator, keyed by
the function's ``__qualname__`` so the counters equal JAX's) and counts its
**entries**: always, in every mode, one lock-guarded dict increment a
handoff.  Observers (:func:`add_publish_observer`: the request tracer)
see every entry.

Armed (:func:`arm`, the serve bench's ``sanitize=("races",)``; options are
arguments, never environment variables), :func:`share` wraps the object
handed over in a :class:`SharedProxy` that remembers its owner thread,
its publish generation and the point that last released it.  An access
from another thread while the object is unpublished raises
:class:`UndeclaredCrossThreadAccess` at the callsite; so does a mutation
after publish through the shared reference, and a read that finds the
snapshot changed since its publish (each publish fingerprints it).  Legal
cross-thread reads count against the point that made them legal: the
per-point **crossings**.  The serve report carries both as its
``thread_crossings`` block.

Disarmed, :func:`share` and :func:`reveal` return their argument
unchanged: the only cost is the publish-entry counter bump.
"""

from __future__ import annotations

import functools
import json
import threading
from contextlib import contextmanager


class UndeclaredCrossThreadAccess(RuntimeError):
    """An object crossed host threads outside every declared publish
    point (or was mutated after publish)."""


_tls = threading.local()
#: Publish-point entry counts, bumped in EVERY run, like the sync
#: sanitizer's fence entries.
_publishes: dict[str, int] = {}
#: Cross-thread accesses attributed to the publish point that made
#: them legal — only populated while the sanitizer is armed (the
#: proxies are what observe individual accesses).
_crossings: dict[str, int] = {}
#: Crossing bumps come from reader threads (the status server's
#: handler pool) and publish bumps from the prefetch worker and the
#: ingest handlers, so the tables take a real mutex (one dict store).
_mu = threading.Lock()

#: Publish-entry observers (the sanitizer's fence-observer pattern,
#: lint/sanitizer.py): each is called with the point's qualname at
#: every publish-point entry, OUTSIDE the counter mutex.  The request
#: tracer (obs/reqtrace.py) hooks here so every trace-context
#: propagation edge IS a declared publish point — the crossing
#: counters and the request trace stay one causal picture.  Observers
#: run on the publishing thread (for every point in this stack, the
#: hot thread); an observer that needs cross-thread safety brings its
#: own.
_publish_observers: list = []


def add_publish_observer(fn) -> None:
    if fn not in _publish_observers:
        _publish_observers.append(fn)


def remove_publish_observer(fn) -> None:
    try:
        _publish_observers.remove(fn)
    except ValueError:
        pass


_armed = False


def armed() -> bool:
    return _armed


def arm() -> None:
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def reset_counters() -> None:
    """Zero both counter tables (each bench run owns its window)."""
    with _mu:
        _publishes.clear()
        _crossings.clear()


def counters() -> dict[str, dict[str, int]]:
    """Snapshot: ``{"publishes": {point: n}, "crossings": {point: n}}``.
    ``crossings`` is only populated while the sanitizer is armed."""
    with _mu:
        return {
            "publishes": dict(sorted(_publishes.items())),
            "crossings": dict(sorted(_crossings.items())),
        }


def _point_stack() -> list:
    s = getattr(_tls, "points", None)
    if s is None:
        s = _tls.points = []
    return s


#: Receiver-mutating method names the proxy treats as writes.
MUTATOR_METHODS = frozenset({
    "append", "extend", "insert", "update", "setdefault", "pop",
    "popitem", "popleft", "appendleft", "clear", "add", "discard",
    "remove", "sort", "reverse",
})

_SLOTS = ("_graft_target", "_graft_label", "_graft_owner",
          "_graft_gen", "_graft_point", "_graft_fp")


def _fingerprint(obj) -> str | None:
    """Content fingerprint of a published snapshot, or None when the
    object is not canonically serializable.  The snapshots this module
    guards are JSON-serializable by contract (/status.json and the
    Prometheus renderer consume them), so in practice every publish
    gets one."""
    try:
        return json.dumps(obj, sort_keys=True, default=repr)
    except Exception:
        return None


class SharedProxy:
    """Ownership-tracking wrapper around one shared object.

    Owner-thread accesses are free until the object is published; a
    publish (inside a declared publish point) freezes it — further
    in-place mutation from ANY thread raises — and licenses
    cross-thread reads, each counted against the publish point.  An
    unpublished cross-thread access raises at the callsite."""

    __slots__ = _SLOTS

    def __init__(self, target, label: str):
        object.__setattr__(self, "_graft_target", target)
        object.__setattr__(self, "_graft_label", label)
        object.__setattr__(self, "_graft_owner", threading.get_ident())
        object.__setattr__(self, "_graft_gen", 0)
        object.__setattr__(self, "_graft_point", None)
        object.__setattr__(self, "_graft_fp", None)

    # -- the access rule --

    def _graft_check(self, mutate: bool, what: str) -> None:
        tid = threading.get_ident()
        gen = self._graft_gen
        if tid == self._graft_owner:
            if mutate and gen:
                raise UndeclaredCrossThreadAccess(
                    f"owner mutation `{what}` of `{self._graft_label}` "
                    f"AFTER publish (generation {gen}, via "
                    f"`{self._graft_point}`): a published object is "
                    "frozen — readers on other threads may hold it; "
                    "build a fresh object and publish that instead"
                )
            return
        if gen == 0:
            raise UndeclaredCrossThreadAccess(
                f"undeclared cross-thread access `{what}` to "
                f"`{self._graft_label}` (owner thread "
                f"{self._graft_owner}, reader thread {tid}): the "
                "object never passed a declared publish point — "
                "hand it over inside a @published function"
            )
        if mutate:
            raise UndeclaredCrossThreadAccess(
                f"reader-side mutation `{what}` of published "
                f"`{self._graft_label}` (thread {tid}): what crosses "
                "a publish point is read-only on the far side — copy "
                "before mutating"
            )
        # torn-publish detection: the proxy cannot see a mutation made
        # through a bare alias the publisher retained, but the
        # fingerprint taken at publish can — verify it at every legal
        # cross-thread read, so the tear raises at the read that would
        # have observed it.
        fp = self._graft_fp
        if fp is not None and _fingerprint(self._graft_target) != fp:
            raise UndeclaredCrossThreadAccess(
                f"torn publish of `{self._graft_label}` observed at "
                f"read `{what}` (thread {tid}, via "
                f"`{self._graft_point}`): the snapshot changed after "
                "its publish — the publisher mutated a retained bare "
                "reference; a published object is frozen, build a "
                "fresh one and publish that instead"
            )
        point = self._graft_point
        with _mu:
            _crossings[point] = _crossings.get(point, 0) + 1

    def _graft_publish(self, point: str) -> None:
        object.__setattr__(self, "_graft_gen", self._graft_gen + 1)
        object.__setattr__(self, "_graft_point", point)
        object.__setattr__(self, "_graft_fp",
                           _fingerprint(self._graft_target))

    # -- forwarding surface --

    def __getattr__(self, name):
        self._graft_check(name in MUTATOR_METHODS, name)
        return getattr(self._graft_target, name)

    def __setattr__(self, name, value):
        self._graft_check(True, f"set {name}")
        setattr(self._graft_target, name, value)

    def __getitem__(self, k):
        self._graft_check(False, f"[{k!r}]")
        return self._graft_target[k]

    def __setitem__(self, k, v):
        self._graft_check(True, f"[{k!r}] = ...")
        self._graft_target[k] = v

    def __delitem__(self, k):
        self._graft_check(True, f"del [{k!r}]")
        del self._graft_target[k]

    def __iter__(self):
        self._graft_check(False, "iter")
        return iter(self._graft_target)

    def __len__(self):
        self._graft_check(False, "len")
        return len(self._graft_target)

    def __contains__(self, k):
        self._graft_check(False, "in")
        return k in self._graft_target

    def __bool__(self):
        self._graft_check(False, "bool")
        return bool(self._graft_target)

    def __repr__(self):
        return (
            f"SharedProxy({self._graft_label!r}, "
            f"gen={self._graft_gen}, via={self._graft_point!r})"
        )


def share(obj, label: str | None = None):
    """Wrap ``obj`` for cross-thread handoff.  Disarmed: returns
    ``obj`` unchanged (identity — the zero-overhead contract).  Armed:
    returns (or re-publishes) a :class:`SharedProxy`; when called
    inside an active publish point the proxy's generation bumps and
    the handoff is attributed to that point, otherwise the object
    stays owner-confined until a publish releases it."""
    if not _armed:
        return obj
    if isinstance(obj, SharedProxy):
        proxy = obj
    else:
        proxy = SharedProxy(obj, label or type(obj).__name__)
    stack = _point_stack()
    if stack:
        proxy._graft_publish(stack[-1])
    return proxy


def reveal(obj):
    """The reader-side gate: check the cross-thread access (counted
    against the licensing publish point; raises if unpublished) and
    return the BARE object — callers hand it to code that needs the
    real type (``json.dumps``, the Prometheus renderer).  Identity on
    non-proxies, so disarmed paths pass straight through."""
    if isinstance(obj, SharedProxy):
        obj._graft_check(False, "reveal")
        return obj._graft_target
    return obj


@contextmanager
def publish_point(name: str):
    """One declared publish-point entry: count it (always), and while inside,
    every :func:`share` call is a publish attributed to ``name``."""
    with _mu:
        _publishes[name] = _publishes.get(name, 0) + 1
    if _publish_observers:  # disarmed runs keep the entry allocation-free
        for fn in list(_publish_observers):
            fn(name)
    stack = _point_stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def published(fn):
    """Decorator form of :func:`publish_point`, keyed by
    ``__qualname__`` so the counter names equal JAX's."""
    name = fn.__qualname__

    @functools.wraps(fn)
    def handoff(*args, **kwargs):
        with publish_point(name):
            return fn(*args, **kwargs)

    return handoff
