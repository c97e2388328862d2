"""Runtime lifecycle sanitizer (the JAX package's
``lint/lifecycle_sanitizer.py``), and the leak oracle behind the churn
harness (``serve/lifecheck.py``).

The serve stack declares its state machines (:func:`declare_machine`: the
doc's residency, the reshard coordinator's row machine, an ingest
session, a lazily built stream) and its owned resources (device rows,
sockets, threads).  Every declared transition routes through
:func:`transition` (keyed ``machine, frm, to``) and counts its **edges**;
:func:`acquire`/:func:`release` count a resource's pairs: always, in every
mode, one lock-guarded dict increment.  These counters are the serve
report's ``lifecycle`` block.

Armed (:func:`arm`, the serve bench's ``sanitize=("lifecycle",)`` or the
lifecheck harness; options are arguments, never environment variables),
the model is enforced live: an edge missing from the declared graph
raises :class:`UndeclaredTransitionError`, a release of a key that is not
live :class:`DoubleReleaseError`, a touch of a released key
(:func:`touch`) :class:`UseAfterReleaseError` and a gauge below zero
(:func:`gauge`) :class:`NegativeGaugeError`, each at the callsite.  Live
keys carry a generation bumped at every re-acquire, so a recycled id is a
new object.  :func:`assert_all_released` is the drain-end leak gate.

Disarmed, nothing is enforced and nothing is tracked: the only cost is
the counter bump.
"""

from __future__ import annotations

import threading

class LifecycleError(RuntimeError):
    """Base class for every armed lifecycle violation."""


class UndeclaredTransitionError(LifecycleError):
    """A runtime transition along an edge missing from the declared
    state-machine graph, or departing from a state the instance is not
    in."""


class DoubleReleaseError(LifecycleError):
    """A release of a ``(resource, key)`` that is not live: either it
    was already released (the duplicate-GC-enqueue shape) or it was
    never acquired at all."""


class UseAfterReleaseError(LifecycleError):
    """A touch of a ``(resource, key)`` after its release — reading a
    released stream's arrays is reading freed memory in spirit."""


class NegativeGaugeError(LifecycleError):
    """A paired inc/dec counter observed below zero (the prefetcher's
    in-flight count, say)."""


class LifecycleLeakError(LifecycleError):
    """A drain ended with live acquisitions."""


#: Transition/acquire counts come from whatever thread runs the
#: protocol (the prefetch worker releases off-thread), so the counter
#: tables take a real mutex — same reasoning as fs_sanitizer._mu.
_mu = threading.Lock()
#: The machine vocabulary (the static rules reject any other tag).
KNOWN_MACHINES = ("doc", "row", "spool", "stream", "session")

#: The resource vocabulary for acquire/release pairing.
KNOWN_RESOURCES = ("rows", "spool", "stream", "segment", "socket",
                   "thread")

_machines: dict[str, dict[str, int]] = {}  # machine -> edge -> count
_resources: dict[str, dict[str, int]] = {}  # resource -> acq/rel count
_unattributed: list[str] = []  # transitions on undeclared machines
_gauges: dict[str, int] = {}  # gauge -> last observed value

_decls: dict[str, dict] = {}  # machine -> {"states": set, "edges": set}
_live: dict[tuple[str, object], int] = {}  # (resource, key) -> gen
_released: dict[tuple[str, object], int] = {}  # last released gen
_gens: dict[tuple[str, object], int] = {}  # next generation per key

_armed = False

_UNATTRIBUTED_CAP = 256  # bounded: a hot loop must not grow a list


def armed() -> bool:
    return _armed


def arm() -> None:
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def reset_counters() -> None:
    """Zero the counter tables and the live-object model (each bench
    run owns its window).  Machine declarations survive — they
    describe the code, not the run's history."""
    with _mu:
        _machines.clear()
        _resources.clear()
        _unattributed.clear()
        _gauges.clear()
        _live.clear()
        _released.clear()
        _gens.clear()
        _states.clear()


def declare_machine(name: str, states, edges) -> None:
    """Register a state machine's legal graph: ``states`` an iterable
    of state names, ``edges`` an iterable of ``(frm, to)`` pairs.
    Idempotent per name; the graphs are JAX's."""
    with _mu:
        _decls[name] = {
            "states": frozenset(states),
            "edges": frozenset(tuple(e) for e in edges),
        }


def transition(machine: str, frm: str, to: str, key=None) -> None:
    """One state-machine edge traversal.  Counted in EVERY mode (the
    ``lifecycle`` block); armed, the edge must be in the declared graph
    and — when ``key`` identifies the instance — must depart from the
    instance's actual current state."""
    edge = f"{frm}->{to}"
    decl = _decls.get(machine)
    with _mu:
        if decl is None:
            if len(_unattributed) < _UNATTRIBUTED_CAP:
                _unattributed.append(f"{machine}:{edge}")
        else:
            t = _machines.setdefault(machine, {})
            t[edge] = t.get(edge, 0) + 1
    if not _armed:
        return
    if decl is None:
        raise UndeclaredTransitionError(
            f"transition `{edge}` on undeclared machine `{machine}` — "
            "declare_machine() it first"
        )
    if (frm, to) not in decl["edges"]:
        raise UndeclaredTransitionError(
            f"illegal `{machine}` transition `{edge}`: not in the "
            f"declared edge graph "
            f"{sorted('->'.join(e) for e in decl['edges'])}"
        )
    if key is not None:
        k = (machine, key)
        with _mu:
            cur = _states.get(k)
            if cur is not None and cur != frm:
                raise UndeclaredTransitionError(
                    f"`{machine}` instance {key!r} is in state "
                    f"`{cur}`, not `{frm}` — transition `{edge}` "
                    f"departs from a state the instance never reached "
                    f""
                )
            _states[k] = to


_states: dict[tuple[str, object], str] = {}  # (machine, key) -> state


def acquire(resource: str, key) -> None:
    """One resource acquisition.  Counted in EVERY mode; armed, the
    ``(resource, key)`` pair becomes live under a fresh generation
    (re-acquiring a recycled key is a NEW object, never a stale
    hit)."""
    with _mu:
        t = _resources.setdefault(resource, {})
        t["acquire"] = t.get("acquire", 0) + 1
        if _armed:
            k = (resource, key)
            gen = _gens.get(k, 0) + 1
            _gens[k] = gen
            _live[k] = gen
            _released.pop(k, None)


def release(resource: str, key) -> None:
    """One resource release.  Counted in EVERY mode; armed, releasing
    a key that is not live is a typed error at the callsite."""
    with _mu:
        t = _resources.setdefault(resource, {})
        t["release"] = t.get("release", 0) + 1
        if not _armed:
            return
        k = (resource, key)
        gen = _live.pop(k, None)
        if gen is not None:
            _released[k] = gen
            return
        prior = _released.get(k)
    if prior is not None:
        raise DoubleReleaseError(
            f"double release of {resource} key {key!r} "
            f"(generation {prior} already released)"
        )
    raise DoubleReleaseError(
        f"release of {resource} key {key!r} that was never acquired "
        f""
    )


def touch(resource: str, key) -> None:
    """Assert a resource is live before use — armed, touching a
    released key raises at the callsite (use-after-release); a key the
    model has never seen is out of jurisdiction and passes."""
    if not _armed:
        return
    k = (resource, key)
    with _mu:
        live = k in _live
        was_released = _released.get(k)
    if not live and was_released is not None:
        raise UseAfterReleaseError(
            f"use of {resource} key {key!r} after its release "
            f"(generation {was_released})"
        )


def gauge(name: str, value: int) -> None:
    """Observe a paired inc/dec counter.  Recorded in every mode;
    armed, a negative observation is a typed error."""
    with _mu:
        _gauges[name] = value
    if _armed and value < 0:
        raise NegativeGaugeError(
            f"gauge `{name}` observed at {value} — an inc/dec "
            f"imbalance drove a paired counter negative"
        )


def live_count(resource: str | None = None) -> int:
    """Live (unreleased) acquisitions, optionally for one resource —
    only meaningful armed (disarmed, nothing is tracked)."""
    with _mu:
        if resource is None:
            return len(_live)
        return sum(1 for (r, _k) in _live if r == resource)


def assert_all_released() -> None:
    """The drain-end leak gate: every acquisition released, or a
    :class:`LifecycleLeakError` naming the leaked keys."""
    with _mu:
        leaked = sorted(_live, key=repr)
    if leaked:
        raise LifecycleLeakError(
            f"{len(leaked)} unreleased acquisition(s) at drain end: "
            + ", ".join(f"{r}:{k!r}" for r, k in leaked[:20])
            + (" ..." if len(leaked) > 20 else "")
        )


def counters() -> dict:
    """Snapshot: ``{"machines": {m: {edge: n}}, "resources": {r:
    {"acquire": n, "release": n}}, "gauges": {name: last},
    "unattributed": [...]}``.  Machine/resource tables are populated
    in every mode."""
    with _mu:
        return {
            "machines": {
                m: dict(sorted(t.items()))
                for m, t in sorted(_machines.items())
            },
            "resources": {
                r: dict(sorted(t.items()))
                for r, t in sorted(_resources.items())
            },
            "gauges": dict(sorted(_gauges.items())),
            "unattributed": sorted(set(_unattributed)),
        }
