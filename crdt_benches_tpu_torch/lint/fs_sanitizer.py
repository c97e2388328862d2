"""Runtime fs sanitizer (the JAX package's ``lint/fs_sanitizer.py``), and
the crash-point engine behind the crash enumeration (``serve/fscrash.py``).

A durable protocol is a sequence of filesystem operations that must stay
recoverable at every step (the WAL, snapshot barriers, segment GC, spool
writes, the reshard manifests, the flight dump).  Every declared protocol
routes through :func:`fs_protocol` (or the :func:`durable_protocol`
decorator, keyed by JAX's protocol tags) and counts its **entries**:
always, in every mode, one lock-guarded dict increment a run.

Armed (:func:`arm`, the serve bench's ``sanitize=("fs",)`` or the crash
harness; options are arguments, never environment variables), the
filesystem surface is interposed — ``os.replace`` / ``os.rename`` /
``os.link`` / ``os.unlink`` / ``os.remove`` / ``os.fsync`` /
``shutil.rmtree`` and ``open`` for writing — and every operation under a
**watched root** (:func:`watch_root`: the journal and spool directories)
is attributed to the innermost active protocol: the serve report's
``fs_ops`` block and the op log (:func:`op_log`, basenames).  Armed, a
destructive operation (unlink, rmtree) on a durable path inside a
protocol must follow a committed install (a replace or rename to a
durable target) or a read of the committed record, or it raises
:class:`DurableOrderingError` at the callsite.

:func:`crash_at` injects a crash at a mutating-operation boundary: the
``i``-th mutating operation on a watched root raises
:class:`InjectedCrash` instead of running, and every later one is a
silent no-op (a dead process writes nothing).

Disarmed, nothing is interposed: :func:`disarm` puts back every function
it replaced.  The only cost is the protocol-entry counter bump.
"""

from __future__ import annotations

import builtins
import functools
import os
import shutil
import threading
from contextlib import contextmanager

#: The protocol vocabulary (JAX's tags).
KNOWN_PROTOCOLS = ("snapshot", "gc", "wal", "spool", "flight",
                   "reshard")

#: Ops that change the filesystem — the crash-point boundaries.
#: ``update`` is an ``r+``-mode open (the WAL torn-tail truncate
#: repair): it mutates in place, so it is a boundary and frozen
#: post-crash, and it is NOT a read for the ordering check's witness.
MUTATING_OPS = frozenset(
    {"write", "append", "update", "replace", "rename", "link",
     "unlink", "rmtree"}
)
#: Ops that destroy a copy (the ordering check's jurisdiction).
DESTRUCTIVE_OPS = frozenset({"unlink", "rmtree"})
#: Ops that commit a staged replacement into its final name.
COMMIT_OPS = frozenset({"replace", "rename"})

#: Bounded in-memory op log (tests assert exact sequences off it).
_OP_LOG_CAP = 8192


class DurableOrderingError(RuntimeError):
    """A destructive fs op on a durable path-role fired inside a
    declared protocol entry before the committed install of its
    replacement."""


class InjectedCrash(BaseException):
    """The simulated kill at one fs-op boundary.  A ``BaseException``
    on purpose: recovery-relevant cleanup handlers catch ``OSError`` /
    ``Exception``, and a crash must not be swallowed by the very code
    whose crash window is under test."""


_tls = threading.local()
#: Crossing counts come from whatever thread runs the protocol (the
#: prefetch worker rehydrates spools off-thread), so the counter tables
#: take a real mutex — same reasoning as race_sanitizer._mu.
_mu = threading.Lock()
_protocols: dict[str, int] = {}  # entries, counted in EVERY mode
_ops: dict[str, dict[str, int]] = {}  # tag -> op -> count (armed)
_unattributed: dict[str, int] = {}  # mutating ops outside any protocol
_op_log: list[tuple[str | None, str, str]] = []  # (tag, op, basename)

_watch: list[str] = []
_armed = False

_crash_point: int | None = None
_mutations = 0
_crashed = False


def armed() -> bool:
    return _armed


def arm() -> None:
    """Interpose the filesystem surface and arm the checks."""
    global _armed
    _install()
    _armed = True


def disarm() -> None:
    """Passthrough: put back every replaced function."""
    global _armed
    _armed = False
    _uninstall()


def watch_root(path: str) -> None:
    """Register a directory as durable territory: ops on paths under it
    are attributed (and, armed, enforced + crash-enumerable).  The
    bench registers the journal dir and the pool's spool dir."""
    root = os.path.abspath(path)
    if root not in _watch:
        _watch.append(root)


def clear_watch_roots() -> None:
    _watch.clear()


def _watched(path) -> bool:
    if not _watch or not isinstance(path, str):
        return False
    p = os.path.abspath(path)
    for root in _watch:
        if p == root or p.startswith(root + os.sep):
            return True
    return False


def _durable(path) -> bool:
    """Path-role classifier, matching the static model: a ``.tmp``
    anywhere in the path — basename OR any ancestor component (files
    inside a ``snap_*.tmp`` staging directory are staging too) — is
    never committed and ignorable after a crash; anything else under a
    watched root is a durable role."""
    s = str(path).replace("\\", "/")
    return not any(".tmp" in part for part in s.split("/"))


def reset_counters() -> None:
    """Zero the counter tables and the op log (each bench run owns its
    window).  Watch roots survive: they describe the run's layout, not
    its history."""
    global _mutations
    with _mu:
        _protocols.clear()
        _ops.clear()
        _unattributed.clear()
        _op_log.clear()
        _mutations = 0


def counters() -> dict:
    """Snapshot: ``{"protocols": {tag: entries}, "ops": {tag: {op:
    n}}, "unattributed": {op: n}}``.  ``protocols`` is populated in
    every mode; the op tables only while the
    sanitizer is armed (the interposed surface is what observes
    individual ops)."""
    with _mu:
        return {
            "protocols": dict(sorted(_protocols.items())),
            "ops": {
                tag: dict(sorted(t.items()))
                for tag, t in sorted(_ops.items())
            },
            "unattributed": dict(sorted(_unattributed.items())),
        }


def op_log() -> list[tuple[str | None, str, str]]:
    """The armed run's ``(protocol, op, basename)`` sequence, bounded
    at ``_OP_LOG_CAP`` entries (tests assert orderings off it, e.g.
    fsync-before-replace in the spool protocol)."""
    with _mu:
        return list(_op_log)


def mutation_count() -> int:
    """Mutating ops observed on watched roots since the last reset —
    the crash-enumeration domain size."""
    with _mu:
        return _mutations


def _stack() -> list:
    s = getattr(_tls, "protocols", None)
    if s is None:
        s = _tls.protocols = []
    return s


@contextmanager
def fs_protocol(tag: str):
    """One declared durable-protocol entry: count it (always), and while
    inside, every interposed operation on a watched root is attributed
    to ``tag`` (innermost wins)."""
    with _mu:
        _protocols[tag] = _protocols.get(tag, 0) + 1
    stack = _stack()
    stack.append({"tag": tag, "ops": []})
    try:
        yield
    finally:
        stack.pop()


def durable_protocol(tag: str):
    """Decorator form of :func:`fs_protocol`."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with fs_protocol(tag):
                return fn(*args, **kwargs)

        run.__graft_protocol__ = tag
        return run

    return deco


@contextmanager
def crash_at(point: int):
    """Arm the sanitizer and kill the run at mutating-op boundary
    ``point`` (0-based): ops ``[0, point)`` execute, op ``point`` raises
    :class:`InjectedCrash` without executing, and everything after is a
    no-op until the context exits.  Resets the counters on entry so
    ``point`` indexes the same sequence a recording pass observed; puts
    the armed state back on exit."""
    global _crash_point, _crashed
    was = _armed
    arm()
    reset_counters()
    _crash_point = point
    _crashed = False
    try:
        yield
    finally:
        _crash_point = None
        _crashed = False
        if not was:
            disarm()


# ---------------------------------------------------------------------------
# the interposed surface
# ---------------------------------------------------------------------------


def _observe(op: str, path, durable_hint: bool | None = None) -> bool:
    """Record one fs op.  Returns False when the op must NOT execute
    (frozen post-crash).  Raises :class:`InjectedCrash` at the armed
    crash boundary and :class:`DurableOrderingError` on an ordering
    violation."""
    global _mutations, _crashed
    if not _armed:
        return True
    watched = _watched(path) if path is not None else bool(_stack())
    if not watched:
        return True
    durable = _durable(path) if durable_hint is None else durable_hint
    mutating = op in MUTATING_OPS
    if mutating and _crashed:
        return False  # the process is dead: nothing lands on disk
    stack = _stack()
    entry = stack[-1] if stack else None
    tag = entry["tag"] if entry else None
    if mutating:
        with _mu:
            idx = _mutations
            _mutations += 1
        if _crash_point is not None and idx == _crash_point:
            _crashed = True
            raise InjectedCrash(
                f"injected crash before fs op #{idx} "
                f"({op} {os.path.basename(str(path))!r}, "
                f"protocol {tag or 'unattributed'})"
            )
    if op in DESTRUCTIVE_OPS and durable and entry is not None \
            and not _crashed:
        # destruction of a durable copy must be dominated by
        # the committed install of its replacement — or by a read of
        # the committed record (completing a torn pass)
        ok = any(
            (o in COMMIT_OPS and dur) or o == "read"
            for o, dur in entry["ops"]
        )
        if not ok:
            raise DurableOrderingError(
                f"{op} of durable `{os.path.basename(str(path))}` "
                f"inside protocol `{tag}` before any committed install "
                "(os.replace/os.rename to a durable target) or read of "
                "the committed record — a crash here loses the only "
                f"copy; install the replacement first"
            )
    with _mu:
        if tag is not None:
            t = _ops.setdefault(tag, {})
            t[op] = t.get(op, 0) + 1
        elif mutating:
            _unattributed[op] = _unattributed.get(op, 0) + 1
        if len(_op_log) < _OP_LOG_CAP:
            _op_log.append(
                (tag, op, os.path.basename(str(path)) if path else "")
            )
    if entry is not None:
        entry["ops"].append((op, durable))
    return True


#: The functions replaced by :func:`_install`: (module, name) -> the one
#: in place before, which the hook calls through.
_prev: dict[tuple[object, str], object] = {}


def _call(mod, name):
    return _prev.get((mod, name)) or getattr(mod, name)


def _fs_open(file, mode="r", *args, **kwargs):
    orig = _call(builtins, "open")
    if _armed:
        try:
            path = os.fspath(file)
        except TypeError:
            path = None  # raw fd / file-like: out of model
        if isinstance(path, str) and _watched(path):
            if any(c in mode for c in "wx"):
                op = "write"
            elif "a" in mode:
                op = "append"
            elif "+" in mode:
                op = "update"  # r+: in-place edit (torn-tail truncate)
            else:
                op = "read"
            if not _observe(op, path):
                # frozen: give the unwinding caller a harmless sink so
                # cleanup code cannot touch the crash window
                return orig(os.devnull, mode.replace("x", "w"),
                            *args, **kwargs)
    return orig(file, mode, *args, **kwargs)


def _fs_replace(src, dst, *args, **kwargs):
    if _observe("replace", dst):
        return _call(os, "replace")(src, dst, *args, **kwargs)


def _fs_rename(src, dst, *args, **kwargs):
    if _observe("rename", dst):
        return _call(os, "rename")(src, dst, *args, **kwargs)


def _fs_link(src, dst, *args, **kwargs):
    if _observe("link", dst):
        return _call(os, "link")(src, dst, *args, **kwargs)


def _fs_unlink(path, *args, **kwargs):
    if _observe("unlink", path):
        return _call(os, "unlink")(path, *args, **kwargs)


def _fs_remove(path, *args, **kwargs):
    if _observe("unlink", path):  # the same syscall, both spellings
        return _call(os, "remove")(path, *args, **kwargs)


def _fs_fsync(fd):
    # fd-keyed: no path to watch-filter, so attribution rides the
    # active protocol entry; never a crash boundary (a crash "before the
    # fsync" is one before the next mutating op, already enumerated)
    if _armed and _stack():
        _observe("fsync", None)
    return _call(os, "fsync")(fd)


def _fs_rmtree(path, *args, **kwargs):
    if _observe("rmtree", path):
        return _call(shutil, "rmtree")(path, *args, **kwargs)


_HOOKS = (
    (builtins, "open", _fs_open),
    (os, "replace", _fs_replace),
    (os, "rename", _fs_rename),
    (os, "link", _fs_link),
    (os, "unlink", _fs_unlink),
    (os, "remove", _fs_remove),
    (os, "fsync", _fs_fsync),
    (shutil, "rmtree", _fs_rmtree),
)


def _install() -> None:
    if _prev:
        return
    for mod, name, hook in _HOOKS:
        _prev[(mod, name)] = getattr(mod, name)
        setattr(mod, name, hook)


def _uninstall() -> None:
    """Put back each replaced function whose hook is still in place."""
    for mod, name, hook in _HOOKS:
        orig = _prev.get((mod, name))
        if orig is not None and getattr(mod, name) is hook:
            setattr(mod, name, orig)
    _prev.clear()
