"""Runtime sync sanitizer (the JAX package's ``lint/sanitizer.py``).

A fence is a function allowed to make the host wait for the device (a
bucket pull, the drain's final fence, a barrier).  Every fence routes
through :func:`fence` (usually the :func:`fenced` decorator, keyed by the
function's ``__qualname__`` so the counter names equal JAX's) and counts
its **entries**: always, in every mode, one dict increment a crossing.

Armed (:func:`arm`, the serve bench's ``sanitize=("syncs",)``; options are
arguments, never environment variables), :func:`hot_path` (around
``FleetScheduler.run_round``) interposes the host-sync surface of
``torch.Tensor`` — ``item``, ``tolist``, ``__array__``, ``numpy``,
``cpu``, ``__bool__``, ``__int__``, ``__float__``, ``__index__`` — and
``torch.cuda.synchronize``.  Such a call on a tensor of the hot path's
device outside every fence raises :class:`UndeclaredSyncError` at its
callsite; inside a fence it counts against the innermost fence (the
per-fence **syncs**, the port's own count).  On the CPU every tensor is on
the hot path's device, so host staging stays in numpy, as in JAX, and the
kernels' plain versions (:func:`kernel_body`) stand for the kernels.

On a CUDA hot path the armed sanitizer adds a second tripwire, JAX's
``transfer_guard_device_to_host("disallow")``:
``torch.cuda.set_sync_debug_mode("error")`` inside the hot path, put back
to ``"default"`` inside a fence.  It catches the syncs no Python hook sees
(``nonzero``, boolean-mask indexing, a blocking copy either way).  The
mode is process-wide, not per thread: arm it only where the drain thread
alone issues CUDA work (every serve family of the port: the prefetcher,
the ingest front and the status server touch numpy and sockets only).

:func:`disarm` puts back every attribute it replaced; the hot path puts
the debug mode back when it exits, also when the round raises.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

#: The host-sync surface interposed on ``torch.Tensor``.
_SYNC_SURFACE = (
    "item", "tolist", "__array__", "numpy", "cpu",
    "__bool__", "__int__", "__float__", "__index__",
)

_MISSING = object()


class UndeclaredSyncError(RuntimeError):
    """A host sync on the serving hot path outside every declared fence."""


_tls = threading.local()
_entries: dict[str, int] = {}
_syncs: dict[str, int] = {}
#: Fence-entry observers (``obs/trace.py`` plants one while spans are
#: armed, so every crossing lands on the timeline).  Empty otherwise.
_fence_observers: list = []

_armed = False
#: Attributes replaced while armed: name -> the original (or _MISSING when
#: ``torch.Tensor`` inherited it), plus the module's ``synchronize``.
_saved: dict[str, object] = {}
_saved_sync = None
#: The device type ("cuda" or "cpu") of the latest hot path; a sync counts
#: only on a tensor of this type (inside a fence, also after the hot path
#: exited, as JAX's counts do).
_hot_type: str | None = None


def add_fence_observer(cb) -> None:
    """Register ``cb(qualname)`` to run at every fence entry."""
    if cb not in _fence_observers:
        _fence_observers.append(cb)


def remove_fence_observer(cb) -> None:
    if cb in _fence_observers:
        _fence_observers.remove(cb)


def armed() -> bool:
    return _armed


def arm() -> None:
    """Arm the sanitizer: the hooks go on now, the hot path checks from
    its next entry."""
    global _armed
    _install()
    _armed = True


def disarm() -> None:
    """Disarm and put back every replaced attribute."""
    global _armed, _hot_type
    _armed = False
    _hot_type = None
    _uninstall()


def _fence_stack() -> list:
    s = getattr(_tls, "fences", None)
    if s is None:
        s = _tls.fences = []
    return s


def _hot_depth() -> int:
    return getattr(_tls, "hot", 0)


def reset_counters() -> None:
    """Zero both counter tables (each bench run owns its window)."""
    _entries.clear()
    _syncs.clear()


def counters() -> dict[str, dict[str, int]]:
    """``{"entries": {fence: n}, "syncs": {fence: n}}``; ``syncs`` fills
    only while armed."""
    return {
        "entries": dict(sorted(_entries.items())),
        "syncs": dict(sorted(_syncs.items())),
    }


def entries_total() -> int:
    """The sum of the fence-entry counters (the time-series sample)."""
    return sum(_entries.values())


def _note_sync(label: str) -> None:
    stack = _fence_stack()
    if stack:
        _syncs[stack[-1]] = _syncs.get(stack[-1], 0) + 1
        return
    if _hot_depth() > 0:
        raise UndeclaredSyncError(
            f"undeclared host sync `{label}` on the serving hot path "
            "(sync sanitizer armed): no fence is active here — move the "
            "sync behind a declared fence"
        )


def _counts(t) -> bool:
    """Whether a call on tensor ``t`` is a sync to attribute: the
    sanitizer is armed, this is the outermost hooked call of the thread,
    and ``t`` lies on the hot path's device type."""
    return (_armed and _hot_type is not None
            and not getattr(_tls, "inside", False)
            and t.device.type == _hot_type)


def _wrap(orig, label):
    def hooked(self, *args, **kwargs):
        if _counts(self):
            _note_sync(label)
            _tls.inside = True
            try:
                return orig(self, *args, **kwargs)
            finally:
                _tls.inside = False
        return orig(self, *args, **kwargs)

    hooked.__name__ = label
    hooked.__graft_sanitizer__ = True
    return hooked


def _install() -> None:
    global _saved_sync
    import torch

    if _saved:
        return
    for name in _SYNC_SURFACE:
        orig = getattr(torch.Tensor, name)
        _saved[name] = torch.Tensor.__dict__.get(name, _MISSING)
        setattr(torch.Tensor, name, _wrap(orig, name))
    _saved_sync = torch.cuda.synchronize
    orig_sync = _saved_sync

    def synchronize(device=None):
        if _armed and _hot_type == "cuda" and not getattr(
                _tls, "inside", False):
            _note_sync("torch.cuda.synchronize")
        return orig_sync(device)

    synchronize.__graft_sanitizer__ = True
    torch.cuda.synchronize = synchronize


def _uninstall() -> None:
    global _saved_sync
    import torch

    for name, orig in _saved.items():
        if orig is _MISSING:
            if name in torch.Tensor.__dict__:
                delattr(torch.Tensor, name)
        else:
            setattr(torch.Tensor, name, orig)
    _saved.clear()
    if _saved_sync is not None:
        torch.cuda.synchronize = _saved_sync
        _saved_sync = None


def _set_debug_mode(mode: str) -> None:
    import torch

    torch.cuda.set_sync_debug_mode(mode)


@contextmanager
def hot_path(device=None):
    """One hot-path scope on ``device`` (a ``torch.device`` or its type
    name).  A no-op unless armed; armed, a sync outside a fence raises
    and, on a CUDA device, the sync debug mode is ``"error"`` for the
    scope."""
    global _hot_type
    if not _armed:
        yield
        return
    dev_type = getattr(device, "type", device) or "cpu"
    outer = _hot_depth() == 0
    native = dev_type == "cuda"
    _tls.hot = _hot_depth() + 1
    _hot_type = dev_type
    if native and outer:
        _set_debug_mode("error")
    try:
        yield
    finally:
        _tls.hot -= 1
        if native and outer:
            _set_debug_mode("default")


@contextmanager
def fence(name: str):
    """One declared-boundary crossing: count the entry, allow (and
    attribute) the host syncs within."""
    _entries[name] = _entries.get(name, 0) + 1
    if _fence_observers:
        for cb in _fence_observers:
            cb(name)
    stack = _fence_stack()
    # the outermost fence of a hot scope lifts the native tripwire
    native = (_armed and _hot_type == "cuda" and _hot_depth() > 0
              and not stack)
    stack.append(name)
    if native:
        _set_debug_mode("default")
    try:
        yield
    finally:
        stack.pop()
        if native:
            _set_debug_mode("error")


def kernel_body(fn):
    """Mark a kernel's plain version.  Its wrapper runs it only for a CPU
    tensor, in the calling thread, where it stands for the kernel: what
    it reads of its own tensors is the kernel's work, not a host sync of
    the hot path, so the surface is quiet inside it.  On a CUDA tensor the
    wrapper launches the kernel and this body never runs."""

    @functools.wraps(fn)
    def body(*args, **kwargs):
        if not _armed or getattr(_tls, "inside", False):
            return fn(*args, **kwargs)
        _tls.inside = True
        try:
            return fn(*args, **kwargs)
        finally:
            _tls.inside = False

    return body


def fenced(fn):
    """Decorator form of :func:`fence`, keyed by ``__qualname__``."""
    name = fn.__qualname__

    @functools.wraps(fn)
    def crossing(*args, **kwargs):
        with fence(name):
            return fn(*args, **kwargs)

    crossing.__graft_fence__ = name
    return crossing
