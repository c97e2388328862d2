"""Runtime value-range sanitizer (the JAX package's
``lint/range_sanitizer.py``), and the bounds oracle behind the dtype-edge
harness (``serve/edgecheck.py``).

An out-of-range index handed to a gather or a scatter, or a narrow uint16
lane that wraps, corrupts bytes without a fault.  Every declared index
check routes through :func:`check_index` (keyed by its check name, JAX's)
and counts its dispatches: always, in every mode, one lock-guarded dict
increment a staged macro.  Likewise :func:`check_narrow` a narrow lane,
:func:`check_no_pad` a sentinel-free lane and :func:`note_mask` a declared
clamp-mask region.  These counters are the serve report's ``ranges``
block.

Armed (:func:`arm`, the serve bench's ``sanitize=("ranges",)`` or the
edge harness; options are arguments, never environment variables), the
bounds are enforced on the staged host arrays before the dispatch (they
are numpy there already, so checking costs no device sync): an index
outside ``[lo, bound)`` raises :class:`IndexOutOfBoundsError`, a narrow
lane past its ceiling :class:`NarrowOverflowError`, a PAD value on a
sentinel-free lane :class:`PadLeakError`, each at the callsite with the
doc, class and round.

Disarmed, nothing is validated (a lazy operand is never evaluated): the
only cost is the counter bump.
"""

from __future__ import annotations

import threading

import numpy as np

#: The armed-surface vocabulary for the ``ranges`` artifact block:
#: ``staging`` is armed on every drain, ``fused``/``scan`` name the serve
#: kernel the run dispatched (the static G026/G029 surfaces).
KNOWN_SURFACES = ("staging", "fused", "scan")


class RangeSanitizerError(RuntimeError):
    """Base class for every armed value-range violation."""


class IndexOutOfBoundsError(RangeSanitizerError):
    """A staged index operand outside its declared ``[lo, bound)``
    range — the value a gather or scatter would read or write
    in the wrong place instead of faulting."""


class NarrowOverflowError(RangeSanitizerError):
    """A staged narrow-lane value past its dtype headroom — the value
    a uint16/int8 repack would wrap into an aliased slot id."""


class PadLeakError(RangeSanitizerError):
    """A PAD/sentinel value on a lane declared sentinel-free — the
    sentinel escaped its mask and is about to enter arithmetic."""


#: Checks fire from whatever thread stages the macro (the prefetch
#: worker stages off-thread), so the counter tables take a real mutex
#: — same reasoning as lifecycle_sanitizer._mu.
_mu = threading.Lock()
_checks: dict[str, int] = {}  # check name -> staged-dispatch count
_masks: dict[str, int] = {}  # mask tag -> masked-region dispatch count

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
    """Zero the counter tables (each bench run owns its window)."""
    with _mu:
        _checks.clear()
        _masks.clear()


def _where(doc=None, cls=None, rnd=None) -> str:
    parts = []
    if doc is not None:
        parts.append(f"doc={doc}")
    if cls is not None:
        parts.append(f"class={cls}")
    if rnd is not None:
        parts.append(f"round={rnd}")
    return f" [{', '.join(parts)}]" if parts else ""


def check_index(name: str, arr, bound, *, lo: int = 0,
                doc=None, cls=None, rnd=None) -> None:
    """One staged index-operand validation.  Counted in EVERY mode
    under ``name`` (the ``ranges`` block, JAX's check names); armed,
    every element of ``arr`` must lie in ``[lo, bound)`` or the
    out-of-range value is a typed error at the callsite — BEFORE
    dispatch, while the tensor is still host-side numpy (zero device
    syncs).

    ``arr`` may be a zero-arg callable (e.g. a lambda masking out PAD
    lanes) — it is only evaluated when armed, so the disarmed cost
    stays exactly one counter bump."""
    with _mu:
        _checks[name] = _checks.get(name, 0) + 1
    if not _armed:
        return
    # the staged lanes are host numpy ALREADY (pre-dispatch staging
    # boundary): this asarray is a no-copy view, never a device sync
    a = np.asarray(arr() if callable(arr) else arr)
    if a.size == 0:
        return
    amin = int(a.min())
    amax = int(a.max())
    b = int(bound)
    if amin < lo or amax >= b:
        bad = amin if amin < lo else amax
        raise IndexOutOfBoundsError(
            f"index check `{name}`: value {bad} outside [{lo}, {b}) "
            f"on the staged host tensor{_where(doc, cls, rnd)} — a gather "
            f"or scatter would take it silently"
        )


def check_narrow(name: str, arr, bound, *,
                 doc=None, cls=None, rnd=None) -> None:
    """One narrow-lane headroom validation.  Counted in EVERY mode;
    armed, every element must fit ``[0, bound]`` — the ceiling a
    narrow (uint16/int8) repack of this lane can carry losslessly.  A
    value past it is the silent-wrap corruption ``pack_ops`` exists to
    refuse, caught even on paths that skip the pack (the same-dtype
    passthrough)."""
    with _mu:
        _checks[name] = _checks.get(name, 0) + 1
    if not _armed:
        return
    # host numpy already, same as check_index
    a = np.asarray(arr() if callable(arr) else arr)
    if a.size == 0:
        return
    amin = int(a.min())
    amax = int(a.max())
    b = int(bound)
    if amin < 0 or amax > b:
        bad = amin if amin < 0 else amax
        raise NarrowOverflowError(
            f"narrow lane `{name}`: value {bad} outside [0, {b}] "
            f"headroom{_where(doc, cls, rnd)} — a narrow repack would "
            f"wrap it into an aliased id"
        )


def check_no_pad(name: str, arr, pad, *,
                 doc=None, cls=None, rnd=None) -> None:
    """One sentinel-free-lane validation.  Counted in EVERY mode;
    armed, no element may equal the ``pad`` sentinel — a surviving
    sentinel here escaped its mask and is headed into arithmetic."""
    with _mu:
        _checks[name] = _checks.get(name, 0) + 1
    if not _armed:
        return
    a = np.asarray(arr() if callable(arr) else arr)
    if a.size and bool((a == pad).any()):
        raise PadLeakError(
            f"lane `{name}`: PAD/sentinel value {pad} present on a "
            f"lane declared sentinel-free{_where(doc, cls, rnd)} — "
            f"the mask upstream leaked it"
        )


def note_mask(tag: str, n: int = 1) -> None:
    """One dispatch through a declared clamp-mask region (the
    JAX's mask tags).  Counted in EVERY mode: the ``ranges`` block's
    ``masks``."""
    with _mu:
        _masks[tag] = _masks.get(tag, 0) + n


def counters() -> dict:
    """Snapshot: ``{"checks": {name: n}, "masks": {tag: n}}`` —
    populated in every mode."""
    with _mu:
        return {
            "checks": dict(sorted(_checks.items())),
            "masks": dict(sorted(_masks.items())),
        }
