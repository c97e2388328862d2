"""Narrow-dtype packing for staged serve op tensors (a numpy copy of the
JAX package's ``ops/packing.py``).

A macro dispatch stages ``(K, Rt, B)`` op tensors per capacity class —
four int32 arrays (kind / pos / rlen / slot0) that exist only to carry
small integers from the host planner to the device step.  Their value
ranges are bounded by STATIC engine facts, not by data:

- ``kind`` is one of the three op codes (PAD / INSERT / DELETE) — int8;
- ``pos`` is a position in visible space, < the pool's largest capacity
  class;
- ``rlen`` is a run length, <= the document length, < the largest class;
- ``slot0`` is a slot id, < the largest class (the id space is per-doc).

With the default class ladder (largest class 49152) all three fit
uint16, halving the staged bytes and the host->device transfer of every
macro round.  Pools whose largest class exceeds the uint16 range fall
back to int32 lanes — the engine guard caps classes at 2^22, so int32
always fits.  The dtype choice is a SINGLE static function of the
pool's largest class (not per-class, not per-batch): every class stages
the same lane dtypes, so the shared resolve executable compiles once
for the whole fleet and a quiet round cannot flip dtypes mid-run.
The port stages in these dtypes too and widens to int32 on the host just
before the upload (``serve/pool.py``).

Packing is checked, not truncating: values outside the target lane's
range raise ``OpRangeError`` instead of wrapping, so a future id-space
bump past the uint16 ceiling surfaces as a loud staging error, never as
a silently corrupted slot id.  ``widen_ops`` widens back to int32.
"""

from __future__ import annotations

import numpy as np

#: The packed lane layouts, keyed by whether the pool's id space fits
#: uint16.  ``kind`` is always int8 (three op codes).
NARROW_DTYPES = (np.int8, np.uint16, np.uint16, np.uint16)
WIDE_DTYPES = (np.int8, np.int32, np.int32, np.int32)

#: Largest id-space bound the narrow (uint16) lanes can carry
#: (== np.iinfo(np.uint16).max).
NARROW_ID_BOUND = 65535


class OpRangeError(ValueError):
    """A staged op value does not fit its packed lane dtype."""


def op_lane_dtypes(max_class: int) -> tuple[np.dtype, ...]:
    """The (kind, pos, rlen, slot0) lane dtypes for a pool whose largest
    capacity class is ``max_class``.  Static per pool: every class and
    every round stages the same dtypes."""
    if max_class <= NARROW_ID_BOUND:
        return tuple(np.dtype(d) for d in NARROW_DTYPES)
    return tuple(np.dtype(d) for d in WIDE_DTYPES)


def _check_range(name: str, a: np.ndarray, dt: np.dtype) -> None:
    info = np.iinfo(dt)
    if a.size == 0:
        return
    lo = int(a.min())
    hi = int(a.max())
    if lo < info.min or hi > info.max:
        raise OpRangeError(
            f"op lane {name!r}: values [{lo}, {hi}] do not fit {dt}"
            f" [{info.min}, {info.max}]; widen the lane dtypes"
            " (op_lane_dtypes) before staging"
        )


def pack_ops(kind, pos, rlen, slot0, max_class: int):
    """Pack four host op arrays into the narrow lane dtypes for
    ``max_class``.  Lossless by construction: any out-of-range value
    raises ``OpRangeError`` (never wraps).  Arrays already in the
    target dtype pass through without a copy."""
    dts = op_lane_dtypes(max_class)
    out = []
    for name, a, dt in zip(
        ("kind", "pos", "rlen", "slot0"), (kind, pos, rlen, slot0), dts
    ):
        a = np.asarray(a)
        if a.dtype == dt:
            out.append(a)
            continue
        _check_range(name, a, dt)
        out.append(a.astype(dt))
    return tuple(out)


def widen_ops(kind, pos, rlen, slot0):
    """Widen packed op lanes back to int32 (numpy arrays).  The inverse
    of :func:`pack_ops` for all in-range values — the round-trip is
    exact because pack_ops refuses anything that will not fit."""
    return tuple(a.astype(np.int32) for a in (kind, pos, rlen, slot0))
