"""ctypes binding to the native C++ sequence CRDT (``native/crdt.cpp``,
built into ``native/libcrdtnative.so``): its whole-trace replay (the
single-core baseline of the replay ratio), its downstream update
generation and apply (the baseline of the downstream ratio), the replay
dump the range downstream's update generation anchors on, and the
concurrent-merge treap (:class:`NativeMerge`, the merges' independent
oracle)."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..traces.loader import TestData
from ..traces.patches import PatchArrays, patch_arrays

NATIVE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
LIB_PATH = os.path.join(NATIVE_DIR, "libcrdtnative.so")

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_vp = ctypes.c_void_p
_lib: ctypes.CDLL | None = None


def lib() -> ctypes.CDLL:
    """The native library, built with ``make -C native`` when missing.
    Raises OSError when it cannot be built or loaded."""
    global _lib
    if _lib is None:
        if not os.path.exists(LIB_PATH):
            done = subprocess.run(
                ["make", "-C", NATIVE_DIR, "libcrdtnative.so"],
                capture_output=True, text=True,
            )
            if done.returncode:
                raise OSError(f"make -C native failed:\n{done.stderr[-2000:]}")
        native = ctypes.CDLL(LIB_PATH)
        for fn, res, args in (
            (native.crdt_replay, _i64,
             [_i32p, _i64, _i32p, _i32p, _i32p, _i32p, _i64]),
            (native.crdt_new, _vp, [_i32p, _i64, ctypes.c_uint32]),
            (native.crdt_free, None, [_vp]),
            (native.crdt_len, _i64, [_vp]),
            (native.crdt_read, None, [_vp, _i32p]),
            (native.crdt_apply_updates, _i64, [_vp, _u8p, _i64p, _i64]),
            (native.crdt_gen_updates, _i64,
             [_i32p, _i64, _i32p, _i32p, _i32p, _i32p, _i64, _u8p, _i64,
              _i64p]),
            (native.crdt_integrate_ops, _i64,
             [_vp, _i64, _u8p, _u32p, _u32p, _u32p, _u32p, _i32p]),
            (native.crdt_replay_dump, _i64,
             [_i32p, _i64, _i32p, _i32p, _i32p, _i32p, _i64, _i32p, _i64,
              _u8p, _i32p, _i64]),
        ):
            fn.restype, fn.argtypes = res, args
        _lib = native
    return _lib


class CppCrdt:
    """Treap op-log sequence CRDT, whole-trace replay only."""

    @staticmethod
    def replay_patches(pa: PatchArrays) -> int:
        return lib().crdt_replay(
            pa.init, len(pa.init), pa.pos, pa.del_count, pa.ins_off,
            pa.ins_flat, pa.n_patches,
        )


class CppCrdtDownstream:
    """The native CRDT's downstream: one encoded update per patch,
    generated untimed on an upstream replica; the timed apply (fresh
    replica, every update, final length) is one native call."""

    #: bytes per op record (native/crdt.cpp OP_WIRE)
    OP_WIRE = 21

    def __init__(self, trace: TestData):
        pa = patch_arrays(trace)
        self._init = pa.init
        # one wire record per unit op (a deleted or an inserted char)
        cap = int(pa.del_count.sum() + len(pa.ins_flat)) * self.OP_WIRE
        self._offsets = np.zeros(pa.n_patches + 1, np.int64)
        buf = np.zeros(max(cap, 1), np.uint8)
        n = lib().crdt_gen_updates(
            pa.init, len(pa.init), pa.pos, pa.del_count, pa.ins_off,
            pa.ins_flat, pa.n_patches, buf, len(buf), self._offsets,
        )
        if n < 0:
            raise RuntimeError(f"update buffer undersized: need {-n}")
        self._flat = np.ascontiguousarray(buf[:n])

    def apply_all(self) -> int:
        """Fresh replica from the start content, every update applied;
        returns its length."""
        native = lib()
        h = native.crdt_new(self._init, len(self._init), 1)
        try:
            return native.crdt_apply_updates(
                h, self._flat, self._offsets, len(self._offsets) - 1
            )
        finally:
            native.crdt_free(h)


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        lib()
        return True
    except OSError:
        return False


def _codes(s: str) -> np.ndarray:
    return np.asarray([ord(c) for c in s], np.int32)


class NativeMerge:
    """Independent native RGA oracle for concurrent merge
    (``crdt_integrate_ops``): an order-statistic treap with the same
    (lamport, agent) id order and insert-after-origin rule as
    ``engine/merge.py``, in an entirely separate implementation.  Holds the
    merges at scales where the pure-Python oracle is infeasible."""

    def __init__(self, base: str, base_agent: int = 1_000_000):
        self.base = base
        self.base_agent = base_agent
        self._h = lib().crdt_new(_codes(base), len(base), base_agent)

    def integrate(self, type_, id_agent, id_seq, org_agent, org_seq,
                  ch) -> int:
        """Integrate struct-of-array ops (already (lamport, agent)-sorted,
        ids per :func:`engine.merge.to_native_ops`).  Returns the visible
        length."""
        return lib().crdt_integrate_ops(
            self._h, len(type_),
            np.ascontiguousarray(type_, np.uint8),
            np.ascontiguousarray(id_agent, np.uint32),
            np.ascontiguousarray(id_seq, np.uint32),
            np.ascontiguousarray(org_agent, np.uint32),
            np.ascontiguousarray(org_seq, np.uint32),
            np.ascontiguousarray(ch, np.int32),
        )

    def __len__(self) -> int:
        return lib().crdt_len(self._h)

    def content(self) -> str:
        out = np.zeros(len(self), np.int32)
        lib().crdt_read(self._h, out)
        return "".join(map(chr, out.tolist()))

    def close(self) -> None:
        if getattr(self, "_h", None):
            lib().crdt_free(self._h)
            self._h = None

    __del__ = close
