"""ctypes bindings to the native C++ tier (``native/libcrdtnative.so``,
built from ``native/`` with ``make`` when missing): the host baselines of
the bench matrix, each a registered :class:`~.base.Upstream`, with a
one-call ``replay_patches`` so a timed iteration runs the hot loop natively
(per-op ctypes calls would measure the FFI, not the engine):

- ``CppRope`` / ``CppRopeBytes``: gap-buffer rope (``native/rope.cpp``),
  by codepoint or by UTF-8 byte;
- ``CppCola``: content-free, lengths-only sequence CRDT
  (``native/cola.cpp``), byte-addressed;
- ``CppCrdt`` / ``CppCrdtBytes``: treap op-log sequence CRDT
  (``native/crdt.cpp``) with incremental update encode and apply;
- ``CppCrdtDownstream``: its :class:`~.base.Downstream` form;
- :class:`NativeMerge`: its concurrent-merge treap, the merges'
  independent oracle.

The replay dump (``crdt_replay_dump``) that the range downstream's update
generation anchors on is bound here too.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..traces.loader import TestData
from ..traces.patches import PatchArrays, patch_arrays
from .base import Downstream, Upstream, register_downstream, register_upstream

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
        replay = [_i32p, _i64, _i32p, _i32p, _i32p, _i32p, _i64]
        for fn, res, args in (
            (native.rope_new, _vp, [_i32p, _i64]),
            (native.rope_free, None, [_vp]),
            (native.rope_len, _i64, [_vp]),
            (native.rope_insert, None, [_vp, _i64, _i32p, _i64]),
            (native.rope_remove, None, [_vp, _i64, _i64]),
            (native.rope_read, None, [_vp, _i32p]),
            (native.rope_replay, _i64, replay),
            (native.rope_replay_read, _i64, replay + [_i32p, _i64]),
            (native.crdt_replay, _i64, replay),
            (native.crdt_new, _vp, [_i32p, _i64, ctypes.c_uint32]),
            (native.crdt_free, None, [_vp]),
            (native.crdt_len, _i64, [_vp]),
            (native.crdt_oplog_len, _i64, [_vp]),
            (native.crdt_insert, None, [_vp, _i64, _i32p, _i64]),
            (native.crdt_remove, None, [_vp, _i64, _i64]),
            (native.crdt_read, None, [_vp, _i32p]),
            (native.crdt_encode_from, _i64, [_vp, _i64, _u8p, _i64]),
            (native.crdt_apply_update, None, [_vp, _u8p, _i64]),
            (native.crdt_apply_updates, _i64, [_vp, _u8p, _i64p, _i64]),
            (native.crdt_gen_updates, _i64, replay + [_u8p, _i64, _i64p]),
            (native.crdt_integrate_ops, _i64,
             [_vp, _i64, _u8p, _u32p, _u32p, _u32p, _u32p, _i32p]),
            (native.crdt_replay_dump, _i64,
             replay + [_i32p, _i64, _u8p, _i32p, _i64]),
            (native.cola_new, _vp, [_i64]),
            (native.cola_free, None, [_vp]),
            (native.cola_len, _i64, [_vp]),
            (native.cola_insert, None, [_vp, _i64, _i64]),
            (native.cola_remove, None, [_vp, _i64, _i64]),
            (native.cola_replay, _i64, [_i64, _i32p, _i32p, _i32p, _i64]),
        ):
            fn.restype, fn.argtypes = res, args
        _lib = native
    return _lib


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        lib()
        return True
    except OSError:
        return False


def _codes(s: str) -> np.ndarray:
    return np.asarray([ord(c) for c in s], np.int32)


def _utf8(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), np.uint8).astype(np.int32)


def _replay_read(pa: PatchArrays) -> np.ndarray:
    """The rope's final document elements after replaying ``pa``."""
    out = np.zeros(max(pa.end_len * 2 + 16, 64), np.int32)
    n = lib().rope_replay_read(
        pa.init, len(pa.init), pa.pos, pa.del_count, pa.ins_off,
        pa.ins_flat, pa.n_patches, out, len(out),
    )
    return out[:n]


class _Handle:
    """Owner of one native document handle, freed by ``free``."""

    _free = ""

    def __init__(self, handle):
        self._h = handle

    def close(self) -> None:
        if getattr(self, "_h", None):
            getattr(lib(), self._free)(self._h)
            self._h = None

    __del__ = close


@register_upstream
class CppRope(_Handle, Upstream):
    """Gap-buffer rope (``native/rope.cpp``), addressed by codepoint."""

    NAME = "cpp-rope"
    _free = "rope_free"

    @classmethod
    def from_str(cls, s: str) -> "CppRope":
        return cls(lib().rope_new(_codes(s), len(s)))

    def insert(self, at: int, text: str) -> None:
        lib().rope_insert(self._h, at, _codes(text), len(text))

    def remove(self, start: int, end: int) -> None:
        lib().rope_remove(self._h, start, end)

    def __len__(self) -> int:
        return lib().rope_len(self._h)

    def _elements(self) -> np.ndarray:
        out = np.zeros(len(self), np.int32)
        lib().rope_read(self._h, out)
        return out

    def content(self) -> str:
        return "".join(map(chr, self._elements().tolist()))

    @staticmethod
    def replay_patches(pa: PatchArrays) -> int:
        return lib().rope_replay(
            pa.init, len(pa.init), pa.pos, pa.del_count, pa.ins_off,
            pa.ins_flat, pa.n_patches,
        )

    @staticmethod
    def replay_patches_content(pa: PatchArrays) -> str:
        return "".join(map(chr, _replay_read(pa).tolist()))


@register_upstream
class CppRopeBytes(CppRope):
    """The rope addressed and fed in UTF-8 byte units (the reference's
    byte-offset adapters): ``trace.chars_to_bytes()`` and
    ``patch_arrays(..., bytes_mode=True)``; ``len`` is a byte count."""

    NAME = "cpp-rope-bytes"
    EDITS_USE_BYTE_OFFSETS = True

    @classmethod
    def from_str(cls, s: str) -> "CppRopeBytes":
        b = _utf8(s)
        return cls(lib().rope_new(b, len(b)))

    def insert(self, at: int, text: str) -> None:
        b = _utf8(text)
        lib().rope_insert(self._h, at, b, len(b))

    def content(self) -> str:
        return self._elements().astype(np.uint8).tobytes().decode("utf-8")

    @staticmethod
    def replay_patches_content(pa: PatchArrays) -> str:
        # the elements are UTF-8 bytes, not codepoints
        return _replay_read(pa).astype(np.uint8).tobytes().decode("utf-8")


@register_upstream
class CppCola(_Handle, Upstream):
    """Content-free (lengths-only) sequence-CRDT replica, the reference's
    cola adapter: seeded from a length, edited by (offset, length) pairs,
    read back only as ``len()``; no character crosses the FFI and
    ``content()`` stays None.  Byte-addressed.  Engine: ``native/cola.cpp``
    (a run-granular implicit treap with retained tombstones)."""

    NAME = "cpp-cola"
    EDITS_USE_BYTE_OFFSETS = True
    _free = "cola_free"

    @classmethod
    def from_str(cls, s: str) -> "CppCola":
        return cls(lib().cola_new(len(s.encode("utf-8"))))

    def insert(self, at: int, text: str) -> None:
        lib().cola_insert(self._h, at, len(text.encode("utf-8")))

    def remove(self, start: int, end: int) -> None:
        lib().cola_remove(self._h, start, end)

    def __len__(self) -> int:
        return lib().cola_len(self._h)

    @staticmethod
    def replay_patches(pa: PatchArrays) -> int:
        return lib().cola_replay(
            len(pa.init), pa.pos, pa.del_count, pa.ins_off, pa.n_patches
        )


@register_upstream
class CppCrdt(_Handle, Upstream):
    """Treap op-log sequence CRDT (``native/crdt.cpp``)."""

    NAME = "cpp-crdt"
    _free = "crdt_free"

    @classmethod
    def from_str(cls, s: str, agent: int = 1) -> "CppCrdt":
        return cls(lib().crdt_new(_codes(s), len(s), agent))

    def insert(self, at: int, text: str) -> None:
        lib().crdt_insert(self._h, at, _codes(text), len(text))

    def remove(self, start: int, end: int) -> None:
        lib().crdt_remove(self._h, start, end)

    def __len__(self) -> int:
        return lib().crdt_len(self._h)

    def _elements(self) -> np.ndarray:
        out = np.zeros(len(self), np.int32)
        lib().crdt_read(self._h, out)
        return out

    def content(self) -> str:
        return "".join(map(chr, self._elements().tolist()))

    def oplog_len(self) -> int:
        return lib().crdt_oplog_len(self._h)

    def encode_from(self, from_op: int) -> bytes:
        """The wire update of every op from ``from_op`` on."""
        buf = np.zeros(4096, np.uint8)
        n = lib().crdt_encode_from(self._h, from_op, buf, len(buf))
        if n < 0:  # -n is the size it needs
            buf = np.zeros(-n, np.uint8)
            n = lib().crdt_encode_from(self._h, from_op, buf, len(buf))
        return bytes(buf[:n].tobytes())

    def apply_update(self, update: bytes) -> None:
        arr = np.frombuffer(update, np.uint8)
        lib().crdt_apply_update(self._h, arr, len(arr))

    @staticmethod
    def replay_patches(pa: PatchArrays) -> int:
        return lib().crdt_replay(
            pa.init, len(pa.init), pa.pos, pa.del_count, pa.ins_off,
            pa.ins_flat, pa.n_patches,
        )


@register_upstream
class CppCrdtBytes(CppCrdt):
    """The treap CRDT addressed in UTF-8 byte units (the reference's yrs
    adapter): each element holds one byte, so ``len`` is a byte count."""

    NAME = "cpp-crdt-bytes"
    EDITS_USE_BYTE_OFFSETS = True

    @classmethod
    def from_str(cls, s: str, agent: int = 1) -> "CppCrdtBytes":
        b = _utf8(s)
        return cls(lib().crdt_new(b, len(b), agent))

    def insert(self, at: int, text: str) -> None:
        b = _utf8(text)
        lib().crdt_insert(self._h, at, b, len(b))

    def content(self) -> str:
        return self._elements().astype(np.uint8).tobytes().decode("utf-8")


@register_downstream
class CppCrdtDownstream(Downstream):
    """The native CRDT's downstream: one encoded update per patch,
    generated untimed on an upstream replica; the timed apply (fresh
    replica, every update, final length) is one native call."""

    NAME = "cpp-crdt"
    #: bytes per op record (native/crdt.cpp OP_WIRE)
    OP_WIRE = 21

    def __init__(self, start_content: str, flat: np.ndarray,
                 offsets: np.ndarray):
        self._start = start_content
        self._flat = flat
        self._offsets = offsets
        self._doc = CppCrdt.from_str(start_content, agent=1)

    @classmethod
    def upstream_updates(cls, trace: TestData):
        pa = patch_arrays(trace)
        # one wire record per unit op (a deleted or an inserted char)
        cap = int(pa.del_count.sum() + len(pa.ins_flat)) * cls.OP_WIRE
        offsets = np.zeros(pa.n_patches + 1, np.int64)
        buf = np.zeros(max(cap, 1), np.uint8)
        n = lib().crdt_gen_updates(
            pa.init, len(pa.init), pa.pos, pa.del_count, pa.ins_off,
            pa.ins_flat, pa.n_patches, buf, len(buf), offsets,
        )
        if n < 0:
            raise RuntimeError(f"update buffer undersized: need {-n}")
        inst = cls(trace.start_content, np.ascontiguousarray(buf[:n]),
                   offsets)
        updates = [bytes(buf[offsets[i]:offsets[i + 1]].tobytes())
                   for i in range(pa.n_patches)]
        return inst, updates

    def clone(self) -> "CppCrdtDownstream":
        return CppCrdtDownstream(self._start, self._flat, self._offsets)

    def apply_update(self, update: bytes) -> None:
        self._doc.apply_update(update)

    def apply_all_native(self) -> int:
        """The whole timed iteration in one native call: a fresh replica,
        every update applied, its length.  The fresh replica becomes this
        object's document."""
        doc = CppCrdt.from_str(self._start, agent=1)
        n = lib().crdt_apply_updates(
            doc._h, self._flat, self._offsets, len(self._offsets) - 1
        )
        self._doc = doc
        return n

    def __len__(self) -> int:
        return len(self._doc)

    def content(self) -> str:
        return self._doc.content()


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
