"""ctypes binding to the native C++ sequence CRDT (``native/crdt.cpp``,
built into ``native/libcrdtnative.so``) — only its whole-trace replay,
the single-core baseline of the headline ratio."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..traces.patches import PatchArrays

NATIVE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
LIB_PATH = os.path.join(NATIVE_DIR, "libcrdtnative.so")

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
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
        native.crdt_replay.restype = _i64
        native.crdt_replay.argtypes = [
            _i32p, _i64, _i32p, _i32p, _i32p, _i32p, _i64
        ]
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
