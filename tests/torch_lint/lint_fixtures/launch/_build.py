"""A kernel table for G009's twin (parsed, never imported)."""

import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64

SIGNATURES = {
    "crdt_good": [_P] * 2 + [_I] + [_P],
    "crdt_wide": [_P] + [_I, _U64] + [_P],
    "crdt_short": [_P] + [_I] + [_P],  # expect: G009
    "crdt_kind": [_P, _P, _P, _P],  # expect: G009
    "crdt_gone": [_P],  # expect: G009
}


def kernels():
    return None


def check(err, name):
    if err:
        raise RuntimeError(name)
