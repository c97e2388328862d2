"""Build and load the port's hand-written CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` (one process per
source, all started together, then one link) into
``build/torch_kernels/libcrdt_torch_kernels.so``, which is loaded with
``ctypes``: each kernel has a plain C entry taking device pointers, sizes
and the CUDA stream, and returning ``cudaGetLastError()`` after the
launch.  The library is rebuilt whenever the hash of the sources or the
flags changes.  Nothing builds or loads at import time; the first call to
:func:`kernels` does it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_NAME = "libcrdt_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points and their argument types (pointers and the stream are
#: c_void_p: a bare Python int would be passed as a 32-bit int).
SIGNATURES = {
    # kind, pos, rlen, slot0, v0, R, B, T,
    # ttype, ta, tch, tlen, dlo, dhi, dcount, nused, stream
    "crdt_resolve_range": [_P] * 5 + [_I] * 3 + [_P] * 8 + [_P],
    # doc, delpk, ind_d, dd, new_len, R, C, dsh,
    # doc_out, cv_intile, vis_tile, scratch, stream
    "crdt_range_apply": [_P] * 5 + [_I] * 3 + [_P] * 4 + [_P],
    # kind, pos, v0, R, B, T, emit_origin,
    # del_rank, ins_gvis, ins_seq, ins_alive, origin, del_batch, stream
    "crdt_resolve_unit": [_P] * 3 + [_I] * 4 + [_P] * 6 + [_P],
    # doc, combo, new_len, R, C, emit_cv, doc_out, cv_intile, vis_tile,
    # stream
    "crdt_unit_apply": [_P] * 3 + [_I] * 3 + [_P] * 3 + [_P],
    # doc, cntind, R, C, out, stream
    "crdt_expand_packed": [_P] * 2 + [_I] * 2 + [_P] + [_P],
    # order, vis, cnt, ind, R, C, order_out, vis_out, stream
    "crdt_expand_fill_zero": [_P] * 4 + [_I] * 2 + [_P] * 2 + [_P],
    # doc, combo, cnt_base, new_len, R, C, out, stream
    "crdt_apply_blocked": [_P] * 4 + [_I] * 2 + [_P] + [_P],
}

_lib: ctypes.CDLL | None = None
#: nvcc's output and the build seconds of the last build in this process
#: (empty when the cached library was current).
build_log: str = ""
build_seconds: float = 0.0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels build only on a machine with the CUDA toolkit"
        )
    return nvcc


def _digest(files: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def build() -> str:
    """Compile the kernels if the library is missing or stale; return its
    path.  Raises with nvcc's output when a source does not compile."""
    global build_log, build_seconds
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    lib = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, "sources.sha256")
    digest = _digest(sources + headers)
    if os.path.exists(lib) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == digest:
                return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = os.path.join(
            BUILD_DIR, os.path.basename(src).replace(".cu", ".o")
        )
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs = []
    failed = []
    for src, _obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode:
            failed.append(src)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(logs)
        )
    tmp = lib + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *[o for _, o, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    with open(stamp, "w") as fh:
        fh.write(digest + "\n")
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return lib


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.crdt_error_string.argtypes = [ctypes.c_int]
        lib.crdt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error for its launch."""
    if err:
        text = kernels().crdt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")
