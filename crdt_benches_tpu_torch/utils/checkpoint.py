"""Checkpoint files of every engine state (a replay stopped after any
batch resumes bit-exactly; the serving fleet's eviction spool holds
``PackedState`` rows), byte-compatible with the JAX package's
``utils/checkpoint.py``.

Format: one ``.npz`` with one array per state field plus ``__class__``
(the state's class name), ``__fields__`` (field order), ``__dtypes__``
and ``__crcs__`` (a CRC32 of every array's bytes).  A checkpoint written by
either package loads in the other, for each of ``DocState``,
``DownState``, ``ReplayState``, ``PackedState``, ``PackedState4`` and
``DownPacked``.  ``PackedState4.cv_intile`` is int16 in the port and
bfloat16 in the JAX package (its values are at most 128, exact in both):
the file holds it as JAX does, the bfloat16 bits as uint16 with dtype
``bfloat16`` in the manifest, converted exactly through
``torch.bfloat16`` views both ways.

- **atomic write**: :func:`save_state` writes to a temp file in the same
  directory and ``os.replace``-s it over the target, so an interrupted
  write never leaves a torn file and every write lands on a new inode
  (a snapshot barrier hard-links spool files, so an in-place rewrite
  would change a committed snapshot).  ``durable=True`` also fsyncs the
  file before the rename and the directory after it;
- **verified read**: :func:`load_state` checks every array against the
  CRC manifest and raises :class:`CorruptCheckpointError` on any damage
  (``verify=False`` skips the check).  Checkpoints without ``__crcs__``
  load unverified.
"""

from __future__ import annotations

import os
import tempfile
import zlib

import numpy as np
import torch

from ..engine.downstream import DownPacked, DownState
from ..lint.fs_sanitizer import fs_protocol
from ..ops.apply import DocState
from ..ops.apply2 import PackedState, PackedState4, ReplayState
from .fsdur import fsync_dir, fsync_file  # noqa: F401  (re-exported for
# serve/journal.py, beside save_state and load_state)

_CLASSES = {
    "DocState": DocState,
    "DownState": DownState,
    "ReplayState": ReplayState,
    "PackedState": PackedState,
    "PackedState4": PackedState4,
    "DownPacked": DownPacked,
}
#: (state class, field) held as bfloat16 in the file and int16 here.
_BF16_FIELDS = {("PackedState4", "cv_intile")}


def _int16_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """int16 values -> the uint16 bits of the same values in bfloat16;
    raises unless every value is exact in bfloat16."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int16))
    b = t.to(torch.bfloat16)
    if not torch.equal(b.to(torch.int16), t):
        raise ValueError("values not exact in bfloat16")
    return b.view(torch.int16).numpy().view(np.uint16)


def _bf16_bits_to_int16(a: np.ndarray) -> np.ndarray:
    """uint16 bits of bfloat16 values -> int16; raises unless every value
    is an integer in the int16 range."""
    b = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
    f = b.view(torch.bfloat16).to(torch.float32)
    i = f.to(torch.int16)
    if not torch.equal(i.to(torch.float32), f):
        raise ValueError("bfloat16 values are not int16 integers")
    return i.numpy()


class CorruptCheckpointError(ValueError):
    """A checkpoint failed integrity verification: torn/truncated file,
    CRC mismatch, or an undecodable archive."""


def save_state(path: str, state, compress: bool = True,
               durable: bool = False) -> None:
    """Persist a state of one of the six classes (numpy arrays or tensors
    on any device).  ``compress=False`` skips zlib (``np.savez``), as the
    eviction spool does; :func:`load_state` reads both forms.
    ``durable=True`` fsyncs the written file before the rename and the
    directory after it (snapshot members); the default leaves flushing
    to the OS (eviction spools: the journal's replay rebuilds them)."""
    cls = type(state).__name__
    if cls not in _CLASSES:
        raise TypeError(f"unsupported state type {cls}")
    arrays = {}
    dtypes = []
    crcs = []
    for f in state._fields:
        a = getattr(state, f)
        if hasattr(a, "detach"):  # a torch tensor
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        if (cls, f) in _BF16_FIELDS:
            dtypes.append("bfloat16")
            a = _int16_to_bf16_bits(a)
        else:
            dtypes.append(str(a.dtype))
        arrays[f] = a
        crcs.append(zlib.crc32(np.ascontiguousarray(a).tobytes()))
    saver = np.savez_compressed if compress else np.savez
    d = os.path.dirname(os.path.abspath(path)) or "."
    with fs_protocol("spool"):
        fd, tmp = tempfile.mkstemp(
            dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp"
        )
        try:
            # a file object: np.savez would append ".npz" to a str path
            with os.fdopen(fd, "wb") as fh:
                saver(
                    fh,
                    __class__=np.asarray(cls),
                    __fields__=np.asarray(state._fields),
                    __dtypes__=np.asarray(dtypes),
                    __crcs__=np.asarray(crcs, np.uint64),
                    **arrays,
                )
                if durable:
                    fh.flush()
                    os.fsync(fh.fileno())
            os.replace(tmp, path)
            if durable:
                fsync_dir(d)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def load_state(path: str, verify: bool = True):
    """Restore a state saved by :func:`save_state` in either package (numpy
    arrays; a bfloat16 field as int16).  Every array is checked against the
    CRC manifest unless ``verify`` is False; damage raises
    :class:`CorruptCheckpointError`."""
    try:
        with fs_protocol("spool"):
            z = np.load(path)
    except Exception as e:  # BadZipFile / OSError / EOFError / ValueError
        raise CorruptCheckpointError(
            f"checkpoint {path!r}: unreadable ({type(e).__name__}: {e})"
        ) from e
    with z:
        try:
            name = str(z["__class__"])
            if name not in _CLASSES:
                raise CorruptCheckpointError(
                    f"checkpoint {path!r}: state type {name!r} is not one "
                    f"this package reads ({sorted(_CLASSES)})"
                )
            cls = _CLASSES[name]
            fields = [str(f) for f in z["__fields__"]]
            dtypes = ([str(d) for d in z["__dtypes__"]]
                      if "__dtypes__" in z else [""] * len(fields))
            crcs = z["__crcs__"] if "__crcs__" in z else None
            out = {}
            for i, (f, d) in enumerate(zip(fields, dtypes)):
                a = z[f]
                if verify and crcs is not None:
                    got = zlib.crc32(np.ascontiguousarray(a).tobytes())
                    if got != int(crcs[i]):
                        raise CorruptCheckpointError(
                            f"checkpoint {path!r}: field {f!r} CRC mismatch "
                            f"(stored {int(crcs[i]):#010x}, got {got:#010x})"
                        )
                if d == "bfloat16":
                    a = _bf16_bits_to_int16(a)
                elif a.dtype.kind == "V":
                    # np.savez dropped a bfloat16 dtype and no manifest
                    # names it: the values cannot be recovered
                    raise CorruptCheckpointError(
                        f"checkpoint field {f!r} has opaque dtype {a.dtype}"
                        " and no dtype manifest: re-create it with a "
                        "current save_state"
                    )
                out[f] = a
        except CorruptCheckpointError:
            raise
        except Exception as e:  # truncated zip member, missing key, ...
            raise CorruptCheckpointError(
                f"checkpoint {path!r}: damaged archive "
                f"({type(e).__name__}: {e})"
            ) from e
        return cls(**out)
