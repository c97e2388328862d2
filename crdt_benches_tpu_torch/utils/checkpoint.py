"""Checkpoint files of packed document rows (the serving fleet's eviction
spool), byte-compatible with the JAX package's ``utils/checkpoint.py``.

Format: one ``.npz`` with one array per state field plus ``__class__``
(the state's class name), ``__fields__`` (field order), ``__dtypes__``
and ``__crcs__`` (a CRC32 of every array's bytes).  A spool written by
either package loads in the other: the port reads and writes the
``PackedState`` (doc, length, nvis) the spool holds.

- **atomic write**: :func:`save_state` writes to a temp file in the same
  directory and ``os.replace``-s it over the target, so an interrupted
  write never leaves a torn file;
- **verified read**: :func:`load_state` checks every array against the
  CRC manifest and raises :class:`CorruptCheckpointError` on any damage.
  Checkpoints without ``__crcs__`` load unverified.
"""

from __future__ import annotations

import os
import tempfile
import zlib

import numpy as np

from ..ops.apply2 import PackedState

_CLASSES = {"PackedState": PackedState}


class CorruptCheckpointError(ValueError):
    """A checkpoint failed integrity verification: torn/truncated file,
    CRC mismatch, or an undecodable archive."""


def save_state(path: str, state, compress: bool = True) -> None:
    """Persist a ``PackedState`` (numpy arrays or tensors on any device).
    ``compress=False`` skips zlib (``np.savez``), as the eviction spool
    does; :func:`load_state` reads both forms."""
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
        dtypes.append(str(a.dtype))
        arrays[f] = a
        crcs.append(zlib.crc32(np.ascontiguousarray(a).tobytes()))
    saver = np.savez_compressed if compress else np.savez
    d = os.path.dirname(os.path.abspath(path)) or "."
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
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_state(path: str):
    """Restore a state saved by :func:`save_state` (numpy arrays).  Every
    array is checked against the CRC manifest; damage raises
    :class:`CorruptCheckpointError`."""
    try:
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
            crcs = z["__crcs__"] if "__crcs__" in z else None
            out = {}
            for i, f in enumerate(fields):
                a = z[f]
                if crcs is not None:
                    got = zlib.crc32(np.ascontiguousarray(a).tobytes())
                    if got != int(crcs[i]):
                        raise CorruptCheckpointError(
                            f"checkpoint {path!r}: field {f!r} CRC mismatch "
                            f"(stored {int(crcs[i]):#010x}, got {got:#010x})"
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
