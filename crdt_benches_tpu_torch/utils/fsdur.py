"""Best-effort durability fsync helpers, in one place (the JAX package's
``utils/fsdur.py``).

An ``os.replace``/``os.rename`` commits a NAME; the bytes behind it
(and the directory entry pointing at it) are only durable once fsynced.
These helpers are the single shared implementation for every durable
commit path (checkpoint saves, WAL segment seals, GC manifests,
snapshot barriers): a future behavior change (O_DIRECTORY, EINTR retry,
error surfacing) lands once, not per-copy.

Stdlib-only on purpose: ``utils/checkpoint.py`` pulls the whole engine,
so it cannot be the shared home.

Best effort by contract: a filesystem that cannot open directories (or
rejects fsync on them) degrades to the pre-fix behavior, never to an
error.
"""

from __future__ import annotations

import os


def _fsync_path(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def fsync_file(path: str) -> None:
    """fsync an already-written FILE by path (snapshot barriers adopt
    hard-linked spool members whose hot-path writes skipped the
    per-eviction fsync — the barrier is where their contents must
    become durable, before the commit rename)."""
    _fsync_path(path)


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY: a rename is only durable once the directory
    entry itself is flushed — renaming into a never-synced directory
    can vanish with the page cache."""
    _fsync_path(path)
