"""Dump a trace as the flat binary file that ``native/bench_native``
replays (the JAX package's ``bench/dump_trace.py``): int64 header
(patches, start length, inserted chars), then pos, del_count, ins_off,
ins_flat and the start content as int32.

    python -m crdt_benches_tpu_torch.bench.dump_trace [trace] [out.bin]

The trace defaults to automerge-paper and the file to ``<trace>.bin`` in
the repository's ``build/`` directory.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..traces.loader import load_testing_data
from ..traces.patches import patch_arrays

#: ``build/`` at the repository root.
BUILD_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "build")
)


def dump(name: str, out_path: str | None = None) -> str:
    """Write trace ``name`` to ``out_path``; returns the path."""
    pa = patch_arrays(load_testing_data(name))
    if out_path is None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        out_path = os.path.join(
            BUILD_DIR, os.path.basename(name).removesuffix(".json.gz")
            + ".bin")
    with open(out_path, "wb") as f:
        np.asarray([pa.n_patches, len(pa.init), len(pa.ins_flat)],
                   np.int64).tofile(f)
        for a in (pa.pos, pa.del_count, pa.ins_off, pa.ins_flat, pa.init):
            a.tofile(f)
    return out_path


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "automerge-paper"
    print(dump(name, sys.argv[2] if len(sys.argv) > 2 else None))
