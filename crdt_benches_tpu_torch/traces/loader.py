"""Editing-trace loading: gzipped-JSON traces in josephg's
``editing-traces`` format as ``TestData`` (start/end content, txns of
``(pos, del_count, ins)`` patches; ``len()`` is the patch count, the
throughput element count).

Positions and delete counts are in character (codepoint) units.  Pure
Python and the standard library.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple

#: The four reference workloads.
TRACES = (
    "automerge-paper",
    "rustcode",
    "sveltecomponent",
    "seph-blog1",
)

#: ``traces_data/`` at the repository root.
TRACE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "traces_data")
)


class TestPatch(NamedTuple):
    """One edit: replace ``del_count`` chars at ``pos`` with ``ins``."""

    pos: int
    del_count: int
    ins: str

    __test__ = False  # "Test*" name; keep pytest collection away


@dataclass
class TestTxn:
    __test__ = False
    time: str
    patches: list[TestPatch] = field(default_factory=list)


@dataclass
class TestData:
    __test__ = False
    start_content: str
    end_content: str
    txns: list[TestTxn]

    def __len__(self) -> int:
        """Total patch count — the throughput element count."""
        return sum(len(t.patches) for t in self.txns)

    def iter_patches(self) -> Iterator[TestPatch]:
        for txn in self.txns:
            yield from txn.patches


def trace_path(name: str, trace_dir: str | None = None) -> str:
    """Resolve a trace name (e.g. ``"sveltecomponent"``) to a .json.gz path
    under ``trace_dir`` (default: the repository's ``traces_data/``)."""
    if name.endswith(".json.gz"):
        if os.path.exists(name):
            return name
        raise FileNotFoundError(f"trace file {name!r} does not exist")
    d = trace_dir or TRACE_DIR
    p = os.path.join(d, f"{name}.json.gz")
    if os.path.exists(p):
        return os.path.normpath(p)
    raise FileNotFoundError(f"trace {name!r} not found in {d}")


def load_testing_data(
    path_or_name: str, trace_dir: str | None = None
) -> TestData:
    """Load a gzipped-JSON editing trace."""
    path = trace_path(path_or_name, trace_dir)
    with gzip.open(path, "rt", encoding="utf-8") as f:
        raw = json.load(f)
    try:
        txns = [
            TestTxn(
                time=t.get("time", ""),
                patches=[TestPatch(p[0], p[1], p[2]) for p in t["patches"]],
            )
            for t in raw["txns"]
        ]
        return TestData(
            start_content=raw["startContent"],
            end_content=raw["endContent"],
            txns=txns,
        )
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(
            f"{path}: not a valid editing-traces file "
            "(expected startContent/endContent/txns[].patches)"
        ) from e
