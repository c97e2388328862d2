"""Editing-trace loading: gzipped-JSON traces in josephg's
``editing-traces`` format as ``TestData`` (start/end content, txns of
``(pos, del_count, ins)`` patches; ``len()`` is the patch count, the
throughput element count).

Positions and delete counts are in character (codepoint) units;
``TestData.chars_to_bytes`` rewrites them into UTF-8 byte units.  Pure
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

    def chars_to_bytes(self) -> "TestData":
        """The same trace with positions and delete counts in UTF-8 byte
        units, for byte-addressed backends.  Only multi-byte chars make
        the two differ, so this tracks the char positions of those in the
        evolving document (O(#multi-byte chars) a patch)."""
        # (char_pos, extra_bytes) of each multi-byte char in the document
        extras: list[list[int]] = [
            [i, len(c.encode("utf-8")) - 1]
            for i, c in enumerate(self.start_content)
            if ord(c) >= 128
        ]
        new_txns: list[TestTxn] = []
        for txn in self.txns:
            new_patches: list[TestPatch] = []
            for pos, del_count, ins in txn.patches:
                byte_pos = pos + sum(e for p, e in extras if p < pos)
                byte_del = del_count + sum(
                    e for p, e in extras if pos <= p < pos + del_count
                )
                new_patches.append(TestPatch(byte_pos, byte_del, ins))
                shift = len(ins) - del_count
                extras = [
                    [p + shift if p >= pos + del_count else p, e]
                    for p, e in extras
                    if not (pos <= p < pos + del_count)
                ]
                extras.extend(
                    [pos + i, len(c.encode("utf-8")) - 1]
                    for i, c in enumerate(ins)
                    if ord(c) >= 128
                )
                extras.sort()
            new_txns.append(TestTxn(txn.time, new_patches))
        return TestData(self.start_content, self.end_content, new_txns)


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
