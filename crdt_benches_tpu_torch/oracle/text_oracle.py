"""Pure-Python ground-truth document replay (a copy of the JAX package's
``oracle/text_oracle.py``): the fleet folds trace prefixes through
``OracleDocument`` and verifies every drained document against
:func:`replay_trace`, byte for byte.
"""

from __future__ import annotations

import numpy as np

from ..traces.loader import TestData
from ..traces.tensorize import DELETE, INSERT


class OracleDocument:
    """A trivial char-list document.  Char (codepoint) offsets."""

    NAME = "python-oracle"
    EDITS_USE_BYTE_OFFSETS = False

    def __init__(self, content: str = ""):
        self._chars: list[str] = list(content)

    @classmethod
    def from_str(cls, s: str) -> "OracleDocument":
        return cls(s)

    def insert(self, at: int, text: str) -> None:
        self._chars[at:at] = list(text)

    def remove(self, start: int, end: int) -> None:
        del self._chars[start:end]

    def replace(self, start: int, end: int, text: str) -> None:
        # remove-then-insert, as the reference's default impl (src/rope.rs:21-32)
        self._chars[start:end] = list(text)

    def __len__(self) -> int:
        return len(self._chars)

    def content(self) -> str:
        return "".join(self._chars)


def replay_trace(trace: TestData) -> str:
    """Replay all patches; return final content (ground truth)."""
    doc = OracleDocument.from_str(trace.start_content)
    for pos, del_count, ins in trace.iter_patches():
        doc.replace(pos, pos + del_count, ins)
    return doc.content()


def replay_unit_ops(
    kind: np.ndarray, pos: np.ndarray, ch: np.ndarray, start: str = ""
) -> str:
    """Replay exploded unit ops (tensorize.py layout); oracle for the engine's
    exact input representation."""
    doc = list(start)
    for k, p, c in zip(kind.tolist(), pos.tolist(), ch.tolist()):
        if k == INSERT:
            doc[max(p, 0) : max(p, 0)] = [chr(c)]  # p > len appends, p < 0 prepends
        elif k == DELETE and 0 <= p < len(doc):  # out-of-range delete: no-op
            del doc[p]
    return "".join(doc)
