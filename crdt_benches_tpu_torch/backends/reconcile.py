"""Whole-document-reconcile backend (a copy of the JAX package's
``backends/reconcile.py``), the ``py-reconcile`` column: the reference's
automerge adapter shape.

That adapter leaves ``insert``/``remove`` unimplemented; ``replace``
splices a typed shadow text and then reconciles the whole document: every
edit re-diffs the full document against the shadow and turns the diff
into CRDT ops, and ``len`` is the byte length of the materialized string.
This backend keeps that shape: the edit lands positionally in a shadow
buffer, and the document of stable element ids changes ONLY through a
whole-document diff of shadow against document (common prefix and common
suffix), so the edit position is recovered from the diff, never trusted.
Each edit costs O(document), which is what makes the column slow.

NumPy does the per-edit whole-document scans, so the column stays
benchable on the real traces (the reconcile is still O(doc) work an edit;
nothing is skipped, only vectorized).
"""

from __future__ import annotations

import numpy as np

from .base import Upstream, register_upstream


@register_upstream
class PyReconcile(Upstream):
    """Automerge-shaped upstream: splice a shadow, reconcile the whole doc.

    The "document" is a sequence of stable element ids (the automerge op-id
    analog): reconcile assigns fresh ids to exactly the spliced-in middle
    and drops the ids of the removed middle, preserving ids of the common
    prefix/suffix — matching what ``autosurgeon::reconcile`` derives from
    its whole-value diff.
    """

    NAME = "py-reconcile"
    EDITS_USE_BYTE_OFFSETS = False  # char offsets, as the reference feeds
    # its automerge adapter

    def __init__(self, s: str = ""):
        self._shadow = np.frombuffer(
            s.encode("utf-32-le"), dtype=np.uint32
        ).astype(np.int64)
        self._doc_chars = self._shadow.copy()
        self._doc_ids = np.arange(len(self._shadow), dtype=np.int64)
        self._next_id = len(self._shadow)

    @classmethod
    def from_str(cls, s: str) -> "PyReconcile":
        return cls(s)

    # insert/remove are deliberately unsupported, as in the reference's
    # adapter: all edits arrive through replace.
    def insert(self, at: int, text: str) -> None:
        raise NotImplementedError("py-reconcile edits only via replace")

    def remove(self, start: int, end: int) -> None:
        raise NotImplementedError("py-reconcile edits only via replace")

    def replace(self, start: int, end: int, text: str) -> None:
        ins = np.frombuffer(
            text.encode("utf-32-le"), dtype=np.uint32
        ).astype(np.int64)
        # 1. splice the typed shadow
        self._shadow = np.concatenate(
            [self._shadow[:start], ins, self._shadow[end:]]
        )
        # 2. whole-document reconcile: diff shadow vs doc
        #    by longest common prefix + suffix; only the middle changes.
        old, new = self._doc_chars, self._shadow
        no, nn = len(old), len(new)
        m = min(no, nn)
        neq = old[:m] != new[:m]
        p = int(np.argmax(neq)) if neq.any() else m
        neq = old[no - m:][::-1] != new[nn - m:][::-1]
        s = int(np.argmax(neq)) if neq.any() else m
        s = min(s, m - p)  # suffix may not overlap the prefix
        fresh = np.arange(
            self._next_id, self._next_id + (nn - p - s), dtype=np.int64
        )
        self._next_id += len(fresh)
        self._doc_ids = np.concatenate(
            [self._doc_ids[:p], fresh, self._doc_ids[no - s:]]
        )
        self._doc_chars = new.copy()
        assert len(self._doc_ids) == len(self._doc_chars)

    def __len__(self) -> int:
        # byte length of the materialized string
        return len(self.content().encode())

    def content(self) -> str:
        return self._doc_chars.astype(np.uint32).tobytes().decode(
            "utf-32-le"
        )
