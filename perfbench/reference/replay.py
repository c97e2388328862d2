"""The plain reference: replay a trace's patches, one after another, on a
Python string.  A patch ``(pos, d, ins)`` replaces the ``d`` characters at
``pos`` with ``ins``.  Every replica of a cell receives every patch once,
in trace order, so every replica ends with this text.

:func:`replay_out_of_order` is the control: the same patches with the
guarantee "every patch applied in trace order" broken, each group of
``batch`` patches applied in reverse order, as a change that applied a
batch's patches in parallel without ordering them could do.
"""

from __future__ import annotations

from collections.abc import Iterable

Patch = tuple[int, int, str]


def replay(start: str, patches: Iterable[Patch]) -> str:
    """The text after applying ``patches`` to ``start`` in order."""
    doc = start
    for pos, d, ins in patches:
        doc = doc[:pos] + ins + doc[pos + d:]
    return doc


def replay_out_of_order(start: str, patches: list[Patch], batch: int) -> str:
    """The control: each group of ``batch`` patches applied in reverse
    order (a position past the end of the text clamps to it)."""
    doc = start
    for i in range(0, len(patches), batch):
        for pos, d, ins in reversed(patches[i:i + batch]):
            pos = min(pos, len(doc))
            doc = doc[:pos] + ins + doc[pos + d:]
    return doc
