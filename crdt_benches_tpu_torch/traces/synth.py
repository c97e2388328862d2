"""Synthetic edit-stream generation (a copy of the JAX package's
``traces/synth.py``): seeded random unit edits, the synthetic sessions of
the serving fleet.  The same seed gives the same patches in both packages.
"""

from __future__ import annotations

import numpy as np

from .loader import TestData, TestPatch, TestTxn


def random_patches(
    rng: np.random.Generator,
    n_ops: int,
    start_len: int = 0,
    p_insert: float = 0.65,
) -> tuple[list[TestPatch], int]:
    """``n_ops`` single-char random edits against a document of
    ``start_len`` chars; returns (patches, final_len)."""
    doc_len = start_len
    patches: list[TestPatch] = []
    for _ in range(n_ops):
        if doc_len == 0 or rng.random() < p_insert:
            pos = int(rng.integers(0, doc_len + 1))
            patches.append(TestPatch(pos, 0, chr(int(rng.integers(97, 123)))))
            doc_len += 1
        else:
            patches.append(TestPatch(int(rng.integers(0, doc_len)), 1, ""))
            doc_len -= 1
    return patches, doc_len


def synth_trace(
    seed: int, n_ops: int, base: str = "", p_insert: float = 0.65
) -> TestData:
    """A synthetic TestData: random unit edits from ``base`` (end_content
    left empty — the oracle defines truth for synthetic streams)."""
    rng = np.random.default_rng(seed)
    patches, _ = random_patches(rng, n_ops, len(base), p_insert)
    return TestData(base, "", [TestTxn("", patches)])


def synth_streams(
    seed: int, n_agents: int, n_ops: int, base: str = "",
    p_insert: float = 0.65,
) -> list[TestData]:
    """One divergent random edit stream per agent from a shared base — the
    concurrent-merge workload (BASELINE.md configs 4-5)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_agents):
        patches, _ = random_patches(rng, n_ops, len(base), p_insert)
        out.append(TestData(base, "", [TestTxn("", patches)]))
    return out
