"""A cell's inputs: one published editing trace, read from
``perfbench/data/<trace>.json.gz`` (josephg's editing-traces format), with
its characters relabelled by the seed.

The seed permutes the trace's own alphabet: every patch keeps its
position, delete count and insert length, so each seed asks for the same
work in the same order, and only the text that the replicas must end
with differs.  Plain Python and NumPy; imports nothing of the program.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

Patch = tuple[int, int, str]  # (position, chars deleted, text inserted)


@dataclass(frozen=True)
class Trace:
    """A trace as both sides are given it."""

    start: str
    end: str  # the published end content, relabelled like the patches
    txns: tuple[tuple[str, tuple[Patch, ...]], ...]  # (time, patches)

    @property
    def patches(self) -> list[Patch]:
        return [p for _, ps in self.txns for p in ps]

    @property
    def n_patches(self) -> int:
        return sum(len(ps) for _, ps in self.txns)


def relabel_table(alphabet: list[str], seed: int) -> dict[int, str]:
    """A permutation of ``alphabet`` drawn from ``seed``, as a
    ``str.translate`` table."""
    perm = np.random.default_rng(seed & ((1 << 64) - 1)).permutation(
        len(alphabet))
    return {ord(a): alphabet[j] for a, j in zip(alphabet, perm.tolist())}


def load(name: str, seed: int, data_dir: str = DATA) -> Trace:
    """Trace ``name`` (or a path to a ``.json.gz`` trace) with its
    characters relabelled by ``seed``."""
    path = name if name.endswith(".json.gz") else os.path.join(
        data_dir, name + ".json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as fh:
        raw = json.load(fh)
    txns = [(t.get("time", ""), [(int(p[0]), int(p[1]), str(p[2]))
                                 for p in t["patches"]])
            for t in raw["txns"]]
    alphabet = sorted(set(raw["startContent"]).union(
        *(ins for _, ps in txns for _, _, ins in ps)))
    table = relabel_table(alphabet, seed)
    return Trace(
        start=raw["startContent"].translate(table),
        end=raw["endContent"].translate(table),
        txns=tuple((time_, tuple((p, d, ins.translate(table))
                                 for p, d, ins in ps))
                   for time_, ps in txns),
    )
