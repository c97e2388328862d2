"""K4's worst cases (the serve macro apply, ``csrc/serve_macro.cu``): per-row
range ops made with numpy from a seed, shared by the CPU tests
(``tests/test_torch_serve_macro_worst.py``) and ``chip_smoke.py``
(``[k4 worst]``).

- ``ins_at_0``: every op of every round inserts at 0, so every old column's
  source lies far left of it (across slice boundaries on the card, once a
  round inserts more than a slice holds);
- ``span``: round 0 deletes the whole visible document in one op, later
  rounds insert and delete at random;
- ``full``: random rounds whose final new length is exactly the capacity
  (each round's deletes come before its inserts, so that every inserted
  char takes a column);
- ``mixed``: random rounds with room to spare.

The initial documents have invisible columns (a quarter, at random).
"""

from __future__ import annotations

import numpy as np

from ..traces.tensorize import DELETE, INSERT, PAD

CASES = ("ins_at_0", "span", "full", "mixed")


def worst_rounds(name, K, R, B, C, seed):
    """One worst case: numpy (doc int32[R, C], length, nvis int32[R],
    kind, pos, rlen, slot0 int32[K, R, B]), every row within capacity
    C after the K rounds (exactly C for ``full``)."""
    rng = np.random.default_rng(seed)
    shape = (K, R, B)
    kind = np.full(shape, PAD, np.int32)
    pos, rlen, slot0 = (np.zeros(shape, np.int32) for _ in range(3))
    doc = np.full((R, C), 2, np.int32)
    length = np.zeros(R, np.int32)
    nvis = np.zeros(R, np.int32)
    for r in range(R):
        if name == "ins_at_0":
            vol = C * 5 // 8  # inserted over the K rounds
            ins = np.ones(shape[::2], bool)
            lens = 1 + rng.multinomial(vol - K * B,
                                       np.full(K * B, 1 / (K * B)))
            lens = lens.reshape(K, B)
        else:
            ins = rng.random((K, B)) < 0.6
            lens = np.where(ins, rng.integers(1, 9, (K, B)), 0)
            if name == "span":
                ins[0], lens[0] = False, 0
            if name == "full":  # deletes first: none hits the round's inserts
                order = np.argsort(ins, axis=1, kind="stable")
                ins = np.take_along_axis(ins, order, 1)
                lens = np.take_along_axis(lens, order, 1)
        slack = 0 if name == "full" else int(rng.integers(0, C // 8))
        L0 = C - int(lens.sum()) - slack
        vis = (rng.random(L0) < 0.75).astype(np.int32)
        doc[r, :L0] = ((np.arange(L0) + 2) << 1) | vis
        length[r], nvis[r] = L0, vis.sum()
        total, slot = int(vis.sum()), L0 + 2
        for k in range(K):
            for b in range(B):
                if name == "span" and k == 0:
                    if b == 0 and total:
                        kind[k, r, b], rlen[k, r, b] = DELETE, total
                        total = 0
                    continue
                if ins[k, b]:
                    p = 0 if name == "ins_at_0" else int(
                        rng.integers(0, total + 1))
                    kind[k, r, b], pos[k, r, b] = INSERT, p
                    rlen[k, r, b], slot0[k, r, b] = lens[k, b], slot
                    slot += int(lens[k, b])
                    total += int(lens[k, b])
                elif total:
                    p = int(rng.integers(0, total))
                    n = int(rng.integers(1, min(8, total - p) + 1))
                    kind[k, r, b], pos[k, r, b], rlen[k, r, b] = DELETE, p, n
                    total -= n
    return doc, length, nvis, kind, pos, rlen, slot0
