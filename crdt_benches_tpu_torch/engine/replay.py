"""Unit-op replay driver (the JAX package's ``engine/replay.py``), and the
capacity staging shared by the replay engines.

Per op batch the resolver K5 (``ops/resolve.py``) then one of the unit
applies of ``ops/apply2.py`` — ``v4`` (default: the fused apply K6 over
the maintained-cv state), ``v3`` (packed state, expansion K8) or ``v2``
(order/vis state, expansion K9) — or the slot-indexed ``v1`` apply of
``ops/apply.py``, replicated R times, every replica doing its own full
resolve and apply.  :func:`replay_batches_collect` is the v1 replay that
also returns each delete's target slot (downstream update generation).

The batches run in Python, one K5 launch and one apply per real batch:
the JAX engine's padding of the batch count to a multiple of ``pack``
only made its scan steps uniform.  The resolver runs uncapped at
T = round_up(2B + 2, 128), which bounds every batch's token demand, so
the JAX engine's host token simulation is not needed.  ``v4`` runs each
chunk of ``chunk`` batches at a staged capacity covering its
end-of-chunk used length, as the JAX engine does; ``v2``/``v3`` run at
the full capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lint.boundary import boundary
from ..device import resolve_device
from ..ops.apply import (
    DocState,
    apply_batch,
    apply_batch_collect,
    decode_state,
    init_state,
)
from ..ops.apply2 import (
    LANE,
    MAX_COMBO_CAPACITY,
    PackedState4,
    apply_batch2,
    apply_batch3,
    apply_batch4,
    decode_state2,
    decode_state3,
    decode_state4,
    init_state2,
    init_state3,
    init_state4,
)
from ..ops.resolve import resolve_batch
from ..traces.tensorize import INSERT, TensorizedTrace

_ENGINES = {
    "v1": (init_state, apply_batch, decode_state),
    "v2": (init_state2, apply_batch2, decode_state2),
    "v3": (init_state3, apply_batch3, decode_state3),
    "v4": (init_state4, apply_batch4, decode_state4),
}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _stage_capacity(need: int, lane: int = 128) -> int:
    """Smallest staged capacity >= need from a sqrt(2)-spaced grid
    (lane * {8, 12, 16, 24, 32, ...}) — wasted capacity stays ~20% on
    average while the document grows."""
    s = 8 * lane
    while s < need:
        s2 = s + s // 2
        if s2 >= need:
            return s2
        s *= 2
    return s


def _grow_state4(state: PackedState4, new_cap: int) -> PackedState4:
    """Pad a PackedState4's capacity axis to new_cap (doc pads with
    pack_doc(-1, 0) == 2, the prefix structures with zeros)."""
    R, C = state.doc.shape
    if new_cap <= C:
        return state
    pad = new_cap - C
    doc = state.doc
    return PackedState4(
        doc=torch.cat([doc, doc.new_full((R, pad), 2)], dim=1),
        cv_intile=torch.cat(
            [state.cv_intile, state.cv_intile.new_zeros((R, pad))], dim=1
        ),
        vis_tile=torch.cat(
            [state.vis_tile, state.vis_tile.new_zeros((R, pad // LANE))],
            dim=1,
        ),
        length=state.length,
        nvis=state.nvis,
    )


def slot_char_table(tt: TensorizedTrace, capacity: int) -> np.ndarray:
    """slot -> codepoint: the start content in slots 0..S-1, each insert
    op's preassigned slot its char."""
    chars = np.zeros(capacity, np.int32)
    chars[: len(tt.init_chars)] = tt.init_chars
    ins = tt.slot >= 0
    chars[tt.slot[ins]] = tt.ch[ins]
    return chars


def decode_to_str(state, chars: torch.Tensor, replica: int = 0) -> str:
    """One replica's visible document as a string, from any state with
    order/visible/length fields (``DocState``, the downstream
    ``DownState``)."""
    codes, _ = decode_state(state, chars, replica)
    return "".join(map(chr, codes.cpu().tolist()))


@boundary(
    dtypes=(None, "int32", "int32", "int32"),
    shapes=(None, "N B", "N B", "N B"),
    donates=(0,),
)
def replay_units(state, kind_b, pos_b, slot_b, engine: str = "v4"):
    """Replay the unit batches kind_b/pos_b/slot_b int32[N, B] into
    ``state`` (the engine's state type); returns the new state.  Only v1
    keeps the CRDT origins, so only v1 has the resolver emit them."""
    apply = _ENGINES[engine][1]
    for i in range(kind_b.shape[0]):
        resolved = resolve_batch(
            kind_b[i], pos_b[i], state.nvis, emit_origin=engine == "v1"
        )
        state = apply(state, resolved, slot_b[i])
    return state


def replay_batches_collect(state: DocState, kind_b, pos_b, slot_b):
    """The v1 replay of kind_b/pos_b/slot_b int32[N, B] that also stacks
    each op's tombstoned slot: returns (state, dslot_b int32[N, R, B]).
    Update generation (``engine/downstream.py``) runs it untimed."""
    N, B = kind_b.shape
    dslot_b = torch.empty((N, state.nvis.shape[0], B), dtype=torch.int32,
                          device=state.nvis.device)
    for i in range(N):
        resolved = resolve_batch(kind_b[i], pos_b[i], state.nvis,
                                 emit_origin=True)
        state, dslot_b[i] = apply_batch_collect(state, resolved, slot_b[i])
    return state, dslot_b


class ReplayEngine:
    """Host-side driver for unit-op replay of one tensorized trace on
    ``device``, R replicas wide."""

    def __init__(
        self,
        tt: TensorizedTrace,
        n_replicas: int = 1,
        lane: int = 128,
        chunk: int = 32,
        engine: str = "v4",
        device: str | torch.device = "cuda",
    ):
        if engine not in _ENGINES:
            raise ValueError(f"unknown unit engine {engine!r}")
        self.device = resolve_device(device)
        self.tt = tt
        self.n_replicas = n_replicas
        self.engine = engine
        self.capacity = _round_up(max(tt.capacity, 1), lane)
        # the port's one capacity bound is K6's int32 combo operand; the
        # JAX engine's 2^21 and capacity*(B+1) < 2^31 guards bound the TPU's
        # bf16 chunk arithmetic and an int32 sort key, which the port does
        # not have (its destination sort key is int64)
        if self.capacity >= MAX_COMBO_CAPACITY:
            raise ValueError(
                f"capacity {self.capacity} >= 2^28: the fused apply's "
                "combo operand would overflow int32"
            )
        self.n_init = len(tt.init_chars)
        self.chunk = chunk

        kind_b, pos_b, _, slot_b = tt.batched()
        dev = self.device
        as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        starts = range(0, tt.n_batches, chunk)
        self.chunks = [
            (as_t(kind_b[i:i + chunk]), as_t(pos_b[i:i + chunk]),
             as_t(slot_b[i:i + chunk]))
            for i in starts
        ]
        # v4: capacity staged per chunk by its end-of-chunk used length
        self.stage_caps = [self.capacity] * len(self.chunks)
        if engine == "v4":
            end_len = self.n_init + np.cumsum((kind_b == INSERT).sum(axis=1))
            self.stage_caps = [
                min(self.capacity, _stage_capacity(
                    int(end_len[min(i + chunk, len(end_len)) - 1]), lane))
                for i in starts
            ]
            for i in range(1, len(self.stage_caps)):
                self.stage_caps[i] = max(
                    self.stage_caps[i], self.stage_caps[i - 1]
                )
        self.chars = as_t(slot_char_table(tt, self.capacity))

    def init_state(self):
        """The fresh replica-batched state at the first stage's capacity."""
        init = _ENGINES[self.engine][0]
        return init(self.n_replicas, self.stage_caps[0], self.n_init,
                    device=self.device)

    def run(self, state=None):
        """Replay the whole trace from ``state`` (default: fresh, which is
        part of the replay); returns the final state on the device."""
        st = self.init_state() if state is None else state
        for cap, (kind, pos, slot) in zip(self.stage_caps, self.chunks):
            if self.engine == "v4":
                st = _grow_state4(st, cap)
            st = replay_units(st, kind, pos, slot, self.engine)
        return st

    def decode(self, state, replica: int = 0) -> str:
        """A replica's visible document as a string."""
        codes, _ = _ENGINES[self.engine][2](state, self.chars, replica)
        return "".join(map(chr, codes.cpu().tolist()))

    def lengths(self, state) -> np.ndarray:
        """Per-replica visible char counts."""
        return np.atleast_1d(state.nvis.cpu().numpy())
