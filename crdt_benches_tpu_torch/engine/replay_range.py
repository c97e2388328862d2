"""Range-op replay engine (the JAX package's ``engine/replay_range.py``):
per op batch the resolver K1, then the range apply, replicated R times.
Engine ``v4`` (default) applies with the fused range apply (K2 or K3, as
``range_apply_dispatch`` picks) on the maintained-cv ``PackedState4``;
engine ``v3`` with ``apply_range_batch`` (K4 at K = 1) on a
``PackedState``.

The batches run in chunks of ``chunk`` batches; each chunk runs at a
staged capacity that covers its end-of-chunk used length (the document
grows over the replay, and every apply streams the whole (R, C) doc).
The token list is uncapped (T = round_up(2B + 2, 128), the worst case);
the resolver's true token demand is still checked after the replay with
one host fetch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lint.boundary import boundary
from ..device import resolve_device
from ..ops.apply2 import (
    PackedState,
    PackedState4,
    decode_state3,
    init_state3,
    init_state4,
)
from ..ops.apply_range import apply_range_batch
from ..ops.apply_range_fused import apply_range_batch4
from ..ops.resolve_range import effective_token_list_size, resolve_range
from ..traces.tensorize import INSERT, RangeTrace
from .replay import _grow_state4, _round_up, _stage_capacity

#: Capacity bound of the port's own kernels: the packed doc value
#: ((slot + 2) << 1) | vis and the resolver's tta = ta*4 + ttype (ta a
#: rank or slot id below capacity) must fit int32.
MAX_CAPACITY = 1 << 29


ENGINES = ("v4", "v3")


def _grow_state3(state: PackedState, new_cap: int) -> PackedState:
    """Pad a PackedState's capacity axis to new_cap (doc pads with
    pack_doc(-1, 0) == 2, the beyond-length code every apply re-stamps)."""
    R, C = state.doc.shape
    if new_cap <= C:
        return state
    return PackedState(
        doc=torch.cat([state.doc, state.doc.new_full((R, new_cap - C), 2)],
                      dim=1),
        length=state.length,
        nvis=state.nvis,
    )


@boundary(
    dtypes=(None, "int32", "int32", "int32", "int32"),
    shapes=(None, "N B", "N B", "N B", "N B"),
    donates=(0,),
)
def replay_ranges(state, kind_b, pos_b, rlen_b, slot0_b):
    """Replay the range batches kind_b/pos_b/rlen_b/slot0_b int32[N, B]
    into ``state``: a ``PackedState4`` goes through the fused apply (v4), a
    ``PackedState`` through ``apply_range_batch`` (v3), each batch after
    K1's shared form.  Returns (state, max resolver token demand as a 0-d
    device tensor)."""
    apply = (apply_range_batch4 if isinstance(state, PackedState4)
             else apply_range_batch)
    mx = torch.zeros((), dtype=torch.int32, device=state.doc.device)
    for i in range(kind_b.shape[0]):
        tokens, dints, nused = resolve_range(
            kind_b[i], pos_b[i], rlen_b[i], slot0_b[i], state.nvis
        )
        mx = torch.maximum(mx, nused.max())
        state = apply(state, tokens, dints)
    return state, mx


class RangeReplayEngine:
    """Host-side driver for range-op replay on ``device``."""

    def __init__(
        self,
        rt: RangeTrace,
        n_replicas: int = 1,
        chunk: int = 32,
        pack: int = 4,
        engine: str = "v4",
        device: str | torch.device = "cuda",
    ):
        if engine not in ENGINES:
            raise ValueError(f"unknown range engine {engine!r}")
        self.device = resolve_device(device)
        self.rt = rt
        self.n_replicas = n_replicas
        self.engine = engine
        # capacities round to 1024 positions on v4 and 128 on v3, as the
        # reference's engines do, so both packages stage through the same
        # shapes
        lane = 8 * 128 if engine == "v4" else 128
        self.capacity = _round_up(max(rt.capacity, 1), lane)
        if self.capacity > MAX_CAPACITY:
            raise ValueError(
                f"capacity {self.capacity} > 2^29: packed doc values and "
                "resolver tokens would overflow int32"
            )
        self.n_init = len(rt.init_chars)
        self.chunk = _round_up(chunk, pack)

        kind_b, pos_b, rlen_b, slot0_b = rt.batched()
        dev = self.device
        as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        self.chunks = [
            (
                as_t(kind_b[i:i + self.chunk]),
                as_t(pos_b[i:i + self.chunk]),
                as_t(rlen_b[i:i + self.chunk]),
                as_t(slot0_b[i:i + self.chunk]),
            )
            for i in range(0, rt.n_batches, self.chunk)
        ]
        ins_chars = np.where(kind_b == INSERT, rlen_b, 0).sum(axis=1)
        end_len = self.n_init + np.cumsum(ins_chars)
        self.stage_caps: list[int] = []
        for i in range(0, rt.n_batches, self.chunk):
            need = int(end_len[min(i + self.chunk, len(end_len)) - 1])
            self.stage_caps.append(
                min(self.capacity, _stage_capacity(need, lane))
            )
        for i in range(1, len(self.stage_caps)):
            self.stage_caps[i] = max(
                self.stage_caps[i], self.stage_caps[i - 1]
            )
        if not self.stage_caps:
            self.stage_caps = [self.capacity]

        chars = np.zeros(self.capacity, np.int32)
        chars[: rt.capacity] = rt.chars
        self.chars = as_t(chars)

    def run(self, state=None):
        """Replay every batch into ``state`` (default: a fresh document,
        ``PackedState4`` on v4, ``PackedState`` on v3); returns the final
        state."""
        init, grow = ((init_state4, _grow_state4) if self.engine == "v4"
                      else (init_state3, _grow_state3))
        st = (
            init(self.n_replicas, self.stage_caps[0], self.n_init,
                 device=self.device)
            if state is None
            else state
        )
        demands = []
        for cap, (kind, pos, rlen, slot0) in zip(self.stage_caps, self.chunks):
            st = grow(st, cap)
            st, mx = replay_ranges(st, kind, pos, rlen, slot0)
            demands.append(mx)
        # one host fetch after the loop: an undersized token list is a
        # loud failure, never silent corruption
        t_eff = effective_token_list_size(self.rt.batch, None)
        if demands:
            got = torch.stack(demands).cpu().tolist()
            for i, g in enumerate(got):
                if g > t_eff:
                    raise RuntimeError(
                        f"range resolver token overflow in chunk {i}: "
                        f"demand {g} > token list size {t_eff}"
                    )
        return st

    def decode(self, state, replica: int = 0) -> str:
        s3 = PackedState(doc=state.doc, length=state.length, nvis=state.nvis)
        codes, _ = decode_state3(s3, self.chars, replica=replica)
        return "".join(map(chr, codes.cpu().tolist()))

    def lengths(self, state) -> np.ndarray:
        return np.atleast_1d(state.nvis.cpu().numpy())
