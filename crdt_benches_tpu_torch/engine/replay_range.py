"""Range-op replay driver (the JAX package's ``engine/replay_range.py``,
engine v4): per op batch, the resolver K1 then the fused range apply
K2/K3, over the maintained-cv packed state, replicated R times.

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

from ..device import resolve_device
from ..ops.apply2 import PackedState, PackedState4, decode_state3, init_state4
from ..ops.apply_range_fused import apply_range_batch4
from ..ops.resolve_range import effective_token_list_size, resolve_range
from ..traces.tensorize import INSERT, RangeTrace
from .replay import _grow_state4, _round_up, _stage_capacity

#: Capacity bound of the port's own kernels: the packed doc value
#: ((slot + 2) << 1) | vis and the resolver's tta = ta*4 + ttype (ta a
#: rank or slot id below capacity) must fit int32.
MAX_CAPACITY = 1 << 29


def replay_ranges(state: PackedState4, kind_b, pos_b, rlen_b, slot0_b):
    """Replay the range batches kind_b/pos_b/rlen_b/slot0_b int32[N, B]
    into ``state``.  Returns (state, max resolver token demand as a 0-d
    device tensor)."""
    mx = torch.zeros((), dtype=torch.int32, device=state.doc.device)
    for i in range(kind_b.shape[0]):
        tokens, dints, nused = resolve_range(
            kind_b[i], pos_b[i], rlen_b[i], slot0_b[i], state.nvis
        )
        mx = torch.maximum(mx, nused.max())
        state = apply_range_batch4(state, tokens, dints)
    return state, mx


class RangeReplayEngine:
    """Host-side driver for range-op replay on ``device``."""

    def __init__(
        self,
        rt: RangeTrace,
        n_replicas: int = 1,
        chunk: int = 32,
        pack: int = 4,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.rt = rt
        self.n_replicas = n_replicas
        # capacities round to 1024 positions, as the reference's v4 engine
        # does, so both engines stage through the same shapes
        lane = 8 * 128
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

    def run(self, state: PackedState4 | None = None) -> PackedState4:
        st = (
            init_state4(
                self.n_replicas, self.stage_caps[0], self.n_init,
                device=self.device,
            )
            if state is None
            else state
        )
        demands = []
        for cap, (kind, pos, rlen, slot0) in zip(self.stage_caps, self.chunks):
            st = _grow_state4(st, cap)
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

    def decode(self, state: PackedState4, replica: int = 0) -> str:
        s3 = PackedState(doc=state.doc, length=state.length, nvis=state.nvis)
        codes, _ = decode_state3(s3, self.chars, replica=replica)
        return "".join(map(chr, codes.cpu().tolist()))

    def lengths(self, state: PackedState4) -> np.ndarray:
        return np.atleast_1d(state.nvis.cpu().numpy())
