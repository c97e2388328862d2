"""One step of the headline hot path on tiny shapes (the port's twin of
``entry()`` in the repository's ``__graft_entry__.py``): a compile-and-run
check of the range replay's kernels.

    from crdt_benches_tpu_torch.entry import entry
    step, args = entry()          # device="cuda" by default
    doc, cv_intile, vis_tile, length, nvis = step(*args)

The step is one op batch of the range replay: K1's shared form, then the
fused range apply (``apply_range_batch4``: K2 or K3 by the dispatch), at 4
replicas, capacity 1024, on the first batch of the seed-0 synthetic trace
of 24 ops (batch 8).
"""

from __future__ import annotations

import torch

from .device import resolve_device
from .ops.apply2 import PackedState4, init_state4
from .ops.apply_range_fused import apply_range_batch4
from .ops.resolve_range import resolve_range
from .traces.synth import synth_trace
from .traces.tensorize import tensorize_ranges

#: replicas and capacity of the step (nt = 8 tiles of 128)
R = 4
CAPACITY = 1024


def step(doc, cv_intile, vis_tile, length, nvis, kind, pos, rlen, slot0):
    """One range batch (kind/pos/rlen/slot0 int32[B]) applied to every
    replica of the state; returns the new (doc, cv_intile, vis_tile,
    length, nvis)."""
    st = PackedState4(doc, cv_intile, vis_tile, length, nvis)
    tokens, dints, _ = resolve_range(kind, pos, rlen, slot0, st.nvis)
    st = apply_range_batch4(st, tokens, dints)
    return st.doc, st.cv_intile, st.vis_tile, st.length, st.nvis


def entry(device: str | torch.device = "cuda"):
    """``(step, example_args)`` on ``device``: the fresh state's five
    fields, then the first range batch's four op arrays."""
    dev = resolve_device(device)
    trace = synth_trace(seed=0, n_ops=24, p_insert=0.7)
    kind_b, pos_b, rlen_b, slot0_b = tensorize_ranges(trace,
                                                      batch=8).batched()
    st = init_state4(R, CAPACITY, 0, device=dev)
    ops = tuple(torch.as_tensor(a[0], dtype=torch.int32, device=dev)
                for a in (kind_b, pos_b, rlen_b, slot0_b))
    return step, (st.doc, st.cv_intile, st.vis_tile, st.length,
                  st.nvis) + ops
