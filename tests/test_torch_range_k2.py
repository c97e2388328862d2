"""K2, the fused range apply with one block per row, on its worst cases.

K2 (``csrc/range_apply.cu``) walks a row's live columns chunk by chunk and
gathers each column's source from a shared-memory ring of x, or, where the
source is older than the ring, reads doc again with x's vis bit from a bit
row.  Its worst cases are ``bench/k3_cases.py``'s cases with the span
set to K2's widths (``k2_case``): a paste wider than the ring, new lengths
on a chunk edge, inside a tile, at 0 and at C, full rows, mixed rows, run
depth 2 and random operands.  Made with numpy from a seed, they go
through the port's ``range_apply`` (its plain version on the CPU) and
``range_apply_plain`` (what K2 is held to on the card), and through the
JAX package's ``range_fused`` under the Pallas interpreter and
``range_fused_xla``: exact integer equality (tolerance 0, every output
is an integer; ``cv_intile`` — bf16 in JAX, int16 in the port — compared
by value).  They are the cases ``chip_smoke.py`` holds the kernel to on
the card (``[k2 worst]``), at CPU sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from crdt_benches_tpu.ops.apply_range_fused import range_fused, range_fused_xla
from crdt_benches_tpu_torch.bench.k3_cases import (
    DSH,
    K2_CASES,
    k2_case,
    max_holes,
)
from crdt_benches_tpu_torch.ops import apply_range_fused as arf

#: Two chunks and a tile (a ragged last chunk), and three rings' worth of
#: columns (the paste then spans 1.5 rings).
SIZES = (2 * arf.K2_CHUNK + 128, 3 * arf.K2_RING)


def _case(name, R, C):
    return k2_case(name, R, C, arf.K2_CHUNK, arf.K2_RING, seed=C + R)


def _shapes():
    for C in SIZES:
        for name in K2_CASES:
            rows = {"mixed": (1, 3), "nlen_edges": (4,)}.get(name, (2,))
            for R in rows:
                yield pytest.param(name, R, C, id=f"{name}-R{R}-C{C}")


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            np.asarray(g).astype(np.int64),
            np.asarray(w).astype(np.float32).astype(np.int64),
        )


@pytest.mark.parametrize("name,R,C", list(_shapes()))
def test_k2_case_equals_jax_range_fused(name, R, C):
    ops = _case(name, R, C)
    assert ops[0].shape == (R, C) and ops[4].shape == (R,)
    tops = [torch.from_numpy(a) for a in ops]
    got = arf.range_apply_plain(*tops, DSH)
    spills = torch.zeros(1, dtype=torch.int64)
    _assert_equal(arf.range_apply(*tops, DSH, spills=spills), got)
    assert int(spills) == arf.range_apply_ring_misses(tops[2], tops[4])
    # JAX's roll cascade is exact while 2^nbits exceeds every hole count
    nbits = max(1, max_holes(ops[2]).bit_length())
    jops = [jnp.asarray(a) for a in ops]
    _assert_equal(got, range_fused(*jops, nbits=nbits, dsh=DSH,
                                   interpret=True))
    _assert_equal(got, range_fused_xla(*jops, nbits=nbits, dsh=DSH))


def test_k2_cases_reach_what_they_name():
    """At the larger test size: the paste's sources lie further back than
    the ring, so the bit row is read; the new lengths of
    ``nlen_edges`` fall on a chunk edge, inside a tile, at 0 and at C."""
    C = SIZES[1]
    paste = [torch.from_numpy(a) for a in _case("paste", 2, C)]
    run = torch.cumsum(paste[2], dim=1) > 0
    lag = torch.cumsum(run.to(torch.int32), dim=1)
    assert int(lag.max()) > arf.K2_RING
    assert arf.range_apply_ring_misses(paste[2], paste[4]) > 0
    e, e77, zero, cap = _case("nlen_edges", 4, C)[4].tolist()
    assert 0 < e < C and e % arf.K2_CHUNK == 0
    assert e77 == e + 77 and e77 % 128 != 0
    assert (zero, cap) == (0, C)
    assert (_case("full", 2, C)[4] == C).all()
    # the smaller size fits the ring: no column reads the bit row
    small = [torch.from_numpy(a) for a in _case("full", 2, SIZES[0])]
    assert arf.range_apply_ring_misses(small[2], small[4]) == 0


def test_ring_misses_follow_the_ring_by_hand():
    """One row, a run of n at column 0 then no more: column d >= n reads
    d - n, which is outside the ring when it lies left of the ring's start
    for d's chunk; counted against a Python loop."""
    C, n = 3 * arf.K2_RING, arf.K2_RING + 300
    ind = torch.zeros((1, C), dtype=torch.int32)
    ind[0, 0], ind[0, n] = 1, -1
    for nl in (C, C - 1000, n + 5, 0):
        want = 0
        for d in range(n, nl):
            base = d // arf.K2_CHUNK * arf.K2_CHUNK
            want += d - n < base + arf.K2_CHUNK - arf.K2_RING
        new_len = torch.tensor([nl], dtype=torch.int32)
        assert arf.range_apply_ring_misses(ind, new_len) == want


@settings(max_examples=60, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1), C=st.integers(1, 4096),
       density=st.floats(0.0, 1.0), wide=st.booleans())
def test_source_never_decreases_and_steps_by_at_most_one(seed, C, density,
                                                         wide):
    """On arbitrary ind_d (random int32s at random columns, any sign and
    size, wrapping prefixes included), d - cnt[d] never decreases and grows
    by at most one a column: the invariant K2's ring relies on."""
    rng = np.random.default_rng(seed)
    hi = 2**31 if wide else 4
    ind = np.where(rng.random((2, C)) < density,
                   rng.integers(-hi, hi, (2, C)), 0).astype(np.int32)
    run = torch.cumsum(torch.from_numpy(ind), dim=1, dtype=torch.int32) > 0
    cnt = torch.cumsum(run.to(torch.int32), dim=1, dtype=torch.int32)
    src = torch.arange(C, dtype=torch.int32) - cnt
    step = torch.diff(src, dim=1)
    assert bool(((step == 0) | (step == 1)).all())
    assert bool((src <= torch.arange(C)).all())


def test_range_apply_checks_spills():
    doc = torch.full((2, 256), 2, dtype=torch.int32)
    z = torch.zeros_like(doc)
    nl = torch.tensor([0, 256], dtype=torch.int32)
    with pytest.raises(ValueError, match="spills"):
        arf.range_apply(doc, z, z, z, nl, DSH,
                        spills=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="spills"):
        arf.range_apply(doc, z, z, z, nl, DSH,
                        spills=torch.zeros(2, dtype=torch.int64))
    spills = torch.full((1,), 5, dtype=torch.int64)
    launches = arf.range_apply.launches
    out, cv, vt = arf.range_apply(doc, z, z, z, nl, DSH, spills=spills)
    assert arf.range_apply.launches == launches  # the plain version ran
    assert int(spills) == 5 and (out[0] == 2).all()
