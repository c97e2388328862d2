"""K3, the fused range apply split across blocks, on its worst cases, and
the rule that picks it over K2.

The worst cases (``bench/k3_cases.py``: a paste wider than a block at
column 0, a delete over many blocks, runs across block edges, new lengths
on a block edge, inside a tile, at 0 and at C, ragged capacities, R = 1
and 3, run depth 2 and random operands), made with numpy from a seed, go
through the port's ``range_apply_plain`` (what K3 is held to on the card)
and ``range_apply_blocked`` (its plain version on the CPU), and through the
JAX package's ``range_fused_blocked`` under the Pallas interpreter (block
of 8 tiles, as ``tests/test_torch_apply_range.py`` runs it) and
``range_fused_xla``: exact integer equality (tolerance 0, every output is
an integer; ``cv_intile`` — bf16 in JAX, int16 in the port — compared by
value).  They are the cases ``chip_smoke.py`` holds the kernel to on the
card (``[k3 worst]``), at CPU sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops.apply_range_fused import (
    apply_range_batch4 as jax_apply4,
)
from crdt_benches_tpu.ops.apply_range_fused import (
    range_fused_blocked,
    range_fused_xla,
)
from crdt_benches_tpu.ops.apply2 import init_state4 as jax_init_state4
from crdt_benches_tpu.ops.resolve_range_scan import resolve_ranges_shared
from crdt_benches_tpu.traces import load_testing_data as jax_load
from crdt_benches_tpu.traces.tensorize import (
    tensorize_ranges as jax_tensorize_ranges,
)
from crdt_benches_tpu_torch.bench.k3_cases import (
    CASES,
    DSH,
    k3_case,
    max_holes,
)
from crdt_benches_tpu_torch.ops import apply_range_fused as arf
from crdt_benches_tpu_torch.ops.apply2 import init_state4
from crdt_benches_tpu_torch.ops.resolve_range import resolve_range
from crdt_benches_tpu_torch.traces import load_testing_data, tensorize_ranges
from crdt_benches_tpu_torch.utils.convert import state4_to_numpy

#: The H100's SM count.
H100_SMS = 132


def _shapes():
    for C in (1152, 4096):
        for name in CASES:
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
def test_worst_case_plain_equals_jax_blocked_kernel(name, R, C):
    ops = k3_case(name, R, C, span=1024, seed=C + R)
    assert ops[0].shape == (R, C) and ops[4].shape == (R,)
    tops = [torch.from_numpy(a) for a in ops]
    got = arf.range_apply_plain(*tops, DSH)
    _assert_equal(arf.range_apply_blocked(*tops, DSH), got)
    # JAX's roll cascade is exact while 2^nbits exceeds every hole count
    nbits = max(1, max_holes(ops[2]).bit_length())
    jops = [jnp.asarray(a) for a in ops]
    _assert_equal(got, range_fused_blocked(
        *jops, nbits=nbits, dsh=DSH, block_tiles=8, interpret=True))
    _assert_equal(got, range_fused_xla(*jops, nbits=nbits, dsh=DSH))


def test_cases_reach_what_they_name():
    """The cases hold what their names promise at the test sizes."""
    ops = {n: k3_case(n, 2 if n != "nlen_edges" else 4, 4096, 1024,
                      seed=4098) for n in CASES}
    run = lambda n: np.cumsum(ops[n][2].astype(np.int64), axis=1)
    assert (run("depth2").max() >= 2) and (run("noise").min() < 0)
    assert ops["nlen_edges"][4].tolist() == [2048, 2125, 0, 4096]
    assert (ops["full"][4] == 4096).all()
    paste = ops["paste"][2]
    assert paste[:, 0].tolist() == [1, 1] and max_holes(paste) > 1024


@pytest.mark.parametrize("R,C,blocked", [
    (1, 183_296, True), (2, 183_296, True), (8, 183_296, True),
    (64, 183_296, True), (80, 183_296, True), (84, 183_296, True),
    (88, 183_296, True), (96, 183_296, False), (128, 183_296, False),
    (256, 183_296, False), (1024, 183_296, False), (4096, 183_296, False),
    (2, 1 << 20, True),
])
def test_takes_blocked_at_the_h100_shapes(R, C, blocked):
    """The dispatch rule at the shapes ``chip_smoke.py`` compares K3 and K2
    on (``[k3 vs k2]``), for the H100's 132 SMs: K3 wins up to 88 rows,
    K2 from 96 on (on automerge-paper's batch 3 and on full rows)."""
    assert arf.range_apply_takes_blocked(R, C, H100_SMS) is blocked


def test_takes_blocked_follows_the_sm_count():
    for sms in (66, 132, 264):
        last = (7 * sms - 1) // 10  # the most rows K3 takes: R < 0.7 sms
        for C in (128, 183_296, 1 << 20):
            assert arf.range_apply_takes_blocked(last, C, sms)
            assert not arf.range_apply_takes_blocked(last + 1, C, sms)


def test_range_apply_blocked_checks_inputs():
    doc = torch.full((2, 256), 2, dtype=torch.int32)
    z = torch.zeros_like(doc)
    nl = torch.zeros(2, dtype=torch.int32)
    f = arf.range_apply_blocked
    with pytest.raises(ValueError, match="multiple of 128"):
        f(doc[:, :200], z[:, :200], z[:, :200], z[:, :200], nl, 14)
    with pytest.raises(ValueError, match="int32"):
        f(doc, z.long(), z, z, nl, 14)
    with pytest.raises(ValueError, match="contiguous"):
        f(doc, z.t().contiguous().t(), z, z, nl, 14)
    with pytest.raises(ValueError, match="new_len"):
        f(doc, z, z, z, nl[:1], 14)
    with pytest.raises(ValueError, match="ind_d"):
        f(doc, z, z[:1], z, nl, 14)
    launches, calls = f.launches, arf.range_apply_plain.calls
    out, cv, vt = f(doc, z, z, z, nl, 14)
    assert f.launches == launches  # a CPU tensor runs the plain version
    assert arf.range_apply_plain.calls == calls + 1
    assert out.dtype == torch.int32 and cv.dtype == torch.int16
    assert vt.shape == (2, 2) and (out == 2).all() and (vt == 0).all()


def test_dispatch_on_cpu_runs_the_plain_version():
    ops = [torch.from_numpy(a) for a in k3_case("mixed", 3, 1152, 1024, 7)]
    counts = (arf.range_apply.launches, arf.range_apply_blocked.launches)
    calls = arf.range_apply_plain.calls
    _assert_equal(arf.range_apply_dispatch(*ops, DSH),
                  arf.range_apply_plain(*ops, DSH))
    assert arf.range_apply_plain.calls == calls + 2
    assert (arf.range_apply.launches,
            arf.range_apply_blocked.launches) == counts


def test_apply_range_batch4_walk_matches_jax_sveltecomponent():
    """sveltecomponent at R = 1, batch 1536, every batch: the port's
    resolve and apply_range_batch4 (through the dispatch) against JAX's
    resolve and apply_range_batch4, state by state, field by field."""
    rt = tensorize_ranges(load_testing_data("sveltecomponent"), batch=1536,
                          coalesce=True)
    jrt = jax_tensorize_ranges(jax_load("sveltecomponent"), batch=1536,
                               coalesce=True)
    C = -(-rt.capacity // 1024) * 1024
    nbits = max(1, rt.max_batch_ins.bit_length())
    pst = init_state4(1, C, len(rt.init_chars), device="cpu")
    jst = jax_init_state4(1, C, len(jrt.init_chars))
    t = torch.as_tensor
    for i, (ops, jops) in enumerate(zip(zip(*rt.batched()),
                                        zip(*jrt.batched()))):
        for a, b in zip(ops, jops):
            np.testing.assert_array_equal(a, b)
        tokens, dints, _ = resolve_range(*map(t, ops), pst.nvis)
        pst = arf.apply_range_batch4(pst, tokens, dints)
        jtok, jdi, _ = resolve_ranges_shared(
            *(jnp.asarray(a) for a in jops), jst.nvis)
        jst = jax_apply4(jst, jtok, jdi, nbits=nbits)
        got = state4_to_numpy(pst)
        for f in ("doc", "cv_intile", "vis_tile", "length", "nvis"):
            want = np.asarray(getattr(jst, f)).astype(np.float32)
            np.testing.assert_array_equal(got[f], want.astype(np.int64),
                                          err_msg=f"batch {i} {f}")
    assert i == rt.n_batches - 1
