"""K4 (the serve macro apply) on its worst cases, and its launch geometry.

The worst cases (``bench/k4_cases.py``: inserts at 0 in every round, one
delete spanning the whole document, rows that end exactly at capacity,
random rounds), made with numpy from a seed and resolved by the port's
per-row resolve (K1's per-row form, its plain version on the CPU), go
through the port's ``serve_macro_plain`` (what K4 is held to on the card)
and the JAX package's ``serve_macro_fused`` under the Pallas interpreter
(as its own tests run it) and ``serve_macro_rounds_xla``: exact integer
equality (tolerance 0, every output is an integer).  They are the cases
``chip_smoke.py`` holds the kernel to on the card (``[k4 worst]``), at CPU
sizes.  ``serve_macro_geometry`` is pinned for every (class, tier) of the
serve/mixed/4096 cell and for capacities beyond the shared-memory reach.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops import serve_fused as SF
from crdt_benches_tpu.ops.apply2 import PackedState as JaxPackedState
from crdt_benches_tpu_torch.bench.k4_cases import CASES, worst_rounds
from crdt_benches_tpu_torch.ops import serve_fused as PF
from crdt_benches_tpu_torch.ops.apply2 import PackedState
from crdt_benches_tpu_torch.ops.resolve_range import resolve_range_rows
from crdt_benches_tpu_torch.traces.tensorize import INSERT

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("K,R,B,C", [(8, 3, 8, 1152), (5, 1, 12, 1024)],
                         ids=["K8-R3-B8-C1152", "K5-R1-B12-C1024"])
@pytest.mark.parametrize("name", CASES)
def test_worst_case_plain_equals_jax_interpreted_kernel(name, K, R, B, C):
    doc, length, nvis, *ops = worst_rounds(name, K, R, B, C, seed=C + K)
    tokens, dints, _ = resolve_range_rows(*map(_t, ops), _t(nvis))
    state = PackedState(_t(doc), _t(length), _t(nvis))
    got = PF.serve_macro_plain(state, tokens, dints)
    inputs = PF.serve_round_inputs(tokens, dints, state.length, state.nvis)
    newlen = inputs[5].numpy()
    assert newlen.max() <= C
    if name == "full":
        assert (newlen[-1] == C).all()
    # JAX's roll cascade is exact while 2^nbits exceeds a round's inserts
    n_ins = np.where(ops[0] == INSERT, ops[2], 0).sum(2).max()
    nbits = max(1, int(n_ins).bit_length())
    jstate = JaxPackedState(*(jnp.asarray(a) for a in (doc, length, nvis)))
    jtok = tuple(jnp.asarray(t.numpy()) for t in tokens)
    jdi = tuple(jnp.asarray(d.numpy()) for d in dints)
    want_k4 = SF.serve_macro_fused(jstate, jtok, jdi, nbits=nbits,
                                   interpret=True)
    want_xla = SF.serve_macro_rounds_xla(jstate, jtok, jdi, nbits)
    for f in ("doc", "length", "nvis"):
        for want in (want_k4, want_xla):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


#: serve/mixed/4096's capacity classes and their bucket rows.
SERVE_CLASSES = {256: 2048, 1024: 512, 4096: 128, 8192: 32, 49152: 16}


def _tiers(rows):
    """``DocPool.tiers``: factor-4 steps down from the bucket's rows."""
    out = [rows]
    while out[-1] > 4:
        out.append(max(out[-1] // 4, 4))
    return out


def _check_geometry(Rt, C, max_cluster=PF.MAX_CLUSTER, **card):
    n, width, smem, resident = PF.serve_macro_geometry(Rt, C, max_cluster,
                                                       **card)
    assert width % 128 == 0 and n * width >= C > (n - 1) * width
    assert 1 <= n <= min(16, max_cluster)
    assert smem <= card.get("smem_limit", PF.SMEM_LIMIT)
    assert PF.SMEM_LIMIT == 232_448
    reach = PF.max_slice(card.get("smem_limit", PF.SMEM_LIMIT))
    assert resident == (C <= max_cluster * reach)
    # each block's part of a device-memory scratch starts 16-byte aligned
    assert PF._slice_ints(width) % 4 == 0
    if C <= 1024:
        assert n == 1
    return n, width, smem, resident


@pytest.mark.parametrize("C,Rt", [(C, Rt) for C, rows in SERVE_CLASSES.items()
                                  for Rt in _tiers(rows)])
def test_geometry_of_every_serve_class_and_tier(C, Rt):
    n, width, smem, resident = _check_geometry(Rt, C)
    assert resident and smem == PF.STATIC_SMEM + 4 * (
        PF._slice_ints(width) + n * (width // 128))
    if C > 1024 and n < PF.MAX_CLUSTER:
        # the cluster stops growing at the SM count or the narrowest slice
        assert Rt * n >= PF.SM_COUNT or width < 2 * PF.MIN_SLICE


def test_geometry_of_the_widest_tiers():
    got = {C: PF.serve_macro_geometry(rows, C)[:2]
           for C, rows in SERVE_CLASSES.items()}
    assert got == {256: (1, 256), 1024: (1, 1024), 4096: (2, 2048),
                   8192: (8, 1024), 49152: (16, 3072)}
    # one cluster at Rt = 1; C = 1152 cuts into 640 + 512 columns
    assert PF.serve_macro_geometry(1, 49152)[:2] == (16, 3072)
    assert PF.serve_macro_geometry(1, 1152)[:2] == (2, 640)


@pytest.mark.parametrize("max_cluster", [16, 8])
def test_geometry_beyond_the_shared_memory_reach(max_cluster):
    reach = max_cluster * PF.MAX_SLICE
    assert PF.MAX_SLICE == 11_136
    for C in (reach - 128, reach):
        assert _check_geometry(4, C, max_cluster)[3]
    for C in (reach + 128, 180_352, 262_144, 1_048_576):
        n, width, smem, resident = _check_geometry(4, C, max_cluster)
        assert not resident and n == max_cluster
        assert smem == PF.STATIC_SMEM + 4 * n * (width // 128)


def test_slice_ints_are_whole_int4s_for_every_width():
    # slices whose group count is not a multiple of 4 (C = 180,352 cuts
    # into 16 slices of 89 groups) are padded to a multiple of 4 ints
    assert PF.serve_macro_geometry(2, 180_352)[:2] == (16, 11_392)
    for width in range(128, 1 << 17, 128):
        ints = PF._slice_ints(width)
        assert ints % 4 == 0
        assert 0 <= ints - (5 * width + width // 32 + width // 128) < 4


@pytest.mark.parametrize("sm_count,smem_limit", [(114, 232_448),
                                                 (132, 101_376)],
                         ids=["114-SMs", "99KB-smem"])
def test_geometry_follows_the_card(sm_count, smem_limit):
    card = dict(sm_count=sm_count, smem_limit=smem_limit)
    for C, rows in SERVE_CLASSES.items():
        for Rt in _tiers(rows):
            n, width, _, _ = _check_geometry(Rt, C, **card)
            if C > 1024 and n < PF.MAX_CLUSTER:
                assert Rt * n >= sm_count or width < 2 * PF.MIN_SLICE
    reach = PF.max_slice(smem_limit)
    assert reach < PF.MAX_SLICE if smem_limit < PF.SMEM_LIMIT else (
        reach == PF.MAX_SLICE)
    assert not _check_geometry(4, 16 * reach + 128, **card)[3]
