"""K1's worst cases on the CPU: the port's plain range resolvers held
against the JAX package's (the Pallas kernel under the interpreter, the
vmapped scan for the per-row form) with exact equality (tolerance 0:
every output is an integer), and pins of what the kernel's live-list
design leans on, checked on the plain version and the token walk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops.resolve_range_pallas import resolve_range_pallas
from crdt_benches_tpu.ops.resolve_range_scan import resolve_ranges_rows
from crdt_benches_tpu.ops.serve_fused import round_starts as jax_round_starts
from crdt_benches_tpu.traces.tensorize import (
    DELETE,
    INSERT,
    PAD,
    tensorize_ranges,
)
from crdt_benches_tpu_torch.ops.resolve import FREE, RUN
from crdt_benches_tpu_torch.ops.resolve_range import (
    range_smem_bytes,
    range_token_walk,
    resolve_range,
    resolve_range_plain,
    resolve_range_rows,
)

_rows = jax.jit(resolve_ranges_rows)
#: The worst cases (each also a ``[k1 worst]`` batch of ``chip_smoke.py``,
#: at B = 1536 there): inserts at 0 move the whole live list every op;
#: deletes at 0 clamp the whole tail and run past the end of a short
#: document; inserts at alternating ends land on the FREE sentinel every
#: other op; scattered inserts split the document into ~B runs that one
#: final delete spans (the longest reduction); a PAD tail; and
#: automerge-paper's batch 3 with its true v0.
WORST = ("ins_at_0", "del_at_0", "alternate", "span", "pad_tail", "trace")


@pytest.fixture(scope="module")
def paper_batches(automerge_trace):
    """automerge-paper's range batches at B = 32 and 64: batch 3's ops and
    the visible length before it."""
    out = {}
    for B in (32, 64):
        rt = tensorize_ranges(automerge_trace, batch=B, coalesce=True)
        kind_b, pos_b, rlen_b, slot_b = rt.batched()
        delta = (np.where(kind_b == INSERT, rlen_b, 0).sum(1)
                 - np.where(kind_b == DELETE, rlen_b, 0).sum(1))
        v = len(rt.init_chars) + int(delta[:3].sum())
        out[B] = (kind_b[3], pos_b[3], rlen_b[3], slot_b[3], v)
    return out


def _worst(name, B, paper):
    """(kind, pos, rlen, slot0 int32[B], v0 int32[4]) of a worst case: v0
    is the case's own length (1000, or the trace's), then 0, 7 and 300."""
    rng = np.random.default_rng(B)
    kind = np.full(B, INSERT, np.int32)
    pos = np.zeros(B, np.int32)
    rlen = rng.integers(1, 9, B).astype(np.int32)
    v = 1000
    if name in ("trace", "pad_tail"):
        kind, pos, rlen, slot0, v = (np.array(a) for a in paper[B])
        if name == "pad_tail":
            kind[B // 4:] = PAD
            for a in (pos, rlen, slot0):
                a[B // 4:] = 0
    elif name == "del_at_0":
        kind[:] = DELETE
        rlen = rng.integers(1, 5, B).astype(np.int32)
    elif name == "alternate":
        pos[1::2] = 10**6  # clamps to the end: the sentinel
    elif name == "span":
        pos = rng.integers(1, v, B).astype(np.int32)
        kind[-1], pos[-1], rlen[-1] = DELETE, 0, 10**6
    if name not in ("trace", "pad_tail"):
        slot0 = (v + np.cumsum(rlen) - rlen).astype(np.int32)
    v0 = np.array([int(v), 0, 7, 300], np.int32)
    return (kind.astype(np.int32), pos.astype(np.int32),
            rlen.astype(np.int32), slot0.astype(np.int32), v0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _plain(case):
    tokens, dints, nused = resolve_range_plain(*(_t(a) for a in case))
    return [x.numpy() for x in (*tokens, *dints, nused)]


@pytest.mark.parametrize("B", [32, 64])
@pytest.mark.parametrize("name", WORST)
def test_plain_matches_pallas_interpret(name, B, paper_batches):
    case = _worst(name, B, paper_batches)
    want = resolve_range_pallas(*(jnp.asarray(a) for a in case),
                                interpret=True)
    got = _plain(case)
    for g, w in zip(got, (*want[0], *want[1], want[2])):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("B", [32, 64])
def test_rows_plain_matches_jax_rows(B, paper_batches):
    """One row per worst case (v0 its own length), two rounds: the case's
    batch, then the same ops again from the total it left; against the
    vmapped scan per round, and the starts against JAX's round_starts."""
    cases = [_worst(n, B, paper_batches) for n in WORST]
    ops = [np.stack([np.stack([c[i] for c in cases])] * 2) for i in range(4)]
    v0 = np.array([c[4][0] for c in cases], np.int32)
    toks, dints, starts = resolve_range_rows(*(_t(a) for a in ops), _t(v0))
    want_starts = np.asarray(jax_round_starts(*ops[:3], v0))
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    W = 2 * B + 2
    for k in range(2):
        t_ref, d_ref, _ = _rows(*(jnp.asarray(o[k]) for o in ops),
                                jnp.asarray(want_starts[k]))
        for g, w in zip(toks, t_ref):
            np.testing.assert_array_equal(g[k, :, :W].numpy(), np.asarray(w))
            assert (g[k, :, W:] == 0).all()
        for g, w in zip(dints, d_ref):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w))


@pytest.mark.parametrize("B", [32, 64])
@pytest.mark.parametrize("name", WORST)
def test_live_list_pins(name, B, paper_batches):
    """What the kernel's live-list body leans on: at most 2B + 1 tokens in
    use, token nused FREE at the visible total and everything past it
    (FREE, 0, 0, 0) (the kernel writes those without reading its list);
    the token walk's final list, total and demand equal the plain
    version's."""
    case = _worst(name, B, paper_batches)
    ttype, ta, tch, tlen, _, _, _, nused = _plain(case)
    w = range_token_walk(*(_t(a) for a in case[:3]), _t(case[4]))
    np.testing.assert_array_equal(np.diff(w.cum.numpy(), prepend=0), tlen)
    np.testing.assert_array_equal(w.nused[:, -1].numpy(), nused[:, 0])
    cum = np.cumsum(tlen, 1)
    for r in range(len(case[4])):
        n = int(nused[r, 0])
        assert n <= 2 * B + 1, name
        assert ttype[r, n] == FREE and cum[r, n] == int(w.total[r]), name
        for a in (ttype, ta, tch, tlen):
            assert (a[r, n:] == 0).all(), name


@pytest.mark.parametrize("B", [32, 64])
@pytest.mark.parametrize("name", WORST)
def test_walk_and_delete_spans_agree_with_plain(name, B, paper_batches):
    """Op by op, from the plain version's list after the ops before it:
    the walk's token t = min(#(cum <= p), nused), its tokens in use and
    its tail nused - t; an op that changes nothing has t = -1; and every
    pre-clamp RUN token a delete overlaps lies in [t, nused), the range
    the kernel walks."""
    kind, pos, rlen, slot0, v0 = _worst(name, B, paper_batches)
    w = range_token_walk(_t(kind), _t(pos), _t(rlen), _t(v0))
    for j in range(B):
        ttype, _, _, tlen, _, _, _, nused = _plain(
            (kind[:j], pos[:j], rlen[:j], slot0[:j], v0))
        np.testing.assert_array_equal(w.nused[:, j].numpy(), nused[:, 0])
        cum = np.cumsum(tlen, 1)
        total = cum[:, -1]
        p = np.minimum(max(int(pos[j]), 0), total)
        D = np.where(kind[j] == DELETE,
                     np.minimum(max(int(rlen[j]), 0), total - p), 0)
        acts = ((kind[j] == INSERT) & (rlen[j] > 0)) | (D > 0)
        t = np.minimum((cum <= p[:, None]).sum(1), nused[:, 0])
        np.testing.assert_array_equal(w.t[:, j].numpy(),
                                      np.where(acts, t, -1), err_msg=name)
        np.testing.assert_array_equal(
            w.tail[:, j].numpy(), np.where(acts, nused[:, 0] - t, 0))
        pre = cum - tlen
        ov = ((ttype == RUN)
              & (np.minimum(cum, (p + D)[:, None])
                 > np.maximum(pre, p[:, None])))
        for r in np.nonzero(D > 0)[0]:
            idx = np.nonzero(ov[r])[0]
            assert ((idx >= t[r]) & (idx < nused[r, 0])).all(), (name, j, r)


def test_kernel_shared_memory_range():
    """The wrapper's range check follows the kernel's layout: up to four
    warps a block, each with a (tta, tch, cum) list of T + 1 ints per
    field; the headline and the fleet's batch fit, and a batch whose one
    list passes 227 KB is refused on every device."""
    assert range_smem_bytes(3200) == 4 * 3 * 3201 * 4 == 153648  # B = 1536
    assert range_smem_bytes(256) == 4 * 3 * 257 * 4 == 12336  # B = 64
    assert range_smem_bytes(19328) == 3 * 19329 * 4 <= 232448
    assert range_smem_bytes(19456) > 232448
    z = torch.zeros(9700, dtype=torch.int32)  # T = 19,456
    v0 = torch.zeros(2, dtype=torch.int32)
    calls = resolve_range_plain.calls
    with pytest.raises(ValueError, match="shared-memory"):
        resolve_range(z, z, z, z, v0)
    with pytest.raises(ValueError, match="shared-memory"):
        resolve_range_rows(*(z.view(1, 1, -1),) * 4, v0[:1])
    assert resolve_range_plain.calls == calls
