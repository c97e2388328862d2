"""The port's epoch id -> position structure (``ops/idpos.py``) on the CPU,
held against the JAX package's with exact equality — snapshot rebuilds,
levels of unit inserts and of runs (rlen > 1), and queries over several
levels of ids present before the epoch, ids inserted at a level, and
invalid ids — and against a direct list simulation of the documents."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops import idpos as jidpos
from crdt_benches_tpu.ops.apply2 import pack_doc as jax_pack_doc
from crdt_benches_tpu_torch.ops import idpos


def _t(a):
    return torch.as_tensor(np.array(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def _random_batch(rng, docs, B, next_slot, max_run):
    """One batch of insert runs per replica, ``B`` rows (the last ones
    padding): (dest0, rlen, slot0, live) numpy int32[R, B] (live bool),
    the replicas' documents updated in place, and the next free slot."""
    R = len(docs)
    dest0 = np.zeros((R, B), np.int32)
    rlen = np.zeros((R, B), np.int32)
    slot0 = np.full((R, B), -1, np.int32)
    live = np.zeros((R, B), bool)
    for r, doc in enumerate(docs):
        n = int(rng.integers(1, B))
        gaps = np.sort(rng.integers(0, len(doc) + 1, n))
        lens = rng.integers(1, max_run + 1, n)
        d = gaps + np.concatenate([[0], np.cumsum(lens)[:-1]])
        s = next_slot + np.concatenate([[0], np.cumsum(lens)[:-1]])
        next_slot = int(s[-1] + lens[-1])
        order = rng.permutation(B)[:n]  # rows scattered among the padding
        dest0[r, order], rlen[r, order] = d, lens
        slot0[r, order], live[r, order] = s, True
        dest0[r, ~live[r]] = rng.integers(0, 999, (~live[r]).sum())
        for dd, ss, ll in sorted(zip(d.tolist(), s.tolist(), lens.tolist())):
            doc[dd:dd] = list(range(ss, ss + ll))
    return dest0, rlen, slot0, live, next_slot


def _level_eq(plv, jlv, msg):
    for f in jidpos.Level._fields:
        _eq(getattr(plv, f), getattr(jlv, f), f"{msg} field {f}")


@pytest.mark.parametrize("max_run", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_query_over_levels_matches_jax_and_simulation(seed, max_run):
    rng = np.random.default_rng(seed)
    R, B, K, n_init, C = 3, 12, 5, 30, 512
    docs = [list(range(n_init)) for _ in range(R)]
    jsnap = jidpos.snap_init(R, C)
    psnap = idpos.snap_init(R, C, "cpu")
    _eq(psnap, jsnap, "snap_init")
    jlevels, plevels = [], []
    next_slot = n_init
    for k in range(K):
        # ids present before this batch, some inserted at earlier levels,
        # and invalid ids (-1) that callers mask
        ids = np.stack([rng.choice(doc, 2 * B) for doc in docs]).astype(
            np.int32)
        ids[:, :3] = -1
        want = np.asarray(jidpos.query(jsnap, jlevels, jnp.asarray(ids)))
        got = idpos.query(psnap, plevels, _t(ids))
        _eq(got, want, f"query before level {k}")
        for r in range(R):
            for b in range(3, 2 * B):
                assert docs[r][want[r, b]] == ids[r, b]

        dest0, rlen, slot0, live, next_slot = _random_batch(
            rng, docs, B, next_slot, max_run)
        if max_run == 1:
            jlv = jidpos.make_level(jnp.asarray(dest0), jnp.asarray(live),
                                    jnp.asarray(slot0))
            plv = idpos.make_level(_t(dest0), _t(live), _t(slot0))
        else:
            args = (dest0, rlen, slot0, live)
            jlv = jidpos.make_level_runs(*map(jnp.asarray, args))
            plv = idpos.make_level_runs(*map(_t, args))
        _level_eq(plv, jlv, f"level {k}")
        jlevels.append(jlv)
        plevels.append(plv)

        # every slot the batch inserted resolves at once
        new = np.where(live, slot0, -1)
        got = idpos.query(psnap, plevels, _t(new)).numpy()
        _eq(torch.as_tensor(got),
            jidpos.query(jsnap, jlevels, jnp.asarray(new)), f"new {k}")
        for r in range(R):
            for b in np.nonzero(live[r])[0]:
                assert docs[r][got[r, b]] == new[r, b]

    # epoch boundary: rebuild the snapshot from the packed documents
    order = np.full((R, C), -1, np.int32)
    vis = rng.integers(0, 2, (R, C)).astype(np.int32)
    for r, doc in enumerate(docs):
        order[r, : len(doc)] = doc
    packed = np.asarray(jax_pack_doc(jnp.asarray(order), jnp.asarray(vis)))
    jsnap = jidpos.snap_rebuild(jnp.asarray(packed))
    psnap = idpos.snap_rebuild(_t(packed))
    _eq(psnap, jsnap, "snap_rebuild")
    ids = np.stack([rng.choice(doc, B) for doc in docs]).astype(np.int32)
    got = idpos.query(psnap, [], _t(ids)).numpy()
    for r in range(R):
        for b in range(B):
            assert docs[r][got[r, b]] == ids[r, b]


def test_snap_rebuild_leaves_absent_slots_zero():
    doc = np.asarray(jax_pack_doc(jnp.asarray([[4, 3, 0, -1, -1]]),
                                  jnp.asarray([[1, 0, 1, 0, 0]])))
    got = idpos.snap_rebuild(_t(doc))
    _eq(got, jidpos.snap_rebuild(jnp.asarray(doc)))
    assert got.tolist() == [[2, 0, 0, 1, 0]]
