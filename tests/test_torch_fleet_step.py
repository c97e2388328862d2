"""The unit-op fleet step of the port against the JAX package's.

- K5's per-row form: ``resolve_batch_rows`` (on the CPU its plain version,
  ``resolve_batch_rows_plain``) against ``jax.vmap(resolve_batch)``, field
  by field, with PAD rows, rows at ``nvis`` 0 and deletes past the end;
- ``apply_batch3`` with (R, B) ``slots`` (one op stream a row) against
  JAX's, which takes both forms;
- ``fleet_step`` against JAX's over several steps of a fleet of docs;
- ``DocPool.step`` on two classes against JAX's ``DocPool.step``: the
  buckets equal after every step, every doc decoding to a list oracle.

Inputs are made with numpy from a seed; the JAX side runs jitted on the
CPU (``fleet_step`` reaches no Pallas call)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops import apply2 as japply
from crdt_benches_tpu.ops.resolve import resolve_batch as jresolve
from crdt_benches_tpu.serve import pool as jpool
from crdt_benches_tpu_torch.ops import apply2 as papply
from crdt_benches_tpu_torch.ops import resolve as presolve
from crdt_benches_tpu_torch.serve import pool as ppool
from crdt_benches_tpu_torch.traces.tensorize import DELETE, INSERT, PAD

_vmapped = jax.jit(jax.vmap(jresolve))


def _random_rows(rng, R, B, v0hi=30):
    """kind/pos int32[R, B] and v0 int32[R]: row 0 all PAD, row 1 at
    nvis 0, positions reaching past the end (deletes there are no-ops)."""
    v0 = rng.integers(0, v0hi, R).astype(np.int32)
    v0[min(1, R - 1)] = 0
    kind = rng.choice([PAD, INSERT, DELETE], size=(R, B),
                      p=[0.15, 0.55, 0.3]).astype(np.int32)
    kind[0] = PAD
    pos = rng.integers(-2, v0hi + B + 2, (R, B)).astype(np.int32)
    return kind, pos, v0


def _same(jres, pres):
    for f in pres._fields:
        want = np.asarray(getattr(jres, f))
        got = getattr(pres, f).numpy()
        assert got.dtype == (np.bool_ if f == "ins_alive" else np.int32), f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("R,B,seed", [(1, 1, 0), (3, 7, 1), (9, 33, 2),
                                      (6, 64, 3), (2, 130, 4)])
def test_resolve_batch_rows_equals_jax_vmap(R, B, seed):
    kind, pos, v0 = _random_rows(np.random.default_rng(seed), R, B)
    want = _vmapped(jnp.asarray(kind), jnp.asarray(pos), jnp.asarray(v0))
    got = presolve.resolve_batch_rows(*map(torch.from_numpy,
                                           (kind, pos, v0)))
    _same(want, got)
    # without origins: an insert's origin -1, any other op's -2
    plain = presolve.resolve_batch_rows_plain(
        *map(torch.from_numpy, (kind, pos, v0)), emit_origin=False)
    np.testing.assert_array_equal(
        plain.origin.numpy(), np.where(kind == INSERT, -1, -2))
    np.testing.assert_array_equal(plain.del_rank.numpy(),
                                  np.asarray(want.del_rank))


def test_rows_form_equals_shared_form_on_identical_rows():
    rng = np.random.default_rng(5)
    kind, pos, v0 = _random_rows(rng, 5, 24)
    shared = presolve.resolve_batch_plain(
        torch.from_numpy(kind[2]), torch.from_numpy(pos[2]),
        torch.from_numpy(v0))
    rows = presolve.resolve_batch_rows(
        torch.from_numpy(np.repeat(kind[2:3], 5, 0)),
        torch.from_numpy(np.repeat(pos[2:3], 5, 0)), torch.from_numpy(v0))
    for f in rows._fields:
        assert torch.equal(getattr(rows, f), getattr(shared, f)), f


def test_resolve_batch_rows_refuses_bad_operands():
    k = torch.zeros((2, 4), dtype=torch.int32)
    v0 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        presolve.resolve_batch_rows(k[0], k[0], v0)
    with pytest.raises(ValueError, match="unsupported device"):
        presolve.resolve_batch_rows(k.to("meta"), k.to("meta"),
                                    v0.to("meta"))
    B = presolve.max_rows_batch()
    assert presolve.unit_rows_smem_bytes(B) <= 232448
    assert presolve.unit_rows_smem_bytes(B + 1) > 232448
    assert presolve.unit_rows_smem_bytes(64) == 10272


def _fleet_state(rng, R, C):
    """R documents, row r with n_init[r] visible chars (one at 0)."""
    n_init = rng.integers(0, C // 4, R).astype(np.int32)
    n_init[min(1, R - 1)] = 0
    doc = np.stack([jpool._fresh_row_np(C, int(n)) for n in n_init])
    return doc, n_init


def _slots(kind, base):
    """Each row's insert slots: its next fresh ids, from ``base[r]``."""
    ins = kind == INSERT
    slot = np.where(ins, base[:, None] + np.cumsum(ins, 1) - 1, -1)
    return slot.astype(np.int32), base + ins.sum(1).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_batch3_with_row_slots_equals_jax(seed):
    rng = np.random.default_rng(seed)
    R, B, C = 6, 16, 256
    doc, n_init = _fleet_state(rng, R, C)
    kind, pos, _ = _random_rows(rng, R, B)
    slot, _ = _slots(kind, n_init.copy())
    jst = japply.PackedState(jnp.asarray(doc), jnp.asarray(n_init),
                             jnp.asarray(n_init))
    pst = papply.PackedState(*map(torch.from_numpy,
                                  (doc, n_init.copy(), n_init.copy())))
    jres = _vmapped(jnp.asarray(kind), jnp.asarray(pos), jst.nvis)
    pres = presolve.resolve_batch_rows(
        torch.from_numpy(kind), torch.from_numpy(pos), pst.nvis)
    want = japply.apply_batch3(jst, jres, jnp.asarray(slot))
    got = papply.apply_batch3(pst, pres, torch.from_numpy(slot))
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # K8 is fed the same operands whichever form the slots take, and a
    # shared stream broadcast to every row gives the shared result
    shared = slot[2]
    a = papply.batch3_operands(pst, pres, torch.from_numpy(shared))
    b = papply.batch3_operands(pst, pres, torch.from_numpy(
        np.repeat(shared[None], R, 0)))
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


def test_fleet_step_equals_jax_over_steps():
    rng = np.random.default_rng(7)
    R, B, C = 8, 24, 512
    doc, n_init = _fleet_state(rng, R, C)
    jst = japply.PackedState(jnp.asarray(doc), jnp.asarray(n_init),
                             jnp.asarray(n_init))
    pst = papply.PackedState(*map(torch.from_numpy,
                                  (doc, n_init.copy(), n_init.copy())))
    keep = pst
    base = n_init.copy()
    for _ in range(3):
        kind, pos, _ = _random_rows(rng, R, B)
        slot, base = _slots(kind, base)
        jst = jpool.fleet_step(jst, *map(jnp.asarray, (kind, pos, slot)))
        pst = ppool.fleet_step(pst, *map(torch.from_numpy,
                                         (kind, pos, slot)))
        for f in pst._fields:
            np.testing.assert_array_equal(getattr(pst, f).numpy(),
                                          np.asarray(getattr(jst, f)), f)
    # written in place (the port's donates): the same tensors throughout
    assert all(a is b for a, b in zip(keep, pst))


def _oracle(text: list[int], kind, pos, chars, slot):
    """Apply one row's unit ops to a codepoint list (the oracle)."""
    for k, p, s in zip(kind.tolist(), pos.tolist(), slot.tolist()):
        p = min(max(p, 0), len(text))
        if k == INSERT:
            text.insert(p, int(chars[s]))
        elif k == DELETE and p < len(text):
            del text[p]
    return text


def _make_docs(rng, n_docs, B, steps):
    docs = []
    for d in range(n_docs):
        # every third doc in the 512 class, the rest in the 128 class
        n_init = (0 if d == 1 else int(rng.integers(140, 300)) if d % 3 == 0
                  else int(rng.integers(1, 60)))
        kinds, poss, slots = [], [], []
        n = n_init
        base = np.array([n_init], np.int32)
        for _ in range(steps):
            k, p, _ = _random_rows(rng, 2, B, v0hi=max(n, 1) + 4)
            k, p = k[1:], p[1:]
            s, base = _slots(k, base)
            kinds.append(k[0])
            poss.append(p[0])
            slots.append(s[0])
            n += int((k == INSERT).sum())
        need = int(base[0])
        chars = rng.integers(97, 123, max(need, 1)).astype(np.int32)
        docs.append(dict(n_init=n_init, need=need, chars=chars,
                         kind=kinds, pos=poss, slot=slots))
    return docs


@pytest.mark.parametrize("mesh", [False, True], ids=["flat", "mesh8"])
def test_docpool_step_equals_jax(tmp_path, mesh):
    """Two classes of a pool in each package, every doc admitted, three
    (R, B) steps a class with idle (PAD) rows and a doc at nvis 0: the
    buckets equal JAX's after every step and every doc decodes to the
    oracle.  ``mesh8``: the port's ``fleet_mesh(8, "cpu")`` against JAX's
    ``replica_mesh(8)``, docs on several shards, each shard stepped on
    its own rows."""
    rng = np.random.default_rng(11)
    classes, B, steps = (128, 512), 16, 3
    slots_n = (16, 8) if mesh else (8, 4)
    docs = _make_docs(rng, 12 if mesh else 9, B, steps)
    kw = dict(classes=classes, slots=slots_n, prefetch=False)
    jkw, pkw = {}, {}
    if mesh:
        from crdt_benches_tpu.parallel.mesh import replica_mesh
        from crdt_benches_tpu_torch.parallel.mesh import fleet_mesh

        jkw, pkw = {"mesh": replica_mesh(8)}, {"mesh": fleet_mesh(8, "cpu")}
    jp = jpool.DocPool(spool_dir=str(tmp_path / "j"), **kw, **jkw)
    pp = ppool.DocPool(spool_dir=str(tmp_path / "p"), device="cpu", **kw,
                       **pkw)
    assert (pp.buckets[128].parts is not None) == mesh
    where = {}
    for i, d in enumerate(docs):
        for pool in (jp, pp):
            pool.register(i, d["n_init"], d["need"], d["chars"])
        got = pp.admit(i, d["need"])
        assert jp.admit(i, d["need"]) == got
        where[i] = got
    texts = {i: [int(c) for c in d["chars"][:d["n_init"]]]
             for i, d in enumerate(docs)}
    for t in range(steps):
        for cls, R in zip(classes, slots_n):
            kind = np.full((R, B), PAD, np.int32)
            pos = np.zeros((R, B), np.int32)
            slot = np.full((R, B), -1, np.int32)
            for i, (c, row) in where.items():
                if c == cls:
                    d = docs[i]
                    kind[row], pos[row] = d["kind"][t], d["pos"][t]
                    slot[row] = d["slot"][t]
                    _oracle(texts[i], kind[row], pos[row], d["chars"],
                            slot[row])
            assert (kind == PAD).all(axis=1).any()  # an idle row
            jp.step(cls, kind, pos, slot)
            pp.step(cls, kind, pos, slot)
            for want, got in zip(jp.pull_bucket(cls), pp.pull_bucket(cls)):
                np.testing.assert_array_equal(got, np.asarray(want))
            assert pp.buckets[cls].steps == jp.buckets[cls].steps == t + 1
    for i in where:
        want = "".join(map(chr, texts[i]))
        assert pp.decode(i) == jp.decode(i) == want
    if mesh:  # the stepped docs sit on several shards of each class
        for cls in classes:
            g = pp.buckets[cls].Rg
            assert len({r // g for c, r in where.values() if c == cls}) > 1
    assert any(not texts[i] or docs[i]["n_init"] == 0 for i in where)
    # the stepped rows, and only they, are dirty
    dirty = pp.take_dirty()
    assert dirty == {c: sorted(r for c2, r in where.values() if c2 == c)
                     for c in classes}
    jp.close()
    pp.close()
