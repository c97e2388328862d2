"""The port's downstream update apply (``engine/downstream.py``) on the
CPU, held against the JAX package with exact equality: generated updates
field by field (positional form included), the v5 state (doc, snap,
length, nvis) after every epoch, the final v3 and v1 states, the v1 unit
replay and its collecting twin; and every engine decoded against the
oracle byte for byte."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine import downstream as jd
from crdt_benches_tpu.engine.replay import ReplayEngine as JaxReplayEngine
from crdt_benches_tpu.engine.replay import (
    replay_batches_collect as jax_collect,
)
from crdt_benches_tpu.engine.replay import replay_batches_r
from crdt_benches_tpu.ops.apply import init_state as jax_init_state
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces import loader as jax_loader
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu.traces.tensorize import tensorize as jax_tensorize
from crdt_benches_tpu_torch.engine import downstream as pd
from crdt_benches_tpu_torch.engine.replay import (
    ReplayEngine,
    replay_batches_collect,
    replay_units,
)
from crdt_benches_tpu_torch.ops import expand
from crdt_benches_tpu_torch.ops.apply import init_state
from crdt_benches_tpu_torch.traces import loader as port_loader
from crdt_benches_tpu_torch.traces.tensorize import tensorize

_UPD_FIELDS = ("ins_slot", "anchor", "rank", "dslot", "ins_gap", "del_pos",
               "chars")


def _trace(seed, n_ops=400, base="downstream parity "):
    tr = synth_trace(seed=seed, n_ops=n_ops, base=base)
    return dataclasses.replace(tr, end_content=replay_trace(tr))


def _eq_fields(pst, jst, fields, msg):
    for f in fields:
        np.testing.assert_array_equal(
            getattr(pst, f).numpy(), np.asarray(getattr(jst, f)),
            err_msg=f"{msg} field {f}")


def _eq_updates(pu, ju):
    for f in _UPD_FIELDS:
        np.testing.assert_array_equal(getattr(pu, f), getattr(ju, f),
                                      err_msg=f)
    for f in ("capacity", "n_init", "end_content", "n_patches"):
        assert getattr(pu, f) == getattr(ju, f), f
    assert pu.nbytes("v5") == ju.nbytes("v5")
    assert pu.nbytes("v3") == ju.nbytes("v3")


@pytest.mark.parametrize("seed,batch", [(0, 16), (1, 32)])
def test_generate_updates_matches_jax(seed, batch):
    tr = _trace(seed)
    _eq_updates(pd.generate_updates(tensorize(tr, batch), device="cpu"),
                jd.generate_updates(jax_tensorize(tr, batch)))


def test_generate_updates_matches_jax_on_a_sveltecomponent_prefix(
        svelte_trace):
    """The first 24 patches (18 batches of 64 unit ops)."""
    def cut(tr, mod):
        patches = list(tr.iter_patches())[:24]
        return mod.TestData(tr.start_content, "", [mod.TestTxn("", patches)])

    ptrace = port_loader.load_testing_data("sveltecomponent")
    tt = tensorize(cut(ptrace, port_loader), 64)
    assert tt.n_batches >= 10
    _eq_updates(pd.generate_updates(tt, device="cpu"),
                jd.generate_updates(
                    jax_tensorize(cut(svelte_trace, jax_loader), 64)))


@pytest.mark.parametrize("seed", [0, 3])
def test_v5_matches_jax_epoch_by_epoch(seed):
    """R = 2, B = 32, epoch 4: doc, snap, length and nvis equal after every
    epoch (the last one shorter); both replicas decode to the oracle."""
    tr = _trace(seed)
    B, R, epoch = 32, 2, 4
    peng = pd.DownstreamEngine(tensorize(tr, B), n_replicas=R, epoch=epoch,
                               device="cpu")
    u = peng.upd
    assert u.ins_slot.shape[0] % epoch  # a short last epoch is covered
    nbits = max(1, B.bit_length())
    jst = jd.down_packed_init(R, u.capacity, u.n_init)
    pst = peng.init_state()
    _eq_fields(pst, jst, pd.DownPacked._fields, "fresh")
    wire = (u.ins_slot, u.anchor, u.rank, u.dslot)
    for e0 in range(0, u.ins_slot.shape[0], epoch):
        part = [a[e0:e0 + epoch] for a in wire]
        jst = jd.apply_updates5(jst, *map(jnp.asarray, part), nbits=nbits,
                                epoch=epoch)
        pst = pd.apply_updates5(pst, *map(torch.as_tensor, part),
                                epoch=epoch)
        _eq_fields(pst, jst, pd.DownPacked._fields, f"epoch at {e0}")
    assert peng.decode(pst, 0) == peng.decode(pst, 1) == tr.end_content


@pytest.mark.parametrize("engine", ["v3", "v1"])
def test_v3_v1_final_states_match_jax(engine):
    tr = _trace(5)
    jeng = jd.JaxDownstreamEngine(jax_tensorize(tr, 32), n_replicas=2,
                                  engine=engine)
    peng = pd.DownstreamEngine(tensorize(tr, 32), n_replicas=2,
                               engine=engine, device="cpu")
    jst, pst = jeng.run(), peng.run()
    _eq_fields(pst, jst, pst._fields, engine)
    assert peng.decode(pst, 0) == peng.decode(pst, 1) == tr.end_content


_SMALL = {
    # an insert deleted in its own batch must tombstone
    "same_batch_insert_delete": (
        [1, 1, 1, 2, 1, 2, 1, 1], [0, 1, 2, 1, 1, 2, 0, 4], ""),
    "start_content": ([1, 2, 1, 2], [3, 0, 5, 1], "hello"),
    "head_inserts": ([1, 1, 1, 1], [0, 0, 0, 0], ""),
}


@pytest.mark.parametrize("engine", ["v5", "v3", "v1"])
@pytest.mark.parametrize("case", list(_SMALL))
def test_small_streams_decode_to_the_oracle(case, engine):
    kinds, poss, start = _SMALL[case]
    patches = [jax_loader.TestPatch(p, 1, "") if k == 2 else
               jax_loader.TestPatch(p, 0, "abcdefgh"[i])
               for i, (k, p) in enumerate(zip(kinds, poss))]
    tr = jax_loader.TestData(start, "", [jax_loader.TestTxn("", patches)])
    want = replay_trace(tr)
    eng = pd.DownstreamEngine(tensorize(tr, 8), n_replicas=3, engine=engine,
                              device="cpu")
    st = eng.run()
    assert [eng.decode(st, r) for r in range(3)] == [want] * 3
    assert st.nvis.tolist() == [len(want)] * 3


def test_backend_and_dispatch_on_the_cpu():
    tr = _trace(2, n_ops=200)
    before = expand.apply_fused_blocked_plain.calls
    bk = pd.TorchDownstreamBackend(n_replicas=2, batch=32, device="cpu")
    bk.prepare(tr)
    assert bk.NAME == "torch-cpu-r2"
    assert bk.replay_once() == len(tr.end_content)
    assert bk.final_content() == tr.end_content
    # on the CPU the v5 apply runs K7's plain version, once per batch
    assert (expand.apply_fused_blocked_plain.calls - before
            == 2 * bk.engine.n_batches)
    assert pd.TorchDownstreamBackend(engine="v3", device="cpu").NAME == (
        "torch-cpu-pos")
    with pytest.raises(ValueError, match="unknown downstream engine"):
        pd.DownstreamEngine(tensorize(tr, 32), engine="v4", device="cpu")


def _np_state(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def test_collect_replay_matches_jax():
    tr = _trace(6, n_ops=300)
    jt, pt = jax_tensorize(tr, 32), tensorize(tr, 32)
    cap = -(-pt.capacity // 128) * 128
    kind, pos, _, slot = jt.batched()
    jst, jds = jax_collect(jax_init_state(cap, len(jt.init_chars)),
                           *map(jnp.asarray, (kind, pos, slot)))
    pst, pds = replay_batches_collect(
        init_state(1, cap, len(pt.init_chars), device="cpu"),
        *(torch.as_tensor(a) for a in (kind, pos, slot)))
    np.testing.assert_array_equal(pds[:, 0].numpy(), np.asarray(jds))
    want = _np_state(jst)
    for f in pst._fields:
        np.testing.assert_array_equal(getattr(pst, f)[0].numpy(), want[f],
                                      err_msg=f)


def test_unit_v1_engine_matches_jax_scan():
    """The unit ReplayEngine(engine="v1") against the JAX
    replay_batches_r (resolver "scan"), chunk by chunk, every field."""
    tr = _trace(7, n_ops=300, base="unit v1 parity ")
    jeng = JaxReplayEngine(jax_tensorize(tr, 32), n_replicas=2,
                           resolver="scan", chunk=3, engine="v1", pack=1)
    peng = ReplayEngine(tensorize(tr, 32), n_replicas=2, chunk=3,
                        engine="v1", device="cpu")
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape),
                       jax_init_state(peng.capacity, peng.n_init))
    pst = peng.init_state()
    for i, (jch, pch) in enumerate(zip(jeng.chunks, peng.chunks)):
        jst = replay_batches_r(jst, *jch, resolver="scan")
        pst = replay_units(pst, *pch, engine="v1")
        want = _np_state(jst)
        for f in pst._fields:
            np.testing.assert_array_equal(getattr(pst, f).numpy(), want[f],
                                          err_msg=f"chunk {i} field {f}")
    assert peng.decode(pst, 0) == peng.decode(pst, 1) == tr.end_content
    assert (peng.lengths(pst) == len(tr.end_content)).all()


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["v5", "v3", "v1"])
def test_sveltecomponent_downstream_byte_identical(engine):
    trace = port_loader.load_testing_data("sveltecomponent")
    bk = pd.TorchDownstreamBackend(n_replicas=1, batch=512, engine=engine,
                                   device="cpu")
    bk.prepare(trace)
    assert bk.replay_once() == len(trace.end_content)
    assert bk.final_content() == trace.end_content
