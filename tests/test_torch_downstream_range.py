"""The port's range-granular downstream (``engine/downstream_range.py``)
on the CPU, held against the JAX package with exact equality: the
generated ``RangeUpdates`` field by field, the ``DownPacked`` state after
every epoch and at the end, and each replica decoded against the trace's
oracle byte for byte."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine import downstream as jds
from crdt_benches_tpu.engine import downstream_range as jdr
from crdt_benches_tpu.ops import idpos as jidpos
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces.synth import synth_trace as jsynth_trace
from crdt_benches_tpu_torch.engine import downstream as pds
from crdt_benches_tpu_torch.engine import downstream_range as pdr
from crdt_benches_tpu_torch.ops import expand
from crdt_benches_tpu_torch.ops import idpos as pidpos
from crdt_benches_tpu_torch.traces.synth import synth_trace as psynth_trace

WIRE = ("anchor", "rank", "slot0", "rlen", "alive", "dfirst", "dlast")
STATE = ("doc", "snap", "length", "nvis")


def _traces(seed, n_ops=400, base="range downstream parity "):
    jt = jsynth_trace(seed=seed, n_ops=n_ops, base=base)
    jt = dataclasses.replace(jt, end_content=replay_trace(jt))
    pt = psynth_trace(seed=seed, n_ops=n_ops, base=base)
    return jt, dataclasses.replace(pt, end_content=jt.end_content)


@pytest.mark.parametrize("seed,batch_ops", [(0, 8), (1, 16), (2, 64)])
def test_generate_range_updates_matches_jax(seed, batch_ops):
    jt, pt = _traces(seed)
    ju = jdr.generate_range_updates(jt, batch_ops=batch_ops)
    pu = pdr.generate_range_updates(pt, batch_ops=batch_ops)
    for f in WIRE + ("chars",):
        np.testing.assert_array_equal(getattr(pu, f), getattr(ju, f),
                                      err_msg=f)
    for f in ("capacity", "n_init", "end_content", "n_patches"):
        assert getattr(pu, f) == getattr(ju, f), f
    assert pu.nbytes() == ju.nbytes()
    if seed == 0:  # runs killed in their own batch arrive dead
        assert (pu.alive == 0).any()


def _walk(upd, R, epoch, port):
    """The range apply walked on one side, the state after every epoch."""
    if port:
        t = torch.as_tensor
        st = pds.down_packed_init(R, upd.capacity, upd.n_init, device="cpu")
        apply5, rebuild, kw = (pdr._apply_range_update_batch5,
                               pidpos.snap_rebuild, {})
    else:
        t = jnp.asarray
        st = jds.down_packed_init(R, upd.capacity, upd.n_init)
        nbits = max(1, int(upd.rlen.sum(axis=1).max(initial=1)).bit_length())
        apply5, rebuild, kw = (jdr._apply_range_update_batch5,
                               jidpos.snap_rebuild, {"nbits": nbits})
    doc, snap, length, nvis = st
    N = upd.anchor.shape[0]
    states = []
    for e0 in range(0, N, epoch):
        levels = []
        for i in range(e0, min(e0 + epoch, N)):
            doc, length, nvis, lv = apply5(
                doc, length, nvis, snap, levels,
                *(t(getattr(upd, f)[i]) for f in WIRE), **kw)
            levels.append(lv)
        snap = rebuild(doc)
        states.append({f: np.asarray(x) for f, x in
                       zip(STATE, (doc, snap, length, nvis))})
    return states


@pytest.mark.parametrize("seed,batch_ops,epoch", [(0, 8, 4), (3, 16, 3)])
def test_apply_matches_jax_epoch_by_epoch(seed, batch_ops, epoch):
    jt, pt = _traces(seed)
    upd = pdr.generate_range_updates(pt, batch_ops=batch_ops)
    pst = _walk(upd, 3, epoch, port=True)
    jst = _walk(upd, 3, epoch, port=False)
    assert len(pst) == len(jst) >= 3
    for e, (p, j) in enumerate(zip(pst, jst)):
        for f in STATE:
            np.testing.assert_array_equal(p[f], j[f], err_msg=f"epoch {e} {f}")
    # the engine runs that walk, and matches JAX's engine (which pads the
    # batch count to a multiple of the epoch with no-op rows)
    eng = pdr.RangeDownstreamEngine(pt, n_replicas=3, batch_ops=batch_ops,
                                    epoch=epoch, device="cpu")
    st = eng.run()
    for f in STATE:
        np.testing.assert_array_equal(getattr(st, f).numpy(), pst[-1][f],
                                      err_msg=f)
    jeng = jdr.JaxRangeDownstreamEngine(jt, n_replicas=3,
                                        batch_ops=batch_ops, epoch=epoch)
    jfin = jeng.run()
    for f in STATE:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jfin, f)), err_msg=f)
    assert [eng.decode(st, r) for r in range(3)] == [jt.end_content] * 3


@pytest.mark.parametrize("seed,base", [(4, ""), (5, "x"),
                                       (6, "a longer shared start text ")])
def test_small_streams_decode_to_the_oracle(seed, base):
    _, pt = _traces(seed, n_ops=300, base=base)
    eng = pdr.RangeDownstreamEngine(pt, n_replicas=2, batch_ops=32, epoch=2,
                                    device="cpu")
    st = eng.run()
    assert [eng.decode(st, r) for r in range(2)] == [pt.end_content] * 2
    assert st.nvis.tolist() == [len(pt.end_content)] * 2


def test_backend_runs_k7_plain_once_a_batch():
    _, pt = _traces(7, n_ops=250)
    bk = pdr.TorchRangeDownstreamBackend(n_replicas=2, batch_ops=16,
                                         device="cpu")
    assert bk.NAME == "torch-cpu-r2-range"
    with pytest.raises(RuntimeError, match="prepare"):
        bk.engine
    bk.prepare(pt)
    before = expand.apply_fused_blocked_plain.calls
    assert bk.replay_once() == len(pt.end_content)
    assert (expand.apply_fused_blocked_plain.calls - before
            == bk.engine.n_batches)
    assert bk.final_content() == pt.end_content
    with pytest.raises(ValueError, match="epoch"):
        pdr.RangeDownstreamEngine(pt, epoch=0, device="cpu")
