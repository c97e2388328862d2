"""The port's unit-op replay engine on the CPU, held against the JAX
engine (``resolver="scan"``) field by field after every chunk for the v2,
v3 and v4 applies (exact equality, ``cv_intile`` compared by value), and
against the oracle byte for byte; and the port's unit tensorization
against the JAX package's on the four reference traces."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from crdt_benches_tpu.engine.replay import ReplayEngine as JaxReplayEngine
from crdt_benches_tpu.engine.replay import _grow_state4 as jax_grow
from crdt_benches_tpu.engine.replay import (
    replay_batches_r2,
    replay_batches_r3,
    replay_batches_r4,
)
from crdt_benches_tpu.ops import apply2 as japply2
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces import loader as jax_loader
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu.traces.tensorize import tensorize as jax_tensorize
from crdt_benches_tpu_torch.backends.torch_backend import TorchReplayBackend
from crdt_benches_tpu_torch.engine.replay import (
    ReplayEngine,
    _grow_state4,
    replay_units,
)
from crdt_benches_tpu_torch.traces import loader as port_loader
from crdt_benches_tpu_torch.traces.tensorize import tensorize

_JAX_REPLAY = {"v2": replay_batches_r2, "v3": replay_batches_r3,
               "v4": replay_batches_r4}
_JAX_INIT = {"v2": japply2.init_state2, "v3": japply2.init_state3,
             "v4": japply2.init_state4}


def _np(st) -> dict[str, np.ndarray]:
    return {f: np.asarray(getattr(st, f).astype(jnp.int32))
            for f in st._fields}


@pytest.mark.parametrize("engine", ["v2", "v3", "v4"])
@pytest.mark.parametrize("seed,batch", [(0, 16), (1, 32)])
def test_engine_matches_jax_chunk_by_chunk(engine, seed, batch):
    """R = 2, chunks of 3 batches (v4's staged capacity grows between
    chunks); the JAX engine is driven chunk by chunk as its run() does."""
    trace = synth_trace(seed=seed, n_ops=400, base="unit engine parity ")
    jeng = JaxReplayEngine(jax_tensorize(trace, batch=batch), n_replicas=2,
                           resolver="scan", chunk=3, engine=engine, pack=1)
    peng = ReplayEngine(tensorize(trace, batch=batch), n_replicas=2,
                        chunk=3, engine=engine, device="cpu")
    assert len(peng.chunks) == len(jeng.chunks) >= 3
    if engine == "v4":
        assert peng.stage_caps == jeng.stage_caps
    jst = _JAX_INIT[engine](2, peng.stage_caps[0], jeng.n_init)
    pst = peng.init_state()
    for i, (cap, jch, pch) in enumerate(
        zip(peng.stage_caps, jeng.chunks, peng.chunks)
    ):
        kw = {"token_cap": None} if engine == "v4" else {}
        if engine == "v4":
            jst, pst = jax_grow(jst, cap), _grow_state4(pst, cap)
        jst = _JAX_REPLAY[engine](jst, *jch, resolver="scan", pack=1, **kw)
        pst = replay_units(pst, *pch, engine=engine)
        want = _np(jst)
        for f in pst._fields:
            np.testing.assert_array_equal(
                getattr(pst, f).numpy().astype(np.int32), want[f],
                err_msg=f"chunk {i} field {f}",
            )
    oracle = replay_trace(trace)
    assert peng.decode(pst, 0) == peng.decode(pst, 1) == oracle
    assert (peng.lengths(pst) == len(oracle)).all()


_TRACE_FIXTURES = {
    "sveltecomponent": "svelte_trace",
    "automerge-paper": "automerge_trace",
    "rustcode": "rustcode_trace",
    "seph-blog1": "seph_trace",
}


@pytest.mark.parametrize("name", list(_TRACE_FIXTURES))
def test_tensorize_matches_jax(request, name):
    jtrace = request.getfixturevalue(_TRACE_FIXTURES[name])
    want = jax_tensorize(jtrace, batch=256)
    got = tensorize(port_loader.load_testing_data(name), batch=256)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


def test_sveltecomponent_prefix_decodes_like_jax(svelte_trace):
    """The first 40 patches (6,176 unit ops, 25 batches of 256): the port's
    v4 replay decodes byte-identical to the JAX engine's at the same
    point, and to the oracle."""
    ptrace = port_loader.load_testing_data("sveltecomponent")

    def cut(tr, mod):
        patches = list(tr.iter_patches())[:40]
        return mod.TestData(tr.start_content, "", [mod.TestTxn("", patches)])

    jeng = JaxReplayEngine(jax_tensorize(cut(svelte_trace, jax_loader), 256),
                           n_replicas=2, resolver="scan", pack=1)
    peng = ReplayEngine(tensorize(cut(ptrace, port_loader), 256),
                        n_replicas=2, device="cpu")
    assert peng.tt.n_batches >= 3
    want = jeng.decode(jeng.run(), replica=1)
    pst = peng.run()
    assert peng.decode(pst, 0) == peng.decode(pst, 1) == want
    assert want == replay_trace(cut(svelte_trace, jax_loader))


def test_backend_unit_layout_engines_and_refusals():
    trace = synth_trace(seed=4, n_ops=200, base="backend unit layout ")
    trace = dataclasses.replace(trace, end_content=replay_trace(trace))
    for eng in ("v1", "v2", "v3", "v4"):
        bk = TorchReplayBackend(n_replicas=2, batch=32, layout="unit",
                                unit_engine=eng, device="cpu")
        bk.prepare(trace)
        assert isinstance(bk.engine, ReplayEngine)
        assert bk.engine.engine == eng
        assert bk.replay_once() == len(trace.end_content)
        assert bk.final_content() == trace.end_content
    tt = tensorize(trace, batch=32)
    with pytest.raises(ValueError, match="unknown unit engine"):
        ReplayEngine(tt, engine="v5", device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_TRACE_FIXTURES))
def test_trace_unit_replay_byte_identical(name):
    trace = port_loader.load_testing_data(name)
    bk = TorchReplayBackend(n_replicas=1, batch=256, layout="unit",
                            device="cpu")
    bk.prepare(trace)
    st = bk.engine.run()
    assert (bk.engine.lengths(st) == len(trace.end_content)).all()
    assert bk.engine.decode(st) == trace.end_content
