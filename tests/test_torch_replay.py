"""The port's range replay engine on the CPU, held against the JAX
engine field by field after every chunk (exact equality, ``cv_intile``
compared by value) and against the oracle byte for byte; and the port's
trace loading and range tensorization against the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from crdt_benches_tpu.engine.replay import _grow_state4 as jax_grow
from crdt_benches_tpu.engine.replay_range import (
    RangeReplayEngine as JaxRangeReplayEngine,
)
from crdt_benches_tpu.engine.replay_range import _init_state4_jit
from crdt_benches_tpu.engine.replay_range import replay_ranges as jax_replay
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu.traces.tensorize import (
    split_insert_runs as jax_split_insert_runs,
)
from crdt_benches_tpu.traces.tensorize import (
    tensorize_ranges as jax_tensorize_ranges,
)
from crdt_benches_tpu_torch.backends.torch_backend import TorchReplayBackend
from crdt_benches_tpu_torch.engine.replay import _grow_state4
from crdt_benches_tpu_torch.engine.replay_range import (
    RangeReplayEngine,
    replay_ranges,
)
from crdt_benches_tpu_torch.ops.apply2 import init_state4
from crdt_benches_tpu_torch.traces import loader as port_loader
from crdt_benches_tpu_torch.traces.tensorize import (
    split_insert_runs,
    tensorize_ranges,
)
from crdt_benches_tpu_torch.utils.convert import state4_to_numpy

FIELDS = ("doc", "cv_intile", "vis_tile", "length", "nvis")


def _np_state(st):
    return {
        "doc": np.asarray(st.doc),
        "cv_intile": np.asarray(st.cv_intile.astype(jnp.int32)),
        "vis_tile": np.asarray(st.vis_tile),
        "length": np.asarray(st.length),
        "nvis": np.asarray(st.nvis),
    }


@pytest.mark.parametrize("seed,batch", [(0, 16), (1, 32), (3, 16)])
def test_engine_matches_jax_chunk_by_chunk(seed, batch):
    """R = 2, chunks of 3 batches so the staged capacity grows between
    chunks; the JAX engine is driven chunk by chunk as its run() does."""
    trace = synth_trace(seed=seed, n_ops=300, base="engine parity test ")
    jrt = jax_tensorize_ranges(trace, batch=batch, coalesce=True)
    prt = tensorize_ranges(trace, batch=batch, coalesce=True)
    jeng = JaxRangeReplayEngine(
        jrt, n_replicas=2, chunk=3, pack=1, interpret=True, engine="v4"
    )
    peng = RangeReplayEngine(prt, n_replicas=2, chunk=3, pack=1,
                             device="cpu")
    assert peng.stage_caps == jeng.stage_caps
    assert len(peng.chunks) == len(jeng.chunks) >= 3
    jst = _init_state4_jit(2, jeng.stage_caps[0], jeng.n_init)
    pst = init_state4(2, peng.stage_caps[0], peng.n_init, device="cpu")
    for i, (cap, tcap, jch, pch) in enumerate(zip(
        jeng.stage_caps, jeng.token_caps, jeng.chunks, peng.chunks
    )):
        jst, _ = jax_replay(
            jax_grow(jst, cap), *jch, nbits=jeng.nbits, pack=jeng.pack,
            interpret=True, token_cap=tcap, engine="v4",
        )
        pst, _ = replay_ranges(_grow_state4(pst, cap), *pch)
        want, got = _np_state(jst), state4_to_numpy(pst)
        for f in FIELDS:
            np.testing.assert_array_equal(
                got[f], want[f], err_msg=f"chunk {i} field {f}"
            )
    oracle = replay_trace(trace)
    assert peng.decode(pst, 0) == peng.decode(pst, 1) == oracle
    assert peng.decode(peng.run(), 1) == oracle


def _replay_trace_by_name(request, fixture):
    trace = request.getfixturevalue(fixture)
    bk = TorchReplayBackend(n_replicas=2, batch=1536, device="cpu")
    bk.prepare(trace)
    st = bk.engine.run()
    assert (bk.engine.lengths(st) == len(trace.end_content)).all()
    assert bk.engine.decode(st, 0) == trace.end_content
    assert bk.engine.decode(st, 1) == trace.end_content


def test_sveltecomponent_byte_identical(request):
    _replay_trace_by_name(request, "svelte_trace")


@pytest.mark.slow
@pytest.mark.parametrize(
    "fixture", ["automerge_trace", "rustcode_trace", "seph_trace"]
)
def test_trace_byte_identical(request, fixture):
    _replay_trace_by_name(request, fixture)


_TRACE_FIXTURES = {
    "sveltecomponent": "svelte_trace",
    "automerge-paper": "automerge_trace",
    "rustcode": "rustcode_trace",
    "seph-blog1": "seph_trace",
}


@pytest.mark.parametrize("name", list(_TRACE_FIXTURES))
def test_loader_and_tensorize_ranges_match_jax(request, name):
    jtrace = request.getfixturevalue(_TRACE_FIXTURES[name])
    ptrace = port_loader.load_testing_data(name)
    assert len(ptrace) == len(jtrace)
    assert ptrace.start_content == jtrace.start_content
    assert ptrace.end_content == jtrace.end_content
    assert list(ptrace.iter_patches()) == list(jtrace.iter_patches())
    want = jax_tensorize_ranges(jtrace, batch=1536, coalesce=True)
    got = tensorize_ranges(ptrace, batch=1536, coalesce=True)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("max_ins", [1, 7, 64])
def test_split_insert_runs_matches_jax(svelte_trace, max_ins):
    rt = jax_tensorize_ranges(svelte_trace, batch=512)
    args = (rt.kind, rt.pos, rt.rlen, rt.slot0, max_ins)
    for g, w in zip(split_insert_runs(*args),
                    jax_split_insert_runs(*args)):
        np.testing.assert_array_equal(g, w)
