"""The port's v3 range engine (``engine/replay_range.py`` with
``engine="v3"``: K1's shared form, then ``ops/apply_range.py
apply_range_batch``, K4 at K = 1 on the card, its plain round here) held
against the JAX package's ``RangeReplayEngine(engine="v3")`` field by
field (doc, length, nvis) after every chunk, and every replica against the
oracle byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine.replay_range import (
    RangeReplayEngine as JaxRangeReplayEngine,
)
from crdt_benches_tpu.engine.replay_range import _grow_state3 as jax_grow3
from crdt_benches_tpu.engine.replay_range import _init_state3_jit
from crdt_benches_tpu.engine.replay_range import replay_ranges as jax_replay
from crdt_benches_tpu.ops.apply_range import (
    apply_range_batch as jax_apply_range_batch,
)
from crdt_benches_tpu.ops.resolve_range_scan import resolve_ranges_shared
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces.loader import (
    load_testing_data as jax_load_testing_data,
)
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu.traces.tensorize import (
    tensorize_ranges as jax_tensorize_ranges,
)
from crdt_benches_tpu_torch.backends.torch_backend import TorchReplayBackend
from crdt_benches_tpu_torch.engine.replay_range import (
    RangeReplayEngine,
    _grow_state3,
    replay_ranges,
)
from crdt_benches_tpu_torch.ops import serve_fused as sf
from crdt_benches_tpu_torch.ops.apply2 import PackedState, init_state3
from crdt_benches_tpu_torch.ops.apply_range import apply_range_batch
from crdt_benches_tpu_torch.ops.resolve_range import resolve_range
from crdt_benches_tpu_torch.traces.loader import load_testing_data
from crdt_benches_tpu_torch.traces.tensorize import tensorize_ranges

FIELDS = ("doc", "length", "nvis")


def _check(jst, pst, what):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f"{what}: field {f}")


@pytest.mark.parametrize("seed,R,batch,chunk", [
    (21, 1, 8, 2), (22, 3, 16, 2), (23, 5, 5, 3),
])
def test_v3_engine_matches_jax_chunk_by_chunk(seed, R, batch, chunk):
    """A 1,500-char base and small chunks, so the staged capacity grows
    between chunks."""
    trace = synth_trace(seed=seed, n_ops=400, base="v3 parity base " * 100)
    jrt = jax_tensorize_ranges(trace, batch=batch, coalesce=True)
    prt = tensorize_ranges(trace, batch=batch, coalesce=True)
    jeng = JaxRangeReplayEngine(jrt, n_replicas=R, chunk=chunk, pack=1,
                                interpret=True, engine="v3")
    peng = RangeReplayEngine(prt, n_replicas=R, chunk=chunk, pack=1,
                             engine="v3", device="cpu")
    assert peng.capacity == jeng.capacity
    assert peng.stage_caps == jeng.stage_caps
    assert len(set(peng.stage_caps)) >= 2  # the capacity grew
    jst = _init_state3_jit(R, jeng.stage_caps[0], jeng.n_init)
    pst = init_state3(R, peng.stage_caps[0], peng.n_init, device="cpu")
    for i, (cap, jch, pch) in enumerate(zip(jeng.stage_caps, jeng.chunks,
                                            peng.chunks)):
        jst, _ = jax_replay(jax_grow3(jst, cap), *jch, nbits=jeng.nbits,
                            pack=jeng.pack, interpret=True, engine="v3")
        pst, _ = replay_ranges(_grow_state3(pst, cap), *pch)
        assert isinstance(pst, PackedState)
        _check(jst, pst, f"chunk {i}")
    oracle = replay_trace(trace)
    final = peng.run()
    _check(jst, final, "run()")
    for r in range(R):
        assert peng.decode(final, r) == oracle


def test_v3_engine_run_equals_jax_on_sveltecomponent():
    trace = load_testing_data("sveltecomponent")
    jeng = JaxRangeReplayEngine(
        jax_tensorize_ranges(jax_load_testing_data("sveltecomponent"),
                             batch=1536, coalesce=True),
        n_replicas=2, interpret=True, engine="v3")
    peng = RangeReplayEngine(tensorize_ranges(trace, batch=1536,
                                              coalesce=True),
                             n_replicas=2, engine="v3", device="cpu")
    assert peng.stage_caps == jeng.stage_caps
    _check(jeng.run(), st := peng.run(), "sveltecomponent")
    assert (peng.lengths(st) == len(trace.end_content)).all()
    for r in (0, 1):
        assert peng.decode(st, r) == trace.end_content


@pytest.mark.parametrize("seed", [0, 7])
def test_apply_range_batch_equals_jax_on_every_batch(seed):
    """One resolve + apply per batch at R = 3: each batch's output, from
    the same state, held against JAX's resolve + ``apply_range_batch``,
    and run as one plain round (one ``serve_macro_plain`` call)."""
    trace = synth_trace(seed=seed, n_ops=120, base="apply batch ")
    rt = tensorize_ranges(trace, batch=12, coalesce=True)
    R, C = 3, 1024
    st = init_state3(R, C, len(rt.init_chars), device="cpu")
    nbits = max(1, int(rt.max_batch_ins).bit_length())
    for i, ops in enumerate(zip(*rt.batched())):
        ops = [torch.as_tensor(a) for a in ops]
        tokens, dints, _ = resolve_range(*ops, st.nvis)
        before = sf.serve_macro_plain.calls
        new = apply_range_batch(st, tokens, dints)
        assert sf.serve_macro_plain.calls == before + 1
        jtok, jd, _ = resolve_ranges_shared(*(a.numpy() for a in ops),
                                            st.nvis.numpy())
        want = jax_apply_range_batch(_jax_packed(st), jtok, jd, nbits=nbits)
        _check(want, new, f"batch {i}")
        st = new
    oracle = replay_trace(trace)
    eng = RangeReplayEngine(rt, n_replicas=R, engine="v3", device="cpu")
    for r in range(R):
        assert eng.decode(st, r) == oracle


def _jax_packed(st):
    import jax.numpy as jnp

    from crdt_benches_tpu.ops.apply2 import PackedState as JPackedState

    return JPackedState(jnp.asarray(st.doc.numpy()),
                        jnp.asarray(st.length.numpy()),
                        jnp.asarray(st.nvis.numpy()))


def test_backend_range_engine_v3_name_and_content():
    trace = synth_trace(seed=2, n_ops=200, base="backend v3 ")
    trace = dataclasses.replace(trace, end_content=replay_trace(trace))
    bk = TorchReplayBackend(n_replicas=2, batch=32, layout="range",
                            range_engine="v3", device="cpu")
    assert bk.NAME == "torch-cpu-r2-range"
    bk.prepare(trace)
    assert bk.engine.engine == "v3"
    assert bk.replay_once() == len(trace.end_content)
    assert bk.final_content() == trace.end_content
    assert TorchReplayBackend(device="cpu").NAME == "torch-cpu"
    assert TorchReplayBackend(n_replicas=4, layout="unit",
                              device="cpu").NAME == "torch-cpu-r4-unit"
    with pytest.raises(ValueError, match="range engine"):
        RangeReplayEngine(tensorize_ranges(trace, batch=32),
                          engine="v5", device="cpu")
