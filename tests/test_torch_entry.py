"""The port's ``entry()`` twin (``crdt_benches_tpu_torch/entry.py``):
its example arguments and its one range-replay step at ``device="cpu"``
equal the JAX ``__graft_entry__.entry()`` step's (Pallas interpreted),
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from crdt_benches_tpu_torch import entry as pentry
from crdt_benches_tpu_torch.ops import apply_range_fused as arf
from crdt_benches_tpu_torch.ops import resolve_range as rr


def _np(a):
    a = a.astype(jnp.int32) if a.dtype == jnp.bfloat16 else a
    return np.asarray(a)


@pytest.fixture(scope="module")
def jax_step():
    step, args = __graft_entry__.entry()
    return step, args, step(*args)


def test_example_args_equal_the_references(jax_step):
    _, jargs, _ = jax_step
    _, args = pentry.entry(device="cpu")
    assert len(args) == len(jargs) == 9
    for i, (a, b) in enumerate(zip(args, jargs)):
        assert a.dtype in (torch.int32, torch.int16), i
        np.testing.assert_array_equal(a.numpy(), _np(b), err_msg=str(i))
    assert tuple(args[0].shape) == (pentry.R, pentry.CAPACITY) == (4, 1024)


def test_step_equals_the_references_exactly(jax_step):
    _, jargs, jout = jax_step
    step, args = pentry.entry(device="cpu")
    out = step(*args)
    assert len(out) == len(jout) == 5
    for i, (a, b) in enumerate(zip(out, jout)):
        np.testing.assert_array_equal(a.numpy(), _np(b), err_msg=str(i))
    assert int(out[3][0]) > 0  # the batch inserted chars


def test_step_on_the_references_own_arguments(jax_step):
    """The port's step fed the JAX example arguments (converted) gives the
    JAX step's outputs."""
    _, jargs, jout = jax_step
    args = tuple(torch.from_numpy(_np(a).astype(
        np.int16 if a.dtype == jnp.bfloat16 else np.int32)) for a in jargs)
    for a, b in zip(pentry.step(*args), jout):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_step_runs_the_plain_versions_on_the_cpu():
    """On CPU tensors the step's kernels run their plain versions: K1's
    shared form and the range apply, once each."""
    step, args = pentry.entry(device="cpu")
    k1 = rr.resolve_range_plain.calls
    plain = arf.range_apply_plain.calls
    step(*args)
    assert rr.resolve_range_plain.calls == k1 + 1
    assert arf.range_apply_plain.calls == plain + 1


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pentry.entry()
