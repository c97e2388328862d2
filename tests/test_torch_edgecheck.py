"""The port's dtype-edge harness (``crdt_benches_tpu_torch/serve/edgecheck.py``)
and boundary contracts (``lint/boundary.py``) against the JAX package's.

``run_edgecheck(small=True)`` drains the small ladder through both serve
kernels on the CPU (the kernels' plain versions) with the range sanitizer
armed: every document byte-exact against the oracle and across the two
kernels, and its ``checks`` and ``masks`` counters equal to JAX's harness
on the same ladder.  Every contract of the port's registry accepts its
conforming call at the dtype edges and refuses each one-field perturbation
(a dtype swap, a rank bump, a contradicted symbol, an overlapping written
argument); a real call through a decorated function is checked only while
the checks are armed.  Nothing here is timed."""

import numpy as np
import pytest
import torch

from crdt_benches_tpu.serve.edgecheck import run_edgecheck as jax_edgecheck
from crdt_benches_tpu_torch.lint import range_sanitizer as ranges
from crdt_benches_tpu_torch.lint.boundary import (
    REGISTRY,
    BoundaryError,
    _check_call,
    arm,
    armed,
    disarm,
)
from crdt_benches_tpu_torch.serve import edgecheck


def test_small_ladder_is_byte_exact_and_counts_as_jax(tmp_path):
    got = edgecheck.run_edgecheck(workdir=str(tmp_path / "port"),
                                  small=True, device="cpu")
    want = jax_edgecheck(workdir=str(tmp_path / "jax"), small=True)
    assert got["checks"] == want["checks"]
    assert got["masks"] == want["masks"]
    assert got["ladders"] == want["ladders"]
    assert set(got["ladders"]) == {"small-ladder"}
    for name in edgecheck._REQUIRED_CHECKS:
        assert got["checks"][name] > 0
    fuzz = got["boundary_fuzz"]
    assert fuzz["contracts"] == len(_contracts()) and fuzz["rejected"] > 0
    assert not ranges.armed()  # put back as it was found


def test_harness_entry_point_on_the_cpu(capsys):
    assert edgecheck.main(["--small", "--device", "cpu"]) == 0
    assert "edgecheck: OK" in capsys.readouterr().out
    assert edgecheck.main(["--bogus"]) == 2


def _contracts():
    for mod in edgecheck._BOUNDARY_MODULES:
        __import__(mod)
    return sorted(n for n in REGISTRY
                  if n.startswith("crdt_benches_tpu_torch."))


@pytest.mark.parametrize("name", _contracts())
def test_contract_accepts_its_call_and_refuses_each_perturbation(name):
    c = REGISTRY[name]
    rng = np.random.default_rng(7)
    args = edgecheck._contract_args(c, rng)
    _check_call(c, tuple(args))  # the conforming call passes
    assert edgecheck._fuzz_contract(c, rng)["rejects"] > 0


def test_decorated_call_is_checked_only_while_armed():
    from crdt_benches_tpu_torch.engine.merge_fleet import merge_rows_round
    from crdt_benches_tpu_torch.ops.apply2 import PackedState

    R, B, C = 2, 4, 128

    def fresh():  # the callee writes its state in place: one a call
        return PackedState(torch.full((R, C), 2, dtype=torch.int32),
                           torch.zeros(R, dtype=torch.int32),
                           torch.zeros(R, dtype=torch.int32))

    ops = [torch.full((R, B), 3, dtype=torch.int32) for _ in range(4)]
    ops[1] = torch.zeros(R, B, dtype=torch.int32)
    wide = [o.to(torch.int64) for o in ops]
    with pytest.raises((ValueError, RuntimeError, TypeError)):
        merge_rows_round(fresh(), *wide)  # the engine's own check refuses
    arm()
    try:
        with pytest.raises(BoundaryError, match="dtype"):
            merge_rows_round(fresh(), *wide)
        st = fresh()
        with pytest.raises(BoundaryError, match="overlaps"):
            merge_rows_round(st, st.doc[:, :B], *ops[1:])
    finally:
        disarm()
    assert not armed()
