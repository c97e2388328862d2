"""Boundaries of the PyTorch port: it imports no JAX and nothing of the
JAX package, its entry points default to CUDA and refuse to fall back to
the CPU, its chip driver fails without a card, and states carry across
from the JAX reference and back."""

import dataclasses
import glob
import gzip
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops.apply2 import init_state4 as jax_init_state4
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu_torch import _build
from crdt_benches_tpu_torch.backends.torch_backend import TorchReplayBackend
from crdt_benches_tpu.engine.downstream import (
    down_packed_init as jax_down_packed_init,
)
from crdt_benches_tpu_torch.bench.merge import merge_sim
from crdt_benches_tpu_torch.engine.downstream import (
    DownstreamEngine,
    TorchDownstreamBackend,
    down_packed_init,
    generate_updates,
    init_down_state,
)
from crdt_benches_tpu_torch.engine.downstream_range import (
    RangeDownstreamEngine,
    TorchRangeDownstreamBackend,
)
from crdt_benches_tpu_torch.engine.merge import MergeSimulation, agent_oplog
from crdt_benches_tpu_torch.engine.merge_range import (
    TorchRunDownstreamBackend,
)
from crdt_benches_tpu_torch.engine.replay import ReplayEngine
from crdt_benches_tpu_torch.engine.replay_range import RangeReplayEngine
from crdt_benches_tpu_torch.models import flagship
from crdt_benches_tpu_torch.ops.apply import init_state
from crdt_benches_tpu_torch.ops.apply2 import (
    init_state2,
    init_state3,
    init_state4,
)
from crdt_benches_tpu_torch.serve.bench import run_serve_bench
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.traces.tensorize import (
    tensorize,
    tensorize_ranges,
)
from crdt_benches_tpu_torch.utils.convert import (
    down_packed_from_jax,
    down_packed_to_numpy,
    down_state_from_jax,
    resolved_from_jax,
    state2_from_jax,
    state3_from_jax,
    state4_from_jax,
    state4_to_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import crdt_benches_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
old = sorted(m for m in sys.modules
             if m == "crdt_benches_tpu" or m.startswith("crdt_benches_tpu."))
print(len(names), old)
"""


def test_port_imports_no_jax_and_no_reference_module():
    done = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert done.returncode == 0, done.stderr
    n, old = done.stdout.split(" ", 1)
    assert int(n) >= 41  # every module of the port was imported
    assert old.strip() == "[]"
    for mod in ("ops.idpos", "ops.apply", "engine.downstream",
                "ops.packing", "ops.serve_fused", "oracle.text_oracle",
                "traces.synth", "utils.checkpoint", "serve.workload",
                "serve.pool", "serve.scheduler", "serve.bench",
                "engine.merge", "engine.downstream_range",
                "engine.merge_range", "engine.downstream_flat",
                "utils.digest", "bench.merge", "bench.nocv_versus"):
        assert os.path.exists(os.path.join(
            REPO, "crdt_benches_tpu_torch", *mod.split(".")) + ".py"), mod


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    rt = tensorize_ranges(synth_trace(seed=0, n_ops=20), batch=16)
    tt = tensorize(synth_trace(seed=0, n_ops=20), batch=16)
    for call in (
        lambda: RangeReplayEngine(rt),
        lambda: ReplayEngine(tt),
        lambda: TorchReplayBackend(),
        lambda: TorchReplayBackend(layout="unit"),
        lambda: flagship.backend(),
        lambda: init_state2(1, 1024),
        lambda: init_state3(1, 1024),
        lambda: init_state4(1, 1024),
        lambda: state2_from_jax({}),
        lambda: state3_from_jax({}),
        lambda: state4_from_jax({}),
        lambda: resolved_from_jax({}),
        lambda: ReplayEngine(tt, engine="v1"),
        lambda: init_state(1, 1024),
        lambda: init_down_state(1, 1024, 0),
        lambda: down_packed_init(1, 1024, 0),
        lambda: generate_updates(tt),
        lambda: DownstreamEngine(tt),
        lambda: TorchDownstreamBackend(),
        lambda: flagship.downstream("sveltecomponent"),
        lambda: DocPool(),
        lambda: run_serve_bench(n_docs=2),
        lambda: agent_oplog(tt, 1, 0, 0),
        lambda: MergeSimulation([tt]),
        lambda: merge_sim("synthetic", 320, batch=16),
        lambda: RangeDownstreamEngine(synth_trace(seed=0, n_ops=20)),
        lambda: TorchRangeDownstreamBackend(),
        lambda: TorchRunDownstreamBackend(),
        lambda: TorchRunDownstreamBackend(granularity="patch",
                                          schedule="batched"),
        lambda: down_packed_from_jax({}),
        lambda: down_state_from_jax({}),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_bench_entry_without_cuda_exits_with_error():
    _no_cuda()
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench",
         "--trace", "sveltecomponent", "--samples", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert done.returncode != 0
    assert "CUDA is not available" in done.stderr
    assert done.stdout.strip() == ""


def test_downstream_bench_entry_without_cuda_exits_with_error():
    _no_cuda()
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--group",
         "downstream", "--trace", "sveltecomponent", "--samples", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert done.returncode != 0
    assert "CUDA is not available" in done.stderr
    assert done.stdout.strip() == ""


@pytest.mark.parametrize("argv", [
    ["--group", "merge", "--merge-config", "synthetic", "--merge-ops",
     "320"],
    ["--group", "merge", "--merge-engine", "flat"],
    ["--group", "downstream", "--engine", "range"],
    ["--group", "downstream", "--engine", "runs", "--schedule", "batched"],
    ["--group", "downstream", "--engine", "patch"],
    ["--group", "downstream", "--engine", "unitwire"],
])
def test_merge_and_run_downstream_entries_without_cuda_exit_with_error(argv):
    _no_cuda()
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", *argv,
         "--trace", "sveltecomponent", "--samples", "1"]
        if "downstream" in argv else
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", *argv,
         "--samples", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert done.returncode != 0
    assert "CUDA is not available" in done.stderr
    assert done.stdout.strip() == ""


def test_merge_bench_entry_on_cpu_prints_one_json_line():
    for engine in ("unit", "range", "flat"):
        done = subprocess.run(
            [sys.executable, "-m", "crdt_benches_tpu_torch.bench",
             "--group", "merge", "--merge-config", "synthetic",
             "--merge-ops", "640", "--merge-engine", engine, "--replicas",
             "2", "--batch", "16", "--epoch", "2", "--samples", "1",
             "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert done.returncode == 0, done.stderr
        lines = done.stdout.strip().splitlines()
        assert len(lines) == 1
        out = json.loads(lines[0])
        assert out["unit"] == "elements/sec" and out["value"] > 0
        assert out["verify_ok"] is True
        assert f"engine {engine}" in out["metric"]
        assert "torch-cpu-r2" in out["metric"]
    # the run merge refuses duplicated delivery
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--group",
         "merge", "--merge-config", "adversarial", "--merge-ops", "1280",
         "--merge-engine", "range", "--batch", "16", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 2
    assert "refuses duplicated delivery" in done.stderr
    assert done.stdout.strip() == ""


def test_port_reads_no_environment_knob():
    """Options are arguments; the one environment read is the build's
    CUDA_HOME, which locates the toolkit."""
    reads = []
    for path in glob.glob(os.path.join(REPO, "crdt_benches_tpu_torch", "**",
                                       "*.py"), recursive=True):
        with open(path) as fh:
            for line in fh:
                if re.search(r"os\.environ|getenv", line):
                    reads.append((os.path.basename(path), line.strip()))
    assert reads == [("_build.py", 'os.environ.get("CUDA_HOME", '
                      '"/usr/local/cuda"), "bin", "nvcc"')]


def test_serve_bench_entry_without_cuda_exits_with_error():
    _no_cuda()
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--group",
         "serve", "--serve-docs", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert done.returncode != 0
    assert "CUDA is not available" in done.stderr
    assert done.stdout.strip() == ""


@pytest.mark.parametrize("argv", [
    ["--group", "downstream", "--layout", "unit"],
    ["--group", "downstream", "--unit-engine", "v3"],
    ["--engine", "v3"],
    ["--merge-engine", "flat"],
    ["--group", "downstream", "--epoch", "4"],
    ["--group", "serve", "--merge-ops", "100"],
    ["--group", "merge", "--engine", "v5"],
    ["--group", "merge", "--serve-docs", "4"],
    ["--schedule", "batched"],
    ["--group", "downstream", "--engine", "range", "--schedule", "flat"],
])
def test_bench_entry_rejects_the_other_groups_flags(argv, capsys):
    from crdt_benches_tpu_torch.bench.__main__ import main

    with pytest.raises(SystemExit) as done:
        main(argv + ["--device", "cpu"])
    assert done.value.code == 2
    assert "belong" in capsys.readouterr().err


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    done = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert done.returncode != 0
    assert '"ok": true' not in done.stdout


def test_bench_entry_on_cpu_prints_one_json_line():
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench",
         "--trace", "sveltecomponent", "--samples", "1", "--replicas", "1",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr
    lines = done.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["unit"] == "elements/sec" and out["value"] > 0
    assert "torch-cpu" in out["metric"]


def test_downstream_bench_entry_on_cpu_prints_one_json_line(tmp_path):
    trace = synth_trace(seed=9, n_ops=300, base="downstream bench entry ")
    path = tmp_path / "synth.json.gz"
    with gzip.open(path, "wt", encoding="utf-8") as fh:
        json.dump({
            "startContent": trace.start_content,
            "endContent": replay_trace(trace),
            "txns": [{"time": "", "patches": [list(p) for p in
                                              trace.iter_patches()]}],
        }, fh)
    for engine in ("v5", "v1"):
        done = subprocess.run(
            [sys.executable, "-m", "crdt_benches_tpu_torch.bench",
             "--group", "downstream", "--engine", engine, "--trace",
             str(path), "--samples", "1", "--replicas", "2", "--batch",
             "32", "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert done.returncode == 0, done.stderr
        lines = done.stdout.strip().splitlines()
        assert len(lines) == 1
        out = json.loads(lines[0])
        assert out["unit"] == "elements/sec" and out["value"] > 0
        assert f"engine {engine}" in out["metric"]
        assert "torch-cpu-r2" in out["metric"]
        assert isinstance(out["vs_baseline"], float)


def test_state_conversion_round_trip():
    jst = jax_init_state4(3, 2048, 700)
    arrays = {
        "doc": np.asarray(jst.doc),
        "cv_intile": np.asarray(jst.cv_intile.astype(jnp.int32)),
        "vis_tile": np.asarray(jst.vis_tile),
        "length": np.asarray(jst.length),
        "nvis": np.asarray(jst.nvis),
    }
    pst = state4_from_jax(arrays, device="cpu")
    assert pst.cv_intile.dtype == torch.int16
    back = state4_to_numpy(pst)
    for f, a in arrays.items():
        np.testing.assert_array_equal(back[f], a, err_msg=f)
    # the port's own fresh state equals the reference's
    fresh = state4_to_numpy(init_state4(3, 2048, 700, device="cpu"))
    for f, a in arrays.items():
        np.testing.assert_array_equal(fresh[f], a, err_msg=f)
    # the downstream's packed state carries across too
    jdp = jax_down_packed_init(3, 2048, 700)
    darrays = {f: np.asarray(getattr(jdp, f)) for f in jdp._fields}
    back = down_packed_to_numpy(down_packed_from_jax(darrays, device="cpu"))
    fresh = down_packed_to_numpy(down_packed_init(3, 2048, 700, device="cpu"))
    for f, a in darrays.items():
        np.testing.assert_array_equal(back[f], a, err_msg=f)
        np.testing.assert_array_equal(fresh[f], a, err_msg=f)
    with pytest.raises(ValueError, match="integer"):
        state4_from_jax(
            dict(arrays, cv_intile=arrays["cv_intile"].astype(np.float32)),
            device="cpu",
        )


def test_backend_replay_once_and_layouts():
    trace = synth_trace(seed=2, n_ops=120, base="backend check ")
    trace = dataclasses.replace(trace, end_content=replay_trace(trace))
    bk = TorchReplayBackend(n_replicas=2, batch=32, layout="range",
                            device="cpu")
    bk.prepare(trace)
    assert bk.replay_once() == len(trace.end_content)
    assert bk.final_content() == trace.end_content
    # unit-op random edits do not coalesce 2x: auto picks the unit layout
    bk = TorchReplayBackend(n_replicas=2, batch=32, device="cpu")
    bk.prepare(trace)
    assert isinstance(bk.engine, ReplayEngine)
    assert bk.replay_once() == len(trace.end_content)
    assert bk.final_content() == trace.end_content


def test_every_c_entry_is_defined_in_a_source():
    """Each C entry the loader binds is defined once in ``csrc/*.cu`` with
    as many parameters as its ctypes signature lists."""
    defs = {}
    for src in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(src) as fh:
            text = fh.read()
        for name, params in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', text
        ):
            assert name not in defs, f"{name} defined twice"
            defs[name] = len(params.split(","))
    for name, argtypes in _build.SIGNATURES.items():
        assert defs.get(name) == len(argtypes), name
    assert {"crdt_resolve_range", "crdt_range_apply", "crdt_resolve_unit",
            "crdt_unit_apply", "crdt_expand_packed",
            "crdt_expand_fill_zero", "crdt_apply_blocked",
            "crdt_resolve_range_rows", "crdt_serve_macro",
            "crdt_range_apply_blocked"} <= set(
                _build.SIGNATURES)
