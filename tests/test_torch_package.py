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
import time

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
from crdt_benches_tpu_torch.bench.runner import (
    run_downstream,
    run_merge,
    run_upstream,
    verify_upstream,
)
from crdt_benches_tpu_torch.entry import dryrun_multichip, dryrun_rank, entry
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
from crdt_benches_tpu_torch.parallel.launch import run_ranks
from crdt_benches_tpu_torch.parallel.mesh import device_memory_stats
from crdt_benches_tpu_torch.serve.bench import (
    run_serve_bench,
    run_serve_open_sweep,
)
from crdt_benches_tpu_torch.serve.construction import probe
from crdt_benches_tpu_torch.serve.journal import rebuild_doc
from crdt_benches_tpu_torch.serve.pool import DocPool
from crdt_benches_tpu_torch.serve.replicate.bench import run_serve_repl_bench
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
    assert int(n) >= 70  # every module of the port was imported
    assert old.strip() == "[]"
    for mod in ("ops.idpos", "ops.apply", "engine.downstream",
                "ops.packing", "ops.serve_fused", "oracle.text_oracle",
                "traces.synth", "utils.checkpoint", "serve.workload",
                "serve.pool", "serve.scheduler", "serve.bench",
                "serve.prefetch",
                "engine.merge", "engine.downstream_range",
                "engine.merge_range", "engine.downstream_flat",
                "utils.digest", "bench.merge", "bench.nocv_versus",
                "bench.runner", "bench.report", "bench.dump_trace",
                "bench.harness", "backends.reconcile", "backends.base",
                "backends.native", "entry", "parallel.mesh",
                "parallel.launch", "engine.merge_fleet", "serve.journal",
                "utils.fsdur", "serve.faults", "serve.construction",
                "obs.__init__", "obs.metrics", "obs.trace",
                "obs.timeseries", "obs.shard", "obs.status", "obs.anomaly",
                "obs.reqtrace", "obs.slo", "obs.flight", "serve.reshard",
                "serve.replicate.__init__", "serve.replicate.group",
                "serve.replicate.broadcast", "serve.replicate.checker",
                "serve.replicate.scheduler", "serve.replicate.bench",
                "serve.ingest.__init__", "serve.ingest.admission",
                "serve.ingest.front", "serve.ingest.deadline",
                "serve.ingest.loadgen", "bench.serve_flags",
                "lint.__init__", "lint.sanitizer", "lint.boundary",
                "lint.range_sanitizer", "lint.race_sanitizer",
                "lint.fs_sanitizer", "lint.lifecycle_sanitizer",
                "obs.profiler", "serve.edgecheck", "serve.fscrash",
                "serve.lifecheck", "lint.core", "lint.rules", "lint.flow",
                "lint.launch_rules", "lint.ranges", "lint.fsops",
                "lint.lifecycle", "lint.threads", "lint.fix",
                "lint.__main__"):
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
        lambda: RangeReplayEngine(rt, engine="v3"),
        lambda: TorchReplayBackend(range_engine="v3"),
        lambda: entry(),
        lambda: run_upstream("sveltecomponent", "torch", 1, 0, 1, 1536),
        lambda: run_downstream("sveltecomponent", "torch", 1, 0),
        lambda: run_merge("synthetic", "torch-flat", 1, 0, 1, 16, 320),
        lambda: verify_upstream("sveltecomponent", "torch-unit", 1, 256),
        lambda: dryrun_multichip(1),
        lambda: run_ranks(dryrun_rank, 1),
        lambda: device_memory_stats(),
        lambda: DocPool(serve_kernel="scan"),
        lambda: run_serve_bench(n_docs=2, serve_kernel="scan"),
        lambda: run_serve_bench(n_docs=2, journal_dir="auto",
                                crash_after=1),
        lambda: rebuild_doc(None, 256, None, 1, n_init=0, batch=16,
                            batch_chars=64),
        lambda: run_serve_bench(n_docs=2, faults="stall=1"),
        lambda: run_serve_bench(n_docs=2, queue_cap=8,
                                overflow_policy="shed"),
        lambda: run_serve_bench(n_docs=2, stream=True, record_evict=True),
        lambda: probe(2),
        lambda: probe(2, stream=False),
        lambda: run_serve_repl_bench(n_docs=2, writers=2),
        lambda: run_serve_bench(n_docs=4, reshard_spec="shrink:2:1",
                                journal_dir="auto"),
        lambda: run_serve_bench(n_docs=2, open_spec="8", deadline=True,
                                tenants_spec="gold=8"),
        lambda: run_serve_open_sweep([4, 16], open_spec="8", n_docs=2),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_construct_worker_runs_no_torch(tmp_path):
    """The prefetch thread's construct path (``LazyStreams.builder`` ->
    ``build_stream_payload``: a session from the spec, numpy tensorization
    and lane packing) calls no function of torch: every Python frame the
    thread enters is profiled, and none belongs to a torch module."""
    import threading

    from crdt_benches_tpu_torch.serve.prefetch import Prefetcher
    from crdt_benches_tpu_torch.serve.scheduler import LazyStreams
    from crdt_benches_tpu_torch.serve.workload import FleetSpec

    spec = FleetSpec.build(3, mix={"synth-small": 0.5, "trace-small": 0.5},
                           seed=2, arrival_span=2)
    pool = DocPool(classes=(256, 1024), slots=(2, 2), device="cpu",
                   spool_dir=str(tmp_path / "sp"))
    streams = LazyStreams(spec, pool, batch=16, batch_chars=64)
    seen: set[str] = set()

    def prof(frame, event, arg):
        if event in ("call", "c_call"):
            mod = (frame.f_globals.get("__name__") or "") if event == "call" \
                else (getattr(arg, "__module__", None) or "")
            seen.add(mod)
        return prof

    pf = Prefetcher(capacity=4)
    threading.setprofile(prof)
    try:
        pf.start()
    finally:
        threading.setprofile(None)
    try:
        for d in range(3):
            assert pf.submit_construct(d, streams.builder(d))
        got = []
        deadline = time.monotonic() + 60
        while len(got) < 3:
            assert time.monotonic() < deadline
            got.extend(pf.drain())
            time.sleep(0.01)
    finally:
        pf.stop()
        pool.close()
    assert all(p["error"] is None for p in got)
    assert "crdt_benches_tpu_torch.serve.scheduler" in seen
    assert "crdt_benches_tpu_torch.ops.packing" in seen
    torchy = sorted(m for m in seen if m == "torch" or m.startswith("torch."))
    assert torchy == []


def test_journal_moves_no_state_to_the_cpu():
    """``serve/journal.py`` reads a device tensor back to the host in one
    place, ``rebuild_doc``'s result; recovery uploads each bucket to the
    pool's device (``DocPool.upload_bucket``) and never computes on a CPU
    copy of a CUDA state (the device tests are in test_torch_journal.py
    and test_torch_recovery.py)."""
    with open(os.path.join(REPO, "crdt_benches_tpu_torch", "serve",
                           "journal.py")) as fh:
        src = fh.read()
    assert src.count(".cpu()") == 1
    assert "return (state.doc[0].cpu().numpy()," in src
    assert ".to(\"cpu\")" not in src and "device=\"cpu\"" not in src


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


def test_chaos_bench_entry_without_cuda_exits_with_error():
    """The chaos flags are arguments of the serve group and change nothing
    about the device: without CUDA the run exits with the error."""
    _no_cuda()
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--group",
         "serve", "--serve-docs", "2", "--serve-faults",
         "seed=7,stall=1,queue_overflow=1", "--serve-queue-cap", "16",
         "--serve-overflow-policy", "shed"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert done.returncode != 0
    assert "CUDA is not available" in done.stderr
    assert done.stdout.strip() == ""
    helped = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    for flag in ("--serve-faults", "--serve-queue-cap",
                 "--serve-overflow-policy"):
        assert flag in helped.stdout, flag


@pytest.mark.parametrize("argv", [
    ["--serve-writers", "2", "--serve-turn-ops", "16"],
    ["--serve-reshard", "shrink:2:1", "--serve-journal", "{tmp}"],
    ["--serve-open", "8", "--serve-tenants", "gold=8", "--serve-deadline",
     "--serve-faults", "conn_churn=1"],
])
def test_repl_and_reshard_entries_without_cuda_exit_with_error(argv,
                                                                tmp_path):
    """A replicated or resharding serve run changes nothing about the
    device: without CUDA it exits with the error and prints no result."""
    _no_cuda()
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench", "--group",
         "serve", "--serve-docs", "4",
         *(a.format(tmp=tmp_path) for a in argv)],
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
    ["--serve-faults", "stall=1"],
    ["--group", "downstream", "--serve-queue-cap", "8"],
    ["--group", "merge", "--serve-overflow-policy", "shed"],
    ["--schedule", "batched"],
    ["--group", "downstream", "--engine", "range", "--schedule", "flat"],
])
def test_bench_entry_rejects_the_other_groups_flags(argv, capsys):
    from crdt_benches_tpu_torch.bench.__main__ import main

    with pytest.raises(SystemExit) as done:
        main(argv + ["--device", "cpu"])
    assert done.value.code == 2
    assert "belong" in capsys.readouterr().err


_REPL = ["--group", "serve", "--device", "cpu", "--serve-docs", "2",
         "--serve-writers", "2"]


@pytest.mark.parametrize("extra,flag", [
    (["--serve-soak", "0"], "--serve-soak"),
    (["--serve-longhaul", "2"], "--serve-longhaul"),
    (["--serve-journal", "auto", "--serve-recover"], "--serve-recover"),
    (["--serve-crash-round", "3"], "--serve-crash-round"),
    (["--serve-reshard", "shrink:2:1"], "--serve-reshard"),
    (["--serve-record-evict"], "--serve-record-evict"),
    (["--serve-tiers", "warm=4"], "--serve-tiers"),
    (["--serve-queue-cap", "8"], "--serve-queue-cap"),
    (["--serve-status", "0"], "--serve-status"),
    (["--serve-timeseries", "ts.jsonl"], "--serve-timeseries"),
    (["--serve-trace", "t.json"], "--serve-trace"),
    (["--serve-flight", "f.json"], "--serve-flight"),
    (["--serve-stream"], "--serve-stream"),
    (["--serve-stream-scaling", "8"], "--serve-stream-scaling"),
    (["--serve-open", "32"], "--serve-open"),
])
def test_repl_entry_refuses_the_flags_jax_refuses(extra, flag, capsys):
    """``--serve-writers`` with a flag the replicated family does not take
    exits 2 naming it, before any fleet is built (the JAX runner's list,
    without the flags the port does not have)."""
    from crdt_benches_tpu_torch.bench.__main__ import main

    assert main(_REPL + extra) == 2
    err = capsys.readouterr().err
    assert flag in err and "not supported with --serve-writers" in err


@pytest.mark.parametrize("argv,msg", [
    (["--serve-reshard", "shrink:2:1"], "--serve-journal is required"),
    (["--serve-reshard", "shrink:2:2", "--serve-journal", "auto"],
     "FROM > TO"),
    (["--serve-reshard", "drain:0", "--serve-journal", "auto"],
     "does not determine a shard count"),
    (["--serve-reshard", "shrink:2:1", "--serve-journal", "auto",
      "--serve-tiers", "warm=4"], "own bench family"),
    (["--serve-faults", "reshard_crash=1"], "--serve-reshard is required"),
    (["--serve-faults", "replica_partition=1"], "replicated fleet"),
])
def test_reshard_entry_refusals_exit_2(argv, msg, capsys):
    from crdt_benches_tpu_torch.bench.__main__ import main

    assert main(["--group", "serve", "--device", "cpu", "--serve-docs",
                 "2"] + argv) == 2
    assert msg in capsys.readouterr().err


_OPEN_NEEDED = "configure the live ingest front: --serve-open RATE is required"
_OPEN_REFUSED = "not supported with --serve-open"


@pytest.mark.parametrize("extra,msg", [
    # tests/test_ingest.py's runner matrix
    (["--serve-open", "32", "--serve-longhaul", "1"],
     "--serve-longhaul " + _OPEN_REFUSED),
    (["--serve-open", "32", "--serve-recover"],
     "--serve-recover " + _OPEN_REFUSED),
    # the port has no serve mesh yet: argparse refuses the flag
    (["--serve-open", "32", "--serve-mesh", "3"],
     "unrecognized arguments: --serve-mesh 3"),
    (["--serve-open", "bogus"], "--serve-open: bad rate 'bogus'"),
    (["--serve-tenants", "gold=8"], "--serve-tenants " + _OPEN_NEEDED),
    (["--serve-deadline"], "--serve-deadline " + _OPEN_NEEDED),
    (["--serve-open-sweep", "8,16"], "--serve-open-sweep " + _OPEN_NEEDED),
    # and the rest of the JAX runner's open-loop refusals
    (["--serve-deadline-budget", "9"],
     "--serve-deadline-budget " + _OPEN_NEEDED),
    (["--serve-open", "32", "--serve-crash-round", "3", "--serve-journal",
      "auto"], "--serve-crash-round " + _OPEN_REFUSED),
    (["--serve-open", "32", "--serve-reshard", "shrink:2:1",
      "--serve-tiers", "warm=4", "--serve-stream"],
     "--serve-reshard, --serve-tiers, --serve-stream " + _OPEN_REFUSED),
    (["--serve-open", "32", "--serve-open-sweep", "8", "--serve-soak", "0"],
     "--serve-soak does not compose with the sweep"),
    (["--serve-open", "32", "--serve-open-sweep", "8,x"],
     "--serve-open-sweep: bad rate list '8,x'"),
    (["--serve-open", "32", "--serve-open-sweep", "8",
      "--serve-stream-scaling", "8"], "--serve-soak / --serve-open-sweep"),
    (["--serve-open", "32:steady"], "unknown arrival process 'steady'"),
    (["--serve-open", "32", "--serve-tenants", "gold=0"],
     "rate must be a positive finite"),
    (["--serve-faults", "conn_churn=1"],
     "target the live ingest front: --serve-open is required"),
    (["--serve-faults", "tenant_flood=1"],
     "target the live ingest front: --serve-open is required"),
])
def test_open_entry_refusals_exit_2(extra, msg, capsys):
    """The JAX runner's refusals of the open-loop flags
    (``crdt_benches_tpu/bench/runner.py`` and ``tests/test_ingest.py``'s
    matrix) through the port's entry: exit 2 with the message, before
    any fleet is built."""
    from crdt_benches_tpu_torch.bench.__main__ import main

    argv = ["--group", "serve", "--serve-docs", "8"] + extra
    try:
        rc = main(argv)
    except SystemExit as e:  # argparse's own refusal
        rc = e.code
    assert rc == 2
    out = capsys.readouterr()
    assert msg in out.err and out.out == ""


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
