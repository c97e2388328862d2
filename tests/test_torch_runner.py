"""The port's bench matrix runner (``crdt_benches_tpu_torch/bench/
runner.py``) on the CPU at small sizes: ``--verify-only`` passes for every
column of every group, a timed run writes ``torch_<name>.json`` records
with the JAX package's schema and nothing else, ``--family serve`` and a
missing card exit with errors; plus the report and the trace dump against
the JAX package's."""

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from crdt_benches_tpu.bench import dump_trace as jdump
from crdt_benches_tpu.bench.harness import BenchResult as JBenchResult
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu_torch.backends.native import native_available
from crdt_benches_tpu_torch.bench import dump_trace, report, runner
from crdt_benches_tpu_torch.bench import harness as h

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPSTREAM = ("cpp-rope", "cpp-rope-bytes", "cpp-crdt", "cpp-crdt-bytes",
            "cpp-cola", "python-oracle", "py-reconcile", "torch",
            "torch-unit")
DOWNSTREAM = ("cpp-crdt", "torch", "torch-pos", "torch-range", "torch-runs",
              "torch-patch", "torch-unitwire")
MERGE = ("cpp-crdt", "torch", "torch-range", "torch-flat")
SMALL = ["--device", "cpu", "--replicas", "2", "--batch", "16",
         "--merge-configs", "synthetic", "--merge-ops", "640", "--epoch",
         "2"]

pytestmark = pytest.mark.skipif(
    not native_available(), reason="libcrdtnative.so not built"
)


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    """A synthetic trace with multi-byte chars, as a .json.gz file."""
    trace = synth_trace(seed=9, n_ops=300, base="runner base — é 😀 ")
    path = tmp_path_factory.mktemp("traces") / "synth.json.gz"
    with gzip.open(path, "wt", encoding="utf-8") as fh:
        json.dump({
            "startContent": trace.start_content,
            "endContent": replay_trace(trace),
            "txns": [{"time": "", "patches": [list(p) for p in
                                              trace.iter_patches()]}],
        }, fh)
    return str(path)


@pytest.fixture
def results_dir(tmp_path, monkeypatch):
    """Results go to a temporary directory; the repository's
    ``bench_results/`` must not change."""
    before = sorted(os.listdir(os.path.join(REPO, "bench_results")))
    monkeypatch.setattr(h, "RESULTS_DIR", str(tmp_path))
    yield tmp_path
    assert sorted(os.listdir(os.path.join(REPO, "bench_results"))) == before


@pytest.mark.parametrize("group,backends", [
    ("upstream", UPSTREAM), ("downstream", DOWNSTREAM), ("merge", MERGE),
])
def test_verify_only_passes_for_every_column(trace_path, results_dir,
                                             capsys, group, backends):
    rc = runner.main(["--traces", trace_path, "--backends",
                      ",".join(backends), "--filter", group,
                      "--verify-only", *SMALL])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "verify: all cells byte-identical" in err
    checked = [ln for ln in err.splitlines() if ln.startswith("verify ")
               and ln.endswith(": ok")]
    # every column verified (cpp-crdt is the merges' reference itself)
    want = len(backends) - (group == "merge")
    assert len(checked) == want, err
    assert "skip" not in err
    assert os.listdir(results_dir) == []


def test_verify_only_with_the_v3_range_engine(trace_path, results_dir,
                                              capsys):
    rc = runner.main(["--traces", trace_path, "--backends", "torch",
                      "--filter", "upstream", "--range-engine", "v3",
                      "--verify-only", *SMALL])
    assert rc == 0, capsys.readouterr().err


def test_verify_reports_a_mismatch(trace_path, results_dir, capsys,
                                   monkeypatch):
    monkeypatch.setattr(runner, "_oracle_content", lambda name: "wrong")
    rc = runner.main(["--traces", trace_path, "--backends", "cpp-rope",
                      "--filter", "upstream", "--verify-only", *SMALL])
    err = capsys.readouterr().err
    assert rc == 1
    assert "MISMATCH" in err and "verify FAILED" in err


def test_timed_run_writes_records_with_the_references_schema(
        trace_path, results_dir, capsys):
    rc = runner.main(["--traces", trace_path, "--backends",
                      "cpp-rope,cpp-cola,py-reconcile,torch,torch-unit,"
                      "torch-range", "--samples", "2", "--warmup", "1",
                      "--save-baseline", "small", "--verify", *SMALL])
    out = capsys.readouterr()
    assert rc == 0, out.err
    assert sorted(os.listdir(results_dir)) == ["torch_latest.json",
                                               "torch_small.json"]
    with open(results_dir / "torch_latest.json") as fh:
        records = json.load(fh)
    ids = {f"{r['group']}/{r['backend']}" for r in records}
    assert ids == {"upstream/cpp-rope", "upstream/cpp-cola",
                   "upstream/py-reconcile", "upstream/torch-cpu-r2",
                   "upstream/torch-cpu-r2-unit", "downstream/torch-cpu-r2",
                   "downstream/torch-cpu-r2-range"}
    schema = list(JBenchResult("upstream", "t", "b", 1, [1.0, 2.0])
                  .to_dict())
    for r in records:
        assert list(r) == schema
        assert r["trace"] == trace_path and r["elements"] == 300
        assert len(r["samples"]) >= 2 and r["elements_per_sec"] > 0
        assert r["replicas"] == (2 if r["backend"].startswith("torch")
                                 else 1)
    assert "| group | trace |" in out.out
    # a second run compares with the saved baseline
    rc = runner.main(["--traces", trace_path, "--backends", "cpp-rope",
                      "--filter", "upstream", "--samples", "2",
                      "--baseline", "small", *SMALL])
    out = capsys.readouterr()
    assert rc == 0
    assert f"upstream/{trace_path}/cpp-rope: " in out.out
    assert "%)" in out.out


def test_merge_cells_and_only_filter(trace_path, results_dir, capsys):
    rc = runner.main(["--traces", trace_path, "--backends", ",".join(MERGE),
                      "--filter", "merge", "--samples", "2", *SMALL])
    assert rc == 0, capsys.readouterr().err
    with open(results_dir / "torch_latest.json") as fh:
        records = json.load(fh)
    assert {r["backend"] for r in records} == {
        "cpp-crdt", "torch-cpu-r2", "torch-cpu-r2-range",
        "torch-cpu-r2-flat"}
    assert {r["group"] for r in records} == {"merge"}
    assert {r["trace"] for r in records} == {"synthetic"}
    assert len({r["elements"] for r in records}) == 1
    rc = runner.main(["--traces", trace_path, "--backends", ",".join(MERGE),
                      "--only", "merge/synthetic/torch-flat", "--samples",
                      "2", *SMALL])
    assert rc == 0
    with open(results_dir / "torch_latest.json") as fh:
        records = json.load(fh)
    assert [r["backend"] for r in records] == ["torch-cpu-r2-flat"]


def test_adversarial_run_merge_is_skipped(trace_path, results_dir, capsys):
    rc = runner.main(["--traces", trace_path, "--backends", "torch-range",
                      "--filter", "merge", "--samples", "1", "--device",
                      "cpu", "--replicas", "2", "--batch", "16",
                      "--merge-configs", "adversarial", "--merge-ops",
                      "1280"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "skip merge/adversarial/torch-range" in err


def test_profile_writes_a_torch_profiler_trace(trace_path, results_dir,
                                               tmp_path, capsys):
    prof = tmp_path / "prof"
    rc = runner.main(["--traces", trace_path, "--backends", "torch",
                      "--filter", "upstream", "--samples", "1",
                      "--profile", str(prof), *SMALL])
    assert rc == 0, capsys.readouterr().err
    with open(prof / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


def test_without_cuda_the_runner_exits_with_an_error():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    done = subprocess.run(
        [sys.executable, "-m", "crdt_benches_tpu_torch.bench.runner",
         "--traces", "sveltecomponent", "--backends", "torch",
         "--verify-only"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert done.returncode == 1
    assert "CUDA is not available" in done.stderr
    assert done.stdout.strip() == ""


def test_unknown_backend_fails(trace_path, results_dir):
    with pytest.raises(ValueError, match="unknown backend"):
        runner.main(["--traces", trace_path, "--backends", "jax",
                     "--filter", "upstream", "--samples", "1", *SMALL])


def test_report_reads_the_ports_and_the_references_results(tmp_path):
    ours = h.BenchResult("upstream", "t", "torch-cuda-r8", 10, [0.1, 0.2],
                         replicas=8)
    path = h.save_results([ours], "rep", results_dir=str(tmp_path))
    out = tmp_path / "r.html"
    ref = os.path.join(REPO, "bench_results", "down_r5.json")
    assert report.main([path, ref, "-o", str(out)]) == 0
    text = out.read_text()
    assert "torch-cuda-r8" in text and "jax-tpu-r64" in text
    assert "<svg" in text
    rows = report.load_results([path, ref])
    assert rows[0]["elements_per_sec"] == ours.elements_per_sec


def test_dump_trace_equals_the_references(tmp_path):
    a = dump_trace.dump("sveltecomponent", str(tmp_path / "p.bin"))
    b = jdump.dump("sveltecomponent", str(tmp_path / "j.bin"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
