"""The harness: cells, mixes and metrics found as files by name, the
result line's keys, and the refusals."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.spec import ROOT, find_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tree_digest(root: str) -> dict[str, str]:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_config_mix_metric_and_work_count_are_files(tiny_root, tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a work count
    added as new files (and entries) run with no existing file edited."""
    root = str(tmp_path / "checkout")
    shutil.copytree(tiny_root, root)
    before = tree_digest(os.path.join(root, "perfbench"))
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", "tiny.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny3", replicas=3)
    with open(os.path.join(pb, "configs", "tiny3.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pb, "traffic", "upstream_warm2.json"), "w") as fh:
        json.dump({"driver": "upstream", "warm_runs": 2, "traced_runs": 3,
                   "sample_replicas": 3}, fh)
    with open(os.path.join(pb, "roofline", "columns.py"), "w") as fh:
        fh.write("def work(trace, config):\n"
                 "    return [(config['replicas'] * len(trace.end), 0)]\n")
    with open(os.path.join(pb, "metrics", "replays_traced.py"), "w") as fh:
        fh.write("def read(c):\n"
                 "    return float(c.runs + c.work('columns')[0][0])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(bench["configs"][0], name="tiny3",
                                 file="perfbench/configs/tiny3.json"))
    bench["workloads"].append({"name": "tiny3.warm2", "config": "tiny3",
                               "traffic": "upstream_warm2", "chips": 1,
                               "why": "a cell added by files"})
    bench["per_layer"].append({"name": "replays_traced", "unit": "runs",
                               "better": "higher", "source": "device_trace",
                               "layer": "engine", "moves": "setup_s",
                               "workloads": ["tiny3.warm2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    res = run.run_cell(find_cell("tiny3.warm2", root), 5, 0.2, True,
                       device="cpu")
    assert res["correct"] and res["attempted"] == 3 + 1  # and the gaps run
    assert res["metrics"]["replays_traced"]["unit"] == "runs"
    assert res["metrics"]["replays_traced"]["value"] > 3
    after = tree_digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        os.path.join("configs", "tiny3.json"),
        os.path.join("traffic", "upstream_warm2.json"),
        os.path.join("roofline", "columns.py"),
        os.path.join("metrics", "replays_traced.py")}


@pytest.mark.parametrize("cell", ["tiny.upstream", "tiny.downstream"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(tiny_root, cell, traced):
    res = run.run_cell(find_cell(cell, tiny_root), 2**31 + 99, 0.3, traced,
                       device="cpu")
    keys = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(res) == keys
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"len_bad", "text_bad"}
    want = ({"setup_s", "upstream_elems_per_s", "upstream_replay_ms_p95"}
            if cell == "tiny.upstream" else
            {"setup_s", "downstream_elems_per_s"})
    # device metrics are never read off the card
    assert set(res["metrics"]) == (set() if traced else want)
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])


def run_command(cwd: str, *args: str, env=None):
    cmd = [sys.executable, "-m", "perfbench", "--workload",
           "automerge-paper.r1024.upstream", "--seed", "1", "--seconds", "1",
           "--trace", "0", *args]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_cuda_device_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = run_command(ROOT, env=env)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_unknown_workload_fails():
    p = subprocess.run([sys.executable, "-m", "perfbench", "--workload",
                        "nope", "--seed", "1", "--seconds", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_bare_directory_fails(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ holds no
    program: the run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_command(str(tmp_path))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_json_names_existing_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    pb = os.path.join(ROOT, "perfbench")
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = find_cell(w["name"])
        assert os.path.exists(os.path.join(pb, "drivers",
                                           cell.traffic["driver"] + ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(pb, "metrics", m["name"] + ".py"))
