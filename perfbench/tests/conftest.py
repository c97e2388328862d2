"""Fixtures of the benchmark's own tests (run with
``python -m pytest perfbench/tests -q``; the repository's ``tests/`` run
does not collect them).

``tiny_root`` is a checkout in a temporary directory: a copy of
``perfbench/`` and a ``BENCHMARK.json`` whose cells replay the first
patches of sveltecomponent over 2 replicas at batch 16, small enough for
the program's plain versions on the CPU, through both drivers (upstream
and downstream) with every metric reader.  Tests that need the card take
the ``card`` fixture, which decides when the test runs, not at import.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil

import pytest

from perfbench.reference.replay import replay
from perfbench.spec import ROOT

TINY_PATCHES = 400


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def write_trace(path: str, n_patches: int) -> None:
    """The first ``n_patches`` of sveltecomponent as a trace file, with
    its end content worked out by the reference."""
    src = os.path.join(ROOT, "perfbench", "data", "sveltecomponent.json.gz")
    with gzip.open(src, "rt", encoding="utf-8") as fh:
        raw = json.load(fh)
    txns, kept = [], 0
    for t in raw["txns"]:
        ps = t["patches"][:n_patches - kept]
        kept += len(ps)
        if ps:
            txns.append({"time": t.get("time", ""), "patches": ps})
        if kept >= n_patches:
            break
    end = replay(raw["startContent"],
                 [tuple(p) for t in txns for p in t["patches"]])
    with gzip.open(path, "wt", encoding="utf-8") as fh:
        json.dump({"startContent": raw["startContent"], "endContent": end,
                   "txns": txns}, fh)


def make_root(base: str) -> str:
    """A checkout under ``base`` with the tiny cells ``tiny.upstream`` and
    ``tiny.downstream``."""
    root = os.path.join(base, "checkout")
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.json.gz"))
    write_trace(os.path.join(root, "perfbench", "data", "tiny.json.gz"),
                TINY_PATCHES)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "automerge-paper.r1024.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny", trace="tiny", replicas=2, batch=16)
    with open(os.path.join(root, "perfbench", "configs", "tiny.json"),
              "w") as fh:
        json.dump(cfg, fh)
    up, down = ["tiny.upstream"], ["tiny.downstream"]

    def metric(name, unit, cells, **more):
        return dict(name=name, unit=unit, better="higher", source="host_clock",
                    workloads=cells, **more)

    bench = {
        "configs": [{"name": "tiny", "file": "perfbench/configs/tiny.json",
                     "source": "sveltecomponent's first patches",
                     "reduced": [], "why": "the program's plain versions"}],
        "workloads": [{"name": n, "config": "tiny", "traffic": t, "chips": 1,
                       "why": "a CPU test"}
                      for n, t in (("tiny.upstream", "upstream"),
                                   ("tiny.downstream", "downstream"))],
        "end_to_end": [
            metric("upstream_elems_per_s", "elements/s", up, bound=0.02),
            metric("upstream_replay_ms_p95", "ms", up, bound=0.02),
            metric("downstream_elems_per_s", "elements/s", down, bound=0.02),
            {"name": "setup_s", "unit": "s", "better": "lower",
             "source": "host_clock", "bound": 0.25}],
        "per_layer": [
            metric(name, unit, cells, layer=layer, moves=moves)
            for name, unit, cells, layer, moves in (
                ("device_idle_pct.upstream", "%", up, "device", "setup_s"),
                ("device_idle_pct.downstream", "%", down, "device", "setup_s"),
                ("range_resolve_roofline", "%", up, "kernels", "setup_s"),
                ("range_apply_roofline", "%", up, "kernels", "setup_s"),
                ("down_apply_roofline", "%", down, "kernels", "setup_s"),
                ("torch_ops_ms.upstream", "ms/replay", up, "producer",
                 "setup_s"),
                ("torch_ops_ms.downstream", "ms/apply", down, "producer",
                 "setup_s"),
                ("device_ops.upstream", "ops/replay", up, "engine",
                 "setup_s"),
                ("device_ops.downstream", "ops/apply", down, "engine",
                 "setup_s"))],
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh, indent=1)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_root(str(tmp_path_factory.mktemp("perfbench")))
