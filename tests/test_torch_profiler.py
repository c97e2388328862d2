"""The port's device profiler (``crdt_benches_tpu_torch/obs/profiler.py``,
the JAX package's ``obs/profiler.py`` over ``torch.profiler``).

Held: the capture state machine (wait, ready, on, done; the window opens
the round after the first steady round, counts steady rounds to N and
counts the non-steady rounds inside it as ``dirty_rounds``), ``top_ops``
on an exported trace (device events when the trace has any, else the CPU
operators; totals and call counts per name, heaviest first) and the
``profile`` block's keys, JAX's, from a tiny drain on the CPU.  The timed
values (``total_ms``) are held to being positive and ordered, no more."""

import gzip
import json

import pytest

from crdt_benches_tpu.obs import profiler as jprofiler
from crdt_benches_tpu_torch.obs import profiler as pprofiler
from crdt_benches_tpu_torch.serve import bench as pbench
from crdt_benches_tpu_torch.serve import workload as pworkload


def test_state_machine_waits_for_a_steady_round_and_counts_dirty(tmp_path):
    prof = pprofiler.DeviceProfiler(2, logdir=str(tmp_path), device="cpu")
    assert prof.state == "wait"
    prof.round_begin()
    prof.round_end(steady=False)  # a barrier round: still waiting
    assert prof.state == "wait"
    prof.round_begin()
    prof.round_end(steady=True)
    assert prof.state == "ready"  # the window opens at the next round
    prof.round_begin()
    assert prof.state == "on"
    prof.round_end(steady=False)  # a barrier inside the window
    prof.round_begin()
    prof.round_end(steady=True)
    assert (prof.state, prof.captured, prof.dirty_rounds) == ("on", 1, 1)
    prof.round_begin()
    prof.round_end(steady=True)
    assert prof.state == "done" and prof.captured == 2
    prof.round_begin()  # done: nothing reopens
    prof.round_end(steady=True)
    block = prof.finalize()
    assert block["rounds"] == 2 and block["requested"] == 2
    assert block["dirty_rounds"] == 1
    assert block["logdir"] == str(tmp_path)  # a caller's directory stays
    assert prof.finalize() is block  # idempotent


def test_finalize_closes_an_open_window_and_a_short_drain_has_none(
        tmp_path):
    prof = pprofiler.DeviceProfiler(5, device="cpu")
    prof.round_end(steady=True)
    prof.round_begin()
    fenced = []
    block = prof.finalize(fence=lambda: fenced.append(1))
    assert fenced == [1] and prof.state == "done"
    assert block["rounds"] == 0 and block["requested"] == 5
    assert set(block) == {"rounds", "requested", "dirty_rounds", "top_ops"}
    never = pprofiler.DeviceProfiler(3, device="cpu")
    never.round_end(steady=False)
    assert never.finalize() is None


def _events():
    x = lambda name, cat, dur: {"ph": "X", "name": name, "cat": cat,
                                "dur": dur, "ts": 0, "pid": 1, "tid": 1}
    return [x("k4", "kernel", 300.0), x("k1", "kernel", 100.0),
            x("k4", "kernel", 200.0), x("Memcpy HtoD", "gpu_memcpy", 50.0),
            x("aten::add", "cpu_op", 900.0),
            x("cudaLaunchKernel", "cuda_runtime", 10.0),
            x("k0", "kernel", 0.0), {"ph": "i", "name": "mark"}]


def test_top_ops_prefers_device_events_of_an_exported_trace(tmp_path):
    with open(tmp_path / "trace.json", "w") as fh:
        json.dump({"traceEvents": _events()}, fh)
    sub = tmp_path / "sub"
    sub.mkdir()
    with gzip.open(sub / "more.json.gz", "wt") as fh:
        json.dump({"traceEvents": [_events()[1]]}, fh)
    ops = pprofiler.top_ops(str(tmp_path))
    assert ops == [
        {"name": "k4", "total_ms": 0.5, "calls": 2},
        {"name": "k1", "total_ms": 0.2, "calls": 2},
        {"name": "Memcpy HtoD", "total_ms": 0.05, "calls": 1},
    ]
    assert pprofiler.top_ops(str(tmp_path), limit=1) == ops[:1]


def test_top_ops_falls_back_to_cpu_operators(tmp_path):
    with open(tmp_path / "trace.json", "w") as fh:
        json.dump({"traceEvents": [e for e in _events()
                                   if e.get("cat") != "kernel"
                                   and e.get("cat") != "gpu_memcpy"]}, fh)
    assert pprofiler.top_ops(str(tmp_path)) == [
        {"name": "aten::add", "total_ms": 0.9, "calls": 1}]
    assert pprofiler.top_ops(str(tmp_path / "missing")) == []


def test_top_ops_reads_a_torch_profiler_export(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = torch.arange(4096)
        for _ in range(3):
            a = (a * 3 + 1) % 7
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ops = pprofiler.top_ops(str(tmp_path))
    names = {o["name"] for o in ops}
    assert {"aten::mul", "aten::add"} & names
    assert all(o["calls"] >= 1 and o["total_ms"] > 0 for o in ops)
    assert [o["total_ms"] for o in ops] == sorted(
        (o["total_ms"] for o in ops), reverse=True)


def test_profile_block_keys_are_jax(monkeypatch):
    monkeypatch.setitem(pworkload.MIXES, "tiny", {"synth-small": 1.0})
    rep = pbench.run_serve_bench(
        mix="tiny", n_docs=24, batch=8, macro_k=2, batch_chars=32,
        classes=(128, 512), slots=(8, 4), arrival_span=2, verify_sample=4,
        profile_rounds=2, device="cpu", log=lambda *a, **k: None)
    block = rep["profile"]
    # JAX's block: the keys its DeviceProfiler.finalize writes
    src = open(jprofiler.__file__).read()
    for key in block:
        assert f'"{key}"' in src, key
    assert set(block) == {"rounds", "requested", "dirty_rounds", "top_ops"}
    assert block["rounds"] == block["requested"] == 2
    assert block["top_ops"], "a CPU capture lists the CPU operators"
    for op in block["top_ops"]:
        assert set(op) == {"name", "total_ms", "calls"}
    assert rep["verify_ok"]


@pytest.mark.parametrize("rounds", [0, -3])
def test_no_profile_without_rounds(rounds, monkeypatch):
    monkeypatch.setitem(pworkload.MIXES, "tiny", {"synth-small": 1.0})
    rep = pbench.run_serve_bench(
        mix="tiny", n_docs=8, batch=8, macro_k=4, batch_chars=32,
        classes=(128, 512), slots=(8, 4), arrival_span=2, verify_sample=4,
        profile_rounds=rounds, device="cpu", log=lambda *a, **k: None)
    assert rep["profile"] is None
