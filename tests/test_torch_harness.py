"""The port's measurement harness (``crdt_benches_tpu_torch/bench/
harness.py``) against the JAX package's: the same outlier analysis,
re-run policy, quantiles and result records, key for key and value for
value, and result files named ``torch_<name>.json``."""

import itertools
import json
import os

import numpy as np
import pytest

import crdt_benches_tpu.bench.harness as jh
import crdt_benches_tpu_torch.bench.harness as h
from crdt_benches_tpu_torch.bench.harness import (
    BenchResult,
    SampleList,
    _quantile,
    classify_outliers,
    compare_to_baseline,
    load_results,
    markdown_table,
    measure,
    quantiles,
    save_results,
    steady_quantiles,
    summarize,
)

SAMPLE_SETS = [
    [1.0, 1.01, 0.99, 1.02, 0.98],
    [24.08, 24.12, 24.12, 24.13, 294.64],
    [10.0, 10.1, 10.2, 10.3, 10.9, 1000.0],
    [24.1201, 24.1214, 24.1216, 24.1219, 24.135],
    [24.12, 24.121, 24.122, 24.123, 294.6],
    [3.0],
    [2.0, 1.0],
    [float(x) for x in range(1, 101)],
]


def test_classify_clean():
    cls = classify_outliers([1.0, 1.01, 0.99, 1.02, 0.98])
    assert cls["mild"] == 0 and cls["severe"] == 0
    assert cls["flagged"] == []


def test_classify_severe_high():
    cls = classify_outliers([24.08, 24.12, 24.12, 24.13, 294.64])
    assert cls["severe"] >= 1
    assert 294.64 in cls["flagged"]
    assert "fences" in cls


def test_classify_mild_vs_severe():
    cls = classify_outliers([10.0, 10.1, 10.2, 10.3, 10.9, 1000.0])
    assert cls["severe"] >= 1 and 1000.0 in cls["flagged"]


def test_classify_short_lists_never_flag():
    for n in range(4):
        cls = classify_outliers([1.0] * n)
        assert cls == {"mild": 0, "severe": 0, "flagged": []}


def _fake_clock_measure(times, **kw):
    clock = [0.0]

    def fake_fn():
        clock[0] += next(times)

    real = h.time.perf_counter
    try:
        h.time.perf_counter = lambda: clock[0]
        return measure(fake_fn, warmup=0, samples=5, **kw)
    finally:
        h.time.perf_counter = real


def test_measure_reruns_severe_outlier():
    out = _fake_clock_measure(itertools.chain(
        [1.0, 1.01, 100.0, 1.02, 0.99], itertools.repeat(1.0)))
    assert len(out) == 5
    assert out.discarded == [100.0]
    assert out.reruns == 1
    assert max(out) < 2.0
    assert classify_outliers(out)["severe"] == 0


def test_measure_keeps_persistent_outliers_annotated():
    out = _fake_clock_measure(itertools.chain(
        [1.0, 1.01, 1.02, 0.99], itertools.repeat(100.0)), max_reruns=2)
    assert len(out) == 5
    assert out.reruns == 2
    assert classify_outliers(out)["severe"] >= 1


def test_measure_batches_calls_below_the_minimum_sample_time():
    """A call shorter than ``min_sample_time`` repeats within the sample,
    which reports the time a call."""
    out = _fake_clock_measure(itertools.repeat(0.01), min_sample_time=0.05)
    assert len(out) == 5
    for x in out:
        assert x == pytest.approx(0.01)


def test_benchresult_persists_outlier_record():
    s = SampleList([24.08, 24.12, 24.12, 24.13])
    s.discarded = [294.64]
    s.reruns = 1
    r = BenchResult("merge", "adv", "torch", 1000, s)
    d = r.to_dict()
    assert d["discarded_outliers"] == [294.64]
    assert d["min"] == 24.08 and d["max"] == 24.13
    assert d["outliers"]["severe"] == 0
    assert r.worst == 24.13


def test_quantile_linear_interpolation():
    s = [float(x) for x in range(1, 101)]
    assert _quantile(s, 0.5) == pytest.approx(50.5)
    assert _quantile(s, 0.95) == pytest.approx(95.05)
    assert _quantile(s, 0.99) == pytest.approx(99.01)
    assert _quantile(s, 0.0) == 1.0 and _quantile(s, 1.0) == 100.0
    for p in (0.5, 0.9, 0.95, 0.99):
        assert _quantile(s, p) == pytest.approx(float(np.quantile(s, p)))


def test_quantiles_table_and_benchresult_properties():
    q = quantiles(list(range(1, 101)))
    assert set(q) == {"p50", "p95", "p99"}
    assert q["p50"] <= q["p95"] <= q["p99"]
    assert quantiles([3.0, 1.0, 2.0]) == quantiles([1.0, 2.0, 3.0])
    assert quantiles([7.0]) == {"p50": 7.0, "p95": 7.0, "p99": 7.0}
    with pytest.raises(ValueError):
        quantiles([])
    r = BenchResult("serve", "mixed", "16", 100,
                    [float(x) for x in range(1, 101)])
    assert (r.p50, r.p95, r.p99) == (
        pytest.approx(50.5), pytest.approx(95.05), pytest.approx(99.01)
    )
    d = r.to_dict()
    assert d["p50"] == r.p50 and d["p95"] == r.p95 and d["p99"] == r.p99


def test_classify_relative_floor_on_tight_clusters():
    c = classify_outliers([24.1201, 24.1214, 24.1216, 24.1219, 24.135])
    assert c["severe"] == 0
    c2 = classify_outliers([24.12, 24.121, 24.122, 24.123, 294.6])
    assert c2["severe"] == 1


def _pair(samples, discarded=(), **kw):
    """The same result in both packages."""
    out = []
    for mod in (h, jh):
        s = mod.SampleList(samples)
        s.discarded = list(discarded)
        out.append(mod.BenchResult("upstream", "sveltecomponent",
                                   "torch-cuda-r8", 19749, s, **kw))
    return out


@pytest.mark.parametrize("samples", SAMPLE_SETS)
def test_result_record_equals_the_references(samples):
    port, ref = _pair(samples, replicas=8, extra={"note": "x"})
    assert port.to_dict() == ref.to_dict()
    assert list(port.to_dict()) == list(ref.to_dict())
    assert port.elements_per_sec == ref.elements_per_sec
    assert port.bench_id == ref.bench_id
    assert classify_outliers(samples) == jh.classify_outliers(samples)
    assert quantiles(samples) == jh.quantiles(samples)


def test_result_record_with_discarded_outliers_equals_the_references():
    port, ref = _pair([1.0, 1.1, 1.2, 1.3], discarded=[9.0, 12.0])
    assert port.to_dict() == ref.to_dict()
    assert port.to_dict()["discarded_outliers"] == [9.0, 12.0]


def test_steady_quantiles_and_summarize_equal_the_references():
    s = [0.7, 3.2, 0.71, 0.69, 0.72, 2.9]
    flags = [False, True, False, False, False, True]
    assert steady_quantiles(s, flags) == jh.steady_quantiles(s, flags)
    q, t, n = steady_quantiles(s, flags)
    assert n == 2 and t == pytest.approx(6.1) and q["p50"] < 1.0
    assert steady_quantiles([1.0], [True]) == jh.steady_quantiles(
        [1.0], [True])
    with pytest.raises(ValueError):
        steady_quantiles([1.0], [])
    for vals in ([], [3, 1, 2], [0.5]):
        assert summarize(vals) == jh.summarize(vals)
    assert summarize([]) == {"n": 0, "mean": 0.0, "max": 0}


def test_results_files_are_torch_prefixed_and_compare(tmp_path):
    port, ref = _pair([0.5, 0.6, 0.55], replicas=8)
    path = save_results([port], results_dir=str(tmp_path))
    assert os.path.basename(path) == "torch_latest.json"
    save_results([port], "base", results_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["torch_base.json",
                                            "torch_latest.json"]
    # the record is the JAX package's record of the same result
    jpath = jh.save_results([ref], "ref", results_dir=str(tmp_path))
    with open(path) as a, open(jpath) as b:
        assert json.load(a) == json.load(b)
    got = load_results("base", results_dir=str(tmp_path))
    assert list(got) == [port.bench_id]
    slower = BenchResult("upstream", "sveltecomponent", "torch-cuda-r8",
                         19749, [1.1, 1.2, 1.1], replicas=8)
    other = BenchResult("downstream", "x", "cpp-crdt", 5, [1.0])
    lines = compare_to_baseline([slower, other], "base",
                                results_dir=str(tmp_path))
    assert lines[0].startswith(f"{port.bench_id}: 1100.00ms vs 550.00ms")
    assert "(+100.0%)" in lines[0]
    assert lines[1] == "downstream/x/cpp-crdt: new"


def test_markdown_table_equals_the_references():
    rows = []
    for mod in (h, jh):
        rows.append(mod.markdown_table([
            mod.BenchResult("upstream", "a", "cpp-rope", 10, [0.1]),
            mod.BenchResult("upstream", "a", "torch-cuda-r8", 10, [0.2],
                            replicas=8),
            mod.BenchResult("downstream", "a", "cpp-crdt", 10, [0.3]),
        ]))
    assert rows[0] == rows[1]
    assert rows[0].splitlines()[0] == ("| group | trace | cpp-crdt | "
                                       "cpp-rope | torch-cuda-r8 |")
    assert markdown_table([]) == jh.markdown_table([])
