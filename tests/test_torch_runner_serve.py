"""The port's runner serve family (``bench/runner.py --family serve``)
against the JAX runner's ``run_serve`` on the same argvs.

Tolerance: exact on every timing-free value.  Each family (a plain drain,
``--serve-writers 2``, an open drain, a two-rate sweep, a short soak and
``--serve-mesh 4``) runs in both packages, in process, on a tiny fleet (a
``tiny`` mix of the small synthetic band registered in both packages);
the port runs on the CPU through its kernels' plain versions.  Held: the
exit code, the bench id, the artifact's keys and every value that does not
depend on the clock or the host.  The refusal matrix (the counterpart of
JAX's ``tests/test_ingest.py`` one) holds exit 2 and JAX's message word
for word; ``--serve-save-name`` and ``--serve-sample-seed`` name and draw
as JAX's do.  The sanitizers' and the profiler's blocks (``boundary_syncs``,
``thread_crossings``, ``fs_ops``, ``lifecycle``, ``ranges``, ``profile``)
equal JAX's but for their timed keys and the profile's op names (XLA's
operations there, torch's here); ``--serve-profile 2`` and
``--serve-edgecheck small`` run through both runners."""

import functools
import json
import os

import pytest
import torch

from crdt_benches_tpu.bench import runner as jrunner
from crdt_benches_tpu.serve import bench as jbench
from crdt_benches_tpu.serve import workload as jworkload
from crdt_benches_tpu.serve.replicate import bench as jrbench
from crdt_benches_tpu_torch.bench import harness as h
from crdt_benches_tpu_torch.bench import runner
from crdt_benches_tpu_torch.serve import bench as pbench
from crdt_benches_tpu_torch.serve import workload as pworkload

TINY = ["--serve-mix", "tiny", "--serve-docs", "8", "--serve-batch", "8",
        "--serve-macro", "4", "--serve-batch-chars", "32",
        "--serve-classes", "128,512", "--serve-slots", "8,4",
        "--serve-arrival-span", "2", "--serve-verify-sample", "4"]

#: extra keys whose values follow the clock or the host (held by presence)
TIMED = {"patches_per_sec", "merge_unit_ops_per_sec", "batch_latency",
         "compile_time", "compile_rounds", "steady_rounds", "barrier_time",
         "construction", "metrics", "doc_drain_latency", "timeseries",
         "anomalies", "reqtrace", "slo", "flight", "status_port", "ingest",
         "knee", "journal", "recovery", "occupancy_mean",
         "queue_depth_mean", "queue_depth_max", "replication",
         "convergence", "kernel", "op_dtypes", "device_rounds"}
#: an open drain's ops arrive over a live socket: its round count, and what
#: follows from it, depend on the wire's timing (the plan itself does not)
LIVE = {"rounds", "pad_fraction", "deferred_ops", "backpressure_rounds"}


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """Both packages' artifacts into temporary directories, and the tiny
    mix registered in both."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(h, "RESULTS_DIR", str(pdir))
    for mod in (jbench, jrbench):
        monkeypatch.setattr(mod, "save_results", functools.partial(
            mod.save_results, results_dir=str(jdir)))
    for mixes in (jworkload.MIXES, pworkload.MIXES):
        monkeypatch.setitem(mixes, "tiny", {"synth-small": 1.0})
    return jdir, pdir


def _run(argv, capsys):
    """(JAX's exit code, its stdout, the port's exit code, its stdout)."""
    jrc = jrunner.main(["--family", "serve", *argv])
    jout = capsys.readouterr().out
    prc = runner.main(["--family", "serve", "--device", "cpu", *argv])
    pout = capsys.readouterr().out
    return jrc, jout, prc, pout


def _artifact(d, name):
    with open(os.path.join(d, name)) as fh:
        (rec,) = json.load(fh)
    return rec


def _same_artifacts(jdir, pdir, name, live=False):
    j = _artifact(jdir, f"{name}.json")
    p = _artifact(pdir, f"torch_{name}.json")
    for k in ("group", "trace", "backend", "elements", "replicas"):
        assert p[k] == j[k], k
    assert set(p["extra"]) == set(j["extra"])
    for k, v in j["extra"].items():
        if k in runner.LINT_BLOCKS:  # the sanitizers' and the profiler's
            assert _untimed(k, p["extra"][k], live) == _untimed(k, v, live), k
        elif k not in TIMED and not (live and k in LIVE):
            assert p["extra"][k] == v, k
    return j["extra"], p["extra"]


def _untimed(key, block, live):
    """A sanitizer or profile block without what follows the clock: the
    profile's op table (its names are each package's own operations) and,
    for a drain over the live wire, every count (the plans, and so the
    boundary moves, follow the wire's timing): the surface flags stay."""
    if block is None:
        return None
    if key == "profile":
        ops = block["top_ops"]
        assert ops and all(set(o) == {"name", "total_ms", "calls"}
                           for o in ops)
        return {k: v for k, v in block.items() if k != "top_ops"}
    if live:
        return {k: v for k, v in block.items() if not isinstance(v, dict)}
    return block


FAMILIES = [
    ("plain", [], "serve_tiny_8"),
    ("writers", ["--serve-writers", "2", "--serve-turn-ops", "8"],
     "serve_repl_tiny_8x2"),
    ("open", ["--serve-open", "64"], "serve_open_tiny_8"),
    ("sweep", ["--serve-open", "64", "--serve-open-sweep", "64,256"],
     "serve_open_tiny_8"),
    ("soak", ["--serve-soak", "0"], "serve_tiny_8"),
    ("mesh", ["--serve-mesh", "4"], "serve_tiny_8"),
]


@pytest.mark.parametrize("extra,name", [f[1:] for f in FAMILIES],
                         ids=[f[0] for f in FAMILIES])
def test_family_matches_jax(extra, name, dirs, capsys):
    jrc, jout, prc, pout = _run(TINY + extra, capsys)
    assert prc == jrc == 0
    # the summary's first line names the same bench id
    assert pout.split(":")[0] == jout.split(":")[0]
    live = "--serve-open" in extra
    jx, px = _same_artifacts(*dirs, name, live=live)
    if live:
        assert px["ingest"]["open"] == jx["ingest"]["open"]
    if "--serve-writers" in extra:
        for k in ("replicas_checked", "converged", "ra_ok"):
            assert px["convergence"][k] == jx["convergence"][k], k
        return
    assert px["verify_ok"] and px["verified_docs"]
    assert px["construction"]["verify_sample_seed"] == 1
    if "--serve-mesh" in extra:
        assert px["mesh_devices"] == jx["mesh_devices"] == 4
    if "--serve-open-sweep" in extra:
        assert ([q["offered_rate"] for q in px["knee"]["points"]]
                == [q["offered_rate"] for q in jx["knee"]["points"]])
    if "--serve-soak" in extra:
        assert px["anomalies"]["fired"] == jx["anomalies"]["fired"] == 0


def test_save_name_and_sample_seed(dirs, capsys):
    argv = TINY + ["--serve-verify-sample", "2", "--serve-sample-seed", "9",
                   "--serve-save-name", "named"]
    jrc, _, prc, _ = _run(argv, capsys)
    assert prc == jrc == 0
    jx, px = _same_artifacts(*dirs, "named")
    assert px["construction"]["verify_sample_seed"] == 9
    assert px["verified_docs"] == jx["verified_docs"]


REFUSALS = [
    ["--serve-writers", "2", "--serve-mesh", "4", "--serve-soak", "1"],
    ["--serve-writers", "2", "--serve-profile", "2"],
    ["--serve-writers", "2", "--serve-stream", "--serve-tiers", "warm=4"],
    ["--serve-open", "32", "--serve-longhaul", "1"],
    ["--serve-open", "32", "--serve-recover"],
    ["--serve-open", "32", "--serve-mesh", "3"],
    ["--serve-open", "32", "--serve-open-sweep", "8", "--serve-soak", "1"],
    ["--serve-tenants", "gold=8"],
    ["--serve-deadline"],
    ["--serve-open-sweep", "8,16"],
    ["--serve-deadline-budget", "4", "--serve-tenants", "a=1"],
    ["--serve-record-evict", "--serve-journal", "auto"],
    ["--serve-stream-scaling", "8", "--serve-soak", "1"],
    ["--serve-edgecheck", "small", "--serve-mesh", "3", "--serve-journal",
     "auto", "--serve-faults", "seed=1,stall=1"],
]


@pytest.mark.parametrize("extra", REFUSALS,
                         ids=["-".join(a.strip("-") for a in r
                                       if a.startswith("--"))
                              for r in REFUSALS])
def test_refusal_matrix(extra, dirs, capsys):
    jrc = jrunner.main(["--family", "serve", *TINY, *extra])
    jerr = capsys.readouterr().err
    prc = runner.main(["--family", "serve", "--device", "cpu", *TINY,
                       *extra])
    perr = capsys.readouterr().err
    assert prc == jrc == 2
    assert perr == jerr
    for d in dirs:
        assert not d.exists() or not os.listdir(d)


@pytest.mark.parametrize("extra", [["--serve-profile", "2"],
                                   ["--serve-edgecheck", "small"]])
def test_profile_and_edgecheck_match_jax(extra, dirs, capsys):
    """The device profiler and the edge harness (once refused with exit 2)
    through both runners: the profiled drain's artifact equal to JAX's
    but for the timed keys and the op names, the harness's ladders and
    range checks word for word (the boundary fuzz counts each package's
    own contracts)."""
    argv = ([*TINY, *extra] if extra[0] == "--serve-profile"
            else ["--serve-verify-sample", "4", *extra])
    jrc, jout, prc, pout = _run(argv, capsys)
    assert prc == jrc == 0
    if extra[0] == "--serve-profile":
        jx, px = _same_artifacts(*dirs, "serve_tiny_8")
        assert px["profile"]["rounds"] == jx["profile"]["rounds"] == 2
        return
    jl, pl = jout.strip().splitlines(), pout.strip().splitlines()
    assert pl[:-2] == jl[:-2]  # the ladders, oracle-identical
    assert pl[-1].split(", ")[:-1] == jl[-1].split(", ")[:-1]
    assert pl[-1].startswith("edgecheck: OK")


def test_mesh_refusals_exit_2_with_jax_words(dirs, capsys):
    """The drain's own mesh refusals (the warm tier, the recovery leg):
    JAX's runner raises its ValueError, the port's exits 2 with the same
    words."""
    for extra in (["--serve-mesh", "4", "--serve-tiers", "warm=4"],
                  ["--serve-mesh", "4", "--serve-journal", "auto",
                   "--serve-recover"]):
        with pytest.raises(ValueError) as e:
            jrunner.main(["--family", "serve", *TINY, *extra])
        capsys.readouterr()
        assert runner.main(["--family", "serve", "--device", "cpu", *TINY,
                            *extra]) == 2
        assert capsys.readouterr().err.strip() == f"error: {e.value}"


def test_no_cuda_exits_1_and_drain_failures_keep_their_traceback(
        dirs, capsys, monkeypatch):
    """Without CUDA the serve family exits 1 before any drain, as the
    classic family does; a drain's failure other than its own refusals (a
    ValueError) is not reported as a refusal but raised as it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runner.main(["--family", "serve", *TINY]) == 1
    assert "CUDA is not available" in capsys.readouterr().err

    def broken(**_kw):
        raise RuntimeError("crdt_serve_macro: launch failed")

    monkeypatch.setattr(pbench, "run_serve_bench", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        runner.main(["--family", "serve", "--device", "cpu", *TINY])
