"""The port's sync sanitizer (``crdt_benches_tpu_torch/lint/sanitizer.py``)
against the JAX package's (``crdt_benches_tpu/lint/sanitizer.py``).

The same tiny drain runs in both packages, JAX's sanitizer armed by its
environment variable (through ``monkeypatch``), the port's by
``run_serve_bench(sanitize=("syncs",))``.  Exact: the fence entries, fence
by fence, and the sequence of fence instants in the span trace.  The
per-fence ``syncs`` are each package's own count (JAX counts jax Array
conversions, the port torch tensor ones), so they are held by their fence
names only.  The port's tripwire itself: an ``.item()`` on the hot path
outside a fence raises ``UndeclaredSyncError``; inside a fence it counts;
disarmed, the sanitizer counts entries only and leaves ``torch.Tensor`` as
it was, also after a drain that raised.  Nothing here is timed."""

import json

import pytest
import torch

from crdt_benches_tpu.serve import bench as jbench
from crdt_benches_tpu.serve import workload as jworkload
from crdt_benches_tpu_torch.lint import sanitizer
from crdt_benches_tpu_torch.serve import bench as pbench
from crdt_benches_tpu_torch.serve import workload as pworkload

TINY = dict(mix="tiny", n_docs=8, batch=8, macro_k=4, batch_chars=32,
            classes=(128, 512), slots=(8, 4), arrival_span=2,
            verify_sample=4)

#: drains whose fence entries are held equal: the plain drain, a journaled
#: chaos drain (the chaos and journal fences), a live reshard (its two
#: fences) and a streamed, record-evicting drain (the genesis fences)
DRAINS = {
    "plain": {},
    "journal-chaos": dict(
        n_docs=24, slots=(6, 2), journal_dir="auto", snapshot_every=3,
        faults="seed=5,span=5,spool_corrupt=1,device_loss=1,"
               "queue_overflow=1,dup_batch=1"),
    "reshard": dict(n_docs=24, journal_dir="auto", snapshot_every=3,
                    reshard_spec="shrink:2:1@4,batch=2"),
    "stream": dict(n_docs=24, slots=(4, 2), stream=True, record_evict=True),
}


@pytest.fixture
def tiny_mix(monkeypatch):
    for mixes in (jworkload.MIXES, pworkload.MIXES):
        monkeypatch.setitem(mixes, "tiny", {"synth-small": 1.0})


def _jax_drain(tmp_path, monkeypatch, **kw):
    monkeypatch.setenv("CRDT_BENCH_SANITIZE_SYNCS", "1")
    try:
        r, _info = jbench.run_serve_bench(
            results_dir=str(tmp_path / "jax"), log=lambda *a, **k: None,
            **{**TINY, **kw})
    finally:
        monkeypatch.delenv("CRDT_BENCH_SANITIZE_SYNCS")
    return r.extra


def _port_drain(**kw):
    return pbench.run_serve_bench(device="cpu", sanitize=("syncs",),
                                  log=lambda *a, **k: None,
                                  **{**TINY, **kw})


@pytest.mark.parametrize("name", list(DRAINS))
def test_fence_entries_equal_jax(name, tmp_path, monkeypatch, tiny_mix):
    jx = _jax_drain(tmp_path, monkeypatch, **DRAINS[name])
    px = _port_drain(**DRAINS[name])
    jb, pb = jx["boundary_syncs"], px["boundary_syncs"]
    assert pb["entries"] == jb["entries"]
    assert pb["entries"]  # every drain crosses its boundary pulls
    for k in ("sanitized", "chaos", "journal", "flight", "reshard"):
        assert pb[k] == jb[k], k
    # each package's own sync count, on fences both packages declare
    assert set(pb["syncs"]) <= set(pb["entries"])
    assert px["verify_ok"]


def test_fence_instants_in_the_trace_equal_jax(tmp_path, monkeypatch,
                                               tiny_mix):
    kw = dict(journal_dir="auto", snapshot_every=3)
    jx = _jax_drain(tmp_path, monkeypatch,
                    trace_path=str(tmp_path / "jax.json"), **kw)
    px = _port_drain(trace_path=str(tmp_path / "port.json"), **kw)
    assert jx["trace"] and px["trace"]

    def instants(path):
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        return [e["name"] for e in events
                if e.get("ph") == "i" and e.get("cat") == "fence"]

    got, want = instants(tmp_path / "port.json"), instants(
        tmp_path / "jax.json")
    assert got == want
    # the trace covers the drain (the verify after it pulls rows too)
    entries = px["boundary_syncs"]["entries"]
    assert got and all(got.count(n) <= entries[n] for n in set(got))


def test_an_item_on_the_hot_path_outside_a_fence_raises():
    t = torch.arange(4, dtype=torch.int32)
    sanitizer.reset_counters()
    sanitizer.arm()
    try:
        with sanitizer.hot_path("cpu"):
            with pytest.raises(sanitizer.UndeclaredSyncError, match="item"):
                t[1].item()
            with pytest.raises(sanitizer.UndeclaredSyncError,
                               match="tolist"):
                t.tolist()
            with sanitizer.fence("probe"):
                assert t[2].item() == 2 and int(t[3]) == 3
        # outside the hot path a sync is no one's business
        assert t.tolist() == [0, 1, 2, 3]
    finally:
        sanitizer.disarm()
    assert sanitizer.counters() == {"entries": {"probe": 1},
                                    "syncs": {"probe": 2}}


def test_disarmed_counts_entries_only_and_restores_the_tensor_type():
    before = {name: torch.Tensor.__dict__.get(name)
              for name in sanitizer._SYNC_SURFACE}
    sync_before = torch.cuda.synchronize
    t = torch.ones(3)

    @sanitizer.fenced
    def pull():
        return t.sum().item()

    sanitizer.reset_counters()
    with sanitizer.hot_path("cpu"):
        assert pull() == 3.0
        assert t[0].item() == 1.0  # disarmed: no hooks, no raise
    assert sanitizer.counters() == {
        "entries": {pull.__graft_fence__: 1}, "syncs": {}}
    sanitizer.arm()
    assert torch.Tensor.__dict__["item"].__graft_sanitizer__
    with pytest.raises(sanitizer.UndeclaredSyncError):
        with sanitizer.hot_path("cpu"):
            bool(t[0])
    sanitizer.disarm()
    assert {name: torch.Tensor.__dict__.get(name)
            for name in sanitizer._SYNC_SURFACE} == before
    assert torch.cuda.synchronize is sync_before
    assert not sanitizer.armed()


def test_a_drain_that_raises_leaves_the_tensor_type_as_it_was(tiny_mix):
    before = {name: torch.Tensor.__dict__.get(name)
              for name in sanitizer._SYNC_SURFACE}

    def hook(pool):
        raise RuntimeError("the drain stops here")

    with pytest.raises(RuntimeError, match="stops here"):
        pbench.run_serve_bench(device="cpu", sanitize="syncs,ranges",
                               pool_hook=hook, log=lambda *a, **k: None,
                               **TINY)
    assert {name: torch.Tensor.__dict__.get(name)
            for name in sanitizer._SYNC_SURFACE} == before
    assert not sanitizer.armed()


def test_a_profiled_drain_runs_the_profiler_hooks_outside_the_hot_path(
        monkeypatch, tiny_mix):
    """Stopping a CUDA capture synchronizes the device (torch's profiler
    exit calls ``torch.cuda.synchronize``), so the profiler's round hooks
    run outside the hot scope.  On the CPU a tensor read in each hook
    stands for that sync: inside the hot scope it would raise."""
    from crdt_benches_tpu_torch.obs import profiler as pprofiler

    probe = torch.ones(1)
    hooks = []
    real_begin = pprofiler.DeviceProfiler.round_begin
    real_end = pprofiler.DeviceProfiler.round_end

    def round_begin(self):
        hooks.append(probe.item())
        return real_begin(self)

    def round_end(self, steady):
        hooks.append(probe.item())
        return real_end(self, steady)

    monkeypatch.setattr(pprofiler.DeviceProfiler, "round_begin",
                        round_begin)
    monkeypatch.setattr(pprofiler.DeviceProfiler, "round_end", round_end)
    rep = _port_drain(profile_rounds=2)
    assert rep["verify_ok"] and hooks
    assert rep["profile"]["rounds"] == 2
    assert rep["boundary_syncs"]["sanitized"]


def test_unknown_sanitizer_word_is_refused(tiny_mix):
    with pytest.raises(ValueError, match="unknown sanitizer"):
        pbench.run_serve_bench(device="cpu", sanitize="syncs,typo",
                               log=lambda *a, **k: None, **TINY)


@pytest.mark.parametrize("mesh", [0, 2], ids=["pool", "mesh"])
def test_the_macro_step_uploads_its_ops_without_a_blocking_copy(
        mesh, monkeypatch, tiny_mix):
    """The staged ops cross to the device with ``non_blocking=True``: a
    blocking host-to-device copy from pageable memory synchronizes the
    stream, a host sync on the hot path that JAX's ``device_put`` does not
    make (the card's native tripwire refuses it; ROADMAP.md Queue 3)."""
    from crdt_benches_tpu_torch.serve import pool as pool_mod

    uploads = []
    real_to = torch.Tensor.to
    real_step = pool_mod.DocPool.macro_step

    def to(self, *args, **kwargs):
        if args and isinstance(args[0], (torch.device, str)):
            uploads.append(kwargs.get("non_blocking", False))
        return real_to(self, *args, **kwargs)

    def step(self, *args, **kwargs):
        monkeypatch.setattr(torch.Tensor, "to", to)
        try:
            return real_step(self, *args, **kwargs)
        finally:
            monkeypatch.setattr(torch.Tensor, "to", real_to)

    monkeypatch.setattr(pool_mod.DocPool, "macro_step", step)
    rep = _port_drain(mesh_devices=mesh)
    assert rep["verify_ok"] and uploads and all(uploads)
