"""The port's crash-point enumeration (``crdt_benches_tpu_torch/serve/fscrash.py``)
against the JAX package's (``crdt_benches_tpu/serve/fscrash.py``).

``enumerate_crash_points(small=True)`` drives the small protocol-complete
fleet (WAL, snapshot barriers, segment GC, spool churn, a live reshard, a
flight dump) under the armed fs sanitizer, then crashes a fresh run at
every mutating operation and recovers it: every point must recover to the
oracle's bytes with the shard partition whole.  Exact against JAX's
harness: the number of points and their count by protocol.  The port runs
on the CPU through its kernels' plain versions.  Nothing here is timed."""

from crdt_benches_tpu.serve.fscrash import (
    enumerate_crash_points as jax_enumerate,
)
from crdt_benches_tpu_torch.lint import fs_sanitizer
from crdt_benches_tpu_torch.serve import fscrash


def test_every_crash_point_recovers_and_counts_as_jax(tmp_path):
    got = fscrash.enumerate_crash_points(workdir=str(tmp_path / "port"),
                                         small=True, device="cpu")
    want = jax_enumerate(workdir=str(tmp_path / "jax"), small=True)
    assert got["verified"] == got["mutations"] > 0
    assert got["mutations"] == want["mutations"]
    assert got["per_protocol"] == want["per_protocol"]
    assert set(got["per_protocol"]) == set(fs_sanitizer.KNOWN_PROTOCOLS)
    assert not fs_sanitizer.armed()  # put back as it was found
