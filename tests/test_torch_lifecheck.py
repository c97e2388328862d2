"""The port's lifecycle leak check (``crdt_benches_tpu_torch/serve/lifecheck.py``)
and lifecycle sanitizer against the JAX package's.

``run_lifecheck(small=True)`` runs the churn drain (residency churn on a
small hot budget, a live reshard, a real ingest front with a churned and
resumed session, the warm tier's prefetch thread) and the record-evicting
streamed drain with the lifecycle sanitizer armed: zero leaks at each
drain's end, zero unattributed transitions, and the edge counts of every
machine and the acquire/release counts of every resource equal to JAX's
harness.  The sanitizer's own rules: an undeclared edge, a wrong-state
departure, a double release, a use after release and a negative gauge
raise.  The port runs on the CPU.  Nothing here is timed."""

import pytest

from crdt_benches_tpu.serve.lifecheck import run_lifecheck as jax_lifecheck
from crdt_benches_tpu_torch.lint import lifecycle_sanitizer as lc
from crdt_benches_tpu_torch.serve import lifecheck


def test_zero_leaks_and_edge_counts_equal_jax(tmp_path):
    got = lifecheck.run_lifecheck(workdir=str(tmp_path / "port"),
                                  small=True, device="cpu")
    want = jax_lifecheck(workdir=str(tmp_path / "jax"), small=True)
    assert got["leaked"] == 0 and got["unattributed"] == []
    assert got["machines"] == want["machines"]
    assert got["resources"] == want["resources"]
    assert got["churn"] == want["churn"]
    assert got["record_evict"] == want["record_evict"]
    for name in lifecheck._REQUIRED_MACHINES:
        assert got["machines"][name]
    assert not lc.armed()  # put back as it was found


def test_the_sanitizer_raises_at_each_violation():
    lc.declare_machine("probe", ("a", "b"), (("a", "b"),))
    lc.reset_counters()
    lc.arm()
    try:
        lc.transition("probe", "a", "b", key=1)
        with pytest.raises(lc.UndeclaredTransitionError, match="illegal"):
            lc.transition("probe", "b", "a", key=1)
        with pytest.raises(lc.UndeclaredTransitionError,
                           match="is in state"):
            lc.transition("probe", "a", "b", key=1)
        lc.acquire("rows", (128, 0))
        lc.touch("rows", (128, 0))
        lc.release("rows", (128, 0))
        with pytest.raises(lc.UseAfterReleaseError):
            lc.touch("rows", (128, 0))
        with pytest.raises(lc.DoubleReleaseError, match="double"):
            lc.release("rows", (128, 0))
        with pytest.raises(lc.NegativeGaugeError):
            lc.gauge("prefetch_inflight", -1)
        lc.acquire("socket", 7)
        with pytest.raises(lc.LifecycleLeakError, match="socket"):
            lc.assert_all_released()
    finally:
        lc.disarm()
        lc.reset_counters()
    # disarmed: counted, never enforced
    lc.transition("probe", "b", "a")
    lc.release("thread", 1)
    c = lc.counters()
    assert c["machines"] == {"probe": {"b->a": 1}}
    assert c["resources"] == {"thread": {"release": 1}}
    lc.reset_counters()
