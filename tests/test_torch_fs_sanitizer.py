"""The port's fs sanitizer (``crdt_benches_tpu_torch/lint/fs_sanitizer.py``)
against the JAX package's (``crdt_benches_tpu/lint/fs_sanitizer.py``).

The same journaled drain runs in both packages with the fs sanitizer
armed (JAX's by its environment variable through ``monkeypatch``, the
port's by ``run_serve_bench(sanitize=("fs",))``).  Exact: the op log, op
by op — (protocol, operation, the basename, with a temporary directory's
random name taken relative to its root) — and the ``fs_ops`` block.  The
sanitizer's own rules: a destructive op on a durable path before any
committed install raises ``DurableOrderingError``, a crash point freezes
every later op, and disarming puts ``open``, ``os`` and ``shutil`` back.
The crash enumeration is ``tests/test_torch_fscrash.py``.  Nothing here is
timed."""

import builtins
import os
import re
import shutil

import pytest

from crdt_benches_tpu.lint import fs_sanitizer as jfs
from crdt_benches_tpu.serve import bench as jbench
from crdt_benches_tpu.serve import workload as jworkload
from crdt_benches_tpu_torch.lint import fs_sanitizer as pfs
from crdt_benches_tpu_torch.serve import bench as pbench
from crdt_benches_tpu_torch.serve import workload as pworkload

TINY = dict(mix="tiny", n_docs=24, batch=8, macro_k=4, batch_chars=32,
            classes=(128, 512), slots=(6, 2), arrival_span=2,
            verify_sample=4, journal_dir="auto", snapshot_every=3,
            snapshot_full_every=2, wal_segment_bytes=512)

#: a temporary directory's name (the journal's and the spool's roots)
_TMP = re.compile(r"^crdt_\w+?_[A-Za-z0-9_]{8}$")


def _relative(log):
    return [(tag, op, "<root>" if _TMP.match(name) else name)
            for tag, op, name in log]


@pytest.fixture
def tiny_mix(monkeypatch):
    for mixes in (jworkload.MIXES, pworkload.MIXES):
        monkeypatch.setitem(mixes, "tiny", {"synth-small": 1.0})


@pytest.mark.parametrize("extra", [{}, {"serve_tiers": "hot=6,warm=4"}],
                         ids=["journal", "tiers"])
def test_op_log_equals_jax_op_by_op(extra, tmp_path, monkeypatch, tiny_mix):
    kw = {**TINY, **extra}
    if extra:  # the prefetch thread's timing must not pick the reads
        monkeypatch.setattr(jbench.DocPool, "__init__", _no_prefetch(
            jbench.DocPool.__init__))
        monkeypatch.setattr(pbench.DocPool, "__init__", _no_prefetch(
            pbench.DocPool.__init__))
    monkeypatch.setenv("CRDT_BENCH_SANITIZE_FS", "1")
    try:
        r, _ = jbench.run_serve_bench(results_dir=str(tmp_path / "jax"),
                                      log=lambda *a, **k: None, **kw)
        want = _relative(jfs.op_log())
    finally:
        monkeypatch.delenv("CRDT_BENCH_SANITIZE_FS")
        jfs.disarm()
    rep = pbench.run_serve_bench(device="cpu", sanitize=("fs",),
                                 log=lambda *a, **k: None, **kw)
    got = _relative(pfs.op_log())
    assert got == want
    assert {op for _, op, _ in got} >= {"write", "append", "replace",
                                        "fsync", "read", "rmtree"}
    jb, pb = r.extra["fs_ops"], rep["fs_ops"]
    assert pb == jb
    assert pb["sanitized"] and pb["ops"]["snapshot"]["replace"] > 0
    assert not pfs.armed()


def _no_prefetch(init):
    def patched(self, *a, **k):
        k["prefetch"] = False
        init(self, *a, **k)
    return patched


def test_a_destructive_op_before_its_install_raises(tmp_path):
    (tmp_path / "durable").mkdir()
    root = str(tmp_path / "durable")  # the model watches str paths
    with open(os.path.join(root, "member.npz"), "wb") as fh:
        fh.write(b"x")
    pfs.clear_watch_roots()
    pfs.watch_root(root)
    pfs.reset_counters()
    pfs.arm()
    try:
        with pytest.raises(pfs.DurableOrderingError, match="member.npz"):
            with pfs.fs_protocol("gc"):
                os.unlink(os.path.join(root, "member.npz"))
        with pfs.fs_protocol("snapshot"):
            with open(os.path.join(root, "next.tmp"), "w") as fh:
                fh.write("y")
            os.replace(os.path.join(root, "next.tmp"),
                       os.path.join(root, "next.npz"))
            # after a committed install
            os.unlink(os.path.join(root, "member.npz"))
        assert pfs.op_log() == [
            ("snapshot", "write", "next.tmp"),
            ("snapshot", "replace", "next.npz"),
            ("snapshot", "unlink", "member.npz")]
        assert pfs.counters()["protocols"] == {"gc": 1, "snapshot": 1}
    finally:
        pfs.disarm()
        pfs.clear_watch_roots()


def test_a_crash_point_freezes_every_later_op(tmp_path):
    (tmp_path / "r").mkdir()
    root = str(tmp_path / "r")
    pfs.clear_watch_roots()
    pfs.watch_root(root)
    try:
        with pytest.raises(pfs.InjectedCrash):
            with pfs.crash_at(1):
                with pfs.fs_protocol("wal"):
                    with open(os.path.join(root, "a"), "w") as fh:
                        fh.write("1")
                    with open(os.path.join(root, "b"), "w") as fh:  # crash
                        fh.write("2")
        assert os.listdir(root) == ["a"]
        assert pfs.mutation_count() == 2
        assert not pfs.armed()
    finally:
        pfs.clear_watch_roots()


def test_disarm_puts_the_filesystem_surface_back():
    before = (builtins.open, os.replace, os.rename, os.link, os.unlink,
              os.remove, os.fsync, shutil.rmtree)
    pfs.arm()
    assert os.replace is not before[1]
    pfs.disarm()
    assert (builtins.open, os.replace, os.rename, os.link, os.unlink,
            os.remove, os.fsync, shutil.rmtree) == before
    pfs.reset_counters()
    with pfs.fs_protocol("flight"):
        pass
    assert pfs.counters() == {"protocols": {"flight": 1}, "ops": {},
                              "unattributed": {}}
