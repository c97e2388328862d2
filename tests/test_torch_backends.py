"""The port's host backends (``backends/native.py``, ``backends/
reconcile.py``, ``backends/base.py``) against the JAX package's: the
native rope, cola and CRDT columns, their byte-addressed forms, the
native downstream and the whole-document reconcile give byte-identical
content (cola: the same lengths) on a synthetic trace with multi-byte
chars and on sveltecomponent."""

import numpy as np
import pytest

from crdt_benches_tpu.backends import native as jn
from crdt_benches_tpu.backends import reconcile as jrec
from crdt_benches_tpu.backends.base import (
    downstream_backends as jax_downstream_backends,
)
from crdt_benches_tpu.backends.base import (
    upstream_backends as jax_upstream_backends,
)
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces.loader import TestData as JTestData
from crdt_benches_tpu.traces.loader import TestPatch as JTestPatch
from crdt_benches_tpu.traces.loader import TestTxn as JTestTxn
from crdt_benches_tpu.traces.patches import patch_arrays as jax_patch_arrays
from crdt_benches_tpu_torch.backends import native as pn
from crdt_benches_tpu_torch.backends.base import (
    Downstream,
    Upstream,
    downstream_backends,
    upstream_backends,
)
from crdt_benches_tpu_torch.backends.reconcile import PyReconcile
from crdt_benches_tpu_torch.traces.loader import (
    TestData,
    TestPatch,
    TestTxn,
    load_testing_data,
)
from crdt_benches_tpu_torch.traces.patches import patch_arrays

pytestmark = pytest.mark.skipif(
    not pn.native_available(), reason="libcrdtnative.so not built"
)

#: (port class, JAX class) of every native upstream column
PAIRS = [
    (pn.CppRope, jn.CppRope),
    (pn.CppRopeBytes, jn.CppRopeBytes),
    (pn.CppCrdt, jn.CppCrdt),
    (pn.CppCrdtBytes, jn.CppCrdtBytes),
    (pn.CppCola, jn.CppCola),
]
ALPHABET = "abc é€😀\n"


def _mixed_patches(seed: int, n_ops: int, base: str):
    """Random multi-char edits whose inserted text mixes 1- to 4-byte
    chars, as (pos, del, ins) tuples in char units."""
    rng = np.random.default_rng(seed)
    n = len(base)
    out = []
    for _ in range(n_ops):
        pos = int(rng.integers(0, n + 1))
        d = int(rng.integers(0, min(3, n - pos) + 1)) if rng.random() < 0.4 \
            else 0
        ins = "".join(ALPHABET[int(i)] for i in
                      rng.integers(0, len(ALPHABET), int(rng.integers(0, 4))))
        out.append((pos, d, ins))
        n += len(ins) - d
    return out


def _traces(seed=5, n_ops=400, base="héllo wörld — base 😀 "):
    """The same trace in both packages' types."""
    patches = _mixed_patches(seed, n_ops, base)
    jt = JTestData(base, "", [JTestTxn("", [JTestPatch(*p)
                                             for p in patches])])
    end = replay_trace(jt)
    jt = JTestData(base, end, jt.txns)
    pt = TestData(base, end, [TestTxn("", [TestPatch(*p) for p in patches])])
    return pt, jt


@pytest.fixture(scope="module")
def svelte():
    return load_testing_data("sveltecomponent")


def test_registries_name_the_references_columns():
    assert set(upstream_backends()) == set(jax_upstream_backends())
    assert set(downstream_backends()) == set(jax_downstream_backends())
    for name, cls in upstream_backends().items():
        ref = jax_upstream_backends()[name]
        assert issubclass(cls, Upstream)
        assert cls.EDITS_USE_BYTE_OFFSETS == ref.EDITS_USE_BYTE_OFFSETS
    assert issubclass(downstream_backends()["cpp-crdt"], Downstream)


@pytest.mark.parametrize("seed", [0, 5])
def test_chars_to_bytes_and_patch_arrays_equal_the_references(seed, svelte):
    pt, jt = _traces(seed=seed)
    for p, j in ((pt, jt), (svelte, None)):
        if j is None:
            from crdt_benches_tpu.traces.loader import load_testing_data as jl

            j = jl("sveltecomponent")
        pb, jb = p.chars_to_bytes(), j.chars_to_bytes()
        assert list(pb.iter_patches()) == [tuple(x) for x in
                                           jb.iter_patches()]
        for mode in (False, True):
            src_p, src_j = (pb, jb) if mode else (p, j)
            a = patch_arrays(src_p, bytes_mode=mode)
            b = jax_patch_arrays(src_j, bytes_mode=mode)
            for f in ("pos", "del_count", "ins_off", "ins_flat", "init"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert (a.n_patches, a.end_len) == (b.n_patches, b.end_len)


def _per_op(cls, trace):
    """Replay ``trace`` through ``cls``'s per-op interface in its offset
    units; returns (content, len)."""
    t = trace.chars_to_bytes() if cls.EDITS_USE_BYTE_OFFSETS else trace
    doc = cls.from_str(t.start_content)
    for pos, d, ins in t.iter_patches():
        doc.replace(pos, pos + d, ins)
    return doc.content(), len(doc)


@pytest.mark.parametrize("port,ref", PAIRS, ids=[p[0].NAME for p in PAIRS])
def test_per_op_replay_equals_the_reference(port, ref):
    pt, jt = _traces()
    got, ref_got = _per_op(port, pt), _per_op(ref, jt)
    assert got == ref_got
    if port is pn.CppCola:
        assert got == (None, len(pt.end_content.encode()))
    else:
        assert got[0] == pt.end_content


@pytest.mark.parametrize("port,ref", PAIRS, ids=[p[0].NAME for p in PAIRS])
@pytest.mark.parametrize("which", ["synthetic", "sveltecomponent"])
def test_one_call_replay_equals_the_reference(port, ref, which, svelte):
    if which == "synthetic":
        pt, jt = _traces(seed=11, n_ops=600)
    else:
        from crdt_benches_tpu.traces.loader import load_testing_data as jl

        pt, jt = svelte, jl("sveltecomponent")
    if port.EDITS_USE_BYTE_OFFSETS:
        pa = patch_arrays(pt.chars_to_bytes(), bytes_mode=True)
        ja = jax_patch_arrays(jt.chars_to_bytes(), bytes_mode=True)
    else:
        pa, ja = patch_arrays(pt), jax_patch_arrays(jt)
    assert port.replay_patches(pa) == ref.replay_patches(ja) == pa.end_len
    if hasattr(port, "replay_patches_content"):
        got = port.replay_patches_content(pa)
        assert got == ref.replay_patches_content(ja) == pt.end_content


def test_basic_ops_of_each_column():
    r = pn.CppRope.from_str("hello")
    r.insert(5, " world")
    r.remove(0, 1)
    r.replace(0, 4, "hi")
    assert r.content() == "hi world" and len(r) == 8
    b = pn.CppRopeBytes.from_str("héllo")
    assert len(b) == 6
    b.remove(1, 3)
    b.insert(1, "€")
    assert b.content() == "h€llo" and len(b) == 7
    c = pn.CppCola.from_str("héllo")
    c.insert(6, "😀")
    c.remove(0, 1)
    assert len(c) == 9 and c.content() is None
    y = pn.CppCrdtBytes.from_str("héllo")
    y.replace(1, 3, "e")
    assert y.content() == "hello" and len(y) == 5


def test_update_exchange_across_packages():
    """Updates the port's CRDT encodes apply in the reference's, and back:
    one native engine, one wire."""
    a = pn.CppCrdt.from_str("", agent=1)
    b = jn.CppCrdt.from_str("", agent=2)
    mark_a = mark_b = 0
    for text, at in [("hello", 0), (" world", 5), ("!", 11)]:
        a.insert(at, text)
        b.apply_update(a.encode_from(mark_a))
        mark_a = a.oplog_len()
    b.remove(0, 1)
    a.apply_update(b.encode_from(mark_b))
    assert a.content() == b.content() == "ello world!"
    big = pn.CppCrdt.from_str("", agent=3)
    big.insert(0, "x" * 500)
    wire = big.encode_from(0)
    assert len(wire) > 4096  # past the first encode buffer
    c = jn.CppCrdt.from_str("", agent=4)
    c.apply_update(wire)
    assert c.content() == "x" * 500


@pytest.mark.parametrize("which", ["synthetic", "sveltecomponent"])
def test_downstream_equals_the_reference(which, svelte):
    if which == "synthetic":
        pt, jt = _traces(seed=3, n_ops=300, base="downstream base ")
    else:
        from crdt_benches_tpu.traces.loader import load_testing_data as jl

        pt, jt = svelte, jl("sveltecomponent")
    down, updates = pn.CppCrdtDownstream.upstream_updates(pt)
    jdown, jupdates = jn.CppCrdtDownstream.upstream_updates(jt)
    assert updates == jupdates
    assert down.apply_all_native() == jdown.apply_all_native()
    assert down.content() == jdown.content() == pt.end_content
    fresh = down.clone()
    for u in updates:
        fresh.apply_update(u)
    assert fresh.content() == pt.end_content
    assert len(fresh) == len(pt.end_content)


def test_reconcile_is_registered_and_splices_like_the_reference():
    assert upstream_backends()["py-reconcile"] is PyReconcile
    for start, edits in (
        ("hello world", [(0, 5, "goodbye"), (8, 13, "")]),
        ("aaaa", [(1, 1, "a"), (2, 4, "")]),
        ("", [(0, 0, "abc"), (1, 2, "é😀")]),
    ):
        d, j = PyReconcile.from_str(start), jrec.PyReconcile.from_str(start)
        for s, e, t in edits:
            d.replace(s, e, t)
            j.replace(s, e, t)
            assert d.content() == j.content()
            assert len(d) == len(j)
            np.testing.assert_array_equal(d._doc_ids, j._doc_ids)
    with pytest.raises(NotImplementedError):
        PyReconcile.from_str("x").insert(0, "y")


@pytest.mark.parametrize("which", ["synthetic", "sveltecomponent"])
def test_reconcile_replay_equals_the_reference(which, svelte):
    if which == "synthetic":
        pt, jt = _traces(seed=8, n_ops=500)
    else:
        from crdt_benches_tpu.traces.loader import load_testing_data as jl

        pt, jt = svelte, jl("sveltecomponent")
    d, j = PyReconcile.from_str(pt.start_content), jrec.PyReconcile.from_str(
        jt.start_content)
    for (pos, dl, ins) in pt.iter_patches():
        d.replace(pos, pos + dl, ins)
        j.replace(pos, pos + dl, ins)
    assert d.content() == j.content() == pt.end_content
    np.testing.assert_array_equal(d._doc_ids, j._doc_ids)
