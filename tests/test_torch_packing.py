"""The port's copy of the narrow-dtype op-lane packing against the JAX
package's ``ops/packing.py``: the same dtypes, the same packed arrays,
a lossless round trip, and the same refusals."""

import numpy as np
import pytest

from crdt_benches_tpu.ops import packing as jp
from crdt_benches_tpu_torch.ops import packing as pp


@pytest.mark.parametrize("max_class", [256, 49152, 65535, 65536, 1 << 20])
def test_lane_dtypes_equal_jax(max_class):
    assert pp.op_lane_dtypes(max_class) == jp.op_lane_dtypes(max_class)
    assert pp.NARROW_ID_BOUND == jp.NARROW_ID_BOUND


@pytest.mark.parametrize("max_class", [49152, 1 << 20])
def test_pack_and_widen_round_trip_equal_jax(max_class):
    rng = np.random.default_rng(3)
    his = [int(np.iinfo(d).max) for d in pp.op_lane_dtypes(max_class)]
    kind = rng.integers(0, 3, 4096).astype(np.int32)
    lanes = [rng.integers(0, min(h, 1 << 22) + 1, 4096).astype(np.int32)
             for h in his[1:]]
    for a, h in zip(lanes, his[1:]):
        a[0] = min(h, 1 << 22)  # the lane's boundary value
    got = pp.pack_ops(kind, *lanes, max_class=max_class)
    want = jp.pack_ops(kind, *lanes, max_class=max_class)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for w, orig in zip(pp.widen_ops(*got), (kind, *lanes)):
        assert w.dtype == np.int32
        np.testing.assert_array_equal(w, orig)


@pytest.mark.parametrize("lane", [1, 2, 3])
def test_pack_raises_where_jax_raises(lane):
    kind = np.zeros(4, np.int32)
    ok = np.zeros(4, np.int32)
    for bad in (np.array([0, 1, 65536, 2], np.int32),
                np.array([0, -1, 3, 2], np.int32)):
        args = [kind, ok, ok, ok]
        args[lane] = bad
        with pytest.raises(jp.OpRangeError) as want:
            jp.pack_ops(*args, max_class=49152)
        with pytest.raises(pp.OpRangeError) as got:
            pp.pack_ops(*args, max_class=49152)
        assert str(got.value) == str(want.value)
    # an out-of-range kind is refused too; int32 lanes take the big ids
    with pytest.raises(pp.OpRangeError):
        pp.pack_ops(np.array([999], np.int32), ok[:1], ok[:1], ok[:1],
                    max_class=49152)
    big = np.array([0, 1, 65536, 2], np.int32)
    out = pp.pack_ops(kind, big, big, big, max_class=1 << 20)
    assert all(o.dtype == np.int32 for o in out[1:])
