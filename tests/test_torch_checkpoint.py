"""Checkpoints of every engine state (``crdt_benches_tpu_torch/utils/
checkpoint.py``) against the JAX package's: a file written by either
package loads in the other exactly, for all six state classes, with the
port's int16 ``cv_intile`` held as the JAX package's bfloat16; the write
is atomic, damage is detected, and a file without a CRC manifest loads
unverified."""

import os
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine import downstream as jds
from crdt_benches_tpu.ops import apply as japply
from crdt_benches_tpu.ops import apply2 as japply2
from crdt_benches_tpu.utils import checkpoint as jcp
from crdt_benches_tpu_torch.engine import downstream as pds
from crdt_benches_tpu_torch.engine.replay_range import (
    RangeReplayEngine,
    replay_ranges,
)
from crdt_benches_tpu_torch.ops import apply as papply
from crdt_benches_tpu_torch.ops import apply2 as papply2
from crdt_benches_tpu_torch.traces.synth import synth_trace
from crdt_benches_tpu_torch.traces.tensorize import tensorize_ranges
from crdt_benches_tpu_torch.utils import checkpoint as cp

R, C = 3, 256
#: class name -> (port class, JAX class, {field: (dtype, shape)})
CLASSES = {
    "DocState": (papply.DocState, japply.DocState, {
        "order": ("int32", (R, C)), "visible": ("bool", (R, C)),
        "origin": ("int32", (R, C)), "length": ("int32", (R,)),
        "nvis": ("int32", (R,))}),
    "DownState": (pds.DownState, jds.DownState, {
        "order": ("int32", (R, C)), "visible": ("bool", (R, C)),
        "length": ("int32", (R,)), "nvis": ("int32", (R,))}),
    "ReplayState": (papply2.ReplayState, japply2.ReplayState, {
        "order": ("int32", (R, C)), "vis": ("int32", (R, C)),
        "length": ("int32", (R,)), "nvis": ("int32", (R,))}),
    "PackedState": (papply2.PackedState, japply2.PackedState, {
        "doc": ("int32", (R, C)), "length": ("int32", (R,)),
        "nvis": ("int32", (R,))}),
    "PackedState4": (papply2.PackedState4, japply2.PackedState4, {
        "doc": ("int32", (R, C)), "cv_intile": ("cv", (R, C)),
        "vis_tile": ("int32", (R, C // 128)), "length": ("int32", (R,)),
        "nvis": ("int32", (R,))}),
    "DownPacked": (pds.DownPacked, jds.DownPacked, {
        "doc": ("int32", (R, C)), "snap": ("int32", (R, C)),
        "length": ("int32", (R,)), "nvis": ("int32", (R,))}),
}


def _arrays(name, seed=0):
    """Random field values of class ``name`` as numpy (cv_intile int16 in
    [0, 128], the range a tile's in-tile count takes)."""
    rng = np.random.default_rng(seed)
    out = {}
    for f, (dt, shape) in CLASSES[name][2].items():
        if dt == "bool":
            out[f] = rng.random(shape) < 0.5
        elif dt == "cv":
            out[f] = rng.integers(0, 129, shape).astype(np.int16)
        else:
            out[f] = rng.integers(-(1 << 30), 1 << 30, shape).astype(
                np.int32)
    return out


def _jax_state(name, arrays):
    cls = CLASSES[name][1]
    return cls(**{f: (jnp.asarray(a, jnp.bfloat16) if f == "cv_intile"
                      else jnp.asarray(a)) for f, a in arrays.items()})


def _port_state(name, arrays):
    cls = CLASSES[name][0]
    return cls(**{f: torch.from_numpy(a.copy()) for f, a in arrays.items()})


def _manifest(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_jax_checkpoint_loads_in_the_port_exactly(tmp_path, name):
    arrays = _arrays(name, seed=1)
    path = str(tmp_path / "jax.npz")
    jcp.save_state(path, _jax_state(name, arrays))
    st = cp.load_state(path)
    assert type(st) is CLASSES[name][0]
    for f, a in arrays.items():
        got = getattr(st, f)
        assert got.dtype == a.dtype, f
        np.testing.assert_array_equal(got, a, err_msg=f)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_port_checkpoint_loads_in_jax_exactly(tmp_path, name):
    arrays = _arrays(name, seed=2)
    path = str(tmp_path / "port.npz")
    cp.save_state(path, _port_state(name, arrays))
    st = jcp.load_state(path)
    assert type(st) is CLASSES[name][1]
    for f, a in arrays.items():
        got = np.asarray(getattr(st, f))
        if f == "cv_intile":
            assert got.dtype == np.dtype(ml_dtypes.bfloat16)
            got = got.astype(np.int16)
        assert got.dtype == a.dtype, f
        np.testing.assert_array_equal(got, a, err_msg=f)


@pytest.mark.parametrize("name", sorted(CLASSES))
@pytest.mark.parametrize("compress", [True, False])
def test_both_packages_write_the_same_manifest_and_arrays(tmp_path, name,
                                                          compress):
    arrays = _arrays(name, seed=3)
    cp.save_state(str(tmp_path / "p.npz"), _port_state(name, arrays),
                  compress=compress)
    jcp.save_state(str(tmp_path / "j.npz"), _jax_state(name, arrays),
                   compress=compress)
    got, want = _manifest(tmp_path / "p.npz"), _manifest(tmp_path / "j.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert str(got["__class__"]) == name


def test_fresh_states_and_a_round_trip_through_the_port(tmp_path):
    """The port's own fresh PackedState4 and DownPacked, saved and loaded
    by the port, equal the JAX package's fresh states field by field."""
    for mine, ref in (
        (papply2.init_state4(2, 256, 7, device="cpu"),
         japply2.init_state4(2, 256, 7)),
        (pds.down_packed_init(2, 256, 7, device="cpu"),
         jds.down_packed_init(2, 256, 7)),
    ):
        path = str(tmp_path / "s.npz")
        cp.save_state(path, mine)
        back = cp.load_state(path)
        for f in mine._fields:
            want = np.asarray(getattr(ref, f))
            if want.dtype == np.dtype(ml_dtypes.bfloat16):
                want = want.astype(np.int16)
            np.testing.assert_array_equal(getattr(back, f), want,
                                          err_msg=f)
            np.testing.assert_array_equal(getattr(back, f),
                                          getattr(mine, f).numpy())


def test_bf16_conversion_refuses_inexact_values(tmp_path):
    arrays = _arrays("PackedState4")
    arrays["cv_intile"][0, 0] = 257  # not exact in bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        cp.save_state(str(tmp_path / "x.npz"),
                      _port_state("PackedState4", arrays))
    assert os.listdir(tmp_path) == []
    # a JAX file whose bfloat16 field holds a fraction is damage here
    arrays = _arrays("PackedState4")
    st = _jax_state("PackedState4", arrays)._replace(
        cv_intile=jnp.full((R, C), 0.5, jnp.bfloat16))
    jcp.save_state(str(tmp_path / "f.npz"), st)
    with pytest.raises(cp.CorruptCheckpointError, match="int16"):
        cp.load_state(str(tmp_path / "f.npz"))


def test_replay_resumes_exactly_from_a_checkpoint(tmp_path):
    """A v3 range replay stopped after a batch, saved, loaded and resumed
    ends in the state of the uninterrupted replay."""
    rt = tensorize_ranges(synth_trace(seed=4, n_ops=160), batch=8)
    eng = RangeReplayEngine(rt, n_replicas=2, engine="v3", device="cpu")
    want = eng.run()
    kind, pos, rlen, slot0 = (torch.as_tensor(a) for a in rt.batched())
    st = papply2.init_state3(2, eng.capacity, eng.n_init, device="cpu")
    half = rt.n_batches // 2
    st, _ = replay_ranges(st, kind[:half], pos[:half], rlen[:half],
                          slot0[:half])
    path = str(tmp_path / "mid.npz")
    cp.save_state(path, st)
    back = cp.load_state(path)
    st = papply2.PackedState(*(torch.from_numpy(getattr(back, f))
                               for f in back._fields))
    st, _ = replay_ranges(st, kind[half:], pos[half:], rlen[half:],
                          slot0[half:])
    for f in st._fields:
        a, b = getattr(st, f), getattr(want, f)
        assert torch.equal(a[..., :b.shape[-1]] if a.dim() == 2 else a, b), f


def _small_state(r=2, c=256):
    rng = np.random.default_rng(5)
    return papply2.PackedState(
        doc=rng.integers(0, 1 << 20, (r, c)).astype(np.int32),
        length=np.asarray([c] * r, np.int32),
        nvis=np.asarray([c // 2] * r, np.int32),
    )


def test_save_state_atomic_on_midwrite_crash(tmp_path, monkeypatch):
    """A save killed mid-write leaves the previous checkpoint intact and
    no temp file behind."""
    st = _small_state()
    path = str(tmp_path / "spool.npz")
    cp.save_state(path, st, compress=False)
    with open(path, "rb") as fh:
        good = fh.read()

    def boom(fh, **kw):
        fh.write(b"partial garbage that must never reach the target")
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(RuntimeError, match="killed mid-write"):
        cp.save_state(path, _small_state(3, 128), compress=False)
    with open(path, "rb") as fh:
        assert fh.read() == good
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    st2 = cp.load_state(path)
    for f in st._fields:
        assert (np.asarray(getattr(st, f)) == getattr(st2, f)).all()


@pytest.mark.parametrize("damage", ["bitflip", "truncate"])
def test_load_state_detects_damage(tmp_path, damage):
    path = str(tmp_path / "st.npz")
    cp.save_state(path, _small_state(), compress=False)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if damage == "bitflip":
            f.seek(size // 2)
            chunk = f.read(8)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        else:
            f.truncate(int(size * 0.6))
    with pytest.raises(cp.CorruptCheckpointError):
        cp.load_state(path)
    with pytest.raises(jcp.CorruptCheckpointError):
        jcp.load_state(path)


def test_load_state_legacy_no_crc_manifest(tmp_path):
    """A checkpoint without ``__crcs__`` loads with verification skipped,
    in both packages."""
    st = _small_state()
    path = str(tmp_path / "legacy.npz")
    arrays = {f: np.asarray(getattr(st, f)) for f in st._fields}
    np.savez(
        path, __class__=np.asarray("PackedState"),
        __fields__=np.asarray(st._fields),
        __dtypes__=np.asarray([str(a.dtype) for a in arrays.values()]),
        **arrays,
    )
    for load in (cp.load_state, jcp.load_state):
        st2 = load(path)
        for f in st._fields:
            assert (arrays[f] == np.asarray(getattr(st2, f))).all()


def test_checkpoint_legacy_void_fails_loudly(tmp_path):
    """A bfloat16 field saved with no dtype manifest cannot be decoded:
    a clear error, not opaque void arrays."""
    st = japply2.init_state4(1, 128, 0)
    path = str(tmp_path / "legacy.npz")
    arrays = {f: np.asarray(getattr(st, f)) for f in st._fields}
    np.savez_compressed(
        path, __class__=np.asarray("PackedState4"),
        __fields__=np.asarray(st._fields), **arrays,
    )
    with pytest.raises(cp.CorruptCheckpointError, match="dtype manifest"):
        cp.load_state(path)


def test_crc_manifest_covers_the_bf16_bits(tmp_path):
    """The stored CRC of cv_intile is the CRC of the bfloat16 bits, as the
    JAX package computes it."""
    arrays = _arrays("PackedState4", seed=9)
    path = str(tmp_path / "c.npz")
    cp.save_state(path, _port_state("PackedState4", arrays))
    z = _manifest(path)
    i = list(z["__fields__"]).index("cv_intile")
    bits = np.asarray(arrays["cv_intile"], np.float32).astype(
        ml_dtypes.bfloat16).view(np.uint16)
    assert int(z["__crcs__"][i]) == zlib.crc32(bits.tobytes())
    assert str(z["__dtypes__"][i]) == "bfloat16"
