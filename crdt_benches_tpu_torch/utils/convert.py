"""Carry replay states and resolved batches between the JAX reference and
the port, as numpy arrays, so both sides can start a batch from the same
state and the same ``ResolvedBatch``.

The serving fleet's carriers: :func:`rounds_from_jax` for a macro
dispatch's K resolved rounds, :func:`buckets_from_jax` for a pool's
bucket stacks.

The JAX side holds ``cv_intile`` as bf16; its caller casts it to int32
before ``np.asarray``.  The port holds it as int16 (values are at most
128); :func:`state4_to_numpy` hands it back as int32 for comparison by
value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.apply2 import LANE, PackedState, PackedState4, ReplayState
from ..ops.resolve import ResolvedBatch

_FIELDS = ("doc", "cv_intile", "vis_tile", "length", "nvis")


def state4_from_jax(
    arrays: dict[str, np.ndarray], device: str | torch.device = "cuda"
) -> PackedState4:
    """A port state from a JAX ``PackedState4``'s arrays (numpy, with
    ``cv_intile`` already cast to an integer dtype)."""
    dev = resolve_device(device)
    missing = [f for f in _FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"state arrays missing {missing}")
    R, C = np.shape(arrays["doc"])
    cv = np.asarray(arrays["cv_intile"])
    if not np.issubdtype(cv.dtype, np.integer):
        raise ValueError(f"cv_intile must be integer, got {cv.dtype}")
    want = {"doc": (R, C), "cv_intile": (R, C), "vis_tile": (R, C // LANE),
            "length": (R,), "nvis": (R,)}
    for f in _FIELDS:
        if np.shape(arrays[f]) != want[f]:
            raise ValueError(
                f"{f}: shape {np.shape(arrays[f])}, want {want[f]}"
            )
    t = lambda a, dt: torch.tensor(np.asarray(a), device=dev).to(dt)
    return PackedState4(
        doc=t(arrays["doc"], torch.int32),
        cv_intile=t(cv, torch.int16),
        vis_tile=t(arrays["vis_tile"], torch.int32),
        length=t(arrays["length"], torch.int32),
        nvis=t(arrays["nvis"], torch.int32),
    )


def state4_to_numpy(state: PackedState4) -> dict[str, np.ndarray]:
    """The port state's fields as int32 numpy arrays."""
    return {
        f: getattr(state, f).cpu().numpy().astype(np.int32) for f in _FIELDS
    }


def _from_numpy(cls, arrays, rows, dtypes, device):
    """A ``cls`` NamedTuple from numpy arrays: fields in ``rows`` are
    (R, C), the rest (R,); ``dtypes`` maps a field to its torch dtype
    (default int32)."""
    dev = resolve_device(device)
    missing = [f for f in cls._fields if f not in arrays]
    if missing:
        raise ValueError(f"arrays missing {missing}")
    shape2 = np.shape(arrays[rows[0]])
    for f in cls._fields:
        want = shape2 if f in rows else shape2[:1]
        if np.shape(arrays[f]) != want:
            raise ValueError(f"{f}: shape {np.shape(arrays[f])}, want {want}")
    return cls(**{
        f: torch.tensor(np.asarray(arrays[f]), device=dev).to(
            dtypes.get(f, torch.int32))
        for f in cls._fields
    })


def _to_numpy(state) -> dict[str, np.ndarray]:
    return {f: getattr(state, f).cpu().numpy() for f in state._fields}


def state2_from_jax(
    arrays: dict[str, np.ndarray], device: str | torch.device = "cuda"
) -> ReplayState:
    """A port ``ReplayState`` from a JAX ``ReplayState``'s arrays."""
    return _from_numpy(ReplayState, arrays, ("order", "vis"), {}, device)


def state2_to_numpy(state: ReplayState) -> dict[str, np.ndarray]:
    return _to_numpy(state)


def state3_from_jax(
    arrays: dict[str, np.ndarray], device: str | torch.device = "cuda"
) -> PackedState:
    """A port ``PackedState`` from a JAX ``PackedState``'s arrays."""
    return _from_numpy(PackedState, arrays, ("doc",), {}, device)


def state3_to_numpy(state: PackedState) -> dict[str, np.ndarray]:
    return _to_numpy(state)


def resolved_from_jax(
    arrays: dict[str, np.ndarray], device: str | torch.device = "cuda"
) -> ResolvedBatch:
    """A port ``ResolvedBatch`` ((R, B) leaves, ``ins_alive`` bool) from a
    replica-batched JAX ``ResolvedBatch``'s arrays."""
    return _from_numpy(
        ResolvedBatch, arrays, ResolvedBatch._fields,
        {"ins_alive": torch.bool}, device,
    )


def rounds_from_jax(tokens, dints, device: str | torch.device = "cuda"):
    """K resolved rounds as port tensors: tokens (ttype, ta, tch, tlen)
    int32[K, R, T] and dints (dlo, dhi, dcount) int32[K, R, B], from numpy
    (or any array numpy converts)."""
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    tokens, dints = tuple(map(t, tokens)), tuple(map(t, dints))
    K, R, T = tokens[0].shape
    B = dints[0].shape[2]
    for name, group, shape in (("tokens", tokens, (K, R, T)),
                               ("dints", dints, (K, R, B))):
        if any(tuple(x.shape) != shape for x in group):
            raise ValueError(f"{name}: shapes "
                             f"{[tuple(x.shape) for x in group]}, want {shape}")
    return tokens, dints


def buckets_from_jax(
    buckets: dict[int, dict[str, np.ndarray]],
    device: str | torch.device = "cuda",
) -> dict[int, PackedState]:
    """A pool's bucket stacks {class: PackedState} from the JAX pool's
    {class: {doc, length, nvis}} arrays."""
    out = {}
    for cls, arrays in buckets.items():
        st = state3_from_jax(arrays, device)
        if st.doc.shape[1] != cls:
            raise ValueError(f"bucket c{cls}: rows of {st.doc.shape[1]} slots")
        out[cls] = st
    return out
