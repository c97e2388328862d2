"""Carry a replay state between the JAX reference and the port, as numpy
arrays, so both sides can start a batch from the same state.

The JAX side holds ``cv_intile`` as bf16; its caller casts it to int32
before ``np.asarray``.  The port holds it as int16 (values are at most
128); :func:`state4_to_numpy` hands it back as int32 for comparison by
value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.apply2 import LANE, PackedState4

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
