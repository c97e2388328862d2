"""The port's replay as a bench backend (the counterpart of the JAX
package's ``backends/jax_backend.py``).

Timed region of :meth:`TorchReplayBackend.replay_once`: document init +
full replay + the final length fetch, which waits for the device (a
``.cpu()`` copy after the kernels on the same stream).  Tensorization and
op upload happen untimed in :meth:`prepare`.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..engine.replay import ReplayEngine
from ..engine.replay_range import RangeReplayEngine
from ..traces.loader import TestData
from ..traces.tensorize import coalesce_patches, tensorize, tensorize_ranges
from .base import BatchedReplay


class TorchReplayBackend(BatchedReplay):
    def __init__(self, n_replicas: int = 1, batch: int = 512,
                 layout: str | None = None, pack: int = 8,
                 unit_engine: str = "v4",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.batch = batch
        #: None/'auto' picks the coalesced range engine when RLE shrinks
        #: the op stream >= 2x and the unit-op engine otherwise; 'range'
        #: and 'unit' force one.
        self.layout = layout
        self.pack = pack
        #: the unit engine's apply: 'v4' (fused, default), 'v3' or 'v2'
        self.unit_engine = unit_engine
        self._eng: RangeReplayEngine | ReplayEngine | None = None
        self._end_len = 0

    @property
    def replicas(self) -> int:
        return self.n_replicas

    @property
    def engine(self) -> RangeReplayEngine | ReplayEngine:
        if self._eng is None:
            raise RuntimeError("call prepare(trace) first")
        return self._eng

    def prepare(self, trace: TestData) -> None:
        layout = self.layout or "auto"
        patches = None
        if layout == "auto":
            unit_ops = sum(
                d + len(ins) for _, d, ins in trace.iter_patches()
            )
            patches = list(coalesce_patches(trace))
            range_ops = sum(
                (1 if d else 0) + (1 if ins else 0) for _, d, ins in patches
            )
            layout = "range" if unit_ops >= 2 * range_ops else "unit"
        if layout == "unit":
            self._eng = ReplayEngine(
                tensorize(trace, batch=self.batch),
                n_replicas=self.n_replicas, engine=self.unit_engine,
                device=self.device,
            )
        elif layout == "range":
            rt = tensorize_ranges(
                trace, batch=self.batch, coalesce=True, patches=patches
            )
            self._eng = RangeReplayEngine(
                rt, n_replicas=self.n_replicas, pack=self.pack,
                device=self.device,
            )
        else:
            raise ValueError(f"unknown layout {layout!r}")
        self._end_len = len(trace.end_content)

    def replay_once(self) -> int:
        state = self.engine.run()  # includes the timed document init
        lengths = state.nvis.cpu()  # device -> host: waits for the kernels
        if not bool((lengths == self._end_len).all()):
            raise RuntimeError(
                f"length mismatch: {lengths.tolist()[:8]} != {self._end_len}"
            )
        return int(lengths[0])

    def final_content(self) -> str:
        return self.engine.decode(self.engine.run())
