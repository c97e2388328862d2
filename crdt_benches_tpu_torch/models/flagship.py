"""Flagship configuration of the port: one configured engine family.

- ``upstream(trace)``: local-edit replay (the Upstream capability);
- ``downstream(trace)``: remote-update apply (the Downstream capability).

``FlagshipConfig()`` with no arguments is the configuration
``python -m crdt_benches_tpu_torch.bench`` runs: the RLE-coalesced range
engine, 1024 replicas, op batch 1536; ``downstream()`` applies updates
with the v5 engine at the same width and batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..backends.torch_backend import TorchReplayBackend
from ..device import resolve_device
from ..engine.downstream import DownstreamEngine
from ..engine.replay_range import RangeReplayEngine
from ..traces.loader import TestData, load_testing_data
from ..traces.tensorize import tensorize


@dataclass
class FlagshipConfig:
    n_replicas: int = 1024  # replica-parallel width
    batch: int = 1536  # ops per resolver launch
    pack: int = 8  # chunk lengths round to a multiple of this
    #: 'auto' picks the coalesced range engine when RLE shrinks the op
    #: stream >= 2x (all four reference traces); 'range' forces it and
    #: 'unit' forces the unit-op engine.
    layout: str = "auto"


def backend(
    cfg: FlagshipConfig | None = None, device: str | torch.device = "cuda"
) -> TorchReplayBackend:
    """The flagship as a bench backend."""
    cfg = cfg or FlagshipConfig()
    return TorchReplayBackend(
        n_replicas=cfg.n_replicas,
        batch=cfg.batch,
        layout=None if cfg.layout == "auto" else cfg.layout,
        pack=cfg.pack,
        device=device,
    )


def upstream(
    trace: TestData | str, cfg: FlagshipConfig | None = None,
    device: str | torch.device = "cuda",
) -> RangeReplayEngine:
    """Local-edit replay engine for ``trace`` under ``cfg`` (engine
    selection is the backend's, so the two cannot drift apart)."""
    if isinstance(trace, str):
        trace = load_testing_data(trace)
    bk = backend(cfg, device=device)
    bk.prepare(trace)
    return bk.engine


def downstream(
    trace: TestData | str, cfg: FlagshipConfig | None = None,
    device: str | torch.device = "cuda",
) -> DownstreamEngine:
    """Remote-update apply engine for ``trace`` under ``cfg``: updates
    generated (untimed) at op batch ``cfg.batch``, applied to
    ``cfg.n_replicas`` replicas by the v5 engine (other engines:
    :class:`DownstreamEngine` directly)."""
    device = resolve_device(device)
    cfg = cfg or FlagshipConfig()
    if isinstance(trace, str):
        trace = load_testing_data(trace)
    return DownstreamEngine(
        tensorize(trace, batch=cfg.batch), n_replicas=cfg.n_replicas,
        engine="v5", device=device,
    )
