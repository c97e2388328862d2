"""Upstream: replay the trace's local edits into fresh replicas.

Set-up builds the range engine through the program's flagship entry
(``models.flagship.upstream``) at the configuration's replicas, batch and
pack; one run is ``RangeReplayEngine.run()`` (fresh replicas, every op
batch) and the length fetch, which waits for the device.  The timed
region of the reference (noib3/crdt-benches, ``src/main.rs``).
"""

from __future__ import annotations

import numpy as np

from perfbench.port import as_port_input


class Session:
    def __init__(self, cell, trace, device):
        from crdt_benches_tpu_torch.engine.replay_range import RangeReplayEngine
        from crdt_benches_tpu_torch.models import flagship

        cfg = cell.config
        path = cfg["upstream"]
        self.replicas = cfg["replicas"]
        self.elements = trace.n_patches * self.replicas
        self.engine = flagship.upstream(
            as_port_input(trace),
            flagship.FlagshipConfig(n_replicas=self.replicas,
                                    batch=cfg["batch"], pack=cfg["pack"],
                                    layout=path["layout"]),
            device=device,
        )
        if not (isinstance(self.engine, RangeReplayEngine)
                and self.engine.engine == path["range_engine"]):
            raise RuntimeError(
                f"the program built {type(self.engine).__name__} "
                f"{getattr(self.engine, 'engine', '?')}, not the "
                f"configuration's range engine {path['range_engine']}")

    def run(self):
        return self.engine.run()

    def lengths(self, state) -> np.ndarray:
        return state.nvis.cpu().numpy()

    def decode(self, state, replica: int) -> str:
        return self.engine.decode(state, replica)
