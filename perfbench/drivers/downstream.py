"""Downstream: apply the trace's encoded remote updates to fresh replicas.

Set-up generates the updates outside the timed window through the
program's flagship entry (``models.flagship.downstream``, engine v5) at
the configuration's replicas and batch; one run is
``DownstreamEngine.run()`` (fresh replicas, every update batch) and the
length fetch, which waits for the device.  The timed region of the
reference's downstream group (noib3/crdt-benches, ``src/main.rs``).
"""

from __future__ import annotations

import numpy as np

from perfbench.port import as_port_input


class Session:
    def __init__(self, cell, trace, device):
        from crdt_benches_tpu_torch.models import flagship

        cfg = cell.config
        path = cfg["downstream"]
        self.replicas = cfg["replicas"]
        self.elements = trace.n_patches * self.replicas
        self.engine = flagship.downstream(
            as_port_input(trace),
            flagship.FlagshipConfig(n_replicas=self.replicas,
                                    batch=cfg["batch"], pack=cfg["pack"]),
            device=device,
        )
        want = (path["engine"], min(path["epoch"], self.engine.n_batches))
        if (self.engine.engine, self.engine.epoch) != want:
            raise RuntimeError(
                f"the program built engine {self.engine.engine} at epoch "
                f"{self.engine.epoch}, not the configuration's {want}")

    def run(self):
        return self.engine.run()

    def lengths(self, state) -> np.ndarray:
        return state.nvis.cpu().numpy()

    def decode(self, state, replica: int) -> str:
        return self.engine.decode(state, replica)
