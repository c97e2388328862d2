"""``upstream_replay_ms_p95``: the 95th percentile over every replay of
the window, each from fresh replicas to the synced length fetch, timed
by two CUDA events on the device's clock (a replay is shorter than the
host clock can time alone)."""

import numpy as np


def read(w):
    return float(np.percentile(w.run_ms, 95))
