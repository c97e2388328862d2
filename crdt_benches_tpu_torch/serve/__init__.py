"""The serving fleet: many independent documents in a few batched device
states (``pool.py``), drained in macro-rounds by a deterministic host
scheduler (``scheduler.py``) over a multi-tenant workload
(``workload.py``); ``bench.py`` builds, drains and verifies one fleet."""
