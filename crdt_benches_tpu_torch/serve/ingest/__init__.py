"""The live ingest front door (the JAX package's ``serve/ingest/``): the
part that turns the serve stack from a batch replayer into a server.

- :mod:`.front`: a thread-confined TCP front (a sibling of
  ``obs/status.py``'s HTTP server) taking CRC-framed op batches on
  per-session connections; its one crossing into the hot drain is a
  bounded queue;
- :mod:`.admission`: per-tenant admission control (token buckets,
  per-tenant queue budgets, and SLO-aware admit/defer/shed driven by the
  class burn rates ``obs/slo.py`` tracks).  Sheds are journaled in the
  overflow shed's record shape, so ``recover_fleet`` replays them;
- :mod:`.deadline`: ``DeadlineScheduler``, a ``FleetScheduler`` subclass
  selecting earliest-deadline-first over per-class latency budgets in
  place of round-robin; the macro-round staging is untouched;
- :mod:`.loadgen`: the open-loop load family (``serve/open/<mix>/<fleet>``):
  seeded Poisson or burst arrivals at a configured offered load, the hot
  pump that joins the front to the scheduler's bounded queues, and the
  drive loop.
"""

from .admission import (AdmissionController, TenantPolicy,
                        TenantSpecError, parse_tenant_spec)
from .deadline import DeadlineScheduler
from .front import FRAME_KINDS, IngestFront, decode_frame, encode_frame
from .loadgen import (IngestPump, OpenLoadClient, OpenLoadPlan,
                      build_open_plan, drive_open_loop, parse_open_spec)

__all__ = [
    "AdmissionController",
    "TenantPolicy",
    "TenantSpecError",
    "parse_tenant_spec",
    "DeadlineScheduler",
    "IngestFront",
    "FRAME_KINDS",
    "encode_frame",
    "decode_frame",
    "IngestPump",
    "OpenLoadClient",
    "OpenLoadPlan",
    "build_open_plan",
    "drive_open_loop",
    "parse_open_spec",
]
