"""Per-tenant admission control for the live ingest front (the JAX
package's ``serve/ingest/admission.py``).

Every op batch the front delivers carries a tenant; before the pump pushes
it into a bounded per-doc queue the batch passes one
``AdmissionController.decide`` call, which returns one of three verbs:

- **admit**: tokens consumed, the ops flow into the doc's bounded queue;
- **defer**: the pump holds the batch and retries next macro-round (the
  token bucket is empty, the queue budget full, or the tenant's SLO class
  burns error budget faster than it refills: a fast-window spike);
- **shed**: the doc's stream is tail-dropped at its current delivery
  point, as the scheduler's ``queue_overflow`` shed does.  The decision is
  journaled as a ``t="shed"`` record (with a ``tenant`` field the replay
  ignores), so ``recover_fleet`` replays it with no recovery code of its
  own.  A shed fires on a sustained burn (fast and slow windows > 1.0) or
  when a batch has been deferred ``MAX_DEFERS`` times: a defer is a
  promise to retry, not a place to park ops for ever.

The burn rates come from ``obs/slo.py``: burn > 1.0 means the class
consumes error budget faster than the window refills it.  A fast-window
burn alone is a spike (defer and let it decay); fast and slow together is
a sustained incident (shed: the tenant is not going to catch up).

Tenant policy grammar (``--serve-tenants``)::

    name=RATE[:BURST[:BUDGET]][,name=...]

``RATE`` is tokens (ops) refilled a macro-round; ``BURST`` the bucket
depth (default ``4*RATE``); ``BUDGET`` caps the tenant's total in-queue ops
over its docs (default 0: unbounded).  Example:
``gold=256:1024,free=16:32:256``.

The controller belongs to the hot thread: ``decide`` and ``refill`` run
only on the pump, the front's handler threads never touch it.  Its
metrics are registered up front by :meth:`AdmissionController.bind`,
labelled by tenant.
"""

import math

__all__ = [
    "TenantSpecError",
    "TenantPolicy",
    "parse_tenant_spec",
    "AdmissionController",
    "DEFAULT_TENANT",
]

DEFAULT_TENANT = "default"


class TenantSpecError(ValueError):
    """A ``--serve-tenants`` spec that does not parse."""


class TenantPolicy:
    """One tenant's admission knobs (immutable after construction)."""

    __slots__ = ("name", "rate", "burst", "budget")

    def __init__(self, name: str, rate: float, burst: float = 0.0,
                 budget: int = 0):
        if not name:
            raise TenantSpecError("tenant name must be non-empty")
        if rate <= 0 or not math.isfinite(rate):
            raise TenantSpecError(
                f"tenant {name!r}: rate must be a positive finite "
                f"ops/round, got {rate!r}"
            )
        if burst < 0 or budget < 0:
            raise TenantSpecError(
                f"tenant {name!r}: burst/budget must be >= 0"
            )
        self.name = name
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else 4.0 * self.rate
        self.budget = int(budget)

    def to_dict(self) -> dict:
        return {"rate": self.rate, "burst": self.burst,
                "budget": self.budget}


def parse_tenant_spec(spec: str) -> dict[str, TenantPolicy]:
    """Parse ``name=RATE[:BURST[:BUDGET]],...`` into policies.

    Raises :class:`TenantSpecError` on a malformed entry, a duplicate
    tenant or a non-numeric field; the bench entry prints the message and
    exits 2, as it does for ``--serve-slo``."""
    out: dict[str, TenantPolicy] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, rhs = part.partition("=")
        name = name.strip()
        if not eq or not name or not rhs:
            raise TenantSpecError(
                f"bad tenant entry {part!r} (want name=RATE[:BURST[:BUDGET]])"
            )
        if name in out:
            raise TenantSpecError(f"duplicate tenant {name!r}")
        fields = rhs.split(":")
        if len(fields) > 3:
            raise TenantSpecError(
                f"tenant {name!r}: too many ':' fields in {rhs!r}"
            )
        try:
            rate = float(fields[0])
            burst = float(fields[1]) if len(fields) > 1 else 0.0
            budget = int(fields[2]) if len(fields) > 2 else 0
        except ValueError as e:
            raise TenantSpecError(
                f"tenant {name!r}: non-numeric field in {rhs!r}"
            ) from e
        out[name] = TenantPolicy(name, rate, burst, budget)
    if not out:
        raise TenantSpecError(f"empty tenant spec {spec!r}")
    return out


class AdmissionController:
    """The hot thread's admit/defer/shed policy over per-tenant token
    buckets.

    ``refill()`` runs once a macro-round (refills the buckets, snapshots
    the SLO burns); ``decide()`` once a delivered batch.  A decision never
    blocks and never touches the network: the front's handler threads see
    only their frame's ack."""

    #: a batch deferred this many times escalates to a shed: a defer is
    #: backpressure, not an unbounded parking lot (and the open-loop drive
    #: must end even under a sustained burn)
    MAX_DEFERS = 64

    def __init__(self, policies: dict[str, TenantPolicy], *,
                 slo=None, journal=None):
        self.policies = dict(policies)
        self.slo = slo
        self.journal = journal
        self.tokens = {t: p.burst for t, p in self.policies.items()}
        self.admitted_ops = {t: 0 for t in self.policies}
        self.deferred_ops = {t: 0 for t in self.policies}
        self.shed_ops = {t: 0 for t in self.policies}
        self.decisions: dict[str, int] = {}
        self._burns: dict[str, tuple[float, float]] = {}
        self._counters = None  # (tenant, verb) -> Counter, set by bind
        self._token_gauges = None

    def bind(self, registry) -> None:
        """Register the per-tenant counters and token gauges up front, so
        the hot path only touches references it holds."""
        counters = {}
        gauges = {}
        for t in self.policies:
            for verb in ("admitted", "deferred", "shed"):
                counters[(t, verb)] = registry.counter(
                    f'serve.ingest.{verb}_ops{{tenant="{t}"}}'
                )
            gauges[t] = registry.gauge(
                f'serve.ingest.tokens{{tenant="{t}"}}'
            )
        self._counters = counters
        self._token_gauges = gauges

    def policy_for(self, tenant: str) -> TenantPolicy:
        try:
            return self.policies[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r} (declared: "
                f"{', '.join(sorted(self.policies))})"
            ) from None

    def refill(self) -> None:  # graftlint: thread=hot
        """Once a macro-round: refill the buckets and snapshot the SLO
        class burns the round's decisions read."""
        for t, p in self.policies.items():
            tok = min(p.burst, self.tokens[t] + p.rate)
            self.tokens[t] = tok
            if self._token_gauges is not None:
                self._token_gauges[t].set(tok)
        if self.slo is not None:
            # one status snapshot a round, not one a class
            burns = {}
            fields = self.slo.status_fields().get("classes", {})
            for name, d in fields.items():
                burns[name] = (float(d.get("burn_fast", 0.0)),
                               float(d.get("burn_slow", 0.0)))
            self._burns = burns

    def burn(self, klass: str) -> tuple[float, float]:
        """(fast, slow) burn of an SLO class name; 0.0 when unknown."""
        return self._burns.get(klass, (0.0, 0.0))

    def decide(self, tenant: str, ops: int, klass: str,  # graftlint: thread=hot
               pending: int, defers: int = 0) -> tuple[str, str]:
        """One batch's verdict: ``("admit"|"defer"|"shed", reason)``.

        ``pending`` is the tenant's total in-queue ops (delivered, not yet
        drained) before this batch; ``defers`` how many rounds this batch
        has already been pushed back."""
        p = self.policy_for(tenant)
        fast, slow = self.burn(klass)
        if fast > 1.0 and slow > 1.0:
            return self._note(tenant, "shed", "burn_sustained", ops)
        if defers >= self.MAX_DEFERS:
            return self._note(tenant, "shed", "defer_limit", ops)
        if fast > 1.0:
            return self._note(tenant, "defer", "burn_spike", ops)
        if p.budget and pending + ops > p.budget:
            return self._note(tenant, "defer", "queue_budget", ops)
        if self.tokens[tenant] < ops:
            return self._note(tenant, "defer", "tokens", ops)
        self.tokens[tenant] -= ops
        return self._note(tenant, "admit", "ok", ops)

    def journal_shed(self, doc_id: int, keep: int, shed: int,  # graftlint: thread=hot
                     tenant: str, rnd: int) -> None:
        """Journal an admission shed in the overflow shed's record shape:
        ``recover_fleet`` replays ``t="shed"`` by (doc, at, ops) and
        ignores the extra ``tenant``/``why`` fields."""
        if self.journal is not None:
            self.journal.event("shed", r=rnd, doc=doc_id, at=keep,
                               ops=shed, tenant=tenant, why="admission")

    def _note(self, tenant: str, verb: str, reason: str, ops: int
              ) -> tuple[str, str]:
        key = f"{verb}:{reason}"
        self.decisions[key] = self.decisions.get(key, 0) + 1
        bucket = {"admit": self.admitted_ops, "defer": self.deferred_ops,
                  "shed": self.shed_ops}[verb]
        bucket[tenant] = bucket.get(tenant, 0) + ops
        if self._counters is not None:
            self._counters[(tenant, {"admit": "admitted",
                                     "defer": "deferred",
                                     "shed": "shed"}[verb])].inc(ops)
        return verb, reason

    def status_fields(self) -> dict:
        """The ``/status.json`` and report sub-block: per-tenant totals and
        the decision histogram."""
        return {
            "tenants": {
                t: {
                    "tokens": round(self.tokens[t], 3),
                    "admitted_ops": self.admitted_ops.get(t, 0),
                    "deferred_ops": self.deferred_ops.get(t, 0),
                    "shed_ops": self.shed_ops.get(t, 0),
                }
                for t in self.policies
            },
            "decisions": dict(sorted(self.decisions.items())),
        }

    def to_dict(self) -> dict:
        out = self.status_fields()
        out["policies"] = {t: p.to_dict()
                          for t, p in self.policies.items()}
        return out
