"""Deadline-aware selection, ``DeadlineScheduler`` (the JAX package's
``serve/ingest/deadline.py``).

``FleetScheduler._select`` walks a round-robin rotation: the right
fairness for a batch drain, the wrong one for serving under latency
budgets, where a doc admitted with 8 rounds of budget left should not wait
behind one with 80.  ``DeadlineScheduler`` re-sorts the rotation
earliest-deadline-first before every selection pass and otherwise runs the
base selection as it is: the per-class lane bounds, the bounded-queue
deferral, the duplicate clamp, the request contexts and the macro-round
staging downstream are untouched.

A doc's deadline is static: ``arrival + budget(capacity class)``, the
budgets per class in rounds (the capacity classes ``obs/slo.py`` keys its
burn windows on).  A doc drained by its deadline counts as met, after it as
missed; both totals ride ``/status.json`` and the report's ``ingest``
block.

The subclass also holds the open loop's glue the base class should not
know of: an ``ingest_status`` callable merged into ``status_fields()``, so
the live front's gauges reach ``/status.json``.  EDF can be off
(``edf=False``): the open-loop family always drives this class for the
status and deadline plumbing, and ``--serve-deadline`` turns the selection
from round-robin to EDF.
"""

from collections import deque

from ..scheduler import DocStream, FleetScheduler

__all__ = ["DeadlineScheduler", "DEFAULT_DEADLINE_BUDGET"]

#: rounds of latency budget for classes without an entry of their own:
#: generous enough that a closed-loop drain of a small fleet meets it
DEFAULT_DEADLINE_BUDGET = 64


class DeadlineScheduler(FleetScheduler):
    """EDF selection over per-class latency budgets.

    ``deadline_budgets`` maps a capacity class (row length) to a budget in
    macro-rounds; a class not listed gets ``default_budget``."""

    def __init__(self, pool, streams, *, edf: bool = True,
                 deadline_budgets: dict[int, int] | None = None,
                 default_budget: int = DEFAULT_DEADLINE_BUDGET, **kw):
        super().__init__(pool, streams, **kw)
        self._edf = bool(edf)
        self._budgets = dict(deadline_budgets or {})
        self._default_budget = int(default_budget)
        self._deadlines: dict[int, int] = {}
        self.deadline_met = 0
        self.deadline_missed = 0
        #: an optional () -> dict merged into status_fields()["ingest"],
        #: set by the open-loop bench before the drain starts
        self.ingest_status = None

    def deadline_for(self, doc_id: int) -> int:
        """The absolute round this doc must drain by (cached: its arrival
        and capacity class are static)."""
        dl = self._deadlines.get(doc_id)
        if dl is None:
            st = self.streams[doc_id]
            rec = self.pool.docs[doc_id]
            cls = self.pool.class_for(max(rec.length, 1))
            budget = self._budgets.get(cls, self._default_budget)
            dl = st.arrival + budget
            self._deadlines[doc_id] = dl
        return dl

    def _select(self, plan) -> None:
        """The EDF re-sort, then the base selection pass.  The base
        rotation discipline (scheduled to the back, deferred in place) does
        not matter here: the rotation is re-sorted every round, so urgency
        always wins over recency."""
        if self._edf and len(self._rr) > 1:
            self._rr = deque(sorted(
                self._rr,
                key=lambda d: (self.deadline_for(d),
                               self.streams[d].arrival, d),
            ))
        super()._select(plan)

    def _note_doc_drained(self, st: DocStream, tag: str | None = None
                          ) -> None:
        """Score the deadline before the base close, which adds the doc
        to ``_ended`` (the guard that keeps a re-entry from counting
        twice)."""
        if st.doc_id not in self._ended:
            if self.round <= self.deadline_for(st.doc_id):
                self.deadline_met += 1
            else:
                self.deadline_missed += 1
        super()._note_doc_drained(st, tag)

    def deadline_fields(self) -> dict:
        met, missed = self.deadline_met, self.deadline_missed
        total = met + missed
        return {
            "edf": self._edf,
            "default_budget": self._default_budget,
            "budgets": {str(k): v for k, v in sorted(self._budgets.items())},
            "met": met,
            "missed": missed,
            "hit_rate": round(met / total, 4) if total else 1.0,
        }

    def status_fields(self) -> dict:
        out = super().status_fields()
        out["deadline"] = self.deadline_fields()
        if self.ingest_status is not None:
            out["ingest"] = self.ingest_status()
        return out
