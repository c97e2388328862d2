"""Per-class latency SLOs: objectives, burn rates, compliance (the JAX
package's ``obs/slo.py``).

The continuous telemetry says what the fleet is doing; this module says whether
it is doing it *well enough to admit more work* — the accounting the
ROADMAP's deadline/SLO-aware scheduler admits against.  An **objective**
binds a latency budget class to a quantile target (``--serve-slo``
grammar: ``class=pQ:MS``, e.g. ``default=p99:250,c4096=p99.9:1500`` —
"99% of class-c4096 requests drain within 1.5s").  Every closed doc
request (``obs/reqtrace.py``) lands here as one observation:

- **compliance** — the fraction of the class's requests inside the
  objective, cumulative over the drain (the artifact's headline);
- **burn rate** — violations consumed per unit of error budget, over
  TWO rolling request windows (fast ~64 / slow ~512 requests, the
  multi-window pattern that separates a blip from a sustained burn:
  fast >> 1 with slow ~ 1 is a spike; both elevated is an incident).
  Burn 1.0 = exactly on budget (a p99 objective tolerating 1%
  violations is *expected* to run at 1.0), >1 = the budget is burning
  faster than it refills.  Exported live as pre-registered gauges
  (``serve.slo.burn_rate{class="c",window="fast|slow"}``) on the
  Prometheus endpoint and folded into ``/status.json``;
- **top-K slowest docs** — the worst requests with their per-segment
  breakdowns (queue/stage/dispatch/drain, from the request trace), so
  "the p99.9 is burning" links to *which* docs and *where* their time
  went.

Budget classes derive from the doc's capacity class at admission
(``c256`` .. ``c49152``); ``default`` catches everything the spec does
not name.  Classification happens once per request at admission — the
hot path holds pre-registered gauge references only.

Thread confinement: the tracker is owned by the **hot** thread — every
observation happens at a request close inside the macro-round; what
readers see is the snapshot the status publisher swaps out.
"""

from __future__ import annotations

import math
from collections import deque

#: Bump when the ``slo`` artifact block changes shape.
SLO_VERSION = 1

#: Rolling burn-rate windows, in REQUESTS (not wall time): request
#: arrival is what the admission scheduler will pace, and request
#: windows keep the math identical across fleet sizes.
FAST_WINDOW = 64
SLOW_WINDOW = 512

#: Slowest requests retained with segment breakdowns.
DEFAULT_TOP_K = 8


class SloSpecError(ValueError):
    """A ``--serve-slo`` spec that does not parse MUST fail the run —
    a typo'd objective silently gating nothing is worse than none."""


class SloObjective:
    """One class's latency objective: quantile target + threshold."""

    __slots__ = ("name", "quantile", "threshold_s")

    def __init__(self, name: str, quantile: float, threshold_s: float):
        if not name:
            raise SloSpecError(
                "slo class name must be non-empty (classify() could "
                "never route a request to it)"
            )
        if not (0.0 < quantile < 1.0):
            raise SloSpecError(
                f"slo class {name!r}: quantile must be in (0, 1), "
                f"got {quantile}"
            )
        # nan passes a bare `<= 0` check (nan <= 0 is False) and then
        # every `latency > nan` is False — an objective that silently
        # gates nothing, exactly what SloSpecError exists to prevent
        if not math.isfinite(threshold_s) or threshold_s <= 0:
            raise SloSpecError(
                f"slo class {name!r}: threshold must be finite "
                f"positive ms, got {threshold_s * 1e3:g}"
            )
        self.name = name
        self.quantile = quantile
        self.threshold_s = threshold_s

    @property
    def budget(self) -> float:
        """Tolerated violation fraction (1 - quantile)."""
        return 1.0 - self.quantile

    def to_dict(self) -> dict:
        return {
            "quantile": self.quantile,
            "threshold_ms": self.threshold_s * 1e3,
        }


def parse_slo_spec(spec: str) -> dict[str, SloObjective]:
    """THE ``--serve-slo`` grammar: comma-separated ``class=pQ:MS``.
    ``class`` is a budget class (``default`` or a capacity class like
    ``c4096``), ``pQ`` a percentile (``p99``, ``p99.9``), ``MS`` the
    latency threshold in milliseconds.  Raises :class:`SloSpecError`
    on anything malformed."""
    out: dict[str, SloObjective] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SloSpecError(
                f"slo spec {part!r}: expected class=pQ:MS "
                "(e.g. default=p99:250)"
            )
        name, rest = part.split("=", 1)
        name = name.strip()
        if ":" not in rest:
            raise SloSpecError(
                f"slo spec {part!r}: expected pQ:MS after '='"
            )
        q_s, ms_s = rest.split(":", 1)
        q_s = q_s.strip().lower()
        if not q_s.startswith("p"):
            raise SloSpecError(
                f"slo spec {part!r}: quantile must be spelled pQ "
                "(p99, p99.9)"
            )
        try:
            quantile = float(q_s[1:]) / 100.0
            threshold_s = float(ms_s) / 1e3
        except ValueError as e:
            raise SloSpecError(f"slo spec {part!r}: {e}") from None
        if name in out:
            raise SloSpecError(f"slo class {name!r} given twice")
        out[name] = SloObjective(name, quantile, threshold_s)
    if not out:
        raise SloSpecError(f"slo spec {spec!r} names no objective")
    return out


def class_window_key(name: str, window: str) -> str:
    """Registry key for a burn-rate gauge (labels parsed back out by
    the Prometheus renderer in obs/status.py)."""
    return f'serve.slo.burn_rate{{class="{name}",window="{window}"}}'


def compliance_key(name: str) -> str:
    return f'serve.slo.compliance{{class="{name}"}}'


class _ClassState:
    __slots__ = ("objective", "requests", "violations", "fast", "slow",
                 "g_fast", "g_slow", "g_comp")

    def __init__(self, objective: SloObjective):
        self.objective = objective
        self.requests = 0
        self.violations = 0
        self.fast: deque[bool] = deque(maxlen=FAST_WINDOW)
        self.slow: deque[bool] = deque(maxlen=SLOW_WINDOW)
        self.g_fast = None
        self.g_slow = None
        self.g_comp = None

    @staticmethod
    def _burn(window: deque, budget: float) -> float:
        if not window:
            return 0.0
        frac = sum(window) / len(window)
        return frac / budget

    def note(self, violation: bool) -> None:
        self.requests += 1
        self.violations += int(violation)
        self.fast.append(violation)
        self.slow.append(violation)
        if self.g_fast is not None:
            b = self.objective.budget
            self.g_fast.set(self._burn(self.fast, b))
            self.g_slow.set(self._burn(self.slow, b))
            self.g_comp.set(self.compliance)

    @property
    def compliance(self) -> float:
        if not self.requests:
            return 1.0
        return 1.0 - self.violations / self.requests

    def to_dict(self) -> dict:
        b = self.objective.budget
        return {
            "objective": self.objective.to_dict(),
            "requests": self.requests,
            "violations": self.violations,
            "compliance": self.compliance,
            "burn_rate_fast": self._burn(self.fast, b),
            "burn_rate_slow": self._burn(self.slow, b),
        }


class SloTracker:  # graftlint: thread=hot
    """Per-class SLO accounting over closed doc requests (module
    docstring has the model).  Gauges are pre-registered at
    :meth:`bind`; :meth:`note_request` touches held references only."""

    def __init__(self, objectives: dict[str, SloObjective],
                 top_k: int = DEFAULT_TOP_K):
        self.objectives = dict(objectives)
        self.classes = {
            name: _ClassState(obj) for name, obj in objectives.items()
        }
        self.top_k = max(1, int(top_k))
        # top-K slowest requests: a sorted ascending list bounded at K,
        # so the head is the eviction candidate (K is single digits —
        # an insertion beats heap bookkeeping at this size)
        self._slowest: list[tuple[float, int, dict]] = []
        self._seq = 0
        self.unclassified = 0  # requests no objective claims

    @classmethod
    def from_spec(cls, spec: str, top_k: int = DEFAULT_TOP_K
                  ) -> "SloTracker":
        return cls(parse_slo_spec(spec), top_k=top_k)

    # ---- driver-side wiring ----

    def bind(self, registry) -> None:
        """Pre-register every gauge in the drain's registry (the
        per-request path must never get-or-create)."""
        for name, st in self.classes.items():
            st.g_fast = registry.gauge(class_window_key(name, "fast"))
            st.g_slow = registry.gauge(class_window_key(name, "slow"))
            st.g_comp = registry.gauge(compliance_key(name))

    # ---- admission-time classification ----

    def classify(self, capacity_class: int | None) -> str:
        """Budget class for a doc admitted into ``capacity_class``:
        the class's own objective (``c4096``) when the spec names one,
        else ``default``.  Returns the class name even when no
        objective claims it — the request trace still carries it."""
        if capacity_class is not None:
            name = f"c{capacity_class}"
            if name in self.classes:
                return name
        if "default" in self.classes:
            return "default"
        return f"c{capacity_class}" if capacity_class is not None \
            else "default"

    # ---- per-request accounting (hot path; held references only) ----

    def note_request(self, name: str, latency_s: float, doc_id: int,
                     segments: dict | None = None, *,
                     dropped: bool = False) -> None:
        """One closed request: a violation when it missed its latency
        objective OR was dropped (shed/quarantined) — a request the
        service failed to serve never satisfies the objective, however
        quickly it was dropped."""
        st = self.classes.get(name)
        if st is None:
            self.unclassified += 1
            return
        st.note(dropped or latency_s > st.objective.threshold_s)
        self._seq += 1
        slow = self._slowest
        if len(slow) >= self.top_k and latency_s <= slow[0][0]:
            return  # common case: not a top-K entry, allocate nothing
        entry = (latency_s, self._seq, {
            "doc": doc_id,
            "class": name,
            "latency_s": latency_s,
            "segments": dict(segments) if segments else {},
        })
        if len(slow) < self.top_k:
            slow.append(entry)
            slow.sort(key=lambda e: (e[0], e[1]))
        else:
            slow[0] = entry
            slow.sort(key=lambda e: (e[0], e[1]))

    # ---- surfaces ----

    def slowest(self) -> list[dict]:
        """Top-K slowest requests, worst first, with segment
        breakdowns."""
        return [e[2] for e in sorted(
            self._slowest, key=lambda e: (-e[0], e[1])
        )]

    def status_fields(self) -> dict:
        """The ``/status.json`` view: per-class burn/compliance plus
        the current top-K (plain scalars/lists — published verbatim)."""
        b = {
            name: {
                "burn_fast": st._burn(st.fast, st.objective.budget),
                "burn_slow": st._burn(st.slow, st.objective.budget),
                "compliance": st.compliance,
                "requests": st.requests,
            }
            for name, st in sorted(self.classes.items())
        }
        return {"classes": b, "slow_docs": self.slowest()}

    def block(self) -> dict:
        """The versioned ``slo`` artifact block."""
        return {
            "version": SLO_VERSION,
            "windows": {"fast": FAST_WINDOW, "slow": SLOW_WINDOW},
            "classes": {
                name: st.to_dict()
                for name, st in sorted(self.classes.items())
            },
            "unclassified": self.unclassified,
            "slow_docs": self.slowest(),
        }
