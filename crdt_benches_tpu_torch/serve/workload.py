"""Multi-tenant workload of the document fleet (the JAX package's
``serve/workload.py``, the parts the core drain uses): N sessions over
size bands of synthetic streams (``traces/synth.py``) and folded
real-trace windows, with staggered arrival rounds.  The same seed gives
the same sessions in both packages: doc ids, bands, arrivals and trace
windows with their ``start_content``.

A real trace needs up to ~260k slots, far beyond any pool class, so a
real-trace session replays a **folded prefix window**: leading patches
that alone would blow the slot budget are folded into ``start_content``
through the oracle, and the following patches form the edit stream,
truncated so the doc's slot need (start chars + window inserts) fits the
band's budget.  Positions stay the original trace's, so the oracle replay
of the window over the folded start is ground truth.  All sessions of one
band edit the same template window; synthetic sessions are all distinct
(seeded per doc).

Each band also carries a **delivery burst** (:data:`DELIVERY_BURST`): the
ops a session's producer pushes toward the fleet per scheduler round.  It
matters only under the scheduler's bounded per-doc queue (``queue_cap``);
``build_fleet(delivery="banded")`` turns it on, the default (None)
delivers each stream whole.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..oracle.text_oracle import OracleDocument
from ..traces.loader import TRACES, TestData, TestTxn, load_testing_data
from ..traces.synth import synth_trace

#: band -> (source, sizing).  "synth": (lo, hi) op-count range per doc.
#: "trace": (slot_budget, window_ins_cap): the doc's total slot need stays
#: <= slot_budget and its window's inserted chars <= window_ins_cap (None:
#: only the budget caps it).
BANDS: dict[str, tuple[str, object]] = {
    "synth-small": ("synth", (24, 160)),
    "synth-medium": ("synth", (320, 900)),
    "synth-large": ("synth", (1400, 3400)),
    "trace-small": ("trace", (240, None)),
    "trace-medium": ("trace", (1000, None)),
    "trace-large": ("trace", (3900, None)),
    "trace-xl": ("trace", (8000, 1600)),
    "trace-huge": ("trace", (49000, 1200)),
}

#: band -> producer delivery burst (coalesced range ops pushed per
#: scheduler round) under ``delivery="banded"``: small interactive docs
#: trickle, big trace replays arrive in heavy bursts.
DELIVERY_BURST: dict[str, int] = {
    "synth-small": 64, "synth-medium": 96, "synth-large": 128,
    "trace-small": 96, "trace-medium": 128, "trace-large": 192,
    "trace-xl": 256, "trace-huge": 256,
}

#: mix name -> {band: weight}.  "mixed" is the headline multi-tenant blend.
MIXES: dict[str, dict[str, float]] = {
    "mixed": {
        "synth-small": 0.36, "synth-medium": 0.12, "synth-large": 0.05,
        "trace-small": 0.20, "trace-medium": 0.12, "trace-large": 0.07,
        "trace-xl": 0.05, "trace-huge": 0.03,
    },
    "synth": {
        "synth-small": 0.60, "synth-medium": 0.28, "synth-large": 0.12,
    },
    "traces": {
        "trace-small": 0.35, "trace-medium": 0.25, "trace-large": 0.20,
        "trace-xl": 0.12, "trace-huge": 0.08,
    },
}

#: Skew exponent of ``arrival_dist="zipf"``: arrivals land at
#: ``span * u**ZIPF_EXP`` (u uniform), a dense head of early joiners and a
#: long tail.
ZIPF_EXP = 3.0


@dataclass
class Session:
    """One simulated tenant: a doc id, its edit stream, and the scheduler
    round it joins the fleet."""

    doc_id: int
    band: str
    source: str  # "synth" or a real trace name
    trace: TestData
    arrival: int = 0
    burst: int | None = None  # producer delivery rate (ops/round)


# ---- the multi-writer split (serve/replicate/) -----------------------------


def split_turns(n_ops: int, writers: int,
                turn_ops: int) -> list[tuple[int, int, int]]:
    """Partition a doc's op stream ``[0, n_ops)`` into contiguous turn
    blocks of up to ``turn_ops`` coalesced range ops, block ``j`` owned by
    writer ``j % writers``: ``[(lo, hi, writer), ...]`` in sequence order.
    The blocks concatenate back to the original stream, so the group's
    arbitration order (ascending sequence) replays to the oracle's
    content; the split is arithmetic alone, which is what lets a crashed
    replicated fleet recover from the workload."""
    if writers < 1:
        raise ValueError(f"writers must be >= 1, got {writers}")
    if turn_ops < 1:
        raise ValueError(f"turn_ops must be >= 1, got {turn_ops}")
    blocks: list[tuple[int, int, int]] = []
    lo = seq = 0
    while lo < n_ops:
        hi = min(lo + turn_ops, n_ops)
        blocks.append((lo, hi, seq % writers))
        lo = hi
        seq += 1
    return blocks


def replicate_sessions(sessions: list[Session],
                       writers: int) -> list[Session]:
    """Each logical session as ``writers`` replica sessions, one pool doc
    each, with dense ids ``logical * writers + w``.  Replicas share the
    trace object (``prepare_streams`` tensorizes it once) and the arrival
    round; the producer ``burst`` is dropped (the broadcast bus paces a
    replicated fleet)."""
    if writers < 1:
        raise ValueError(f"writers must be >= 1, got {writers}")
    return [Session(doc_id=s.doc_id * writers + w, band=s.band,
                    source=s.source, trace=s.trace, arrival=s.arrival,
                    burst=None)
            for s in sessions for w in range(writers)]


@functools.lru_cache(maxsize=8)
def _full_trace(name: str) -> TestData:
    return load_testing_data(name)


@functools.lru_cache(maxsize=64)
def trace_prefix(name: str, slot_budget: int,
                 window_cap: int | None = None) -> TestData:
    """A real-trace session document: fold leading patches into
    ``start_content`` until the next patch fits the budget, then take the
    longest following window whose slot need (start chars + window
    inserts) stays within ``slot_budget`` (and whose inserts stay within
    ``window_cap``, if given).  ``end_content`` is left empty: the oracle
    defines truth for partial replays.  Raises if no fold point fits."""
    full = _full_trace(name)
    patches = list(full.iter_patches())
    doc = OracleDocument.from_str(full.start_content)
    fold = 0
    while fold <= len(patches):
        n_init = len(doc)
        if n_init <= slot_budget and fold < len(patches):
            need = n_init
            window = []
            win_ins = 0
            for p in patches[fold:]:
                need += len(p.ins)
                win_ins += len(p.ins)
                if need > slot_budget or (
                    window_cap is not None and win_ins > window_cap
                ):
                    break
                window.append(p)
            if window:
                return TestData(doc.content(), "", [TestTxn("", window)])
        if fold == len(patches):
            break
        p = patches[fold]
        doc.replace(p.pos, p.pos + p.del_count, p.ins)
        fold += 1
    raise ValueError(f"{name}: no patch window fits slot budget {slot_budget}")


@functools.lru_cache(maxsize=64)
def _fitting_traces(slot_budget: int, window_cap: int | None) -> tuple:
    """Real traces that can provide a window for this budget."""
    fits = []
    for name in TRACES:
        try:
            trace_prefix(name, slot_budget, window_cap)
        except ValueError:
            continue
        fits.append(name)
    if not fits:
        raise ValueError(f"no trace fits slot budget {slot_budget}")
    return tuple(fits)


@dataclass(frozen=True)
class FleetSpec:
    """The fleet as arithmetic: doc ``i``'s band and arrival come from
    per-doc arrays drawn up front, its synth stream from a generator seeded
    ``(seed, doc_id)``, and its trace window from the running count of
    trace-band docs before it.  Frozen, with read-only arrays: a streamed
    fleet hands the spec to the prefetch thread inside its construct
    builders."""

    n_docs: int
    seed: int
    horizon: int  # the longhaul multiplier on synthetic op counts
    delivery: str | None  # "banded": sessions carry DELIVERY_BURST
    names: tuple[str, ...]  # sorted band names; band_of indexes these
    table: dict  # band -> (source, sizing)
    band_of: np.ndarray  # int16 band index per doc
    arrivals: np.ndarray  # int32 arrival round per doc
    trace_ord: np.ndarray  # int32 trace-band docs before each doc

    @staticmethod
    def build(n_docs: int, mix: str | dict[str, float] = "mixed",
              seed: int = 0, arrival_span: int = 8,
              bands: dict | None = None,
              arrival_dist: str = "uniform",
              horizon: int = 1,
              delivery: str | None = None) -> "FleetSpec":
        """Draw the per-fleet vectors (band assignment, then arrivals) in
        the JAX package's order, so the same seed gives the same fleet."""
        weights = MIXES[mix] if isinstance(mix, str) else dict(mix)
        table = BANDS if bands is None else bands
        names = sorted(weights)
        w = np.asarray([weights[b] for b in names], float)
        if not np.all(w >= 0) or w.sum() <= 0:
            raise ValueError(f"bad mix weights {weights}")
        w = w / w.sum()
        if arrival_dist not in ("uniform", "zipf"):
            raise ValueError(f"unknown arrival_dist {arrival_dist!r} "
                             "(expected 'uniform' or 'zipf')")
        rng = np.random.default_rng(seed)
        band_of = rng.choice(len(names), size=n_docs, p=w)
        if arrival_span <= 1:
            arrivals = np.zeros(n_docs, int)
        elif arrival_dist == "zipf":
            arrivals = np.floor(
                arrival_span * rng.random(n_docs) ** ZIPF_EXP
            ).astype(int)
        else:
            arrivals = rng.integers(0, arrival_span, size=n_docs)
        is_trace = np.asarray(
            [1 if table[b][0] == "trace" else 0 for b in names], np.int32,
        )[band_of] if n_docs else np.zeros(0, np.int32)
        trace_ord = np.zeros(n_docs, np.int64)
        if n_docs:
            np.cumsum(is_trace[:-1], out=trace_ord[1:])
        band_of = np.ascontiguousarray(band_of, np.int16)
        arrivals = np.ascontiguousarray(arrivals, np.int32)
        trace_ord = np.ascontiguousarray(trace_ord, np.int32)
        for a in (band_of, arrivals, trace_ord):
            a.flags.writeable = False
        return FleetSpec(
            n_docs=int(n_docs), seed=int(seed),
            horizon=max(1, int(horizon)), delivery=delivery,
            names=tuple(names), table=dict(table),
            band_of=band_of, arrivals=arrivals, trace_ord=trace_ord,
        )

    def session(self, doc_id: int) -> Session:
        """Doc ``doc_id``'s session."""
        if not 0 <= doc_id < self.n_docs:
            raise IndexError(f"doc {doc_id} outside fleet {self.n_docs}")
        band = self.names[int(self.band_of[doc_id])]
        source, sizing = self.table[band]
        if source == "synth":
            lo, hi = sizing
            r = np.random.default_rng((self.seed, doc_id))
            n_ops = int(r.integers(lo, hi + 1)) * self.horizon
            trace = synth_trace(seed=int(r.integers(1 << 31)), n_ops=n_ops)
            src = "synth"
        else:
            budget, cap = sizing
            fits = _fitting_traces(int(budget), cap)
            src = fits[int(self.trace_ord[doc_id]) % len(fits)]
            trace = trace_prefix(src, int(budget), cap)
        burst = (DELIVERY_BURST.get(band) if self.delivery == "banded"
                 else None)
        return Session(doc_id=doc_id, band=band, source=src, trace=trace,
                       arrival=int(self.arrivals[doc_id]), burst=burst)

    def shard_range(self, shard: int, n_shards: int) -> tuple[int, int]:
        """The ``[lo, hi)`` doc-id range shard ``shard`` of ``n_shards``
        owns: the balanced contiguous split (sizes differ by at most one).
        The spec is per-doc arithmetic, so a shard materializes its range
        without touching another shard's docs (the mesh split of the
        streaming path)."""
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} outside [0, {n_shards})")
        return (shard * self.n_docs // n_shards,
                (shard + 1) * self.n_docs // n_shards)

    def shard_doc_ids(self, shard: int, n_shards: int) -> range:
        """:meth:`shard_range` as a range of doc ids."""
        lo, hi = self.shard_range(shard, n_shards)
        return range(lo, hi)


def build_fleet(n_docs: int, mix: str | dict[str, float] = "mixed",
                seed: int = 0, arrival_span: int = 8,
                bands: dict | None = None,
                arrival_dist: str = "uniform",
                horizon: int = 1,
                delivery: str | None = None) -> list[Session]:
    """N sessions drawn from the mix's band weights, arrivals staggered
    over ``arrival_span`` rounds (``"uniform"`` or ``"zipf"``-skewed).
    ``mix`` is a name from MIXES or a {band: weight} table; ``bands``
    overrides the band sizing table (tests use tiny bands).  ``horizon``
    is the longhaul multiplier (``serve/longhaul``): synthetic sessions
    carry ``horizon`` times the band's op count, one valid edit history;
    real-trace windows keep their band's sizing.  ``delivery="banded"``
    attaches each band's :data:`DELIVERY_BURST` producer rate to its
    sessions (the bounded queue's delivery pace); the default delivers
    each stream whole."""
    spec = FleetSpec.build(n_docs, mix=mix, seed=seed,
                           arrival_span=arrival_span, bands=bands,
                           arrival_dist=arrival_dist, horizon=horizon,
                           delivery=delivery)
    return [spec.session(i) for i in range(n_docs)]
