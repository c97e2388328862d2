"""Adversarial dtype-edge check: the value-range harness (the JAX
package's ``serve/edgecheck.py``).

Drive the serve stack with workloads built to live at the edges a gather,
a scatter or a narrow lane gets wrong without a fault: documents grown to
exactly their capacity class, ops at every position extreme (prepend at
0, append at len, the last char, the full wipe), deletes that empty a
document and inserts that refill it, rounds whose staged lanes are all
PAD, and slot ids driven to the top of the narrow uint16 ladder and across
the uint16 boundary on the wide ladder.  Every drain runs through BOTH
serve kernels (``fused``: K1's per-row form then K4; ``scan``: the rounds
one by one) with ``lint/range_sanitizer.py`` armed, and every final
document is byte-verified against the pure-Python oracle AND the other
kernel's.

The second leg is a seeded differential fuzz of the boundary contracts
(``lint/boundary.py``): for every ``@boundary`` entry of the port it makes
a conforming call at the contract's dtype edges (tensors filled with
``torch.iinfo(dtype).min``/``max``) and checks the checker accepts it, then
perturbs one field at a time — a dtype swap on every typed lane, a rank
bump on every shaped argument, an inconsistent symbolic dim, a written
argument that overlaps another — and checks each is refused.

On the CPU (``--device cpu``) the kernels' plain versions run; on the card
(the default) K1's per-row form and K4 launch, the 65,408- and 65,664-column
ladders included::

    python -m crdt_benches_tpu_torch.serve.edgecheck [--small] [--device cpu]
"""

from __future__ import annotations

import importlib
import os
import shutil
import sys
import tempfile
import zlib

import numpy as np
import torch

from ..lint import range_sanitizer as ranges
from ..lint.boundary import REGISTRY, BoundaryError, _check_call
from ..device import resolve_device
from ..oracle.text_oracle import replay_trace
from ..traces.loader import TestData, TestPatch, TestTxn
from ..traces.synth import synth_trace
from .pool import DocPool
from .scheduler import FleetScheduler, prepare_streams
from .workload import Session

_SEED = 7
_BATCH = 16
_MACRO_K = 2

#: The narrow ladder's largest legal class (the biggest multiple of the
#: 128-lane tile that still fits the uint16 id space) and the wide
#: ladder's smallest: the two pools that bracket the uint16 boundary.
#: 65408 = 511 * 128 <= 65535 < 65664 = 513 * 128.
_NARROW_MAX_CLASS = 65408
_WIDE_MIN_CLASS = 65664

#: checks/masks a green run must have dispatched — a zero count means
#: the harness silently stopped covering a declared range contract
_REQUIRED_CHECKS = ("pool.macro-pos", "pool.macro-ids", "pool.write-row")
_REQUIRED_MASKS = ("count-le-clamp", "fused-gap-gather")


# ---------------------------------------------------------------------------
# adversarial trace construction
# ---------------------------------------------------------------------------


class _Script:
    """A legal-by-construction patch script: tracks the visible length
    so every emitted patch is in-contract (positions within the doc at
    op time), which keeps the harness adversarial about VALUES at the
    edges, never about malformed streams."""

    def __init__(self, start: str = ""):
        self.start = start
        self.len = len(start)
        self.patches: list[TestPatch] = []

    def ins(self, pos: int, text: str) -> None:
        assert 0 <= pos <= self.len, (pos, self.len)
        self.patches.append(TestPatch(pos, 0, text))
        self.len += len(text)

    def delete(self, pos: int, n: int) -> None:
        assert 0 <= pos and pos + n <= self.len, (pos, n, self.len)
        self.patches.append(TestPatch(pos, n, ""))
        self.len -= n

    def wipe(self) -> None:
        """The full-doc delete: [0, len) exactly."""
        if self.len:
            self.delete(0, self.len)

    def trace(self) -> TestData:
        td = TestData(self.start, "", [TestTxn("", list(self.patches))])
        return TestData(self.start, replay_trace(td), td.txns)


def _chars(n: int, salt: int) -> str:
    return "".join(chr(97 + (salt + j) % 26) for j in range(n))


def _position_extremes() -> TestData:
    """Every op-position edge on one small doc: insert at 0, at len,
    at len-1, delete of the first and last char, the exact full wipe,
    the refill of an emptied doc, down to a single-char doc."""
    s = _Script("ab")
    s.ins(0, "L")  # prepend into a non-empty doc
    s.ins(s.len, "R")  # append at exactly len
    s.ins(s.len - 1, "m")  # one before the end
    s.ins(s.len // 2, "c")  # interior, for contrast
    s.delete(0, 1)  # first char
    s.delete(s.len - 1, 1)  # last char
    s.wipe()  # delete [0, len) — the doc is now empty
    s.ins(0, "xyz")  # insert into the emptied doc
    s.delete(1, 1)
    s.wipe()
    s.ins(0, "q")  # end as a single-char doc
    return s.trace()


def _empty_churn(cycles: int) -> TestData:
    """Grow-from-empty / wipe-to-empty churn, ending EMPTY — the
    zero-length decode edge, reached repeatedly, from an empty
    start_content (n_init = 0)."""
    s = _Script("")
    for i in range(cycles):
        s.ins(0, _chars(i % 3 + 1, i))
        s.ins(s.len, _chars(1, i + 7))
        s.wipe()
    return s.trace()


def _all_pad_stream() -> TestData:
    """The zero-op trace: no patches at all.  Its tensorized stream is
    pure padding — the literal all-PAD round — and its final content
    is its (empty) start content."""
    return TestData("", "", [])


def _capacity_exact(cap: int, run: int = 48, full_end: bool = False,
                    init: str = "ab") -> TestData:
    """Drive a doc's capacity need (n_init + total inserted chars) to
    EXACTLY ``cap`` — the class-boundary doc.  Growth runs rotate
    through the position extremes (0 / len / mid).  ``full_end`` keeps
    every char, so the final visible length equals the class capacity
    (a completely full row); otherwise the doc is deleted down to a
    handful of chars, leaving capacity at the edge but the row mostly
    dead — both shapes cross the same clamp regions differently."""
    s = _Script(init)
    budget = cap - len(init)
    assert budget >= 0, (cap, init)
    i = 0
    while budget:
        n = min(run, budget)
        pos = 0 if i % 3 == 0 else (s.len if i % 3 == 1 else s.len // 2)
        s.ins(pos, _chars(n, i))
        budget -= n
        i += 1
    if not full_end and s.len > 7:
        s.delete(0, s.len - 7)
    return s.trace()


def _id_pressure(cap: int, run: int) -> TestData:
    """Pure append growth to capacity ``cap``: slot ids climb
    monotonically to ``cap - 1`` (the top of the pool's id space) and
    insert positions climb with them — on the 65408-class narrow
    ladder this staffs the uint16 lanes with their largest legal
    values; on the 65664-class wide ladder the same script carries ids
    ACROSS the uint16 boundary in int32 lanes.  Ends deleted down to a
    stub so the decode compare stays cheap while the ids stay maximal."""
    s = _Script("")
    while s.len < cap:
        n = min(run, cap - s.len)
        s.ins(s.len, _chars(n, s.len))
    if s.len > 9:
        s.delete(0, s.len - 9)
    return s.trace()


def _small_fleet() -> list[Session]:
    """The small-ladder fleet: every structural edge on a (256, 512)
    class pair, plus seeded random mass.  Arrivals are staggered so
    early rounds stage PAD rows for not-yet-arrived docs and late
    rounds stage PAD rows for drained ones."""
    traces = [
        _position_extremes(),
        _empty_churn(6),
        _all_pad_stream(),
        _capacity_exact(256, full_end=True),  # visible len == class cap
        _capacity_exact(255),  # one under the boundary
        _capacity_exact(257),  # one over: lands in the 512 class
        _id_pressure(256, run=48),  # ids to the top of the 256 space
        synth_trace(101, 220),
        synth_trace(102, 60, base="hello world"),
    ]
    arrivals = [0, 2, 1, 0, 1, 0, 3, 0, 2]
    return [
        Session(doc_id=i, band="edge", source="edge", trace=t, arrival=a)
        for i, (t, a) in enumerate(zip(traces, arrivals))
    ]


def _ladder_fleet(cap: int) -> list[Session]:
    """The uint16-bracket fleets: one doc at the big class's exact
    capacity with maximal ids, one small-class edge doc, one random."""
    return [
        Session(doc_id=0, band="edge", source="edge",
                trace=_id_pressure(cap, run=896), arrival=0),
        Session(doc_id=1, band="edge", source="edge",
                trace=_position_extremes(), arrival=1),
        Session(doc_id=2, band="edge", source="edge",
                trace=synth_trace(103, 120), arrival=0),
    ]


# ---------------------------------------------------------------------------
# the armed differential drains
# ---------------------------------------------------------------------------


def _drain(workdir: str, tag: str, sessions, classes, slots, kernel: str,
           batch_chars: int, device) -> tuple[dict[int, str], int]:
    """One armed drain: build the pool on ``kernel``, run the fleet,
    byte-verify every doc against the oracle, return the decodes (for
    the cross-kernel compare) and the round count."""
    sp = os.path.join(workdir, f"{tag}-{kernel}")
    pool = DocPool(classes=classes, slots=slots, spool_dir=sp,
                   serve_kernel=kernel, device=device)
    try:
        streams = prepare_streams(sessions, pool, batch=_BATCH,
                                  batch_chars=batch_chars)
        sched = FleetScheduler(pool, streams, batch=_BATCH,
                               macro_k=_MACRO_K, batch_chars=batch_chars)
        sched.run()
        out: dict[int, str] = {}
        for s in sessions:
            if not any(True for _ in s.trace.iter_patches()):
                # the zero-op stream: registered, but the scheduler
                # never stages a round for it, so it is never admitted
                # — decode refusing is the contract, and the doc's
                # content is its (empty) start content
                try:
                    pool.decode(s.doc_id)
                except ValueError:
                    out[s.doc_id] = s.trace.start_content
                    continue
                raise AssertionError(
                    f"{tag}/{kernel}: zero-op doc {s.doc_id} was "
                    "admitted — a pure-PAD stream staged real rounds"
                )
            got = pool.decode(s.doc_id)
            want = replay_trace(s.trace)
            if got != want:
                i = next(
                    (k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                    min(len(got), len(want)),
                )
                raise AssertionError(
                    f"{tag}/{kernel}: doc {s.doc_id} diverges from the "
                    f"oracle at char {i} (got len {len(got)}, want "
                    f"{len(want)}): {got[i:i + 12]!r} != {want[i:i + 12]!r}"
                )
            out[s.doc_id] = got
        return out, sched.round
    finally:
        pool.close()


def _run_ladder(workdir: str, log, tag: str, sessions, classes, slots,
                batch_chars: int, device) -> dict:
    """One fleet through BOTH kernels: each oracle-verified, then the
    two decode maps compared byte-for-byte (the kernel differential)."""
    fused, r_f = _drain(workdir, tag, sessions, classes, slots, "fused",
                        batch_chars, device)
    scan, r_s = _drain(workdir, tag, sessions, classes, slots, "scan",
                       batch_chars, device)
    if fused != scan:
        bad = sorted(d for d in fused if fused[d] != scan.get(d))
        raise AssertionError(
            f"{tag}: fused and scan kernels disagree on docs {bad}"
        )
    log(f"edgecheck: {tag} clean — {len(sessions)} docs x 2 kernels, "
        f"oracle-identical ({r_f}+{r_s} rounds)")
    return {"docs": len(sessions), "classes": list(classes),
            "rounds": {"fused": r_f, "scan": r_s}}


# ---------------------------------------------------------------------------
# the boundary-contract differential fuzz
# ---------------------------------------------------------------------------

#: modules whose import registers every @boundary contract (the same
#: list the lint CLI's --boundaries dump imports, plus the ops-level
#: entries imported transitively there but named here explicitly)
_BOUNDARY_MODULES = (
    "crdt_benches_tpu_torch.ops.resolve",
    "crdt_benches_tpu_torch.ops.resolve_range",
    "crdt_benches_tpu_torch.ops.apply2",
    "crdt_benches_tpu_torch.ops.apply_range",
    "crdt_benches_tpu_torch.serve.pool",
    "crdt_benches_tpu_torch.engine.replay",
    "crdt_benches_tpu_torch.engine.replay_range",
    "crdt_benches_tpu_torch.engine.merge",
    "crdt_benches_tpu_torch.engine.merge_range",
    "crdt_benches_tpu_torch.engine.merge_fleet",
    "crdt_benches_tpu_torch.engine.downstream",
    "crdt_benches_tpu_torch.engine.downstream_range",
)

#: the dtype-edge swap set: for every typed lane, each of these that
#: differs from the declared dtype must be rejected
_EDGE_DTYPES = ("int8", "uint16", "int32", "int64")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _contract_args(c, rng) -> list:
    """A conforming argument list for contract ``c`` at its dtype
    edges: every typed/shaped slot is a real array of the declared
    dtype with symbolic dims bound to seeded sizes, filled with the
    dtype's ``iinfo`` extremes; unchecked slots (state pytrees) are a
    one-leaf list so the in-place overlap check has a buffer to track."""
    n = max(len(c.dtypes), len(c.shapes), max(c.donates, default=-1) + 1)
    env: dict[str, int] = {}
    args: list = []
    for i in range(n):
        dt = c.dtypes[i] if i < len(c.dtypes) else None
        spec = c.shapes[i] if i < len(c.shapes) else None
        if dt is None and spec is None:
            args.append([torch.zeros(int(rng.integers(2, 5)),
                                     dtype=torch.int32)])
            continue
        if spec is not None:
            shape = tuple(
                int(t) if t.isdigit()
                else env.setdefault(t, int(rng.integers(2, 6)))
                for t in spec.split()
            )
        else:
            shape = (int(rng.integers(2, 6)),)
        dtype = _torch_dtype(dt or "int32")
        info = torch.iinfo(dtype)
        a = torch.full(shape, info.max, dtype=dtype)
        a.view(-1)[::2] = info.min  # both edges on every lane
        args.append(a)
    return args


def _expect_reject(c, args, what: str) -> None:
    try:
        _check_call(c, tuple(args))
    except BoundaryError:
        return
    raise AssertionError(
        f"boundary fuzz: {c.name} ACCEPTED a {what} perturbation — "
        "the contract checker no longer rejects it"
    )


def _fuzz_contract(c, rng) -> dict:
    """Differential fuzz of one registry entry: the conforming
    edge-filled call must pass, then every one-field perturbation
    (edge-dtype swap, rank bump, inconsistent symbolic binding,
    aliased donation) must raise BoundaryError."""
    args = _contract_args(c, rng)
    _check_call(c, tuple(args))  # the conforming baseline
    rejects = 0
    for i, want in enumerate(c.dtypes):
        if want is None:
            continue
        for ed in _EDGE_DTYPES:
            if ed == want:
                continue
            bad = list(args)
            bad[i] = args[i].to(_torch_dtype(ed))
            _expect_reject(c, bad, f"arg{i} {want}->{ed} dtype")
            rejects += 1
    sym_seen: dict[str, int] = {}
    sym_pair = None  # (arg index, dim index) of a repeated symbol
    for i, spec in enumerate(c.shapes):
        if spec is None:
            continue
        bad = list(args)
        bad[i] = args[i][None]  # rank bump
        _expect_reject(c, bad, f"arg{i} rank")
        rejects += 1
        for d, tok in enumerate(spec.split()):
            if tok.isdigit():
                continue
            if tok in sym_seen and sym_pair is None and sym_seen[tok] != i:
                sym_pair = (i, d)
            sym_seen.setdefault(tok, i)
    if sym_pair is not None:
        i, d = sym_pair
        bad = list(args)
        shape = list(args[i].shape)
        shape[d] += 1  # contradicts the binding made by an earlier arg
        bad[i] = torch.zeros(shape, dtype=args[i].dtype)
        _expect_reject(c, bad, "symbolic-dim binding")
        rejects += 1
    for i in c.donates:
        j = next(
            (k for k, a in enumerate(args)
             if k != i and isinstance(a, torch.Tensor)),
            None,
        )
        if j is None:
            continue
        bad = list(args)
        bad[i] = [bad[j][..., :1]]  # the written pytree overlaps arg j
        _expect_reject(c, bad, f"in-place arg{i} overlapping arg{j}")
        rejects += 1
    return {"rejects": rejects}


def _fuzz_boundaries(seed: int, log, rounds: int = 4) -> dict:
    """Seeded differential fuzz of EVERY @boundary registry entry at
    its contract's dtype edges (module docstring, second leg)."""
    for mod in _BOUNDARY_MODULES:
        importlib.import_module(mod)
    # registry keys are "module.qualname": fuzz the port's contracts
    # only, not toy @boundary functions a test may have registered
    ours = [n for n in sorted(REGISTRY)
            if n.startswith("crdt_benches_tpu_torch.")]
    if not ours:
        raise AssertionError("boundary registry is empty after imports")
    per: dict[str, int] = {}
    total = 0
    for name in ours:
        c = REGISTRY[name]
        rng = np.random.default_rng((seed, zlib.crc32(name.encode())))
        n = 0
        for _ in range(rounds):
            n += _fuzz_contract(c, rng)["rejects"]
        if n == 0:
            raise AssertionError(
                f"boundary fuzz: {name} produced no rejectable "
                "perturbations — the contract declares nothing checkable"
            )
        per[name] = n
        total += n
    log(f"edgecheck: boundary fuzz clean — {len(per)} contracts, "
        f"{total} edge perturbations all rejected")
    return {"contracts": len(per), "rejected": total, "per_entry": per}


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def run_edgecheck(workdir: str | None = None, log=lambda s: None,
                  small: bool = False, device="cuda") -> dict:
    """The full check.  Returns a report dict::

        {"ladders": {tag: {...}}, "checks": {...}, "masks": {...},
         "boundary_fuzz": {...}}

    Every drain runs with the range sanitizer ARMED in one counter
    window: any staged index outside its declared bound, any narrow
    lane past its headroom, any PAD payload on a checked lane raises a
    typed error at the staging callsite; every final doc is oracle-
    and cross-kernel-verified; the required check/mask counters are
    asserted nonzero so the harness can never silently cover nothing.
    ``small`` keeps the structural edges and drops the two big-ladder
    fleets (the uint16 bracket) — the CPU tests' shape.  ``device``: the
    pools' (the card by default; ``"cpu"`` runs the plain versions).
    The range sanitizer is put back as it was found.
    """
    device = resolve_device(device)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="crdt_edgecheck_")
    was_armed = ranges.armed()
    ranges.reset_counters()
    ranges.arm()
    try:
        ladders: dict[str, dict] = {}
        ladders["small-ladder"] = _run_ladder(
            workdir, log, "small-ladder", _small_fleet(),
            classes=(256, 512), slots=(2, 2), batch_chars=64,
            device=device,
        )
        if not small:
            # the uint16 bracket: the largest narrow ladder (ids to
            # the top of the uint16 space) and the smallest wide one
            # (ids across the uint16 boundary in int32 lanes)
            ladders["narrow-max"] = _run_ladder(
                workdir, log, "narrow-max", _ladder_fleet(_NARROW_MAX_CLASS),
                classes=(256, _NARROW_MAX_CLASS), slots=(2, 1),
                batch_chars=256, device=device,
            )
            ladders["wide-min"] = _run_ladder(
                workdir, log, "wide-min", _ladder_fleet(_WIDE_MIN_CLASS),
                classes=(256, _WIDE_MIN_CLASS), slots=(2, 1),
                batch_chars=256, device=device,
            )
        c = ranges.counters()
        for name in _REQUIRED_CHECKS:
            if not c["checks"].get(name):
                raise AssertionError(
                    f"check `{name}` recorded zero dispatches — the "
                    "harness no longer covers it"
                )
        for tag in _REQUIRED_MASKS:
            if not c["masks"].get(tag):
                raise AssertionError(
                    f"mask `{tag}` recorded zero dispatches — the "
                    "harness no longer covers it"
                )
        fuzz = _fuzz_boundaries(_SEED, log)
        return {
            "ladders": ladders,
            "checks": c["checks"],
            "masks": c["masks"],
            "boundary_fuzz": fuzz,
        }
    finally:
        if not was_armed:
            ranges.disarm()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m crdt_benches_tpu_torch.serve.edgecheck")
    ap.add_argument("--small", action="store_true",
                    help="the small ladder only (no uint16 bracket)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    try:
        args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    except SystemExit as e:
        return int(e.code or 0)
    try:
        report = run_edgecheck(log=lambda s: print(s, flush=True),
                               small=args.small, device=args.device)
    except (AssertionError, ranges.RangeSanitizerError) as e:
        print(f"edgecheck: FAILED — {e}", file=sys.stderr)
        return 1
    docs = sum(t["docs"] for t in report["ladders"].values())
    checks = sum(report["checks"].values())
    print(
        f"edgecheck: OK — {docs} docs x 2 kernels across "
        f"{len(report['ladders'])} ladders oracle-identical, "
        f"{checks} armed range checks, "
        f"{report['boundary_fuzz']['rejected']} boundary edge "
        "perturbations rejected"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
