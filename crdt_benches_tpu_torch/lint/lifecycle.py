"""Lifecycle & ownership rules G022-G025: state-machine discipline,
acquire/release pairing, identity/generation hazards, and the runtime
lifecycle-artifact cross-check.

The last three PRs each shipped a latent lifecycle bug no existing
rule could see: a prefetch inflight counter underflowed, an
``id(trace)``-keyed cache was poisoned by id recycling, duplicate GC
enqueues KeyError'd mid-reclaim, and a doc was migrated before its
install was real.  These rules encode that incident class the same
way G014-G021 encoded theirs: a declared static model, enforced
against the AST, with a runtime sanitizer twin
(lint/lifecycle_sanitizer.py) whose counters the artifact-driven G025
cross-checks.

Marker vocabulary (parsed from REAL comments via
``ModuleInfo.comments``; richer than core's ``_MARKER_RE`` — keys
carry ``,``/``->`` payloads):

- class line::

    # graftlint: state=<machine> [field=<attr>] [states=a,b,...]
    #            [edges=a->b,b->c,...]

  declares a state machine (``doc``/``row``/``spool``/``stream``/
  ``session``), optionally naming the guarded instance attribute, the
  state vocabulary, and the legal edge graph.

- def line ``# graftlint: transition=<machine>:<a>-><b>[,<c>-><d>..]``
  declares a transition function and the edges it is allowed to
  traverse.

- def line ``# graftlint: acquire=<resource>`` / ``release=<resource>``
  declares a paired ownership primitive
  (``rows``/``spool``/``stream``/``segment``/``socket``/``thread``).

**G022 — state-machine discipline.**  A direct store to a declared
state field outside a transition function (or ``__init__``) in the
machine's jurisdiction (the modules that declare it or carry its
transitions), a transition marker for a machine nothing declares, a
transition endpoint outside the declared state vocabulary, or a
transition edge missing from the declared graph (the
same-round-admit migration was exactly an illegal edge out of
GENESIS) are all findings.

**G023 — acquire/release pairing.**  Marked functions are the
primitives; every *unmarked* function is walked statement-ordered and
its resolved calls to primitives (confident edges only, plus a
unique-bare-name fallback) become acquire/release events.  An acquire
whose balance never returns to zero on the fall-off path — with no
release in a covering ``finally`` and no ownership escape (returned,
stored into an attribute/subscript, or handed to another call) — is a
leak-on-path; a release that would drive the balance negative, or a
syntactically identical repeated release, is a double-release; a
resource acquired somewhere but released nowhere (or vice versa) is
unpaired at the marker level.

**G024 — identity/generation hazards.**  An attribute-held map
(``self._cache`` — long-lived state) keyed by ``id(obj)`` (subscript
or ``.get``/``.setdefault``/``.pop``) without a >=2-tuple generation
component is the cache-poisoning incident (a function-local
table keyed by id() over pinned objects is the legal identity idiom
and stays out of scope); inside
lifecycle-annotated classes, a paired ``+=``/``-=`` attribute whose
decrement carries no underflow guard (a dominating self-test /
``is``/``in`` filter / ``> 0`` comparison, or an earlier
membership-``continue`` filter in the same function) is the inflight
underflow.

**G025 — lifecycle artifact cross-check** (artifact-driven, mirrors
G011/G017/G021): the serve artifact's ``lifecycle`` block (the
lifecycle sanitizer's transition/acquire counters) is the runtime
ground truth.  A declared machine/resource the run never touched is
DEAD (scoped by armed surface); a runtime machine or resource with no
static declaration, and unattributed runtime transitions, are model
escapes — all findings.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from .core import Finding, FuncInfo, ModuleInfo, PackageIndex
from .lifecycle_sanitizer import KNOWN_MACHINES, KNOWN_RESOURCES
from .threads import load_artifact_block

_STATE_RE = re.compile(
    r"#\s*graftlint:\s*state=([a-zA-Z0-9_-]+)([^#]*)"
)
_FIELD_RE = re.compile(r"\bfield=([A-Za-z_][A-Za-z0-9_]*)")
_STATES_RE = re.compile(r"\bstates=([A-Za-z0-9_,]+)")
_EDGES_RE = re.compile(r"\bedges=([A-Za-z0-9_>,\-]+)")
_TRANS_RE = re.compile(
    r"#\s*graftlint:\s*transition=([a-zA-Z0-9_-]+):([A-Za-z0-9_>,\-]+)"
)
_ACQ_RE = re.compile(r"#\s*graftlint:\s*acquire=([a-zA-Z0-9_-]+)")
_REL_RE = re.compile(r"#\s*graftlint:\s*release=([a-zA-Z0-9_-]+)")

#: Armed-surface scoping for the G025 dead checks, the
#: PROTOCOL_SURFACES pattern: a machine/resource is only expected to
#: have runtime entries when the run armed the surface it lives on.
MACHINE_SURFACES = {
    "doc": "pool",
    "spool": "pool",
    "row": "reshard",
    "stream": "stream",
    "session": "ingest",
}
RESOURCE_SURFACES = {
    "rows": "pool",
    "spool": "pool",
    "stream": "stream",
    "segment": "journal",
    "socket": "ingest",
    "thread": "prefetch",
}


def _parse_edges(spec: str) -> tuple[list[tuple[str, str]], list[str]]:
    """``a->b,c->d`` as edge pairs + the malformed chunks."""
    edges, bad = [], []
    for chunk in spec.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split("->")
        if len(parts) == 2 and parts[0] and parts[1]:
            edges.append((parts[0], parts[1]))
        else:
            bad.append(chunk)
    return edges, bad


@dataclass
class MachineDecl:
    name: str
    module: ModuleInfo
    cls: str | None
    line: int
    col: int
    field_name: str | None = None
    states: frozenset | None = None
    edges: frozenset | None = None


@dataclass
class TransitionDecl:
    machine: str
    edges: list
    fi: FuncInfo
    line: int


@dataclass
class LifecycleModel:
    machines: dict = field(default_factory=dict)  # name -> MachineDecl
    transitions: list = field(default_factory=list)
    acquires: dict = field(default_factory=dict)  # res -> [FuncInfo]
    releases: dict = field(default_factory=dict)
    #: (module path, class name) pairs carrying ANY lifecycle marker —
    #: the G024 pair-counter jurisdiction.
    marked_classes: set = field(default_factory=set)
    #: findings produced during parsing (malformed specs, unknown
    #: vocabulary) — surfaced by G022.
    parse_findings: list = field(default_factory=list)


def _class_decls(m: ModuleInfo):
    """Every ClassDef in the module (nested included), in order."""
    out = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                out.append(child)
                visit(child)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                visit(child)

    visit(m.tree)
    return out


def build_model(index: PackageIndex) -> LifecycleModel:
    # G022/G023/G024 all start from the same marker scan; memoize it
    # on the index (one lint run = one index) so the gate pays for the
    # comment sweep once, not once per rule.
    cached = getattr(index, "_lifecycle_model", None)
    if cached is not None:
        return cached
    model = LifecycleModel()
    for m in index.modules:
        cls_lines = {c.lineno: c for c in _class_decls(m)}
        for lineno, text in sorted(m.comments.items()):
            for sm in _STATE_RE.finditer(text):
                name, tail = sm.group(1), sm.group(2)
                node = cls_lines.get(lineno)
                cls = node.name if node is not None else None
                col = node.col_offset if node is not None else 0
                decl = MachineDecl(
                    name=name, module=m, cls=cls, line=lineno, col=col,
                )
                if name not in KNOWN_MACHINES:
                    model.parse_findings.append(Finding(
                        rule="G022", path=m.path, line=lineno, col=col,
                        msg=(
                            f"unknown state machine `{name}` — the "
                            "lifecycle model only knows "
                            f"{'/'.join(KNOWN_MACHINES)}; a typo'd "
                            "machine silently detaches every "
                            "transition declared for it"
                        ),
                    ))
                fm = _FIELD_RE.search(tail)
                if fm:
                    decl.field_name = fm.group(1)
                stm = _STATES_RE.search(tail)
                if stm:
                    decl.states = frozenset(
                        s for s in stm.group(1).split(",") if s
                    )
                em = _EDGES_RE.search(tail)
                if em:
                    edges, bad = _parse_edges(em.group(1))
                    decl.edges = frozenset(edges)
                    for b in bad:
                        model.parse_findings.append(Finding(
                            rule="G022", path=m.path, line=lineno,
                            col=col,
                            msg=(
                                f"malformed edge `{b}` in machine "
                                f"`{name}`'s declared graph (want "
                                "`from->to`)"
                            ),
                        ))
                if name not in model.machines:
                    model.machines[name] = decl
                if cls is not None:
                    model.marked_classes.add((m.path, cls))
        for fi in m.functions.values():
            text = m.comments.get(fi.node.lineno, "")
            if not text:
                continue
            for tm in _TRANS_RE.finditer(text):
                machine, spec = tm.group(1), tm.group(2)
                edges, bad = _parse_edges(spec)
                for b in bad:
                    model.parse_findings.append(Finding(
                        rule="G022", path=m.path, line=fi.node.lineno,
                        col=fi.node.col_offset,
                        msg=(
                            f"malformed transition edge `{b}` on "
                            f"`{fi.qualname}` (want `from->to`)"
                        ),
                    ))
                model.transitions.append(TransitionDecl(
                    machine=machine, edges=edges, fi=fi,
                    line=fi.node.lineno,
                ))
                if fi.cls is not None:
                    model.marked_classes.add((m.path, fi.cls))
            for am in _ACQ_RE.finditer(text):
                res = am.group(1)
                model.acquires.setdefault(res, []).append(fi)
                if res not in KNOWN_RESOURCES:
                    model.parse_findings.append(Finding(
                        rule="G023", path=m.path, line=fi.node.lineno,
                        col=fi.node.col_offset,
                        msg=(
                            f"unknown resource `{res}` in acquire "
                            "marker — the ownership model only knows "
                            f"{'/'.join(KNOWN_RESOURCES)}"
                        ),
                    ))
                if fi.cls is not None:
                    model.marked_classes.add((m.path, fi.cls))
            for rm in _REL_RE.finditer(text):
                res = rm.group(1)
                model.releases.setdefault(res, []).append(fi)
                if res not in KNOWN_RESOURCES:
                    model.parse_findings.append(Finding(
                        rule="G023", path=m.path, line=fi.node.lineno,
                        col=fi.node.col_offset,
                        msg=(
                            f"unknown resource `{res}` in release "
                            "marker — the ownership model only knows "
                            f"{'/'.join(KNOWN_RESOURCES)}"
                        ),
                    ))
                if fi.cls is not None:
                    model.marked_classes.add((m.path, fi.cls))
    index._lifecycle_model = model
    return model


# ---------------------------------------------------------------------------
# G022 — state-machine discipline
# ---------------------------------------------------------------------------


def g022_state_discipline(index: PackageIndex) -> list[Finding]:
    model = build_model(index)
    out = [f for f in model.parse_findings if f.rule == "G022"]
    by_machine: dict[str, list[TransitionDecl]] = {}
    for t in model.transitions:
        by_machine.setdefault(t.machine, []).append(t)

    for t in model.transitions:
        decl = model.machines.get(t.machine)
        if decl is None:
            out.append(Finding(
                rule="G022", path=t.fi.module.path, line=t.line,
                col=t.fi.node.col_offset,
                msg=(
                    f"transition marker on `{t.fi.qualname}` names "
                    f"machine `{t.machine}` but no class declares it "
                    "(`# graftlint: state=...`) — orphaned transition"
                ),
            ))
            continue
        for frm, to in t.edges:
            if decl.states is not None:
                for endpoint in (frm, to):
                    if endpoint not in decl.states:
                        out.append(Finding(
                            rule="G022", path=t.fi.module.path,
                            line=t.line, col=t.fi.node.col_offset,
                            msg=(
                                f"transition `{frm}->{to}` on "
                                f"`{t.fi.qualname}` uses state "
                                f"`{endpoint}` outside machine "
                                f"`{t.machine}`'s declared vocabulary "
                                f"{sorted(decl.states)}"
                            ),
                        ))
            if decl.edges is not None and (frm, to) not in decl.edges:
                out.append(Finding(
                    rule="G022", path=t.fi.module.path, line=t.line,
                    col=t.fi.node.col_offset,
                    msg=(
                        f"illegal `{t.machine}` transition "
                        f"`{frm}->{to}` on `{t.fi.qualname}`: not an "
                        "edge of the declared graph "
                        f"{sorted('->'.join(e) for e in decl.edges)} — "
                        "an undeclared edge is how a doc got migrated "
                        "straight out of GENESIS"
                    ),
                ))

    # direct writes to a declared state field outside its transition
    # functions, within the machine's jurisdiction
    for name, decl in sorted(model.machines.items()):
        if decl.field_name is None:
            continue
        jurisdiction = {decl.module.path}
        allowed: set[int] = set()
        for t in by_machine.get(name, ()):
            jurisdiction.add(t.fi.module.path)
            allowed.add(id(t.fi.node))
        for m in index.modules:
            if m.path not in jurisdiction:
                continue
            for fi in m.functions.values():
                if id(fi.node) in allowed:
                    continue
                if fi.qualname.split(".")[-1] == "__init__":
                    continue
                for node in ast.walk(fi.node):
                    targets = ()
                    if isinstance(node, ast.Assign):
                        targets = node.targets
                    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                        targets = (node.target,)
                    for tgt in targets:
                        for leaf in ast.walk(tgt):
                            if (
                                isinstance(leaf, ast.Attribute)
                                and leaf.attr == decl.field_name
                            ):
                                out.append(Finding(
                                    rule="G022", path=m.path,
                                    line=node.lineno,
                                    col=node.col_offset,
                                    msg=(
                                        "direct write to state field "
                                        f"`.{decl.field_name}` of "
                                        f"machine `{name}` outside a "
                                        "declared transition function "
                                        f"(`{fi.qualname}`) — route it "
                                        "through a `# graftlint: "
                                        f"transition={name}:...` "
                                        "function so the edge is "
                                        "declared and counted"
                                    ),
                                ))
    return out


# ---------------------------------------------------------------------------
# G023 — acquire/release pairing
# ---------------------------------------------------------------------------


def _marker_map(model: LifecycleModel) -> dict[int, list]:
    """id(FuncInfo.node) -> [("acq"|"rel", resource)] for primitives."""
    marks: dict[int, list] = {}
    for res, fis in model.acquires.items():
        for fi in fis:
            marks.setdefault(id(fi.node), []).append(("acq", res))
    for res, fis in model.releases.items():
        for fi in fis:
            marks.setdefault(id(fi.node), []).append(("rel", res))
    return marks


def _bare_name_fallback(model: LifecycleModel) -> dict[str, tuple]:
    """bare function name -> its unique ("acq"|"rel", resource), for
    attribute calls the strict resolver cannot see through
    (``self.prefetcher.stop()``).  Ambiguous names resolve to
    nothing — precision over recall, same reasoning as strict
    resolve_call."""
    seen: dict[str, set] = {}
    for kind, table in (("acq", model.acquires),
                        ("rel", model.releases)):
        for res, fis in table.items():
            for fi in fis:
                bare = fi.qualname.split(".")[-1]
                seen.setdefault(bare, set()).add((kind, res))
    return {
        name: next(iter(kinds))
        for name, kinds in seen.items() if len(kinds) == 1
    }


@dataclass
class _Event:
    kind: str  # "acq" | "rel"
    resource: str
    call: ast.Call
    stmt: ast.stmt
    in_finally: bool


def _collect_events(fi: FuncInfo, index: PackageIndex,
                    marks: dict[int, list],
                    fallback: dict[str, tuple],
                    candidates: frozenset) -> list[_Event]:
    events: list[_Event] = []

    def calls_of(stmt: ast.stmt):
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                yield node

    def classify(call: ast.Call) -> list[tuple]:
        # cheap bare-name prefilter: resolve_call only when the callee
        # name could possibly be a marked primitive
        f = call.func
        name = (
            f.id if isinstance(f, ast.Name)
            else f.attr if isinstance(f, ast.Attribute) else None
        )
        if name is None or name not in candidates:
            return []
        hits = []
        for callee in index.resolve_call(call, fi, strict=True):
            hits.extend(marks.get(id(callee.node), ()))
        if not hits and isinstance(call.func, ast.Attribute):
            fb = fallback.get(call.func.attr)
            if fb is not None:
                hits.append(fb)
        return list(dict.fromkeys(hits))

    def calls_of_shallow(s):
        """Calls in a control statement's own header (test / iter /
        with-items), not its body — bodies recurse separately so Try
        nesting keeps its finally tagging."""
        headers = []
        if isinstance(s, (ast.If, ast.While)):
            headers.append(s.test)
        elif isinstance(s, ast.For):
            headers.extend([s.target, s.iter])
        elif isinstance(s, ast.With):
            for item in s.items:
                headers.append(item.context_expr)
        for h in headers:
            for node in ast.walk(h):
                if isinstance(node, ast.Call):
                    yield node

    def ordered(stmts, in_finally: bool, sink: list[_Event]):
        for s in stmts:
            if isinstance(s, ast.Try):
                # handlers are the crash paths — G023 checks the
                # non-crash paths (the crash windows belong to the fs
                # crash-enumeration harness); finally-releases cover
                # every exit, so they are tagged
                ordered(s.body, in_finally, sink)
                ordered(s.orelse, in_finally, sink)
                ordered(s.finalbody, True, sink)
            elif isinstance(s, ast.If) and s.orelse:
                for call in calls_of_shallow(s):
                    for kind, res in classify(call):
                        sink.append(
                            _Event(kind, res, call, s, in_finally)
                        )
                # if/else are ALTERNATIVE paths: linearizing both
                # would double-count an either-way release (a migrate
                # batch that releases the source row on both the
                # row-to-row and the demote branch is balanced, not a
                # double release).  Keep the heavier branch — ties go
                # to the if-body, so a branch-local acquire stays
                # visible to the leak check.
                body_ev: list[_Event] = []
                else_ev: list[_Event] = []
                ordered(s.body, in_finally, body_ev)
                ordered(s.orelse, in_finally, else_ev)
                sink.extend(
                    body_ev if len(body_ev) >= len(else_ev) else else_ev
                )
            elif isinstance(s, (ast.If, ast.For, ast.While, ast.With)):
                for call in calls_of_shallow(s):
                    for kind, res in classify(call):
                        sink.append(
                            _Event(kind, res, call, s, in_finally)
                        )
                ordered(s.body, in_finally, sink)
                ordered(getattr(s, "orelse", []) or [], in_finally, sink)
            else:
                for call in calls_of(s):
                    for kind, res in classify(call):
                        sink.append(
                            _Event(kind, res, call, s, in_finally)
                        )

    ordered(fi.node.body, False, events)
    return events


def _escape_names(fi: FuncInfo) -> set[str]:
    """Names whose value leaves the function's ownership: returned,
    stored into an attribute/subscript, or passed to another call."""
    out: set[str] = set()
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Return) and node.value is not None:
            for leaf in ast.walk(node.value):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
        elif isinstance(node, ast.Assign):
            if any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                or any(
                    isinstance(e, (ast.Attribute, ast.Subscript))
                    for e in ast.walk(t)
                )
                for t in node.targets
            ):
                for leaf in ast.walk(node.value):
                    if isinstance(leaf, ast.Name):
                        out.add(leaf.id)
        elif isinstance(node, ast.Call):
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                for leaf in ast.walk(a):
                    if isinstance(leaf, ast.Name):
                        out.add(leaf.id)
    return out


def _acquire_escapes(ev: _Event, fi: FuncInfo,
                     escaped: set[str]) -> bool:
    # handle-by-argument acquire (``take_row(row)``): the resource's
    # identity is an argument the caller's bookkeeping chose, so when
    # that handle is itself stored beyond the frame (or IS an attribute
    # load) the ownership record outlives the function — the release
    # lives wherever the record does
    for a in list(ev.call.args) + [kw.value for kw in ev.call.keywords]:
        for leaf in ast.walk(a):
            if isinstance(leaf, ast.Attribute):
                return True
            if isinstance(leaf, ast.Name) and leaf.id in escaped:
                return True
    stmt = ev.stmt
    if isinstance(stmt, ast.Return):
        return True
    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        targets = (
            stmt.targets if isinstance(stmt, ast.Assign)
            else [stmt.target]
        )
        for t in targets:
            for leaf in ast.walk(t):
                if isinstance(leaf, (ast.Attribute, ast.Subscript)):
                    return True  # stored beyond the frame
                if isinstance(leaf, ast.Name) and leaf.id in escaped:
                    return True
        return False
    if isinstance(stmt, ast.Expr) and stmt.value is ev.call:
        return False  # bare call, result dropped on the floor
    # the acquire feeds a larger expression (wrapped in another call,
    # a condition, a comprehension) — ownership moved, stay silent
    return True


def g023_acquire_release(index: PackageIndex) -> list[Finding]:
    model = build_model(index)
    out = [f for f in model.parse_findings if f.rule == "G023"]
    for res, fis in sorted(model.acquires.items()):
        if res in KNOWN_RESOURCES and res not in model.releases:
            fi = fis[0]
            out.append(Finding(
                rule="G023", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"resource `{res}` has an acquire marker but no "
                    "release marker anywhere in the lint scope — an "
                    "unpaired acquire is a leak by construction"
                ),
            ))
    for res, fis in sorted(model.releases.items()):
        if res in KNOWN_RESOURCES and res not in model.acquires:
            fi = fis[0]
            out.append(Finding(
                rule="G023", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"resource `{res}` has a release marker but no "
                    "acquire marker anywhere in the lint scope — a "
                    "release without a matching acquire protocol"
                ),
            ))
    marks = _marker_map(model)
    fallback = _bare_name_fallback(model)
    if not marks:
        return out
    candidates = frozenset(
        fi.qualname.split(".")[-1]
        for table in (model.acquires, model.releases)
        for fis in table.values() for fi in fis
    )
    for m in index.modules:
        for fi in m.functions.values():
            if id(fi.node) in marks:
                continue  # primitives are trusted, not analyzed
            events = _collect_events(fi, index, marks, fallback,
                                     candidates)
            if not events:
                continue
            escaped = _escape_names(fi)
            resources = sorted({e.resource for e in events})
            for res in resources:
                evs = [e for e in events if e.resource == res]
                acqs = [e for e in evs if e.kind == "acq"]
                if not acqs:
                    # release-only function: legal cleanup — unless
                    # the SAME release is issued twice verbatim (the
                    # duplicate-GC-enqueue shape)
                    seen_dumps: dict[str, _Event] = {}
                    for e in evs:
                        d = ast.dump(e.call)
                        if d in seen_dumps:
                            out.append(Finding(
                                rule="G023", path=m.path,
                                line=e.call.lineno,
                                col=e.call.col_offset,
                                msg=(
                                    f"double release of `{res}`: this "
                                    "call repeats an identical release "
                                    f"on line "
                                    f"{seen_dumps[d].call.lineno} — "
                                    "the second one fires on an "
                                    "already-dead resource"
                                ),
                            ))
                        else:
                            seen_dumps[d] = e
                    continue
                balance = 0
                finally_covered = any(
                    e.kind == "rel" and e.in_finally for e in evs
                )
                for e in evs:
                    if e.kind == "acq":
                        balance += 1
                    else:
                        if balance == 0 and any(
                            isinstance(leaf, ast.Attribute)
                            for a in (list(e.call.args)
                                      + [kw.value for kw in e.call.keywords])
                            for leaf in ast.walk(a)
                        ):
                            # the handle is an attribute load (a record
                            # field, not a local this frame acquired):
                            # cross-frame ownership release, legal
                            # without a local dominating acquire
                            continue
                        balance -= 1
                        if balance < 0:
                            out.append(Finding(
                                rule="G023", path=m.path,
                                line=e.call.lineno,
                                col=e.call.col_offset,
                                msg=(
                                    f"release of `{res}` without a "
                                    "dominating acquire in "
                                    f"`{fi.qualname}` — on the path "
                                    "walked this is a double release"
                                ),
                            ))
                            balance = 0
                if balance > 0 and not finally_covered:
                    if not any(
                        _acquire_escapes(e, fi, escaped) for e in acqs
                    ):
                        e = acqs[0]
                        out.append(Finding(
                            rule="G023", path=m.path,
                            line=e.call.lineno, col=e.call.col_offset,
                            msg=(
                                f"`{res}` acquired in "
                                f"`{fi.qualname}` is never released "
                                "on the fall-off path and never "
                                "escapes the frame (not returned, "
                                "stored, or handed off) — leaked on "
                                "every non-crash exit"
                            ),
                        ))
    return out


# ---------------------------------------------------------------------------
# G024 — identity/generation hazards
# ---------------------------------------------------------------------------

_KEYED_METHODS = ("get", "setdefault", "pop")

#: Text prefilter for the id-key scan: a module with no ``id(`` call
#: anywhere cannot hold the hazard, and skipping its AST walk keeps
#: the tier-1 stage-0 gate fast.
_ID_CALL_RE = re.compile(r"\bid\(")


def _is_id_call(node) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "id"
        and len(node.args) == 1
    )


def _id_key_hazard(key: ast.expr) -> ast.Call | None:
    """The bare ``id(...)`` call used as a map key, or None when the
    key is safe (no id() at all, or id() inside a >=2-element tuple —
    the generation component defeats recycling)."""
    if _is_id_call(key):
        return key
    if isinstance(key, ast.Tuple):
        if len(key.elts) >= 2:
            return None  # (id(x), gen) carries a generation component
        for e in key.elts:
            if _is_id_call(e):
                return e
    return None


def g024_identity_hazards(index: PackageIndex) -> list[Finding]:
    out: list[Finding] = []
    for m in index.modules:
        if not _ID_CALL_RE.search(m.src):
            continue
        for node in ast.walk(m.tree):
            # jurisdiction: maps held in ATTRIBUTES (self._cache /
            # obj.table) — the long-lived caches id recycling poisons.
            # A function-local table keyed by id() while its objects
            # are pinned for one pass (the linter's own walk sets) is
            # the legal identity idiom and stays out of scope.
            hazard = None
            if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Attribute
            ):
                hazard = _id_key_hazard(node.slice)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _KEYED_METHODS
                and isinstance(node.func.value, ast.Attribute)
                and node.args
            ):
                hazard = _id_key_hazard(node.args[0])
            if hazard is not None:
                out.append(Finding(
                    rule="G024", path=m.path, line=hazard.lineno,
                    col=hazard.col_offset,
                    msg=(
                        "map keyed by bare `id(...)`: CPython recycles "
                        "a freed object's id, so a later allocation "
                        "can silently hit the dead entry (the "
                        "cache poisoning) — key by identity that "
                        "cannot recycle, or add a generation "
                        "component (`(id(x), gen)`)"
                    ),
                ))
    model = build_model(index)
    out.extend(_pair_counter_hazards(index, model))
    return out


def _guarding_test(test: ast.expr) -> bool:
    """A conditional test that plausibly protects a decrement under
    it: a membership / identity / positivity comparison (`in`, `not
    in`, `is`, `is not`, `>`, `>=`) or any attribute read (the
    `if self.x:` truthiness shape) — the guard classes the prefetch
    fix used.  A plain boolean flag or `==` test does not count."""
    for leaf in ast.walk(test):
        if isinstance(leaf, ast.Compare) and any(
            isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot,
                            ast.Gt, ast.GtE))
            for op in leaf.ops
        ):
            return True
        if isinstance(leaf, ast.Attribute):
            return True
    return False


def _membership_filter_line(fi: FuncInfo) -> int | None:
    """The line of an `if x in ...: ... continue/return` filter — the
    prefetch drain's reaped-seq dedup — which guards every later
    decrement in the same function."""
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.If):
            continue
        has_membership = any(
            isinstance(op, (ast.In, ast.NotIn))
            for leaf in ast.walk(node.test)
            if isinstance(leaf, ast.Compare)
            for op in leaf.ops
        )
        bails = any(
            isinstance(b, (ast.Continue, ast.Return))
            for b in ast.walk(node)
        )
        if has_membership and bails:
            return node.lineno
    return None


def _pair_counter_hazards(index: PackageIndex,
                          model: LifecycleModel) -> list[Finding]:
    out: list[Finding] = []
    for m in index.modules:
        classes = {
            cls for path, cls in model.marked_classes if path == m.path
        }
        if not classes:
            continue
        incs: dict[str, list] = {}  # attr -> inc sites
        decs: dict[str, list] = {}  # attr -> (site, guarded, fi)
        for fi in m.functions.values():
            if fi.cls not in classes:
                continue
            filter_line = _membership_filter_line(fi)

            def scan(stmts, guarded: bool):
                for s in stmts:
                    if isinstance(s, ast.AugAssign) and isinstance(
                        s.target, ast.Attribute
                    ) and isinstance(s.target.value, ast.Name) \
                            and s.target.value.id == "self":
                        attr = s.target.attr
                        if isinstance(s.op, ast.Add):
                            incs.setdefault(attr, []).append(s)
                        elif isinstance(s.op, ast.Sub):
                            g = guarded or (
                                filter_line is not None
                                and filter_line < s.lineno
                            )
                            decs.setdefault(attr, []).append(
                                (s, g, fi)
                            )
                    if isinstance(s, ast.If):
                        scan(s.body,
                             guarded or _guarding_test(s.test))
                        scan(s.orelse, guarded)
                    elif isinstance(s, (ast.For, ast.While, ast.With)):
                        scan(s.body, guarded)
                        scan(getattr(s, "orelse", []) or [], guarded)
                    elif isinstance(s, ast.Try):
                        scan(s.body, guarded)
                        for h in s.handlers:
                            scan(h.body, guarded)
                        scan(s.orelse, guarded)
                        scan(s.finalbody, guarded)

            scan(fi.node.body, False)
        for attr in sorted(set(incs) & set(decs)):
            for s, guarded, fi in decs[attr]:
                if not guarded:
                    out.append(Finding(
                        rule="G024", path=m.path, line=s.lineno,
                        col=s.col_offset,
                        msg=(
                            f"paired counter `self.{attr}` is "
                            "decremented without an underflow guard "
                            f"in `{fi.qualname}` — an inc/dec "
                            "imbalance drives it negative (the "
                            "prefetch inflight underflow); clamp with "
                            "max(0, ...), test positivity, or filter "
                            "duplicates before the decrement"
                        ),
                    ))
    return out


# ---------------------------------------------------------------------------
# G025 — lifecycle artifact cross-check
# ---------------------------------------------------------------------------


def g025_lifecycle_artifact(index: PackageIndex, artifact_path: str
                            ) -> list[Finding]:
    """Cross-validate the declared lifecycle model against a serve
    run's ``lifecycle`` counters (the lifecycle sanitizer's ground
    truth): a declared machine/resource the run never touched is DEAD
    — the annotation is stale or the transition path moved; a runtime
    machine/resource (or an unattributed transition) with no matching
    static declaration is lifecycle activity the model does not know
    about.  Dead-checking is scoped by armed surface exactly like
    G011 fence tags and G021 protocol surfaces."""
    block, err = load_artifact_block(artifact_path, "lifecycle")
    if block is None:
        return [Finding(
            rule="G025", path=artifact_path, line=0, col=0, msg=err,
        )]
    out: list[Finding] = []
    version = block.get("version")
    if version != 1:
        out.append(Finding(
            rule="G025", path=artifact_path, line=0, col=0,
            msg=(
                f"lifecycle block version {version!r} is not the "
                "schema this rule validates (want 1) — regenerate the "
                "artifact or update the cross-check together with the "
                "schema"
            ),
        ))
        return out
    machines = block.get("machines") or {}
    resources = block.get("resources") or {}
    unattributed = block.get("unattributed") or []
    model = build_model(index)
    base = os.path.basename(artifact_path)
    for name, decl in sorted(model.machines.items()):
        surface = MACHINE_SURFACES.get(name)
        if surface is None:
            continue  # unknown machine: G022's finding, not G025's
        if surface not in block:
            out.append(Finding(
                rule="G025", path=decl.module.path, line=decl.line,
                col=decl.col,
                msg=(
                    f"machine `{name}` is scoped to surface "
                    f"`{surface}` but {base} records no such surface "
                    "— stale lifecycle schema or typo'd surface map; "
                    "an unmatchable surface silently disables the "
                    "dead-machine check"
                ),
            ))
            continue
        if not block.get(surface):
            continue  # surface not armed in this run
        if not machines.get(name):
            out.append(Finding(
                rule="G025", path=decl.module.path, line=decl.line,
                col=decl.col,
                msg=(
                    f"declared machine `{name}` recorded zero "
                    f"transitions in {base} (surface `{surface}` "
                    "armed) — dead machine: delete the stale "
                    "declaration or route the real state writes "
                    "through its transition functions"
                ),
            ))
    declared_res = {
        r for r in set(model.acquires) | set(model.releases)
        if r in KNOWN_RESOURCES
    }
    for res in sorted(declared_res):
        fis = model.acquires.get(res) or model.releases.get(res)
        fi = fis[0]
        surface = RESOURCE_SURFACES[res]
        if surface not in block:
            out.append(Finding(
                rule="G025", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"resource `{res}` is scoped to surface "
                    f"`{surface}` but {base} records no such surface "
                    "— stale lifecycle schema or typo'd surface map"
                ),
            ))
            continue
        if not block.get(surface):
            continue
        if not resources.get(res):
            out.append(Finding(
                rule="G025", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"declared resource `{res}` recorded zero "
                    f"acquire/release events in {base} (surface "
                    f"`{surface}` armed) — dead ownership protocol: "
                    "delete the stale markers or route the real "
                    "alloc/free path through them"
                ),
            ))
    for name in sorted(machines):
        if name not in model.machines:
            out.append(Finding(
                rule="G025", path=artifact_path, line=0, col=0,
                msg=(
                    f"runtime machine `{name}` has no matching "
                    "`# graftlint: state=` declaration — state "
                    "activity the static lifecycle model does not "
                    "know about"
                ),
            ))
    for res in sorted(resources):
        if res not in set(model.acquires) | set(model.releases):
            out.append(Finding(
                rule="G025", path=artifact_path, line=0, col=0,
                msg=(
                    f"runtime resource `{res}` has no matching "
                    "`# graftlint: acquire=`/`release=` marker — "
                    "ownership activity the static model does not "
                    "know about"
                ),
            ))
    for entry in sorted(set(unattributed)):
        out.append(Finding(
            rule="G025", path=artifact_path, line=0, col=0,
            msg=(
                f"unattributed runtime transition `{entry}` — the "
                "sanitizer saw an edge on a machine no "
                "declare_machine() registered; declare the machine "
                "or remove the stray transition call"
            ),
        ))
    return out
