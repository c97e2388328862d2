"""Thread-confinement analysis: rules G014-G017.

The serving stack is concurrent on the host side: the drain runs on the
**hot** thread, the live status endpoint renders on its own **status**
threads, and the broadcast bus and journal writer are their own logical
roots (today co-scheduled on the hot thread; the tiered-residency
prefetch work moves them off it).  The static model here is the
G002/G011 architecture applied to threads instead of device syncs:

- **ownership is declared**, not inferred: ``# graftlint: thread=<t>``
  on a def (or a class) line pins the function (or every method) to a
  thread root; ownership then propagates along the call graph — the
  same best-effort resolver the hot-path walks use, including subclass
  overrides of ``self.m()`` dispatches — into unmarked functions.  A
  function reachable from two roots is owned by both.
- **publish points are declared like fences**: ``# graftlint: publish``
  marks the one legal way a mutable object crosses threads — an atomic
  single-assignment reference swap (or a lock-guarded section).
  ``publish=<tag>`` scopes the G017 dead-point accounting to artifacts
  whose run armed that surface (``publish=status`` = the live status
  server).
- **G014 shared-mutable escape**: a mutable class attribute written on
  one thread and touched on another, with no write ever passing
  through a declared publish point, is a data race waiting for the
  second thread to actually exist.  Immutable single-assignment swaps
  (bools, strs, tuples of scalars — CPython makes the store atomic)
  are legal without a publish point; ``__init__`` writes precede
  thread handoff and are exempt.
- **G015 publish-point discipline**: inside a publish function the
  shared attribute may only be *swapped* (``self.x = fresh``), never
  mutated in place (``self.x[k] = v`` / ``self.x.append(...)`` — a
  reader on the other thread can observe the half-applied mutation);
  and a reader-thread function may not mutate an object it received
  through a publish point (the published snapshot contract is
  read-only).
- **G016 blocking call in the hot thread**: locks acquired, bare
  thread ``join()``s, socket waits (``recv``/``accept``/``select``)
  and unbounded stdlib-queue ``get``/``put`` inside the hot-path walk.
  Like G012/G013 (and unlike G002) the walk DESCENDS into declared
  fences: a fence declares a device sync, not a license to wedge the
  drain behind a lock.
- **G017 publish-point cross-check** (artifact-driven, G011's mirror):
  the runtime race sanitizer (lint/race_sanitizer.py) counts every
  declared publish-point entry and attributes every observed
  cross-thread access to the publish that made it legal, exported as
  the serve artifact's ``thread_crossings`` block.  A declared publish
  point the run never entered is DEAD; a runtime counter with no
  matching ``# graftlint: publish`` marker is an UNATTRIBUTED handoff
  the static model does not know about.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field, replace

from .core import (
    DEFAULT_HOT_ROOTS,
    Finding,
    FuncInfo,
    PackageIndex,
    dotted,
    walk_hot_scope,
)
from .race_sanitizer import MUTATOR_METHODS as _RUNTIME_MUTATORS

# ---------------------------------------------------------------------------
# ownership propagation
# ---------------------------------------------------------------------------


def thread_labels(index: PackageIndex) -> dict[int, set[str]]:
    """``id(FuncInfo) -> set of owning thread roots``.  Explicitly
    marked functions are PINNED to their declared root (propagation
    neither relabels them nor descends through them under a different
    label — the marker is a declared ownership boundary); hot-path
    roots (G002's set) count as ``thread=hot``.  Unmarked functions
    accumulate every root that reaches them.  Propagation follows only
    the CONFIDENT call edges (``resolve_call(strict=True)``: same-
    module / named-import functions, ``self.m()`` dispatch with
    subclass overrides) — the any-receiver bare-name fan-out the sync
    rules use for recall would fuse thread roots through every shared
    method name and label half the package bilaterally owned.

    Memoized on the index: G014 and G015 both need the full labeling
    (a per-root BFS over every function body) and run back-to-back in
    one gate pass over one immutable index."""
    cached = getattr(index, "_thread_labels", None)
    if cached is not None:
        return cached
    labels: dict[int, set[str]] = {}
    roots: list[tuple[FuncInfo, str]] = []
    for m in index.modules:
        for fi in m.functions.values():
            if fi.thread:
                roots.append((fi, fi.thread))
            elif fi.hot or fi.qualname in DEFAULT_HOT_ROOTS:
                roots.append((fi, "hot"))
    for root, label in roots:
        queue = [root]
        while queue:
            fi = queue.pop()
            got = labels.setdefault(id(fi), set())
            if label in got:
                continue
            got.add(label)
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in index.resolve_call(node, fi, strict=True):
                    if callee.thread and callee.thread != label:
                        continue  # pinned to another thread: boundary
                    if label not in labels.get(id(callee), ()):
                        queue.append(callee)
    index._thread_labels = labels
    return labels


# ---------------------------------------------------------------------------
# per-class attribute access model
# ---------------------------------------------------------------------------

#: Method names that mutate their receiver in place.  Derived from the
#: runtime proxy's canonical set (race_sanitizer.MUTATOR_METHODS) plus
#: the subscript dunders only the AST sees spelled out — the static
#: and runtime halves of the model judge mutation identically by
#: construction.
MUTATOR_METHODS = _RUNTIME_MUTATORS | frozenset(
    {"__setitem__", "__delitem__"}
)

#: Constructors whose result is a shared-mutable container.
_MUTABLE_CTORS = {
    "list", "dict", "set", "deque", "defaultdict", "bytearray",
    "OrderedDict",
}

#: Calls safely returning immutables (atomic to swap by reference).
_IMMUTABLE_CALLS = {
    "int", "float", "bool", "str", "bytes", "tuple", "frozenset",
    "len", "min", "max", "sum", "round", "id",
}
_IMMUTABLE_DOTTED = {
    "time.time", "time.monotonic", "time.perf_counter",
    "os.getpid", "threading.get_ident",
}


def _value_kind(e: ast.expr | None) -> str:
    """'immutable' | 'mutable' | 'unknown' for an assigned value.  A
    tuple literal of scalars/names counts as immutable: the reference
    swap is atomic and tuples cannot be mutated in place — the legal
    no-publish-point pattern for multi-field state (see
    ``StatusServer._health``)."""
    if e is None:
        return "unknown"
    if isinstance(e, ast.Constant):
        return "immutable"
    if isinstance(e, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                      ast.DictComp, ast.SetComp)):
        return "mutable"
    if isinstance(e, ast.Tuple):
        kinds = {_value_kind(el) for el in e.elts}
        if kinds <= {"immutable"} or all(
            isinstance(el, (ast.Constant, ast.Name)) for el in e.elts
        ):
            return "immutable"
        return "unknown"
    if isinstance(e, (ast.UnaryOp, ast.BinOp, ast.BoolOp, ast.Compare,
                      ast.IfExp)):
        return "unknown"  # usually scalar, but not provably
    if isinstance(e, ast.Call):
        f = e.func
        name = f.id if isinstance(f, ast.Name) else None
        if name in _MUTABLE_CTORS:
            return "mutable"
        if name in _IMMUTABLE_CALLS:
            return "immutable"
        if dotted(f) in _IMMUTABLE_DOTTED:
            return "immutable"
    return "unknown"


@dataclass
class _Access:
    fi: FuncInfo
    line: int
    col: int
    write: bool  # any store/mutation (False = plain read)
    inplace: bool  # subscript/aug/mutator-call (never an atomic swap)
    value_kind: str = "unknown"  # for plain assigns
    locked: bool = False  # textually inside a `with <...lock...>:`
    aug: bool = False  # ``self.x op= v`` on the attribute itself


@dataclass
class _AttrTable:
    accesses: dict[str, list[_Access]] = field(default_factory=dict)

    def note(self, attr: str, acc: _Access) -> None:
        self.accesses.setdefault(attr, []).append(acc)


#: Name tokens (``.``/``_``-separated segments of a dotted receiver)
#: that identify a mutual-exclusion primitive.  Token-exact on purpose:
#: a bare substring test would classify every ``block``/``block_span``
#: receiver — pervasive domain terms here — as a lock, flagging G016 on
#: non-locks and (worse) silently lock-exempting unguarded shared
#: writes from G014/G015.
_LOCK_TOKENS = frozenset({"lock", "rlock", "mutex", "semaphore"})


def _is_lockish(e: ast.expr) -> bool:
    d = dotted(e)
    if d is None:
        return False
    for tok in re.split(r"[._]", d.lower()):
        if tok in _LOCK_TOKENS or (
            tok.endswith("lock") and not tok.endswith("block")
        ):
            return True
    return False


class _AttrScanner(ast.NodeVisitor):
    """Collect every ``self.X`` access (and one-hop local aliases of
    ``self.X`` that are later mutated) in one method body."""

    def __init__(self, fi: FuncInfo, table: _AttrTable):
        self.fi = fi
        self.table = table
        self._lock_depth = 0
        self.aliases: dict[str, str] = {}  # local name -> attr

    # -- helpers --

    def _self_attr(self, e: ast.expr) -> str | None:
        if (isinstance(e, ast.Attribute)
                and isinstance(e.value, ast.Name)
                and e.value.id == "self"):
            return e.attr
        return None

    def _note(self, node: ast.AST, attr: str, *, write: bool,
              inplace: bool = False, value: ast.expr | None = None,
              aug: bool = False) -> None:
        self.table.note(attr, _Access(
            fi=self.fi, line=node.lineno, col=node.col_offset,
            write=write, inplace=inplace,
            value_kind=_value_kind(value) if write else "unknown",
            locked=self._lock_depth > 0, aug=aug,
        ))

    def _target_attr(self, t: ast.expr) -> tuple[str, bool] | None:
        """(attr, inplace) for a store target touching ``self.X`` (or a
        tracked alias), else None."""
        a = self._self_attr(t)
        if a is not None:
            return a, False
        if isinstance(t, ast.Subscript):
            base = t.value
            a = self._self_attr(base)
            if a is not None:
                return a, True
            if isinstance(base, ast.Name) and base.id in self.aliases:
                return self.aliases[base.id], True
        return None

    # -- visitors --

    def visit_With(self, node: ast.With) -> None:
        lockish = any(_is_lockish(it.context_expr) for it in node.items)
        if lockish:
            self._lock_depth += 1
        self.generic_visit(node)
        if lockish:
            self._lock_depth -= 1

    visit_AsyncWith = visit_With

    def _visit_store(self, node: ast.Assign, t: ast.expr,
                     value: ast.expr | None) -> None:
        # Tuple/list unpacking: `self._a, x = {}, y` stores into
        # self._a just as surely as the single-target form — pair each
        # element with its RHS element when the shapes line up, else
        # fall through with an unknown value.
        if isinstance(t, (ast.Tuple, ast.List)):
            elts = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(t.elts) else None)
            for i, sub in enumerate(t.elts):
                if isinstance(sub, ast.Starred):
                    self._visit_store(node, sub.value, None)
                else:
                    self._visit_store(node, sub,
                                      elts[i] if elts is not None else None)
            return
        hit = self._target_attr(t)
        if hit is not None:
            attr, inplace = hit
            self._note(node, attr, write=True, inplace=inplace, value=value)
        # alias tracking: y = self.X
        if isinstance(t, ast.Name):
            src = self._self_attr(value) if value is not None else None
            if src is not None:
                self.aliases[t.id] = src
            else:
                self.aliases.pop(t.id, None)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._visit_store(node, t, node.value)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        hit = self._target_attr(node.target)
        if hit is not None:
            self._note(node, hit[0], write=True, inplace=True,
                       aug=not hit[1])
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            hit = self._target_attr(node.target)
            if hit is not None:
                attr, inplace = hit
                self._note(node, attr, write=True, inplace=inplace,
                           value=node.value)
            self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATOR_METHODS:
            attr = self._self_attr(f.value)
            if attr is None and isinstance(f.value, ast.Name):
                attr = self.aliases.get(f.value.id)
            if attr is not None:
                self._note(node, attr, write=True, inplace=True)
                for a in node.args:
                    self.visit(a)
                for kw in node.keywords:
                    self.visit(kw.value)
                return
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._note(node, attr, write=False)
        self.generic_visit(node)


def _class_tables(index: PackageIndex
                  ) -> dict[tuple[str, str], dict[str, list[_Access]]]:
    """(module path | '<hierarchy>', class) -> attr -> accesses, across
    the index.  A subclass instance is ONE object at runtime — a base
    method and a subclass method touch the same ``self.X`` storage —
    so classes connected by LOCAL inheritance edges (the base has
    methods in the index; external bases merge nothing real) share one
    table, keyed by the component root.  Memoized on the index (G014 +
    G015 share one scan)."""
    cached = getattr(index, "_class_tables", None)
    if cached is not None:
        return cached
    parent: dict[str, str] = {}

    def find(c: str) -> str:
        parent.setdefault(c, c)
        while parent[c] != c:
            parent[c] = parent[parent[c]]
            c = parent[c]
        return c

    for cls, bases in index.bases.items():
        for b in bases:
            if b in index.methods:
                ra, rb = find(cls), find(b)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
    merged = {c for c in parent if find(c) != c} | {
        find(c) for c in parent if find(c) != c
    }
    out: dict[tuple[str, str], _AttrTable] = {}
    for m in index.modules:
        for fi in m.functions.values():
            if fi.cls is None:
                continue
            key = (("<hierarchy>", find(fi.cls)) if fi.cls in merged
                   else (m.path, fi.cls))
            table = out.setdefault(key, _AttrTable())
            _AttrScanner(fi, table).visit(fi.node)
    tables = {k: t.accesses for k, t in out.items()}
    index._class_tables = tables
    return tables


def _is_init(fi: FuncInfo) -> bool:
    return fi.qualname.endswith(".__init__") or fi.qualname.endswith(
        ".__post_init__"
    )


# ---------------------------------------------------------------------------
# G014 — shared-mutable escape
# ---------------------------------------------------------------------------


def g014_shared_escape(index: PackageIndex) -> list[Finding]:
    """A mutable class attribute reachable from two declared thread
    roots with no write ever passing through a declared publish point
    (or a lock-guarded section).  Immutable reference swaps and
    ``__init__``-time construction are exempt; attributes that DO cross
    a publish point are G015's jurisdiction (discipline, not escape)."""
    labels = thread_labels(index)
    out: list[Finding] = []
    for (path, cls), attrs in sorted(_class_tables(index).items()):
        for attr, accesses in sorted(attrs.items()):
            threads: set[str] = set()
            for a in accesses:
                threads |= labels.get(id(a.fi), set())
            if len(threads) < 2:
                continue
            writes = [a for a in accesses if a.write]
            if any(a.fi.publish for a in writes):
                continue  # published attr: G015 territory
            suspects = [
                a for a in writes
                if not _is_init(a.fi) and not a.locked
                and labels.get(id(a.fi))
                and (a.inplace or a.value_kind != "immutable")
            ]
            for a in suspects:
                out.append(Finding(
                    rule="G014", path=a.fi.module.path, line=a.line, col=a.col,
                    msg=(
                        f"`self.{attr}` is shared across threads "
                        f"{{{', '.join(sorted(threads))}}} but this "
                        "write is not a declared publish point — a "
                        "mutable object escaping its owning thread "
                        "without an atomic handoff races its readers; "
                        "swap it in via a `# graftlint: publish` "
                        "function (or guard both sides with one lock)"
                    ),
                ))
    return out


# ---------------------------------------------------------------------------
# G015 — publish-point discipline
# ---------------------------------------------------------------------------


def _scalar_augs(accesses: list[_Access]) -> list[_Access]:
    """``self.x += 1`` on an attribute every plain store gives an
    immutable value (``self.x = 0``) rebinds it to a fresh immutable
    object: a swap, not an in-place mutation (the port's one change to
    JAX's G015, which counts every augmented store as in place)."""
    stores = [a for a in accesses if a.write and not a.inplace]
    if not stores or any(a.value_kind != "immutable" for a in stores) or any(
            a.inplace and not a.aug for a in accesses if a.write):
        return accesses
    return [replace(a, inplace=False, value_kind="immutable") if a.aug
            else a for a in accesses]


def g015_publish_discipline(index: PackageIndex) -> list[Finding]:
    """The publish contract: (a) a publish function may only SWAP the
    shared attribute (one atomic reference store) — an in-place
    mutation (``self.x[k] = v``, ``self.x += ...``,
    ``self.x.append(...)``) outside a lock publishes a half-applied
    state; (b) a reader-thread function may not mutate an attribute it
    received through a publish point — published snapshots are
    read-only on the far side; (c) the OWNER may not mutate a
    published attribute in place outside the publish point either —
    readers may already hold the reference (the armed sanitizer's
    owner-mutation-after-publish raise, statically); (d) a non-writer
    thread may not REASSIGN a published attribute — even an atomic
    swap races the publisher's swap when it comes from the far side;
    (e) the owner may not reassign a published attribute to a fresh
    MUTABLE object outside the publish point — the swap itself is
    atomic, but the new object crosses threads with no publish
    generation, so the armed sanitizer cannot track it and G017's
    accounting misses the handoff (immutable swaps stay legal: atomic
    and frozen by construction)."""
    labels = thread_labels(index)
    out: list[Finding] = []
    for (path, cls), attrs in sorted(_class_tables(index).items()):
        attrs = {a: _scalar_augs(acc) for a, acc in attrs.items()}
        # published attrs of this class and their writer-side threads
        published: dict[str, set[str]] = {}
        for attr, accesses in attrs.items():
            for a in accesses:
                if a.write and a.fi.publish:
                    published.setdefault(attr, set()).update(
                        labels.get(id(a.fi), set())
                    )
        for attr, accesses in sorted(attrs.items()):
            for a in accesses:
                if not a.write or a.locked:
                    continue
                if not a.inplace:
                    # plain reference swap: the legal form inside a
                    # publish point (and during construction) — but a
                    # NON-writer thread clobbering the published
                    # reference races the publisher's swap
                    if a.fi.publish or _is_init(a.fi):
                        continue
                    writer_threads = published.get(attr)
                    if writer_threads is None:
                        continue
                    mine = labels.get(id(a.fi), set())
                    if mine and not (mine <= writer_threads):
                        out.append(Finding(
                            rule="G015", path=a.fi.module.path, line=a.line,
                            col=a.col,
                            msg=(
                                f"`self.{attr}` is published from "
                                "thread(s) "
                                f"{{{', '.join(sorted(writer_threads))}}}"
                                f" but reassigned here on thread(s) "
                                f"{{{', '.join(sorted(mine))}}} outside "
                                "any publish point — the swap races the "
                                "publisher; route it through a declared "
                                "publish point on the owning thread"
                            ),
                        ))
                    elif mine and a.value_kind != "immutable":
                        # owner-side swap of a fresh mutable object
                        # OUTSIDE the publish point: the store is
                        # atomic, but the new object never gets a
                        # publish generation — the armed sanitizer
                        # cannot track it and the reader thread races
                        # whatever the owner does to it next
                        out.append(Finding(
                            rule="G015", path=a.fi.module.path, line=a.line,
                            col=a.col,
                            msg=(
                                f"`self.{attr}` is a published "
                                "attribute but is reassigned to a "
                                "non-immutable object here outside any "
                                "publish point — the replacement "
                                "crosses threads with no publish "
                                "generation (the race sanitizer cannot "
                                "track it); route every mutable swap "
                                "through the declared publish point"
                            ),
                        ))
                    continue
                if a.fi.publish:
                    out.append(Finding(
                        rule="G015", path=a.fi.module.path,
                        line=a.line, col=a.col,
                        msg=(
                            f"in-place mutation of `self.{attr}` inside "
                            f"publish point `{a.fi.qualname}` — a "
                            "publish must be ONE atomic reference swap "
                            "(build the new object first, then "
                            f"`self.{attr} = fresh`) or lock-guarded; "
                            "readers on the other thread can observe "
                            "this half-applied"
                        ),
                    ))
                    continue
                writer_threads = published.get(attr)
                if writer_threads is None or _is_init(a.fi):
                    continue
                mine = labels.get(id(a.fi), set())
                if mine and not (mine <= writer_threads):
                    out.append(Finding(
                        rule="G015", path=a.fi.module.path,
                        line=a.line, col=a.col,
                        msg=(
                            f"`self.{attr}` is published from thread(s) "
                            f"{{{', '.join(sorted(writer_threads))}}} "
                            f"but mutated here on thread(s) "
                            f"{{{', '.join(sorted(mine))}}} — what a "
                            "reader receives through a publish point "
                            "is read-only; copy before mutating"
                        ),
                    ))
                else:
                    # owner-side: once published, readers may already
                    # hold the reference — mutating it anywhere outside
                    # the publish point tears the snapshot under them
                    # (the armed sanitizer raises for exactly this)
                    out.append(Finding(
                        rule="G015", path=a.fi.module.path,
                        line=a.line, col=a.col,
                        msg=(
                            f"in-place mutation of published "
                            f"`self.{attr}` outside its publish point "
                            f"(`{a.fi.qualname}` is not one) — readers "
                            "on the other thread may already hold this "
                            "reference; build a fresh object and swap "
                            "it in through the publish point"
                        ),
                    ))
    return out


# ---------------------------------------------------------------------------
# G016 — blocking calls in the hot thread
# ---------------------------------------------------------------------------

#: ``queue`` module constructors whose instances block on get/put.
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}


def _queue_names(m) -> set[str]:
    """Dotted receiver names bound to stdlib ``queue`` constructions in
    this module (``self.inbox = queue.Queue()`` / ``q = Queue()``)."""
    if not any(src == "queue" or src.startswith("queue.")
               for src in m.imports.values()):
        return set()
    out: set[str] = set()
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]  # self.inbox: queue.Queue = Queue()
        else:
            continue
        v = node.value
        if not isinstance(v, ast.Call):
            continue
        d = dotted(v.func) or ""
        tail = d.split(".")[-1]
        if tail not in _QUEUE_CTORS:
            continue
        root = d.split(".")[0]
        src = m.imports.get(root, "")
        if not (src == "queue" or src.startswith("queue.")):
            continue
        for t in targets:
            td = dotted(t)
            if td:
                out.add(td)
    return out


def _call_arg(node: ast.Call, pos: int, kw: str) -> ast.expr | None:
    """Argument ``kw`` of ``node`` whether passed by keyword or at
    positional index ``pos`` (None when absent or behind ``*args``)."""
    for k in node.keywords:
        if k.arg == kw:
            return k.value
    if len(node.args) > pos and not any(
        isinstance(a, ast.Starred) for a in node.args[: pos + 1]
    ):
        return node.args[pos]
    return None


def _is_false(e: ast.expr | None) -> bool:
    return isinstance(e, ast.Constant) and e.value is False


def _blocking_findings(fi: FuncInfo, chain: str, queues: set[str]
                       ) -> list[Finding]:
    m = fi.module
    out = []

    def hit(node, what, why):
        out.append(Finding(
            rule="G016", path=m.path, line=node.lineno,
            col=node.col_offset,
            msg=(
                f"blocking `{what}` on the serving hot thread "
                f"({chain}) — {why}; hand the wait to its owning "
                "thread and cross back over a publish point"
            ),
        ))

    for node in ast.walk(fi.node):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if _is_lockish(item.context_expr):
                    hit(item.context_expr,
                        f"with {dotted(item.context_expr)}:",
                        "a lock acquisition stalls the drain behind "
                        "whatever thread holds it")
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        if f.attr == "acquire":
            # acquire(blocking=False) polls; acquire(timeout=t) bounds
            # the stall — only the bare unbounded form wedges the drain
            if not _is_false(_call_arg(node, 0, "blocking")) and (
                _call_arg(node, 1, "timeout") is None
            ):
                hit(node, f"{dotted(f) or f.attr}()",
                    "a lock acquisition stalls the drain behind "
                    "whatever thread holds it")
        elif (f.attr == "join" and not node.args
                and _call_arg(node, 0, "timeout") is None):
            # str.join / os.path.join always take a positional
            # argument; a no-positional-arg join is a thread join —
            # and join(timeout=t) bounds the park, like wait/acquire
            hit(node, f"{dotted(f) or f.attr}()",
                "joining a thread parks the drain for the thread's "
                "whole remaining lifetime")
        elif f.attr == "wait" and _call_arg(node, 0, "timeout") is None:
            hit(node, f"{dotted(f) or f.attr}()",
                "an unbounded event/condition wait wedges the drain "
                "until another thread signals")
        elif f.attr in ("recv", "accept"):
            hit(node, f".{f.attr}()",
                "a socket wait belongs to the status/bus threads, "
                "never the drain")
        elif dotted(f) == "select.select":
            hit(node, "select.select()",
                "a readiness wait belongs to the I/O-owning thread")
        elif f.attr in ("get", "put"):
            recv = dotted(f.value)
            # get/put take (block, timeout) positionally for get and
            # (item, block, timeout) for put — non-blocking or bounded
            # either way stays legal
            pos0 = 1 if f.attr == "put" else 0
            if (recv in queues
                    and not _is_false(_call_arg(node, pos0, "block"))
                    and _call_arg(node, pos0 + 1, "timeout") is None):
                hit(node, f"{recv}.{f.attr}()",
                    "an unbounded stdlib-queue op blocks until the "
                    "other end moves; use put_nowait/get_nowait or a "
                    "timeout and surface the backpressure")
    return out


def g016_blocking_hot_thread(index: PackageIndex) -> list[Finding]:
    """Blocking host primitives reachable from the serving hot path —
    the same walker as G002/G013, DESCENDING into declared fences (a
    fence declares a device sync; wedging the drain behind a lock,
    thread join, socket wait or unbounded queue op is a stall hazard
    anywhere inside the round)."""
    out: list[Finding] = []
    qcache: dict[int, set[str]] = {}
    for fi, chain in walk_hot_scope(index, descend_fences=True):
        m = fi.module
        queues = qcache.get(id(m))
        if queues is None:
            queues = qcache[id(m)] = _queue_names(m)
        out.extend(_blocking_findings(fi, chain, queues))
    return out


# ---------------------------------------------------------------------------
# G017 — publish-point cross-check (static markers vs runtime counters)
# ---------------------------------------------------------------------------


def load_artifact_block(path: str, key: str
                        ) -> tuple[dict | None, str | None]:
    """Block ``key`` from a serve bench artifact (a ``save_results``
    list of BenchResult dicts) or from a raw JSON fixture dict.
    Returns (block, error)."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError) as e:
        return None, f"unreadable artifact: {e}"
    if isinstance(data, dict):
        block = data.get(key)
        return (block, None) if isinstance(block, dict) else (
            None, f"artifact has no {key} block"
        )
    if isinstance(data, list):
        for entry in data:
            extra = entry.get("extra") if isinstance(entry, dict) else None
            if isinstance(extra, dict) and isinstance(
                extra.get(key), dict
            ):
                return extra[key], None
        return None, f"artifact has no {key} block"
    return None, "artifact is neither a result list nor a dict"


def g017_thread_crossings(index: PackageIndex, artifact_path: str
                          ) -> list[Finding]:
    """Cross-validate the declared publish points against a serve run's
    ``thread_crossings`` counters (the race sanitizer's ground truth):
    a declared publish point the run never entered is DEAD — the
    annotation is stale or the handoff moved; a runtime publish or
    crossing counter with no matching ``# graftlint: publish`` marker
    is an UNATTRIBUTED cross-thread handoff the static confinement
    model does not know about.  ``publish=<tag>`` points are only
    dead-checked against artifacts whose run armed that surface (the
    block carries one boolean per surface, e.g. ``status``); a tag the
    artifact records NO surface for is itself a finding — an
    unmatchable tag would exempt its point from the accounting
    forever."""
    block, err = load_artifact_block(artifact_path, "thread_crossings")
    if block is None:
        return [Finding(
            rule="G017", path=artifact_path, line=0, col=0, msg=err,
        )]
    publishes = block.get("publishes") or {}
    crossings = block.get("crossings") or {}
    declared = {
        fi.qualname: fi
        for m in index.modules for fi in m.functions.values()
        if fi.publish
    }
    out = []
    for qual, fi in sorted(declared.items()):
        tag = fi.publish_tag
        if tag and tag not in block:
            # a tag naming no surface the artifact records would
            # otherwise exempt this point from dead-point accounting
            # FOREVER (a typo'd tag never matches an armed surface)
            out.append(Finding(
                rule="G017", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"publish point `{qual}` is tagged "
                    f"`publish={tag}` but "
                    f"{os.path.basename(artifact_path)} records no "
                    f"`{tag}` surface — typo'd or stale tag; an "
                    "unmatchable tag silently disables the dead-point "
                    "check for this point"
                ),
            ))
            continue
        if tag and not block.get(tag):
            continue  # surface not armed in this run
        if not publishes.get(qual):
            out.append(Finding(
                rule="G017", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"declared publish point `{qual}` never entered in "
                    f"{os.path.basename(artifact_path)} — dead publish "
                    "point: delete the stale annotation or re-declare "
                    "the real handoff (tag it publish=<surface> if it "
                    "only crosses when that surface is armed)"
                ),
            ))
    for qual in sorted(set(publishes) | set(crossings)):
        if qual not in declared:
            out.append(Finding(
                rule="G017", path=artifact_path, line=0, col=0,
                msg=(
                    f"runtime publish/crossing counter `{qual}` has no "
                    "matching `# graftlint: publish` marker — an "
                    "unattributed cross-thread handoff the static "
                    "confinement model does not know about"
                ),
            ))
    return out
