"""Crash-consistency analysis: rules G018-G021.

Every durability bug the serve stack shipped and then fixed was a
filesystem-*ordering* bug found by hand or by the oracle, never by
tooling: the spool unlink-before-install crash window, the torn GC pass
between manifest write and unlinks, the bit-flipped-but-parseable
manifest that escaped the CRC catch.  The static model here is the
G002/G011/G014 architecture applied to filesystem effects:

- **protocols are declared**, not inferred: ``# graftlint:
  durable=<protocol>`` on a def line pins the function into one of the
  durability stack's multi-step commit protocols (``snapshot`` / ``gc``
  / ``wal`` / ``spool`` / ``flight``).  The analyzer builds a
  per-function **effect sequence** — write/read/fsync/replace/link/
  unlink/rmtree/truncate over *path-role symbols* — walking the body in
  statement order and inlining the CONFIDENT call edges
  (``resolve_call(strict=True)``), descending into undeclared helpers
  and same-protocol members but stopping at functions declared under a
  DIFFERENT protocol (a declared boundary, exactly like pinned thread
  roots).
- **path roles** are ``staging`` vs ``durable``: a name bound from an
  expression carrying a ``.tmp`` literal (or ``tempfile.mkstemp``), or
  tested with ``endswith(".tmp")``, is staging — free to write, free to
  destroy; everything else a protocol touches is a durable role.
- **G018 atomic-commit discipline**: a durable artifact reaches its
  final name only via tmp + ``os.replace``/``os.rename`` — an in-place
  write-mode ``open`` of a durable role is a finding (append mode is
  exempt: the WAL's contract is append-only + CRC framing, and an
  append never destroys committed bytes).  A commit (replace/rename to
  a durable target) with NO fsync effect anywhere earlier in the
  protocol sequence is also a finding: rename durability does not
  imply content durability — the committed name can point at
  never-flushed pages after a power cut.
- **G019 durable-ordering**: destruction of a durable copy (unlink,
  rmtree, truncation) must be dominated by the committed install of
  its replacement (an earlier replace/rename to a durable target) or
  by a read of the committed record (the torn-pass-completion form,
  e.g. ``finish_torn_gc`` re-reading the GC manifest).  This is the
  exact spool-unlink-before-install and torn-GC incident class, as a
  rule.
- **G020 verify-before-trust**: reads of durable artifacts must flow
  through CRC verification (``np.load`` in a function that never
  computes ``zlib.crc32`` is a trusted read), and a fallback handler
  in a protocol function whose try-body indexes into parsed manifest
  data must catch the parseable-garbage set (KeyError / IndexError /
  TypeError) — a bit-flipped manifest can stay PARSEABLE json with
  garbled values, and a designed-recoverable corruption must degrade
  to the next candidate, never crash the recovery itself (the
  ``_read_manifest`` incident).
- **G021 fs-protocol cross-check** (artifact-driven, G011/G017's
  mirror): the runtime fs sanitizer (lint/fs_sanitizer.py) counts
  every declared protocol entry and attributes every observed fs op to
  the protocol that ran it, exported as the serve artifact's
  ``fs_ops`` block.  A declared protocol the run never entered is DEAD
  (scoped by armed surface: ``snapshot``/``gc``/``wal`` ride the
  journal, ``spool`` rides pool spool traffic, ``flight`` a dump); a
  runtime protocol tag or mutating op with no matching ``durable=``
  marker is UNATTRIBUTED — fs activity the static model does not know
  about.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass

from .core import Finding, FuncInfo, PackageIndex, dotted
from .threads import load_artifact_block

#: The declared-protocol vocabulary (shared with the runtime twin).
KNOWN_PROTOCOLS = ("snapshot", "gc", "wal", "spool", "flight",
                   "reshard")

#: Armed-surface scoping for the G021 dead-protocol accounting: a tag
#: is only dead-checked against artifacts whose run armed its surface
#: (``journal`` = the WAL + barriers ran; ``spool`` = the pool actually
#: spooled; ``flight`` = a dump fired this drain; ``reshard`` = a live
#: shard-map change committed its migration manifest).
PROTOCOL_SURFACES = {
    "snapshot": "journal",
    "gc": "journal",
    "wal": "journal",
    "spool": "spool",
    "flight": "flight",
    "reshard": "reshard",
}

_COMMIT_OPS = ("replace", "rename")
_DESTRUCTIVE_OPS = ("unlink", "rmtree", "truncate")

#: The parseable-garbage error set a recovery fallback must cover: a
#: bit-flipped manifest that still parses surfaces as one of these
#: deep in the restore, not as a corruption error.
_GARBAGE_ERRORS = frozenset({"KeyError", "IndexError", "TypeError"})


@dataclass
class Effect:
    op: str  # write|append|read|fsync|replace|rename|link|unlink|rmtree|truncate|copy|npload
    role: str  # role of the affected/destination path: staging|durable
    fi: FuncInfo  # function whose body contains the op (for location)
    line: int
    col: int
    reportable: bool = True  # False for effects inlined from a
    # DECLARED callee (it gets its own standalone analysis — findings
    # there would duplicate)


# ---------------------------------------------------------------------------
# path-role inference
# ---------------------------------------------------------------------------


def _walk_skip_defs(node: ast.AST):
    """ast.walk that does not descend into nested function bodies (a
    nested def's effects happen at its CALL sites, not its def site)."""
    queue = [node]
    while queue:
        n = queue.pop(0)
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child,
                          (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda)):
                continue
            queue.append(child)


def _has_tmp_literal(e: ast.AST) -> bool:
    for n in ast.walk(e):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and ".tmp" in n.value:
            return True
    return False


def _staging_names(fnode: ast.AST, seed: set[str] | None = None
                   ) -> set[str]:
    """Names bound to staging paths inside one function body: assigned
    from an expression carrying a ``.tmp`` literal or a
    ``tempfile.mkstemp`` call (both unpacked names — the fd rides the
    same temp file), tested with ``endswith(".tmp")`` anywhere, or
    derived from another staging name (run to a fixpoint — staging-ness
    propagates through ``os.path.join(tmp, fname)``)."""
    staging: set[str] = set(seed or ())
    assigns: list[tuple[list[str], ast.expr]] = []
    for n in _walk_skip_defs(fnode):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                names = [e.id for e in ast.walk(t)
                         if isinstance(e, ast.Name)]
                if names:
                    assigns.append((names, n.value))
        elif isinstance(n, ast.AnnAssign) and n.value is not None \
                and isinstance(n.target, ast.Name):
            assigns.append(([n.target.id], n.value))
        elif isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr == "endswith" \
                    and isinstance(f.value, ast.Name) and n.args \
                    and _has_tmp_literal(n.args[0]):
                staging.add(f.value.id)
    for names, value in assigns:
        d = dotted(getattr(value, "func", value)) or ""
        if _has_tmp_literal(value) or d.split(".")[-1] == "mkstemp":
            staging.update(names)
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if any(n in staging for n in names):
                continue
            if any(isinstance(e, ast.Name) and e.id in staging
                   for e in ast.walk(value)):
                staging.update(names)
                changed = True
    return staging


def _role(e: ast.expr | None, staging: set[str]) -> str:
    """'staging' | 'durable' for a path expression.  Durable is the
    default: inside a declared protocol, any path not provably staged
    is somebody's committed artifact."""
    if e is None:
        return "durable"
    if _has_tmp_literal(e):
        return "staging"
    for n in ast.walk(e):
        if isinstance(n, ast.Name) and n.id in staging:
            return "staging"
    return "durable"


# ---------------------------------------------------------------------------
# effect-sequence extraction (with confident-call inlining)
# ---------------------------------------------------------------------------

_MAX_INLINE_DEPTH = 8


def _function_effects(index: PackageIndex, fi: FuncInfo, proto: str | None,
                      *, seen: set[int] | None = None, depth: int = 0,
                      staging_seed: set[str] | None = None,
                      reportable: bool = True) -> list[Effect]:
    """The protocol effect sequence of ``fi``: its own fs ops in
    statement order, with confident callees inlined at their call
    sites — undeclared helpers and same-protocol members descend,
    functions declared under a different protocol are boundaries."""
    seen = set() if seen is None else seen
    seen.add(id(fi))
    staging = _staging_names(fi.node, staging_seed)
    nested: dict[str, ast.AST] = {}
    handles: dict[str, str] = {}  # file-handle var -> path role
    out: list[Effect] = []

    def note(op: str, role: str, node: ast.AST) -> None:
        out.append(Effect(op=op, role=role, fi=fi, line=node.lineno,
                          col=node.col_offset, reportable=reportable))

    def handle_open(call: ast.Call, target: str | None) -> None:
        mode = "r"
        if len(call.args) > 1 and isinstance(call.args[1], ast.Constant):
            mode = str(call.args[1].value)
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = str(kw.value.value)
        path = call.args[0] if call.args else None
        role = _role(path, staging)
        if any(c in mode for c in "wx"):
            note("write", role, call)
        elif "a" in mode:
            note("append", role, call)
        elif "+" in mode:
            note("update", role, call)  # r+: in-place edit, not a
            # G019 read-witness (the torn-tail truncate repair shape)
        else:
            note("read", role, call)
        if target is not None:
            handles[target] = role

    def visit_call(call: ast.Call) -> None:
        f = call.func
        d = dotted(f) or ""
        tail = d.split(".")[-1]
        args = call.args
        if d in ("open", "io.open"):
            handle_open(call, None)
            return
        if tail == "fdopen":
            mode = "r"
            if len(args) > 1 and isinstance(args[1], ast.Constant):
                mode = str(args[1].value)
            role = _role(args[0] if args else None, staging)
            if any(c in mode for c in "wxa"):
                note("write", role, call)
            return
        if d == "os.replace" or d == "os.rename":
            op = "replace" if d.endswith("replace") else "rename"
            note(op, _role(args[1] if len(args) > 1 else None, staging),
                 call)
            return
        if d == "os.link":
            note("link",
                 _role(args[1] if len(args) > 1 else None, staging), call)
            return
        if d in ("os.unlink", "os.remove"):
            note("unlink", _role(args[0] if args else None, staging),
                 call)
            return
        if d in ("os.fsync", "os.fdatasync"):
            note("fsync", "durable", call)
            return
        if d == "shutil.rmtree":
            note("rmtree", _role(args[0] if args else None, staging),
                 call)
            return
        if tail in ("copy2", "copy", "copyfile") and d.startswith(
                "shutil."):
            note("copy",
                 _role(args[1] if len(args) > 1 else None, staging), call)
            return
        if d in ("os.truncate", "os.ftruncate"):
            note("truncate", _role(args[0] if args else None, staging),
                 call)
            return
        if isinstance(f, ast.Attribute) and f.attr == "truncate" \
                and isinstance(f.value, ast.Name):
            note("truncate", handles.get(f.value.id, "durable"), call)
            return
        if fi.module.is_np_attr(f) == "load":
            note("npload", _role(args[0] if args else None, staging),
                 call)
            return
        # nested defs inline at their call sites, under the caller's
        # staging environment (a closure sees the enclosing temps)
        if isinstance(f, ast.Name) and f.id in nested:
            sub = nested[f.id]
            sub_staging = _staging_names(sub, staging)
            saved = dict(handles)
            for n in _walk_skip_defs(sub):
                if isinstance(n, ast.Call):
                    _dispatch(n, sub_staging)
            handles.update(saved)
            return
        for callee in index.resolve_call(call, fi, strict=True):
            if id(callee) in seen or depth >= _MAX_INLINE_DEPTH:
                continue
            if callee.protocol is not None and callee.protocol != proto:
                continue  # a different declared protocol: boundary
            out.extend(_function_effects(
                index, callee, proto, seen=seen, depth=depth + 1,
                reportable=reportable and not callee.durable,
            ))

    def _dispatch(call: ast.Call, env: set[str]) -> None:
        nonlocal staging
        saved = staging
        staging = env
        try:
            visit_call(call)
        finally:
            staging = saved

    def scan_stmt(stmt: ast.AST) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested[stmt.name] = stmt
            return
        # file-handle role bindings (for `f.truncate(...)`)
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call):
            d = dotted(stmt.value.func) or ""
            if d in ("open", "io.open") and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                handle_open(stmt.value, stmt.targets[0].id)
                return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if isinstance(item.context_expr, ast.Call):
                    d = dotted(item.context_expr.func) or ""
                    if d in ("open", "io.open"):
                        tgt = (item.optional_vars.id
                               if isinstance(item.optional_vars, ast.Name)
                               else None)
                        handle_open(item.context_expr, tgt)
                    else:
                        visit_call(item.context_expr)
            for sub in stmt.body:
                scan_stmt(sub)
            return
        if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While)):
            guard = getattr(stmt, "test", None) or getattr(
                stmt, "iter", None)
            if guard is not None:
                for n in _walk_skip_defs(guard):
                    if isinstance(n, ast.Call):
                        visit_call(n)
            for sub in stmt.body + getattr(stmt, "orelse", []):
                scan_stmt(sub)
            return
        if isinstance(stmt, ast.Try):
            for sub in stmt.body:
                scan_stmt(sub)
            for h in stmt.handlers:
                for sub in h.body:
                    scan_stmt(sub)
            for sub in stmt.orelse + stmt.finalbody:
                scan_stmt(sub)
            return
        for n in _walk_skip_defs(stmt):
            if isinstance(n, ast.Call):
                visit_call(n)

    for stmt in fi.node.body:
        scan_stmt(stmt)
    return out


def _declared(index: PackageIndex) -> list[FuncInfo]:
    return [
        fi for m in index.modules for fi in m.functions.values()
        if fi.durable
    ]


# ---------------------------------------------------------------------------
# G018 — atomic-commit discipline
# ---------------------------------------------------------------------------


def g018_atomic_commit(index: PackageIndex) -> list[Finding]:
    """Durable artifacts reach their final name only via tmp +
    ``os.replace`` inside a declared protocol — and a commit is only a
    commit when the staged bytes were fsynced first (see module
    docstring)."""
    out: list[Finding] = []
    for fi in sorted(_declared(index),
                     key=lambda f: (f.module.path, f.node.lineno)):
        if fi.protocol is not None and fi.protocol not in KNOWN_PROTOCOLS:
            out.append(Finding(
                rule="G018", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"`{fi.qualname}` declares unknown durable protocol "
                    f"`{fi.protocol}` (known: "
                    f"{', '.join(KNOWN_PROTOCOLS)}) — a typo'd tag "
                    "silently exempts the function from the fs-protocol "
                    "accounting forever"
                ),
            ))
            continue
        effects = _function_effects(index, fi, fi.protocol)
        fsync_seen = False
        for e in effects:
            if e.op == "fsync":
                fsync_seen = True
            elif e.op == "write" and e.role == "durable" and e.reportable:
                out.append(Finding(
                    rule="G018", path=e.fi.module.path, line=e.line,
                    col=e.col,
                    msg=(
                        "in-place write-mode open of a durable path "
                        f"role in protocol `{fi.protocol}` — a crash "
                        "mid-write leaves a torn artifact under its "
                        "committed name; write to a `.tmp` sibling and "
                        "commit it with os.replace"
                    ),
                ))
            elif e.op in _COMMIT_OPS and e.role == "durable" \
                    and not fsync_seen and e.reportable:
                out.append(Finding(
                    rule="G018", path=e.fi.module.path, line=e.line,
                    col=e.col,
                    msg=(
                        f"committed {e.op} in protocol `{fi.protocol}` "
                        "with no fsync anywhere earlier in the effect "
                        "sequence — rename durability does not imply "
                        "content durability; fsync the staged file "
                        "(and the parent directory) before the commit"
                    ),
                ))
    return out


# ---------------------------------------------------------------------------
# G019 — durable ordering
# ---------------------------------------------------------------------------


def g019_durable_ordering(index: PackageIndex) -> list[Finding]:
    """Destruction of a durable copy must be dominated by the committed
    install of its replacement — or by a read of the committed record
    (completing a torn pass).  Unlink-before-install is the spool
    crash window; rmtree-before-commit is the torn-GC class."""
    out: list[Finding] = []
    for fi in sorted(_declared(index),
                     key=lambda f: (f.module.path, f.node.lineno)):
        if fi.protocol is not None and fi.protocol not in KNOWN_PROTOCOLS:
            continue  # G018 already flagged the typo
        effects = _function_effects(index, fi, fi.protocol)
        dominated = False
        for e in effects:
            if (e.op in _COMMIT_OPS and e.role == "durable") \
                    or e.op in ("read", "npload"):
                dominated = True
            elif e.op in _DESTRUCTIVE_OPS and e.role == "durable" \
                    and not dominated and e.reportable:
                out.append(Finding(
                    rule="G019", path=e.fi.module.path, line=e.line,
                    col=e.col,
                    msg=(
                        f"{e.op} of a durable path role in protocol "
                        f"`{fi.protocol}` before any committed install "
                        "(os.replace/os.rename to a durable target) or "
                        "read of the committed record — a crash at "
                        "this boundary destroys the only copy; install "
                        "the replacement first, destroy second"
                    ),
                ))
    return out


# ---------------------------------------------------------------------------
# G020 — verify-before-trust
# ---------------------------------------------------------------------------


def _resolve_catch(handler_type: ast.expr | None, module
                   ) -> set[str] | None:
    """The exception-name set an ``except`` clause catches, resolving
    a bare Name through module-level tuple assignments (the
    ``_RECOVER_ERRORS`` idiom).  None = unresolvable or bare except
    (trust it — a bare except already covers the garbage set)."""
    if handler_type is None:
        return None
    if isinstance(handler_type, ast.Tuple):
        names: set[str] = set()
        for el in handler_type.elts:
            got = _resolve_catch(el, module)
            if got is None:
                return None
            names |= got
        return names
    if isinstance(handler_type, ast.Attribute):
        return {handler_type.attr}
    if isinstance(handler_type, ast.Name):
        name = handler_type.id
        for node in ast.iter_child_nodes(module.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == name \
                    and isinstance(node.value, ast.Tuple):
                return _resolve_catch(node.value, module)
        return {name}
    return None


def g020_verify_before_trust(index: PackageIndex) -> list[Finding]:
    """(a) a ``np.load`` of a durable artifact in a function that never
    computes ``zlib.crc32`` is a TRUSTED read — damage flows into field
    access far from the load site; route it through the verifying
    reader.  (b) a fallback handler (no re-raise) in a declared
    protocol function whose try-body indexes into parsed data must
    catch the parseable-garbage set {KeyError, IndexError, TypeError}:
    a bit-flipped manifest can stay parseable json with garbled values,
    and designed-recoverable corruption must degrade to the next
    candidate, never crash the recovery (the ``_read_manifest``
    incident class)."""
    out: list[Finding] = []
    crc_cache: dict[int, bool] = {}

    def has_crc(fi: FuncInfo) -> bool:
        if id(fi) not in crc_cache:
            crc_cache[id(fi)] = any(
                isinstance(n, ast.Call)
                and (dotted(n.func) or "").endswith("crc32")
                for n in _walk_skip_defs(fi.node)
            )
        return crc_cache[id(fi)]

    for fi in sorted(_declared(index),
                     key=lambda f: (f.module.path, f.node.lineno)):
        if fi.protocol is not None and fi.protocol not in KNOWN_PROTOCOLS:
            continue
        for e in _function_effects(index, fi, fi.protocol):
            if e.op == "npload" and e.reportable and not has_crc(e.fi):
                out.append(Finding(
                    rule="G020", path=e.fi.module.path, line=e.line,
                    col=e.col,
                    msg=(
                        "trusted np.load of a durable artifact in "
                        f"protocol `{fi.protocol}` — no CRC "
                        "verification in this function; bit flips "
                        "surface as field-access crashes far from the "
                        "load site, route the read through the "
                        "verifying loader (utils/checkpoint.load_state)"
                    ),
                ))
        for node in _walk_skip_defs(fi.node):
            if not isinstance(node, ast.Try):
                continue
            body_subscripts = any(
                isinstance(n, ast.Subscript)
                for stmt in node.body for n in ast.walk(stmt)
            )
            if not body_subscripts:
                continue
            for handler in node.handlers:
                caught = _resolve_catch(handler.type, fi.module)
                if caught is None:
                    continue
                if {"Exception", "BaseException"} & caught:
                    continue
                if any(isinstance(n, ast.Raise)
                       for stmt in handler.body
                       for n in ast.walk(stmt)):
                    continue  # re-raise: not a fallback
                missing = _GARBAGE_ERRORS - caught
                if missing:
                    out.append(Finding(
                        rule="G020", path=fi.module.path,
                        line=handler.lineno, col=handler.col_offset,
                        msg=(
                            "recovery fallback in protocol "
                            f"`{fi.protocol}` catches "
                            f"{{{', '.join(sorted(caught))}}} but the "
                            "try-body indexes into parsed data — a "
                            "bit-flipped manifest stays PARSEABLE with "
                            "garbled values and escapes as "
                            f"{{{', '.join(sorted(missing))}}}; widen "
                            "the catch to the parseable-garbage set so "
                            "damage degrades to the next candidate "
                            "instead of crashing the recovery"
                        ),
                    ))
    return out


# ---------------------------------------------------------------------------
# G021 — fs-protocol cross-check (static markers vs runtime fs_ops)
# ---------------------------------------------------------------------------


def g021_fs_protocols(index: PackageIndex, artifact_path: str
                      ) -> list[Finding]:
    """Cross-validate the declared ``durable=`` protocols against a
    serve run's ``fs_ops`` counters (the fs sanitizer's ground truth):
    a declared protocol the run never entered is DEAD — the annotation
    is stale or the commit path moved; a runtime protocol tag (or an
    unattributed mutating op) with no matching static declaration is
    fs activity the crash-consistency model does not know about.
    Dead-checking is scoped by armed surface exactly like G011 fence
    tags: ``snapshot``/``gc``/``wal`` are only expected in journaled
    runs, ``spool`` when the pool actually spooled, ``flight`` when a
    dump fired."""
    block, err = load_artifact_block(artifact_path, "fs_ops")
    if block is None:
        return [Finding(
            rule="G021", path=artifact_path, line=0, col=0, msg=err,
        )]
    entries = block.get("protocols") or {}
    ops = block.get("ops") or {}
    unattributed = block.get("unattributed") or {}
    declared: dict[str, FuncInfo] = {}
    for fi in sorted(_declared(index),
                     key=lambda f: (f.module.path, f.node.lineno)):
        if fi.protocol in KNOWN_PROTOCOLS:
            declared.setdefault(fi.protocol, fi)
    out: list[Finding] = []
    for tag, fi in sorted(declared.items()):
        surface = PROTOCOL_SURFACES[tag]
        if surface not in block:
            out.append(Finding(
                rule="G021", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"durable protocol `{tag}` is scoped to surface "
                    f"`{surface}` but "
                    f"{os.path.basename(artifact_path)} records no "
                    "such surface — stale fs_ops schema or typo'd "
                    "surface map; an unmatchable surface silently "
                    "disables the dead-protocol check"
                ),
            ))
            continue
        if not block.get(surface):
            continue  # surface not armed in this run
        if not entries.get(tag):
            out.append(Finding(
                rule="G021", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"declared durable protocol `{tag}` never entered "
                    f"in {os.path.basename(artifact_path)} (surface "
                    f"`{surface}` armed) — dead protocol: delete the "
                    "stale annotation or route the real commit path "
                    "through its fs_protocol context"
                ),
            ))
    for tag in sorted(set(entries) | set(ops)):
        if tag not in declared:
            out.append(Finding(
                rule="G021", path=artifact_path, line=0, col=0,
                msg=(
                    f"runtime fs protocol `{tag}` has no matching "
                    "`# graftlint: durable=` marker — fs activity the "
                    "static crash-consistency model does not know about"
                ),
            ))
    for op, n in sorted(unattributed.items()):
        out.append(Finding(
            rule="G021", path=artifact_path, line=0, col=0,
            msg=(
                f"{n} unattributed runtime `{op}` op(s) on watched "
                "durable roots outside every declared protocol — "
                "either declare the owning protocol or move the op "
                "out of durable territory"
            ),
        ))
    return out
