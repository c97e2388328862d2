"""G009's twin: the port's launch boundary.

JAX's G009 checks each ``pl.pallas_call`` against its grid and block
specs.  The port's kernels are ``extern "C"`` entries in ``csrc/*.cu``,
loaded with ``ctypes`` by ``_build.py``, whose ``SIGNATURES`` table gives
each entry its argument types.  Nothing checks that the two agree: a
pointer declared where the C entry takes an ``int`` (or one argument too
few) passes a truncated or shifted value, and the kernel reads garbage
without an error.  And a launch returns ``cudaGetLastError()``, which is
lost unless the wrapper hands it to ``check(err, name)``.  So:

- every ``extern "C" int crdt_*(...)`` in ``csrc/*.cu`` has a
  ``SIGNATURES`` row with the same count of arguments, pointer against
  integer in each position (``void*``/``T*`` against ``_P``; ``int``,
  ``int64_t``, ``uint64_t`` against ``_I``/``_U64``), and every row
  names an entry that exists;
- every call of a ``crdt_*`` entry on the library (``kernels().crdt_x``,
  ``lib.crdt_x`` or ``getattr(kernels(), name)``) passes as many
  arguments as its row (unless starred) and its result reaches
  ``check(...)``: directly, or bound to a name that the same function
  later passes to ``check``.

The ``.cu`` side is read with a regular expression over the entry's
declaration (parameters up to the closing parenthesis); ``_build.py``'s
table is evaluated from its AST (``[_P] * 3 + [_I] * 4 + ...``).  The
sources are found beside the linted ``_build.py`` (``csrc/``).
"""

from __future__ import annotations

import ast
import glob
import os
import re

from .core import Finding, PackageIndex

_ENTRY_RE = re.compile(r'extern\s+"C"\s+int\s+(crdt_\w+)\s*\(([^)]*)\)')
#: SIGNATURES' ctypes spellings: pointer or integer.
_KINDS = {"_P": "pointer", "_I": "integer", "_U64": "integer"}


def _c_kind(param: str) -> str:
    return "pointer" if "*" in param else "integer"


def cu_entries(csrc: str) -> dict[str, tuple[str, int, list[str]]]:
    """``{entry: (path, line, [kind a parameter])}`` of every
    ``extern "C" int crdt_*`` in ``csrc/*.cu``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        for m in _ENTRY_RE.finditer(src):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            line = src.count("\n", 0, m.start()) + 1
            out[m.group(1)] = (path, line,
                               [_c_kind(p) for p in params
                                if p != "void"])
    return out


def _eval_row(e: ast.expr) -> list[str] | None:
    """A ``SIGNATURES`` value as a list of kinds, or None when it is not
    built from ``[...]``, ``*`` and ``+`` over the ctypes names."""
    if isinstance(e, ast.List):
        out = []
        for el in e.elts:
            if not (isinstance(el, ast.Name) and el.id in _KINDS):
                return None
            out.append(_KINDS[el.id])
        return out
    if isinstance(e, ast.BinOp):
        a, b = _eval_row(e.left), None
        if isinstance(e.op, ast.Add):
            b = _eval_row(e.right)
            return None if a is None or b is None else a + b
        if isinstance(e.op, ast.Mult) and isinstance(e.right, ast.Constant):
            return None if a is None else a * int(e.right.value)
    return None


def signature_table(tree: ast.Module) -> dict[str, tuple[int, list]] | None:
    """``{entry: (line, kinds or None)}`` of a module-level
    ``SIGNATURES = {...}``, or None without one."""
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if not any(isinstance(t, ast.Name) and t.id == "SIGNATURES"
                   for t in targets):
            continue
        if not isinstance(node.value, ast.Dict):
            return None
        return {
            k.value: (k.lineno, _eval_row(v))
            for k, v in zip(node.value.keys, node.value.values)
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        }
    return None


def _table_findings(path: str, table: dict, csrc: str) -> list[Finding]:
    out = []
    entries = cu_entries(csrc)
    for name, (line, kinds) in sorted(table.items()):
        if name not in entries:
            out.append(Finding(
                rule="G009", path=path, line=line, col=0,
                msg=(f"SIGNATURES row `{name}` names no `extern \"C\" int "
                     f"{name}` in {os.path.basename(csrc)}/*.cu — the "
                     "loader fails, or binds a stale library's entry"),
            ))
            continue
        cu, cu_line, want = entries[name]
        if kinds is None:
            out.append(Finding(
                rule="G009", path=path, line=line, col=0,
                msg=(f"SIGNATURES row `{name}` is not a literal list of "
                     "_P/_I/_U64 — its argument types cannot be checked "
                     "against the C entry"),
            ))
        elif len(kinds) != len(want):
            out.append(Finding(
                rule="G009", path=path, line=line, col=0,
                msg=(f"SIGNATURES row `{name}` has {len(kinds)} arguments "
                     f"but {os.path.basename(cu)}:{cu_line} declares "
                     f"{len(want)} — ctypes shifts every argument after "
                     "the gap"),
            ))
        else:
            for i, (got, exp) in enumerate(zip(kinds, want)):
                if got != exp:
                    out.append(Finding(
                        rule="G009", path=path, line=line, col=0,
                        msg=(f"SIGNATURES row `{name}` argument {i} is "
                             f"{'an' if got == 'integer' else 'a'} {got} "
                             f"but {os.path.basename(cu)}:{cu_line} takes "
                             f"{'an' if exp == 'integer' else 'a'} {exp} — "
                             "a pointer passed as a C int is truncated"),
                    ))
    for name, (cu, cu_line, _k) in sorted(entries.items()):
        if name not in table:
            out.append(Finding(
                rule="G009", path=cu, line=cu_line, col=0,
                msg=(f"`extern \"C\" int {name}` has no SIGNATURES row in "
                     f"{os.path.basename(path)} — ctypes would pass every "
                     "argument as a C int"),
            ))
    return out


def _launch_name(call: ast.Call) -> tuple[bool, str | None]:
    """(is a kernel launch, the entry's name or None when dynamic)."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr.startswith("crdt_"):
        return True, f.attr
    if (isinstance(f, ast.Call) and isinstance(f.func, ast.Name)
            and f.func.id == "getattr" and f.args
            and isinstance(f.args[0], ast.Call)
            and isinstance(f.args[0].func, ast.Name)
            and f.args[0].func.id == "kernels"):
        return True, None
    return False, None


def _checked_names(fn: ast.AST) -> dict[str, list[int]]:
    """name -> lines of ``check(name, ...)`` calls in ``fn``."""
    out: dict[str, list[int]] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "check" and node.args
                and isinstance(node.args[0], ast.Name)):
            out.setdefault(node.args[0].id, []).append(node.lineno)
    return out


def _launch_findings(m, table) -> list[Finding]:
    out = []
    for fi in m.functions.values():
        checked = None
        parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(fi.node):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            is_launch, name = _launch_name(node)
            if not is_launch:
                continue
            if table is not None and name is not None \
                    and name not in table:
                continue  # not a kernel entry (crdt_error_string)
            label = name or "a dynamic crdt_* entry"
            if (table is not None and name is not None and name in table
                    and table[name][1] is not None
                    and not any(isinstance(a, ast.Starred)
                                for a in node.args)
                    and len(node.args) != len(table[name][1])):
                out.append(Finding(
                    rule="G009", path=m.path, line=node.lineno,
                    col=node.col_offset,
                    msg=(f"`{name}` launched with {len(node.args)} "
                         f"arguments but its SIGNATURES row has "
                         f"{len(table[name][1])}"),
                ))
            up = parents.get(node)
            if (isinstance(up, ast.Call) and isinstance(up.func, ast.Name)
                    and up.func.id == "check" and up.args
                    and up.args[0] is node):
                continue
            if (isinstance(up, ast.Assign) and len(up.targets) == 1
                    and isinstance(up.targets[0], ast.Name)):
                if checked is None:
                    checked = _checked_names(fi.node)
                if any(ln >= node.lineno
                       for ln in checked.get(up.targets[0].id, ())):
                    continue
            out.append(Finding(
                rule="G009", path=m.path, line=node.lineno,
                col=node.col_offset,
                msg=(f"the return of {label} (in `{fi.qualname}`) never "
                     "reaches check(err, name) — a failed launch "
                     "(cudaGetLastError) goes unnoticed and its outputs "
                     "are read uninitialized"),
            ))
    return out


def g009_launch_boundary(index: PackageIndex) -> list[Finding]:
    out: list[Finding] = []
    table = None
    for m in index.modules:
        if os.path.basename(m.path) != "_build.py":
            continue
        t = signature_table(m.tree)
        if t is None:
            continue
        table = t if table is None else {**table, **t}
        out.extend(_table_findings(
            m.path, t, os.path.join(os.path.dirname(m.path), "csrc")))
    for m in index.modules:
        out.extend(_launch_findings(m, table))
    return out
