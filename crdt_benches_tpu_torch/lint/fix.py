"""``--fix`` autofixer for G005's twin (implicit dtype at tensor
creation).

Mechanically rewrites ``torch.arange(...)`` / ``torch.zeros(...)`` / ...
to state the dtype they ALREADY produce under torch's defaults (default
float dtype float32) — making the implicit explicit is
semantics-preserving by construction, which is the only kind of rewrite a
linter may apply unattended.  The inference is deliberately narrow:

- ``arange``: every bound/step must be a numeric literal — all-int is
  ``torch.int64``, anything float is ``torch.float32``.  A non-literal
  bound is REFUSED: the result dtype follows the runtime type of the
  argument, which the AST cannot know;
- ``zeros``/``ones``/``empty``: always ``torch.float32`` (the shape
  never influences dtype);
- ``full``: dtype of the literal fill value (int -> int64, float ->
  float32, bool -> bool); non-literal fills are refused;
- ``tensor``: a literal (nested) list/tuple of numbers — int -> int64,
  any float -> float32, all-bool -> bool; anything else refused.

Refused sites stay G005 findings; the fixer reports them with the
reason.  Fixes are applied right-to-left per file (positions stay
valid), and a second run is a no-op: the rewritten call now has an
explicit dtype, so G005 no longer selects it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from .core import ModuleInfo, build_index
from .rules import g005_implicit_dtype


@dataclass
class FixResult:
    path: str
    line: int
    applied: bool
    detail: str  # inserted text, or the refusal reason


def _literal_num(e: ast.expr):
    if isinstance(e, ast.Constant) and isinstance(
        e.value, (int, float, bool)
    ):
        return e.value
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
        v = _literal_num(e.operand)
        return -v if isinstance(v, (int, float)) else None
    return None


def _flat_literals(e: ast.expr):
    """Every scalar literal of a nested list/tuple, or None."""
    if isinstance(e, (ast.List, ast.Tuple)):
        out = []
        for el in e.elts:
            sub = _flat_literals(el)
            if sub is None:
                return None
            out.extend(sub)
        return out
    v = _literal_num(e)
    return None if v is None else [v]


def infer_dtype(call: ast.Call, creator: str) -> tuple[str | None, str]:
    """(dtype name, reason) — dtype None means REFUSED."""
    if any(isinstance(a, ast.Starred) for a in call.args) or any(
        kw.arg is None for kw in call.keywords
    ):
        return None, "star-args hide the argument types"
    if creator in ("zeros", "ones", "empty"):
        return "float32", "torch default for value-less factories"
    if creator == "arange":
        vals = [_literal_num(a) for a in call.args]
        vals += [
            _literal_num(kw.value) for kw in call.keywords
            if kw.arg in ("start", "end", "step")
        ]
        if not vals or any(v is None for v in vals):
            return None, (
                "non-literal bound: the result dtype follows the "
                "runtime argument type"
            )
        if any(isinstance(v, float) for v in vals):
            return "float32", "float bound"
        return "int64", "all-int bounds"
    if creator == "full":
        fill = call.args[1] if len(call.args) >= 2 else next(
            (kw.value for kw in call.keywords if kw.arg == "fill_value"),
            None)
        if fill is None:
            return None, "no fill value"
        v = _literal_num(fill)
        if v is None:
            return None, "non-literal fill value"
        if isinstance(v, bool):
            return "bool", "bool fill"
        if isinstance(v, float):
            return "float32", "float fill"
        return "int64", "int fill"
    if creator == "tensor":
        if not call.args:
            return None, "no data argument"
        vals = _flat_literals(call.args[0])
        if vals is None:
            return None, "non-literal data: dtype follows runtime values"
        if vals and all(isinstance(v, bool) for v in vals):
            return "bool", "all-bool data"
        if any(isinstance(v, float) for v in vals):
            return "float32", "float data"
        return "int64", "all-int data"
    return None, f"no inference rule for torch.{creator}"


def _insertion(src_lines: list[str], call: ast.Call,
               dtype_expr: str) -> tuple[int, int, str] | None:
    """(line0, col, text) inserting ``dtype=...`` before the closing
    paren — or None when the span is unavailable."""
    end_ln = getattr(call, "end_lineno", None)
    end_col = getattr(call, "end_col_offset", None)
    if end_ln is None or end_col is None or end_col < 1:
        return None
    line0 = end_ln - 1
    if line0 >= len(src_lines):
        return None
    close = end_col - 1
    if src_lines[line0][close:close + 1] != ")":
        return None
    # trailing comma? walk back over whitespace (possibly across lines)
    ln, col = line0, close
    while True:
        seg = src_lines[ln][:col]
        if ln != line0:  # an earlier line may end in a comment
            seg = seg.split("#", 1)[0]
        seg = seg.rstrip()
        if seg:
            last = seg[-1]
            break
        if ln == 0:
            last = ""
            break
        ln -= 1
        col = len(src_lines[ln])
    sep = "" if last in (",", "(") else ", "
    return line0, close, f"{sep}dtype={dtype_expr}"


def fix_g005(paths: list[str]) -> list[FixResult]:
    """Apply the G005 autofix to every finding under ``paths``."""
    index, _errors = build_index(paths)
    findings = g005_implicit_dtype(index)
    by_path: dict[str, ModuleInfo] = {m.path: m for m in index.modules}
    per_file: dict[str, list] = {}
    results: list[FixResult] = []
    for f in findings:
        m = by_path.get(f.path)
        if m is None:
            continue
        if f.rule in m.suppress_file or f.rule in m.suppress.get(
            f.line, ()
        ):
            continue
        # locate the exact call node this finding anchored
        call = creator = None
        for node in ast.walk(m.tree):
            if (
                isinstance(node, ast.Call)
                and node.lineno == f.line
                and node.col_offset == f.col
            ):
                attr = m.is_torch_attr(node.func)
                if attr:
                    call, creator = node, attr
                    break
        if call is None:
            results.append(FixResult(
                f.path, f.line, False, "could not re-locate the call"
            ))
            continue
        alias = call.func.value.id  # the module's own torch spelling
        dtype, reason = infer_dtype(call, creator)
        if dtype is None:
            results.append(FixResult(
                f.path, f.line, False, f"refused ({reason})"
            ))
            continue
        ins = _insertion(
            m.src.splitlines(), call, f"{alias}.{dtype}"
        )
        if ins is None:
            results.append(FixResult(
                f.path, f.line, False, "call span not rewritable"
            ))
            continue
        per_file.setdefault(f.path, []).append((ins, f.line))
    for path, edits in per_file.items():
        lines = by_path[path].src.splitlines(keepends=True)
        # right-to-left so earlier positions stay valid
        for (line0, col, text), src_line in sorted(
            edits, key=lambda e: (e[0][0], e[0][1]), reverse=True
        ):
            ln = lines[line0]
            lines[line0] = ln[:col] + text + ln[col:]
            results.append(FixResult(path, src_line, True, text))
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("".join(lines))
    results.sort(key=lambda r: (r.path, r.line))
    return results
