"""Interprocedural constant/shape dataflow + rule G008 (shape drift).

The per-module rules are all module-local; the incident class they cannot see is
a *dimension constant* drifting between the module that defines it and
the modules that consume it — ``ops/apply2.py LANE`` tiling every packed
kernel, the capacity-class tuples that ``serve/pool.py`` buckets by, the
``Rt``/``B`` tile sizes baked into BlockSpecs.  This module adds the
missing half: a package-wide **constant environment** that resolves
module-level constants *across imports* (fixpoint over literal folding:
ints, tuples, arithmetic on already-resolved names, ``len`` of resolved
tuples), plus rule G008 which cross-checks producers and consumers of
the same symbolic dimension:

- **shared-constant drift**: a constant name that some module imports
  cross-module (it has a *producer*) independently redefined elsewhere
  with a different value — two copies of the same symbolic dimension
  that can now diverge silently;
- **import shadowing**: a module that imports NAME and also assigns a
  module-level NAME with a different resolved value (the imported
  binding is dead, the local fork wins);
- **capacity classes vs LANE**: every literal/default capacity-class
  tuple (``classes=...`` parameter defaults and call-site keywords) must
  hold multiples of the *resolved* ``LANE`` — the packed kernels tile by
  it, and ``DocPool`` only catches this at runtime;
- **classes/slots pairing**: ``classes`` and ``slots`` tuples declared
  together must agree on length (one bucket row-count per class).

The environment is also the resolver of the range rules' bounds
(:mod:`.ranges`): an ``inrange=`` bound written as a constant
(``NARROW_ID_BOUND``, ``LANE``) resolves through the same import chain
the runtime uses.  (The JAX package's G008, ported as it was.)
"""

from __future__ import annotations

import ast
import re

from .core import Finding, ModuleInfo, PackageIndex

#: Module-level constant names eligible for drift tracking: the
#: screaming-case convention this repo uses for dimension constants.
_CONST_NAME = re.compile(r"^[A-Z][A-Z0-9_]{2,}$")

#: Parameter names whose tuple values are capacity-class lists (checked
#: against LANE divisibility and against their paired row-count tuple).
_CLASS_PARAMS = ("classes",)
_SLOT_PARAMS = ("slots",)

_FOLD_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.FloorDiv: lambda a, b: a // b if b else None,
    ast.Mod: lambda a, b: a % b if b else None,
    ast.Pow: lambda a, b: a ** b if abs(b) < 64 else None,
    ast.LShift: lambda a, b: a << b if 0 <= b < 64 else None,
    ast.RShift: lambda a, b: a >> b if 0 <= b < 64 else None,
}


class ConstEnv:
    """Package-wide module-constant resolution (best-effort, pure AST).

    ``values[(module_path, name)]`` holds the resolved constant — int,
    float, str, bool, or tuple of those — for every module-level
    single-target assignment the fixpoint could fold.  Imports resolve
    through :meth:`resolve_module` (suffix match on the dotted source,
    the same flat-package assumption as ``PackageIndex.resolve_call``).
    """

    @classmethod
    def of(cls, index: PackageIndex) -> "ConstEnv":
        """The memoized environment for this index (rules share it)."""
        env = getattr(index, "_const_env", None)
        if env is None:
            env = index._const_env = cls(index)
        return env

    def __init__(self, index: PackageIndex):
        self.index = index
        self.values: dict[tuple[str, str], object] = {}
        self.def_lines: dict[tuple[str, str], int] = {}
        self._exprs: dict[tuple[str, str], tuple[ModuleInfo, ast.expr]] = {}
        self._mod_index: dict[str, list[ModuleInfo]] = {}
        for m in index.modules:
            parts = m.path.replace("\\", "/").split("/")
            stem = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
            names = parts[:-1] + [stem]
            # register every dotted suffix: "apply2", "ops.apply2", ...
            for i in range(len(names)):
                key = ".".join(names[i:])
                self._mod_index.setdefault(key, []).append(m)
            self._scan_module(m)
        self._fixpoint()

    # -- collection --------------------------------------------------------

    def _scan_module(self, m: ModuleInfo) -> None:
        dead: set[tuple[str, str]] = set()  # rebound names STAY dropped
        for node in ast.iter_child_nodes(m.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                t = node.target
                value = node.value
            else:
                continue
            if not isinstance(t, ast.Name):
                continue
            key = (m.path, t.id)
            if key in dead or key in self._exprs:
                # rebound at module level: ambiguous, drop from the env
                # for good (a third assignment must not resurrect it)
                dead.add(key)
                self.values.pop(key, None)
                self._exprs.pop(key, None)
                self.def_lines.pop(key, None)
                continue
            self._exprs[key] = (m, value)
            self.def_lines[key] = node.lineno

    # -- resolution --------------------------------------------------------

    def resolve_module(self, dotted: str) -> ModuleInfo | None:
        """The index module a dotted import source names, or None when
        the suffix is missing or ambiguous."""
        hits = self._mod_index.get(dotted, ())
        return hits[0] if len(hits) == 1 else None

    def lookup(self, m: ModuleInfo, name: str):
        """Resolve ``name`` as seen from module ``m``: a local module
        constant, or an imported one followed to its defining module.
        Returns the value or None."""
        v = self.values.get((m.path, name))
        if v is not None:
            return v
        src = m.imports.get(name)
        if src is None:
            return None
        mod, _, attr = src.rpartition(".")
        if not mod:
            return None
        target = self.resolve_module(mod)
        if target is None or target.path == m.path:
            return None
        return self.values.get((target.path, attr))

    def producer_of(self, m: ModuleInfo, name: str) -> ModuleInfo | None:
        """The module an import of ``name`` in ``m`` resolves to."""
        src = m.imports.get(name)
        if src is None:
            return None
        mod, _, attr = src.rpartition(".")
        if not mod or attr != name:
            return None
        return self.resolve_module(mod)

    def fold(self, m: ModuleInfo, e: ast.expr, depth: int = 0):
        """Fold ``e`` to a literal using ``m``'s constant view, or None."""
        if depth > 24:
            return None
        if isinstance(e, ast.Constant):
            v = e.value
            return v if isinstance(v, (int, float, str, bool)) else None
        if isinstance(e, ast.Name):
            return self.lookup(m, e.id)
        if isinstance(e, (ast.Tuple, ast.List)):
            out = []
            for el in e.elts:
                v = self.fold(m, el, depth + 1)
                if v is None:
                    return None
                out.append(v)
            return tuple(out)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
            v = self.fold(m, e.operand, depth + 1)
            return -v if isinstance(v, (int, float)) else None
        if isinstance(e, ast.BinOp):
            op = _FOLD_BINOPS.get(type(e.op))
            if op is None:
                return None
            a = self.fold(m, e.left, depth + 1)
            b = self.fold(m, e.right, depth + 1)
            if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                try:
                    return op(a, b)
                except (ZeroDivisionError, OverflowError, ValueError):
                    return None
            return None
        if (
            isinstance(e, ast.Call)
            and isinstance(e.func, ast.Name)
            and e.func.id == "len"
            and len(e.args) == 1
            and not e.keywords
        ):
            v = self.fold(m, e.args[0], depth + 1)
            return len(v) if isinstance(v, tuple) else None
        if isinstance(e, ast.Subscript):
            base = self.fold(m, e.value, depth + 1)
            idx = self.fold(m, e.slice, depth + 1)
            if isinstance(base, tuple) and isinstance(idx, int):
                try:
                    return base[idx]
                except IndexError:
                    return None
        return None

    def _fixpoint(self) -> None:
        pending = dict(self._exprs)
        for _ in range(12):  # import chains in this repo are shallow
            progressed = False
            for key, (m, expr) in list(pending.items()):
                v = self.fold(m, expr)
                if v is not None:
                    self.values[key] = v
                    del pending[key]
                    progressed = True
            if not progressed:
                break

    def lane_for(self, m: ModuleInfo) -> int | None:
        """The LANE value as module ``m`` sees it: its own resolved
        binding when present, otherwise the package's unique module-level
        ``LANE`` definition (every kernel module imports exactly that)."""
        v = self.lookup(m, "LANE")
        if isinstance(v, int):
            return v
        defs = {
            val for (_, name), val in self.values.items()
            if name == "LANE" and isinstance(val, int)
        }
        return defs.pop() if len(defs) == 1 else None


def _const_defs(env: ConstEnv) -> dict[str, list[tuple[ModuleInfo, object, int]]]:
    """name -> [(module, value, line)] for tracked module constants."""
    by_path = {m.path: m for m in env.index.modules}
    out: dict[str, list] = {}
    for (path, name), v in env.values.items():
        if not _CONST_NAME.match(name):
            continue
        m = by_path.get(path)
        if m is None:
            continue
        out.setdefault(name, []).append(
            (m, v, env.def_lines.get((path, name), 0))
        )
    return out


def _imported_producers(env: ConstEnv, name: str) -> dict[str, ModuleInfo]:
    """Modules whose constant ``name`` is imported by someone else in the
    package: path -> producer ModuleInfo."""
    out: dict[str, ModuleInfo] = {}
    for m in env.index.modules:
        p = env.producer_of(m, name)
        if p is not None and p.path != m.path:
            if (p.path, name) in env.values:
                out[p.path] = p
    return out


def _class_tuple_findings(env: ConstEnv, m: ModuleInfo, node: ast.expr,
                          values, lane: int | None, where: str
                          ) -> list[Finding]:
    out = []
    if lane and isinstance(values, tuple):
        bad = [v for v in values if isinstance(v, int) and v % lane]
        if bad:
            out.append(Finding(
                rule="G008", path=m.path, line=node.lineno,
                col=node.col_offset,
                msg=(
                    f"capacity class(es) {bad} in {where} are not "
                    f"multiples of LANE={lane} (ops/apply2.py) — the "
                    "packed kernels tile the capacity axis by LANE and "
                    "DocPool only rejects this at runtime"
                ),
            ))
    return out


def g008_shape_drift(index: PackageIndex) -> list[Finding]:
    """Cross-module constant/shape drift (see module docstring)."""
    env = ConstEnv.of(index)
    out: list[Finding] = []

    # ---- (a) import shadowing: local NAME forks an imported NAME ----
    shadowed: set[tuple[str, str]] = set()  # (path, name) already flagged
    for m in index.modules:
        for (path, name), v in list(env.values.items()):
            if path != m.path or not _CONST_NAME.match(name):
                continue
            p = env.producer_of(m, name)
            if p is None or p.path == m.path:
                continue
            pv = env.values.get((p.path, name))
            if pv is not None and pv != v:
                shadowed.add((path, name))
                out.append(Finding(
                    rule="G008", path=m.path,
                    line=env.def_lines[(path, name)], col=0,
                    msg=(
                        f"`{name} = {v!r}` shadows the imported "
                        f"`{name} = {pv!r}` from {p.path} — the local "
                        "fork silently drifts from the producer"
                    ),
                ))

    # ---- (b) shared-constant drift across independent definitions ----
    defs = _const_defs(env)
    for name, sites in defs.items():
        if len(sites) < 2:
            continue
        producers = _imported_producers(env, name)
        if not producers:
            continue  # never imported cross-module: not a shared symbol
        # canonical value: the producer(s) everyone imports from
        canon_vals = {
            env.values[(p.path, name)] for p in producers.values()
        }
        if len(canon_vals) != 1:
            canon_vals = {sites[0][1]}
        canon = canon_vals.pop()
        canon_paths = set(producers)
        for m, v, line in sites:
            if m.path in canon_paths or v == canon:
                continue
            if (m.path, name) in shadowed:
                continue  # already reported as an import shadow
            src = sorted(canon_paths)[0]
            out.append(Finding(
                rule="G008", path=m.path, line=line, col=0,
                msg=(
                    f"`{name} = {v!r}` drifts from `{name} = {canon!r}` "
                    f"defined in {src} (imported cross-module as the "
                    "shared dimension) — one symbolic dimension now has "
                    "two values"
                ),
            ))

    # ---- (c)/(d) capacity-class tuples: LANE multiples + slot pairing --
    def sig_params(fi):
        a = fi.node.args
        params = [p.arg for p in (a.posonlyargs + a.args)]
        defaults = list(a.defaults)
        # align defaults to the tail of params
        pairs = dict(zip(params[len(params) - len(defaults):], defaults))
        for p, d in zip(a.kwonlyargs, a.kw_defaults):
            if d is not None:
                pairs[p.arg] = d
        return pairs

    for m in index.modules:
        lane = env.lane_for(m)
        for fi in m.functions.values():
            pairs = sig_params(fi)
            cls_vals = slot_vals = None
            slot_node = None
            for pname, dnode in pairs.items():
                if pname in _CLASS_PARAMS:
                    cls_vals = env.fold(m, dnode)
                    out.extend(_class_tuple_findings(
                        env, m, dnode, cls_vals, lane,
                        f"`{fi.qualname}` default `{pname}=`",
                    ))
                elif pname in _SLOT_PARAMS:
                    slot_vals = env.fold(m, dnode)
                    slot_node = dnode
            if (
                isinstance(cls_vals, tuple)
                and isinstance(slot_vals, tuple)
                and len(cls_vals) != len(slot_vals)
            ):
                out.append(Finding(
                    rule="G008", path=m.path, line=slot_node.lineno,
                    col=slot_node.col_offset,
                    msg=(
                        f"`{fi.qualname}`: {len(cls_vals)} capacity "
                        f"classes but {len(slot_vals)} slot counts — "
                        "every class needs exactly one bucket row count"
                    ),
                ))
        # call sites passing literal class/slot tuples by keyword
        for fi in m.functions.values():
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                kw = {k.arg: k.value for k in node.keywords if k.arg}
                cv = sv = None
                for pname in _CLASS_PARAMS:
                    if pname in kw:
                        cv = env.fold(m, kw[pname])
                        out.extend(_class_tuple_findings(
                            env, m, kw[pname], cv, lane,
                            f"call-site `{pname}=`",
                        ))
                for pname in _SLOT_PARAMS:
                    if pname in kw:
                        sv = env.fold(m, kw[pname])
                if (
                    isinstance(cv, tuple) and isinstance(sv, tuple)
                    and len(cv) != len(sv)
                ):
                    out.append(Finding(
                        rule="G008", path=m.path,
                        line=kw[_SLOT_PARAMS[0]].lineno,
                        col=kw[_SLOT_PARAMS[0]].col_offset,
                        msg=(
                            f"call passes {len(cv)} capacity classes "
                            f"but {len(sv)} slot counts — every class "
                            "needs exactly one bucket row count"
                        ),
                    ))
    return out
