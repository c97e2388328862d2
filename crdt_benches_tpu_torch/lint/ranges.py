"""Value-range & index-space rules G026-G029: guarded dynamic
indexing, narrow-lane overflow, PAD-sentinel flow, and the runtime
ranges-artifact cross-check.

The JAX package's rules, ported; G026 is the torch twin.  On the card
a bad index does not clamp as XLA's does: torch's CUDA gathers and
scatters check their index on the device, and an out-of-range one is a
device-side assert that poisons the CUDA context for the rest of the
process (an unchecked one in a hand kernel reads or writes the wrong
row silently, as XLA's clamp does).  The
serving stack is built on exactly these operations (the serve_fused
clamped gather whose garbage "is masked" was a prose claim; the
uint16 op lanes whose ``OpRangeError`` ceiling guards one entry point
of several).  These rules encode that incident class the same way
G014-G021 and G022-G025 encoded theirs: a declared static model
enforced against the AST, with a runtime sanitizer twin
(lint/range_sanitizer.py) whose counters the artifact-driven G029
cross-checks.

Marker vocabulary (parsed from REAL comments via
``ModuleInfo.comments``):

- ``# graftlint: inrange=<sym><op><bound> [check=<name>]
  [surface=<staging|fused|scan>]`` — declares that local ``<sym>`` is
  in-range (``<`` or ``<=`` the bound) in the enclosing function.
  The bound is an int literal, a SCREAMING_CASE constant resolved
  through the G008 constant environment (``LANE``, class capacities —
  an unresolvable constant is a finding), or a lowercase local whose
  value only the runtime twin can check.  ``check=<name>`` pairs the
  fact with a :func:`range_sanitizer.check_index` counter so G029 can
  dead-check it against a serve artifact.

- ``# graftlint: mask=<tag>`` — one half of a clamp/mask pair: on the
  clamped-gather line it declares "the clamp region's garbage is
  consumed by mask ``<tag>``"; on the masking ``jnp.where`` line it
  declares the consumer.  G026 requires both halves — an undeclared
  clamp-and-hope is a finding — and G029 dead-checks the tag against
  the runtime :func:`range_sanitizer.note_mask` counters.

- ``# graftlint: narrow=<name>`` — declares local ``<name>`` a narrow
  (uint16/int8) op lane for G027 (lanes assigned via an explicit
  ``.astype(uint16/int8)`` are inferred without a marker).

**G026 — unguarded dynamic index (torch twin).**  Every torch index
site — ``gather``, ``index_select``, ``take``, ``scatter_``/
``scatter_add_``/``scatter_reduce_``, ``index_add_``/``index_copy_``/
``index_fill_``, ``index_put_``, and advanced indexing (a subscript by a
tensor: a ``torch.*`` call or a local bound to one) — whose index
operand is not dominated by a clamp/clip/maximum/minimum/mod/``where``
selection, an ``arange``-family constructor, or a declared ``inrange=``
fact is a finding (JAX's sites are ``take_along_axis``/``jnp.take``/
``.at[...]``/Pallas refs).  Guardedness
propagates through local assignment chains and interprocedurally
along the CONFIDENT call edges (``resolve_call(strict=True)``, the
thread-labeling resolver): a bare-parameter index is guarded only
when every confident caller passes a guarded value.  A *clamped*
gather (clamp/clip/maximum/minimum) additionally requires a declared
``mask=`` consumer for the clamp region.

**G027 — narrow-lane overflow.**  Arithmetic (``+ - * <<``) on a lane
declared (or inferred) uint16/int8 before a widen
(``.astype(int32)`` / ``widen_ops`` unpack) can exceed the dtype and
wrap — unless the function is dominated by the ``OpRangeError``
staging bound check (``pack_ops``'s refusal path).

**G028 — PAD-sentinel flow.**  A PAD/sentinel constant (``PAD``,
``*_PAD``, ``*_SENTINEL``, ``_BIG`` — local or imported, resolved
cross-module) reaching arithmetic, or a sentinel-carrying local
(assigned from a ``where``/``full`` that plants the sentinel)
reaching arithmetic or an ordering comparison against anything other
than the sentinel itself, without an intervening mask (a ``where``
whose condition tests the sentinel, or a ``mask=`` tag on the line).
Comparisons AGAINST the sentinel are the masking idiom and are legal.

**G029 — ranges artifact cross-check** (artifact-driven, mirrors
G011/G017/G021/G025): the serve artifact's ``ranges`` block (the
range sanitizer's check/mask counters) is the runtime ground truth.
A ``check=``-paired fact or declared mask tag the run never counted
is DEAD (scoped by armed surface: staging/fused/scan); a runtime
counter with no matching declaration is a model escape.

Jurisdiction: the serving stack (``ops/``, ``serve/``) plus the
``ranges`` fixture corpus — the engine's merge/replay kernels predate
the model and land under it with the ROADMAP compaction work.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from .core import Finding, FuncInfo, ModuleInfo, PackageIndex
from .flow import ConstEnv
from .range_sanitizer import KNOWN_SURFACES
from .threads import load_artifact_block

#: Directory scope (path components): the serving stack, plus the
#: fixture corpus directory so seeded violations fire under test.
_RANGE_DIRS = ("ops", "serve", "ranges")

_INRANGE_RE = re.compile(
    r"#\s*graftlint:\s*inrange=([A-Za-z_][A-Za-z0-9_]*)"
    r"(<=|<)([A-Za-z0-9_\-]+)"
)
_CHECK_RE = re.compile(r"\bcheck=([A-Za-z0-9_.\-]+)")
_SURFACE_RE = re.compile(r"\bsurface=([A-Za-z0-9_-]+)")
_MASK_RE = re.compile(r"#\s*graftlint:\s*mask=([A-Za-z0-9_-]+)")
_NARROW_RE = re.compile(
    r"#\s*graftlint:\s*narrow=([A-Za-z_][A-Za-z0-9_]*)"
)

#: Module-constant names treated as PAD/sentinel values by convention.
_PAD_NAME_RE = re.compile(r"^(_?(PAD|SENTINEL|BIG)|.*_(PAD|SENTINEL))$")

#: SCREAMING_CASE bound symbols must resolve through the constant
#: environment (same convention as flow._CONST_NAME).
_CONST_BOUND_RE = re.compile(r"^[A-Z][A-Z0-9_]{2,}$")

#: Index-producing calls that CLAMP their operand into range — guarded,
#: but the clamp region's garbage needs a declared mask consumer when
#: the result feeds a gather.
_CLAMP_FUNCS = frozenset({
    "clip", "maximum", "minimum", "clamp", "clamp_", "clamp_min",
    "clamp_max",
})

#: Index-producing calls whose result is in-range (or out-of-range-safe)
#: by construction: `where` selection (the drop-sentinel scatter idiom),
#: iota/arange/argsort families, zero/full constructors.
_SAFE_FUNCS = frozenset({
    "where", "arange", "argsort", "argmax", "argmin", "iota",
    "broadcasted_iota", "zeros", "zeros_like", "ones", "full",
    "mod", "remainder", "fmod", "nonzero", "full_like",
})

#: Receiver methods transparent to guardedness (shape-only).
_TRANSPARENT_METHODS = frozenset({
    "astype", "reshape", "squeeze", "ravel", "flatten", "transpose",
    "long", "int", "to", "view", "expand", "expand_as", "unsqueeze",
    "contiguous", "clone", "t",
})

#: Torch index methods: name -> position of the index operand (the
#: tensor method form; ``torch.<name>(x, ...)`` shifts it by one).
_TORCH_INDEX_METHODS = {
    "gather": 1, "index_select": 1, "take_along_dim": 0,
    "scatter": 1, "scatter_": 1, "scatter_add": 1, "scatter_add_": 1,
    "scatter_reduce": 1, "scatter_reduce_": 1, "index_add": 1,
    "index_add_": 1, "index_copy": 1, "index_copy_": 1,
    "index_fill": 1, "index_fill_": 1, "index_put": 0, "index_put_": 0,
}
_SCATTERS = frozenset(n for n in _TORCH_INDEX_METHODS
                      if n.startswith(("scatter", "index_add",
                                       "index_copy", "index_fill",
                                       "index_put")))


#: Narrow dtype attribute spellings for G027 inference.
_NARROW_DTYPE_ATTRS = frozenset({"uint16", "int8"})

_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.LShift, ast.Pow)
_ORDER_OPS = (ast.Lt, ast.LtE, ast.Gt, ast.GtE)


def _in_scope(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return any(d in parts for d in _RANGE_DIRS)


# ---------------------------------------------------------------------------
# marker model
# ---------------------------------------------------------------------------


@dataclass
class RangeFact:
    sym: str
    op: str  # "<" | "<="
    bound: str  # raw token
    bound_val: int | None
    check: str | None
    surface: str
    module: ModuleInfo
    line: int
    fi: FuncInfo | None


@dataclass
class MaskDecl:
    tag: str
    surface: str
    module: ModuleInfo
    line: int
    fi: FuncInfo | None


@dataclass
class NarrowDecl:
    name: str
    module: ModuleInfo
    line: int
    fi: FuncInfo | None


@dataclass
class RangeModel:
    facts: list = field(default_factory=list)
    masks: list = field(default_factory=list)
    narrows: list = field(default_factory=list)
    parse_findings: list = field(default_factory=list)

    def facts_for(self, fi: FuncInfo) -> dict:
        return {
            f.sym: f for f in self.facts
            if f.fi is not None and f.fi.node is fi.node
        }

    def mask_lines(self, m: ModuleInfo) -> dict:
        """tag -> sorted distinct declaration lines in module ``m``."""
        out: dict[str, set] = {}
        for mk in self.masks:
            if mk.module.path == m.path:
                out.setdefault(mk.tag, set()).add(mk.line)
        return {t: sorted(ls) for t, ls in out.items()}


def _enclosing_fn(m: ModuleInfo, line: int) -> FuncInfo | None:
    """The innermost function whose span contains ``line``."""
    best = None
    best_span = None
    for fi in m.functions.values():
        lo = fi.node.lineno
        hi = getattr(fi.node, "end_lineno", lo) or lo
        if lo <= line <= hi:
            span = hi - lo
            if best_span is None or span < best_span:
                best, best_span = fi, span
    return best


def build_range_model(index: PackageIndex) -> RangeModel:
    cached = getattr(index, "_range_model", None)
    if cached is not None:
        return cached
    model = RangeModel()
    env = ConstEnv.of(index)
    for m in index.modules:
        for lineno, text in sorted(m.comments.items()):
            for im in _INRANGE_RE.finditer(text):
                sym, op, bound = im.group(1), im.group(2), im.group(3)
                fi = _enclosing_fn(m, lineno)
                bound_val: int | None = None
                if re.fullmatch(r"-?\d+", bound):
                    bound_val = int(bound)
                elif _CONST_BOUND_RE.match(bound):
                    v = env.lookup(m, bound)
                    if isinstance(v, int):
                        bound_val = v
                    else:
                        model.parse_findings.append(Finding(
                            rule="G026", path=m.path, line=lineno,
                            col=0,
                            msg=(
                                f"inrange bound `{bound}` looks like a "
                                "module constant but the constant "
                                "environment cannot resolve it — a "
                                "typo'd bound symbol declares a fact "
                                "about nothing"
                            ),
                        ))
                cm = _CHECK_RE.search(text)
                sm = _SURFACE_RE.search(text)
                surface = sm.group(1) if sm else "staging"
                if surface not in KNOWN_SURFACES:
                    model.parse_findings.append(Finding(
                        rule="G026", path=m.path, line=lineno, col=0,
                        msg=(
                            f"unknown range surface `{surface}` — the "
                            "ranges model only knows "
                            f"{'/'.join(KNOWN_SURFACES)}; an "
                            "unmatchable surface silently disables "
                            "the G029 dead-fact check"
                        ),
                    ))
                if fi is None:
                    model.parse_findings.append(Finding(
                        rule="G026", path=m.path, line=lineno, col=0,
                        msg=(
                            f"inrange fact for `{sym}` outside any "
                            "function — range facts describe a local "
                            "operand, not the module"
                        ),
                    ))
                model.facts.append(RangeFact(
                    sym=sym, op=op, bound=bound, bound_val=bound_val,
                    check=cm.group(1) if cm else None,
                    surface=surface, module=m, line=lineno, fi=fi,
                ))
            for mm in _MASK_RE.finditer(text):
                sm = _SURFACE_RE.search(text)
                surface = sm.group(1) if sm else "staging"
                if surface not in KNOWN_SURFACES:
                    model.parse_findings.append(Finding(
                        rule="G026", path=m.path, line=lineno, col=0,
                        msg=(
                            f"unknown range surface `{surface}` on "
                            f"mask `{mm.group(1)}` — want "
                            f"{'/'.join(KNOWN_SURFACES)}"
                        ),
                    ))
                model.masks.append(MaskDecl(
                    tag=mm.group(1), surface=surface, module=m,
                    line=lineno, fi=_enclosing_fn(m, lineno),
                ))
            for nm in _NARROW_RE.finditer(text):
                model.narrows.append(NarrowDecl(
                    name=nm.group(1), module=m, line=lineno,
                    fi=_enclosing_fn(m, lineno),
                ))
    index._range_model = model
    return model


# ---------------------------------------------------------------------------
# guardedness analysis (G026)
# ---------------------------------------------------------------------------


def _call_sites(index: PackageIndex) -> dict:
    """id(callee FuncInfo node) -> [(caller FuncInfo, Call)] along the
    CONFIDENT edges only — the same resolver thread_labels trusts."""
    cached = getattr(index, "_range_call_sites", None)
    if cached is not None:
        return cached
    sites: dict[ast.AST, list] = {}
    for m in index.modules:
        for fi in m.functions.values():
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in index.resolve_call(node, fi, strict=True):
                    sites.setdefault(callee.node, []).append(
                        (fi, node)
                    )
    index._range_call_sites = sites
    return sites


class _FnGuards:
    """Per-function guardedness state: declared facts, range-loop
    variables, and locals assigned from guarded expressions (a small
    fixpoint so assignment chains converge)."""

    def __init__(self, fi: FuncInfo, model: RangeModel):
        self.fi = fi
        self.facts = model.facts_for(fi)
        self.loopvars: set[str] = set()
        self.guarded: dict[str, bool] = {}  # name -> clamped
        for node in ast.walk(fi.node):
            if isinstance(node, ast.For) and isinstance(
                node.target, ast.Name
            ):
                it = node.iter
                if (
                    isinstance(it, ast.Call)
                    and isinstance(it.func, ast.Name)
                    and it.func.id == "range"
                ):
                    self.loopvars.add(node.target.id)

    def populate(self, an: "_Analyzer") -> None:
        for _ in range(4):  # assignment chains are shallow
            changed = False
            for node in ast.walk(self.fi.node):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Tuple)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "sort"
                ):
                    # (values, permutation): both index the sorted axis
                    for el in node.targets[0].elts:
                        if isinstance(el, ast.Name) and \
                                el.id not in self.guarded:
                            self.guarded[el.id] = False
                            changed = True
                    continue
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                ):
                    continue
                name = node.targets[0].id
                if name in self.guarded:
                    continue
                g, c = an.guard(node.value, self, set())
                if g:
                    self.guarded[name] = c
                    changed = True
            if not changed:
                break


class _Analyzer:
    def __init__(self, index: PackageIndex, model: RangeModel):
        self.index = index
        self.model = model
        # keyed by the node OBJECT (never a bare id(): the dict keeps
        # the node alive, so the key cannot recycle — G024's contract)
        self._states: dict[ast.AST, _FnGuards] = {}

    def state(self, fi: FuncInfo) -> _FnGuards:
        st = self._states.get(fi.node)
        if st is None:
            # store BEFORE populating: guardedness can re-enter this
            # function's state through a call cycle, and the partially
            # built (conservative) view must answer, not recurse
            st = self._states[fi.node] = _FnGuards(fi, self.model)
            st.populate(self)
        return st

    # -- expression guardedness -------------------------------------------

    def guard(self, e: ast.expr, st: _FnGuards,
              visited: set) -> tuple[bool, bool]:
        """(guarded, clamped) for an index expression in ``st``'s
        function."""
        if isinstance(e, ast.Constant):
            return isinstance(e.value, (int, bool)), False
        if isinstance(e, ast.Slice):
            return True, False  # python slice semantics clamp safely
        if isinstance(e, ast.Tuple):
            clamped = False
            for el in e.elts:
                g, c = self.guard(el, st, visited)
                if not g:
                    return False, False
                clamped |= c
            return True, clamped
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
            return self.guard(e.operand, st, visited)
        if isinstance(e, ast.Name):
            if e.id in st.facts or e.id in st.loopvars:
                return True, False
            if e.id in st.guarded:
                return True, st.guarded[e.id]
            if e.id in st.fi.params:
                return self._param_guard(st.fi, e.id, visited)
            return False, False
        if isinstance(e, ast.BinOp):
            if isinstance(e.op, ast.Mod):
                return True, False  # wraps into range by construction
            return False, False
        if isinstance(e, ast.Subscript):
            # pure reshape subscripts (`sq[:, :, None]`) are
            # transparent: the values are the receiver's
            parts = (
                e.slice.elts if isinstance(e.slice, ast.Tuple)
                else [e.slice]
            )
            if all(
                isinstance(p, ast.Slice)
                or (isinstance(p, ast.Constant) and p.value is None)
                for p in parts
            ):
                return self.guard(e.value, st, visited)
            return False, False
        if isinstance(e, ast.Call):
            f = e.func
            attr = f.attr if isinstance(f, ast.Attribute) else None
            if attr in _CLAMP_FUNCS:
                return True, True
            if attr in _SAFE_FUNCS:
                return True, False
            if attr in _TRANSPARENT_METHODS and isinstance(
                f, ast.Attribute
            ):
                return self.guard(f.value, st, visited)
            return False, False
        return False, False

    def _param_guard(self, fi: FuncInfo, pname: str,
                     visited: set) -> tuple[bool, bool]:
        """A bare-parameter index is guarded iff EVERY confident call
        site passes a guarded value (and at least one exists) — the
        interprocedural propagation along thread_labels' edges."""
        key = (fi.node, pname)
        if key in visited:
            return False, False  # recursion: nothing proven
        visited = visited | {key}
        sites = _call_sites(self.index).get(fi.node)
        if not sites:
            return False, False
        clamped = False
        try:
            pos = fi.params.index(pname)
        except ValueError:
            return False, False
        for caller, call in sites:
            arg = None
            offset = (
                1 if fi.cls is not None
                and isinstance(call.func, ast.Attribute) else 0
            )
            idx = pos - offset
            if 0 <= idx < len(call.args):
                arg = call.args[idx]
            else:
                for kw in call.keywords:
                    if kw.arg == pname:
                        arg = kw.value
                        break
            if arg is None:
                arg = self._default_for(fi, pname)
            if arg is None:
                return False, False
            g, c = self.guard(arg, self.state(caller), visited)
            if not g:
                return False, False
            clamped |= c
        return True, clamped

    @staticmethod
    def _default_for(fi: FuncInfo, pname: str) -> ast.expr | None:
        a = fi.node.args
        names = [p.arg for p in (a.posonlyargs + a.args)]
        defaults = a.defaults
        if not defaults:
            return None
        tail = names[-len(defaults):]
        if pname in tail:
            return defaults[tail.index(pname)]
        return None


@dataclass
class _Site:
    idx: ast.expr
    line: int
    col: int
    kind: str  # "gather" | "scatter"
    desc: str


def _index_sites(m: ModuleInfo, fi: FuncInfo) -> list[_Site]:
    sites: list[_Site] = []
    tensors = None
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            f = node.func
            torch_fn = m.is_torch_attr(f) is not None
            pos = 0 if torch_fn and f.attr == "take" else \
                _TORCH_INDEX_METHODS.get(f.attr)
            if pos is None:
                continue
            if torch_fn:
                pos += 1  # torch.gather(x, dim, index), torch.take(x, i)
            idx = node.args[pos] if len(node.args) > pos else next(
                (kw.value for kw in node.keywords
                 if kw.arg in ("index", "indices")), None)
            if idx is None:
                continue
            sites.append(_Site(
                idx=idx, line=node.lineno, col=node.col_offset,
                kind="scatter" if f.attr in _SCATTERS else "gather",
                desc=f"torch {f.attr}",
            ))
        elif isinstance(node, ast.Subscript):
            parts = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                     else [node.slice])
            if tensors is None:
                tensors = m.tensor_locals(fi.node)
            hit = [p for p in parts
                   if (isinstance(p, ast.Name) and p.id in tensors)
                   or (isinstance(p, ast.Call) and m.is_torch_call(p))]
            if not hit:
                continue
            store = isinstance(node.ctx, ast.Store)
            for p in hit:
                sites.append(_Site(
                    idx=p, line=node.lineno, col=node.col_offset,
                    kind="scatter" if store else "gather",
                    desc=("advanced-index store" if store
                          else "advanced-index gather"),
                ))
    return sites


def _plain_version(fi: FuncInfo) -> bool:
    """A kernel's plain version (``@kernel_body``, or named ``*_plain``):
    its wrapper runs it only for CPU tensors, where torch raises on an
    out-of-range index instead of reading the wrong row; on the card the
    kernel runs, whose bounds are its launch boundary's (G009's twin)."""
    return fi.kernel_body or fi.qualname.split(".")[-1].endswith("_plain")


def g026_index_guard(index: PackageIndex) -> list[Finding]:
    model = build_range_model(index)
    out = list(model.parse_findings)
    an = _Analyzer(index, model)
    for m in index.modules:
        if not _in_scope(m.path):
            continue
        mask_lines = model.mask_lines(m)
        for fi in m.functions.values():
            if _plain_version(fi):
                continue
            sites = _index_sites(m, fi)
            if not sites:
                continue
            st = an.state(fi)
            for s in sites:
                guarded, clamped = an.guard(s.idx, st, set())
                if not guarded:
                    out.append(Finding(
                        rule="G026", path=m.path, line=s.line,
                        col=s.col,
                        msg=(
                            f"unguarded dynamic index into {s.desc} "
                            f"in `{fi.qualname}`: the operand is not "
                            "dominated by a clip/maximum/mod/where "
                            "guard or a declared `# graftlint: "
                            "inrange=` fact on any confident call "
                            "path — an out-of-range index is a device-side "
                            "assert on the card (a silent wrong row in a "
                            "hand kernel)"
                        ),
                    ))
                    continue
                if clamped and s.kind == "gather":
                    tags = [
                        t for t, lines in mask_lines.items()
                        if s.line in lines
                    ]
                    if not tags:
                        out.append(Finding(
                            rule="G026", path=m.path, line=s.line,
                            col=s.col,
                            msg=(
                                f"clamped gather in `{fi.qualname}` "
                                "with no declared mask consumer — the "
                                "clamp region reads garbage by "
                                "construction; declare the consuming "
                                "mask with `# graftlint: mask=<tag>` "
                                "on BOTH the gather and the masking "
                                "`where` (undeclared clamp-and-hope)"
                            ),
                        ))
                        continue
                    for t in tags:
                        if len(mask_lines.get(t, [])) < 2:
                            out.append(Finding(
                                rule="G026", path=m.path, line=s.line,
                                col=s.col,
                                msg=(
                                    f"mask tag `{t}` on this clamped "
                                    "gather has no paired consumer "
                                    "site in the module — the clamp "
                                    "region's garbage is read "
                                    "unmasked"
                                ),
                            ))
    return out


# ---------------------------------------------------------------------------
# G027 — narrow-lane overflow
# ---------------------------------------------------------------------------


def _is_narrow_dtype_attr(e: ast.expr, m: ModuleInfo) -> bool:
    return (
        isinstance(e, ast.Attribute)
        and e.attr in _NARROW_DTYPE_ATTRS
        and isinstance(e.value, ast.Name)
        and e.value.id in (m.jnp_aliases | m.np_aliases
                           | m.torch_aliases)
    )


def _narrow_inferred(node: ast.Assign, m: ModuleInfo) -> bool:
    """True when the assignment's value casts to a narrow dtype
    (``x.astype(np.uint16)`` / ``np.asarray(x, np.int8)``)."""
    for leaf in ast.walk(node.value):
        if not isinstance(leaf, ast.Call):
            continue
        f = leaf.func
        if isinstance(f, ast.Attribute) and f.attr in (
            "astype", "asarray", "array", "full", "zeros", "ones",
        ):
            for a in list(leaf.args) + [kw.value for kw in leaf.keywords]:
                if _is_narrow_dtype_attr(a, m):
                    return True
        if _is_narrow_dtype_attr(f, m):  # np.uint16(x) constructor
            return True
    return False


def _widen_lines(fi: FuncInfo) -> dict[str, int]:
    """name -> line where the local is widened back to int32: an
    ``.astype(int32)``-style reassignment or a ``widen_ops`` unpack."""
    out: dict[str, int] = {}
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Assign):
            continue
        widens = False
        for leaf in ast.walk(node.value):
            if isinstance(leaf, ast.Call):
                f = leaf.func
                if isinstance(f, ast.Name) and f.id == "widen_ops":
                    widens = True
                elif isinstance(f, ast.Attribute) and f.attr in (
                    "astype", "asarray",
                ):
                    for a in (
                        list(leaf.args)
                        + [kw.value for kw in leaf.keywords]
                    ):
                        if (
                            isinstance(a, ast.Attribute)
                            and a.attr in ("int32", "int64")
                        ):
                            widens = True
        if not widens:
            continue
        for t in node.targets:
            elts = t.elts if isinstance(t, ast.Tuple) else [t]
            for el in elts:
                if isinstance(el, ast.Name):
                    line = out.get(el.id)
                    if line is None or node.lineno < line:
                        out[el.id] = node.lineno
    return out


def _range_check_line(fi: FuncInfo) -> int | None:
    """The line of an ``OpRangeError`` raise (or a ``pack_ops`` /
    ``_check_range`` call) dominating later narrow arithmetic — the
    staging bound check the packing module keeps."""
    best = None
    for node in ast.walk(fi.node):
        line = None
        if isinstance(node, ast.Raise) and node.exc is not None:
            for leaf in ast.walk(node.exc):
                if (
                    isinstance(leaf, ast.Name)
                    and leaf.id == "OpRangeError"
                ):
                    line = node.lineno
        elif isinstance(node, ast.Call):
            f = node.func
            name = (
                f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None
            )
            if name in ("pack_ops", "_check_range"):
                line = node.lineno
        if line is not None and (best is None or line < best):
            best = line
    return best


def g027_narrow_overflow(index: PackageIndex) -> list[Finding]:
    model = build_range_model(index)
    out: list[Finding] = []
    for m in index.modules:
        if not _in_scope(m.path):
            continue
        for fi in m.functions.values():
            narrow: dict[str, int] = {}
            for nd in model.narrows:
                if nd.fi is not None and nd.fi.node is fi.node:
                    narrow[nd.name] = nd.line
            for node in ast.walk(fi.node):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _narrow_inferred(node, m)
                ):
                    name = node.targets[0].id
                    if name not in narrow:
                        narrow[name] = node.lineno
            if not narrow:
                continue
            widened = _widen_lines(fi)
            checked = _range_check_line(fi)
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.BinOp) or not isinstance(
                    node.op, _ARITH_OPS
                ):
                    continue
                for side in (node.left, node.right):
                    if not isinstance(side, ast.Name):
                        continue
                    name = side.id
                    if name not in narrow:
                        continue
                    if node.lineno < narrow[name]:
                        continue  # arithmetic before it went narrow
                    w = widened.get(name)
                    if w is not None and w <= node.lineno:
                        continue  # widened first — the legal order
                    if checked is not None and checked <= node.lineno:
                        continue  # dominated by the OpRangeError check
                    out.append(Finding(
                        rule="G027", path=m.path, line=node.lineno,
                        col=node.col_offset,
                        msg=(
                            f"arithmetic on narrow lane `{name}` "
                            f"(uint16/int8) in `{fi.qualname}` before "
                            "a widen — the sum can exceed the dtype "
                            "and WRAP into an aliased value; widen "
                            "first (`.astype(int32)` / `widen_ops`) "
                            "or dominate with the `OpRangeError` "
                            "staging bound check"
                        ),
                    ))
    return out


# ---------------------------------------------------------------------------
# G028 — PAD-sentinel flow
# ---------------------------------------------------------------------------


def _pad_consts(m: ModuleInfo) -> set[str]:
    """Local names bound to PAD/sentinel constants: module-level
    definitions matching the naming convention, plus imports whose
    source ends with one (cross-module tracking)."""
    out = set()
    for node in ast.iter_child_nodes(m.tree):
        targets = ()
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = (node.target,)
        for t in targets:
            if isinstance(t, ast.Name) and _PAD_NAME_RE.match(t.id):
                out.add(t.id)
    for local, src in m.imports.items():
        leaf = src.rpartition(".")[2]
        if _PAD_NAME_RE.match(leaf) and _PAD_NAME_RE.match(local):
            out.add(local)
    return out


def _compares_pad(e: ast.expr, pads: set, carrying: set) -> bool:
    """True when ``e`` contains a comparison against the sentinel —
    the masking idiom (``x == PAD`` / ``nxt >= _BIG``)."""
    for leaf in ast.walk(e):
        if isinstance(leaf, ast.Compare):
            for side in [leaf.left] + list(leaf.comparators):
                if isinstance(side, ast.Name) and side.id in pads:
                    return True
    return False


def _carry_names(e: ast.expr) -> list[str]:
    """Names contributing VALUE to ``e`` — Compare subtrees are pruned
    (a comparison yields a boolean mask, never the sentinel value, so
    ``before = sum(where(d < d', L, 0))`` does not carry ``d``'s
    sentinel even though ``d`` appears in it)."""
    out: list[str] = []
    stack = [e]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Compare):
            continue
        if isinstance(n, ast.Name):
            out.append(n.id)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _replant_exempt(fi: FuncInfo, pads: set) -> set:
    """ids of nodes inside a ``where`` branch whose OTHER branch (or
    the same one) re-plants the sentinel constant — the self-masking
    idiom ``where(live, d - before, BIG)``: whatever garbage the
    sentinel-carrying operand produces on dead lanes is overwritten by
    the sentinel in the same select, so the arithmetic never leaks."""
    out: set[int] = set()
    for node in ast.walk(fi.node):
        if not (isinstance(node, ast.Call) and len(node.args) == 3):
            continue
        f = node.func
        fname = (
            f.attr if isinstance(f, ast.Attribute)
            else f.id if isinstance(f, ast.Name) else None
        )
        if fname != "where":
            continue
        if any(
            isinstance(a, ast.Name) and a.id in pads
            for a in node.args[1:3]
        ):
            for a in node.args[1:3]:
                for leaf in ast.walk(a):
                    out.add(id(leaf))
    return out


def g028_pad_flow(index: PackageIndex) -> list[Finding]:
    model = build_range_model(index)
    out: list[Finding] = []
    for m in index.modules:
        if not _in_scope(m.path):
            continue
        pads = _pad_consts(m)
        if not pads:
            continue
        masked_lines = {
            mk.line for mk in model.masks if mk.module.path == m.path
        }
        for fi in m.functions.values():
            carrying: set[str] = set()
            # sentinel-carrying locals, small fixpoint for chains;
            # a `where` whose condition tests the sentinel MASKS it
            # (the reassigned value is clean), as does any value
            # containing a sentinel comparison (it is a boolean mask)
            for _ in range(4):
                changed = False
                for node in ast.walk(fi.node):
                    if not (
                        isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                    ):
                        continue
                    name = node.targets[0].id
                    carries = any(
                        nm in pads or nm in carrying
                        for nm in _carry_names(node.value)
                    )
                    masked = _compares_pad(node.value, pads, carrying)
                    if carries and not masked:
                        if name not in carrying:
                            carrying.add(name)
                            changed = True
                    elif masked and name in carrying:
                        carrying.discard(name)
                        changed = True
                if not changed:
                    break
            replant = _replant_exempt(fi, pads)
            for node in ast.walk(fi.node):
                if isinstance(node, ast.BinOp) and isinstance(
                    node.op, _ARITH_OPS + (ast.FloorDiv, ast.Mod)
                ):
                    for side in (node.left, node.right):
                        if not isinstance(side, ast.Name):
                            continue
                        if side.id in pads:
                            out.append(Finding(
                                rule="G028", path=m.path,
                                line=node.lineno,
                                col=node.col_offset,
                                msg=(
                                    f"PAD/sentinel constant "
                                    f"`{side.id}` used directly in "
                                    f"arithmetic in `{fi.qualname}` — "
                                    "a sentinel is an out-of-band "
                                    "marker, not a number; mask it "
                                    "out first"
                                ),
                            ))
                        elif (
                            side.id in carrying
                            and node.lineno not in masked_lines
                            and id(node) not in replant
                        ):
                            out.append(Finding(
                                rule="G028", path=m.path,
                                line=node.lineno,
                                col=node.col_offset,
                                msg=(
                                    f"`{side.id}` may carry the PAD/"
                                    "sentinel value into arithmetic "
                                    f"in `{fi.qualname}` with no "
                                    "intervening mask — a surviving "
                                    "sentinel poisons every "
                                    "downstream sum; mask with a "
                                    "`where` testing the sentinel "
                                    "first"
                                ),
                            ))
                elif isinstance(node, ast.Compare) and any(
                    isinstance(op, _ORDER_OPS) for op in node.ops
                ):
                    operands = [node.left] + list(node.comparators)
                    if any(
                        isinstance(s, ast.Name) and s.id in pads
                        for s in operands
                    ):
                        continue  # comparison AGAINST the sentinel:
                        # the masking idiom itself
                    for side in operands:
                        if (
                            isinstance(side, ast.Name)
                            and side.id in carrying
                            and node.lineno not in masked_lines
                        ):
                            out.append(Finding(
                                rule="G028", path=m.path,
                                line=node.lineno,
                                col=node.col_offset,
                                msg=(
                                    f"`{side.id}` may carry the PAD/"
                                    "sentinel value into an ordering "
                                    f"comparison in `{fi.qualname}` — "
                                    "the sentinel orders arbitrarily; "
                                    "mask it out (or compare against "
                                    "the sentinel itself) first"
                                ),
                            ))
    return out


# ---------------------------------------------------------------------------
# G029 — ranges artifact cross-check
# ---------------------------------------------------------------------------


def g029_ranges_artifact(index: PackageIndex, artifact_path: str
                         ) -> list[Finding]:
    """Cross-validate the declared range model against a serve run's
    ``ranges`` counters (the range sanitizer's ground truth): a
    ``check=``-paired inrange fact or declared mask tag the run never
    counted is DEAD — the declaration is stale or the staging path
    moved; a runtime counter with no matching declaration is bounds
    activity the static model does not know about.  Dead-checking is
    scoped by armed surface (staging/fused/scan) exactly like G011
    fence tags and G025 machine surfaces."""
    block, err = load_artifact_block(artifact_path, "ranges")
    if block is None:
        return [Finding(
            rule="G029", path=artifact_path, line=0, col=0, msg=err,
        )]
    out: list[Finding] = []
    version = block.get("version")
    if version != 1:
        out.append(Finding(
            rule="G029", path=artifact_path, line=0, col=0,
            msg=(
                f"ranges block version {version!r} is not the schema "
                "this rule validates (want 1) — regenerate the "
                "artifact or update the cross-check together with "
                "the schema"
            ),
        ))
        return out
    checks = block.get("checks") or {}
    masks = block.get("masks") or {}
    model = build_range_model(index)
    base = artifact_path.replace("\\", "/").rpartition("/")[2]
    declared_checks: dict[str, RangeFact] = {}
    for fact in model.facts:
        if fact.check is not None and fact.check not in declared_checks:
            declared_checks[fact.check] = fact
    for name, fact in sorted(declared_checks.items()):
        if fact.surface not in block:
            out.append(Finding(
                rule="G029", path=fact.module.path, line=fact.line,
                col=0,
                msg=(
                    f"range check `{name}` is scoped to surface "
                    f"`{fact.surface}` but {base} records no such "
                    "surface — stale ranges schema or typo'd "
                    "surface; an unmatchable surface silently "
                    "disables the dead-fact check"
                ),
            ))
            continue
        if not block.get(fact.surface):
            continue  # surface not armed in this run
        if not checks.get(name):
            out.append(Finding(
                rule="G029", path=fact.module.path, line=fact.line,
                col=0,
                msg=(
                    f"declared range check `{name}` recorded zero "
                    f"dispatches in {base} (surface "
                    f"`{fact.surface}` armed) — dead fact: delete "
                    "the stale declaration or route the staging "
                    "path through its check_index() twin"
                ),
            ))
    declared_masks: dict[str, MaskDecl] = {}
    for mk in model.masks:
        if mk.tag not in declared_masks:
            declared_masks[mk.tag] = mk
    for tag, mk in sorted(declared_masks.items()):
        if mk.surface not in block:
            out.append(Finding(
                rule="G029", path=mk.module.path, line=mk.line, col=0,
                msg=(
                    f"mask `{tag}` is scoped to surface "
                    f"`{mk.surface}` but {base} records no such "
                    "surface — stale ranges schema or typo'd surface"
                ),
            ))
            continue
        if not block.get(mk.surface):
            continue
        if not masks.get(tag):
            out.append(Finding(
                rule="G029", path=mk.module.path, line=mk.line, col=0,
                msg=(
                    f"declared mask `{tag}` recorded zero dispatches "
                    f"in {base} (surface `{mk.surface}` armed) — "
                    "dead mask: the clamp region it consumes never "
                    "dispatched; delete the stale tag or note_mask() "
                    "the region"
                ),
            ))
    for name in sorted(checks):
        if name not in declared_checks:
            out.append(Finding(
                rule="G029", path=artifact_path, line=0, col=0,
                msg=(
                    f"runtime range check `{name}` has no matching "
                    "`# graftlint: inrange=... check=` declaration — "
                    "bounds activity the static model does not know "
                    "about"
                ),
            ))
    for tag in sorted(masks):
        if tag not in declared_masks:
            out.append(Finding(
                rule="G029", path=artifact_path, line=0, col=0,
                msg=(
                    f"runtime mask counter `{tag}` has no matching "
                    "`# graftlint: mask=` declaration — a masked "
                    "clamp region the static model does not know "
                    "about"
                ),
            ))
    return out
