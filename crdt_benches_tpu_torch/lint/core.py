"""graftlint core for the PyTorch port: file model, suppressions, rule
runner, reporters (the JAX package's ``lint/core.py``, with its marker
grammar, suppressions, reporters and exit-code gate).

graftlint is an AST-based hygiene linter (stdlib ``ast`` only: it runs
before anything heavy imports, and it imports neither torch nor jax).
The design is deliberately small:

- every ``.py`` file is parsed once into a :class:`ModuleInfo` (AST +
  per-function facts: boundary contracts, kernel bodies, hot-path /
  fence markers, suppression comments);
- the :class:`PackageIndex` aggregates modules so rules can resolve
  cross-module calls by name (best-effort, the repo's idiom is flat
  enough for this to work);
- each rule in :mod:`.rules` is a function
  ``rule(index) -> list[Finding]``;
- findings carrying a same-line ``# graftlint: disable=G00X`` (or a
  file-level ``# graftlint: disable-file=G00X``) are dropped.

The rules that read jnp and Pallas code (G001, G002, G004, G005, G009,
G026) have torch twins here; G003 and G010 guard jit retraces, the
Pallas import shim and Mosaic's lane blocks, which the port does not
have, and are not ported.  A function decorated with ``@kernel_body``
(``lint/sanitizer.py``: a kernel's plain version, which on the CPU is
the kernel) is a boundary of the G002 walk, as the runtime tripwire
treats it.

Marker comments (on the ``def`` line):

- ``# graftlint: hot-path`` — the function is a serving hot-path root:
  G002 walks its call graph for host syncs;
- ``# graftlint: fence`` — the function is a DECLARED sync boundary
  (e.g. the scheduler's boundary bucket pulls): G002 does not descend
  into it.  Fences are the allowlist — a new sync belongs behind one, or
  it is a bug.
- ``# graftlint: thread=<name>`` — the function (or, on a ``class``
  line, every method of the class) is OWNED by that host thread
  (``hot`` / ``status`` / ``bus`` / ``journal`` are the canonical
  roots).  The thread-confinement rules (G014/G015, lint/threads.py)
  propagate ownership along the call graph from these declarations;
  a mutable object shared across two owners must cross at a publish
  point.
- ``# graftlint: publish`` (optionally ``publish=<tag>``) — the
  function is a DECLARED cross-thread publish point: an atomic
  reference swap (or lock-guarded section) that hands an object from
  its owning thread to a reader thread.  The runtime twin
  (lint/race_sanitizer.py ``@published``) counts its entries; G017
  cross-validates the two like G011 does for fences.  A tag names the
  armed surface the point rides (``publish=status`` crosses only when
  the live status server runs) and scopes the dead-point accounting
  to artifacts whose run armed it.
- ``# graftlint: durable=<protocol>`` — the function is a DECLARED
  member of a multi-step durable commit protocol (``snapshot`` / ``gc``
  / ``wal`` / ``spool`` / ``flight``).  The crash-consistency rules
  (G018-G020, lint/fsops.py) build a per-protocol filesystem-effect
  sequence (write/fsync/replace/link/unlink over path-role symbols)
  from these declarations and check atomic-commit discipline, durable
  ordering, and verify-before-trust; the runtime twin
  (lint/fs_sanitizer.py ``fs_protocol``) counts entries and records
  the real op sequences, and G021 cross-validates the two like G011
  does for fences.

Fence tags (``# graftlint: fence=<tag>``) scope the G011 dead-fence
accounting against serve bench artifacts:

- bare ``fence`` — expected to cross in EVERY serve drain; a zero
  counter in a ``boundary_syncs`` artifact block is a G011 finding;
- ``fence=chaos`` — crosses only under fault injection; accounted only
  against chaos artifacts;
- ``fence=journal`` — crosses only with the write-ahead journal on;
  accounted only against journaled artifacts;
- ``fence=flight`` — crosses only when the flight recorder DUMPED
  (``boundary_syncs.flight``); even an armed recorder on a clean
  chaos run never enters it, so chaos-scoping would false-positive;
- ``fence=reshard`` — crosses only with a live-reshard coordinator
  bound (``boundary_syncs.reshard``); the per-round tick and the
  end-of-drain finalize are the two declared boundaries;
- ``fence=cold`` — an off-drain API boundary (direct pool calls from
  tests/tools): still a G002 barrier, never dead-fence accounted;
- ``fence=genesis`` — crosses only in a streamed drain (``LazyStreams``'
  two edges); accounted only against artifacts that record a streamed
  run (``lifecycle.stream``, the surface G025 scopes the stream machine
  by; an artifact without a ``lifecycle`` block dead-checks them as
  JAX's G011 does);
- any other tag is dead-checked like a bare ``fence``.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# configuration

#: G002 hot-path roots that hold even on an unannotated tree (qualnames).
DEFAULT_HOT_ROOTS = {
    "fleet_step",
    "DocPool.step",
    "DocPool.macro_step",
    "FleetScheduler.run_round",
}

#: Method names never linked by the bare-name call resolver (container /
#: stdlib traffic would otherwise swamp the call graph).
_GENERIC_METHODS = {
    "append", "add", "get", "pop", "popleft", "items", "keys", "values",
    "update", "extend", "sort", "clear", "copy", "discard", "remove",
    "insert", "index", "count", "join", "split", "strip", "format",
    "startswith", "endswith", "setdefault", "write", "read", "close",
    "open", "mkdir", "exists", "unlink", "encode", "decode", "flush",
    "reshape", "astype", "sum", "max", "min", "mean", "all", "any",
    "fire", "pick", "event", "describe", "bit_length", "put", "take",
    "dump", "dumps", "load", "loads",
}

#: Directories whose modules are in scope for G005 (implicit dtype) and
#: G006 (nondeterminism in journaled paths).
G005_DIRS = ("ops", "engine", "serve", "parallel", "traces")
G006_DIRS = ("serve",)
G006_FILES = ("tensorize.py",)

#: Torch tensor factories whose dtype follows torch's defaults when none
#: is passed (G005's twin), and what they make at module scope (G001's).
TORCH_CREATORS = {"zeros", "ones", "empty", "full", "arange", "tensor"}

#: Recognized dtype spellings for "an explicit dtype was passed".
DTYPE_NAMES = {
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "bfloat16", "bool_",
    "complex64", "complex128",
}

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Z0-9,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*graftlint:\s*disable-file=([A-Z0-9,\s]+)"
)
_MARKER_RE = re.compile(
    r"#\s*graftlint:\s*(hot-path|fence|publish|thread|durable)"
    r"(?:=([a-zA-Z0-9_-]+))?\b"
)

#: Recognized ``fence=<tag>`` spellings (see module docstring).
FENCE_TAGS = ("chaos", "journal", "flight", "reshard", "cold", "genesis")


def dotted(e: ast.expr) -> str | None:
    """``a.b.c`` as a string, or None for non-trivial expressions."""
    parts = []
    while isinstance(e, ast.Attribute):
        parts.append(e.attr)
        e = e.value
    if isinstance(e, ast.Name):
        parts.append(e.id)
        return ".".join(reversed(parts))
    return None


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    msg: str

    def key(self):
        return (self.path, self.line, self.rule, self.msg)


@dataclass
class FuncInfo:
    """Per-function facts extracted from the decorator stack + markers."""

    qualname: str  # "func" or "Class.method"
    node: ast.AST  # FunctionDef / AsyncFunctionDef
    module: "ModuleInfo"
    cls: str | None = None
    jitted: bool = False
    donate_argnums: tuple | None = None  # statically parsed, else None
    static_argnames: tuple = ()
    boundary: dict | None = None  # parsed @boundary(...) kwargs
    boundary_line: int = 0
    hot: bool = False
    fence: bool = False
    fence_tag: str | None = None  # None|"chaos"|"journal"|"flight"|"cold"
    publish: bool = False  # declared cross-thread publish point
    publish_tag: str | None = None  # armed-surface tag (e.g. "status")
    thread: str | None = None  # declared owning thread (or class's)
    durable: bool = False  # declared durable-commit-protocol member
    protocol: str | None = None  # snapshot|gc|wal|spool|flight
    kernel_body: bool = False  # @kernel_body: a kernel's plain version

    @property
    def params(self) -> list[str]:
        a = self.node.args
        return [p.arg for p in (a.posonlyargs + a.args)]


class ModuleInfo:
    def __init__(self, path: str, src: str):
        self.path = path
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        self.suppress: dict[int, set[str]] = {}
        self.suppress_file: set[str] = set()
        self.jnp_aliases: set[str] = set()  # names bound to jax.numpy
        self.torch_aliases: set[str] = set()  # names bound to torch
        self.np_aliases: set[str] = set()  # names bound to numpy
        self.time_aliases: set[str] = set()  # names bound to time
        self.random_aliases: set[str] = set()  # stdlib random module
        self.imports: dict[str, str] = {}  # local name -> dotted source
        #: local name -> root module, for absolute imports only
        self.abs_roots: dict[str, str] = {}
        self.functions: dict[str, FuncInfo] = {}
        self.class_threads: dict[str, str] = {}  # class -> thread marker
        self.class_bases: dict[str, list[str]] = {}  # class -> base names
        self._scan_comments()
        self._scan_imports()
        self._scan_functions()

    # -- comments ----------------------------------------------------------

    def _scan_comments(self) -> None:
        """Directives live in REAL comments only (tokenize, not line
        regex): a docstring that *documents* the escape hatch must not
        trigger it."""
        self.comments: dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                io.StringIO(self.src).readline
            ):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError):
            pass  # ast.parse already surfaced the syntax problem
        for i, text in self.comments.items():
            m = _SUPPRESS_RE.search(text)
            if m:
                self.suppress.setdefault(i, set()).update(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
            m = _SUPPRESS_FILE_RE.search(text)
            if m:
                self.suppress_file.update(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )

    def _markers(self, lineno: int) -> list[tuple[str, str | None]]:
        """All ``# graftlint: <marker>`` directives on one line (a def
        line may carry several, e.g. ``publish=status`` + ``thread=hot``
        — each with its own ``graftlint:`` prefix)."""
        return [
            (m.group(1), m.group(2))
            for m in _MARKER_RE.finditer(self.comments.get(lineno, ""))
        ]

    # -- imports -----------------------------------------------------------

    def _scan_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    name = al.asname or al.name.split(".")[0]
                    self.imports[name] = al.name
                    self.abs_roots[name] = al.name.split(".")[0]
                    if al.name == "jax.numpy":
                        self.jnp_aliases.add(al.asname or "jax.numpy")
                    elif al.name == "numpy":
                        self.np_aliases.add(al.asname or "numpy")
                    elif al.name == "torch":
                        self.torch_aliases.add(al.asname or "torch")
                    elif al.name == "time":
                        self.time_aliases.add(al.asname or "time")
                    elif al.name == "random":
                        self.random_aliases.add(al.asname or "random")
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for al in node.names:
                    local = al.asname or al.name
                    self.imports[local] = f"{mod}.{al.name}"
                    if node.level == 0 and mod:
                        self.abs_roots[local] = mod.split(".")[0]
                    if mod == "jax" and al.name == "numpy":
                        self.jnp_aliases.add(local)

    # -- functions ---------------------------------------------------------

    def _scan_functions(self) -> None:
        def visit(node, cls: str | None):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    self.class_bases[child.name] = [
                        b for b in (dotted(e) for e in child.bases)
                        if b is not None
                    ]
                    for kind, tag in self._markers(child.lineno):
                        if kind == "thread" and tag:
                            self.class_threads[child.name] = tag
                    visit(child, child.name)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qual = (
                        f"{cls}.{child.name}" if cls else child.name
                    )
                    self.functions[qual] = self._func_info(
                        child, qual, cls
                    )
                    # nested defs are part of the enclosing body for
                    # sync scanning; they are not indexed separately.

        visit(self.tree, None)

    def _func_info(self, node, qual: str, cls: str | None) -> FuncInfo:
        fi = FuncInfo(qualname=qual, node=node, module=self, cls=cls)
        for kind, tag in self._markers(node.lineno):
            if kind == "hot-path":
                fi.hot = True
            elif kind == "fence":
                fi.fence = True
                fi.fence_tag = tag
            elif kind == "publish":
                fi.publish = True
                fi.publish_tag = tag
            elif kind == "thread" and tag:
                fi.thread = tag
            elif kind == "durable":
                fi.durable = True
                fi.protocol = tag
        if fi.thread is None and cls is not None:
            fi.thread = self.class_threads.get(cls)
        for dec in node.decorator_list:
            self._parse_decorator(fi, dec)
        return fi

    def _parse_decorator(self, fi: FuncInfo, dec: ast.expr) -> None:
        # @kernel_body (lint/sanitizer.py)
        if dotted(dec) is not None and dotted(dec).split(".")[-1] == \
                "kernel_body":
            fi.kernel_body = True
            return
        # @jax.jit / @jit
        if self._is_jit_expr(dec):
            fi.jitted = True
            if fi.donate_argnums is None:
                fi.donate_argnums = ()
            return
        if not isinstance(dec, ast.Call):
            return
        # @partial(jax.jit, ...) or @functools.partial(jax.jit, ...)
        f = dec.func
        fname = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if fname == "partial" and dec.args and self._is_jit_expr(
            dec.args[0]
        ):
            fi.jitted = True
            fi.donate_argnums = ()
            for kw in dec.keywords:
                if kw.arg == "donate_argnums":
                    fi.donate_argnums = self._literal_tuple(kw.value)
                elif kw.arg == "static_argnames":
                    v = self._literal_tuple(kw.value)
                    fi.static_argnames = v or ()
            return
        # @jax.jit(...) used directly as a decorator factory
        if self._is_jit_expr(f):
            fi.jitted = True
            fi.donate_argnums = ()
            for kw in dec.keywords:
                if kw.arg == "donate_argnums":
                    fi.donate_argnums = self._literal_tuple(kw.value)
                elif kw.arg == "static_argnames":
                    fi.static_argnames = self._literal_tuple(kw.value) or ()
            return
        # @boundary(...)
        if fname == "boundary":
            spec: dict = {}
            for kw in dec.keywords:
                if kw.arg in ("dtypes", "shapes", "donates"):
                    spec[kw.arg] = self._literal_tuple(kw.value)
            fi.boundary = spec
            fi.boundary_line = dec.lineno

    @staticmethod
    def _is_jit_expr(e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id == "jit"
        return (
            isinstance(e, ast.Attribute)
            and e.attr == "jit"
            and isinstance(e.value, ast.Name)
            and e.value.id == "jax"
        )

    @staticmethod
    def _literal_tuple(e: ast.expr):
        """A decorator kwarg as a tuple of literals, or None when it is
        not statically evaluable (rules then skip the comparison)."""
        try:
            v = ast.literal_eval(e)
        except (ValueError, TypeError, SyntaxError):
            return None
        if isinstance(v, (list, tuple)):
            return tuple(v)
        return (v,)

    # -- helpers for rules -------------------------------------------------

    def is_jnp_attr(self, e: ast.expr) -> str | None:
        """'zeros' for an expression like ``jnp.zeros`` (any alias)."""
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            if e.value.id in self.jnp_aliases:
                return e.attr
        return None

    def is_torch_attr(self, e: ast.expr) -> str | None:
        """'zeros' for an expression like ``torch.zeros`` (any alias)."""
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            if e.value.id in self.torch_aliases:
                return e.attr
        return None

    def is_torch_call(self, e: ast.expr) -> bool:
        """A ``torch.*`` call, or a method chain ending on one
        (``torch.arange(n).long()``)."""
        while isinstance(e, ast.Call):
            if self.is_torch_attr(e.func) is not None:
                return True
            if not isinstance(e.func, ast.Attribute):
                return False
            e = e.func.value
        return False

    def tensor_locals(self, fn: ast.AST) -> set[str]:
        """Names ``fn`` binds (plainly, or by tuple unpacking) to a torch
        call's result."""
        out = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and self.is_torch_call(
                node.value
            ):
                for t in node.targets:
                    for leaf in (t.elts if isinstance(t, ast.Tuple)
                                 else [t]):
                        if isinstance(leaf, ast.Name):
                            out.add(leaf.id)
        return out

    def is_np_attr(self, e: ast.expr) -> str | None:
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            if e.value.id in self.np_aliases:
                return e.attr
        return None

    def dotted(self, e: ast.expr) -> str | None:
        """``a.b.c`` as a string, or None for non-trivial expressions."""
        return dotted(e)


class PackageIndex:
    """All parsed modules + name-based cross-module call resolution."""

    def __init__(self, modules: list[ModuleInfo]):
        self.modules = modules
        self.by_name: dict[str, list[FuncInfo]] = {}
        self.methods: dict[str, dict[str, list[FuncInfo]]] = {}
        # subclass edges by bare class name (suffix-matched bases, so
        # `scheduler.FleetScheduler` links like `FleetScheduler`)
        self.subclasses: dict[str, set[str]] = {}
        self.bases: dict[str, set[str]] = {}  # reverse: class -> bases
        #: every directory and module name of the linted tree: an import
        #: whose root is none of them comes from outside it
        self._local_names = {
            os.path.splitext(part)[0]
            for m in modules for part in m.path.replace(os.sep, "/")
            .split("/")}
        self._foreign: dict[tuple[str, str], set[str]] = {}
        for m in modules:
            for fi in m.functions.values():
                bare = fi.qualname.split(".")[-1]
                self.by_name.setdefault(bare, []).append(fi)
                if fi.cls:
                    self.methods.setdefault(fi.cls, {}).setdefault(
                        bare, []
                    ).append(fi)
            for cls, bases in m.class_bases.items():
                for b in bases:
                    self.subclasses.setdefault(
                        b.split(".")[-1], set()
                    ).add(cls)
                    self.bases.setdefault(cls, set()).add(
                        b.split(".")[-1]
                    )

    def _descendants(self, cls: str) -> set[str]:
        out: set[str] = set()
        queue = [cls]
        while queue:
            c = queue.pop()
            for sub in self.subclasses.get(c, ()):
                if sub not in out:
                    out.add(sub)
                    queue.append(sub)
        return out

    def _ancestors(self, cls: str) -> list[str]:
        out: list[str] = []
        seen = {cls}
        queue = [cls]
        while queue:
            for b in sorted(self.bases.get(queue.pop(), ())):
                if b not in seen:
                    seen.add(b)
                    out.append(b)
                    queue.append(b)
        return out

    def override_methods(self, cls: str, name: str) -> list[FuncInfo]:
        """Every subclass override of ``cls.name`` in the index — a
        ``self.m()`` call in a hot-path root dispatches to the override
        when the subclass runs (ReplicatedScheduler's ``_plan`` /
        ``_deliver`` bus tick), so the hot-path walks must cover them,
        not just the statically enclosing class."""
        out = []
        for sub in sorted(self._descendants(cls)):
            out.extend(self.methods.get(sub, {}).get(name, []))
        return out

    def _foreign_attrs(self, m: ModuleInfo, cls: str) -> set[str]:
        """The ``self.X`` attributes of ``cls`` that only ever hold None
        or an object built by a callable imported from outside the linted
        tree (``self._prof = profile(...)``, ``profile`` from
        ``torch.profiler``): a method called on one is the library's and
        links to no package function of the same name.  The port's one
        change to JAX's resolver."""
        key = (m.path, cls)
        if key in self._foreign:
            return self._foreign[key]
        values: dict[str, list[ast.expr | None]] = {}

        def store(t, v):
            if isinstance(t, (ast.Tuple, ast.List)):
                pair = (isinstance(v, (ast.Tuple, ast.List))
                        and len(v.elts) == len(t.elts))
                for i, sub in enumerate(t.elts):
                    store(sub, v.elts[i] if pair else None)
            elif (isinstance(t, ast.Attribute)
                  and isinstance(t.value, ast.Name) and t.value.id == "self"):
                values.setdefault(t.attr, []).append(v)

        for fi in m.functions.values():
            if fi.cls != cls:
                continue
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        store(t, node.value)
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    store(node.target, None)

        def built_outside(v) -> bool:
            d = dotted(v.func) if isinstance(v, ast.Call) else None
            root = m.abs_roots.get(d.split(".")[0]) if d else None
            return root is not None and root not in self._local_names

        out = {
            a for a, vs in values.items()
            if any(built_outside(v) for v in vs)
            and all(built_outside(v) or (isinstance(v, ast.Constant)
                                         and v.value is None) for v in vs)
        }
        self._foreign[key] = out
        return out

    def resolve_call(self, call: ast.Call, fi: FuncInfo,
                     strict: bool = False) -> list[FuncInfo]:
        """Best-effort callee resolution (see module docstring).

        ``strict=True`` keeps only the confident edges — same-module /
        named-import functions and ``self.m()`` dispatch (subclass
        overrides included) — and drops the any-receiver bare-name
        fan-out.  The fan-out is tuned for recall (a missed host sync
        is a silent stall, so G002 wants every plausible edge); thread-
        ownership propagation needs precision instead — one generic
        method name shared between a status handler and the scheduler
        would fuse the two thread roots and mark half the package
        bilaterally owned."""
        f = call.func
        if isinstance(f, ast.Name):
            m = fi.module
            if f.id in m.functions:
                return [m.functions[f.id]]
            # from .sibling import helper
            src = m.imports.get(f.id)
            if src is not None:
                bare = src.split(".")[-1]
                return [
                    g for g in self.by_name.get(bare, [])
                    if g.cls is None
                ]
            return []
        if isinstance(f, ast.Attribute):
            name = f.attr
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                if fi.cls:
                    own = fi.module.functions.get(f"{fi.cls}.{name}")
                    if own is not None:
                        # the defining method PLUS every subclass
                        # override virtual dispatch could select
                        return [own] + self.override_methods(
                            fi.cls, name
                        )
                    # inherited: `self.m()` where m lives on an
                    # ancestor class — dispatch UP the hierarchy to
                    # the defining method, then back down through the
                    # overrides of the CALLING class (still a
                    # confident edge: the receiver is self)
                    for anc in self._ancestors(fi.cls):
                        inherited = self.methods.get(anc, {}).get(name)
                        if inherited:
                            return list(inherited) + \
                                self.override_methods(fi.cls, name)
            if strict or name in _GENERIC_METHODS:
                return []
            recv = f.value
            if (fi.cls and isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id == "self"
                    and recv.attr in self._foreign_attrs(fi.module, fi.cls)):
                return []
            # obj.method(...): link every same-named package function —
            # conservative, fences/suppressions handle the rare FP.
            return self.by_name.get(name, [])
        return []


def hot_roots(index: PackageIndex) -> list[FuncInfo]:
    """The serving hot-path roots: ``# graftlint: hot-path`` markers
    plus the built-in qualname set."""
    return [
        fi for m in index.modules for fi in m.functions.values()
        if fi.hot or fi.qualname in DEFAULT_HOT_ROOTS
    ]


def walk_hot_scope(index: PackageIndex, *, descend_fences: bool):
    """THE hot-path call-graph walker shared by G002/G012/G013/G016:
    yields ``(fi, chain)`` for every function reachable from the hot
    roots via :meth:`PackageIndex.resolve_call` (subclass overrides of
    ``self.m()`` dispatches included).  ``descend_fences=False`` is the
    G002 shape (fences are declared sync boundaries and kernel bodies
    stand for their kernels: the walk stops at both); the hygiene rules
    (G012/G013/G016) descend — being behind a
    sync boundary does not make a mid-drain socket, a per-round series
    registration, or a blocking wait acceptable."""
    seen: set[int] = set()
    queue: list[tuple[FuncInfo, str]] = [
        (r, f"reached from {r.qualname}") for r in hot_roots(index)
    ]
    while queue:
        fi, chain = queue.pop()
        if id(fi) in seen:
            continue
        seen.add(id(fi))
        if not descend_fences and (fi.fence or fi.kernel_body):
            continue
        yield fi, chain
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                for callee in index.resolve_call(node, fi):
                    if id(callee) not in seen:
                        queue.append(
                            (callee, f"{chain} -> {callee.qualname}")
                        )


# ---------------------------------------------------------------------------
# the run

#: Directory names pruned from directory walks: the fixture corpus is
#: INTENTIONALLY dirty (linting ``tests/`` must not fail on it).  A
#: fixture file passed as an explicit path still lints.
_WALK_PRUNE = ("__pycache__", "lint_fixtures")


def collect_files(paths: list[str]) -> tuple[list[str], list[Finding]]:
    """Expand paths to .py files.  A target that does not exist (or
    names no Python file at all) is a G000 finding, NOT a silent skip —
    a typo'd path in a CI script must fail the gate, never turn it
    permanently green."""
    out, errors = [], []
    for p in paths:
        if os.path.isdir(p):
            n0 = len(out)
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if not d.startswith(".") and d not in _WALK_PRUNE
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
            if len(out) == n0:
                errors.append(Finding(
                    rule="G000", path=p, line=0, col=0,
                    msg=(
                        "lint target directory contains no .py files — "
                        "refusing to report a clean run on nothing"
                    ),
                ))
        elif os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        else:
            errors.append(Finding(
                rule="G000", path=p, line=0, col=0,
                msg=(
                    "lint target does not exist or is not a .py "
                    "file/directory — refusing to report a clean run "
                    "on nothing"
                ),
            ))
    return out, errors


def build_index(paths: list[str]) -> tuple[PackageIndex, list[Finding]]:
    files, errors = collect_files(paths)
    modules = []
    for path in files:
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            modules.append(ModuleInfo(path, src))
        except SyntaxError as e:
            errors.append(Finding(
                rule="G000", path=path, line=e.lineno or 0, col=0,
                msg=f"syntax error: {e.msg}",
            ))
        except OSError as e:
            errors.append(Finding(
                rule="G000", path=path, line=0, col=0,
                msg=f"unreadable: {e}",
            ))
    return PackageIndex(modules), errors


#: Artifact-driven rules: rule id -> (keyword, CLI flag) of the runtime
#: ground truth it cross-checks; without an artifact the rule is
#: skipped (nothing to validate against), and explicitly selecting it
#: without one is a G000 failure, never a silent no-op.
ARTIFACT_RULES = {
    "G011": ("sync_artifact", "--sync-artifact"),
    "G017": ("thread_artifact", "--thread-artifact"),
    "G021": ("fs_artifact", "--fs-artifact"),
    "G025": ("lifecycle_artifact", "--lifecycle-artifact"),
    "G029": ("ranges_artifact", "--ranges-artifact"),
}


def run_lint(paths: list[str], select: set[str] | None = None,
             sync_artifact: str | None = None,
             thread_artifact: str | None = None,
             fs_artifact: str | None = None,
             lifecycle_artifact: str | None = None,
             ranges_artifact: str | None = None) -> list[Finding]:
    """Run the rule suite over ``paths``.  ``sync_artifact`` names a
    serve bench artifact (or raw ``boundary_syncs`` JSON) to enable the
    G011 fence-cost cross-check — without it G011 is skipped (it has no
    runtime ground truth to compare the static fence graph against).
    ``thread_artifact`` is the same for G017's ``thread_crossings``
    publish-point cross-check (usually the same artifact file);
    ``fs_artifact`` for G021's ``fs_ops`` durable-protocol cross-check
    (the fs sanitizer's per-protocol op counters);
    ``lifecycle_artifact`` for G025's ``lifecycle`` machine/resource
    cross-check (the lifecycle sanitizer's transition and
    acquire/release counters); ``ranges_artifact`` for G029's
    ``ranges`` bounds cross-check (the range sanitizer's index-check
    and clamp-mask dispatch counters)."""
    from . import rules as _rules

    artifacts = {
        "sync_artifact": sync_artifact,
        "thread_artifact": thread_artifact,
        "fs_artifact": fs_artifact,
        "lifecycle_artifact": lifecycle_artifact,
        "ranges_artifact": ranges_artifact,
    }
    index, findings = build_index(paths)
    for rule_id, fn in _rules.RULES.items():
        if select and rule_id not in select:
            continue
        if rule_id in ARTIFACT_RULES:
            kw, flag = ARTIFACT_RULES[rule_id]
            artifact = artifacts[kw]
            if artifact is not None:
                findings.extend(fn(index, artifact))
            elif select and rule_id in select:
                # explicitly selecting the rule with no ground truth
                # must FAIL, not no-op: a dropped artifact flag in a CI
                # script would otherwise turn the gate permanently green
                findings.append(Finding(
                    rule="G000", path=f"<{rule_id}>", line=0, col=0,
                    msg=(
                        f"{rule_id} selected but no {flag} given — "
                        "the cross-check has no runtime counters to "
                        "validate against"
                    ),
                ))
            continue
        findings.extend(fn(index))
    # apply suppressions
    by_path = {m.path: m for m in index.modules}
    out = []
    for f in findings:
        if select and f.rule not in select and f.rule != "G000":
            continue
        m = by_path.get(f.path)
        if m is not None:
            if f.rule in m.suppress_file:
                continue
            if f.rule in m.suppress.get(f.line, ()):
                continue
        out.append(f)
    out.sort(key=Finding.key)
    # de-dup (the bare-name resolver can reach a function twice)
    seen, uniq = set(), []
    for f in out:
        if f.key() not in seen:
            seen.add(f.key())
            uniq.append(f)
    return uniq


# ---------------------------------------------------------------------------
# reporters

def format_text(findings: list[Finding]) -> str:
    lines = [
        f"{f.path}:{f.line}:{f.col}: {f.rule} {f.msg}" for f in findings
    ]
    lines.append(
        f"graftlint: {len(findings)} finding(s)"
        if findings else "graftlint: clean"
    )
    return "\n".join(lines)


def format_json(findings: list[Finding]) -> str:
    return json.dumps(
        {
            "findings": [
                {
                    "rule": f.rule, "path": f.path, "line": f.line,
                    "col": f.col, "message": f.msg,
                }
                for f in findings
            ],
            "count": len(findings),
        },
        indent=2,
    )


def format_sarif(findings: list[Finding]) -> str:
    """SARIF 2.1.0 (the schema CI annotation surfaces ingest).  One
    run, one result per finding; ``level`` is always ``error`` — the
    exit-code gate treats every finding as fatal, SARIF must not paint
    a softer picture.  Artifact-level findings carry line 0; SARIF
    regions are 1-based, so those clamp to line 1."""
    rules = sorted({f.rule for f in findings})
    return json.dumps(
        {
            "$schema": (
                "https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"
            ),
            "version": "2.1.0",
            "runs": [{
                "tool": {"driver": {
                    "name": "graftlint",
                    "rules": [{"id": r} for r in rules],
                }},
                "results": [
                    {
                        "ruleId": f.rule,
                        "level": "error",
                        "message": {"text": f.msg},
                        "locations": [{
                            "physicalLocation": {
                                "artifactLocation": {"uri": f.path},
                                "region": {
                                    "startLine": max(1, f.line),
                                    "startColumn": max(1, f.col + 1),
                                },
                            },
                        }],
                    }
                    for f in findings
                ],
            }],
        },
        indent=2,
    )
