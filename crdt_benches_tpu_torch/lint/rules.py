"""graftlint rules for the PyTorch port, G001-G029 but G003 and G010.

Each rule is ``fn(index: PackageIndex) -> list[Finding]`` and is
registered in :data:`RULES`.  The rules that read no jnp or Pallas code
(G006-G008, G011-G025, G027-G029) are the JAX package's, ported as they
were: on the same files they give the same findings.  G001, G002, G004,
G005 and G026 are torch twins of the JAX rules (the hazard each encodes,
in the port's idiom), and G009's twin (:mod:`.launch_rules`) checks the
port's launch boundary, the ctypes entries of ``csrc/*.cu`` against
``_build.py SIGNATURES``.  G008 lives in :mod:`.flow`, the thread
suite G014-G017 in :mod:`.threads`, the durable-protocol suite G018-G021
in :mod:`.fsops`, the lifecycle suite G022-G025 in :mod:`.lifecycle`,
the range suite G026-G029 in :mod:`.ranges`.  G011 (below), G017, G021,
G025 and G029 cross-validate the static model against a serve bench
artifact's blocks and run only when a caller hands them one.

G003 (retraces from jitted bodies, the Pallas-TPU import shim, unhashable
jit statics) and G010 (Mosaic's 128-lane VMEM blocks) are not ported:
the port has no jit, no Pallas and no VMEM blocks.
"""

from __future__ import annotations

import ast
import os

from .core import (
    DTYPE_NAMES,
    G005_DIRS,
    G006_DIRS,
    G006_FILES,
    TORCH_CREATORS,
    Finding,
    FuncInfo,
    PackageIndex,
    dotted,
    walk_hot_scope,
)
from .flow import g008_shape_drift
from .fsops import (
    g018_atomic_commit,
    g019_durable_ordering,
    g020_verify_before_trust,
    g021_fs_protocols,
)
from .launch_rules import g009_launch_boundary
from .lifecycle import (
    g022_state_discipline,
    g023_acquire_release,
    g024_identity_hazards,
    g025_lifecycle_artifact,
)
from .ranges import (
    g026_index_guard,
    g027_narrow_overflow,
    g028_pad_flow,
    g029_ranges_artifact,
)
from .threads import (
    g014_shared_escape,
    g015_publish_discipline,
    g016_blocking_hot_thread,
    g017_thread_crossings,
)

#: What G001's twin counts as making a tensor at module scope.
_TORCH_TENSOR_MAKERS = TORCH_CREATORS | {
    "as_tensor", "from_numpy", "linspace", "eye", "rand", "randn",
    "randint", "zeros_like", "ones_like", "full_like", "empty_like",
}

_NP_LEGACY_RANDOM = {
    "seed", "rand", "randn", "randint", "random", "choice", "shuffle",
    "permutation", "uniform", "normal", "sample",
}

_JOURNAL_SINKS = {
    "round_record", "event", "write_snapshot", "tensorize_ranges",
}


def _in_dirs(path: str, dirs: tuple, files: tuple = ()) -> bool:
    parts = path.replace("\\", "/").split("/")
    return any(d in parts for d in dirs) or any(
        path.endswith(f) for f in files
    )


def _explicit_dtype_name(call: ast.Call) -> str | None:
    """The dtype NAME a creation call passes explicitly, if literal."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            if isinstance(kw.value, ast.Attribute):
                return kw.value.attr
            if isinstance(kw.value, ast.Constant) and isinstance(
                kw.value.value, str
            ):
                return kw.value.value
            return None
    for a in call.args:
        if isinstance(a, ast.Attribute) and a.attr in DTYPE_NAMES:
            return a.attr
    return None


# ---------------------------------------------------------------------------
# G001 — module-scope tensor constants

def g001_module_tensor(index: PackageIndex) -> list[Finding]:
    """A module-scope ``torch.*`` tensor is state created at import: it
    lives on the CPU, so every CUDA use copies it from the host (a
    hidden synchronous upload a call), and it is shared by every caller
    and thread (an in-place op on it changes every later call).  Keep a
    host int or numpy value and build the tensor where it is used, on
    the operands' device (the twin of JAX's module-level device
    constant, the idpos ``BIG`` tracer leak)."""
    out = []
    for m in index.modules:
        for node in ast.iter_child_nodes(m.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            if value is None:
                continue
            hit = None
            for sub in ast.walk(value):
                if isinstance(sub, ast.Call) and m.is_torch_attr(
                    sub.func
                ) in _TORCH_TENSOR_MAKERS:
                    hit = m.dotted(sub.func)
                    break
            if hit is None:
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            out.append(Finding(
                rule="G001", path=m.path, line=node.lineno,
                col=node.col_offset,
                msg=(
                    f"module-level tensor `{' = '.join(names) or '<target>'}"
                    f" = {hit}(...)` — state created at import, on the "
                    "CPU: every CUDA use copies it from the host and "
                    "every caller shares it; keep a host value and "
                    "build the tensor on the operands' device"
                ),
            ))
    return out


# ---------------------------------------------------------------------------
# G002 — host sync reachable from the serving hot path

#: Tensor methods that always make the host wait for the device.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_NP_SYNC_FUNCS = {"asarray", "array"}
#: Tensor copies that wait for the device unless asked not to.
_COPY_METHODS = {"to", "cuda", "copy_"}
#: Host tensors: a copy from one is a pageable upload.
_HOST_TENSOR_FUNCS = {"from_numpy", "as_tensor", "tensor"}


def _tensor_like(e: ast.expr, fi: FuncInfo, locals_: set[str]) -> bool:
    """Does ``e`` plausibly hold a device tensor: a pool ``state``, a
    ``torch.*`` call, or a local bound to one?"""
    m = fi.module
    for s in ast.walk(e):
        if isinstance(s, ast.Attribute) and s.attr == "state":
            return True
        if isinstance(s, ast.Call) and m.is_torch_attr(s.func):
            return True
        if isinstance(s, ast.Name) and s.id in locals_:
            return True
    return False


def _device_like(e: ast.expr, m) -> bool:
    """A ``.to()`` argument naming a device (not a dtype)."""
    if isinstance(e, ast.Constant) and isinstance(e.value, str):
        return e.value.split(":")[0] in ("cuda", "cpu")
    if isinstance(e, ast.Call):
        return m.is_torch_attr(e.func) == "device"
    d = dotted(e)
    tail = d.split(".")[-1] if d else ""
    return tail in ("dev", "device", "devices") or tail.endswith(
        "_device") or tail.endswith("_dev")


def _non_blocking(call: ast.Call) -> bool:
    return any(
        kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
        and kw.value.value is True for kw in call.keywords
    )


def _host_tensor(e: ast.expr, m, hosts: set[str]) -> bool:
    """Is ``e`` a host tensor in pageable memory (made by
    ``torch.from_numpy``/``as_tensor``/``tensor`` here or bound to one)?"""
    if isinstance(e, ast.Name):
        return e.id in hosts
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
            and e.func.attr in ("to", "cuda"):
        return False  # the copy's result lives on the device
    return any(
        isinstance(s, ast.Call)
        and m.is_torch_attr(s.func) in _HOST_TENSOR_FUNCS
        for s in ast.walk(e)
    )


def _host_locals(fi: FuncInfo) -> set[str]:
    """Names the function binds to a host tensor maker's result."""
    m = fi.module
    out = set()
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Assign) and _host_tensor(node.value, m,
                                                         set()):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _sync_findings(fi: FuncInfo, index: PackageIndex, chain: str
                   ) -> list[Finding]:
    m = fi.module
    out = []
    locals_ = hosts = None

    def add(node, msg):
        out.append(Finding(rule="G002", path=m.path, line=node.lineno,
                           col=node.col_offset, msg=msg))

    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            add(node, f"host sync `.{f.attr}()` on the serving hot path "
                f"({chain}); move it behind a declared fence "
                "(# graftlint: fence)")
            continue
        if isinstance(f, ast.Attribute) and f.attr in _COPY_METHODS \
                and not _non_blocking(node):
            if hosts is None:
                hosts = _host_locals(fi)
            args = list(node.args) + [
                kw.value for kw in node.keywords if kw.arg == "device"]
            up = _host_tensor(f.value, m, hosts)
            blocking = (
                (f.attr == "cuda" and up)
                or (f.attr == "to" and up and any(_device_like(a, m)
                                                  for a in args))
                or (f.attr == "copy_" and any(_host_tensor(a, m, hosts)
                                              for a in node.args))
            )
            if blocking:
                add(node, f"blocking `.{f.attr}(...)` copy on the serving "
                    f"hot path ({chain}): from pageable memory it waits "
                    "for the device; pass non_blocking=True or move it "
                    "behind a fence")
                continue
        np_attr = m.is_np_attr(f)
        if np_attr in _NP_SYNC_FUNCS and node.args:
            if locals_ is None:
                locals_ = m.tensor_locals(fi.node)
            if _tensor_like(node.args[0], fi, locals_):
                add(node, f"`np.{np_attr}(...)` of a tensor on the "
                    f"serving hot path ({chain}): a device->host copy; "
                    "keep host staging in numpy or move behind a fence")
            continue
        if (
            isinstance(f, ast.Name)
            and f.id in ("int", "float", "bool")
            and len(node.args) == 1
        ):
            if locals_ is None:
                locals_ = m.tensor_locals(fi.node)
            if _tensor_like(node.args[0], fi, locals_):
                add(node, f"`{f.id}(...)` of a tensor forces a device sync "
                    f"on the serving hot path ({chain})")
    return out


def g002_host_sync(index: PackageIndex) -> list[Finding]:
    """Walk the call graph from the serving hot-path roots
    (``# graftlint: hot-path`` markers + the built-in root set, with
    ``self.m()`` dispatches covering subclass overrides) and flag the
    calls that make the host wait for the device: ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.synchronize()``
    (``torch.cuda.synchronize`` included), ``np.asarray``/``np.array``
    and ``int``/``float``/``bool`` of a tensor, and a blocking
    ``.to(device)``/``.cuda()``/``.copy_(host tensor)`` without
    ``non_blocking=True``.  Functions marked ``# graftlint: fence`` are
    DECLARED sync boundaries and ``@kernel_body`` functions stand for
    their kernels: the walk does not descend into either."""
    out: list[Finding] = []
    for fi, chain in walk_hot_scope(index, descend_fences=False):
        out.extend(_sync_findings(fi, index, chain))
    return out


# ---------------------------------------------------------------------------
# G004 — a tensor read after a call wrote it in place

def _collect_assign_lines(fn_node: ast.AST) -> dict[str, list[int]]:
    lines: dict[str, list[int]] = {}
    for node in ast.walk(fn_node):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        elif isinstance(node, ast.For):
            targets = [node.target]
        for t in targets:
            for leaf in ast.walk(t):
                if isinstance(leaf, (ast.Name, ast.Attribute)):
                    s = dotted(leaf)
                    if s:
                        lines.setdefault(s, []).append(node.lineno)
    return lines


def g004_inplace_misuse(index: PackageIndex) -> list[Finding]:
    """The port's ``@boundary(donates=...)`` names the arguments a call
    writes IN PLACE (JAX's donation, where the buffer dies, becomes an
    overwrite here): after the call the variable holds the new values,
    so a later read of it in the same body, unless rebound first, reads
    the post-call state where the code was written against the old one.
    Read the call's result, or clone before the call."""
    out = []
    for m in index.modules:
        for fi in m.functions.values():
            assigns = None
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in index.resolve_call(node, fi):
                    if not (callee.boundary
                            and callee.boundary.get("donates")):
                        continue
                    donated = set(callee.boundary["donates"])
                    offset = 0
                    if (
                        callee.cls
                        and callee.params
                        and callee.params[0] == "self"
                        and isinstance(node.func, ast.Attribute)
                    ):
                        offset = 1
                    for d in sorted(donated):
                        i = d - offset
                        if not 0 <= i < len(node.args):
                            continue
                        expr = m.dotted(node.args[i])
                        if expr is None:
                            continue
                        if assigns is None:
                            assigns = _collect_assign_lines(fi.node)
                        rebinds = [
                            ln for ln in assigns.get(expr, ())
                            if ln >= node.lineno
                        ]
                        call_end = getattr(node, "end_lineno", node.lineno)
                        for read in ast.walk(fi.node):
                            if not isinstance(
                                read, (ast.Name, ast.Attribute)
                            ):
                                continue
                            if not isinstance(
                                getattr(read, "ctx", None), ast.Load
                            ):
                                continue
                            # the call's own argument expressions are
                            # not "later" reads
                            if read.lineno <= call_end:
                                continue
                            if m.dotted(read) != expr:
                                continue
                            if any(
                                node.lineno <= ln <= read.lineno
                                for ln in rebinds
                            ):
                                continue
                            out.append(Finding(
                                rule="G004", path=m.path,
                                line=read.lineno, col=read.col_offset,
                                msg=(
                                    f"`{expr}` read after "
                                    f"`{callee.qualname}` wrote it in "
                                    f"place (line {node.lineno}) — it "
                                    "holds the post-call values; read "
                                    "the result or clone first"
                                ),
                            ))
                            break  # one finding per written arg
    return out


# ---------------------------------------------------------------------------
# G005 — implicit dtype at tensor creation

def g005_implicit_dtype(index: PackageIndex) -> list[Finding]:
    """``torch.zeros/ones/empty/full/arange/tensor`` without ``dtype=``
    take torch's defaults (float32 for the value-less factories, int64
    for an int ``arange``, the fill's or data's type otherwise): an
    int32-keyed kernel fed an accidental int64 or float32 tensor raises
    at its boundary, or silently doubles the bytes a pass moves.
    Everything in ops/engine/serve/parallel/traces states its dtype."""
    out = []
    for m in index.modules:
        if not _in_dirs(m.path, G005_DIRS):
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            attr = m.is_torch_attr(node.func)
            if attr not in TORCH_CREATORS:
                continue
            if any(kw.arg == "dtype" for kw in node.keywords):
                continue
            out.append(Finding(
                rule="G005", path=m.path, line=node.lineno,
                col=node.col_offset,
                msg=(
                    f"`torch.{attr}(...)` without an explicit dtype — "
                    "it takes torch's default (float32, or int64 for "
                    "ints), not the int32 the kernels are keyed on"
                ),
            ))
    return out


# ---------------------------------------------------------------------------
# G006 — nondeterminism feeding journaled paths

def g006_nondeterminism(index: PackageIndex) -> list[Finding]:
    """The write-ahead journal assumes replay parity: the same streams
    re-produce the same tensors.  Wall-clock or unseeded randomness
    feeding tensorization/journal records, and set-order iteration,
    break that parity (a recovered fleet diverges byte-wise)."""
    out = []
    for m in index.modules:
        if not _in_dirs(m.path, G006_DIRS, G006_FILES):
            continue
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Call):
                f = node.func
                d = m.dotted(f) or ""
                root = d.split(".")[0] if d else ""
                # stdlib random module (always unseeded-global here)
                if root in m.random_aliases:
                    out.append(Finding(
                        rule="G006", path=m.path, line=node.lineno,
                        col=node.col_offset,
                        msg=(
                            f"stdlib `{d}(...)` in a journaled path — "
                            "global unseeded RNG breaks replay parity; "
                            "use np.random.default_rng(seed)"
                        ),
                    ))
                # numpy legacy global RNG / unseeded default_rng
                elif (
                    root in m.np_aliases
                    and d.split(".")[1:2] == ["random"]
                ):
                    tail = d.split(".")[-1]
                    if tail in _NP_LEGACY_RANDOM:
                        out.append(Finding(
                            rule="G006", path=m.path, line=node.lineno,
                            col=node.col_offset,
                            msg=(
                                f"`{d}(...)` uses numpy's GLOBAL RNG — "
                                "journal replay parity needs a seeded "
                                "default_rng instance"
                            ),
                        ))
                    elif tail == "default_rng" and not (
                        node.args or node.keywords
                    ):
                        out.append(Finding(
                            rule="G006", path=m.path, line=node.lineno,
                            col=node.col_offset,
                            msg=(
                                "`default_rng()` without a seed in a "
                                "journaled path — recovery replay "
                                "cannot reproduce it"
                            ),
                        ))
                # wall-clock feeding a journal/tensorize sink
                sink = (
                    f.attr if isinstance(f, ast.Attribute)
                    else (f.id if isinstance(f, ast.Name) else "")
                )
                if sink in _JOURNAL_SINKS:
                    for a in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        for s in ast.walk(a):
                            if (
                                isinstance(s, ast.Call)
                                and isinstance(s.func, ast.Attribute)
                                and isinstance(s.func.value, ast.Name)
                                and s.func.value.id in m.time_aliases
                            ):
                                out.append(Finding(
                                    rule="G006", path=m.path,
                                    line=s.lineno, col=s.col_offset,
                                    msg=(
                                        f"wall-clock `{m.dotted(s.func)}"
                                        f"()` feeds journaled sink "
                                        f"`{sink}` — replay cannot "
                                        "reproduce it; journal round "
                                        "counters instead"
                                    ),
                                ))
            elif isinstance(node, ast.For):
                it = node.iter
                is_set = isinstance(it, ast.Set) or (
                    isinstance(it, ast.Call)
                    and isinstance(it.func, ast.Name)
                    and it.func.id in ("set", "frozenset")
                )
                if is_set:
                    out.append(Finding(
                        rule="G006", path=m.path, line=it.lineno,
                        col=it.col_offset,
                        msg=(
                            "iteration over a set in a journaled path — "
                            "order is salted per process; wrap in "
                            "sorted(...)"
                        ),
                    ))
    return out


# ---------------------------------------------------------------------------
# G007 — boundary contract cross-check

def g007_boundary_contract(index: PackageIndex) -> list[Finding]:
    """Static cross-checks of the ``@boundary`` registry: the declared
    ``donates`` must equal the ``donate_argnums`` of the jit wrapper in
    the same decorator stack, and call sites passing an explicit literal
    dtype must match the declared one."""
    out = []
    for m in index.modules:
        for fi in m.functions.values():
            if fi.boundary is None:
                continue
            declared = fi.boundary.get("donates")
            if (
                fi.jitted
                and declared is not None
                and fi.donate_argnums is not None
                and set(declared) != set(fi.donate_argnums)
            ):
                out.append(Finding(
                    rule="G007", path=m.path, line=fi.boundary_line,
                    col=0,
                    msg=(
                        f"`{fi.qualname}`: @boundary donates="
                        f"{tuple(declared)} but jax.jit donate_argnums="
                        f"{tuple(fi.donate_argnums)} — the contract "
                        "table lies about buffer lifetime"
                    ),
                ))
    # call-site dtype literals vs declared contract
    for m in index.modules:
        for fi in m.functions.values():
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in index.resolve_call(node, fi):
                    spec = callee.boundary
                    if not spec or not spec.get("dtypes"):
                        continue
                    dtypes = spec["dtypes"]
                    offset = 1 if (
                        callee.cls
                        and callee.params
                        and callee.params[0] == "self"
                        and isinstance(node.func, ast.Attribute)
                    ) else 0
                    for j, a in enumerate(node.args):
                        k = j + offset
                        if k >= len(dtypes) or dtypes[k] is None:
                            continue
                        if not isinstance(a, ast.Call):
                            continue
                        if m.is_jnp_attr(a.func) is None and (
                            m.is_np_attr(a.func) is None
                        ) and m.is_torch_attr(a.func) is None:
                            continue
                        got = _explicit_dtype_name(a)
                        if got is not None and got != dtypes[k]:
                            out.append(Finding(
                                rule="G007", path=m.path,
                                line=a.lineno, col=a.col_offset,
                                msg=(
                                    f"arg {k} of `{callee.qualname}` "
                                    f"built as {got} but the boundary "
                                    f"contract declares {dtypes[k]}"
                                ),
                            ))
    return out


# ---------------------------------------------------------------------------
# G011 — fence-cost cross-check (static fence graph vs runtime counters)

def _load_boundary_syncs(path: str) -> tuple[dict | None, str | None]:
    """The ``boundary_syncs`` block of a serve bench artifact (a
    ``save_results`` list of BenchResult dicts) or of a raw JSON fixture.
    Returns (block, error)."""
    from .threads import load_artifact_block

    return load_artifact_block(path, "boundary_syncs")


def g011_fence_cost(index: PackageIndex, artifact_path: str
                    ) -> list[Finding]:
    """Cross-validate the static fence model against a serve run's
    ``boundary_syncs`` counters (the runtime ground truth the sanitizer
    records): a declared fence the run never crossed is DEAD — either
    the annotation is stale (delete it) or the boundary moved (re-fence
    the real one); a runtime counter with no matching ``# graftlint:
    fence`` marker is an UNATTRIBUTED sync boundary the static model
    does not know about.  ``fence=chaos`` / ``fence=journal`` /
    ``fence=flight`` / ``fence=reshard`` fences are accounted only
    against artifacts whose run had faults / a journal / a
    flight-recorder dump / a live-reshard coordinator, ``fence=genesis``
    only against streamed runs (the artifact's ``lifecycle.stream``);
    every other tag is dead-checked like an untagged fence; ``fence=cold``
    fences (off-drain APIs) are never dead-checked."""
    block, err = _load_boundary_syncs(artifact_path)
    if block is None:
        return [Finding(
            rule="G011", path=artifact_path, line=0, col=0, msg=err,
        )]
    entries = block.get("entries") or {}
    chaos = bool(block.get("chaos"))
    journal = bool(block.get("journal"))
    flight = bool(block.get("flight"))
    reshard = bool(block.get("reshard"))
    out = []
    fences = {
        fi.qualname: fi
        for m in index.modules for fi in m.functions.values() if fi.fence
    }
    # ``fence=genesis`` fences (LazyStreams' install and materialize) are
    # accounted only against a streamed run, the fact the artifact's
    # ``lifecycle`` block records for G025 (``stream``).  An artifact
    # without that block dead-checks them as JAX's G011 does
    from .threads import load_artifact_block

    life, _ = load_artifact_block(artifact_path, "lifecycle")
    stream = bool((life or {}).get("stream", True))
    for qual, fi in sorted(fences.items()):
        tag = fi.fence_tag
        if tag == "cold":
            continue
        if tag == "genesis" and not stream:
            continue
        if tag == "chaos" and not chaos:
            continue
        if tag == "journal" and not journal:
            continue
        if tag == "flight" and not flight:
            continue
        if tag == "reshard" and not reshard:
            continue
        if not entries.get(qual):
            out.append(Finding(
                rule="G011", path=fi.module.path, line=fi.node.lineno,
                col=fi.node.col_offset,
                msg=(
                    f"declared fence `{qual}` never crossed in "
                    f"{os.path.basename(artifact_path)} — dead fence: "
                    "delete the stale annotation or re-fence the real "
                    "boundary (tag it fence=chaos/journal/cold if it is "
                    "only reachable there)"
                ),
            ))
    for qual in sorted(entries):
        if qual not in fences:
            out.append(Finding(
                rule="G011", path=artifact_path, line=0, col=0,
                msg=(
                    f"runtime fence counter `{qual}` has no matching "
                    "`# graftlint: fence` marker — an unattributed sync "
                    "boundary the static G002 model does not know about"
                ),
            ))
    return out


# ---------------------------------------------------------------------------
# G012 — observability hygiene in hot-path scopes

#: obs-API calls that take a series NAME as their first argument.
#: ``segment`` is the obs/reqtrace.py per-phase timer — its names are
#: registered constants exactly like span/metric names.
_OBS_NAME_CALLS = {"span", "instant", "counter", "gauge", "histogram",
                   "segment"}

#: obs/reqtrace.py admission/drain-EDGE calls: opening a request
#: context or sampling an exemplar allocates and (for exemplars) grows
#: per-bucket state — legal once per admitted doc at the selection/
#: close edges (loop depth <= 1), banned in per-op inner loops.
_REQTRACE_EDGE_CALLS = {"open_request", "sample_exemplar",
                        "RequestContext"}

#: Tracer lifecycle — never legal in a hot scope (arming inside the
#: drain voids the disarmed-tracer no-op contract and skews timing).
_OBS_LIFECYCLE = {"arm", "disarm", "write_trace", "SpanTracer"}


def _is_obs_name(m, f: ast.expr) -> bool:
    """Does this call expression denote the obs span/metric API?
    Attribute calls (``registry.counter``, ``tracer.span``) match by
    attr name; bare names must be imported from an obs module."""
    if isinstance(f, ast.Attribute):
        return f.attr in _OBS_NAME_CALLS
    if isinstance(f, ast.Name) and f.id in _OBS_NAME_CALLS:
        src = m.imports.get(f.id, "")
        return "obs.trace" in src or "obs.metrics" in src
    return False


def _is_obs_lifecycle(m, f: ast.expr) -> str | None:
    d = dotted(f)
    if d is None:
        return None
    tail = d.split(".")[-1]
    if tail not in _OBS_LIFECYCLE:
        return None
    if isinstance(f, ast.Name):
        src = m.imports.get(f.id, "")
        return tail if ("obs.trace" in src or tail == "SpanTracer") \
            else None
    root = d.split(".")[0]
    src = m.imports.get(root, "")
    return tail if "obs" in src else None


def _obs_findings(fi: FuncInfo, chain: str) -> list[Finding]:
    m = fi.module
    out = []
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        life = _is_obs_lifecycle(m, f)
        if life is not None:
            out.append(Finding(
                rule="G012", path=m.path, line=node.lineno,
                col=node.col_offset,
                msg=(
                    f"tracer lifecycle `{life}(...)` in a hot-path "
                    f"scope ({chain}) — arming/writing belongs to the "
                    "bench harness; inside the drain the tracer must "
                    "stay a no-op when disarmed"
                ),
            ))
            continue
        if not _is_obs_name(m, f):
            continue
        name_arg = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "name"), None
        )
        if name_arg is None:
            continue
        if isinstance(name_arg, ast.Constant):
            # a constant str name is the contract; a constant NON-str
            # first arg means this is some other API sharing the method
            # name (re.Match.span(1)) — not an obs callsite at all
            continue
        what = (
            f.attr if isinstance(f, ast.Attribute) else f.id
        )
        out.append(Finding(
            rule="G012", path=m.path, line=node.lineno,
            col=node.col_offset,
            msg=(
                f"non-constant name passed to `{what}(...)` in a "
                f"hot-path scope ({chain}) — span/metric names are "
                "registered constants (f-strings allocate per round "
                "and explode series cardinality); put dynamic context "
                "in the args/tag payload"
            ),
        ))
    return out


def _reqtrace_call_name(m, f: ast.expr) -> str | None:
    """The reqtrace edge-call name this expression denotes, or None.
    Attribute calls (``tracker.open_request``) match by attr name —
    the method names are distinctive; bare names must be imported from
    ``obs.reqtrace``."""
    d = dotted(f)
    if d is None:
        return None
    tail = d.split(".")[-1]
    if tail not in _REQTRACE_EDGE_CALLS:
        return None
    if isinstance(f, ast.Name):
        src = m.imports.get(f.id, "")
        return tail if "reqtrace" in src else None
    return tail


def _reqtrace_loop_findings(fi: FuncInfo, chain: str) -> list[Finding]:
    """Request-context creation / exemplar sampling inside per-op
    INNER loops (loop depth >= 2) of a hot-path scope.  Depth 1 is the
    admission edge — the scheduler's per-DOC selection loop opens one
    context per admitted doc there, which is the sanctioned pattern."""
    m = fi.module
    out: list[Finding] = []

    def walk(node: ast.AST, depth: int) -> None:
        for child in ast.iter_child_nodes(node):
            d = depth
            if isinstance(child, (ast.For, ast.AsyncFor, ast.While)):
                d = depth + 1
            elif isinstance(child, (ast.ListComp, ast.SetComp,
                                    ast.DictComp, ast.GeneratorExp)):
                d = depth + len(child.generators)
            if isinstance(child, ast.Call) and depth >= 2:
                name = _reqtrace_call_name(m, child.func)
                if name is not None:
                    what = ("request-context creation"
                            if name in ("open_request", "RequestContext")
                            else "exemplar sampling")
                    out.append(Finding(
                        rule="G012", path=m.path, line=child.lineno,
                        col=child.col_offset,
                        msg=(
                            f"{what} `{name}(...)` inside a per-op "
                            f"inner loop (depth {depth}) in a hot-path "
                            f"scope ({chain}) — contexts and exemplars "
                            "are admission/drain-edge work: open once "
                            "per admitted doc in the selection loop, "
                            "sample once per request close"
                        ),
                    ))
            walk(child, d)

    walk(fi.node, 0)
    return out


def g012_obs_hygiene(index: PackageIndex) -> list[Finding]:
    """Observability discipline on the serving hot path: every
    ``obs/trace.py`` span, ``obs/metrics.py`` series, and
    ``obs/reqtrace.py`` segment created in a hot-path scope must use a
    registered CONSTANT name (dynamic context goes in args /
    pre-registered cause tags), the tracer lifecycle (arm / disarm /
    write) must never run there — the disarmed tracer is a shared
    no-op and arming mid-drain would void that contract — and request
    contexts / exemplars are opened at admission/drain EDGES only,
    never in per-op inner loops.  Unlike G002 the walk DESCENDS into
    declared fences: naming discipline applies behind sync boundaries
    too."""
    out: list[Finding] = []
    for fi, chain in walk_hot_scope(index, descend_fences=True):
        out.extend(_obs_findings(fi, chain))
        out.extend(_reqtrace_loop_findings(fi, chain))
    return out


# ---------------------------------------------------------------------------
# G013 — status/telemetry isolation in hot-path scopes

#: Server/socket constructor names (with their import-source checks
#: below): binding a port or accepting connections belongs to the bench
#: harness, never the serving hot path.
_G013_SERVER_CTORS = {
    "HTTPServer", "ThreadingHTTPServer", "TCPServer",
    "ThreadingTCPServer", "UDPServer", "ThreadingUDPServer",
    "StatusServer", "IngestFront",
}
_G013_SERVER_SOURCES = ("http.server", "socketserver", "obs.status",
                        "serve.ingest")

#: obs/ v3 lifecycle constructors: the flight recorder and the request
#: tracker are built (and armed — the tracker installs a global
#: publish observer) by the bench DRIVER; constructing either mid-
#: drain re-arms tracing under the hot path and leaks observers.
_G013_OBS_LIFECYCLE_CTORS = {"FlightRecorder", "RequestTracker"}

#: ``socket``-module entry points that create/bind network endpoints.
_G013_SOCKET_FUNCS = {"socket", "create_server", "create_connection"}

#: Registry-shape mutators: get-or-create and adoption.  The hot path
#: holds pre-registered references; creating series mid-drain races the
#: status server's snapshot reads and allocates per round.
_G013_REG_MUTATORS = {"counter", "gauge", "histogram", "attach"}


def _g013_call_finding(fi: FuncInfo, node: ast.Call, chain: str
                       ) -> Finding | None:
    m = fi.module
    f = node.func
    d = dotted(f)
    # (a) HTTP/TCP server construction (http.server / socketserver /
    # obs.status classes, by import source)
    tail = d.split(".")[-1] if d else None
    if tail in _G013_SERVER_CTORS:
        root = d.split(".")[0]
        src = m.imports.get(root, "")
        if tail in ("StatusServer", "IngestFront") or any(
            s in src for s in _G013_SERVER_SOURCES
        ):
            return Finding(
                rule="G013", path=m.path, line=node.lineno,
                col=node.col_offset,
                msg=(
                    f"`{tail}(...)` constructed in a hot-path scope "
                    f"({chain}) — servers are thread-confined and "
                    "harness-owned (status AND the ingest front); the "
                    "drain only swaps snapshot references in"
                ),
            )
    # (a') obs/ v3 lifecycle construction (flight recorder / request
    # tracker) — harness-side work, like the status server above
    if tail in _G013_OBS_LIFECYCLE_CTORS:
        return Finding(
            rule="G013", path=m.path, line=node.lineno,
            col=node.col_offset,
            msg=(
                f"`{tail}(...)` constructed in a hot-path scope "
                f"({chain}) — flight-recorder / request-tracker "
                "lifecycle belongs to the bench harness (the tracker "
                "installs a global publish observer when armed); the "
                "drain holds pre-built references"
            ),
        )
    # (b) raw socket creation
    if d is not None and len(d.split(".")) == 2:
        root, attr = d.split(".")
        if attr in _G013_SOCKET_FUNCS and m.imports.get(root) == "socket":
            return Finding(
                rule="G013", path=m.path, line=node.lineno,
                col=node.col_offset,
                msg=(
                    f"`{d}(...)` in a hot-path scope ({chain}) — no "
                    "network endpoints on the serving hot path"
                ),
            )
    # (c) serving a socket from the hot path
    if isinstance(f, ast.Attribute) and f.attr == "serve_forever":
        return Finding(
            rule="G013", path=m.path, line=node.lineno,
            col=node.col_offset,
            msg=(
                f"`.serve_forever()` in a hot-path scope ({chain}) — "
                "the status server loops on its own daemon thread"
            ),
        )
    # (d) registry mutation (get-or-create / attach), even with a
    # constant name — G012 polices naming, this polices WHEN: series
    # are pre-registered at bind time, the hot path holds references
    is_mutator = False
    if isinstance(f, ast.Attribute) and f.attr in _G013_REG_MUTATORS:
        is_mutator = True
        if (isinstance(f.value, ast.Name)
                and "sanitizer" in m.imports.get(f.value.id, "")):
            # runtime-sanitizer record calls (fs/race/lifecycle) share
            # the metric verbs but mutate no registry shape: a
            # fixed-key dict write the status server never snapshots
            is_mutator = False
    elif isinstance(f, ast.Name) and f.id in _G013_REG_MUTATORS:
        is_mutator = "obs.metrics" in m.imports.get(f.id, "")
    if is_mutator:
        what = f.attr if isinstance(f, ast.Attribute) else f.id
        return Finding(
            rule="G013", path=m.path, line=node.lineno,
            col=node.col_offset,
            msg=(
                f"registry mutation `{what}(...)` in a hot-path scope "
                f"({chain}) — get-or-create/attach races the status "
                "server's snapshot reads and allocates per round; "
                "pre-register at bind time and hold the reference "
                "(.inc()/.set()/.observe() stay legal)"
            ),
        )
    return None


def g013_status_isolation(index: PackageIndex) -> list[Finding]:
    """The live-telemetry isolation contract: the serving hot path
    never constructs sockets or HTTP servers, never serves them, and
    never mutates the metric registry's shape — the status endpoint is
    read-only over published snapshots on its own thread, and every
    series the hot path touches was pre-registered at bind time.  Like
    G012 (and unlike G002) the walk DESCENDS into declared fences:
    being behind a sync boundary does not make a mid-drain socket or a
    per-round series registration acceptable."""
    out: list[Finding] = []
    for fi, chain in walk_hot_scope(index, descend_fences=True):
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                finding = _g013_call_finding(fi, node, chain)
                if finding is not None:
                    out.append(finding)
    return out


RULES = {
    "G001": g001_module_tensor,
    "G002": g002_host_sync,
    "G004": g004_inplace_misuse,
    "G005": g005_implicit_dtype,
    "G006": g006_nondeterminism,
    "G007": g007_boundary_contract,
    "G008": g008_shape_drift,
    "G009": g009_launch_boundary,
    "G011": g011_fence_cost,  # artifact-driven; see run_lint
    "G012": g012_obs_hygiene,
    "G013": g013_status_isolation,
    "G014": g014_shared_escape,
    "G015": g015_publish_discipline,
    "G016": g016_blocking_hot_thread,
    "G017": g017_thread_crossings,  # artifact-driven; see run_lint
    "G018": g018_atomic_commit,
    "G019": g019_durable_ordering,
    "G020": g020_verify_before_trust,
    "G021": g021_fs_protocols,  # artifact-driven; see run_lint
    "G022": g022_state_discipline,
    "G023": g023_acquire_release,
    "G024": g024_identity_hazards,
    "G025": g025_lifecycle_artifact,  # artifact-driven; see run_lint
    "G026": g026_index_guard,
    "G027": g027_narrow_overflow,
    "G028": g028_pad_flow,
    "G029": g029_ranges_artifact,  # artifact-driven; see run_lint
}
