"""Boundary contracts on torch dtypes and shapes (the JAX package's
``lint/boundary.py``).

Every public entry point that takes host-built tensors into a kernel path
is a *boundary*; the ``@boundary`` decorator records its contract in a
machine-readable table (:data:`REGISTRY`)::

    @boundary(dtypes=(None, "int32", "int32"), shapes=(None, "R B", "R B"),
              donates=(0,))
    def merge_rows_round(state, kind, pos, rlen, slot0): ...

- ``dtypes``: per-positional-arg dtype name (``"int32"``, the torch dtype
  without its ``torch.`` prefix), applied to every tensor leaf of that
  argument; ``None`` = unchecked.
- ``shapes``: per-arg symbolic dim spec (``"K R B"``); letters bind
  consistently across the call's arguments, integer tokens are exact.
  Checked for single-tensor arguments only; ``None`` = unchecked.
- ``donates``: the positions the callee writes in place (JAX's donated
  buffers).  The check refuses a donated argument whose storage overlaps
  another argument's: the callee would read what it has already written.

Checking is armed by :func:`arm` (the serve bench's
``sanitize=("boundaries",)``; options are arguments, never environment
variables).  Disarmed, a decorated call costs one module-global test.
Armed, every call validates its arguments (the checks read ``.dtype``,
``.shape`` and the storage only: no sync).
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass

_armed = False


def arm() -> None:
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def armed() -> bool:
    return _armed


class BoundaryError(TypeError):
    """A call violated its declared boundary contract."""


@dataclass(frozen=True)
class BoundaryContract:
    name: str  # "module.qualname", the registry key
    dtypes: tuple  # per-positional-arg dtype name or None
    shapes: tuple  # per-positional-arg "K R B" spec or None
    donates: tuple  # positions written in place


#: The contract table, keyed by "module.qualname".
REGISTRY: dict[str, BoundaryContract] = {}


def _leaves(x):
    """Tensor leaves of a minimal pytree (NamedTuple / tuple / list /
    dict); anything with a ``.dtype`` is a leaf."""
    if hasattr(x, "_fields"):  # NamedTuple states
        for f in x._fields:
            yield from _leaves(getattr(x, f))
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif hasattr(x, "dtype"):
        yield x


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _span(leaf):
    """The byte interval ``[lo, hi)`` a tensor's elements occupy, or None
    for an empty one or a leaf that is not a torch tensor."""
    if not hasattr(leaf, "untyped_storage") or leaf.numel() == 0:
        return None
    lo = leaf.data_ptr()
    last = sum((n - 1) * st for n, st in zip(leaf.shape, leaf.stride()))
    return (lo, lo + (last + 1) * leaf.element_size())


def _overlaps(a, b) -> bool:
    if a is b:
        return True
    sa, sb = _span(a), _span(b)
    if sa is None or sb is None:
        return False
    return sa[0] < sb[1] and sb[0] < sa[1]


def _check_call(c: BoundaryContract, args: tuple) -> None:
    # dtypes: every tensor leaf of arg i has the declared dtype
    for i, want in enumerate(c.dtypes):
        if want is None or i >= len(args):
            continue
        for leaf in _leaves(args[i]):
            got = _dtype_name(leaf)
            if got != want:
                raise BoundaryError(
                    f"{c.name}: arg {i} dtype {got!r} != declared {want!r}"
                )
    # shapes: symbolic dims bind consistently across the call
    env: dict[str, int] = {}
    for i, spec in enumerate(c.shapes):
        if spec is None or i >= len(args):
            continue
        leaves = list(_leaves(args[i]))
        if len(leaves) != 1:  # a pytree argument: the spec is for tensors
            continue
        shape = tuple(leaves[0].shape)
        toks = spec.split()
        if len(shape) != len(toks):
            raise BoundaryError(
                f"{c.name}: arg {i} rank {len(shape)} != declared "
                f"{spec!r}"
            )
        for tok, dim in zip(toks, shape):
            if tok.isdigit():
                if int(tok) != dim:
                    raise BoundaryError(
                        f"{c.name}: arg {i} dim {dim} != declared {tok} "
                        f"in {spec!r}"
                    )
            elif env.setdefault(tok, dim) != dim:
                raise BoundaryError(
                    f"{c.name}: arg {i} dim {tok}={dim} contradicts "
                    f"{tok}={env[tok]} bound earlier in the call"
                )
    # in place: a written argument shares storage with no other argument
    for i in c.donates:
        if i >= len(args):
            continue
        written = list(_leaves(args[i]))
        for j, other in enumerate(args):
            if j == i:
                continue
            for leaf in _leaves(other):
                if any(_overlaps(w, leaf) for w in written):
                    raise BoundaryError(
                        f"{c.name}: arg {j} overlaps arg {i}, which the "
                        "callee writes in place — it would read what it "
                        "has already written"
                    )


def boundary(*, dtypes=(), shapes=(), donates=()):
    """Declare a boundary contract (see the module docstring)."""

    def deco(fn):
        c = BoundaryContract(
            name=f"{fn.__module__}.{fn.__qualname__}",
            dtypes=tuple(dtypes),
            shapes=tuple(shapes),
            donates=tuple(donates),
        )
        REGISTRY[c.name] = c
        # positional parameter names, so keyword call sites bind back to
        # their contract positions: `f(state, kind=k)` is checked as
        # `f(state, k)`
        pos_params = [
            p.name
            for p in inspect.signature(fn).parameters.values()
            if p.kind in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
            )
        ]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _armed:
                full = list(args)
                for name in pos_params[len(args):]:
                    if name not in kwargs:
                        break
                    full.append(kwargs[name])
                _check_call(c, tuple(full))
            return fn(*args, **kwargs)

        wrapper.__boundary__ = c
        return wrapper

    return deco
