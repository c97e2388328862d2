"""Unit-op resolver K5 (the JAX package's ``ops/resolve.py`` and
``ops/resolve_pallas.py``): one batch of B single-char ops, shared by
every replica, resolved per replica over a token list.

Token list (low two bits of ``tta = ta*4 + ttype``; the resolvers keep it
cum-primary: ``cum[i]`` is the inclusive prefix sum of token lengths):

- RUN(a): surviving pre-batch chars with visible ranks a .. a+len-1;
- TINS(j): the char inserted by batch op j (length 1);
- TDEAD(j): a batch insert deleted later in the same batch (length 0,
  kept in place so it still receives a position for its tombstone);
- FREE: unused token (cum stays flat).

The token list depends on the pre-batch document only through its
visible length ``v0``.  Per op j the batch reports (:class:`ResolvedBatch`,
all (R, B)): ``del_rank`` (pre-batch rank a DELETE tombstones, -1),
``ins_gvis`` (rank of the first surviving pre-batch char after the insert
at batch end, v0 = document tail, -1 for non-inserts), ``ins_seq``
(tie-break among inserts sharing that gap), ``ins_alive`` (bool: not
deleted within the batch), ``origin`` (left origin of an insert: -1 =
document head, r = pre-batch char of rank r, ORIGIN_BATCH + k = the char
of batch op k; -2 for non-inserts) and ``del_batch`` (the batch op whose
insert a DELETE kills, -1).  With ``emit_origin=False`` an insert's origin
is -1 and a non-insert's -2, as in the JAX Pallas resolver.

Each insert j leaves exactly one TINS(j) or TDEAD(j) token in the final
list (TDEAD exactly when a later delete of the batch killed it), so
``ins_gvis``, ``ins_seq`` and ``ins_alive`` are read off the final list
(:func:`extract_from_tokens`) with no per-op bookkeeping during the walk.

:func:`resolve_batch` launches the CUDA kernel (``csrc/resolve_unit.cu``)
on a CUDA tensor; :func:`resolve_batch_plain` is its plain PyTorch version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..lint.boundary import boundary
from ..lint.sanitizer import kernel_body
from .._build import check, kernels
from ..traces.tensorize import DELETE, INSERT

# Token types.
FREE, RUN, TINS, TDEAD = 0, 1, 2, 3

#: Origin codes >= ORIGIN_BATCH refer to batch op indices.
ORIGIN_BATCH = 1 << 24

_BIG = 1 << 30
I32 = torch.int32
#: Shared memory a block may use on Hopper (227 KB).
_MAX_SMEM = 232448
#: Replicas per block of the kernel (one warp each; ``kWarps`` in
#: ``csrc/resolve_unit.cu``).
UNIT_WARPS = 4


class ResolvedBatch(NamedTuple):
    del_rank: torch.Tensor  # int32[R, B]
    ins_gvis: torch.Tensor  # int32[R, B]  (-1 for non-insert ops)
    ins_seq: torch.Tensor  # int32[R, B]
    ins_alive: torch.Tensor  # bool[R, B]
    origin: torch.Tensor  # int32[R, B]  (-2 for non-insert ops)
    del_batch: torch.Tensor  # int32[R, B]


def token_list_size(B: int) -> int:
    """The resolver's token-list size: 2B+2 bounds the tokens any batch of
    B unit ops can create, rounded up to 128."""
    return -(-(2 * B + 2) // 128) * 128


def unit_smem_bytes(B: int) -> int:
    """Shared memory of one K5 block at batch B: kind/pos staged once, and
    each warp's (tta, cum) list of T + 1 ints per field."""
    return (UNIT_WARPS * 2 * (token_list_size(B) + 1) + 2 * B) * 4


def unit_rows_smem_bytes(B: int) -> int:
    """Shared memory of one block of K5's per-row form at batch B: each
    warp's (tta, cum) list of T + 1 ints per field and its own row's
    kind/pos."""
    return UNIT_WARPS * (2 * (token_list_size(B) + 1) + 2 * B) * 4


def max_rows_batch() -> int:
    """The largest batch K5's per-row form takes (227 KB a block)."""
    B = 1
    while unit_rows_smem_bytes(B + 1) <= _MAX_SMEM:
        B += 1
    return B


def extract_from_tokens(ttype, ta, tlen, v0, B: int):
    """Per-op (ins_gvis, ins_seq, ins_alive) from a final token list
    (ttype/ta/tlen int32[R, T], v0 int32[R]): each instok token's gap rank,
    its tie-break rank among the instok tokens of its gap, and whether it
    survived, scattered to its op index."""
    R, T = ttype.shape
    dev = ttype.device
    is_instok = (ttype == TINS) | (ttype == TDEAD)
    # first surviving pre-batch char after each token: suffix-min of the
    # run starts to its right
    run_start = torch.where((ttype == RUN) & (tlen > 0), ta, _BIG)
    suff = torch.cummin(run_start.flip(1), dim=1).values.flip(1)
    nxt = torch.cat([suff[:, 1:], torch.full_like(suff[:, :1], _BIG)], 1)
    gvis = torch.where(nxt >= _BIG, v0.to(I32)[:, None], nxt)
    # tie-break: instok tokens of one gap are contiguous among the instok
    # tokens; a group starts where the gap differs from the previous one's
    tpos = torch.arange(T, device=dev, dtype=torch.int64).expand(R, T)
    ci = torch.cumsum(is_instok, dim=1)
    last = torch.where(is_instok, tpos, -1).cummax(dim=1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    # K5's plain version: prev < 0 is masked by the where
    prev_gvis = torch.where(prev >= 0, gvis.gather(1, prev.clamp(min=0)), -1)  # graftlint: disable=G026
    boundary = is_instok & ((prev < 0) | (prev_gvis != gvis))
    base = torch.where(boundary, ci - 1, -1)
    seq = ci - 1 - base.cummax(dim=1).values
    # scatter to op space; non-instok tokens land in a dropped column B
    opidx = torch.where(is_instok, ta, B).long()

    def to_ops(fill, val):
        out = torch.full((R, B + 1), fill, dtype=val.dtype, device=dev)
        return out.scatter_(1, opidx, val)[:, :B].contiguous()

    return (
        to_ops(-1, gvis.to(I32)),
        to_ops(0, seq.to(I32)),
        to_ops(False, ttype == TINS),
    )


class TokenWalk(NamedTuple):
    """The sequential part of K5's plain version: the final token list and
    the per-op results that do not need it, plus where each op acted."""
    tta: torch.Tensor  # int64[R, T]  ta*4 + ttype of the final list
    cum: torch.Tensor  # int64[R, T]  inclusive prefix of token lengths
    del_rank: torch.Tensor  # int64[R, B]
    origin: torch.Tensor  # int64[R, B]
    del_batch: torch.Tensor  # int64[R, B]
    t: torch.Tensor  # int64[R, B]  the op's token index (-1 for PAD)
    nused: torch.Tensor  # int64[R, B]  tokens in use before the op


class _TokenList:
    """The (R, T) token lists of a plain walk: ``X[:, 0]`` = tta,
    ``X[:, 1]`` = cum; column 0 is a sentinel (tta 0, cum 0) "before" the
    first token, so token i lives in column i + 1."""

    def __init__(self, v0, T: int):
        R = v0.shape[0]
        dev = v0.device
        self.R, self.T = R, T
        self.col = torch.arange(T + 1, device=dev, dtype=torch.int64)[None, :]
        self.pair = torch.tensor([0, 1], device=dev, dtype=torch.int64)
        self.X = torch.zeros((R, 2, T + 1), dtype=torch.int64, device=dev)
        self.X[:, 0, 1] = RUN
        self.X[:, 1, 1:] = v0.to(torch.int64)[:, None]

    def at(self, t):
        """(tta, cum) of the token in column t + 1 and cum of column t."""
        # K5's plain walk: t <= nused <= T - 1, so t + 1 < T + 1
        g = self.X.gather(2, (t + self.pair)[:, None, :].expand(self.R, 2, 2))  # graftlint: disable=G026
        return g[:, 0, 1:], g[:, 1, :1], g[:, 1, 1:]

    def place(self, t, m, delta, new):
        """Replace token t by the m tokens of ``new`` ((R, 2, 1) each),
        shifting the tail right by m - 1 and its cum by delta."""
        c = t + 1
        col = self.col
        tail = col >= c
        src = (col - (m - 1) * tail).clamp(min=0)
        # K5's plain walk: src < 0 only left of token t, which place keeps
        Y = self.X.gather(2, src[:, None, :].expand(self.R, 2, self.T + 1))  # graftlint: disable=G026
        Y[:, 1] += delta * tail
        for k, v in enumerate(new):
            hit = (col == c + k) & (m > k)
            Y = torch.where(hit[:, None, :], v, Y)
        self.X = Y

    def find(self, p, nused):
        """The token holding offset p: the count of cum <= p, at most
        ``nused`` (the FREE sentinel, where an insert at the end lands)."""
        return torch.minimum((self.X[:, 1, 1:] <= p).sum(1, keepdim=True),
                             nused)

    def origin(self, p):
        """The left origin code of an insert at offset p > 0."""
        tp = (self.X[:, 1, 1:] <= p - 1).sum(1, keepdim=True)
        tta_p, pre_p, _ = self.at(tp)
        a_p = tta_p >> 2
        return torch.where((tta_p & 3) == RUN, a_p + (p - 1 - pre_p),
                           ORIGIN_BATCH + a_p)


def _insert_tokens(j, p, a, off, pre, tta_t, c_t):
    """An insert's m and its new tokens at token t (INSERT off == 0:
    [TINS(j), old_t]; off > 0: [RUN(a, off), TINS(j), RUN(a + off,
    rest)])."""
    split = off > 0
    j4 = j * 4 + TINS
    return 2 + split.to(torch.int64), (
        torch.stack([torch.where(split, a * 4 + RUN, j4),
                     torch.where(split, p, pre + 1)], 1),
        torch.stack([torch.where(split, j4, tta_t),
                     torch.where(split, p, c_t) + 1], 1),
        torch.stack([(a + off) * 4 + RUN, c_t + 1], 1),
    )


def _delete_tokens(is_del, hit_run, p, a, off, pre, tta_t, c_t):
    """A delete's m and its new tokens at token t (on TINS: [TDEAD(a)];
    on RUN: [RUN(a, off), RUN(a + off + 1, rest)]; a delete past the end
    keeps token t as it is)."""
    return 1 + (is_del & hit_run).to(torch.int64), (
        torch.stack([
            torch.where(is_del, a * 4 + torch.where(hit_run, RUN, TDEAD),
                        tta_t),
            torch.where(is_del, torch.where(hit_run, p, pre), c_t),
        ], 1),
        torch.stack([(a + off + 1) * 4 + RUN, c_t - 1], 1),
    )


def resolve_tokens_plain(kind, pos, v0, *, emit_origin: bool = True):
    """Run a batch of unit ops over each replica's token list (a Python
    loop over the ops with tensor passes over the (R, T) list) and return a
    :class:`TokenWalk`.  Token ``nused`` (after the last op) stays FREE
    with ``cum`` equal to the visible total: an insert at the end lands on
    it."""
    B = kind.shape[0]
    R = v0.shape[0]
    dev = v0.device
    i64 = torch.int64
    L = _TokenList(v0, token_list_size(B))
    total = v0.to(i64)[:, None]
    nused = torch.ones((R, 1), dtype=i64, device=dev)
    del_rank = torch.full((R, B), -1, dtype=i64, device=dev)
    origin = torch.full((R, B), -2, dtype=i64, device=dev)
    del_batch = torch.full((R, B), -1, dtype=i64, device=dev)
    op_t = torch.full((R, B), -1, dtype=i64, device=dev)
    op_nused = torch.zeros((R, B), dtype=i64, device=dev)

    for j, (k, p0) in enumerate(zip(kind.tolist(), pos.tolist())):
        op_nused[:, j:j + 1] = nused
        if k not in (INSERT, DELETE):
            continue  # PAD: no-op
        p = total.clamp(max=max(p0, 0))
        t = L.find(p, nused)
        op_t[:, j:j + 1] = t
        tta_t, pre, c_t = L.at(t)
        a = tta_t >> 2
        off = p - pre
        if k == INSERT:
            if emit_origin:
                origin[:, j:j + 1] = torch.where(p == 0, -1, L.origin(p))
            else:
                origin[:, j] = -1
            m, new = _insert_tokens(j, p, a, off, pre, tta_t, c_t)
            L.place(t, m, 1, new)
            total = total + 1
        else:
            is_del = p < total
            tt = tta_t & 3
            hit_run = tt == RUN
            m, new = _delete_tokens(is_del, hit_run, p, a, off, pre, tta_t,
                                    c_t)
            delta = -is_del.to(i64)
            L.place(t, m, delta, new)
            del_rank[:, j:j + 1] = torch.where(is_del & hit_run, a + off, -1)
            del_batch[:, j:j + 1] = torch.where(is_del & (tt == TINS), a, -1)
            total = total + delta
        nused = nused + (m - 1)

    return TokenWalk(
        tta=L.X[:, 0, 1:], cum=L.X[:, 1, 1:], del_rank=del_rank,
        origin=origin, del_batch=del_batch, t=op_t, nused=op_nused,
    )


def resolve_tokens_rows_plain(kind, pos, v0, *, emit_origin: bool = True):
    """:func:`resolve_tokens_plain` with one op stream a row (kind/pos
    int32[R, B]): each op's insert and delete forms are both computed
    over the (R, T) lists and picked per row, PAD rows and deletes past
    the end keeping their token.  ``t`` is -1 for a PAD op."""
    R, B = kind.shape
    dev = v0.device
    i64 = torch.int64
    L = _TokenList(v0, token_list_size(B))
    total = v0.to(i64)[:, None]
    nused = torch.ones((R, 1), dtype=i64, device=dev)
    ks, ps = kind.to(i64), pos.to(i64)
    cols = []
    for j in range(B):
        k, p0 = ks[:, j:j + 1], ps[:, j:j + 1]
        n_before = nused
        ins = k == INSERT
        p = torch.minimum(p0.clamp(min=0), total)
        t = L.find(p, nused)
        tta_t, pre, c_t = L.at(t)
        a = tta_t >> 2
        off = p - pre
        tt = tta_t & 3
        hit_run = tt == RUN
        is_del = (k == DELETE) & (p < total)
        m_i, new_i = _insert_tokens(j, p, a, off, pre, tta_t, c_t)
        m_d, new_d = _delete_tokens(is_del, hit_run, p, a, off, pre, tta_t,
                                    c_t)
        if emit_origin:
            org = torch.where(p == 0, -1, L.origin(p))
        else:
            org = torch.full_like(p, -1)
        m = torch.where(ins, m_i, m_d)
        delta = torch.where(ins, 1, -is_del.to(i64))
        w = ins[:, :, None]
        L.place(t, m, delta, (torch.where(w, new_i[0], new_d[0]),
                              torch.where(w, new_i[1], new_d[1]),
                              new_i[2]))
        cols.append((
            torch.where(is_del & hit_run, a + off, -1),
            torch.where(ins, org, -2),
            torch.where(is_del & (tt == TINS), a, -1),
            torch.where(ins | (k == DELETE), t, -1),
            n_before,
        ))
        total = total + delta
        nused = nused + (m - 1)

    dr, org, db, op_t, op_nused = (torch.cat(c, 1) for c in zip(*cols))
    return TokenWalk(
        tta=L.X[:, 0, 1:], cum=L.X[:, 1, 1:], del_rank=dr, origin=org,
        del_batch=db, t=op_t, nused=op_nused,
    )


@kernel_body
def resolve_batch_plain(kind, pos, v0, *, emit_origin: bool = True):
    """Plain PyTorch version of K5 (any device): :func:`resolve_tokens_plain`
    then :func:`extract_from_tokens` on its final list.  Same arguments and
    results as :func:`resolve_batch`."""
    resolve_batch_plain.calls += 1
    w = resolve_tokens_plain(kind, pos, v0, emit_origin=emit_origin)
    return _from_walk(w, v0, kind.shape[0])


resolve_batch_plain.calls = 0


def _from_walk(w: TokenWalk, v0, B: int) -> ResolvedBatch:
    """The :class:`ResolvedBatch` of a finished plain walk."""
    tlen = torch.diff(w.cum, dim=1, prepend=w.cum.new_zeros(len(v0), 1))
    gvis, seq, alive = extract_from_tokens(
        (w.tta & 3).to(I32), (w.tta >> 2).to(I32), tlen.to(I32), v0, B,
    )
    return ResolvedBatch(
        del_rank=w.del_rank.to(I32), ins_gvis=gvis, ins_seq=seq,
        ins_alive=alive, origin=w.origin.to(I32),
        del_batch=w.del_batch.to(I32),
    )


@kernel_body
def resolve_batch_rows_plain(kind, pos, v0, *, emit_origin: bool = True):
    """Plain PyTorch version of K5's per-row form (any device):
    :func:`resolve_tokens_rows_plain` then :func:`extract_from_tokens`.
    Same arguments and results as :func:`resolve_batch_rows`."""
    resolve_batch_rows_plain.calls += 1
    w = resolve_tokens_rows_plain(kind, pos, v0, emit_origin=emit_origin)
    return _from_walk(w, v0, kind.shape[1])


resolve_batch_rows_plain.calls = 0


def _check_operands(name, kind, pos, v0, op_shape):
    R = v0.shape[0]
    for arg, t, shape in (("kind", kind, op_shape), ("pos", pos, op_shape),
                          ("v0", v0, (R,))):
        if t.device != v0.device:
            raise ValueError(f"{name}: {arg} on {t.device}, v0 on "
                             f"{v0.device}")
        if t.dtype != I32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {arg}: want int32{list(shape)}, got "
                f"{t.dtype}{list(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    if v0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {v0.device}")


def _launch(entry, kind, pos, v0, B: int, smem: int, emit_origin: bool):
    """Launch a K5 entry over R = len(v0) warps; the (R, B) outputs."""
    R = v0.shape[0]
    T = token_list_size(B)
    if B < 1 or smem > _MAX_SMEM:
        raise ValueError(
            f"{entry}: batch {B} (token list {T}) outside the kernel's "
            "shared-memory range"
        )
    mk = lambda: torch.empty((R, B), dtype=I32, device=v0.device)
    drank, gvis, seq, orig, dbatch = mk(), mk(), mk(), mk(), mk()
    alive = torch.empty((R, B), dtype=torch.bool, device=v0.device)
    if R:
        with torch.cuda.device(v0.device):  # on the operands' device
            err = getattr(kernels(), entry)(
                kind.data_ptr(), pos.data_ptr(), v0.data_ptr(), R, B, T,
                int(emit_origin), drank.data_ptr(), gvis.data_ptr(),
                seq.data_ptr(), alive.data_ptr(), orig.data_ptr(),
                dbatch.data_ptr(),
                torch.cuda.current_stream(v0.device).cuda_stream,
            )
        check(err, entry)
    return ResolvedBatch(
        del_rank=drank, ins_gvis=gvis, ins_seq=seq, ins_alive=alive,
        origin=orig, del_batch=dbatch,
    )


@boundary(dtypes=("int32", "int32", "int32"), shapes=("R B", "R B", "R"))
def resolve_batch_rows(kind, pos, v0, *,
                       emit_origin: bool = True) -> ResolvedBatch:
    """K5's per-row form: row r resolves its own batch of unit ops
    (kind/pos int32[R, B]) against its own visible length ``v0[r]`` (JAX's
    ``jax.vmap(resolve_batch)`` over a fleet's rows).  PAD ops are no-ops.
    Returns a :class:`ResolvedBatch` of (R, B) tensors.  On a CUDA tensor
    this launches ``crdt_resolve_unit_rows`` (or raises); on a CPU tensor
    it runs :func:`resolve_batch_rows_plain`."""
    R = v0.shape[0]
    B = kind.shape[1] if kind.dim() == 2 else -1
    _check_operands("resolve_batch_rows", kind, pos, v0, (R, B))
    if v0.device.type == "cpu":
        return resolve_batch_rows_plain(kind, pos, v0,
                                        emit_origin=emit_origin)
    out = _launch("crdt_resolve_unit_rows", kind, pos, v0, B,
                  unit_rows_smem_bytes(B), emit_origin)
    if R:
        resolve_batch_rows.launches += 1
    return out


resolve_batch_rows.launches = 0


@boundary(dtypes=("int32", "int32", "int32"), shapes=("B", "B", None))
def resolve_batch(kind, pos, v0, *, emit_origin: bool = True) -> ResolvedBatch:
    """Resolve one batch of unit ops for R replicas (K5).

    kind/pos: int32[B] (shared by every replica); v0: int32[R] visible
    lengths.  Returns a :class:`ResolvedBatch` of (R, B) tensors.  The
    token list is never capped (T = :func:`token_list_size`), so no demand
    check is needed.  On a CUDA tensor this launches the kernel (or
    raises); on a CPU tensor it runs :func:`resolve_batch_plain`."""
    B = kind.shape[0]
    _check_operands("resolve_batch", kind, pos, v0, (B,))
    if v0.device.type == "cpu":
        return resolve_batch_plain(kind, pos, v0, emit_origin=emit_origin)
    out = _launch("crdt_resolve_unit", kind, pos, v0, B, unit_smem_bytes(B),
                  emit_origin)
    if v0.shape[0]:
        resolve_batch.launches += 1
    return out


resolve_batch.launches = 0
