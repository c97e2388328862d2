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
    tpos = torch.arange(T, device=dev).expand(R, T)
    ci = torch.cumsum(is_instok, dim=1)
    last = torch.where(is_instok, tpos, -1).cummax(dim=1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    prev_gvis = torch.where(prev >= 0, gvis.gather(1, prev.clamp(min=0)), -1)
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


def resolve_tokens_plain(kind, pos, v0, *, emit_origin: bool = True):
    """Run a batch of unit ops over each replica's token list (a Python
    loop over the ops with tensor passes over the (R, T) list) and return a
    :class:`TokenWalk`.  Token ``nused`` (after the last op) stays FREE
    with ``cum`` equal to the visible total: an insert at the end lands on
    it."""
    B = kind.shape[0]
    R = v0.shape[0]
    T = token_list_size(B)
    dev = v0.device
    i64 = torch.int64
    # X[:, 0] = tta, X[:, 1] = cum; column 0 is a sentinel (tta 0, cum 0)
    # "before" the first token, so token i lives in column i + 1
    col = torch.arange(T + 1, device=dev)[None, :]
    X = torch.zeros((R, 2, T + 1), dtype=i64, device=dev)
    X[:, 0, 1] = RUN
    X[:, 1, 1:] = v0.to(i64)[:, None]
    total = v0.to(i64)[:, None]
    nused = torch.ones((R, 1), dtype=i64, device=dev)
    del_rank = torch.full((R, B), -1, dtype=i64, device=dev)
    origin = torch.full((R, B), -2, dtype=i64, device=dev)
    del_batch = torch.full((R, B), -1, dtype=i64, device=dev)
    op_t = torch.full((R, B), -1, dtype=i64, device=dev)
    op_nused = torch.zeros((R, B), dtype=i64, device=dev)
    pair = torch.tensor([0, 1], device=dev)

    def at(t):
        """(tta, cum) of the token in column t + 1 and cum of column t."""
        g = X.gather(2, (t + pair)[:, None, :].expand(R, 2, 2))
        return g[:, 0, 1:], g[:, 1, :1], g[:, 1, 1:]

    def place(t, m, delta, new):
        """Replace token t by the m tokens of ``new`` ((R, 2, 1) each),
        shifting the tail right by m - 1 and its cum by delta."""
        nonlocal X
        c = t + 1
        tail = col >= c
        src = (col - (m - 1) * tail).clamp(min=0)
        Y = X.gather(2, src[:, None, :].expand(R, 2, T + 1))
        Y[:, 1] += delta * tail
        for k, v in enumerate(new):
            hit = (col == c + k) & (m > k)
            Y = torch.where(hit[:, None, :], v, Y)
        X = Y

    for j, (k, p0) in enumerate(zip(kind.tolist(), pos.tolist())):
        op_nused[:, j:j + 1] = nused
        if k not in (INSERT, DELETE):
            continue  # PAD: no-op
        p = total.clamp(max=max(p0, 0))
        cum = X[:, 1, 1:]
        t = torch.minimum((cum <= p).sum(1, keepdim=True), nused)
        op_t[:, j:j + 1] = t
        tta_t, pre, c_t = at(t)
        a = tta_t >> 2
        off = p - pre
        if k == INSERT:
            split = off > 0
            m = 2 + split.to(i64)
            j4 = j * 4 + TINS
            place(t, m, 1, (
                torch.stack([torch.where(split, a * 4 + RUN, j4),
                             torch.where(split, p, pre + 1)], 1),
                torch.stack([torch.where(split, j4, tta_t),
                             torch.where(split, p, c_t) + 1], 1),
                torch.stack([(a + off) * 4 + RUN, c_t + 1], 1),
            ))
            if emit_origin:
                tp = (cum <= p - 1).sum(1, keepdim=True)
                tta_p, pre_p, _ = at(tp)
                a_p = tta_p >> 2
                oc = torch.where((tta_p & 3) == RUN, a_p + (p - 1 - pre_p),
                                 ORIGIN_BATCH + a_p)
                origin[:, j:j + 1] = torch.where(p == 0, -1, oc)
            else:
                origin[:, j] = -1
            total = total + 1
        else:
            is_del = p < total
            tt = tta_t & 3
            hit_run = tt == RUN
            m = 1 + (is_del & hit_run).to(i64)
            delta = -is_del.to(i64)
            place(t, m, delta, (
                torch.stack([
                    torch.where(is_del, a * 4 + torch.where(hit_run, RUN,
                                                            TDEAD), tta_t),
                    torch.where(is_del, torch.where(hit_run, p, pre), c_t),
                ], 1),
                torch.stack([(a + off + 1) * 4 + RUN, c_t - 1], 1),
            ))
            del_rank[:, j:j + 1] = torch.where(is_del & hit_run, a + off, -1)
            del_batch[:, j:j + 1] = torch.where(is_del & (tt == TINS), a, -1)
            total = total + delta
        nused = nused + (m - 1)

    return TokenWalk(
        tta=X[:, 0, 1:], cum=X[:, 1, 1:], del_rank=del_rank, origin=origin,
        del_batch=del_batch, t=op_t, nused=op_nused,
    )


def resolve_batch_plain(kind, pos, v0, *, emit_origin: bool = True):
    """Plain PyTorch version of K5 (any device): :func:`resolve_tokens_plain`
    then :func:`extract_from_tokens` on its final list.  Same arguments and
    results as :func:`resolve_batch`."""
    resolve_batch_plain.calls += 1
    w = resolve_tokens_plain(kind, pos, v0, emit_origin=emit_origin)
    tlen = torch.diff(w.cum, dim=1, prepend=w.cum.new_zeros(len(v0), 1))
    gvis, seq, alive = extract_from_tokens(
        (w.tta & 3).to(I32), (w.tta >> 2).to(I32), tlen.to(I32), v0,
        kind.shape[0],
    )
    return ResolvedBatch(
        del_rank=w.del_rank.to(I32), ins_gvis=gvis, ins_seq=seq,
        ins_alive=alive, origin=w.origin.to(I32),
        del_batch=w.del_batch.to(I32),
    )


resolve_batch_plain.calls = 0


@boundary(dtypes=("int32", "int32", "int32"), shapes=("B", "B", None))
def resolve_batch(kind, pos, v0, *, emit_origin: bool = True) -> ResolvedBatch:
    """Resolve one batch of unit ops for R replicas (K5).

    kind/pos: int32[B] (shared by every replica); v0: int32[R] visible
    lengths.  Returns a :class:`ResolvedBatch` of (R, B) tensors.  The
    token list is never capped (T = :func:`token_list_size`), so no demand
    check is needed.  On a CUDA tensor this launches the kernel (or
    raises); on a CPU tensor it runs :func:`resolve_batch_plain`."""
    B = kind.shape[0]
    R = v0.shape[0]
    for name, t, n in (("kind", kind, B), ("pos", pos, B), ("v0", v0, R)):
        if t.device != v0.device:
            raise ValueError(f"{name} on {t.device}, v0 on {v0.device}")
        if t.dtype != I32 or tuple(t.shape) != (n,):
            raise ValueError(
                f"{name}: want int32[{n}], got {t.dtype}{list(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if v0.device.type == "cpu":
        return resolve_batch_plain(kind, pos, v0, emit_origin=emit_origin)
    if v0.device.type != "cuda":
        raise ValueError(f"resolve_batch: unsupported device {v0.device}")
    T = token_list_size(B)
    if B < 1 or unit_smem_bytes(B) > _MAX_SMEM:
        raise ValueError(
            f"resolve_batch: batch {B} (token list {T}) outside the "
            "kernel's shared-memory range"
        )
    mk = lambda: torch.empty((R, B), dtype=I32, device=v0.device)
    drank, gvis, seq, orig, dbatch = mk(), mk(), mk(), mk(), mk()
    alive = torch.empty((R, B), dtype=torch.bool, device=v0.device)
    if R:
        err = kernels().crdt_resolve_unit(
            kind.data_ptr(), pos.data_ptr(), v0.data_ptr(), R, B, T,
            int(emit_origin), drank.data_ptr(), gvis.data_ptr(),
            seq.data_ptr(), alive.data_ptr(), orig.data_ptr(),
            dbatch.data_ptr(),
            torch.cuda.current_stream(v0.device).cuda_stream,
        )
        check(err, "crdt_resolve_unit")
        resolve_batch.launches += 1
    return ResolvedBatch(
        del_rank=drank, ins_gvis=gvis, ins_seq=seq, ins_alive=alive,
        origin=orig, del_batch=dbatch,
    )


resolve_batch.launches = 0
