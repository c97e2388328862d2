"""Range-op resolver K1 (the JAX package's
``ops/resolve_range_pallas.py``): one batch of range ops, shared by every
replica, resolved per replica over a cum-primary token list.

Token list: (ttype, ta, tch, cum) per token, ``tta = ta*4 + ttype``:

- RUN(a): surviving pre-batch chars with ranks a .. a+len-1;
- TINS(s, c): chars c .. c+len-1 of the insert run whose first slot id is
  s (zero length = fully deleted within the batch);
- FREE: unused token (cum stays flat).

An INSERT replaces the token holding its position by up to three tokens
(left piece, the new run, right piece).  A DELETE clamps every token's
cum and splits at most one token; per delete op it reports the covered
surviving pre-batch chars as one rank interval [dlo, dhi] plus their
count.  :func:`resolve_range` launches the CUDA kernel
(``csrc/resolve_range.cu``) on a CUDA tensor; :func:`resolve_range_plain`
is its plain PyTorch version.  :func:`range_token_walk` records where
each op acts on the list (its token, the tail it moves or clamps, the
tokens in use), the work the kernel does.

:func:`resolve_range_rows` is K1's per-row form, the serving fleet's
resolve (the JAX package's vmapped scan ``resolve_ranges_rows`` with
``ops/serve_fused.py round_starts``): every row is a different document
with its own K rounds of ops; each round starts from the visible total
the previous one left.  :func:`resolve_range_rows_plain` is its plain
version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..lint.boundary import boundary
from ..lint.sanitizer import kernel_body
from .._build import check, kernels
from ..traces.tensorize import DELETE, INSERT, PAD
from .resolve import FREE, RUN, TINS

I32 = torch.int32
_BIG = 1 << 30
#: Shared memory a block may use on Hopper (227 KB).
_MAX_SMEM = 232448
#: Most replicas (rows) a block of the kernel resolves, one warp each
#: (``kMaxWarps`` in ``csrc/resolve_range.cu``).
RANGE_MAX_WARPS = 4


def range_smem_bytes(T: int) -> int:
    """Shared memory of one K1 block at token list T: one (tta, tch, cum)
    list of T + 1 ints per field for each warp, as many warps as 227 KB
    hold, at most :data:`RANGE_MAX_WARPS` and at least one."""
    per_warp = 3 * (T + 1) * 4
    return max(1, min(RANGE_MAX_WARPS, _MAX_SMEM // per_warp)) * per_warp


def _check_smem(T: int, B: int, name: str) -> None:
    """Refuse, on every device, a batch the kernel could not hold: a call
    that runs on the CPU then runs on the card too."""
    if range_smem_bytes(T) > _MAX_SMEM:
        raise ValueError(
            f"{name}: batch {B} (token list {T}) outside the kernel's "
            "shared-memory range"
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def effective_token_list_size(B: int, token_cap: int | None) -> int:
    """The token-list size T for a batch of B ops under ``token_cap`` —
    the one formula shared with the overflow check of the replay engine."""
    return _round_up(min(2 * B + 2, token_cap) if token_cap else 2 * B + 2,
                     128)


def resolve_range_plain(kind, pos, rlen, slot0, v0, *,
                        token_cap: int | None = None):
    """Plain PyTorch version of K1 (any device): a Python loop over the
    ops with tensor passes over the (R, T) token list.  Same arguments and
    results as :func:`resolve_range`."""
    resolve_range_plain.calls += 1
    B = kind.shape[0]
    R = v0.shape[0]
    T = effective_token_list_size(B, token_cap)
    dev = v0.device
    lane = torch.arange(T, dtype=I32, device=dev)[None, :]
    tta = torch.where(lane == 0, RUN, FREE).to(I32).expand(R, T)
    tch = torch.zeros((R, T), dtype=I32, device=dev)
    cum = v0.to(I32)[:, None].expand(R, T)
    total = v0.to(I32)[:, None]
    nused = torch.ones((R, 1), dtype=I32, device=dev)
    dlo_o = torch.full((R, B), -1, dtype=I32, device=dev)
    dhi_o = torch.full((R, B), -1, dtype=I32, device=dev)
    dn_o = torch.zeros((R, B), dtype=I32, device=dev)

    def tsum(x):
        return x.sum(dim=1, keepdim=True, dtype=I32)

    ops = zip(kind.tolist(), pos.tolist(), rlen.tolist(), slot0.tolist())
    for j, (k, p0, L0, s0) in enumerate(ops):
        is_ins = k == INSERT and L0 > 0
        p = torch.minimum(torch.full_like(total, max(p0, 0)), total)
        if k == DELETE:
            D = torch.minimum(torch.full_like(total, max(L0, 0)), total - p)
        else:
            D = torch.zeros_like(total)
        is_del = (D > 0) & (k == DELETE)
        L = L0 if is_ins else 0

        pre_all = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
        is_run_tok = (tta & 3) == RUN

        # delete rank interval outputs (from the pre-clamp state)
        pD = p + D
        ov_lo = torch.maximum(pre_all, p)
        ov_hi = torch.minimum(cum, pD)
        has_ov = is_del & is_run_tok & (ov_hi > ov_lo)
        ta_all = tta >> 2
        r_lo = ta_all + (ov_lo - pre_all)
        r_hi = ta_all + (ov_hi - pre_all) - 1
        dlo = torch.where(has_ov, r_lo, _BIG).amin(dim=1, keepdim=True)
        dhi = torch.where(has_ov, r_hi, -1).amax(dim=1, keepdim=True)
        dcount = tsum(torch.where(has_ov, ov_hi - ov_lo, 0))
        dlo = torch.where(dlo >= _BIG, -1, dlo)

        # vector clamp (the delete's effect on every token)
        consumed = (torch.minimum(cum, pD) - torch.maximum(pre_all, p)).clamp(
            min=0
        )
        adv = torch.where(is_del & (cum > pD), consumed, 0)
        cum_c = torch.where(
            is_del, torch.minimum(cum, p) + (cum - pD).clamp(min=0), cum
        )
        tta_c = tta + torch.where(is_run_tok, adv * 4, 0)
        tch_c = tch + torch.where((tta & 3) == TINS, adv, 0)

        # the token holding p (pre-clamp coordinates)
        t = torch.minimum(tsum((cum <= p).to(I32)), nused)
        m_t = lane == t
        c_t = tsum(torch.where(m_t, cum, 0))
        pre = tsum(torch.where(m_t, pre_all, 0))
        tta_t = tsum(torch.where(m_t, tta, 0))
        ch = tsum(torch.where(m_t, tch, 0))
        tt = tta_t & 3
        off = p - pre
        is_run_t = tt == RUN

        split_ins = (off > 0) & is_ins
        split_del = is_del & (off > 0) & (pD < c_t)
        if is_ins:
            m = torch.where(split_ins, 3, 2).to(I32)
        else:
            m = torch.where(split_del, 2, 1).to(I32)

        c_t_cl = torch.where(
            is_del, torch.minimum(c_t, p) + (c_t - pD).clamp(min=0), c_t
        )
        adv_t = torch.where(
            is_del & (c_t > pD),
            (torch.minimum(c_t, pD) - torch.maximum(pre, p)).clamp(min=0),
            0,
        )
        tta_cl = tta_t + torch.where(is_run_t, adv_t * 4, 0)
        ch_cl = ch + torch.where(tt == TINS, adv_t, 0)
        tta_right_del = tta_t + torch.where(is_run_t, (pD - pre) * 4, 0)
        ch_right_del = torch.where(is_run_t, ch, ch + (pD - pre))
        tta_right_ins = tta_t + torch.where(is_run_t, off * 4, 0)
        ch_right_ins = torch.where(is_run_t, ch, ch + off)
        jj_tins = s0 * 4 + TINS

        if is_ins:
            n0ta = torch.where(split_ins, tta_cl, jj_tins)
            n0c = torch.where(split_ins, ch_cl, 0)
            n0cum = torch.where(split_ins, p, pre + L)
            n1ta = torch.where(split_ins, jj_tins, tta_t)
            n1c = torch.where(split_ins, 0, ch)
            n1cum = torch.where(split_ins, p + L, c_t + L)
        else:
            n0ta = torch.where(split_del, tta_t, tta_cl)
            n0c = torch.where(split_del, ch, ch_cl)
            n0cum = torch.where(split_del, p, c_t_cl)
            n1ta, n1c, n1cum = tta_right_del, ch_right_del, c_t - D
        n2ta, n2c, n2cum = tta_right_ins, ch_right_ins, c_t + L

        def place(x, x0, x1, x2, dlt):
            sh = torch.where(
                m == 1, x,
                torch.where(m == 2, torch.roll(x, 1, 1), torch.roll(x, 2, 1)),
            ) + dlt
            out = torch.where(lane < t, x, sh)
            out = torch.where(lane == t, x0, out)
            out = torch.where((m >= 2) & (lane == t + 1), x1, out)
            return torch.where((m == 3) & (lane == t + 2), x2, out)

        tta = place(tta_c, n0ta, n1ta, n2ta, 0)
        tch = place(tch_c, n0c, n1c, n2c, 0)
        cum = place(cum_c, n0cum, n1cum, n2cum, L)

        dlo_o[:, j:j + 1] = torch.where(is_del, dlo, dlo_o[:, j:j + 1])
        dhi_o[:, j:j + 1] = torch.where(is_del, dhi, dhi_o[:, j:j + 1])
        dn_o[:, j:j + 1] = torch.where(is_del, dcount, dn_o[:, j:j + 1])
        total = total + L - D
        nused = nused + (m - 1)

    tlen = cum - torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
    return (
        (tta & 3, tta >> 2, tch, tlen),
        (dlo_o, dhi_o, dn_o),
        nused,
    )


resolve_range_plain.calls = 0


class RangeWalk(NamedTuple):
    """Where each op of a batch acted on K1's token list (uncapped), and
    the final list's cum."""
    cum: torch.Tensor  # int64[R, T]  inclusive prefix of token lengths
    total: torch.Tensor  # int64[R]  visible total after the batch
    t: torch.Tensor  # int64[R, B]  the op's token (-1: it changes nothing)
    tail: torch.Tensor  # int64[R, B]  tokens after t it moved or clamped
    nused: torch.Tensor  # int64[R, B + 1]  in use before each op, then after


def range_token_walk(kind, pos, rlen, v0) -> RangeWalk:
    """Walk a batch of range ops over each replica's token list with the
    resolver's step, keeping cum alone (where an op acts and how many
    pieces its token becomes depend on positions only): a Python loop over
    the ops with tensor passes over the (R, T) list, as
    ``ops/resolve.py resolve_tokens_plain`` does for K5.

    kind/pos/rlen: int32[B] (shared by every replica) or int32[R, B] (a
    batch per row, as one round of the per-row form); v0: int32[R].  An op
    that acts moves or clamps the tail [t + 1, nused] (the FREE sentinel
    included): ``tail = nused - t``."""
    R = v0.shape[0]
    if kind.dim() == 1:
        kind, pos, rlen = (x.expand(R, -1) for x in (kind, pos, rlen))
    B = kind.shape[1]
    T = effective_token_list_size(B, None)
    dev = v0.device
    i64 = torch.int64
    kind, pos, rlen = (x.to(i64) for x in (kind, pos, rlen))
    col = torch.arange(T + 1, device=dev, dtype=torch.int64)[None, :]
    # C[:, i + 1] is token i's cum; column 0 is 0 "before" the first token
    C = torch.zeros((R, T + 1), dtype=i64, device=dev)
    C[:, 1:] = v0.to(i64)[:, None]
    total = v0.to(i64)[:, None]
    nused = torch.ones((R, 1), dtype=i64, device=dev)
    op_t = torch.full((R, B), -1, dtype=i64, device=dev)
    op_nused = torch.empty((R, B + 1), dtype=i64, device=dev)
    for j in range(B):
        op_nused[:, j:j + 1] = nused
        k, p0, L0 = kind[:, j:j + 1], pos[:, j:j + 1], rlen[:, j:j + 1]
        p = torch.minimum(p0.clamp(min=0), total)
        D = torch.where(k == DELETE,
                        torch.minimum(L0.clamp(min=0), total - p), 0)
        is_ins = (k == INSERT) & (L0 > 0)
        act = is_ins | (D > 0)
        L = torch.where(is_ins, L0, 0)
        pD = p + D
        t = torch.minimum((C[:, 1:] <= p).sum(1, keepdim=True), nused)
        # K1's plain walk: t <= nused < T, so t + 1 <= T (C has T + 1 columns)
        pre, c_t = C.gather(1, t), C.gather(1, t + 1)  # graftlint: disable=G026
        split = (p > pre) & (is_ins | (pD < c_t))
        m = torch.where(act, torch.where(is_ins, 2, 1) + split, 1)
        # the tail moved by m - 1 with cum + L (an insert) or clamped (a
        # delete); token t becomes its m pieces
        clamped = torch.minimum(C, p) + (C - pD).clamp(min=0)
        moved = torch.where(D > 0, clamped, C + L)
        # col < m - 1 lies left of token t, which the where below keeps
        Y = moved.gather(1, (col - (m - 1)).clamp(min=0))  # graftlint: disable=G026
        Y = torch.where(col <= t, C, Y)
        pieces = (
            torch.where(is_ins, torch.where(split, p, pre + L),
                        torch.where(split, p, clamped.gather(1, t + 1))),  # graftlint: disable=G026 (t + 1 <= T)
            torch.where(is_ins, torch.where(split, p + L, c_t + L), c_t - D),
            c_t + L,
        )
        for q, v in enumerate(pieces):
            Y = torch.where((col == t + 1 + q) & (m > q), v, Y)
        C = torch.where(act, Y, C)
        op_t[:, j:j + 1] = torch.where(act, t, -1)
        total = total + L - D
        nused = nused + (m - 1)
    op_nused[:, B:] = nused
    tail = torch.where(op_t >= 0, op_nused[:, :B] - op_t, 0)
    return RangeWalk(C[:, 1:], total[:, 0], op_t, tail, op_nused)


def resolve_range(kind, pos, rlen, slot0, v0, *,
                  token_cap: int | None = None):
    """Resolve one batch of range ops for R replicas (K1).

    kind/pos/rlen/slot0: int32[B] (shared by every replica); v0: int32[R]
    visible lengths.  Returns ((ttype, ta, tch, tlen) int32[R, T],
    (dlo, dhi, dcount) int32[R, B], nused int32[R, 1]) with
    T = effective_token_list_size(B, token_cap); ``ta`` is the pre-batch
    rank of a RUN token and the first slot id of a TINS token.  ``nused``
    is the batch's TRUE token demand: callers compare it with T, since
    placements past T are dropped.  On a CUDA tensor this launches the
    kernel (or raises); on a CPU tensor it runs
    :func:`resolve_range_plain`."""
    B = kind.shape[0]
    R = v0.shape[0]
    for name, t, n in (("kind", kind, B), ("pos", pos, B),
                       ("rlen", rlen, B), ("slot0", slot0, B),
                       ("v0", v0, R)):
        if t.device != v0.device:
            raise ValueError(f"{name} on {t.device}, v0 on {v0.device}")
        if t.dtype != I32 or tuple(t.shape) != (n,):
            raise ValueError(
                f"{name}: want int32[{n}], got {t.dtype}{list(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    T = effective_token_list_size(B, token_cap)
    _check_smem(T, B, "resolve_range")
    if v0.device.type == "cpu":
        return resolve_range_plain(
            kind, pos, rlen, slot0, v0, token_cap=token_cap
        )
    if v0.device.type != "cuda":
        raise ValueError(f"resolve_range: unsupported device {v0.device}")
    mk = lambda n: torch.empty((R, n), dtype=I32, device=v0.device)
    ttype, ta, tch, tlen = mk(T), mk(T), mk(T), mk(T)
    dlo, dhi, dn, nused = mk(B), mk(B), mk(B), mk(1)
    if R:
        lib = kernels()
        err = lib.crdt_resolve_range(
            kind.data_ptr(), pos.data_ptr(), rlen.data_ptr(),
            slot0.data_ptr(), v0.data_ptr(), R, B, T,
            ttype.data_ptr(), ta.data_ptr(), tch.data_ptr(),
            tlen.data_ptr(), dlo.data_ptr(), dhi.data_ptr(), dn.data_ptr(),
            nused.data_ptr(),
            torch.cuda.current_stream(v0.device).cuda_stream,
        )
        check(err, "crdt_resolve_range")
        resolve_range.launches += 1
    return (ttype, ta, tch, tlen), (dlo, dhi, dn), nused


resolve_range.launches = 0


def _check_rows_operands(kind, pos, rlen, slot0, v0):
    if kind.dim() != 3:
        raise ValueError(f"kind: want int32[K, R, B], got {list(kind.shape)}")
    K, R, B = kind.shape
    for name, t, shape in (("kind", kind, (K, R, B)), ("pos", pos, (K, R, B)),
                           ("rlen", rlen, (K, R, B)),
                           ("slot0", slot0, (K, R, B)), ("v0", v0, (R,))):
        if t.device != v0.device:
            raise ValueError(f"{name} on {t.device}, v0 on {v0.device}")
        if t.dtype != I32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want int32{list(shape)}, got {t.dtype}"
                f"{list(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return K, R, B


@kernel_body
def resolve_range_rows_plain(kind, pos, rlen, slot0, v0):
    """Plain PyTorch version of K1's per-row form (any device): per round,
    a loop over the B op columns with tensor passes over every row's
    (R, T) token list — the JAX package's ``res_step`` applied to all rows
    at once.  Same arguments and results as :func:`resolve_range_rows`."""
    resolve_range_rows_plain.calls += 1
    K, R, B = _check_rows_operands(kind, pos, rlen, slot0, v0)
    T = effective_token_list_size(B, None)
    dev = v0.device
    lane = torch.arange(T, dtype=I32, device=dev)[None, :]
    zero = torch.zeros((R, 1), dtype=I32, device=dev)
    toks = [torch.empty((K, R, T), dtype=I32, device=dev) for _ in range(4)]
    dints = [torch.full((K, R, B), v, dtype=I32, device=dev)
             for v in (-1, -1, 0)]
    starts = torch.empty((K, R), dtype=I32, device=dev)

    def tsum(x):
        return x.sum(dim=1, keepdim=True, dtype=I32)

    total = v0.to(I32)[:, None]
    for r in range(K):
        starts[r] = total[:, 0]
        tta = torch.where(lane == 0, RUN, FREE).to(I32).expand(R, T)
        tch = torch.zeros((R, T), dtype=I32, device=dev)
        cum = total.expand(R, T)
        nused = torch.ones((R, 1), dtype=I32, device=dev)
        live_cols = (kind[r] != PAD).any(dim=0).nonzero().flatten().tolist()
        for j in live_cols:  # a PAD op leaves the token list as it is
            k = kind[r, :, j:j + 1]
            p0 = pos[r, :, j:j + 1]
            L0 = rlen[r, :, j:j + 1]
            s0 = slot0[r, :, j:j + 1]
            is_ins = (k == INSERT) & (L0 > 0)
            p = torch.minimum(p0.clamp(min=0), total)
            D = torch.where(
                k == DELETE, torch.minimum(L0.clamp(min=0), total - p), zero
            )
            is_del = (k == DELETE) & (D > 0)
            L = torch.where(is_ins, L0, zero)

            pre_all = torch.cat([zero, cum[:, :-1]], 1)
            ttok = tta & 3
            is_run_tok = ttok == RUN
            # delete rank interval outputs (pre-clamp coordinates)
            pD = p + D
            ov_lo = torch.maximum(pre_all, p)
            ov_hi = torch.minimum(cum, pD)
            has_ov = is_del & is_run_tok & (ov_hi > ov_lo)
            ta_all = tta >> 2
            dlo = torch.where(has_ov, ta_all + (ov_lo - pre_all), _BIG).amin(
                dim=1, keepdim=True)
            dhi = torch.where(has_ov, ta_all + (ov_hi - pre_all) - 1, -1).amax(
                dim=1, keepdim=True)
            dn = tsum(torch.where(has_ov, ov_hi - ov_lo, 0))
            dints[0][r, :, j] = torch.where(is_del & (dlo < _BIG), dlo, -1)[:, 0]
            dints[1][r, :, j] = torch.where(is_del, dhi, -1)[:, 0]
            dints[2][r, :, j] = torch.where(is_del, dn, 0)[:, 0]

            # vector clamp: the delete's effect on every token
            consumed = (torch.minimum(cum, pD)
                        - torch.maximum(pre_all, p)).clamp(min=0)
            adv = torch.where(is_del & (cum > pD), consumed, 0)
            cum_c = torch.where(
                is_del, torch.minimum(cum, p) + (cum - pD).clamp(min=0), cum
            )
            tta_c = tta + torch.where(is_run_tok, adv * 4, 0)
            tch_c = tch + torch.where(ttok == TINS, adv, 0)

            # the token holding p (pre-clamp coordinates); t < T always
            t = torch.minimum(tsum((cum <= p).to(I32)), nused)
            ti = t.long()
            c_t = cum.gather(1, ti)
            pre = pre_all.gather(1, ti)
            tta_t = tta.gather(1, ti)
            ch = tch.gather(1, ti)
            tt = tta_t & 3
            off = p - pre
            is_run_t = tt == RUN
            split_ins = is_ins & (off > 0)
            split_del = is_del & (off > 0) & (pD < c_t)
            m = torch.where(is_ins, torch.where(split_ins, 3, 2),
                            torch.where(split_del, 2, 1)).to(I32)

            c_t_cl = torch.where(
                is_del, torch.minimum(c_t, p) + (c_t - pD).clamp(min=0), c_t
            )
            adv_t = torch.where(
                is_del & (c_t > pD),
                (torch.minimum(c_t, pD) - torch.maximum(pre, p)).clamp(min=0),
                0,
            )
            tta_cl = tta_t + torch.where(is_run_t, adv_t * 4, 0)
            ch_cl = ch + torch.where(tt == TINS, adv_t, 0)
            jj_tins = s0 * 4 + TINS
            n0ta = torch.where(is_ins & ~split_ins, jj_tins,
                               torch.where(split_del, tta_t, tta_cl))
            n0c = torch.where(is_ins & ~split_ins, 0,
                              torch.where(split_del, ch, ch_cl))
            n0cum = torch.where(is_ins, torch.where(split_ins, p, pre + L),
                                torch.where(split_del, p, c_t_cl))
            n1ta = torch.where(
                is_ins, torch.where(split_ins, jj_tins, tta_t),
                tta_t + torch.where(is_run_t, (pD - pre) * 4, 0))
            n1c = torch.where(is_ins, torch.where(split_ins, 0, ch),
                              torch.where(is_run_t, ch, ch + (pD - pre)))
            n1cum = torch.where(is_ins, torch.where(split_ins, p + L, c_t + L),
                                c_t - D)
            n2ta = tta_t + torch.where(is_run_t, off * 4, 0)
            n2c = torch.where(is_run_t, ch, ch + off)
            n2cum = c_t + L
            src = (lane - (m - 1)).clamp(0, T - 1).long()

            def place(x, x0, x1, x2, dlt):
                out = torch.where(lane < t, x, x.gather(1, src) + dlt)
                out = torch.where(lane == t, x0, out)
                out = torch.where((m >= 2) & (lane == t + 1), x1, out)
                return torch.where((m == 3) & (lane == t + 2), x2, out)

            tta = place(tta_c, n0ta, n1ta, n2ta, 0)
            tch = place(tch_c, n0c, n1c, n2c, 0)
            cum = place(cum_c, n0cum, n1cum, n2cum, L)
            total = total + L - D
            nused = nused + (m - 1)
        toks[0][r] = tta & 3
        toks[1][r] = tta >> 2
        toks[2][r] = tch
        toks[3][r] = cum - torch.cat([zero, cum[:, :-1]], 1)
    return tuple(toks), tuple(dints), starts


resolve_range_rows_plain.calls = 0


@boundary(
    # JAX's contract of its per-row resolver (the XLA twin of K1's per-row
    # form), over the K rounds this form takes at once
    dtypes=("int32", "int32", "int32", "int32", "int32"),
    shapes=("K R B", "K R B", "K R B", "K R B", "R"),
)
def resolve_range_rows(kind, pos, rlen, slot0, v0):
    """Resolve K rounds of per-row range ops (K1's per-row form).

    kind/pos/rlen/slot0: int32[K, R, B], row r of round k the ops of the
    document in row r; v0: int32[R] the visible lengths before round 0.
    Returns ((ttype, ta, tch, tlen) int32[K, R, T], (dlo, dhi, dcount)
    int32[K, R, B], starts int32[K, R]) with T = round_up(2B + 2, 128)
    (the list never overflows: B ops need at most 2B + 1 tokens; tokens
    past 2B + 2 are FREE with zero length).  ``starts[k]`` is the visible
    total before round k, clamped as the resolve clamps.  On a CUDA tensor
    this launches the kernel (or raises); on a CPU tensor it runs
    :func:`resolve_range_rows_plain`."""
    K, R, B = _check_rows_operands(kind, pos, rlen, slot0, v0)
    T = effective_token_list_size(B, None)
    _check_smem(T, B, "resolve_range_rows")
    if v0.device.type == "cpu":
        return resolve_range_rows_plain(kind, pos, rlen, slot0, v0)
    if v0.device.type != "cuda":
        raise ValueError(f"resolve_range_rows: unsupported device {v0.device}")
    mk = lambda n: torch.empty((K, R, n), dtype=I32, device=v0.device)
    ttype, ta, tch, tlen = mk(T), mk(T), mk(T), mk(T)
    dlo, dhi, dn = mk(B), mk(B), mk(B)
    starts = torch.empty((K, R), dtype=I32, device=v0.device)
    if K and R:
        # the launch goes to the host thread's current device: make it the
        # operands' (a mesh shard may live on another GPU)
        with torch.cuda.device(v0.device):
            err = kernels().crdt_resolve_range_rows(
                kind.data_ptr(), pos.data_ptr(), rlen.data_ptr(),
                slot0.data_ptr(), v0.data_ptr(), K, R, B, T,
                ttype.data_ptr(), ta.data_ptr(), tch.data_ptr(),
                tlen.data_ptr(), dlo.data_ptr(), dhi.data_ptr(),
                dn.data_ptr(), starts.data_ptr(),
                torch.cuda.current_stream(v0.device).cuda_stream,
            )
        check(err, "crdt_resolve_range_rows")
        resolve_range_rows.launches += 1
    return (ttype, ta, tch, tlen), (dlo, dhi, dn), starts


resolve_range_rows.launches = 0
