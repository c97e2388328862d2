"""The serving fleet's fused macro apply (the JAX package's
``ops/serve_fused.py``): K resolved rounds of per-row range ops applied to
a ``PackedState`` stack whose rows are different documents.

The resolve of a macro dispatch depends on the documents only through
their running visible counts, so the K rounds resolve first (K1's per-row
form, :func:`resolve_range_rows`, which also yields each round's starting
count, JAX's :func:`round_starts`), and :func:`serve_round_inputs` derives
every round's B/T-sized operands and its starting length and visible
count from the resolve outputs alone.  :func:`serve_macro_fused` then
applies all K rounds in ONE launch of K4 (``csrc/serve_macro.cu``), each
document row resident across the rounds in the shared memory of a
thread-block cluster (:func:`serve_macro_geometry`).
:func:`serve_macro_plain` is K4's plain version: the per-round apply
:func:`serve_apply_round_plain` (JAX's ``serve_apply_round_xla``, the
same contract as ``apply_range_batch``) looped over the rounds.

JAX's kernel expands each round with an ``nbits`` roll cascade, exact only
while 2^nbits exceeds a round's inserted chars per row; the port's
expansion is one gather and needs no ``nbits``.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, kernels
from ..lint.sanitizer import kernel_body
from ..traces.tensorize import DELETE, INSERT
from .apply2 import PackedState, _scatter_rows, _zeros_like_rows, count_le_tiled
from .apply_range import _prev_value, extract_range_tokens
from .resolve import TINS

I32 = torch.int32


def round_total_delta(kind, pos, rlen, v0):
    """Advance the visible-count recurrence across one round: kind/pos/
    rlen int32[R, B], v0 int32[R] -> the next round's v0.  Positions clip
    to [0, total] and deletes to the remaining suffix, as the resolve
    clamps them."""
    tot = v0.to(I32)
    for j in range(kind.shape[1]):
        k, p0, L0 = kind[:, j], pos[:, j], rlen[:, j]
        p = torch.minimum(p0.clamp(min=0), tot)
        D = torch.where(k == DELETE, torch.minimum(L0.clamp(min=0), tot - p),
                        0)
        L = torch.where((k == INSERT) & (L0 > 0), L0, 0)
        tot = tot + L - D
    return tot


def round_starts(kind, pos, rlen, v0):
    """The visible count before each round of a macro dispatch:
    kind/pos/rlen int32[K, R, B], v0 int32[R] -> int32[K, R]."""
    out = []
    tot = v0.to(I32)
    for k in range(kind.shape[0]):
        out.append(tot)
        tot = round_total_delta(kind[k], pos[k], rlen[k], tot)
    return torch.stack(out)


def serve_round_inputs(tokens, dints, length0, nvis0):
    """Per-round operands of the K resolved rounds: tokens (ttype, ta, tch,
    tlen) int32[K, R, T], dints (dlo, dhi, dcount) int32[K, R, B],
    length0/nvis0 int32[R] the dispatch's starting state.  Round k's
    starting length and visible count follow from the insert and delete
    volumes of the rounds before it.  Returns (live, gvis, cumlen
    int32[K, R, T], len_k, nvis_k, newlen int32[K, R], length_K, nvis_K
    int32[R])."""
    dev = tokens[0].device
    if dev.type == "cuda":
        with torch.cuda.device(dev):  # launches on the operands' device
            return _round_inputs(tokens, dints, length0, nvis0)
    return _round_inputs(tokens, dints, length0, nvis0)


def _round_inputs(tokens, dints, length0, nvis0):
    ttype, ta, tch, tlen = tokens
    dlo, dhi, dcount = dints
    K, R, T = ttype.shape
    live0 = (ttype == TINS) & (tlen > 0)
    n_ins = torch.where(live0, tlen, 0).sum(2, dtype=I32)  # (K, R)
    n_del = torch.where(dlo >= 0, dcount, 0).sum(2, dtype=I32)
    ins_cum = torch.cumsum(n_ins, 0, dtype=I32)
    del_cum = torch.cumsum(n_del, 0, dtype=I32)
    len_k = length0[None, :] + ins_cum - n_ins
    nvis_k = nvis0[None, :] + (ins_cum - n_ins) - (del_cum - n_del)
    newlen = length0[None, :] + ins_cum
    flat = lambda x: x.reshape(K * R, T)
    live, gvis, cumlen = extract_range_tokens(
        flat(ttype), flat(ta), flat(tch), flat(tlen), nvis_k.reshape(K * R)
    )
    back = lambda x: x.reshape(K, R, T)
    return (
        back(live.to(I32)), back(gvis), back(cumlen), len_k, nvis_k, newlen,
        length0 + ins_cum[-1], nvis0 + ins_cum[-1] - del_cum[-1],
    )


def _spread(idx, val, C: int):
    """int32[R, C] with val[r, b] added at idx[r, b] (out of range
    dropped)."""
    return _scatter_rows(_zeros_like_rows(idx, C), idx, val)


def serve_apply_round_plain(state: PackedState, tokens, dints) -> PackedState:
    """One round's range apply (any device): tokens int32[R, T], dints
    int32[R, B] from the round's resolve against ``state.nvis``.  Deletes
    clear the visible bits over their physical rank intervals; each live
    insert run lands at its gap's position plus the live chars before it;
    the old entries shift right by one gather y[d] = x[d - cnt[d]]; the
    holes get their fill and everything past the new length is 2.  The
    work runs on the columns below the rows' largest new length (rounded
    up to 128); every column past it is 2."""
    ttype, ta, tch, tlen = tokens
    dlo, dhi, dcount = dints
    R, C_full = state.doc.shape
    B = dlo.shape[1]
    has_del = dlo >= 0
    live, gvis, cumlen = extract_range_tokens(ttype, ta, tch, tlen,
                                              state.nvis)
    n_ins = torch.where(live, tlen, 0).sum(1, dtype=I32)
    n_del = torch.where(has_del, dcount, 0).sum(1, dtype=I32)
    new_len = state.length + n_ins
    # at least one tile: rows that stay empty still take the round
    C = min(C_full, max(1, -(-int(new_len.max()) // 128)) * 128)
    drop = C + 7
    col = torch.arange(C, dtype=I32, device=state.doc.device)[None, :]
    length = state.length[:, None]
    doc_in = state.doc[:, :C]
    vis_bit = doc_in & 1

    allq_in = torch.cat([torch.where(has_del, dlo, 0),
                         torch.where(has_del, dhi, 0),
                         torch.where(live, gvis, 0)], 1)
    cumvis = torch.cumsum(vis_bit * (col < length), 1, dtype=I32)
    allq = count_le_tiled(cumvis, allq_in)
    lo_phys, hi_phys, gq_phys = allq[:, :B], allq[:, B:2 * B], allq[:, 2 * B:]

    # deletes: clear the visible bits over the physical rank intervals
    hd = has_del.to(I32)
    depth = torch.cumsum(
        _spread(torch.where(has_del, lo_phys, drop), hd, C)
        - _spread(torch.where(has_del, hi_phys + 1, drop), hd, C),
        1, dtype=I32)
    doc = doc_in - (vis_bit & (depth > 0).to(I32))

    # insert runs: destinations, the hole map, per-run slot deltas
    g_phys = torch.where(gvis >= state.nvis[:, None], length, gq_phys)
    dest0 = torch.where(live, g_phys + cumlen, drop)
    dstop = torch.where(live, dest0 + tlen, drop)
    lv = live.to(I32)
    ind = (torch.cumsum(_spread(dest0, lv, C) - _spread(dstop, lv, C), 1,
                        dtype=I32) > 0).to(I32)
    cnt = torch.cumsum(ind, 1, dtype=I32)
    delta = torch.where(live, ta + tch - dest0, 0)
    ddelta = torch.where(live, delta - _prev_value(delta, live), 0)
    delta_cum = torch.cumsum(_spread(dest0, ddelta, C), 1, dtype=I32)

    # expansion: one gather, then the fill at the holes (col - cnt < 0
    # only at holes, which the fill overwrites)
    doc = doc.gather(1, (col - cnt).clamp(min=0).long())
    doc = torch.where(ind > 0, ((col + delta_cum + 2) << 1) | 1, doc)

    out = torch.full_like(state.doc, 2)
    out[:, :C] = torch.where(col >= new_len[:, None], 2, doc)
    return PackedState(
        doc=out,
        length=new_len,
        nvis=state.nvis + n_ins - n_del,
    )


@kernel_body
def serve_macro_plain(state: PackedState, tokens, dints) -> PackedState:
    """Plain PyTorch version of K4 (any device): the K resolved rounds
    (tokens int32[K, R, T], dints int32[K, R, B]) applied in turn with
    :func:`serve_apply_round_plain`."""
    serve_macro_plain.calls += 1
    for k in range(tokens[0].shape[0]):
        state = serve_apply_round_plain(
            state, tuple(t[k] for t in tokens), tuple(d[k] for d in dints)
        )
    return state


serve_macro_plain.calls = 0

#: The H100's SM count and the shared memory one block may opt in to
#: (227 KB): :func:`serve_macro_geometry`'s defaults.  A launch reads the
#: card's own (:func:`serve_macro_launch_geometry`).
SM_COUNT = 132
SMEM_LIMIT = 232_448
#: The most K4 keeps in static shared memory (scan scratch, one query
#: chunk's deltas, the ranks' bases, the published total).
STATIC_SMEM = 2048
#: The narrowest slice a row is cut into to reach more SMs.
MIN_SLICE = 512
#: The largest cluster (16 needs the non-portable cluster size; 8 is
#: portable).
MAX_CLUSTER = 16


def _slice_ints(width: int) -> int:
    """int32 words of one K4 block's slices of ``width`` columns: two
    rotating doc slices, three boundary spreads, one visible-bit word per
    32 columns and one group count per 128, rounded up to 4 words so that
    each block's part of a device-memory scratch is 16-byte aligned
    (``slice_ints`` in the source)."""
    return 5 * width + width // 32 + -(-(width // 128) // 4) * 4


def _smem_bytes(n: int, width: int, resident: bool) -> int:
    """Shared memory of one K4 block: the static part, the slices when
    resident, and the group counts of all ``n`` ranks."""
    return STATIC_SMEM + 4 * ((_slice_ints(width) if resident else 0)
                              + n * (width // 128))


def max_slice(smem_limit: int = SMEM_LIMIT) -> int:
    """The widest slice a block holds in shared memory in a cluster of
    ``MAX_CLUSTER`` (11,136 columns on the H100)."""
    return max(w for w in range(128, smem_limit, 128)
               if _smem_bytes(MAX_CLUSTER, w, True) <= smem_limit)


MAX_SLICE = max_slice()


def serve_macro_geometry(Rt: int, C: int, max_cluster: int = MAX_CLUSTER,
                         sm_count: int = SM_COUNT,
                         smem_limit: int = SMEM_LIMIT):
    """K4's launch geometry for ``Rt`` rows of capacity ``C`` (a multiple
    of 128) on a card of ``sm_count`` SMs and ``smem_limit`` bytes of
    shared memory a block: ``(n, slice, smem_bytes, resident)``.  Each row
    takes a cluster of ``n`` blocks, block j the columns [j * slice, j *
    slice + slice) (the last may be shorter; none is empty).  n = 1 up to
    C = 1024; past it n doubles while Rt * n is below the SM count and the
    slices stay at least ``MIN_SLICE`` wide, and further until the row
    fits ``n *`` :func:`max_slice`, never past ``max_cluster``.
    ``resident``: the slices fit in shared memory (``smem_bytes`` a block,
    its static part included); otherwise they live in a device-memory
    scratch, above ``max_cluster * max_slice(smem_limit)`` columns."""
    reach = max_slice(smem_limit)
    n = 1
    if C > 1024:
        while (n < max_cluster and Rt * n < sm_count
               and C >= 2 * n * MIN_SLICE):
            n *= 2
        while n < max_cluster and C > n * reach:
            n *= 2
        n = min(n, max_cluster)
    width = -(-C // (128 * n)) * 128
    n = -(-C // width)
    resident = width <= reach
    return n, width, _smem_bytes(n, width, resident), resident


_launch_geometry: dict[tuple[int, int, int], tuple] = {}


def serve_macro_launch_geometry(Rt: int, C: int, device=None):
    """The geometry K4 launches with on ``device`` (the current CUDA
    device by default): the first :func:`serve_macro_geometry` for the
    card's SM count and shared memory, with a cluster of at most 16, 8, 4,
    2 blocks in turn, of which the card holds all ``Rt`` clusters at once
    (``cudaOccupancyMaxActiveClusters``), else the first it can schedule
    at all.  Returns ``(n, slice, smem_bytes, resident,
    active_clusters)`` (``active_clusters`` None at n = 1); cached per
    device and shape."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, Rt, C)
    if key not in _launch_geometry:
        lib = kernels()
        with torch.cuda.device(index):
            sms, optin = ctypes.c_int(0), ctypes.c_int(0)
            check(lib.crdt_serve_macro_device(ctypes.addressof(sms),
                                              ctypes.addressof(optin)),
                  "crdt_serve_macro_device")
            chosen = None
            for mc in (16, 8, 4, 2, 1):
                geo = serve_macro_geometry(Rt, C, mc, sms.value, optin.value)
                n, width, _, resident = geo
                if n == 1:
                    chosen = chosen or (*geo, None)
                    break
                count = ctypes.c_int(0)
                err = lib.crdt_serve_macro_clusters(
                    Rt, n, width, int(resident), ctypes.addressof(count))
                if err or not count.value:
                    continue
                if count.value >= Rt:
                    chosen = (*geo, count.value)
                    break
                chosen = chosen or (*geo, count.value)
        _launch_geometry[key] = chosen
    return _launch_geometry[key]


def _check_operands(state: PackedState, tokens, dints, out):
    doc = state.doc
    if doc.dim() != 2 or doc.dtype != I32 or not doc.is_contiguous():
        raise ValueError(f"doc: want contiguous int32[R, C], got "
                         f"{doc.dtype}{list(doc.shape)}")
    R, C = doc.shape
    if C % 128:
        raise ValueError(f"capacity {C} is not a multiple of 128")
    K, _, T = tokens[0].shape
    B = dints[0].shape[2]
    if K < 1 or R < 1:
        raise ValueError(f"want at least one round and one row, got K={K}, "
                         f"R={R}")
    named = [("length", state.length, (R,)), ("nvis", state.nvis, (R,))]
    named += [(f"tokens[{i}]", t, (K, R, T)) for i, t in enumerate(tokens)]
    named += [(f"dints[{i}]", d, (K, R, B)) for i, d in enumerate(dints)]
    if out is not None:
        named.append(("out", out, (R, C)))
    for name, t, shape in named:
        if t.device != doc.device:
            raise ValueError(f"{name} on {t.device}, doc on {doc.device}")
        if t.dtype != I32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want int32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return K, R, B, T, C


def serve_macro_fused(state: PackedState, tokens, dints, *, inputs=None,
                      out: torch.Tensor | None = None) -> PackedState:
    """Apply K resolved rounds to a ``PackedState`` stack (K4).

    state: doc int32[R, C] (C a multiple of 128), length/nvis int32[R];
    tokens (ttype, ta, tch, tlen) int32[K, R, T] and dints (dlo, dhi,
    dcount) int32[K, R, B], round k resolved against the visible count
    the rounds before it leave (K1's per-row form).  ``inputs`` is
    :func:`serve_round_inputs` of them, computed here when not given.
    ``out`` receives the
    new doc and may be ``state.doc`` itself (the update is then in place);
    by default a new tensor.  Returns the new state.  On a CUDA tensor
    this launches the kernel (or raises); on a CPU tensor it runs
    :func:`serve_macro_plain`."""
    K, R, B, T, C = _check_operands(state, tokens, dints, out)
    dev = state.doc.device
    if dev.type == "cpu":
        new = serve_macro_plain(state, tokens, dints)
        if out is None:
            return new
        out.copy_(new.doc)
        return PackedState(out, new.length, new.nvis)
    if dev.type != "cuda":
        raise ValueError(f"serve_macro_fused: unsupported device {dev}")
    if inputs is None:
        inputs = serve_round_inputs(tokens, dints, state.length, state.nvis)
    live, gvis, cumlen, len_k, nvis_k, newlen, length_K, nvis_K = inputs
    doc_out = torch.empty_like(state.doc) if out is None else out
    n, width, _, resident, _ = serve_macro_launch_geometry(R, C, dev)
    scratch = None
    if not resident:  # rows past the shared-memory reach
        scratch = torch.empty(R * n * _slice_ints(width), dtype=I32,
                              device=dev)
    # the launch goes to the host thread's current device: make it the
    # state's (a mesh shard may live on another GPU)
    with torch.cuda.device(dev):
        err = kernels().crdt_serve_macro(
            state.doc.data_ptr(), dints[0].data_ptr(), dints[1].data_ptr(),
            gvis.data_ptr(), live.data_ptr(), cumlen.data_ptr(),
            tokens[1].data_ptr(), tokens[2].data_ptr(), tokens[3].data_ptr(),
            len_k.data_ptr(),
            nvis_k.data_ptr(), newlen.data_ptr(), K, R, B, T, C, n, width,
            int(resident), doc_out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "crdt_serve_macro")
    serve_macro_fused.launches += 1
    return PackedState(doc_out, length_K, nvis_K)


serve_macro_fused.launches = 0
