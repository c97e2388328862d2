"""Fused batch applications (the JAX package's
``ops/apply_range_fused.py``): the range v4 path, and the fused unit
apply K6 (:func:`apply_fused2`, ``csrc/unit_apply.cu``, with its plain
version :func:`apply_fused2_plain`) that ``apply2.apply_batch4`` calls.

Per batch the producer (:func:`range_apply_operands`) does the B/T-sized
work — token extraction, rank queries against the maintained two-level
visibility structure — and paints three dense int32[R, C] operand arrays
with one ``scatter_add_`` each (out-of-range indices dropped):

- ``delpk``: delete-interval starts in bits 0..dsh-1, one-past-end stops
  in bits dsh..2*dsh-1 (:func:`_del_stop_shift`; the packing is the JAX
  kernel's input contract, so the two are held against each other
  directly);
- ``ind_d``: +1 at each insert run's first destination, -1 one past it;
- ``dd``: each run's slot-delta difference at its first destination.

Every capacity-wide pass then runs in ONE kernel: delete clear, hole map,
expansion as a gather, fill, beyond-length stamp and the next batch's
``cv_intile`` / ``vis_tile``.  Two kernels compute that one function
(:func:`range_apply_plain` is its plain PyTorch version):

- :func:`range_apply` (K2, ``csrc/range_apply.cu``): one block per replica
  row, walking the row's live columns chunk by chunk, its operands staged
  ahead by TMA, the gather from a shared-memory ring of x, and a source
  older than the ring read as doc with x's vis bit
  (:func:`range_apply_ring_misses` counts those);
- :func:`range_apply_blocked` (K3, ``csrc/range_apply_blocked.cu``): each
  row split across blocks of 4096 columns, the row's prefixes carried by
  chained scans with decoupled look-back, columns past new_len not read.

:func:`range_apply_dispatch` picks one by
:func:`range_apply_takes_blocked`, as the JAX ``apply_range_batch4``
sends long documents to ``range_fused_blocked``: there the limit is the
TPU's VMEM, here whether the rows are many enough for one block a row.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check, kernels
from .apply2 import (
    LANE,
    PackedState4,
    _excl_cumsum_small,
    _scatter_rows,
    _zeros_like_rows,
    count_le_two_level,
    tile_cumsum,
)
from .apply_range import _prev_value, extract_range_tokens
from .expand import _sm_count

I32 = torch.int32


def _del_stop_shift(B: int) -> int:
    """Bit position of the stop-count field in ``delpk``: the field must
    hold counts up to B (2^dsh > B) and both fields must fit int32.  Equals
    the JAX package's choice (14 up to B = 1024, bit_length(B) above) at
    every batch size that package accepts."""
    sh = 14 if B <= 1024 else B.bit_length()
    if 2 * sh > 31:
        raise ValueError(f"op batch {B} too large for the packed delete field")
    return sh


def range_apply_plain(doc, delpk, ind_d, dd, new_len, dsh: int):
    """Plain PyTorch version of the fused range apply (any device).
    Returns (doc' int32[R, C], cv_intile int16[R, C], vis_tile int32[R, nt])."""
    range_apply_plain.calls += 1
    R, C = doc.shape
    col = torch.arange(C, dtype=I32, device=doc.device)
    deld = (delpk & ((1 << dsh) - 1)) - (delpk >> dsh)
    depth = torch.cumsum(deld, dim=1, dtype=I32)
    x = doc - ((doc & 1) & (depth > 0).to(I32))
    run = torch.cumsum(ind_d, dim=1, dtype=I32) > 0
    cnt = torch.cumsum(run.to(I32), dim=1, dtype=I32)
    y = x.gather(1, (col - cnt).clamp(min=0).long())
    fill = ((col + torch.cumsum(dd, dim=1, dtype=I32) + 2) << 1) | 1
    out = torch.where(run, fill, y)
    out = torch.where(col >= new_len[:, None], 2, out).to(I32)
    cv = tile_cumsum(out & 1)
    return (
        out,
        cv.reshape(R, C).to(torch.int16),
        cv[:, :, LANE - 1].contiguous(),
    )


range_apply_plain.calls = 0


def _check_operands(doc, *rows, new_len):
    """Every operand int32 and contiguous on doc's device: ``rows`` as
    (name, tensor) pairs of doc's (R, C), new_len (R,); C % 128 == 0."""
    R, C = doc.shape
    if C % LANE:
        raise ValueError(f"capacity {C} is not a multiple of {LANE}")
    for name, t, shape in (
        ("doc", doc, (R, C)),
        *((n, t, (R, C)) for n, t in rows),
        ("new_len", new_len, (R,)),
    ):
        if t.device != doc.device:
            raise ValueError(f"{name} on {t.device}, doc on {doc.device}")
        if t.dtype != I32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want int32{list(shape)}, got "
                f"{t.dtype}{list(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


#: Columns a K2 chunk covers (``kChunk`` in ``csrc/range_apply.cu``).
K2_CHUNK = 2048
#: Columns of x K2's shared-memory ring holds (``kRing``): the chunk being
#: gathered and the three before it.
K2_RING = 8192


def range_apply_ring_misses(ind_d, new_len) -> int:
    """How many columns K2 sources from left of its x ring (doc read again,
    with x's vis bit from its bit row): those below their row's new_len,
    outside a run, whose source max(d - cnt[d], 0) lies left of the ring
    (the K2_RING columns ending with d's chunk)."""
    C = ind_d.shape[1]
    col = torch.arange(C, device=ind_d.device, dtype=torch.int64)
    run = torch.cumsum(ind_d, dim=1, dtype=I32) > 0
    cnt = torch.cumsum(run.to(I32), dim=1, dtype=I32)
    src = (col - cnt).clamp(min=0)
    ring_lo = col // K2_CHUNK * K2_CHUNK + K2_CHUNK - K2_RING
    miss = (col < new_len[:, None]) & ~run & (src < ring_lo)
    return int(miss.sum())


def range_apply(doc, delpk, ind_d, dd, new_len, dsh: int, *, spills=None):
    """Fused range apply K2, one block per replica row.  On a CUDA tensor
    it launches the kernel of ``csrc/range_apply.cu`` (or raises); on a
    CPU tensor it runs :func:`range_apply_plain`.  Same contract as the
    JAX ``range_fused`` / ``range_fused_blocked``, with ``cv_intile`` as
    int16.  ``spills``, an int64[1] on doc's device, gets the count of
    :func:`range_apply_ring_misses` added (by the kernel on the card)."""
    _check_operands(doc, ("delpk", delpk), ("ind_d", ind_d), ("dd", dd),
                    new_len=new_len)
    if spills is not None and (spills.device != doc.device
                               or spills.dtype != torch.int64
                               or tuple(spills.shape) != (1,)):
        raise ValueError(f"spills: want int64[1] on {doc.device}, got "
                         f"{spills.dtype}{list(spills.shape)} on "
                         f"{spills.device}")
    if doc.device.type == "cpu":
        if spills is not None:
            spills += range_apply_ring_misses(ind_d, new_len)
        return range_apply_plain(doc, delpk, ind_d, dd, new_len, dsh)
    if doc.device.type != "cuda":
        raise ValueError(f"range_apply: unsupported device {doc.device}")
    for name, t in (("doc", doc), ("delpk", delpk), ("ind_d", ind_d),
                    ("dd", dd)):
        if t.data_ptr() % 16:  # the kernel's TMA copies
            raise ValueError(f"{name} is not 16-byte aligned")
    R, C = doc.shape
    out = torch.empty_like(doc)
    cv = torch.empty((R, C), dtype=torch.int16, device=doc.device)
    vt = torch.empty((R, C // LANE), dtype=I32, device=doc.device)
    xvis = torch.empty((R, C // 32), dtype=I32, device=doc.device)
    if R:
        lib = kernels()
        err = lib.crdt_range_apply(
            doc.data_ptr(), delpk.data_ptr(), ind_d.data_ptr(),
            dd.data_ptr(), new_len.data_ptr(), R, C, dsh,
            out.data_ptr(), cv.data_ptr(), vt.data_ptr(),
            xvis.data_ptr(),
            None if spills is None else spills.data_ptr(),
            torch.cuda.current_stream(doc.device).cuda_stream,
        )
        check(err, "crdt_range_apply")
        range_apply.launches += 1
    return out, cv, vt


range_apply.launches = 0


def range_apply_info() -> dict[str, int]:
    """K2 on the current CUDA device: registers a thread, shared memory a
    block (bytes, dynamic and static) and resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    vals = [ctypes.c_int() for _ in range(3)]
    check(kernels().crdt_range_apply_info(*map(ctypes.byref, vals)),
          "crdt_range_apply_info")
    return dict(zip(("regs", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


#: Columns a K3 block owns (``kSpan`` in ``csrc/range_apply_blocked.cu``).
K3_SPAN = 4096
#: K3's published values per block (``kVals``).
_K3_VALS = 8
#: K3's chain state per (device index, stream): status words, published
#: values, the ticket counter, the counter's value before the next launch
#: and the last epoch.
_k3_state: dict[tuple[int, int], dict] = {}


def _k3_workspace(dev, stream: int, nblocks: int) -> dict:
    """K3's chain state for ``dev`` and ``stream``, holding at least
    ``nblocks`` blocks.  Allocated zeroed once (and again when it must
    grow), never zero-filled between launches: a launch stamps a fresh
    epoch into every status word it publishes, and its tickets count from
    the counter's value before it, which this side tracks (every block of
    a launch takes exactly one ticket).  A CUDA graph would replay one
    epoch and one base, so the launch cannot be captured as it is."""
    key = (dev.index, stream)
    ws = _k3_state.get(key)
    if ws is None or ws["status"].numel() < nblocks:
        n = max(nblocks, 2 * ws["status"].numel() if ws else 0)
        ws = {
            "status": torch.zeros(n, dtype=torch.int64, device=dev),
            "vals": torch.empty(n * _K3_VALS, dtype=I32, device=dev),
            "ticket": torch.zeros(1, dtype=torch.int64, device=dev),
            "base": 0, "epoch": 0,
        }
        _k3_state[key] = ws
    return ws


def range_apply_blocked(doc, delpk, ind_d, dd, new_len, dsh: int):
    """Fused range apply K3, each row split across blocks.  On a CUDA
    tensor it launches the kernel of ``csrc/range_apply_blocked.cu`` (or
    raises); on a CPU tensor it runs :func:`range_apply_plain`.  Same
    contract as :func:`range_apply` and the JAX ``range_fused_blocked``."""
    _check_operands(doc, ("delpk", delpk), ("ind_d", ind_d), ("dd", dd),
                    new_len=new_len)
    if doc.device.type == "cpu":
        return range_apply_plain(doc, delpk, ind_d, dd, new_len, dsh)
    if doc.device.type != "cuda":
        raise ValueError(f"range_apply_blocked: unsupported device "
                         f"{doc.device}")
    R, C = doc.shape
    dev = doc.device
    out = torch.empty_like(doc)
    cv = torch.empty((R, C), dtype=torch.int16, device=dev)
    vt = torch.empty((R, C // LANE), dtype=I32, device=dev)
    nblocks = R * -(-C // K3_SPAN)
    if nblocks:
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _k3_workspace(dev, stream, nblocks)
        ws["epoch"] += 1
        scratch = torch.empty_like(doc)
        err = kernels().crdt_range_apply_blocked(
            doc.data_ptr(), delpk.data_ptr(), ind_d.data_ptr(),
            dd.data_ptr(), new_len.data_ptr(), R, C, dsh,
            out.data_ptr(), cv.data_ptr(), vt.data_ptr(), scratch.data_ptr(),
            ws["status"].data_ptr(), ws["vals"].data_ptr(),
            ws["ticket"].data_ptr(), ws["base"], ws["epoch"], stream,
        )
        check(err, "crdt_range_apply_blocked")
        ws["base"] = (ws["base"] + nblocks) % (1 << 64)
        range_apply_blocked.launches += 1
    return out, cv, vt


range_apply_blocked.launches = 0


def range_apply_takes_blocked(R: int, C: int, sm_count: int) -> bool:
    """Whether the range apply takes K3 (rows split across blocks) over K2
    (one block per row) for R rows of C columns on a card of ``sm_count``
    SMs: K3 below 7/10 of the SM count of rows, whatever C.  Both kernels
    read only the columns below new_len, so both scale with them.  Up to
    the SM count K2 gives each row a block on an SM of its own, and its
    time barely grows with R, while K3 spreads the rows over the whole card
    and its time grows with R.  On the H100's 132 SMs (PERF.md §5,
    ``chip_smoke.py [k3 vs k2]``) K3 wins up to 88 rows and K2 from 96
    on, on automerge-paper's batch 3 and on rows filled to C alike; near
    the crossing the two are within a few percent, and the crossing moved
    by a few rows from call to call."""
    return 10 * R < 7 * sm_count


def range_apply_dispatch(doc, delpk, ind_d, dd, new_len, dsh: int):
    """The fused range apply: on a CUDA tensor K3
    (:func:`range_apply_blocked`) where :func:`range_apply_takes_blocked`
    says so, else K2 (:func:`range_apply`); on a CPU tensor either runs
    the plain version."""
    dev = doc.device
    R, C = doc.shape
    if dev.type == "cuda" and range_apply_takes_blocked(
            R, C, _sm_count(dev.index)):
        return range_apply_blocked(doc, delpk, ind_d, dd, new_len, dsh)
    return range_apply(doc, delpk, ind_d, dd, new_len, dsh)


def apply_fused2_plain(doc_predel, combo, new_len, *, emit_cv: bool = True):
    """Plain PyTorch version of the fused unit apply K6 (any device).
    Returns doc' int32[R, C], or (doc', cv_intile int16[R, C], vis_tile
    int32[R, nt]) with ``emit_cv``."""
    apply_fused2_plain.calls += 1
    R, C = doc_predel.shape
    col = torch.arange(C, device=doc_predel.device, dtype=torch.int64)
    ind = combo & 1
    cnt = torch.cumsum(ind, dim=1, dtype=I32)
    y = doc_predel.gather(1, (col - cnt).clamp(min=0).long())
    out = torch.where(ind != 0, combo >> 1, y)
    out = torch.where(col >= new_len[:, None], 2, out).to(I32)
    if not emit_cv:
        return out
    cv = tile_cumsum(out & 1)
    return (
        out,
        cv.reshape(R, C).to(torch.int16),
        cv[:, :, LANE - 1].contiguous(),
    )


apply_fused2_plain.calls = 0


def apply_fused2(doc_predel, combo, new_len, *, emit_cv: bool = True):
    """Fused unit apply K6: expansion y[d] = doc_predel[d - cnt[d]] with
    cnt the inclusive prefix of combo & 1, fill combo >> 1 at the insert
    destinations, 2 at and past new_len, and with ``emit_cv`` the next
    batch's cv_intile (int16) and vis_tile.  Same contract as the JAX
    ``apply_fused2``, which ignores its cnt_base and recomputes it from
    combo: this one takes none.  On a CUDA tensor it launches the kernel
    of ``csrc/unit_apply.cu`` (or raises); on a CPU tensor it runs
    :func:`apply_fused2_plain`."""
    _check_operands(doc_predel, ("combo", combo), new_len=new_len)
    if doc_predel.device.type == "cpu":
        return apply_fused2_plain(doc_predel, combo, new_len,
                                  emit_cv=emit_cv)
    if doc_predel.device.type != "cuda":
        raise ValueError(f"apply_fused2: unsupported device "
                         f"{doc_predel.device}")
    R, C = doc_predel.shape
    dev = doc_predel.device
    out = torch.empty_like(doc_predel)
    cv = vt = None
    if emit_cv:
        cv = torch.empty((R, C), dtype=torch.int16, device=dev)
        vt = torch.empty((R, C // LANE), dtype=I32, device=dev)
    if R:
        err = kernels().crdt_unit_apply(
            doc_predel.data_ptr(), combo.data_ptr(), new_len.data_ptr(),
            R, C, int(emit_cv), out.data_ptr(),
            cv.data_ptr() if emit_cv else None,
            vt.data_ptr() if emit_cv else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check(err, "crdt_unit_apply")
        apply_fused2.launches += 1
    return (out, cv, vt) if emit_cv else out


apply_fused2.launches = 0


def _spread(idx, val, C: int):
    """Dense int32[R, C] with val[r, b] added at idx[r, b]; indices
    outside [0, C) are dropped."""
    return _scatter_rows(_zeros_like_rows(idx, C), idx, val)


def range_apply_operands(state: PackedState4, tokens, dints):
    """The producer: (delpk, ind_d, dd, new_len, nvis', dsh) for one
    resolved batch — tokens (ttype, ta, tch, tlen) int32[R, T] with TINS
    ``ta`` = the op's first slot, dints (dlo, dhi, dcount) int32[R, B]."""
    ttype, ta, tch, tlen = tokens
    dlo, dhi, dcount = dints
    R, C = state.doc.shape
    B = dlo.shape[1]
    drop = C + 7

    tile_base = _excl_cumsum_small(state.vis_tile)
    tmax_abs = tile_base + state.vis_tile

    has_del = dlo >= 0
    live, gvis, cumlen = extract_range_tokens(
        ttype, ta, tch, tlen, v0=state.nvis
    )
    allq = count_le_two_level(
        state.cv_intile, tile_base, tmax_abs,
        torch.cat(
            [
                torch.where(has_del, dlo, 0),
                torch.where(has_del, dhi, 0),
                torch.where(live, gvis, 0),
            ],
            dim=1,
        ),
    )
    lo_phys = allq[:, :B]
    hi_phys = allq[:, B:2 * B]
    gq_phys = allq[:, 2 * B:]

    at_end = gvis >= state.nvis[:, None]
    g_phys = torch.where(at_end, state.length[:, None], gq_phys)
    dest0 = torch.where(live, g_phys + cumlen, drop)
    dstop = torch.where(live, dest0 + tlen, drop)

    dsh = _del_stop_shift(B)
    pm = has_del.to(I32)
    delpk = _spread(
        torch.cat([torch.where(has_del, lo_phys, drop),
                   torch.where(has_del, hi_phys + 1, drop)], dim=1),
        torch.cat([pm, pm << dsh], dim=1),
        C,
    )
    lv = live.to(I32)
    ind_d = _spread(
        torch.cat([dest0, dstop], dim=1), torch.cat([lv, -lv], dim=1), C
    )
    # slot(d) = d + delta(run of d); delta = slot0 + tch - dest0 per run,
    # painted as differences at run starts (token order == dest order)
    delta = torch.where(live, ta + tch - dest0, 0)
    ddelta = torch.where(live, delta - _prev_value(delta, live), 0)
    dd = _spread(dest0, ddelta, C)

    n_ins = torch.where(live, tlen, 0).sum(dim=1, dtype=I32)
    n_del = torch.where(has_del, dcount, 0).sum(dim=1, dtype=I32)
    new_len = state.length + n_ins
    return delpk, ind_d, dd, new_len, state.nvis + n_ins - n_del, dsh


def apply_range_batch4(state: PackedState4, tokens, dints) -> PackedState4:
    """Apply one resolved range batch to the maintained-cv state: the
    producer's small work, then the fused kernel that
    :func:`range_apply_dispatch` picks."""
    delpk, ind_d, dd, new_len, nvis, dsh = range_apply_operands(
        state, tokens, dints
    )
    doc, cv, vt = range_apply_dispatch(state.doc, delpk, ind_d, dd, new_len,
                                       dsh)
    return PackedState4(
        doc=doc, cv_intile=cv, vis_tile=vt, length=new_len, nvis=nvis
    )
