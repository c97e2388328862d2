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

Every capacity-wide pass then runs in ONE kernel, :func:`range_apply`
(K2/K3, ``csrc/range_apply.cu``): delete clear, hole map, expansion as a
gather, fill, beyond-length stamp and the next batch's ``cv_intile`` /
``vis_tile``.  :func:`range_apply_plain` is its plain PyTorch version.
"""

from __future__ import annotations

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


def range_apply(doc, delpk, ind_d, dd, new_len, dsh: int):
    """Fused range apply K2/K3.  On a CUDA tensor it launches the kernel
    of ``csrc/range_apply.cu`` (or raises); on a CPU tensor it runs
    :func:`range_apply_plain`.  Same contract as the JAX ``range_fused`` /
    ``range_fused_blocked``, with ``cv_intile`` as int16."""
    _check_operands(doc, ("delpk", delpk), ("ind_d", ind_d), ("dd", dd),
                    new_len=new_len)
    if doc.device.type == "cpu":
        return range_apply_plain(doc, delpk, ind_d, dd, new_len, dsh)
    if doc.device.type != "cuda":
        raise ValueError(f"range_apply: unsupported device {doc.device}")
    R, C = doc.shape
    out = torch.empty_like(doc)
    cv = torch.empty((R, C), dtype=torch.int16, device=doc.device)
    vt = torch.empty((R, C // LANE), dtype=I32, device=doc.device)
    scratch = torch.empty_like(doc)
    if R:
        lib = kernels()
        err = lib.crdt_range_apply(
            doc.data_ptr(), delpk.data_ptr(), ind_d.data_ptr(),
            dd.data_ptr(), new_len.data_ptr(), R, C, dsh,
            out.data_ptr(), cv.data_ptr(), vt.data_ptr(),
            scratch.data_ptr(),
            torch.cuda.current_stream(doc.device).cuda_stream,
        )
        check(err, "crdt_range_apply")
        range_apply.launches += 1
    return out, cv, vt


range_apply.launches = 0


def apply_fused2_plain(doc_predel, combo, new_len, *, emit_cv: bool = True):
    """Plain PyTorch version of the fused unit apply K6 (any device).
    Returns doc' int32[R, C], or (doc', cv_intile int16[R, C], vis_tile
    int32[R, nt]) with ``emit_cv``."""
    apply_fused2_plain.calls += 1
    R, C = doc_predel.shape
    col = torch.arange(C, device=doc_predel.device)
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
    producer's small work, then the fused kernel :func:`range_apply`."""
    delpk, ind_d, dd, new_len, nvis, dsh = range_apply_operands(
        state, tokens, dints
    )
    doc, cv, vt = range_apply(state.doc, delpk, ind_d, dd, new_len, dsh)
    return PackedState4(
        doc=doc, cv_intile=cv, vis_tile=vt, length=new_len, nvis=nvis
    )
