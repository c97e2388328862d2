"""Insert expansions of the unit applies (the JAX package's
``ops/expand_pallas.py``): move each row's old entries right past the
batch's insert destinations and zero the destinations, so the fills can
be adds.  With cnt the inclusive prefix of the destination indicator,
y[d] = x[d - cnt[d]] (d - cnt[d] < 0 only at a destination).

- :func:`expand_packed` (K8, ``apply2.apply_batch3``): the packed doc,
  with cnt and the indicator carried as ``cntind = cnt << 1 | ind``;
- :func:`expand_fill_zero` (K9, ``apply2.apply_batch2``): order and vis,
  with cnt and ind as separate arrays;
- :func:`apply_fused_blocked` (K7, the v5 downstream apply): the no-cv
  fused apply with an explicit per-tile insert-count base ``cnt_base``,
  so every 128-position tile is independent of the others.

K8 and K9 launch ``csrc/expand.cu``, K7 ``csrc/apply_blocked.cu``, on
CUDA tensors; ``*_plain`` are their plain PyTorch versions.  The gather is
exact for any 1-Lipschitz cnt, so unlike the TPU's roll cascade they take
no ``nbits``.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .._build import check, kernels

I32 = torch.int32
LANE = 128


def _check(*named):
    """All (name, tensor) operands int32[R, C], contiguous, on one device;
    returns (R, C, device)."""
    first = named[0][1]
    R, C = first.shape
    for name, t in named:
        if t.device != first.device:
            raise ValueError(f"{name} on {t.device}, not {first.device}")
        if t.dtype != I32 or tuple(t.shape) != (R, C):
            raise ValueError(
                f"{name}: want int32[{R}, {C}], got {t.dtype}{list(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    if R > 65535:
        raise ValueError(f"{R} rows: the kernels' grid takes at most 65535")
    return R, C, first.device


def _source(cnt):
    C = cnt.shape[1]
    col = torch.arange(C, device=cnt.device)
    return (col - cnt).clamp(min=0).long()


def expand_packed_plain(doc, cntind):
    """Plain PyTorch version of K8."""
    expand_packed_plain.calls += 1
    y = doc.gather(1, _source(cntind >> 1))
    return torch.where((cntind & 1) != 0, 0, y)


expand_packed_plain.calls = 0


def expand_packed(doc, cntind):
    """K8: out[d] = 0 where cntind[d] & 1, else doc[d - (cntind[d] >> 1)].
    doc/cntind int32[R, C].  On a CUDA tensor it launches the kernel (or
    raises); on a CPU tensor it runs :func:`expand_packed_plain`."""
    R, C, dev = _check(("doc", doc), ("cntind", cntind))
    if dev.type == "cpu":
        return expand_packed_plain(doc, cntind)
    out = torch.empty_like(doc)
    if R and C:
        err = kernels().crdt_expand_packed(
            doc.data_ptr(), cntind.data_ptr(), R, C, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check(err, "crdt_expand_packed")
        expand_packed.launches += 1
    return out


expand_packed.launches = 0


def expand_fill_zero_plain(order, vis, cnt, ind):
    """Plain PyTorch version of K9."""
    expand_fill_zero_plain.calls += 1
    src = _source(cnt)
    hole = ind != 0
    return (
        torch.where(hole, 0, order.gather(1, src)),
        torch.where(hole, 0, vis.gather(1, src)),
    )


expand_fill_zero_plain.calls = 0


def expand_fill_zero(order, vis, cnt, ind):
    """K9: (order', vis') with y[d] = x[d - cnt[d]] and the destinations
    (ind != 0) zeroed.  All int32[R, C].  On a CUDA tensor it launches the
    kernel (or raises); on a CPU tensor it runs
    :func:`expand_fill_zero_plain`."""
    R, C, dev = _check(("order", order), ("vis", vis), ("cnt", cnt),
                       ("ind", ind))
    if dev.type == "cpu":
        return expand_fill_zero_plain(order, vis, cnt, ind)
    order_out = torch.empty_like(order)
    vis_out = torch.empty_like(vis)
    if R and C:
        err = kernels().crdt_expand_fill_zero(
            order.data_ptr(), vis.data_ptr(), cnt.data_ptr(), ind.data_ptr(),
            R, C, order_out.data_ptr(), vis_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check(err, "crdt_expand_fill_zero")
        expand_fill_zero.launches += 1
    return order_out, vis_out


expand_fill_zero.launches = 0


def _check_blocked(doc_predel, combo, cnt_base, new_len):
    """K7's operands: doc_predel/combo int32[R, C] (C a multiple of 128),
    cnt_base int32[R, C // 128], new_len int32[R], contiguous, on one
    device; returns (R, C, device)."""
    R, C, dev = _check(("doc_predel", doc_predel), ("combo", combo))
    if C % LANE:
        raise ValueError(f"capacity {C} is not a multiple of {LANE}")
    for name, t, shape in (("cnt_base", cnt_base, (R, C // LANE)),
                           ("new_len", new_len, (R,))):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, not {dev}")
        if t.dtype != I32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want int32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return R, C, dev


def apply_fused_blocked_plain(doc_predel, combo, cnt_base, new_len):
    """Plain PyTorch version of K7 (any device)."""
    apply_fused_blocked_plain.calls += 1
    R, C = doc_predel.shape
    ind = combo & 1
    cnt = torch.cumsum(ind.view(R, C // LANE, LANE), dim=2, dtype=I32)
    cnt = (cnt + cnt_base[:, :, None]).view(R, C)
    col = torch.arange(C, device=combo.device)
    y = doc_predel.gather(1, (col - cnt).clamp(0, C - 1).long())
    out = torch.where(ind != 0, combo >> 1, y)
    return torch.where(col >= new_len[:, None], 2, out).to(I32)


apply_fused_blocked_plain.calls = 0


def apply_fused_blocked(doc_predel, combo, cnt_base, new_len):
    """K7: out[d] = 2 at and past new_len, combo[d] >> 1 where combo[d] & 1
    (an insert destination), else doc_predel[d - cnt[d]], with
    cnt[d] = cnt_base[r, d // 128] + the inclusive prefix of combo & 1
    within d's tile.  The same function as the JAX package's
    ``apply_fused_blocked`` and ``apply_fused_nocv_xla``; like them it
    trusts ``cnt_base`` to be consistent with ``combo``.  On a CUDA tensor it
    launches the kernel (or raises); on a CPU tensor it runs
    :func:`apply_fused_blocked_plain`."""
    R, C, dev = _check_blocked(doc_predel, combo, cnt_base, new_len)
    if dev.type == "cpu":
        return apply_fused_blocked_plain(doc_predel, combo, cnt_base, new_len)
    out = torch.empty_like(doc_predel)
    if R and C:
        err = kernels().crdt_apply_blocked(
            doc_predel.data_ptr(), combo.data_ptr(), cnt_base.data_ptr(),
            new_len.data_ptr(), R, C, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check(err, "crdt_apply_blocked")
        apply_fused_blocked.launches += 1
    return out


apply_fused_blocked.launches = 0


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
