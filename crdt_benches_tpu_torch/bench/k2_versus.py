"""Time this checkout's K2 (the fused range apply, ``csrc/range_apply.cu``)
against the K2 of another checkout of this repository, on one card, in
turns.

    git archive <commit> crdt_benches_tpu_torch | tar -x -C build/other
    python -m crdt_benches_tpu_torch.bench.k2_versus build/other

The other checkout's ``csrc/range_apply.cu`` is compiled alone (nvcc,
sm_90a, the flags of ``_build``) into ``build/torch_kernels/other/`` and
loaded with ctypes; its C entry ``crdt_range_apply`` may take the
``spills`` counter or not (read from its source).  On automerge-paper's
headline replay at R = 1024 (capacity 183,296; K1 and the producer on the
card): batch 3's operands, and every batch's, summed; on
``bench/k3_cases.py`` ``full`` rows (every column below new_len) at R =
1024.  Each shape: both kernels held against ``range_apply_plain`` (exact),
then timed this, other, other, this (10 launches each, queued behind a
device sleep as ``chip_smoke.py`` times K2), beside the bound of
``chip_smoke.py range_apply_bound``; this K2's registers, shared memory,
resident blocks an SM and the columns it sourced from left of its x ring.
Prints the card's name and power limit first.  Exits 1 if a kernel
disagrees with the plain version or there is no GPU.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

from .. import _build
from ..ops import apply_range_fused as arf
from ..ops import resolve_range as rr
from ..ops.apply2 import PackedState4, init_state4
from ..traces import load_testing_data, tensorize_ranges
from .k3_cases import DSH, k3_case

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
CAP = 183_296
R = 1024


def _other_lib(checkout: str):
    """(the other checkout's crdt_range_apply, whether it takes spills)."""
    csrc = os.path.join(checkout, "crdt_benches_tpu_torch", "csrc")
    src = os.path.join(csrc, "range_apply.cu")
    with open(src) as fh:
        params = re.search(r'extern "C" int crdt_range_apply\(([^)]*)\)',
                           fh.read()).group(1)
    spills = "spills" in params
    out = os.path.join(_build.BUILD_DIR, "other")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "librange_apply_other.so")
    run = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", csrc, src,
         "-o", lib], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{run.stdout}")
    fn = ctypes.CDLL(lib).crdt_range_apply
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 5 + [I] * 3 + [P] * (5 if spills else 4) + [P]
    fn.restype = I
    return fn, spills


def _call_other(fn, spills: bool, ops):
    doc, delpk, ind_d, dd, new_len, dsh = ops
    Rr, C = doc.shape
    out = torch.empty_like(doc)
    cv = torch.empty((Rr, C), dtype=torch.int16, device=doc.device)
    vt = torch.empty((Rr, C // 128), dtype=torch.int32, device=doc.device)
    scratch = torch.empty_like(doc)  # enough for any form of K2
    args = [doc.data_ptr(), delpk.data_ptr(), ind_d.data_ptr(),
            dd.data_ptr(), new_len.data_ptr(), Rr, C, dsh, out.data_ptr(),
            cv.data_ptr(), vt.data_ptr(), scratch.data_ptr()]
    if spills:
        args.append(None)
    err = fn(*args, torch.cuda.current_stream(doc.device).cuda_stream)
    _build.check(err, "the other crdt_range_apply")
    return out, cv, vt


def _queued_ms(fn, reps: int = 10) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _equal(got, want) -> bool:
    return all(torch.equal(g.long(), w.long()) for g, w in zip(got, want))


def _bound_ms(new_len, C: int) -> float:
    Rr = new_len.shape[0]
    live = int(new_len.clamp(min=0, max=C).sum())
    nbytes = 16 * live + 6 * Rr * C + 4 * Rr * (C // 128) + 4 * Rr
    return nbytes / HBM_BYTES_PER_S * 1e3


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k2_versus: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{smi.stdout.strip()}", flush=True)
    _build.kernels()
    section = _build.build_log.split("== range_apply.cu\n")[-1]
    for ln in section.split("\n== ")[0].splitlines():
        print(f"[build range_apply.cu] {ln.strip()}", flush=True)
    other, other_spills = _other_lib(argv[0])
    print(f"[k2 this] {arf.range_apply_info()}", flush=True)
    this = lambda ops: arf.range_apply(*ops)
    that = lambda ops: _call_other(other, other_spills, ops)
    spills = torch.zeros(1, dtype=torch.int64, device=dev)

    def compare(label, ops):
        want = arf.range_apply_plain(*ops)
        spills.zero_()
        ok_this = _equal(arf.range_apply(*ops, spills=spills), want)
        ok_that = _equal(that(ops), want)
        misses = arf.range_apply_ring_misses(ops[2], ops[4])
        if not (ok_this and ok_that) or int(spills) != misses:
            print(f"FAIL {label}: this equal {ok_this}, other equal "
                  f"{ok_that}, left of the ring {int(spills)} against "
                  f"{misses}", flush=True)
            sys.exit(1)
        a1 = _queued_ms(lambda: this(ops))
        b1 = _queued_ms(lambda: that(ops))
        b2 = _queued_ms(lambda: that(ops))
        a2 = _queued_ms(lambda: this(ops))
        live = int(ops[4].clamp(min=0, max=ops[0].shape[1]).sum())
        print(f"[k2 vs other] {label}: this {(a1 + a2) / 2:.4f} ms ({a1:.4f},"
              f" {a2:.4f}), other {(b1 + b2) / 2:.4f} ms ({b1:.4f}, "
              f"{b2:.4f}), bound {_bound_ms(ops[4], ops[0].shape[1]):.4f} "
              f"ms (bytes); equal to plain; {misses} of {live} live "
              "columns sourced left of the ring", flush=True)
        return (a1 + a2) / 2, (b1 + b2) / 2

    rt = tensorize_ranges(load_testing_data("automerge-paper"), batch=1536,
                          coalesce=True)
    kb, pb, lb, sb = (torch.as_tensor(a, device=dev) for a in rt.batched())
    st = init_state4(R, CAP, len(rt.init_chars), device=dev)
    tot = [0.0, 0.0]
    for i in range(rt.n_batches):
        tok, dints, _ = rr.resolve_range(kb[i], pb[i], lb[i], sb[i], st.nvis)
        delpk, ind_d, dd, new_len, nvis, dsh = arf.range_apply_operands(
            st, tok, dints)
        ops = (st.doc, delpk, ind_d, dd, new_len, dsh)
        a, b = compare(f"automerge-paper R={R} C={CAP} batch {i}", ops)
        tot[0] += a
        tot[1] += b
        out = arf.range_apply(*ops)
        st = PackedState4(doc=out[0], cv_intile=out[1], vis_tile=out[2],
                          length=new_len, nvis=nvis)
        del ops, delpk, ind_d, dd
    print(f"[k2 vs other] automerge-paper R={R} C={CAP}, every batch: this "
          f"{tot[0]:.4f} ms, other {tot[1]:.4f} ms", flush=True)
    del st
    full = tuple(torch.as_tensor(a, device=dev) for a in k3_case(
        "full", R, CAP, arf.K3_SPAN, seed=R)) + (DSH,)
    compare(f"R={R} C={CAP} full rows (bench/k3_cases.py)", full)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
