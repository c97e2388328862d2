// K6: fused unit apply for Hopper (sm_90a).
//
// Replaces the TPU kernel crdt_benches_tpu/ops/apply_range_fused.py
// apply_fused2 (Pallas body _apply_fused2_kernel).  One kernel serves every
// capacity: Hopper has no VMEM gate.  Per replica row of C positions
// (C a multiple of 128), from doc_predel/combo int32[R, C] and new_len
// int32[R]:
//   ind[d] = combo[d] & 1;  cnt[d] = prefix(ind)[d]
//   out[d] = 2                     if d >= new_len
//          = combo[d] >> 1         if ind[d]
//          = doc_predel[d - cnt[d]] otherwise
// and, when emit_cv is set, the next batch's rank structure: cv_intile
// (inclusive vis cumsum within each 128-position tile, int16) and
// vis_tile (tile totals).  The cross-tile insert-count base is the
// running prefix of combo & 1, as the TPU kernel recomputes it; no
// cnt_base operand.
//
// What bounds it on the H100: device-memory bytes.  It must read 8 bytes
// and write 6 (+4/128) per position — 14 B/pos, ~2.6 GB a launch at
// R = 1024, C = 182,400 — with a few integer operations per byte.
//
// Design: one block per replica row walks the row in chunks of 2048
// positions (512 threads x 4 consecutive positions, int4 loads of combo),
// carrying the insert count across chunks; one block-wide scan per chunk.
// The TPU kernel's log-shift roll cascade becomes one gather from the
// INPUT doc_predel at d - cnt[d]: the source is read-only, so no scratch
// row or barrier is needed, and cnt is piecewise constant, so a warp's
// gathers fall on nearly consecutive addresses.  d - cnt[d] < 0 only at
// a hole, which the fill overwrites.  Each warp covers exactly one
// 128-position tile, so cv_intile and vis_tile are a warp scan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
unit_apply_kernel(const int* __restrict__ doc, const int* __restrict__ combo,
                  const int* __restrict__ new_len, int C, int emit_cv,
                  int* __restrict__ out, short* __restrict__ cv,
                  int* __restrict__ vis_tile) {
  __shared__ int ws[1][kWarps];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row = static_cast<size_t>(r) * C;
  const int nlen = new_len[r];
  int c_cnt = 0;  // insert count before this chunk

  for (int base = 0; base < C; base += kChunk) {
    const int q = base + tid * kItems;  // first of this thread's positions
    const bool ok = q < C;  // C % 128 == 0: whole warps are in or out
    int4 cb = make_int4(0, 0, 0, 0);
    if (ok) cb = *reinterpret_cast<const int4*>(combo + row + q);
    const int cv4[kItems] = {cb.x, cb.y, cb.z, cb.w};
    int s1[1] = {(cb.x & 1) + (cb.y & 1) + (cb.z & 1) + (cb.w & 1)}, t1[1];
    block_excl_scan<kThreads>(s1, t1, ws);

    int ov[kItems];
    int cnt = c_cnt + s1[0];
    int vsum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int d = q + k;
      const int ind = cv4[k] & 1;
      cnt += ind;
      int o;
      if (d >= nlen) {
        o = 2;
      } else if (ind) {
        o = cv4[k] >> 1;
      } else {
        const int s = d - cnt;  // >= 0 at every non-hole position
        o = doc[row + (s > 0 ? s : 0)];
      }
      ov[k] = o;
      vsum += o & 1;
    }
    if (ok) {
      *reinterpret_cast<int4*>(out + row + q) =
          make_int4(ov[0], ov[1], ov[2], ov[3]);
    }
    if (emit_cv) {
      // this warp's 128 positions are one tile
      int vincl = vsum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, vincl, o);
        if (lane >= o) vincl += y;
      }
      if (ok) {
        int c = vincl - vsum;
        short cs[kItems];
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          c += ov[k] & 1;
          cs[k] = static_cast<short>(c);
        }
        *reinterpret_cast<short4*>(cv + row + q) =
            make_short4(cs[0], cs[1], cs[2], cs[3]);
        if (lane == 31) {
          vis_tile[static_cast<size_t>(r) * (C / 128) + q / 128] = vincl;
        }
      }
    }
    c_cnt += t1[0];
  }
}

}  // namespace

extern "C" int crdt_unit_apply(const int* doc, const int* combo,
                               const int* new_len, int R, int C, int emit_cv,
                               int* out, short* cv, int* vis_tile,
                               void* stream) {
  unit_apply_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      doc, combo, new_len, C, emit_cv, out, cv, vis_tile);
  return static_cast<int>(cudaGetLastError());
}
