// K7: the no-cv fused unit apply with an explicit per-tile insert-count
// base, for Hopper (sm_90a).
//
// Replaces the TPU kernel crdt_benches_tpu/ops/expand_pallas.py
// apply_fused_blocked (Pallas body _apply_fused_blocked_kernel).  Per
// replica row of C positions (C a multiple of 128), from doc_predel/combo
// int32[R, C], cnt_base int32[R, C / 128] and new_len int32[R]:
//   ind[d] = combo[d] & 1
//   cnt[d] = cnt_base[r, d / 128] + inclusive prefix of ind within d's tile
//   out[d] = 2                      if d >= new_len
//          = combo[d] >> 1          if ind[d]
//          = doc_predel[d - cnt[d]] otherwise
// The caller's cnt_base (the exclusive prefix of the insert count over the
// tiles) removes every dependency between tiles, so unlike K6, which walks
// a whole row in one block and carries the count, the grid splits each row
// too: the C-parallel apply for widths whose rows alone cannot fill the
// card's 132 SMs.  No halo, no block padding, no nbits: the TPU kernel's
// log-shift roll cascade over a haloed VMEM window becomes one gather from
// the input doc_predel (read-only, so no scratch and no barrier).
//
// What bounds it on the H100: device-memory bytes — doc_predel and combo
// read and out written at 4 B/pos each (12 B/pos), plus cnt_base at 4 B
// per tile: 140 MB, 0.042 ms at 3.35 TB/s, at R = 64, C = 182,400, and
// 0.67 ms at R = 1024.  A few integer operations per position.
//
// Design: grid (tiles / 8, R), 256 threads; each warp owns one 128-position
// tile, each lane 4 consecutive positions (int4 loads of combo, an int4
// store of out); the in-tile prefix is a warp shuffle scan.  The gathers
// fall on nearly consecutive addresses (cnt is piecewise constant), and
// positions at or past new_len skip theirs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kItems = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
apply_blocked_kernel(const int* __restrict__ doc,
                     const int* __restrict__ combo,
                     const int* __restrict__ cnt_base,
                     const int* __restrict__ new_len, int C,
                     int* __restrict__ out) {
  const int nt = C / 128;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= nt) return;  // the ragged edge: whole warps only
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y;
  const size_t row = static_cast<size_t>(r) * C;
  const int q = tile * 128 + lane * kItems;
  const int nlen = new_len[r];

  const int4 cb = *reinterpret_cast<const int4*>(combo + row + q);
  const int cv[kItems] = {cb.x, cb.y, cb.z, cb.w};
  const int s = (cb.x & 1) + (cb.y & 1) + (cb.z & 1) + (cb.w & 1);
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int cnt = cnt_base[static_cast<size_t>(r) * nt + tile] + incl - s;

  int ov[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int d = q + k;
    const int ind = cv[k] & 1;
    cnt += ind;
    if (d >= nlen) {
      ov[k] = 2;
    } else if (ind) {
      ov[k] = cv[k] >> 1;
    } else {
      int src = d - cnt;  // in [0, d] when cnt_base is consistent
      src = src < 0 ? 0 : (src >= C ? C - 1 : src);
      ov[k] = doc[row + src];
    }
  }
  *reinterpret_cast<int4*>(out + row + q) =
      make_int4(ov[0], ov[1], ov[2], ov[3]);
}

}  // namespace

extern "C" int crdt_apply_blocked(const int* doc, const int* combo,
                                  const int* cnt_base, const int* new_len,
                                  int R, int C, int* out, void* stream) {
  const dim3 grid((C / 128 + kWarps - 1) / kWarps, R);
  apply_blocked_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      doc, combo, cnt_base, new_len, C, out);
  return static_cast<int>(cudaGetLastError());
}
