// K8 and K9: the insert expansions of the packed (v3) and split (v2)
// unit applies, for Hopper (sm_90a).
//
// Replace the TPU kernels crdt_benches_tpu/ops/expand_pallas.py
// expand_packed (Pallas body _expand_packed_kernel) and expand_fill_zero
// (_expand_kernel).  Per replica row of C positions:
//   K8: out[d] = (cntind[d] & 1) ? 0 : doc[d - (cntind[d] >> 1)]
//   K9: order'[d] = ind[d] ? 0 : order[d - cnt[d]], and likewise vis
// where cnt is the inclusive prefix of the insert holes (the caller's
// cumsum), so the source is never right of d and d - cnt[d] < 0 only at a
// hole.  The TPU's bit-by-bit roll cascade (exact only while 2^nbits
// exceeds the largest shift) becomes one gather, exact for any shift.
//
// What bounds them on the H100: device-memory bytes, 12 B/pos for K8
// (doc and cntind read, out written) and 24 B/pos for K9 (four inputs,
// two outputs), with one or two integer operations per position.
//
// Design: one thread per position, a 2-D grid (positions x replica rows),
// so neighbouring threads read and write neighbouring addresses; the
// gathers are near-consecutive too, since the shift is piecewise constant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
expand_packed_kernel(const int* __restrict__ doc,
                     const int* __restrict__ cntind, int C,
                     int* __restrict__ out) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= C) return;
  const size_t row = static_cast<size_t>(blockIdx.y) * C;
  const int ci = cntind[row + d];
  int o = 0;
  if (!(ci & 1)) {
    const int s = d - (ci >> 1);
    o = doc[row + (s > 0 ? s : 0)];
  }
  out[row + d] = o;
}

__global__ void __launch_bounds__(kThreads)
expand_fill_zero_kernel(const int* __restrict__ order,
                        const int* __restrict__ vis,
                        const int* __restrict__ cnt,
                        const int* __restrict__ ind, int C,
                        int* __restrict__ order_out,
                        int* __restrict__ vis_out) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= C) return;
  const size_t row = static_cast<size_t>(blockIdx.y) * C;
  int o = 0, v = 0;
  if (ind[row + d] == 0) {
    const int s = d - cnt[row + d];
    const size_t src = row + (s > 0 ? s : 0);
    o = order[src];
    v = vis[src];
  }
  order_out[row + d] = o;
  vis_out[row + d] = v;
}

dim3 grid_for(int R, int C) { return dim3((C + kThreads - 1) / kThreads, R); }

}  // namespace

extern "C" int crdt_expand_packed(const int* doc, const int* cntind, int R,
                                  int C, int* out, void* stream) {
  expand_packed_kernel<<<grid_for(R, C), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(doc, cntind, C,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crdt_expand_fill_zero(const int* order, const int* vis,
                                     const int* cnt, const int* ind, int R,
                                     int C, int* order_out, int* vis_out,
                                     void* stream) {
  expand_fill_zero_kernel<<<grid_for(R, C), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      order, vis, cnt, ind, C, order_out, vis_out);
  return static_cast<int>(cudaGetLastError());
}
