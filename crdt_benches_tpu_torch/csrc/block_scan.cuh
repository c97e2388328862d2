// Block-wide exclusive int32 scan shared by the fused apply kernels
// (range_apply.cu, unit_apply.cu).

#pragma once

#include <cuda_runtime.h>

// Exclusive scan over a block of kThreads threads of N int32 values per
// thread.  On return v[n] is the exclusive prefix of this thread's value
// and total[n] the block sum.  ws is shared scratch of N x (kThreads/32).
template <int kThreads, int N>
__device__ __forceinline__ void block_excl_scan(int (&v)[N], int (&total)[N],
                                                int (*ws)[kThreads / 32]) {
  constexpr int kWarps = kThreads / 32;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl[N];
#pragma unroll
  for (int n = 0; n < N; ++n) incl[n] = v[n];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int y = __shfl_up_sync(kAll, incl[n], o);
      if (lane >= o) incl[n] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int n = 0; n < N; ++n) ws[n][warp] = incl[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      int w = lane < kWarps ? ws[n][lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, w, o);
        if (lane >= o) w += y;
      }
      __syncwarp();
      if (lane < kWarps) ws[n][lane] = w;  // inclusive warp-total prefix
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int before = warp > 0 ? ws[n][warp - 1] : 0;
    total[n] = ws[n][kWarps - 1];
    v[n] = before + incl[n] - v[n];
  }
  __syncthreads();  // ws is reused by the next scan
}
