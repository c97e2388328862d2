// Warp-level search over a cum-primary token list in shared memory, shared
// by the resolvers that keep one list per warp (resolve_unit.cu,
// resolve_range.cu).

#pragma once

#include <cuda_runtime.h>

// #(cum[i] <= p) over the nondecreasing cum[0..n), warp-uniform result.
// Each level probes the last token of 32 equal chunks and keeps the chunk
// holding the first cum > p; the last level probes up to 32 tokens.
__device__ __forceinline__ int warp_count_le(const int* cum, int n, int p,
                                             int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (hi - lo > 32) {
    const int s = (hi - lo + 31) >> 5;
    const int i = lo + lane * s + s - 1;
    const bool le = i < hi && cum[i] <= p;
    lo += __popc(__ballot_sync(kAll, le)) * s;
    hi = min(hi, lo + s - 1);
  }
  const int i = lo + lane;
  const bool le = i < hi && cum[i] <= p;
  return lo + __popc(__ballot_sync(kAll, le));
}
