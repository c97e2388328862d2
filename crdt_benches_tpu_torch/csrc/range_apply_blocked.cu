// K3: the fused range apply with each row split across blocks, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel crdt_benches_tpu/ops/apply_range_fused.py
// range_fused_blocked (:591; Pallas body _range_blocked_kernel, :503).
// Same function as K2 (csrc/range_apply.cu) on the same operands: per
// replica row of C positions (C a multiple of 128), from doc/delpk/ind_d/dd
// int32[R, C] and new_len int32[R]:
//   depth[d] = prefix of (delpk & (2^dsh - 1)) - (delpk >> dsh)
//   x[d]     = doc[d] with its vis bit cleared where depth[d] > 0
//   run[d]   = prefix(ind_d)[d] > 0;  cnt[d] = prefix(run)[d]
//   out[d]   = 2                                  if d >= new_len
//            = ((d + prefix(dd)[d] + 2) << 1) | 1  if run[d]
//            = x[d - cnt[d]]                       otherwise
// plus cv_intile (inclusive vis cumsum within each 128-position tile,
// int16) and vis_tile (tile totals).  Exact for any int32 operands: every
// prefix is an int32 sum, wrapping as the plain version's does.
//
// What bounds it on the H100: device-memory bytes.  The function reads 16
// bytes a column below each row's new_len and writes 6 (+4/128) a column
// everywhere: 0.0051 ms at R = 2, C = 1,048,576 on automerge-paper's last
// batch (140,158 columns below new_len).  K2 walks a row in one block, so
// at small R a couple of SMs work, one 2048-column chunk after another.
//
// Design: the grid is R x ceil(C / 4096) blocks of 512 threads; a block
// owns a span of 4096 columns (two chunks of 2048, 4 columns a thread, int4
// loads, so each warp covers one 128-column tile per chunk and the tile
// outputs are warp scans).  Blocks take a ticket (atomicAdd on a counter)
// and work on the ticket's span in row-major order, so every block that is
// waited on already holds a ticket and runs: the scans cannot deadlock.
// The row's prefixes cross blocks by two single-pass chained scans with
// decoupled look-back (Merrill & Garland): chain 1 carries (depth, ind,
// dd); chain 2 the hole count, whose aggregate needs chain 1's ind carry.
// A block publishes its aggregate, looks back a warp's width of
// predecessors at a time, summing aggregates until an inclusive prefix,
// and publishes its own inclusive prefix.  Each status word holds the
// launch's epoch and the block's published bits, stored with release
// after its values and read with acquire, so the words need no reset
// between launches.  Then a block writes its delete-cleared x to shared
// memory and a scratch row and publishes "x ready": sources d - cnt[d]
// fall in a window at most 4096 wide ending left of the block (cnt grows
// at most 1 a column), so a block waits on at most two earlier blocks' x
// and reads its own span from shared memory.  A block wholly at or past
// new_len reads nothing and joins no chain (no block after it in its row
// needs a prefix): it writes 2, a zero cv_intile and a zero vis_tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kItems = 4;
constexpr int kChunks = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * kItems;
constexpr int kSpan = kChunk * kChunks;
constexpr unsigned kFull = 0xffffffffu;

// status word: epoch << 8 | the bits published so far
constexpr unsigned kAgg1 = 1, kInc1 = 2, kAgg2 = 4, kInc2 = 8, kXReady = 16;
// values a block publishes: chain 1 aggregate (depth, ind, dd), chain 2
// aggregate (holes), chain 1 inclusive prefix, chain 2 inclusive prefix
constexpr int kVals = 8;
constexpr int kAggOff1 = 0, kAggOff2 = 3, kIncOff1 = 4, kIncOff2 = 7;

__device__ __forceinline__ void store_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 load_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Warp 0: the exclusive prefix of block ``self`` over the blocks
// [first, self) of its row, by decoupled look-back on one chain.
template <int NV>
__device__ __forceinline__ void look_back(const u64* status, const int* vals,
                                          long long first, long long self,
                                          u64 epoch, unsigned agg_bit,
                                          unsigned inc_bit, int agg_off,
                                          int inc_off, int (&carry)[NV]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NV; ++n) carry[n] = 0;
  for (long long top = self - 1;; top -= 32) {
    const long long p = top - lane;
    const bool valid = p >= first;  // below the row's first block: zero
    u64 w = 0;
    bool ready = !valid;
    while (!__all_sync(kFull, ready)) {
      if (!ready) {
        w = load_acquire(status + p);
        ready = (w >> 8) == epoch && (w & (agg_bit | inc_bit));
      }
    }
    const unsigned incs =
        __ballot_sync(kFull, !valid || (w & inc_bit) != 0);
    const int stop = incs ? __ffs(incs) - 1 : 32;  // nearest inclusive
    int v[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) v[n] = 0;
    if (valid && lane <= stop) {
      const int* src = vals + p * kVals + (lane == stop ? inc_off : agg_off);
#pragma unroll
      for (int n = 0; n < NV; ++n) v[n] = __ldcg(src + n);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v[n] += __shfl_xor_sync(kFull, v[n], o);
      carry[n] += v[n];
    }
    if (incs) return;
  }
}

// One thread waits until block ``p`` has published ``bit`` in this launch.
__device__ __forceinline__ void wait_for(const u64* status, long long p,
                                         u64 epoch, unsigned bit) {
  u64 w;
  do {
    w = load_acquire(status + p);
  } while ((w >> 8) != epoch || !(w & bit));
}

__global__ void __launch_bounds__(kThreads, 2)
range_apply_blocked_kernel(const int* __restrict__ doc,
                           const int* __restrict__ delpk,
                           const int* __restrict__ ind,
                           const int* __restrict__ dd,
                           const int* __restrict__ new_len, int C, int nblk,
                           int dsh, int* __restrict__ out,
                           short* __restrict__ cv, int* __restrict__ vis_tile,
                           int* scratch, u64* status, int* vals, u64* ticket,
                           u64 base, u64 epoch) {
  __shared__ int xs[kSpan];
  __shared__ int ws[3 * kChunks][kWarps];
  __shared__ int carry_s[4];
  __shared__ long long ticket_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    ticket_s = static_cast<long long>(atomicAdd(ticket, 1ull) - base);
  }
  __syncthreads();
  const long long self = ticket_s;
  const int r = static_cast<int>(self / nblk);
  const int b = static_cast<int>(self - static_cast<long long>(r) * nblk);
  const long long first = self - b;  // the row's first block
  const size_t row = static_cast<size_t>(r) * C;
  const int nt = C / 128;
  const int nlen = new_len[r];
  const int b0 = b * kSpan;

  if (b0 >= nlen) {  // wholly at or past new_len: constants only
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int q = b0 + c * kChunk + tid * kItems;
      if (q < C) {  // C % 128 == 0: whole warps are in or out
        *reinterpret_cast<int4*>(out + row + q) = make_int4(2, 2, 2, 2);
        *reinterpret_cast<short4*>(cv + row + q) = make_short4(0, 0, 0, 0);
        if (lane == 31) vis_tile[static_cast<size_t>(r) * nt + q / 128] = 0;
      }
    }
    return;
  }

  // ---- local prefixes of the delete depth, run boundaries and dd ----
  const int dmask = (1 << dsh) - 1;
  int dv[kChunks][kItems], ldep[kChunks][kItems], lind[kChunks][kItems];
  int ldd[kChunks][kItems];
  int s1[3 * kChunks], t1[3 * kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int q = b0 + c * kChunk + tid * kItems;
    int4 dc = make_int4(2, 2, 2, 2), dp = make_int4(0, 0, 0, 0);
    int4 id = dp, d4 = dp;
    if (q < C && q < nlen) {  // only columns below new_len are read
      dc = *reinterpret_cast<const int4*>(doc + row + q);
      dp = *reinterpret_cast<const int4*>(delpk + row + q);
      id = *reinterpret_cast<const int4*>(ind + row + q);
      d4 = *reinterpret_cast<const int4*>(dd + row + q);
    }
    const int pv[kItems] = {dp.x, dp.y, dp.z, dp.w};
    const int iv[kItems] = {id.x, id.y, id.z, id.w};
    const int ev[kItems] = {d4.x, d4.y, d4.z, d4.w};
    dv[c][0] = dc.x;
    dv[c][1] = dc.y;
    dv[c][2] = dc.z;
    dv[c][3] = dc.w;
    int sdep = 0, sind = 0, sdd = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      sdep += (pv[k] & dmask) - (pv[k] >> dsh);
      sind += iv[k];
      sdd += ev[k];
      ldep[c][k] = sdep;
      lind[c][k] = sind;
      ldd[c][k] = sdd;
    }
    s1[3 * c] = sdep;
    s1[3 * c + 1] = sind;
    s1[3 * c + 2] = sdd;
  }
  block_excl_scan<kThreads>(s1, t1, ws);
#pragma unroll
  for (int n = 0; n < 3; ++n) s1[3 + n] += t1[n];  // chunk 1 follows chunk 0

  // ---- chain 1: publish the aggregate, look back, publish the prefix ----
  int* my = vals + self * kVals;
  unsigned bits = kAgg1;  // thread 0's view of this block's status word
  if (tid == 0) {
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      my[kAggOff1 + n] = t1[n] + t1[3 + n];
      if (b == 0) my[kIncOff1 + n] = t1[n] + t1[3 + n];
    }
    if (b == 0) bits |= kInc1;
    store_release(status + self, epoch << 8 | bits);
  }
  if (warp == 0) {
    int c1[3] = {0, 0, 0};
    if (b > 0) {
      look_back<3>(status, vals, first, self, epoch, kAgg1, kInc1, kAggOff1,
                   kIncOff1, c1);
    }
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < 3; ++n) carry_s[n] = c1[n];
      if (b > 0) {
#pragma unroll
        for (int n = 0; n < 3; ++n) {
          my[kIncOff1 + n] = c1[n] + t1[n] + t1[3 + n];
        }
        bits |= kInc1;
        store_release(status + self, epoch << 8 | bits);
      }
    }
  }
  __syncthreads();

  // ---- x, run and dd prefix; x to shared memory and the scratch row ----
  const int c_dep = carry_s[0], c_ind = carry_s[1], c_dd = carry_s[2];
  int dcum[kChunks][kItems];
  unsigned runs = 0;  // bit c * kItems + k
  int s2[kChunks], t2[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int q = b0 + c * kChunk + tid * kItems;
    int xv[kItems];
    int srun = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int depth = c_dep + s1[3 * c] + ldep[c][k];
      xv[k] = dv[c][k] - ((dv[c][k] & 1) & (depth > 0 ? 1 : 0));
      const int rn = (c_ind + s1[3 * c + 1] + lind[c][k]) > 0 ? 1 : 0;
      runs |= static_cast<unsigned>(rn) << (c * kItems + k);
      srun += rn;
      dcum[c][k] = c_dd + s1[3 * c + 2] + ldd[c][k];
    }
    const int4 x4 = make_int4(xv[0], xv[1], xv[2], xv[3]);
    *reinterpret_cast<int4*>(xs + c * kChunk + tid * kItems) = x4;
    if (q < C && q < nlen) {
      __stcg(reinterpret_cast<int4*>(scratch + row + q), x4);
    }
    s2[c] = srun;
  }
  __threadfence();  // the scratch row before "x ready"
  block_excl_scan<kThreads>(s2, t2, ws);  // its barriers also publish xs
  s2[1] += t2[0];

  // ---- chain 2: the hole count; "x ready" goes out with its aggregate ----
  if (tid == 0) {
    my[kAggOff2] = t2[0] + t2[1];
    if (b == 0) my[kIncOff2] = t2[0] + t2[1];
    bits |= kAgg2 | kXReady | (b == 0 ? kInc2 : 0);
    store_release(status + self, epoch << 8 | bits);
  }
  if (warp == 0) {
    int c2[1] = {0};
    if (b > 0) {
      look_back<1>(status, vals, first, self, epoch, kAgg2, kInc2, kAggOff2,
                   kIncOff2, c2);
    }
    if (lane == 0) {
      carry_s[3] = c2[0];
      if (b > 0) {
        my[kIncOff2] = c2[0] + t2[0] + t2[1];
        bits |= kInc2;
        store_release(status + self, epoch << 8 | bits);
      }
    }
    // sources of non-hole columns lie in [b0 - c2, b0 + kSpan - 1 - c2]:
    // at most two blocks, none to the right of this one
    const int lo = max(b0 - c2[0], 0);
    const int hi = max(b0 + kSpan - 1 - c2[0], 0);
    const int j = (lane == 0 ? lo : hi) / kSpan;
    if (lane < 2 && j < b) wait_for(status, first + j, epoch, kXReady);
    __syncwarp();
  }
  __syncthreads();

  // ---- gather, fill, beyond-length stamp, tile outputs ----
  const int c_cnt = carry_s[3];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int q = b0 + c * kChunk + tid * kItems;
    int cnt = c_cnt + s2[c];
    int ov[kItems];
    int vsum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int d = q + k;
      const bool rn = (runs >> (c * kItems + k)) & 1;
      cnt += rn ? 1 : 0;
      int o;
      if (d >= nlen) {
        o = 2;
      } else if (rn) {
        o = ((d + dcum[c][k] + 2) << 1) | 1;
      } else {
        const int s = max(d - cnt, 0);  // >= 0 at every non-hole column
        o = s >= b0 ? xs[s - b0] : __ldcg(scratch + row + s);
      }
      ov[k] = o;
      vsum += o & 1;
    }
    int vincl = vsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, vincl, o);
      if (lane >= o) vincl += y;
    }
    if (q < C) {
      *reinterpret_cast<int4*>(out + row + q) =
          make_int4(ov[0], ov[1], ov[2], ov[3]);
      int cc = vincl - vsum;
      short cs[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        cc += ov[k] & 1;
        cs[k] = static_cast<short>(cc);
      }
      *reinterpret_cast<short4*>(cv + row + q) =
          make_short4(cs[0], cs[1], cs[2], cs[3]);
      if (lane == 31) vis_tile[static_cast<size_t>(r) * nt + q / 128] = vincl;
    }
  }
}

}  // namespace

extern "C" int crdt_range_apply_blocked(
    const int* doc, const int* delpk, const int* ind, const int* dd,
    const int* new_len, int R, int C, int dsh, int* out, short* cv,
    int* vis_tile, int* scratch, unsigned long long* status, int* vals,
    unsigned long long* ticket, unsigned long long base,
    unsigned long long epoch, void* stream) {
  const int nblk = (C + kSpan - 1) / kSpan;
  range_apply_blocked_kernel<<<R * nblk, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      doc, delpk, ind, dd, new_len, C, nblk, dsh, out, cv, vis_tile, scratch,
      status, vals, ticket, base, epoch);
  return static_cast<int>(cudaGetLastError());
}
