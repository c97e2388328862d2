// K1: range-op resolver for Hopper (sm_90a).
//
// Replaces the TPU kernel crdt_benches_tpu/ops/resolve_range_pallas.py
// resolve_range_pallas (Pallas body _kernel).  Contract, bit for bit: one
// batch of B range ops (kind/pos/rlen/slot0 shared by every replica) is
// resolved against each replica's visible length v0 over a cum-primary
// token list of T tokens (tta = ta*4 + ttype, tch, cum).  Outputs per
// replica: the final tokens (ttype, ta, tch, tlen)[T], the per-op delete
// rank intervals (dlo, dhi, dcount)[B] and nused, the TRUE token demand
// (it keeps counting past T; placements past T are dropped).
//
// What bounds it on the H100: latency.  Each replica is a chain of B
// dependent steps (find the op's token, move or clamp the live tail after
// it), and the work of a step is its live tail [t, nused]; device-memory
// traffic (the outputs, ~R*(4T+3B)*4 bytes) is small.
//
// Design (that of resolve_unit.cu, K5, wherever the resolvers are alike):
// one warp per replica, every replica resolving its own batch (never
// deduplicated).  Each warp keeps one (tta, tch, cum) list of T + 1 ints
// per field in shared memory and edits it in place; the ops are read
// through the read-only cache, one op ahead.  Only tokens [0, nused] are
// ever read: token nused is the FREE sentinel with cum = the visible
// total, where an insert at the end lands; nothing past it is kept.  The
// op's token is t = #(cum <= p) over [0, nused), in levels of 32 probes,
// one ballot each.  PAD ops, empty inserts and deletes that clamp to
// nothing skip the op.  Token t becomes m in {1, 2, 3} tokens (the pieces
// n0/n1/n2) and the tail [t + 1, nused] moves right by m - 1 with cum + L;
// for a delete every tail token is also clamped (min(cum, p) +
// max(0, cum - pD), advancing a RUN's ta or a TINS's tch by the chars
// consumed before its new start).  Tokens before t are never touched:
// their cum <= p, so neither the clamp nor the shift changes them.  The
// warp walks the destinations from the top in groups of four 32-token
// chunks: each lane reads its four sources (or takes its new pieces),
// __syncwarp(), then writes (a group's writes lie above every read of the
// groups below it, and its four chunks' loads overlap).  A
// delete's outputs are warp reductions (min, max, add) over the pre-clamp
// RUN tokens overlapping [p, pD), all of which lie in [t, nused): token t
// on lane 0, the rest as the walk reads them.  Lane j % 32 keeps op j's
// outputs in registers; every 32 ops the warp stores them coalesced.  The
// epilogue writes all T tokens: the list up to the sentinel, and
// (FREE, 0, 0, 0) past it without reading shared memory.
//
// Under token_cap (the shared form only) demand can pass T: the list then
// holds tokens [0, T) with no sentinel, the search runs over [0, T),
// writes past T - 1 are dropped (the walk still reads the tail tokens
// that shift out, for the delete reductions) and t == T takes zeros for
// token t's fields, as the Pallas kernel does.
//
// Warps a block: as many lists as 227 KB of shared memory hold, at most
// kMaxWarps = 4.  At the headline (B = 1536, T = 3200) a list is 38,412
// bytes, four 153,648, so one block runs on an SM and R = 1024 replicas
// take two waves; they would at 5 or 6 warps a block too (6 is the most
// that fit, 230,472 bytes), and at 4 each warp has one of the SM's four
// schedulers to itself.  One wave would need eight warps an SM, 28.4 KB a
// list.  The per-row form at T = 256 takes 12,336 bytes a block, so 2048
// rows fit in one wave.  ops/resolve_range.py range_smem_bytes mirrors it.
//
// Per-row form (resolve_rows_kernel, the serving fleet's resolve): each row
// is a different document with its own ops, K rounds of B ops as
// int32[K, R, B].  It replaces the JAX package's vmapped scan
// ops/resolve_range_scan.py resolve_ranges_rows (the vmappable twin of the
// Pallas kernel, the same step) and ops/serve_fused.py round_starts: one
// warp per row resolves its K rounds in order with the same body,
// resetting its list each round and carrying the visible total across
// rounds; the total before each round is that round's start.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_list.cuh"

namespace {

constexpr int kFree = 0;
constexpr int kRun = 1;
constexpr int kTins = 2;
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr int kBig = 1 << 30;
constexpr int kMaxWarps = 4;
constexpr int kChunks = 4;  // 32-token chunks moved per __syncwarp()
constexpr int kMaxSmem = 232448;  // shared memory a block may use (227 KB)
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// One batch of B ops resolved by one warp against a document of total0
// visible chars, over the warp's list (tta, tch, cum: T + 1 ints each);
// the outputs are this replica's (row's) slices.  Returns the visible
// total after the batch.  Ends with __syncwarp(), so the caller may run it
// again on the same list.
__device__ int resolve_warp(
    const int* __restrict__ kind, const int* __restrict__ pos,
    const int* __restrict__ rlen, const int* __restrict__ slot0,
    const int total0, const int B, const int T, int* tta, int* tch,
    int* cum, const int lane, int* __restrict__ ttype_o,
    int* __restrict__ ta_o, int* __restrict__ tch_o,
    int* __restrict__ tlen_o, int* __restrict__ dlo_o,
    int* __restrict__ dhi_o, int* __restrict__ dn_o,
    int* __restrict__ nused_o) {
  if (lane < 2) {  // RUN(0) of length total0, then the FREE sentinel
    tta[lane] = lane == 0 ? kRun : kFree;
    tch[lane] = 0;
    cum[lane] = total0;
  }
  __syncwarp();

  int total = total0;
  int nused = 1;
  int my_lo = -1, my_hi = -1, my_n = 0;  // op (j & ~31) + lane's outputs
  int k = 0, p0 = 0, L0 = 0, s0 = 0;
  if (B > 0) {
    k = __ldg(kind);
    p0 = __ldg(pos);
    L0 = __ldg(rlen);
    s0 = __ldg(slot0);
  }
  for (int j = 0; j < B; ++j) {
    int kn = 0, pn = 0, ln = 0, sn = 0;  // the next op, off the critical path
    if (j + 1 < B) {
      kn = __ldg(kind + j + 1);
      pn = __ldg(pos + j + 1);
      ln = __ldg(rlen + j + 1);
      sn = __ldg(slot0 + j + 1);
    }
    const bool is_ins = k == kInsert && L0 > 0;
    const int p = imin(imax(p0, 0), total);
    const int D = k == kDelete ? imin(imax(L0, 0), total - p) : 0;
    const bool is_del = D > 0;
    int dlo = -1, dhi = -1, dn = 0;
    if (is_ins || is_del) {
      const int L = is_ins ? L0 : 0;
      const int pD = p + D;
      // the op's token over the valid tokens (all T of a capped full list)
      const int t = warp_count_le(cum, imin(nused, T), p, lane);
      int c_t = 0, pre = 0, tta_t = 0, ch = 0;  // zero when t == T
      if (t < T) {
        c_t = cum[t];
        pre = t > 0 ? cum[t - 1] : 0;
        tta_t = tta[t];
        ch = tch[t];
      }
      const int tt = tta_t & 3;
      const bool is_run_t = tt == kRun;
      const int off = p - pre;
      const bool split_ins = is_ins && off > 0;
      const bool split_del = is_del && off > 0 && pD < c_t;
      const int m = is_ins ? (split_ins ? 3 : 2) : (split_del ? 2 : 1);
      const int sh = m - 1;

      // token t's pieces (from its PRE-clamp values):
      //   INSERT off == 0 : [ TINS(s0), old_t + L ]
      //   INSERT off  > 0 : [ left, TINS(s0), right + L ]
      //   DELETE splitting: [ left, right after the deleted chars ]
      //   DELETE otherwise: [ old_t clamped ]
      const int c_t_cl = is_del ? imin(c_t, p) + imax(0, c_t - pD) : c_t;
      const int adv_t =
          (is_del && c_t > pD) ? imax(0, imin(c_t, pD) - imax(pre, p)) : 0;
      const int tta_cl = tta_t + (is_run_t ? adv_t * 4 : 0);
      const int ch_cl = ch + (tt == kTins ? adv_t : 0);
      const int jj_tins = s0 * 4 + kTins;
      const int n0ta = (is_ins && !split_ins) ? jj_tins
                       : (split_del ? tta_t : tta_cl);
      const int n0c = (is_ins && !split_ins) ? 0 : (split_del ? ch : ch_cl);
      const int n0cum = is_ins ? (split_ins ? p : pre + L)
                               : (split_del ? p : c_t_cl);
      const int n1ta = is_ins ? (split_ins ? jj_tins : tta_t)
                              : tta_t + (is_run_t ? (pD - pre) * 4 : 0);
      const int n1c = is_ins ? (split_ins ? 0 : ch)
                             : (is_run_t ? ch : ch + (pD - pre));
      const int n1cum = is_ins ? (split_ins ? p + L : c_t + L) : c_t - D;
      const int n2ta = tta_t + (is_run_t ? off * 4 : 0);
      const int n2c = is_run_t ? ch : ch + off;
      const int n2cum = c_t + L;

      // the delete's rank interval over the pre-clamp RUN tokens that
      // overlap [p, pD): token t here, the tail during the walk
      int lo = kBig, hi = -1, cnt = 0;
      if (is_del && lane == 0 && is_run_t) {
        const int ov_lo = imax(pre, p);
        const int ov_hi = imin(c_t, pD);
        if (ov_hi > ov_lo) {
          lo = (tta_t >> 2) + (ov_lo - pre);
          hi = (tta_t >> 2) + (ov_hi - pre) - 1;
          cnt = ov_hi - ov_lo;
        }
      }
      // destinations [t, last + sh] (last = the last valid token) in
      // groups of kChunks 32-token chunks from the top: d takes piece
      // d - t below t + m, else token d - sh moved (and clamped); the
      // group reads, __syncwarp(), then writes (past T - 1 dropped).  A
      // group's reads lie below the writes of the groups above it, and
      // its chunks' reads are independent, so they overlap.
      for (int top = imin(nused, T - 1) + sh; top >= t;
           top -= 32 * kChunks) {
        int nt[kChunks], nc[kChunks], ncum[kChunks];
#pragma unroll
        for (int g = 0; g < kChunks; ++g) {
          const int d = top - 32 * g - lane;
          const int q = d - t;
          nt[g] = q == 0 ? n0ta : q == 1 ? n1ta : n2ta;
          nc[g] = q == 0 ? n0c : q == 1 ? n1c : n2c;
          ncum[g] = q == 0 ? n0cum : q == 1 ? n1cum : n2cum;
          if (q >= m) {
            const int src = d - sh;  // > t >= 0
            const int cs = cum[src];
            int ta4 = tta[src];
            int c = tch[src];
            ncum[g] = cs + L;
            if (is_del) {
              const int ps = cum[src - 1];
              const int ov_lo = imax(ps, p);
              const int ov_hi = imin(cs, pD);
              const int consumed = imax(0, ov_hi - ov_lo);
              if ((ta4 & 3) == kRun && consumed > 0) {
                lo = imin(lo, (ta4 >> 2) + (ov_lo - ps));
                hi = imax(hi, (ta4 >> 2) + (ov_hi - ps) - 1);
                cnt += consumed;
              }
              const int adv = cs > pD ? consumed : 0;
              ncum[g] = imin(cs, p) + imax(0, cs - pD);
              if ((ta4 & 3) == kRun) ta4 += adv * 4;
              if ((ta4 & 3) == kTins) c += adv;
            }
            nt[g] = ta4;
            nc[g] = c;
          }
        }
        __syncwarp();
#pragma unroll
        for (int g = 0; g < kChunks; ++g) {
          const int d = top - 32 * g - lane;
          if (d >= t && d < T) {
            tta[d] = nt[g];
            tch[d] = nc[g];
            cum[d] = ncum[g];
          }
        }
      }
      __syncwarp();
      if (is_del) {
        lo = __reduce_min_sync(kAll, lo);
        dlo = lo >= kBig ? -1 : lo;
        dhi = __reduce_max_sync(kAll, hi);
        dn = __reduce_add_sync(kAll, cnt);
      }
      total += L - D;
      nused += sh;
    }
    if (lane == (j & 31)) {
      my_lo = dlo;
      my_hi = dhi;
      my_n = dn;
    }
    if ((j & 31) == 31 || j == B - 1) {
      const int jj = (j & ~31) + lane;
      if (jj <= j) {
        dlo_o[jj] = my_lo;
        dhi_o[jj] = my_hi;
        dn_o[jj] = my_n;
      }
    }
    k = kn;
    p0 = pn;
    L0 = ln;
    s0 = sn;
  }

  // the list up to its last valid token (the sentinel, or T - 1 when a
  // capped list is full), then FREE tokens of zero length
  const int last = imin(nused, T - 1);
  for (int i = lane; i < T; i += 32) {
    int ty = kFree, a = 0, c = 0, len = 0;
    if (i <= last) {
      const int v = tta[i];
      ty = v & 3;
      a = v >> 2;
      c = tch[i];
      len = cum[i] - (i > 0 ? cum[i - 1] : 0);
    }
    ttype_o[i] = ty;
    ta_o[i] = a;
    tch_o[i] = c;
    tlen_o[i] = len;
  }
  if (lane == 0 && nused_o != nullptr) *nused_o = nused;
  __syncwarp();  // the list is free for the next round
  return total;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
resolve_range_kernel(const int* __restrict__ kind,
                     const int* __restrict__ pos,
                     const int* __restrict__ rlen,
                     const int* __restrict__ slot0,
                     const int* __restrict__ v0, int R, int B, int T,
                     int* __restrict__ ttype_o, int* __restrict__ ta_o,
                     int* __restrict__ tch_o, int* __restrict__ tlen_o,
                     int* __restrict__ dlo_o, int* __restrict__ dhi_o,
                     int* __restrict__ dn_o, int* __restrict__ nused_o) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;
  int* tta = smem + warp * 3 * (T + 1);
  const size_t ro = static_cast<size_t>(r) * T;
  const size_t rb = static_cast<size_t>(r) * B;
  resolve_warp(kind, pos, rlen, slot0, v0[r], B, T, tta, tta + T + 1,
               tta + 2 * (T + 1), lane, ttype_o + ro, ta_o + ro, tch_o + ro,
               tlen_o + ro, dlo_o + rb, dhi_o + rb, dn_o + rb, nused_o + r);
}

// Per-row form: ops int32[K, R, B]; outputs (K, R, T), (K, R, B) and the
// visible total before each round, starts int32[K, R].
__global__ void __launch_bounds__(kMaxWarps * 32)
resolve_rows_kernel(const int* __restrict__ kind,
                    const int* __restrict__ pos,
                    const int* __restrict__ rlen,
                    const int* __restrict__ slot0,
                    const int* __restrict__ v0, int K, int R, int B, int T,
                    int* __restrict__ ttype_o, int* __restrict__ ta_o,
                    int* __restrict__ tch_o, int* __restrict__ tlen_o,
                    int* __restrict__ dlo_o, int* __restrict__ dhi_o,
                    int* __restrict__ dn_o, int* __restrict__ starts) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;
  int* tta = smem + warp * 3 * (T + 1);
  int total = v0[r];
  for (int k = 0; k < K; ++k) {
    const size_t kr = static_cast<size_t>(k) * R + r;
    const size_t ro = kr * T;
    const size_t rb = kr * B;
    if (lane == 0) starts[kr] = total;
    total = resolve_warp(kind + rb, pos + rb, rlen + rb, slot0 + rb, total,
                         B, T, tta, tta + T + 1, tta + 2 * (T + 1), lane,
                         ttype_o + ro, ta_o + ro, tch_o + ro, tlen_o + ro,
                         dlo_o + rb, dhi_o + rb, dn_o + rb, nullptr);
  }
}

// Warps a block at token list T (0 when not even one list fits).
int block_warps(int T) {
  const int w = kMaxSmem / (3 * (T + 1) * static_cast<int>(sizeof(int)));
  return w < kMaxWarps ? w : kMaxWarps;
}

// Sets the kernel's shared memory, launches it on ceil(R / warps) blocks.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int R, int T, void* stream, Args... args) {
  const int warps = block_warps(T);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = warps * 3 * (T + 1) * static_cast<int>(sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(R + warps - 1) / warps, warps * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int crdt_resolve_range(const int* kind, const int* pos,
                                  const int* rlen, const int* slot0,
                                  const int* v0, int R, int B, int T,
                                  int* ttype, int* ta, int* tch, int* tlen,
                                  int* dlo, int* dhi, int* dcount,
                                  int* nused, void* stream) {
  return launch(resolve_range_kernel, R, T, stream, kind, pos, rlen, slot0,
                v0, R, B, T, ttype, ta, tch, tlen, dlo, dhi, dcount, nused);
}

extern "C" int crdt_resolve_range_rows(const int* kind, const int* pos,
                                       const int* rlen, const int* slot0,
                                       const int* v0, int K, int R, int B,
                                       int T, int* ttype, int* ta, int* tch,
                                       int* tlen, int* dlo, int* dhi,
                                       int* dcount, int* starts,
                                       void* stream) {
  return launch(resolve_rows_kernel, R, T, stream, kind, pos, rlen, slot0,
                v0, K, R, B, T, ttype, ta, tch, tlen, dlo, dhi, dcount,
                starts);
}
