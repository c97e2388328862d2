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
// What bounds it on the H100: the op loop is sequential, so per replica
// it is a chain of B dependent steps, each rewriting the token list —
// shared-memory traffic and instruction issue, O(R*B*T) in all; its
// device-memory traffic (the outputs, ~R*(4T+3B)*4 bytes) is small.
//
// Design: one block per replica (every replica does its own full resolve,
// never deduplicated).  The token list lives in shared memory twice
// (double buffering): op j reads buffer j%2 and writes buffer (j+1)%2, so
// the in-place tail shift by m-1 has no read/write race and each op needs
// a single __syncthreads().  cum is nondecreasing, so the token holding
// the op's position is found by a binary search that every thread runs on
// the same (broadcast) addresses; the TPU kernel's full-width reductions
// and roll cascades are not needed.  The per-op delete intervals are
// reduced with shared-memory atomics into per-op slots (only the few
// tokens a delete overlaps take part), and written out once at the end.
// Shared memory: (6T + 3B) * 4 bytes (95,232 at B = 1536, T = 3200).
//
// Per-row form (resolve_rows_kernel, the serving fleet's resolve): each row
// is a different document with its own ops, K rounds of B ops as
// int32[K, R, B].  It replaces the JAX package's vmapped scan
// ops/resolve_range_scan.py resolve_ranges_rows (the vmappable twin of the
// Pallas kernel, the same step) and ops/serve_fused.py round_starts: one
// block per row resolves its K rounds in order with the same body,
// resetting the token list each round and carrying the visible total
// across rounds; the total before each round is that round's start.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFree = 0;
constexpr int kRun = 1;
constexpr int kTins = 2;
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// One batch of B ops (uniform across the block) resolved against a
// document of total0 visible chars; the outputs are this row's slices.
// Returns the visible total after the batch.  Ends with a barrier, so the
// caller may run it again on the same shared memory.
__device__ __forceinline__ int resolve_one(
    const int* __restrict__ kind, const int* __restrict__ pos,
    const int* __restrict__ rlen, const int* __restrict__ slot0,
    const int total0, const int B, const int T, int* smem,
    int* __restrict__ ttype_o, int* __restrict__ ta_o,
    int* __restrict__ tch_o, int* __restrict__ tlen_o,
    int* __restrict__ dlo_o, int* __restrict__ dhi_o,
    int* __restrict__ dn_o, int* __restrict__ nused_o) {
  // buffer c of field f (tta 0, tch 1, cum 2) at smem + (2 * f + c) * T
  int* dlo_s = smem + 6 * T;
  int* dhi_s = dlo_s + B;
  int* dn_s = dhi_s + B;

  const int tid = threadIdx.x;
  for (int i = tid; i < T; i += kThreads) {
    smem[i] = i == 0 ? kRun : kFree;  // tta; ta = 0 everywhere
    smem[2 * T + i] = 0;               // tch
    smem[4 * T + i] = total0;          // cum
  }
  for (int j = tid; j < B; j += kThreads) {
    dlo_s[j] = kBig;
    dhi_s[j] = -1;
    dn_s[j] = 0;
  }
  __syncthreads();

  int total = total0;
  int nused = 1;
  int cur = 0;
  // software prefetch of the (uniform) op fields one op ahead
  int k = __ldg(kind), p0 = __ldg(pos), L0 = __ldg(rlen), s0 = __ldg(slot0);
  for (int j = 0; j < B; ++j) {
    int kn = 0, pn = 0, ln = 0, sn = 0;
    if (j + 1 < B) {
      kn = __ldg(kind + j + 1);
      pn = __ldg(pos + j + 1);
      ln = __ldg(rlen + j + 1);
      sn = __ldg(slot0 + j + 1);
    }
    const int* tta = smem + cur * T;
    const int* tch = smem + (2 + cur) * T;
    const int* cum = smem + (4 + cur) * T;
    int* ntta = smem + (cur ^ 1) * T;
    int* ntch = smem + (2 + (cur ^ 1)) * T;
    int* ncum = smem + (4 + (cur ^ 1)) * T;

    const bool is_ins = k == kInsert && L0 > 0;
    const int p = imin(imax(p0, 0), total);
    const int D = k == kDelete ? imin(imax(L0, 0), total - p) : 0;
    const bool is_del = k == kDelete && D > 0;
    const int L = is_ins ? L0 : 0;
    const int pD = p + D;

    // t = #(cum <= p): cum is nondecreasing over all T tokens
    int lo = 0, hi = T;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= p) lo = mid + 1; else hi = mid;
    }
    const int t = imin(lo, nused);
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

    // replacement pieces (from the PRE-clamp values at t)
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
    const int sh = m - 1;

    for (int i = tid; i < T; i += kThreads) {
      if (is_del) {  // delete rank interval over pre-clamp tokens
        const int ci = cum[i];
        const int pi = i > 0 ? cum[i - 1] : 0;
        const int ti = tta[i];
        const int ov_lo = imax(pi, p);
        const int ov_hi = imin(ci, pD);
        if ((ti & 3) == kRun && ov_hi > ov_lo) {
          const int a = ti >> 2;
          atomicMin(dlo_s + j, a + (ov_lo - pi));
          atomicMax(dhi_s + j, a + (ov_hi - pi) - 1);
          atomicAdd(dn_s + j, ov_hi - ov_lo);
        }
      }
      int ota, oc, ocum;
      if (i == t) {
        ota = n0ta; oc = n0c; ocum = n0cum;
      } else if (i == t + 1 && m >= 2) {
        ota = n1ta; oc = n1c; ocum = n1cum;
      } else if (i == t + 2 && m == 3) {
        ota = n2ta; oc = n2c; ocum = n2cum;
      } else {
        // kept (i < t) or shifted (i >= t + m) token, delete-clamped
        const int src = i < t ? i : i - sh;
        const int cs = cum[src];
        const int ps = src > 0 ? cum[src - 1] : 0;
        const int ts = tta[src];
        ota = ts;
        oc = tch[src];
        ocum = cs;
        if (is_del) {
          const int consumed = imax(0, imin(cs, pD) - imax(ps, p));
          const int adv = cs > pD ? consumed : 0;
          ocum = imin(cs, p) + imax(0, cs - pD);
          if ((ts & 3) == kRun) ota += adv * 4;
          if ((ts & 3) == kTins) oc += adv;
        }
        if (i >= t) ocum += L;
      }
      ntta[i] = ota;
      ntch[i] = oc;
      ncum[i] = ocum;
    }
    total += L - D;
    nused += m - 1;
    cur ^= 1;
    k = kn; p0 = pn; L0 = ln; s0 = sn;
    __syncthreads();
  }

  const int* tta = smem + cur * T;
  const int* tch = smem + (2 + cur) * T;
  const int* cum = smem + (4 + cur) * T;
  for (int i = tid; i < T; i += kThreads) {
    ttype_o[i] = tta[i] & 3;
    ta_o[i] = tta[i] >> 2;
    tch_o[i] = tch[i];
    tlen_o[i] = cum[i] - (i > 0 ? cum[i - 1] : 0);
  }
  for (int j = tid; j < B; j += kThreads) {
    dlo_o[j] = dlo_s[j] >= kBig ? -1 : dlo_s[j];
    dhi_o[j] = dhi_s[j];
    dn_o[j] = dn_s[j];
  }
  if (tid == 0 && nused_o != nullptr) *nused_o = nused;
  __syncthreads();  // the token buffers are free for the next batch
  return total;
}

__global__ void __launch_bounds__(kThreads)
resolve_range_kernel(const int* __restrict__ kind,
                     const int* __restrict__ pos,
                     const int* __restrict__ rlen,
                     const int* __restrict__ slot0,
                     const int* __restrict__ v0, int B, int T,
                     int* __restrict__ ttype_o, int* __restrict__ ta_o,
                     int* __restrict__ tch_o, int* __restrict__ tlen_o,
                     int* __restrict__ dlo_o, int* __restrict__ dhi_o,
                     int* __restrict__ dn_o, int* __restrict__ nused_o) {
  extern __shared__ int smem[];
  const int r = blockIdx.x;
  const size_t ro = static_cast<size_t>(r) * T;
  const size_t rb = static_cast<size_t>(r) * B;
  resolve_one(kind, pos, rlen, slot0, v0[r], B, T, smem, ttype_o + ro,
              ta_o + ro, tch_o + ro, tlen_o + ro, dlo_o + rb, dhi_o + rb,
              dn_o + rb, nused_o + r);
}

// Per-row form: ops int32[K, R, B]; outputs (K, R, T), (K, R, B) and the
// visible total before each round, starts int32[K, R].
__global__ void __launch_bounds__(kThreads)
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
  const int r = blockIdx.x;
  int total = v0[r];
  for (int k = 0; k < K; ++k) {
    const size_t kr = static_cast<size_t>(k) * R + r;
    const size_t ro = kr * T;
    const size_t rb = kr * B;
    if (threadIdx.x == 0) starts[kr] = total;
    total = resolve_one(kind + rb, pos + rb, rlen + rb, slot0 + rb, total, B,
                        T, smem, ttype_o + ro, ta_o + ro, tch_o + ro,
                        tlen_o + ro, dlo_o + rb, dhi_o + rb, dn_o + rb,
                        nullptr);
  }
}

}  // namespace

extern "C" int crdt_resolve_range(const int* kind, const int* pos,
                                  const int* rlen, const int* slot0,
                                  const int* v0, int R, int B, int T,
                                  int* ttype, int* ta, int* tch, int* tlen,
                                  int* dlo, int* dhi, int* dcount,
                                  int* nused, void* stream) {
  const int smem = (6 * T + 3 * B) * static_cast<int>(sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      resolve_range_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  resolve_range_kernel<<<R, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      kind, pos, rlen, slot0, v0, B, T, ttype, ta, tch, tlen, dlo, dhi,
      dcount, nused);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crdt_resolve_range_rows(const int* kind, const int* pos,
                                       const int* rlen, const int* slot0,
                                       const int* v0, int K, int R, int B,
                                       int T, int* ttype, int* ta, int* tch,
                                       int* tlen, int* dlo, int* dhi,
                                       int* dcount, int* starts,
                                       void* stream) {
  const int smem = (6 * T + 3 * B) * static_cast<int>(sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      resolve_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  resolve_rows_kernel<<<R, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      kind, pos, rlen, slot0, v0, K, R, B, T, ttype, ta, tch, tlen, dlo, dhi,
      dcount, starts);
  return static_cast<int>(cudaGetLastError());
}
