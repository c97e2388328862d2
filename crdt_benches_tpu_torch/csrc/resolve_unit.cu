// K5: unit-op resolver for Hopper (sm_90a).
//
// Replaces the TPU kernel crdt_benches_tpu/ops/resolve_pallas.py
// resolve_batch_pallas (Pallas body _kernel) together with its extraction
// _extract_gather.  Contract, bit for bit: one batch of B unit ops
// (kind/pos shared by every replica) is resolved against each replica's
// visible length v0 over a cum-primary token list of T tokens
// (tta = ta*4 + ttype with RUN/TINS/TDEAD/FREE, cum = inclusive prefix of
// token lengths).  Outputs per replica and op: del_rank, ins_gvis, ins_seq,
// ins_alive (bool), origin and del_batch.  With emit_origin == 0 an
// insert's origin is -1 and any other op's -2.
//
// What bounds it on the H100: the op loop is sequential, so per replica it
// is a chain of B dependent steps, each rewriting the (tta, cum) list —
// shared-memory traffic and instruction issue, O(R*B*T) in all; its
// device-memory traffic (the six (R, B) outputs) is small.
//
// Design: one block per replica (every replica does its own full resolve,
// never deduplicated).  The token list lives in shared memory twice
// (double buffering): op j reads buffer j%2 and writes buffer (j+1)%2, so
// the tail shift by m-1 has no read/write race and each op needs a single
// __syncthreads().  cum is nondecreasing (zero-length TDEAD and FREE
// tokens share their predecessor's cum), so the token holding position p
// — the first with cum > p — is a binary search that every thread runs on
// the same (broadcast) addresses, clamped to the first FREE token for an
// insert at the end.  The per-op token index opos (where each op's token
// sits in the final list) shifts with the tail and stays in shared
// memory, as does a killed flag per op (set when a later delete of the
// batch hits the op's TINS token).  The extraction is fused into the
// epilogue: one thread walks the final list backward (suffix-min of the
// run starts: each token's gap rank) and forward (tie-break rank within a
// gap), then every op gathers its results at opos.  Those two walks are
// O(T) once per launch against the loop's O(B*T).
// Shared memory: (4T + 2B) * 4 bytes (12,288 at B = 256, T = 640).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFree = 0;
constexpr int kRun = 1;
constexpr int kTins = 2;
constexpr int kTdead = 3;
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr int kOriginBatch = 1 << 24;
constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// #(cum[i] <= p) over the nondecreasing cum[0..T)
__device__ __forceinline__ int count_le(const int* cum, int T, int p) {
  int lo = 0, hi = T;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
resolve_unit_kernel(const int* __restrict__ kind, const int* __restrict__ pos,
                    const int* __restrict__ v0, int B, int T, int emit_origin,
                    int* __restrict__ drank_o, int* __restrict__ gvis_o,
                    int* __restrict__ seq_o, bool* __restrict__ alive_o,
                    int* __restrict__ origin_o, int* __restrict__ dbatch_o) {
  // buffer c of field f (tta 0, cum 1) at smem + (2 * f + c) * T
  extern __shared__ int smem[];
  int* opos = smem + 4 * T;
  int* killed = opos + B;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t rb = static_cast<size_t>(r) * B;
  const int vr = v0[r];
  for (int i = tid; i < T; i += kThreads) {
    smem[i] = i == 0 ? kRun : kFree;  // tta; ta = 0 everywhere
    smem[2 * T + i] = vr;             // cum
  }
  for (int j = tid; j < B; j += kThreads) {
    opos[j] = 0;
    killed[j] = 0;
  }
  __syncthreads();

  int total = vr;
  int nused = 1;
  int cur = 0;
  // software prefetch of the (uniform) op fields one op ahead
  int k = __ldg(kind), p0 = __ldg(pos);
  for (int j = 0; j < B; ++j) {
    int kn = 0, pn = 0;
    if (j + 1 < B) {
      kn = __ldg(kind + j + 1);
      pn = __ldg(pos + j + 1);
    }
    const int* tta = smem + cur * T;
    const int* cum = smem + (2 + cur) * T;
    int* ntta = smem + (cur ^ 1) * T;
    int* ncum = smem + (2 + (cur ^ 1)) * T;

    const bool is_ins = k == kInsert;
    const int p = imin(imax(p0, 0), total);
    const bool is_del = k == kDelete && p < total;
    const int t = imin(count_le(cum, T, p), nused);
    const int c_t = t < T ? cum[t] : 0;
    const int pre = t > 0 ? cum[t - 1] : 0;
    const int tta_t = t < T ? tta[t] : 0;
    const int a = tta_t >> 2;
    const int tt = tta_t & 3;
    const int off = p - pre;
    const bool hit_run = tt == kRun;
    const bool split = is_ins && off > 0;
    // token t becomes m in {1, 2, 3} tokens:
    //   INSERT off == 0 : [ TINS(j), old_t ]
    //   INSERT off  > 0 : [ RUN(a, off), TINS(j), RUN(a + off, rest) ]
    //   DELETE on TINS  : [ TDEAD(a) ]
    //   DELETE on RUN   : [ RUN(a, off), RUN(a + off + 1, rest) ]
    //   PAD, or a delete past the end: [ old_t ]
    const int m = is_ins ? (split ? 3 : 2) : (is_del && hit_run ? 2 : 1);
    const int delta = (is_ins ? 1 : 0) - (is_del ? 1 : 0);
    const int j4 = j * 4;
    const int n0 = is_ins ? (split ? a * 4 + kRun : j4 + kTins)
                   : is_del ? a * 4 + (hit_run ? kRun : kTdead)
                            : tta_t;
    const int n0c = is_ins ? (split ? p : pre + 1)
                    : is_del ? (hit_run ? p : pre)
                             : c_t;
    const int n1 = is_ins ? (split ? j4 + kTins : tta_t)
                          : (a + off + 1) * 4 + kRun;
    const int n1c = is_ins ? (split ? p + 1 : c_t + 1) : c_t - 1;
    const int n2 = (a + off) * 4 + kRun;
    const int n2c = c_t + 1;
    const int sh = m - 1;

    for (int i = tid; i < T; i += kThreads) {
      int ota, oc;
      if (i < t) {
        ota = tta[i];
        oc = cum[i];
      } else if (i == t) {
        ota = n0; oc = n0c;
      } else if (i == t + 1 && m >= 2) {
        ota = n1; oc = n1c;
      } else if (i == t + 2 && m == 3) {
        ota = n2; oc = n2c;
      } else {
        ota = tta[i - sh];
        oc = cum[i - sh] + delta;
      }
      ntta[i] = ota;
      ncum[i] = oc;
    }
    // earlier ops' token indices move with the tail
    for (int b = tid; b < j; b += kThreads) {
      if (opos[b] >= t) opos[b] += sh;
    }
    if (tid == 0) {
      opos[j] = split ? t + 1 : t;
      const bool kill = is_del && tt == kTins;
      if (kill) killed[a] = 1;  // a is the op index of a TINS token
      drank_o[rb + j] = is_del && hit_run ? a + off : -1;
      dbatch_o[rb + j] = kill ? a : -1;
      int org = -2;
      if (is_ins) {
        org = -1;
        if (emit_origin && p > 0) {
          // the char at offset p - 1: always a token of positive length
          const int tp = count_le(cum, T, p - 1);
          const int pre_tp = tp > 0 ? cum[tp - 1] : 0;
          const int tta_tp = tp < T ? tta[tp] : 0;
          org = (tta_tp & 3) == kRun ? (tta_tp >> 2) + (p - 1 - pre_tp)
                                     : kOriginBatch + (tta_tp >> 2);
        }
      }
      origin_o[rb + j] = org;
    }
    total += delta;
    nused += sh;
    cur ^= 1;
    k = kn;
    p0 = pn;
    __syncthreads();
  }

  // ---- extraction over the final list; the other buffers hold its
  // per-token gap rank (gv) and tie-break rank (sq) ----
  const int* tta = smem + cur * T;
  const int* cum = smem + (2 + cur) * T;
  int* gv = smem + (cur ^ 1) * T;
  int* sq = smem + (2 + (cur ^ 1)) * T;
  if (tid == 0) {
    // gap rank: the first surviving pre-batch char to the token's right
    int mn = kBig;
    for (int i = T - 1; i >= 0; --i) {
      gv[i] = mn >= kBig ? vr : mn;
      const int len = cum[i] - (i > 0 ? cum[i - 1] : 0);
      if ((tta[i] & 3) == kRun && len > 0) mn = imin(mn, tta[i] >> 2);
    }
    // tie-break: rank among the instok tokens of one gap (they are
    // contiguous among instok tokens, and gv is nondecreasing)
    int ci = 0, prev_g = -1, base = -1;
    for (int i = 0; i < T; ++i) {
      const int ty = tta[i] & 3;
      const bool inst = ty == kTins || ty == kTdead;
      ci += inst ? 1 : 0;
      if (inst && prev_g != gv[i]) base = imax(base, ci - 1);
      sq[i] = ci - 1 - base;
      if (inst) prev_g = imax(prev_g, gv[i]);
    }
  }
  __syncthreads();
  for (int b = tid; b < B; b += kThreads) {
    const bool ins = __ldg(kind + b) == kInsert;
    const int at = imin(imax(opos[b], 0), T - 1);
    gvis_o[rb + b] = ins ? gv[at] : -1;
    seq_o[rb + b] = ins ? sq[at] : 0;
    alive_o[rb + b] = ins && !killed[b];
  }
}

}  // namespace

extern "C" int crdt_resolve_unit(const int* kind, const int* pos,
                                 const int* v0, int R, int B, int T,
                                 int emit_origin, int* del_rank,
                                 int* ins_gvis, int* ins_seq, bool* ins_alive,
                                 int* origin, int* del_batch, void* stream) {
  const int smem = (4 * T + 2 * B) * static_cast<int>(sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      resolve_unit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  resolve_unit_kernel<<<R, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      kind, pos, v0, B, T, emit_origin, del_rank, ins_gvis, ins_seq,
      ins_alive, origin, del_batch);
  return static_cast<int>(cudaGetLastError());
}
