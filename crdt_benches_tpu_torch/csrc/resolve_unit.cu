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
// What bounds it on the H100: latency.  Each replica is a chain of B
// dependent steps (find the op's token, move the live tail after it), and
// the work of a step is the live tail [t, nused], which in an editing trace
// is a few tokens; device-memory traffic (the six (R, B) outputs) is small.
//
// Design: one warp per replica, kWarps replicas per block (every replica
// does its own full resolve, never deduplicated).  kind/pos are staged in
// shared memory once per block, behind the only __syncthreads(); nothing
// in the op loop syncs more than the warp.  Each warp keeps one (tta, cum)
// list of T + 1 ints per field in shared memory and edits it in place.
// Only tokens [0, nused] are ever read: token nused is the FREE sentinel
// with cum = the visible total, where an insert at the end lands; tokens
// past it are never touched.  cum is nondecreasing, so the op's token (the
// first with cum > p) is a count of cum <= p over [0, nused) in levels of
// 32 probes, one ballot each (two levels up to 1024 live tokens).  It never
// lands on a zero-length (TDEAD) token.  Token t becomes m tokens and the
// tail [t + 1, nused] moves right by m - 1 (0, 1 or 2) with cum + delta:
// the warp walks the destinations [t, nused + m - 1] in 32-token chunks
// from the top, each lane reading its source (or taking its new token)
// into registers, __syncwarp(), then writing (a chunk's writes lie above
// every read of the chunks below it).  The per-op outputs
// (del_rank, del_batch, origin) are uniform across the warp; lane j % 32
// keeps op j's in registers and every 32 ops the warp stores them
// coalesced.  No per-op index shifting: each insert j leaves exactly one
// TINS(j) or TDEAD(j) token in the final list (TDEAD exactly when a later
// delete of the batch killed it), so the extraction reads gap rank,
// tie-break rank and liveness off the final list and scatters them to op
// ta.  It is two warp passes over [0, nused): right to left, a suffix-min
// of the live RUN starts (the gap rank, written over cum), then left to
// right, a prefix count and the last group start of the instok tokens (the
// tie-break rank), as in ops/resolve.py extract_from_tokens.
// Shared memory per block: (kWarps * 2 * (T + 1) + 2 * B) * 4 bytes
// (22,560 at B = 256, T = 640); ops/resolve.py unit_smem_bytes mirrors it.
// The per-row form (crdt_resolve_unit_rows) takes one op stream a row,
// kind/pos int32[R, B]: each warp stages its row's ops beside its list,
// kWarps * (2 * (T + 1) + 2 * B) * 4 bytes a block (10,272 at B = 64,
// T = 256); ops/resolve.py unit_rows_smem_bytes mirrors it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_list.cuh"

namespace {

constexpr int kFree = 0;
constexpr int kRun = 1;
constexpr int kTins = 2;
constexpr int kTdead = 3;
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr int kOriginBatch = 1 << 24;
constexpr int kBig = 1 << 30;
constexpr int kWarps = 4;  // replicas per block
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// kRows == false: one op stream (kind/pos int32[B]) for every replica,
// staged once a block.  kRows == true: one op stream a row (kind/pos
// int32[R, B], JAX's vmap of resolve_batch over the fleet's rows); each
// warp stages its own row's ops beside its list, (2 * (T + 1) + 2 * B)
// ints a warp, and nothing syncs more than the warp.
template <bool kRows>
__global__ void __launch_bounds__(kWarps * 32)
resolve_unit_kernel(const int* __restrict__ kind, const int* __restrict__ pos,
                    const int* __restrict__ v0, int R, int B, int T,
                    int emit_origin, int* __restrict__ drank_o,
                    int* __restrict__ gvis_o, int* __restrict__ seq_o,
                    bool* __restrict__ alive_o, int* __restrict__ origin_o,
                    int* __restrict__ dbatch_o) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  const size_t rb = static_cast<size_t>(r) * B;
  int* skind;
  int* spos;
  int* tta;
  if constexpr (kRows) {
    if (r >= R) return;
    skind = smem + warp * (2 * (T + 1) + 2 * B);
    spos = skind + B;
    tta = spos + B;
    for (int i = lane; i < B; i += 32) {
      skind[i] = kind[rb + i];
      spos[i] = pos[rb + i];
    }
  } else {
    skind = smem;
    spos = smem + B;
    for (int i = threadIdx.x; i < B; i += kWarps * 32) {
      skind[i] = kind[i];
      spos[i] = pos[i];
    }
    __syncthreads();
    if (r >= R) return;
    tta = smem + 2 * B + warp * 2 * (T + 1);
  }
  int* cum = tta + T + 1;
  const int vr = v0[r];
  if (lane < 2) {  // RUN(0) of length v0, then the FREE sentinel
    tta[lane] = lane == 0 ? kRun : kFree;
    cum[lane] = vr;
  }
  __syncwarp();

  int total = vr;
  int nused = 1;
  int my_dr = -1, my_db = -1, my_org = -2;  // op (j & ~31) + lane's
  int k = skind[0], p0 = spos[0];
  for (int j = 0; j < B; ++j) {
    int kn = 0, pn = 0;  // the next op's fields, off the critical path
    if (j + 1 < B) {
      kn = skind[j + 1];
      pn = spos[j + 1];
    }
    const bool is_ins = k == kInsert;
    const int p = imin(imax(p0, 0), total);
    const bool is_del = k == kDelete && p < total;
    int dr = -1, db = -1, org = is_ins ? -1 : -2;
    if (is_ins || is_del) {  // PAD and deletes past the end change nothing
      const int t = warp_count_le(cum, nused, p, lane);
      const int c_t = cum[t];
      const int pre = t > 0 ? cum[t - 1] : 0;
      const int tta_t = tta[t];
      const int a = tta_t >> 2;
      const int tt = tta_t & 3;
      const int off = p - pre;
      const bool hit_run = tt == kRun;
      const bool split = is_ins && off > 0;
      if (is_del) {
        dr = hit_run ? a + off : -1;
        db = tt == kTins ? a : -1;  // a is the op index of a TINS token
      } else if (emit_origin && p > 0) {
        // the char at offset p - 1: always a token of positive length
        const int tp = warp_count_le(cum, nused, p - 1, lane);
        const int pre_tp = tp > 0 ? cum[tp - 1] : 0;
        const int tta_tp = tta[tp];
        org = (tta_tp & 3) == kRun ? (tta_tp >> 2) + (p - 1 - pre_tp)
                                   : kOriginBatch + (tta_tp >> 2);
      }
      // token t becomes m in {1, 2, 3} tokens:
      //   INSERT off == 0 : [ TINS(j), old_t ]
      //   INSERT off  > 0 : [ RUN(a, off), TINS(j), RUN(a + off, rest) ]
      //   DELETE on TINS  : [ TDEAD(a) ]
      //   DELETE on RUN   : [ RUN(a, off), RUN(a + off + 1, rest) ]
      const int m = is_ins ? (split ? 3 : 2) : (hit_run ? 2 : 1);
      const int sh = m - 1;
      const int delta = is_ins ? 1 : -1;
      const int j4 = j * 4 + kTins;
      const int n0 = is_ins ? (split ? a * 4 + kRun : j4)
                            : a * 4 + (hit_run ? kRun : kTdead);
      const int n0c = is_ins ? (split ? p : pre + 1) : (hit_run ? p : pre);
      const int n1 = is_ins ? (split ? j4 : tta_t) : (a + off + 1) * 4 + kRun;
      const int n1c = is_ins ? (split ? p : c_t) + 1 : c_t - 1;
      const int n2 = (a + off) * 4 + kRun;
      const int n2c = c_t + 1;
      // destinations [t, nused + sh] in 32-token chunks from the top: d
      // takes the new token d - t below t + m, else token d - sh with cum +
      // delta; each chunk reads, __syncwarp(), then writes (a chunk's
      // writes lie above every read of the chunks below it)
      for (int top = nused + sh; top >= t; top -= 32) {
        const int d = top - lane;
        const int q = d - t;
        int nt = q == 0 ? n0 : q == 1 ? n1 : n2;
        int nc = q == 0 ? n0c : q == 1 ? n1c : n2c;
        if (q >= m) {
          nt = tta[d - sh];
          nc = cum[d - sh] + delta;
        }
        __syncwarp();
        if (q >= 0) {
          tta[d] = nt;
          cum[d] = nc;
        }
      }
      __syncwarp();
      total += delta;
      nused += sh;
    }
    if (lane == (j & 31)) {
      my_dr = dr;
      my_db = db;
      my_org = org;
    }
    if ((j & 31) == 31 || j == B - 1) {
      const int jj = (j & ~31) + lane;
      if (jj <= j) {
        drank_o[rb + jj] = my_dr;
        dbatch_o[rb + jj] = my_db;
        origin_o[rb + jj] = my_org;
      }
    }
    k = kn;
    p0 = pn;
  }

  // ---- extraction over the final list [0, nused) ----
  // non-inserts own no token: their defaults
  for (int jj = lane; jj < B; jj += 32) {
    if (skind[jj] != kInsert) {
      gvis_o[rb + jj] = -1;
      seq_o[rb + jj] = 0;
      alive_o[rb + jj] = false;
    }
  }
  // gap rank, right to left: the first surviving pre-batch char to the
  // token's right (suffix-min of the live RUN starts after it, else v0);
  // written over cum, whose chunk below is read before it is overwritten
  const int nch = (nused + 31) >> 5;
  int carry = kBig;
  for (int c = nch - 1; c >= 0; --c) {
    const int i = c * 32 + lane;
    int rs = kBig;
    if (i < nused) {
      const int tv = tta[i];
      const int len = cum[i] - (i > 0 ? cum[i - 1] : 0);
      if ((tv & 3) == kRun && len > 0) rs = tv >> 2;
    }
    int s = rs;  // inclusive suffix-min over the chunk's lanes >= lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(kAll, s, d);
      if (lane + d < 32) s = imin(s, o);
    }
    int ex = __shfl_down_sync(kAll, s, 1);
    ex = imin(lane == 31 ? kBig : ex, carry);
    carry = imin(carry, __shfl_sync(kAll, s, 0));
    __syncwarp();
    if (i < nused) cum[i] = ex >= kBig ? vr : ex;
  }
  __syncwarp();
  // tie-break, left to right: rank among the instok tokens of one gap (they
  // are contiguous among instok tokens, and the gap rank is nondecreasing)
  const unsigned below = (1u << lane) - 1;
  int cnt = 0;        // instok tokens before this chunk
  int prev_g = -1;    // gap rank of the last of them
  int gbase = 0;      // count before the group start of the last of them
  for (int c = 0; c < nch; ++c) {
    const int i = c * 32 + lane;
    int tv = 0, g = 0;
    bool inst = false;
    if (i < nused) {
      tv = tta[i];
      g = cum[i];
      inst = (tv & 3) == kTins || (tv & 3) == kTdead;
    }
    const unsigned im = __ballot_sync(kAll, inst);
    const unsigned ib = im & below;
    const int cb = cnt + __popc(ib);  // instok tokens before i
    const int pg_l = __shfl_sync(kAll, g, ib ? 31 - __clz(ib) : lane);
    const int pg = ib ? pg_l : prev_g;
    const unsigned bm = __ballot_sync(kAll, inst && pg != g);
    const unsigned bl = bm & (below | (1u << lane));
    const int gb_l = __shfl_sync(kAll, cb, bl ? 31 - __clz(bl) : lane);
    const int gb = bl ? gb_l : gbase;
    if (inst) {
      const int op = tv >> 2;
      gvis_o[rb + op] = g;
      seq_o[rb + op] = cb - gb;
      alive_o[rb + op] = (tv & 3) == kTins;
    }
    const int last_i = im ? 31 - __clz(im) : 0;
    const int last_b = bm ? 31 - __clz(bm) : 0;
    const int g_last = __shfl_sync(kAll, g, last_i);
    const int cb_last = __shfl_sync(kAll, cb, last_b);
    if (im) prev_g = g_last;
    if (bm) gbase = cb_last;
    cnt += __popc(im);
  }
}

template <bool kRows>
int launch(const int* kind, const int* pos, const int* v0, int R, int B,
           int T, int emit_origin, int* del_rank, int* ins_gvis, int* ins_seq,
           bool* ins_alive, int* origin, int* del_batch, void* stream) {
  const int smem =
      (kRows ? kWarps * (2 * (T + 1) + 2 * B) : kWarps * 2 * (T + 1) + 2 * B) *
      static_cast<int>(sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      resolve_unit_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (R + kWarps - 1) / kWarps;
  resolve_unit_kernel<kRows><<<blocks, kWarps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      kind, pos, v0, R, B, T, emit_origin, del_rank, ins_gvis, ins_seq,
      ins_alive, origin, del_batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int crdt_resolve_unit(const int* kind, const int* pos,
                                 const int* v0, int R, int B, int T,
                                 int emit_origin, int* del_rank,
                                 int* ins_gvis, int* ins_seq, bool* ins_alive,
                                 int* origin, int* del_batch, void* stream) {
  return launch<false>(kind, pos, v0, R, B, T, emit_origin, del_rank,
                       ins_gvis, ins_seq, ins_alive, origin, del_batch,
                       stream);
}

// The per-row form: kind/pos int32[R, B], one op stream a row.
extern "C" int crdt_resolve_unit_rows(const int* kind, const int* pos,
                                      const int* v0, int R, int B, int T,
                                      int emit_origin, int* del_rank,
                                      int* ins_gvis, int* ins_seq,
                                      bool* ins_alive, int* origin,
                                      int* del_batch, void* stream) {
  return launch<true>(kind, pos, v0, R, B, T, emit_origin, del_rank,
                      ins_gvis, ins_seq, ins_alive, origin, del_batch,
                      stream);
}
