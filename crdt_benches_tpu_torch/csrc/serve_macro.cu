// K4: the serving fleet's macro apply for Hopper (sm_90a).
//
// Replaces the TPU kernel crdt_benches_tpu/ops/serve_fused.py
// serve_macro_fused (Pallas body _serve_round_kernel, grid (row blocks, K)
// with the document block resident in VMEM across the K rounds).  Each row
// of the PackedState stack (doc int32[R, C], C a multiple of 128) is a
// different document; K resolved rounds are applied to it in order, from
// the per-round operands serve_round_inputs derives: delete rank intervals
// dlo/dhi int32[K, R, B] (dlo < 0: no delete), token gap ranks gvis, live
// flags, live-length prefixes cumlen, gap slot ids ta, char offsets tch and
// lengths tlen int32[K, R, T] (a run's first slot id is ta + tch), and the round's starting length len_k, visible count
// nvis_k and new length newlen int32[K, R].  Per round, with cv the
// inclusive visible prefix of the round's doc below len_k:
//   lo/hi   = #(cv <= dlo), #(cv <= dhi) + 1     (delete interval, physical)
//   depth   = prefix of +1 at lo, -1 at hi; visible bits cleared where > 0
//   dest0   = (gvis >= nvis_k ? len_k : #(cv <= gvis)) + cumlen (live runs)
//   run     = prefix of +1 at dest0, -1 at dest0 + tlen > 0; cnt = prefix(run)
//   dcum    = prefix of (ta + tch - dest0) minus the previous live run's, at
//             dest0
//   out[d]  = 2 past newlen; ((d + dcum + 2) << 1) | 1 in a run;
//             else x[d - cnt[d]] (x = the delete-cleared doc)
//
// What bounds it on the H100: device-memory bytes.  The function must read
// each row's columns below its starting length and write every column once
// (4 B each) plus the K rounds' operands ((2B + 6T + 3) * 4 B per row and
// round); its integer work is a few operations per position below each
// round's new length.  In practice a launch is a chain of K dependent
// rounds, each two cluster barriers and a few block scans deep, with the
// column work of each round on the row's SMs.
//
// Design: one thread-block cluster of n blocks per document row (n and the
// slice width S, a multiple of 128, from ops/serve_fused.py
// serve_macro_geometry; n = 1 at small capacities).  Block `rank` owns the
// columns [rank * S, rank * S + S) of its row and keeps, for them, two doc
// slices that alternate between rounds, three boundary spreads, the
// visible bits (a word per 32 columns) and the visible count through each
// 128-column group's end; and, pushed there by every rank, all ranks'
// group counts and visible totals.  The slices live in the block's shared
// memory (kRes) or, for rows longer than the largest cluster's shared
// memory holds, in a device-memory scratch of the wrapper's: the same
// body, where a peer's slice is a pointer offset instead of a
// distributed-shared-memory (DSMEM) window.  The row is read from device
// memory once (columns below the starting length), all K rounds run on
// the slices, and every column is written once at the end.  Each thread
// owns a contiguous run of int4 groups of the columns below
// round_up(newlen, 128) (blocks past it only reach the barriers), so a
// phase takes one block scan.  A round:
//   (a) each block's visible bits below len_k, its group counts and total
//       (one scan), pushed into every rank's arrays; its spreads zeroed;
//       cluster barrier;
//   (b) every block answers every rank query of the row (2B delete bounds
//       and T token gaps, one thread each, the first chunks' operands
//       loaded during the round before): the owning rank from the totals,
//       the group from its local counts, the column from the group's four
//       bit words (one DSMEM int4).  A block adds only the spreads that
//       land in its own slice (shared atomics) and sums those left of it
//       into its carries; each live run's delta minus the previous live
//       run's comes from a block max-scan over the tokens (the last live
//       index);
//   (c) one block scan of four prefixes from the carries: delete depth,
//       run indicator P, Q = prefix of column * run spread, and delta.
//       Live runs are disjoint (the resolve emits them in document order),
//       so the holes through column d number (d + 1) P[d] - Q[d].  The
//       delete-cleared doc x overwrites the doc slice; each column's output
//       is coded into the delete spread: 2, the fill, or -1 - its source;
//       cluster barrier;
//   (d) the gather x[source] (the source is never right of the column but
//       may lie in any lower rank: read over DSMEM) into the other doc
//       slice, the next round's doc.
// Two cluster barriers a round suffice: what peers read in one phase is
// rewritten only after a later barrier (the x a peer gathers from in round
// k is overwritten by round k + 1's gather, after its first barrier).  A
// last barrier keeps every block's shared memory alive until its peers
// finished reading it.  The in-place update (doc_in == doc_out) is safe:
// each block reads only its own columns, and all of them before it writes.
// Threads: 128 a block at n = 1 (many rows, small slices), else 256 (three
// blocks an SM fit, so 16-block clusters of the largest class run in one
// wave).  The TPU's one-hot MXU spreads, chunked f32 cumsums, nbits roll
// cascade, lane padding and VMEM gate are not needed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace cg = cooperative_groups;

namespace {

// ints of a block's slices: two rotating doc slices, three spreads, the
// visible bits (one word per 32 columns) and the group counts (one per 128),
// rounded up to 4 ints so that every block's part of a device-memory
// scratch starts 16-byte aligned for its int4 accesses
__host__ __device__ __forceinline__ size_t slice_ints(int S) {
  return static_cast<size_t>(5) * S + (S >> 5) + (((S >> 7) + 3) & ~3);
}
constexpr int kMaxCluster = 16;

template <bool kRes>
__device__ __forceinline__ int ld(const int* p) {
  if constexpr (kRes) {
    return *p;
  } else {
    return __ldcg(p);  // peers' writes reach L2, not this SM's L1
  }
}

template <bool kRes>
__device__ __forceinline__ int4 ld4(const int* p) {
  if constexpr (kRes) {
    return *reinterpret_cast<const int4*>(p);
  } else {
    return __ldcg(reinterpret_cast<const int4*>(p));
  }
}

template <bool kRes>
__device__ __forceinline__ void st1(int* p, int v) {
  if constexpr (kRes) {
    *p = v;
  } else {
    __stcg(p, v);
  }
}

template <bool kRes>
__device__ __forceinline__ void st4(int* p, int a, int b, int c, int d) {
  if constexpr (kRes) {
    *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
  } else {
    __stcg(reinterpret_cast<int4*>(p), make_int4(a, b, c, d));
  }
}

// The position of set bit number `rest` (from 0) of the 128 bits
// m.x | m.y << 32 | m.z << 64 | m.w << 96; rest < their popcount.
__device__ __forceinline__ int nth_bit(int4 m, int rest) {
  unsigned v = static_cast<unsigned>(m.x);
  int pos = 0, c = __popc(v);
  if (rest >= c) { rest -= c; v = static_cast<unsigned>(m.y); pos = 32; }
  c = __popc(v);
  if (pos == 32 && rest >= c) {
    rest -= c; v = static_cast<unsigned>(m.z); pos = 64;
  }
  c = __popc(v);
  if (pos == 64 && rest >= c) {
    rest -= c; v = static_cast<unsigned>(m.w); pos = 96;
  }
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    c = __popc(v & ((1u << half) - 1));
    if (rest >= c) { rest -= c; v >>= half; pos += half; }
  }
  return pos;
}

// Exclusive max-scan of one value (>= -1) per thread over the block: returns
// the max over lower threads (-1 for none) and sets *total to the block's.
template <int kThreads>
__device__ __forceinline__ int block_excl_max(int v, int* total, int* ws) {
  constexpr int kWarps = kThreads / 32;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  int excl = __shfl_up_sync(kAll, incl, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? ws[lane] : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w = max(w, y);
    }
    __syncwarp();
    if (lane < kWarps) ws[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? ws[warp - 1] : -1;
  *total = ws[kWarps - 1];
  __syncthreads();  // ws is reused by the next scan
  return max(excl, before);
}

// Query chunks whose operands a thread loads a round ahead (384 queries at
// B = 64, T = 256).
template <int kThreads>
constexpr int kAhead = (384 + kThreads - 1) / kThreads;

template <int kThreads, bool kRes>
__global__ void __launch_bounds__(kThreads, kThreads >= 256 ? 3 : 8)
serve_macro_kernel(const int* doc_in,  // may alias doc_out (in place)
                   const int* __restrict__ dlo, const int* __restrict__ dhi,
                   const int* __restrict__ gvis, const int* __restrict__ live,
                   const int* __restrict__ cumlen,
                   const int* __restrict__ ta, const int* __restrict__ tch,
                   const int* __restrict__ tlen,
                   const int* __restrict__ len_k,
                   const int* __restrict__ nvis_k,
                   const int* __restrict__ newlen, int K, int R, int B, int T,
                   int C, int S, int* doc_out, int* scratch) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int ws[4][kWarps];
  __shared__ int s_delta[kThreads];          // one query chunk's deltas
  __shared__ int s_base[kMaxCluster + 1];    // ranks' visible-count bases
  __shared__ int s_carry[4];                 // depth, run, run*col, delta
  __shared__ int s_tots[kMaxCluster];        // every rank's visible total
  extern __shared__ int4 smem4[];

  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = blockIdx.x / n;
  const int tid = threadIdx.x;
  const int c0 = rank * S;
  const int w = min(S, C - c0);  // > 0: the wrapper leaves no rank empty
  const int G = S >> 7;          // 128-column groups a slice
  const size_t stride = slice_ints(S);
  int* mine = kRes ? reinterpret_cast<int*>(smem4)
                   : scratch + static_cast<size_t>(blockIdx.x) * stride;
  int* sdel = mine + 2 * S;  // delete spread, then the output code
  int* sind = mine + 3 * S;  // run spread
  int* sdd = mine + 4 * S;   // delta spread
  int* msk = mine + 5 * S;   // visible bits below len_k, 32 columns a word
  int* gend = msk + (S >> 5);  // visible count through each group's end
  // every rank's group counts, pushed here by each rank (after the slices
  // when resident)
  int* gval = reinterpret_cast<int*>(smem4) + (kRes ? stride : 0);
  // rank j's copy of a slice of `mine`
  auto peer = [&](int* p, int j) -> int* {
    if (j == rank) return p;
    if constexpr (kRes) {
      return cluster.map_shared_rank(p, j);
    } else {
      return p + (static_cast<ptrdiff_t>(j) - rank) * stride;
    }
  };
  // rank j's copy of a shared-memory array
  auto peer_smem = [&](int* p, int j) -> int* {
    return j == rank ? p : cluster.map_shared_rank(p, j);
  };
  auto sync_row = [&]() {
    if (n > 1) cluster.sync(); else __syncthreads();
  };
  // this thread's int4 groups [g0, g1) of the first `act` columns
  auto groups = [&](int act, int& g0, int& g1) {
    const int g = act >> 2;
    const int m = (g + kThreads - 1) / kThreads;
    g0 = min(tid * m, g);
    g1 = min(g0 + m, g);
  };
  const size_t row = static_cast<size_t>(r) * C + c0;
  const int nq = 2 * B + T;  // rank queries a round: delete bounds, tokens

  // a query's operands: query u is a delete bound (2j: dlo, 2j + 1: dhi,
  // with dlo for its sign) or token u - 2B; the first kAhead chunks' are
  // loaded a round ahead
  constexpr int kPre = kAhead<kThreads>;
  int op[kPre][5];
  auto load_ops = [&](int k, int u, int (&o)[5]) {
    const size_t kr = static_cast<size_t>(k) * R + r;
    if (u < 2 * B) {
      o[0] = dlo[kr * B + (u >> 1)];
      o[1] = (u & 1) ? dhi[kr * B + (u >> 1)] : o[0];
    } else if (u < nq) {
      const size_t t = kr * T + (u - 2 * B);
      o[0] = live[t];
      o[1] = gvis[t];
      o[2] = cumlen[t];
      o[3] = ta[t] + tch[t];  // the run's first slot id
      o[4] = tlen[t];
    }
  };
  auto load_ahead = [&](int k) {
#pragma unroll
    for (int c = 0; c < kPre; ++c) load_ops(k, c * kThreads + tid, op[c]);
  };
  load_ahead(0);
  int L = len_k[r], nvk = nvis_k[r], nlen = newlen[r];

  // ---- the row's columns below the starting length, read once ----
  {
    int g0, g1;
    groups(max(0, min(w, ((L + 127) & ~127) - c0)), g0, g1);
    for (int g = g0; g < g1; ++g) {
      const int4 v = *reinterpret_cast<const int4*>(doc_in + row + 4 * g);
      st4<kRes>(mine + 4 * g, v.x, v.y, v.z, v.w);
    }
  }
  __syncthreads();  // a thread's columns change with each round's extent

  for (int k = 0; k < K; ++k) {
    const int E = min(C, (nlen + 127) & ~127);
    const int act = max(0, min(w, E - c0));  // multiple of 128
    int* doc = mine + (k & 1) * S;  // x in place, gathered from in (d)
    int* out = mine + ((k + 1) & 1) * S;
    int g0, g1;
    groups(act, g0, g1);

    // ---- (a) visible bits and group counts, zeroed spreads, total ----
    {
      int sv = 0;
      for (int g = g0; g < g1; ++g) {
        const int4 d = ld4<kRes>(doc + 4 * g);
        const int c = c0 + 4 * g;
        sv += (d.x & (c < L)) + (d.y & (c + 1 < L)) + (d.z & (c + 2 < L))
              + (d.w & (c + 3 < L));
        if ((g & 7) == 0) st1<kRes>(msk + (g >> 3), 0);
        st4<kRes>(sdel + 4 * g, 0, 0, 0, 0);
        st4<kRes>(sind + 4 * g, 0, 0, 0, 0);
        st4<kRes>(sdd + 4 * g, 0, 0, 0, 0);
      }
      int s[1] = {sv}, tot[1];
      block_excl_scan<kThreads>(s, tot, ws);  // its barriers order msk
      int v = s[0];
      for (int g = g0; g < g1; ++g) {
        const int4 d = ld4<kRes>(doc + 4 * g);
        const int c = c0 + 4 * g;
        const int bits = (d.x & (c < L)) | (d.y & (c + 1 < L)) << 1
                         | (d.z & (c + 2 < L)) << 2
                         | (d.w & (c + 3 < L)) << 3;
        v += __popc(bits);
        if ((g & 31) == 31) st1<kRes>(gend + (g >> 5), v);
        if (bits) atomicOr(msk + (g >> 3), bits << (4 * (g & 7)));
      }
      __syncthreads();
      // push the total and the group counts into every rank's arrays (a
      // group past this round's columns counts the total)
      if (tid < n) peer_smem(s_tots, tid)[rank] = tot[0];
      for (int u = tid; u < n * G; u += kThreads) {
        const int j = u / G, g = u - j * G;
        peer_smem(gval, j)[rank * G + g] =
            128 * g + 128 <= act ? ld<kRes>(gend + g) : tot[0];
      }
    }
    sync_row();  // (1): every rank's bits, group counts and total

    // the next round's scalars, loaded while this one runs
    int L1 = L, nvk1 = nvk, nlen1 = nlen;
    if (k + 1 < K) {
      const size_t kr1 = static_cast<size_t>(k + 1) * R + r;
      L1 = len_k[kr1];
      nvk1 = nvis_k[kr1];
      nlen1 = newlen[kr1];
    }
    if (act > 0) {
      // ---- (b) rank queries, spreads that land in this slice ----
      if (tid < 32) {  // warp 0: the ranks' bases
        int v = tid < n ? s_tots[tid] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += y;
        }
        if (tid < n) s_base[tid + 1] = v;
        if (tid == 0) s_base[0] = 0;
        if (tid < 4) s_carry[tid] = 0;
      }
      __syncthreads();
      // #(cv <= q) over the row: the owning rank from the bases, its group
      // from the local counts, the column from the group's four bit words
      // (one remote int4).  cv is nvis_k from len_k on, so a rank at or
      // past the total maps to len_k (only columns >= len_k differ).
      auto rank_pos = [&](int q) -> int {
        if (q < 0) return 0;
        if (q >= s_base[n]) return L;
        int j = 0, top = n - 1;  // the last rank with base <= q owns q
        while (j < top) {
          const int mid = (j + top + 1) >> 1;
          if (s_base[mid] <= q) j = mid; else top = mid - 1;
        }
        q -= s_base[j];
        const int* gv = gval + j * G;
        int lo = 0, hi = G - 1;  // the first group counting past q
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (gv[mid] <= q) lo = mid + 1; else hi = mid;
        }
        const int4 m4 = ld4<kRes>(peer(msk, j) + 4 * lo);
        return j * S + 128 * lo
               + nth_bit(m4, q - (lo > 0 ? gv[lo - 1] : 0));
      };
      int car[4] = {0, 0, 0, 0};  // spreads left of this slice
      // positions at or past the round's extent only touch columns whose
      // output is 2: dropped
      auto spread = [&](int* arr, int f, int p, int v) {
        if (p < c0) {
          car[f] += v;
          if (f == 1) car[2] += p * v;
        } else if (p < c0 + act) {
          atomicAdd(arr + (p - c0), v);
        }
      };
      int last_delta = 0;  // the last live run's delta in earlier chunks
      auto chunk = [&](int u0, const int (&o)[5]) {
        const int u = u0 + tid;
        bool lv = false;
        int dest = 0, delta = 0;
        if (u < 2 * B) {
          if (o[0] >= 0) {  // dlo < 0: no delete
            const int hi = u & 1;
            spread(sdel, 0, rank_pos(o[1]) + hi, hi ? -1 : 1);
          }
        } else if (u < nq && o[0] != 0) {
          lv = true;
          dest = (o[1] >= nvk ? L : rank_pos(o[1])) + o[2];
          delta = o[3] - dest;
        }
        if (!__syncthreads_or(lv)) return;  // no live run in this chunk
        s_delta[tid] = delta;
        int last;
        const int prev = block_excl_max<kThreads>(lv ? tid : -1, &last,
                                                  ws[0]);
        if (lv) {
          spread(sind, 1, dest, 1);
          spread(sind, 1, dest + o[4], -1);
          spread(sdd, 3, dest,
                 delta - (prev >= 0 ? s_delta[prev] : last_delta));
        }
        if (last >= 0) last_delta = s_delta[last];
        __syncthreads();  // s_delta is rewritten by the next chunk
      };
#pragma unroll
      for (int c = 0; c < kPre; ++c) {
        if (c * kThreads < nq) chunk(c * kThreads, op[c]);
      }
      for (int u0 = kPre * kThreads; u0 < nq; u0 += kThreads) {
        int o[5];
        load_ops(k, u0 + tid, o);
        chunk(u0, o);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (car[j]) atomicAdd(&s_carry[j], car[j]);
      }
      __syncthreads();

      // ---- (c) depth, runs, holes, deltas; x over the doc slice ----
      // Live runs are disjoint (the resolve emits them in document order),
      // so the run indicator is the prefix P of the run spread and the
      // hole count through column d is (d + 1) P[d] - Q[d], Q the prefix
      // of col * spread: one scan of four prefixes.
      int sum[4] = {0, 0, 0, 0};
      for (int g = g0; g < g1; ++g) {
        const int4 a = ld4<kRes>(sdel + 4 * g);
        const int4 b = ld4<kRes>(sind + 4 * g);
        const int4 e = ld4<kRes>(sdd + 4 * g);
        const int c = c0 + 4 * g;
        sum[0] += a.x + a.y + a.z + a.w;
        sum[1] += b.x + b.y + b.z + b.w;
        sum[2] += c * b.x + (c + 1) * b.y + (c + 2) * b.z + (c + 3) * b.w;
        sum[3] += e.x + e.y + e.z + e.w;
      }
      int tot[4];
      block_excl_scan<kThreads>(sum, tot, ws);
      int dep = s_carry[0] + sum[0], p1 = s_carry[1] + sum[1];
      int q1 = s_carry[2] + sum[2], dd = s_carry[3] + sum[3];
      for (int g = g0; g < g1; ++g) {
        const int4 a = ld4<kRes>(sdel + 4 * g);
        const int4 b = ld4<kRes>(sind + 4 * g);
        const int4 e = ld4<kRes>(sdd + 4 * g);
        const int4 d = ld4<kRes>(doc + 4 * g);
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int bv[4] = {b.x, b.y, b.z, b.w};
        const int ev[4] = {e.x, e.y, e.z, e.w};
        const int dv[4] = {d.x, d.y, d.z, d.w};
        int xv[4], code[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = c0 + 4 * g + i;
          dep += av[i];
          p1 += bv[i];
          q1 += col * bv[i];
          dd += ev[i];
          xv[i] = dv[i] - ((dv[i] & 1) & (dep > 0 ? 1 : 0));
          if (col >= nlen) {
            code[i] = 2;
          } else if (p1 > 0) {
            code[i] = ((col + dd + 2) << 1) | 1;
          } else {  // the source: never right of col, below len_k
            code[i] = -1 - max(col - ((col + 1) * p1 - q1), 0);
          }
        }
        st4<kRes>(doc + 4 * g, xv[0], xv[1], xv[2], xv[3]);
        st4<kRes>(sdel + 4 * g, code[0], code[1], code[2], code[3]);
      }
    }
    sync_row();  // (2): every x slice is published

    // ---- (d) the expansion: fill, 2, or x at the source over DSMEM ----
    // Two int4 groups a step, all eight sources loaded before any store.
    for (int g = g0; g < g1; g += 2) {
      const int ng = min(2, g1 - g);
      int ov[8];
      const int* src[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int4 c4 = h < ng ? ld4<kRes>(sdel + 4 * (g + h))
                               : make_int4(2, 2, 2, 2);
        ov[4 * h] = c4.x;
        ov[4 * h + 1] = c4.y;
        ov[4 * h + 2] = c4.z;
        ov[4 * h + 3] = c4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = -1 - ov[i];
        src[i] = ov[i] >= 0 ? nullptr
                 : s >= c0  ? doc + (s - c0)
                            : peer(doc, s / S) + (s % S);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (src[i] != nullptr) ov[i] = ld<kRes>(src[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h < ng) {
          st4<kRes>(out + 4 * (g + h), ov[4 * h], ov[4 * h + 1],
                    ov[4 * h + 2], ov[4 * h + 3]);
        }
      }
    }
    if (k + 1 < K) load_ahead(k + 1);
    L = L1;
    nvk = nvk1;
    nlen = nlen1;
    __syncthreads();  // the next round's threads own other columns
  }

  // ---- every column written once: the last round's output, 2 past it ----
  {
    const int* fin = mine + (K & 1) * S;
    int g0, g1;
    groups(w, g0, g1);
    for (int g = g0; g < g1; ++g) {
      const int d = c0 + 4 * g;
      int4 v = make_int4(2, 2, 2, 2);
      if (d < nlen) {
        v = ld4<kRes>(fin + 4 * g);
        if (d + 1 >= nlen) v.y = 2;
        if (d + 2 >= nlen) v.z = 2;
        if (d + 3 >= nlen) v.w = 2;
      }
      *reinterpret_cast<int4*>(doc_out + row + 4 * g) = v;
    }
  }
  if (n > 1) cluster.sync();  // peers may still read this block's slices
}

template <int kThreads, bool kRes>
cudaError_t launch(int n, int S, size_t smem, cudaStream_t stream,
                   const int* doc_in, const int* dlo, const int* dhi,
                   const int* gvis, const int* live, const int* cumlen,
                   const int* ta, const int* tch, const int* tlen,
                   const int* len_k, const int* nvis_k, const int* newlen,
                   int K, int R, int B, int T, int C, int* doc_out,
                   int* scratch, int* active_clusters) {
  auto kern = serve_macro_kernel<kThreads, kRes>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (n > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * n, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = n > 1 ? 1 : 0;
  if (active_clusters != nullptr) {
    return cudaOccupancyMaxActiveClusters(active_clusters, kern, &cfg);
  }
  return cudaLaunchKernelEx(&cfg, kern, doc_in, dlo, dhi, gvis, live, cumlen,
                            ta, tch, tlen, len_k, nvis_k, newlen, K, R, B, T,
                            C, S, doc_out, scratch);
}

cudaError_t dispatch(int n, int S, int resident, cudaStream_t stream,
                     const int* doc_in, const int* dlo, const int* dhi,
                     const int* gvis, const int* live, const int* cumlen,
                     const int* ta, const int* tch, const int* tlen,
                     const int* len_k, const int* nvis_k, const int* newlen,
                     int K, int R, int B, int T, int C, int* doc_out,
                     int* scratch, int* active_clusters) {
  if (n < 1 || n > kMaxCluster || S < 128 || S % 128) {
    return cudaErrorInvalidValue;
  }
  // the slices when resident, and every rank's group counts
  const size_t smem =
      ((resident ? slice_ints(S) : 0) + static_cast<size_t>(n) * (S >> 7)) * 4;
#define CRDT_SERVE_LAUNCH(THREADS, RES)                                      \
  launch<THREADS, RES>(n, S, smem, stream, doc_in, dlo, dhi, gvis, live,   \
                       cumlen, ta, tch, tlen, len_k, nvis_k, newlen, K, R,  \
                       B, T, C, doc_out, scratch, active_clusters)
  if (n == 1) {
    return resident ? CRDT_SERVE_LAUNCH(128, true)
                    : CRDT_SERVE_LAUNCH(128, false);
  }
  return resident ? CRDT_SERVE_LAUNCH(256, true)
                  : CRDT_SERVE_LAUNCH(256, false);
#undef CRDT_SERVE_LAUNCH
}

}  // namespace

// One launch: n blocks a row (a cluster when n > 1) of slice width S; the
// slices in shared memory when resident, else in scratch (int32[R, n,
// slice_ints(S)]).
extern "C" int crdt_serve_macro(const int* doc_in, const int* dlo,
                                const int* dhi, const int* gvis,
                                const int* live, const int* cumlen,
                                const int* ta, const int* tch,
                                const int* tlen,
                                const int* len_k, const int* nvis_k,
                                const int* newlen, int K, int R, int B, int T,
                                int C, int n, int S, int resident,
                                int* doc_out, int* scratch, void* stream) {
  cudaError_t e = dispatch(n, S, resident, static_cast<cudaStream_t>(stream),
                           doc_in, dlo, dhi, gvis, live, cumlen, ta, tch,
                           tlen, len_k, nvis_k, newlen, K, R, B, T, C,
                           doc_out, scratch, nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of that geometry the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot schedule one).
extern "C" int crdt_serve_macro_clusters(int R, int n, int S, int resident,
                                         int* count) {
  *count = 0;
  cudaError_t e = dispatch(n, S, resident, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, 1, R, 1, 1,
                           n * S, nullptr, nullptr, count);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear a sticky-free error such as too many blocks
  }
  return static_cast<int>(e);
}

// The current device's SM count and the shared memory one block may opt in
// to (the limits serve_macro_geometry sizes the clusters and slices by).
extern "C" int crdt_serve_macro_device(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return static_cast<int>(e);
}
