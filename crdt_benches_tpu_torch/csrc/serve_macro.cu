// K4: the serving fleet's macro apply for Hopper (sm_90a).
//
// Replaces the TPU kernel crdt_benches_tpu/ops/serve_fused.py
// serve_macro_fused (Pallas body _serve_round_kernel, grid (row blocks, K)
// with the document block resident in VMEM across the K rounds).  Each row
// of the PackedState stack (doc int32[R, C], C a multiple of 128) is a
// different document; K resolved rounds are applied to it in order, from
// the per-round operands serve_round_inputs derives: delete rank intervals
// dlo/dhi int32[K, R, B] (dlo < 0: no delete), token gap ranks gvis, live
// flags, live-length prefixes cumlen, first slot ids atch and lengths tlen
// int32[K, R, T], and the round's starting length len_k, visible count
// nvis_k and new length newlen int32[K, R].  Per round, with cv the
// inclusive visible prefix of the round's doc below len_k:
//   lo/hi   = #(cv <= dlo), #(cv <= dhi) + 1     (delete interval, physical)
//   depth   = prefix of +1 at lo, -1 at hi; visible bits cleared where > 0
//   dest0   = (gvis >= nvis_k ? len_k : #(cv <= gvis)) + cumlen (live runs)
//   run     = prefix of +1 at dest0, -1 at dest0 + tlen > 0; cnt = prefix(run)
//   dcum    = prefix of (atch - dest0) minus the previous live run's, at dest0
//   out[d]  = 2 past newlen; ((d + dcum + 2) << 1) | 1 in a run;
//             else x[d - cnt[d]] (x = the delete-cleared doc)
//
// What bounds it on the H100: device-memory bytes.  The function must read
// and write the doc once per launch (8 B/pos) plus the K rounds' operands
// ((2B + 5T + 3) * 4 B per row and round); its integer work is a few
// operations per position and round.
//
// Design: one block per document row, the K rounds in a loop inside the
// launch (the block owns its row, so no grid-wide sync).  A round makes two
// passes over the row in chunks of kThreads * 4 positions with int4 loads
// and block scans carried across chunks, as range_apply.cu does: the first
// writes cv to a scratch row and zeroes three scratch spread rows; then the
// rank queries are binary searches of cv (one thread each) and the
// boundary spreads are global atomics into the scratch rows; the second
// pass takes the delete depth, hole and delta prefixes, writes the
// delete-cleared doc to a scratch row and forms the expansion as one
// gather from it (the source d - cnt[d] is never right of d, and every
// chunk's scratch writes precede its gathers by a block barrier).  The
// TPU's one-hot MXU spreads, chunked f32 cumsums, nbits roll cascade, lane
// padding and VMEM gate are not needed.  The doc and the spread rows make
// round trips through device memory every round (mostly L2 hits at small
// C); keeping a row resident in shared memory is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kItems = 4;
constexpr int kScratchRows = 5;  // cv, x, delete, hole and delta spreads

__device__ __forceinline__ int count_le(const int* __restrict__ cv, int C,
                                        int q) {
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cv[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
serve_macro_kernel(const int* doc_in,  // may alias doc_out (in place)
                   const int* __restrict__ dlo, const int* __restrict__ dhi,
                   const int* __restrict__ gvis, const int* __restrict__ live,
                   const int* __restrict__ cumlen,
                   const int* __restrict__ atch, const int* __restrict__ tlen,
                   const int* __restrict__ len_k,
                   const int* __restrict__ nvis_k,
                   const int* __restrict__ newlen, int K, int R, int B, int T,
                   int C, int* doc_out, int* scratch) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunk = kThreads * kItems;
  __shared__ int ws[3][kWarps];
  extern __shared__ int tok[];  // dest0 (-1: not live) and delta per token
  int* s_dest = tok;
  int* s_delta = tok + T;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(r) * C;
  int* cv = scratch + static_cast<size_t>(r) * kScratchRows * C;
  int* xs = cv + C;
  int* sdel = xs + C;
  int* sind = sdel + C;
  int* sdd = sind + C;
  const int* src = doc_in + row;  // later rounds read what this block wrote
  int* dst = doc_out + row;
  const int4 zero4 = make_int4(0, 0, 0, 0);

  for (int k = 0; k < K; ++k) {
    const size_t kr = static_cast<size_t>(k) * R + r;
    const int lenk = len_k[kr];
    const int nvk = nvis_k[kr];
    const int nlen = newlen[kr];

    // ---- pass 1: cv (visible prefix below len_k), zeroed spreads ----
    int c_vis = 0;
    for (int base = 0; base < C; base += kChunk) {
      const int q = base + tid * kItems;
      const bool ok = q < C;  // C % 128 == 0: whole warps are in or out
      int4 d4 = make_int4(2, 2, 2, 2);
      if (ok) d4 = *reinterpret_cast<const int4*>(src + q);
      const int dv[kItems] = {d4.x, d4.y, d4.z, d4.w};
      int lv[kItems];
      int sv = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        sv += (dv[i] & 1) & (q + i < lenk ? 1 : 0);
        lv[i] = sv;
      }
      int s[1] = {sv}, tot[1];
      block_excl_scan<kThreads>(s, tot, ws);
      if (ok) {
        const int b0 = c_vis + s[0];
        *reinterpret_cast<int4*>(cv + q) =
            make_int4(b0 + lv[0], b0 + lv[1], b0 + lv[2], b0 + lv[3]);
        *reinterpret_cast<int4*>(sdel + q) = zero4;
        *reinterpret_cast<int4*>(sind + q) = zero4;
        *reinterpret_cast<int4*>(sdd + q) = zero4;
      }
      c_vis += tot[0];
    }
    __syncthreads();

    // ---- rank queries and boundary spreads ----
    const int* dlo_k = dlo + kr * B;
    const int* dhi_k = dhi + kr * B;
    for (int j = tid; j < B; j += kThreads) {
      const int lq = dlo_k[j];
      if (lq >= 0) {
        const int lp = count_le(cv, C, lq);
        const int hp = count_le(cv, C, dhi_k[j]) + 1;
        if (lp < C) atomicAdd(sdel + lp, 1);
        if (hp < C) atomicAdd(sdel + hp, -1);
      }
    }
    const size_t kt = kr * T;
    for (int t = tid; t < T; t += kThreads) {
      int dest = -1, delta = 0;
      if (live[kt + t]) {
        const int g = gvis[kt + t];
        const int gp = g >= nvk ? lenk : count_le(cv, C, g);
        dest = gp + cumlen[kt + t];
        const int stop = dest + tlen[kt + t];
        if (dest < C) atomicAdd(sind + dest, 1);
        if (stop < C) atomicAdd(sind + stop, -1);
        delta = atch[kt + t] - dest;
      }
      s_dest[t] = dest;
      s_delta[t] = delta;
    }
    __syncthreads();
    // per live run: its slot delta minus the previous live run's
    for (int t = tid; t < T; t += kThreads) {
      const int dest = s_dest[t];
      if (dest >= 0 && dest < C) {
        int prev = 0;
        for (int u = t - 1; u >= 0; --u) {
          if (s_dest[u] >= 0) {
            prev = s_delta[u];
            break;
          }
        }
        atomicAdd(sdd + dest, s_delta[t] - prev);
      }
    }
    __syncthreads();

    // ---- pass 2: delete depth, holes, deltas, expansion, fill ----
    int c_depth = 0, c_ind = 0, c_dd = 0, c_cnt = 0;
    for (int base = 0; base < C; base += kChunk) {
      const int q = base + tid * kItems;
      const bool ok = q < C;
      int4 dc = make_int4(2, 2, 2, 2), dp = zero4, id = zero4, d4 = zero4;
      if (ok) {
        dc = *reinterpret_cast<const int4*>(src + q);
        dp = *reinterpret_cast<const int4*>(sdel + q);
        id = *reinterpret_cast<const int4*>(sind + q);
        d4 = *reinterpret_cast<const int4*>(sdd + q);
      }
      const int dv[kItems] = {dc.x, dc.y, dc.z, dc.w};
      const int pv[kItems] = {dp.x, dp.y, dp.z, dp.w};
      const int iv[kItems] = {id.x, id.y, id.z, id.w};
      const int ev[kItems] = {d4.x, d4.y, d4.z, d4.w};
      int ldep[kItems], lind[kItems], ldd[kItems];
      int sdep = 0, sid = 0, sde = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        sdep += pv[i];
        sid += iv[i];
        sde += ev[i];
        ldep[i] = sdep;
        lind[i] = sid;
        ldd[i] = sde;
      }
      int s1[3] = {sdep, sid, sde}, t1[3];
      block_excl_scan<kThreads>(s1, t1, ws);
      int xv[kItems], run[kItems], dcum[kItems];
      int srun = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int depth = c_depth + s1[0] + ldep[i];
        xv[i] = dv[i] - ((dv[i] & 1) & (depth > 0 ? 1 : 0));
        run[i] = (c_ind + s1[1] + lind[i]) > 0 ? 1 : 0;
        dcum[i] = c_dd + s1[2] + ldd[i];
        srun += run[i];
      }
      if (ok) {
        *reinterpret_cast<int4*>(xs + q) =
            make_int4(xv[0], xv[1], xv[2], xv[3]);
      }
      int s2[1] = {srun}, t2[1];
      block_excl_scan<kThreads>(s2, t2, ws);  // its barriers publish xs
      int ov[kItems];
      int cnt = c_cnt + s2[0];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int d = q + i;
        cnt += run[i];
        if (d >= nlen) {
          ov[i] = 2;
        } else if (run[i]) {
          ov[i] = ((d + dcum[i] + 2) << 1) | 1;
        } else {
          const int s = d - cnt;  // >= 0 at every non-hole position
          ov[i] = xs[s > 0 ? s : 0];
        }
      }
      if (ok) {
        *reinterpret_cast<int4*>(dst + q) =
            make_int4(ov[0], ov[1], ov[2], ov[3]);
      }
      c_depth += t1[0];
      c_ind += t1[1];
      c_dd += t1[2];
      c_cnt += t2[0];
    }
    __syncthreads();  // the next round reads this round's doc and spreads
    src = dst;
  }
}

}  // namespace

extern "C" int crdt_serve_macro(const int* doc_in, const int* dlo,
                                const int* dhi, const int* gvis,
                                const int* live, const int* cumlen,
                                const int* atch, const int* tlen,
                                const int* len_k, const int* nvis_k,
                                const int* newlen, int K, int R, int B, int T,
                                int C, int* doc_out, int* scratch,
                                void* stream) {
  const int smem = 2 * T * static_cast<int>(sizeof(int));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 1024) {
    serve_macro_kernel<128><<<R, 128, smem, s>>>(
        doc_in, dlo, dhi, gvis, live, cumlen, atch, tlen, len_k, nvis_k,
        newlen, K, R, B, T, C, doc_out, scratch);
  } else {
    serve_macro_kernel<512><<<R, 512, smem, s>>>(
        doc_in, dlo, dhi, gvis, live, cumlen, atch, tlen, len_k, nvis_k,
        newlen, K, R, B, T, C, doc_out, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}
