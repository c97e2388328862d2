// K2: fused range apply for Hopper (sm_90a), one block per replica row.
//
// Replaces the TPU kernel crdt_benches_tpu/ops/apply_range_fused.py
// range_fused (Pallas body _range_fused_kernel).  Its long-document twin
// range_fused_blocked has its own kernel, K3 (range_apply_blocked.cu, the
// same function with each row split across blocks), which
// ops/apply_range_fused.py range_apply_dispatch takes wherever the rows
// alone cannot fill the card.  Per replica row of C positions
// (C a multiple of 128), from doc/delpk/ind_d/dd int32[R, C] and
// new_len int32[R]:
//   depth[d] = prefix of (delpk & (2^dsh - 1)) - (delpk >> dsh)
//   x[d]     = doc[d] with its vis bit cleared where depth[d] > 0
//   run[d]   = prefix(ind_d)[d] > 0;  cnt[d] = prefix(run)[d]
//   out[d]   = 2                                  if d >= new_len
//            = ((d + prefix(dd)[d] + 2) << 1) | 1  if run[d]
//            = x[d - cnt[d]]                       otherwise
// plus the next batch's rank structure: cv_intile (inclusive vis cumsum
// within each 128-position tile, int16) and vis_tile (tile totals).
//
// What bounds it on the H100: device-memory bytes.  It must read 16 bytes
// and write 6 (+4/128) per position — 22 B/pos, ~4.1 GB a launch at
// R = 1024, C = 183,296 — and does a few integer operations per byte.
//
// Design: one block per replica row walks the row in chunks of 2048
// positions (512 threads x 4 consecutive positions, int4 loads), carrying
// the running prefixes (depth, ind, dd, cnt) across chunks.  A chunk does
// two block-wide scans (depth/ind/dd together, then the run count).  The
// TPU kernel's log-shift roll cascade becomes ONE gather from the
// delete-cleared doc x at the source position d - cnt[d], which is never
// to the right of d: each chunk writes x to a scratch row first, and after
// the block barrier the gather reads only positions already written by
// this block.  Each warp covers exactly one 128-position tile, so
// cv_intile and vis_tile are a warp scan.  Scratch adds 8 B/pos of traffic
// (mostly L2 hits) beyond the 22 B/pos the function needs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
range_apply_kernel(const int* __restrict__ doc, const int* __restrict__ delpk,
                   const int* __restrict__ ind, const int* __restrict__ dd,
                   const int* __restrict__ new_len, int C, int dsh,
                   int* __restrict__ out, short* __restrict__ cv,
                   int* __restrict__ vis_tile, int* scratch) {
  __shared__ int ws[3][kWarps];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row = static_cast<size_t>(r) * C;
  const int nlen = new_len[r];
  const int dmask = (1 << dsh) - 1;
  int c_depth = 0, c_ind = 0, c_dd = 0, c_cnt = 0;  // carries across chunks

  for (int base = 0; base < C; base += kChunk) {
    const int q = base + tid * kItems;  // first of this thread's positions
    const bool ok = q < C;  // C % 128 == 0: whole warps are in or out
    int4 dc = make_int4(2, 2, 2, 2), dp = make_int4(0, 0, 0, 0);
    int4 id = dp, d4 = dp;
    if (ok) {
      dc = *reinterpret_cast<const int4*>(doc + row + q);
      dp = *reinterpret_cast<const int4*>(delpk + row + q);
      id = *reinterpret_cast<const int4*>(ind + row + q);
      d4 = *reinterpret_cast<const int4*>(dd + row + q);
    }
    const int dv[kItems] = {dc.x, dc.y, dc.z, dc.w};
    const int pv[kItems] = {dp.x, dp.y, dp.z, dp.w};
    const int iv[kItems] = {id.x, id.y, id.z, id.w};
    const int ev[kItems] = {d4.x, d4.y, d4.z, d4.w};

    // local inclusive prefixes of the delete depth, run boundaries, dd
    int ldep[kItems], lind[kItems], ldd[kItems];
    int sdep = 0, sind = 0, sdd = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      sdep += (pv[k] & dmask) - (pv[k] >> dsh);
      sind += iv[k];
      sdd += ev[k];
      ldep[k] = sdep;
      lind[k] = sind;
      ldd[k] = sdd;
    }
    int s1[3] = {sdep, sind, sdd}, t1[3];
    block_excl_scan<kThreads>(s1, t1, ws);

    int xv[kItems], run[kItems], dcum[kItems];
    int srun = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int depth = c_depth + s1[0] + ldep[k];
      xv[k] = dv[k] - ((dv[k] & 1) & (depth > 0 ? 1 : 0));
      run[k] = (c_ind + s1[1] + lind[k]) > 0 ? 1 : 0;
      dcum[k] = c_dd + s1[2] + ldd[k];
      srun += run[k];
    }
    if (ok) {
      *reinterpret_cast<int4*>(scratch + row + q) =
          make_int4(xv[0], xv[1], xv[2], xv[3]);
    }
    int s2[1] = {srun}, t2[1];
    block_excl_scan<kThreads>(s2, t2, ws);  // its barriers publish the scratch row

    int ov[kItems];
    int cnt = c_cnt + s2[0];
    int vsum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int d = q + k;
      cnt += run[k];
      int o;
      if (d >= nlen) {
        o = 2;
      } else if (run[k]) {
        o = ((d + dcum[k] + 2) << 1) | 1;
      } else {
        const int s = d - cnt;  // >= 0 at every non-hole position
        o = scratch[row + (s > 0 ? s : 0)];
      }
      ov[k] = o;
      vsum += o & 1;
    }
    // cv_intile / vis_tile: this warp's 128 positions are one tile
    int vincl = vsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, vincl, o);
      if (lane >= o) vincl += y;
    }
    if (ok) {
      *reinterpret_cast<int4*>(out + row + q) =
          make_int4(ov[0], ov[1], ov[2], ov[3]);
      int c = vincl - vsum;
      short cs[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        c += ov[k] & 1;
        cs[k] = static_cast<short>(c);
      }
      *reinterpret_cast<short4*>(cv + row + q) =
          make_short4(cs[0], cs[1], cs[2], cs[3]);
      if (lane == 31) {
        vis_tile[static_cast<size_t>(r) * (C / 128) + q / 128] = vincl;
      }
    }
    c_depth += t1[0];
    c_ind += t1[1];
    c_dd += t1[2];
    c_cnt += t2[0];
  }
}

}  // namespace

extern "C" int crdt_range_apply(const int* doc, const int* delpk,
                                const int* ind, const int* dd,
                                const int* new_len, int R, int C, int dsh,
                                int* out, short* cv, int* vis_tile,
                                int* scratch, void* stream) {
  range_apply_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      doc, delpk, ind, dd, new_len, C, dsh, out, cv, vis_tile, scratch);
  return static_cast<int>(cudaGetLastError());
}
