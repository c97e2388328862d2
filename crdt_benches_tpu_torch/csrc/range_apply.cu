// K2: fused range apply for Hopper (sm_90a), one block per replica row.
//
// Replaces the TPU kernel crdt_benches_tpu/ops/apply_range_fused.py
// range_fused (:388; Pallas body _range_fused_kernel, :264).  Its
// long-document twin range_fused_blocked has its own kernel, K3
// (range_apply_blocked.cu, the same function with each row split across
// blocks), which ops/apply_range_fused.py range_apply_dispatch takes
// wherever the rows alone cannot fill the card.  Per replica row of C
// positions (C a multiple of 128), from doc/delpk/ind_d/dd int32[R, C] and
// new_len int32[R]:
//   depth[d] = prefix of (delpk & (2^dsh - 1)) - (delpk >> dsh)
//   x[d]     = doc[d] with its vis bit cleared where depth[d] > 0
//   run[d]   = prefix(ind_d)[d] > 0;  cnt[d] = prefix(run)[d]
//   out[d]   = 2                                  if d >= new_len
//            = ((d + prefix(dd)[d] + 2) << 1) | 1  if run[d]
//            = x[d - cnt[d]]                       otherwise
// plus the next batch's rank structure: cv_intile (inclusive vis cumsum
// within each 128-position tile, int16) and vis_tile (tile totals).  Exact
// for any int32 operands: every prefix is an int32 sum, wrapping as the
// plain version's does.
//
// What bounds it on the H100: device-memory bytes.  The function reads 16
// bytes a column below each row's new_len (doc, delpk, ind_d, dd; past it
// the output is the constant 2) and writes 6 a column (doc', cv_intile) and
// 4 a 128-column tile (vis_tile) everywhere (chip_smoke.py
// range_apply_bound): 0.7992 ms at R = 1024, C = 183,296 on
// automerge-paper batch 3, whose rows hold 94,315 columns below new_len.
// It does a few integer operations a byte.
//
// Design: one block of 512 threads per row (the dispatch takes K2 from
// 7/10 of the SM count of rows on; below that K3 spreads the rows over
// more SMs) walks the row in chunks of 2048 columns, 4 consecutive columns a
// thread, so each warp covers one 128-column tile and the tile outputs are
// warp scans.
// - Only the live columns are read.  new_len is clamped to [0, C]; the
//   chunks stop at the tile that holds column new_len - 1, and past it the
//   block stores the constants (2, cv_intile 0, vis_tile 0) with no loads,
//   scans or barriers, while its first chunk loads.  Exact for any
//   operands: the source of column d, s(d) = max(d - cnt[d], 0), is never
//   right of d.
// - The operands stream in ahead of the scans.  Thread 0 keeps two stages
//   of the four operand chunks in dynamic shared memory, each filled by TMA
//   bulk copies (cp.async.bulk, 512-byte aligned whole tiles, cut at the
//   live tile) completing on the stage's mbarrier; chunk j + 2 is requested
//   as soon as chunk j has been read, so it loads while chunk j scans.
//   The outputs are streaming stores (written once, not read again).
// - The gather reads shared memory.  run is 0 or 1, so d - cnt[d] never
//   decreases and grows by at most one a column: a chunk's sources form one
//   window at or left of it, and no later column reads a source left of a
//   chunk's first one.  A ring holds x for the last 8192 columns (this
//   chunk and the three before it).  x differs from doc only in its vis
//   bit, so a source older than the ring is doc[s] (read again from device
//   memory) with x's vis bit, which the tile kept when it left the ring: a
//   bit row of C / 32 words, written for a tile only if a later column can
//   still read it (at or right of the chunk's first source, bounded without
//   a second scan by base - carried hole count - 1).  Where the ring covers
//   the row's hole count the bit row is never touched.  automerge-paper's
//   batches insert tens of thousands of characters, so at the headline
//   most sources of some batches are older than the ring
//   (ops/apply_range_fused.py range_apply_ring_misses counts them, and the
//   kernel counts them into ``spills`` when given it): each costs 4 bytes
//   of doc read again, against 8 for a scratch row of x.
// - Two barriers a chunk.  A block scan is a warp scan, one barrier, and
//   every warp scanning the 16 warp totals itself; the two scans keep their
//   warp totals apart, so neither needs a trailing barrier.  x goes into
//   the ring before the second scan, whose barrier publishes it (and the
//   bit row) to the gather.
// 512 threads at no more than 64 registers and 96 KB of dynamic shared
// memory a block: two blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * kItems;  // columns a chunk
constexpr int kStages = 2;
constexpr int kStreams = 4;  // doc, delpk, ind_d, dd
constexpr int kRing = 4 * kChunk;  // x of the last 8192 columns
constexpr int kSmemBytes =
    (kStages * kStreams * kChunk + kRing) * static_cast<int>(sizeof(int));
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive on ``bar`` and expect ``bytes`` of copies to complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this block's shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Exclusive scan over the block of N int32 values a thread, one barrier:
// a warp scan, the warp totals into ws, and every warp scanning the
// kWarps totals itself.  On return v[n] is the thread's exclusive prefix
// and total[n] the block sum.  ws is written again only after every thread
// has passed the block's next barrier.
template <int N>
__device__ __forceinline__ void chunk_scan(int (&v)[N], int (&total)[N],
                                           int (*ws)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl[N];
#pragma unroll
  for (int n = 0; n < N; ++n) incl[n] = v[n];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int y = __shfl_up_sync(kFull, incl[n], o);
      if (lane >= o) incl[n] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int n = 0; n < N; ++n) ws[n][warp] = incl[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    int w = lane < kWarps ? ws[n][lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    const int before = __shfl_sync(kFull, w, (warp + 31) & 31);
    total[n] = __shfl_sync(kFull, w, kWarps - 1);
    v[n] = (warp > 0 ? before : 0) + incl[n] - v[n];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
range_apply_kernel(const int* __restrict__ doc, const int* __restrict__ delpk,
                   const int* __restrict__ ind, const int* __restrict__ dd,
                   const int* __restrict__ new_len, int C, int dsh,
                   int* __restrict__ out, short* __restrict__ cv,
                   int* __restrict__ vis_tile, int* xvis,
                   unsigned long long* spills) {
  extern __shared__ __align__(128) int smem[];
  int* const stages = smem;  // [kStages][kStreams][kChunk]
  int* const ring = smem + kStages * kStreams * kChunk;  // [kRing]
  __shared__ uint64_t full[kStages];
  __shared__ int ws1[3][kWarps];
  __shared__ int ws2[1][kWarps];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(r) * C;
  const size_t bits_row = static_cast<size_t>(r) * (C / 32);
  const int nt = C / 128;
  const int nlen = min(max(new_len[r], 0), C);
  const int live_end = (nlen + 127) / 128 * 128;  // <= C
  const int nchunks = (live_end + kChunk - 1) / kChunk;

  // thread 0: chunk j's live columns of the four operands into its stage
  auto request = [&](int j) {
    const int base = j * kChunk;
    const unsigned bytes = min(kChunk, live_end - base) * sizeof(int);
    uint64_t* bar = &full[j % kStages];
    int* dst = stages + (j % kStages) * kStreams * kChunk;
    mbar_expect_tx(bar, kStreams * bytes);
    bulk_load(dst, doc + row + base, bytes, bar);
    bulk_load(dst + kChunk, delpk + row + base, bytes, bar);
    bulk_load(dst + 2 * kChunk, ind + row + base, bytes, bar);
    bulk_load(dst + 3 * kChunk, dd + row + base, bytes, bar);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < kStages && j < nchunks; ++j) request(j);
  }

  // the constant tail past the live tile: stores only, while chunk 0 loads
  for (int t = live_end / 128 + warp; t < nt; t += kWarps) {
    const size_t p = row + static_cast<size_t>(t) * 128 + lane * kItems;
    __stcs(reinterpret_cast<int4*>(out + p), make_int4(2, 2, 2, 2));
    __stcs(reinterpret_cast<short4*>(cv + p), make_short4(0, 0, 0, 0));
    if (lane == 0) vis_tile[static_cast<size_t>(r) * nt + t] = 0;
  }

  const int dmask = (1 << dsh) - 1;
  int c_depth = 0, c_ind = 0, c_dd = 0, c_cnt = 0;  // carries across chunks
  unsigned far = 0;  // this thread's columns sourced left of the ring
  for (int j = 0; j < nchunks; ++j) {
    const int base = j * kChunk;
    const int q = base + tid * kItems;  // first of this thread's columns
    const bool in = q < live_end;  // live_end % 128 == 0: whole warps
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    const int* sg = stages + (j % kStages) * kStreams * kChunk + tid * kItems;
    int4 dc = make_int4(2, 2, 2, 2), dp = make_int4(0, 0, 0, 0);
    int4 id = dp, d4 = dp;
    if (in) {
      dc = *reinterpret_cast<const int4*>(sg);
      dp = *reinterpret_cast<const int4*>(sg + kChunk);
      id = *reinterpret_cast<const int4*>(sg + 2 * kChunk);
      d4 = *reinterpret_cast<const int4*>(sg + 3 * kChunk);
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
    chunk_scan(s1, t1, ws1);  // after it every thread has read the stage
    if (tid == 0 && j + kStages < nchunks) request(j + kStages);

    int xv[kItems], dcum[kItems];
    unsigned runs = 0;  // bit k: column q + k lies in a run
    int srun = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int depth = c_depth + s1[0] + ldep[k];
      xv[k] = dv[k] - ((dv[k] & 1) & (depth > 0 ? 1 : 0));
      const int rn = (c_ind + s1[1] + lind[k]) > 0 ? 1 : 0;
      runs |= static_cast<unsigned>(rn) << k;
      srun += rn;
      dcum[k] = c_dd + s1[2] + ldd[k];
    }
    // x into the ring.  The tile it replaces (kRing columns to the left)
    // leaves x's vis bits in the row's bit scratch if a later column can
    // still read it: at or right of base - c_cnt - 1 <= s(base), left of
    // which no source lies from this chunk on.  Word 4t + k of a row holds
    // the bit of column 128t + 4 lane + k in bit lane.
    int4* slot = reinterpret_cast<int4*>(ring + (q & (kRing - 1)));
    const int e_tile = q - lane * kItems - kRing;  // warp-uniform
    if (base >= kRing && e_tile + 127 >= base - c_cnt - 1) {
      const int4 old = *slot;
      const unsigned b0 = __ballot_sync(kFull, old.x & 1);
      const unsigned b1 = __ballot_sync(kFull, old.y & 1);
      const unsigned b2 = __ballot_sync(kFull, old.z & 1);
      const unsigned b3 = __ballot_sync(kFull, old.w & 1);
      if (lane < kItems) {
        const unsigned b = lane == 0 ? b0 : lane == 1 ? b1 : lane == 2 ? b2
                                                                      : b3;
        __stcg(xvis + bits_row + (e_tile >> 7) * kItems + lane,
               static_cast<int>(b));
      }
    }
    *slot = make_int4(xv[0], xv[1], xv[2], xv[3]);
    int s2[1] = {srun}, t2[1];
    chunk_scan(s2, t2, ws2);  // its barrier publishes the ring and bits

    // gather, fill, beyond-length stamp; the ring holds columns from
    // ring_lo to the end of this chunk
    const int ring_lo = base + kChunk - kRing;
    int ov[kItems];
    int cnt = c_cnt + s2[0];
    int vsum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int d = q + k;
      const int rn = (runs >> k) & 1;
      cnt += rn;
      int o;
      if (d >= nlen) {
        o = 2;
      } else if (rn) {
        o = ((d + dcum[k] + 2) << 1) | 1;
      } else {
        const int s = max(d - cnt, 0);
        if (s >= ring_lo) {
          o = ring[s & (kRing - 1)];
        } else {  // x[s] is doc[s] with x's vis bit
          const unsigned b = static_cast<unsigned>(
              __ldcg(xvis + bits_row + (s >> 7) * kItems + (s & 3)));
          o = (__ldg(doc + row + s) & ~1) | ((b >> ((s >> 2) & 31)) & 1);
          ++far;
        }
      }
      ov[k] = o;
      vsum += o & 1;
    }
    // cv_intile / vis_tile: this warp's 128 columns are one tile
    int vincl = vsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, vincl, o);
      if (lane >= o) vincl += y;
    }
    if (in) {
      __stcs(reinterpret_cast<int4*>(out + row + q),
             make_int4(ov[0], ov[1], ov[2], ov[3]));
      int c = vincl - vsum;
      short cs[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        c += ov[k] & 1;
        cs[k] = static_cast<short>(c);
      }
      __stcs(reinterpret_cast<short4*>(cv + row + q),
             make_short4(cs[0], cs[1], cs[2], cs[3]));
      if (lane == 31) {
        vis_tile[static_cast<size_t>(r) * nt + q / 128] = vincl;
      }
    }
    c_depth += t1[0];
    c_ind += t1[1];
    c_dd += t1[2];
    c_cnt += t2[0];
  }

  if (spills != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) far += __shfl_xor_sync(kFull, far, o);
    if (lane == 0 && far) {
      atomicAdd(spills, static_cast<unsigned long long>(far));
    }
  }
}

cudaError_t configure() {
  cudaError_t e = cudaFuncSetAttribute(
      range_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(range_apply_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  return e;
}

}  // namespace

// xvis: int32[R, C / 32] of bit scratch.  ``spills`` may be null;
// otherwise the kernel adds to it the number of columns whose source is
// older than the ring (read as doc with its bit from xvis).
extern "C" int crdt_range_apply(const int* doc, const int* delpk,
                                const int* ind, const int* dd,
                                const int* new_len, int R, int C, int dsh,
                                int* out, short* cv, int* vis_tile,
                                int* xvis, unsigned long long* spills,
                                void* stream) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return static_cast<int>(e);
  range_apply_kernel<<<R, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      doc, delpk, ind, dd, new_len, C, dsh, out, cv, vis_tile, xvis,
      spills);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's registers a thread, shared memory a block (dynamic and
// static, bytes) and resident blocks an SM on the current device.
extern "C" int crdt_range_apply_info(int* regs, int* smem_bytes,
                                     int* blocks_per_sm) {
  cudaError_t e = configure();
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, range_apply_kernel);
  if (e == cudaSuccess) {
    *regs = attr.numRegs;
    *smem_bytes = kSmemBytes + static_cast<int>(attr.sharedSizeBytes);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, range_apply_kernel, kThreads, kSmemBytes);
  }
  return static_cast<int>(e);
}
