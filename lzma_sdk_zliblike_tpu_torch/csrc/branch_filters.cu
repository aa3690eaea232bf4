// X4's fixed-alignment filters on Hopper: the ARM, PPC and SPARC word
// converters, ARM Thumb, IA64 and the byte delta over a batch of lanes.
//
// Replaces, in lzma_sdk_zliblike_tpu/ops/device_filters.py (plain XLA
// under jax.jit, no Pallas): arm_convert_batch (:62), ppc_convert_batch
// (:81), sparc_convert_batch (:99), armt_convert_batch (:120),
// ia64_convert_batch (:165) and delta_batch (:316).  What they compute is
// unchanged, row for row (branch_filters_lane.cuh).  On the TPU each is a
// few whole-batch vector operations: masks, shifted copies and stacks of
// the [S, L] batch, and delta decode a cumsum along a [S, L / dist, dist]
// reshape.
//
// What bounds them on this card.  The converters do a few dozen integer
// operations per 4-byte word, so they are bound by their bytes: each lane
// read once and written once at 3.35 TB/s.  Their design does nothing but
// stream: a thread owns 16 bytes (four words, eight halfwords or a bundle)
// with one 16-byte load and store where the rows allow it, on a 2-D grid of
// row chunks x lanes that gives a batch of 132 lanes of 1 MiB 34,000
// blocks.  Thumb's pairs straddle units, so a thread also reads the
// halfword on either side of its own (from L1: its neighbours loaded them)
// and each output halfword is a gather, which leaves every byte to one
// thread.
//
// Delta encode is a gather with no carry, on the same 2-D grid: a thread
// loads its 16 bytes and the 16 bytes `dist` before them (one unaligned
// window funnelled out of two aligned 16-byte loads, served by L1/L2) and
// subtracts them as byte vectors.  Delta decode is a prefix sum per residue
// class mod `dist`; besides its bytes it is bound by the chain that
// carries each class's sum along the lane.  The chain is cut into
// launches, so no block ever waits on another:
//   1. reduce: a block of 256 threads per segment of a lane, a segment
//      being whole rows of `dist` bytes, 16 KiB or just under (16,320 at
//      dist 3 or 255), so it starts at class 0.  Each column's total over
//      the segment goes to a scratch of [lanes, segments, dist rounded up
//      to 4] bytes (2.2 MB for 132 lanes of 1 MiB at dist 256).
//   2. carry: a thread per (lane, scratch word) turns its lane's totals
//      into exclusive prefixes along the segments, in place.
//   3. scan: the same blocks total their chunks again, scan the chunk
//      totals again, add the segment's carry and write the sums.
// So decode reads the batch twice and writes it once: its floor is 1.5 x
// the bytes bound.  Within a segment a thread takes `rk` rows of one
// column:
//   * dist 1, 2 and multiples of 4 (words of four classes): 16 words
//     straight from the row into registers, column-fastest, so a warp
//     reads a row's consecutive words; at dist 1, 2 and 4 a row is one
//     word and a thread's 64 bytes are consecutive (four 16-byte loads and
//     stores).  Dist 1 and 2 take a word's prefix sums as dp4a dot
//     products of its bytes with 0/1 masks and pack them by byte_perm,
//     about 7 integer operations a word (byte-vector adds would take 40);
//     multiples of 4 add words as byte vectors.  The chunk totals are
//     scanned by warp shuffles where a row is one word, else by
//     Hillis-Steele steps over a 256-word array in shared memory.
//   * other dists (byte columns): the segment is staged in shared memory
//     by 16-byte loads into chunks of 64 rows, each followed by 4 bytes of
//     padding, and threads take chunks chunk-fastest, so a warp's 32 byte
//     reads fall in 32 banks; it goes back out by 16-byte stores.  Read
//     straight from the row instead, a warp's byte loads at dist 3 would
//     scatter over a dozen sectors each.
// The work a byte is the same at every dist up to 256.  ptxas keeps every
// decode kernel at 64 registers or fewer with no spills, so four blocks
// or more of 256 threads share an SM.  Distances above 256 (never sent by
// a container: the formats allow 1-256) walk their columns instead, in one
// launch: a thread per column (a word where dist % 4 == 0 and the rows are
// 4-aligned, else a byte) down every row, eight rows loaded before they
// are summed.  Every path writes bytes from a lane's `valid` on as they
// went in.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/device_filters.py calls lzt_word_filter_batch,
// lzt_armt_batch, lzt_ia64_batch and lzt_delta_batch through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "branch_filters_lane.cuh"

using namespace lzt::bra;

namespace {

constexpr int kThreads = 256;          // converter threads a block (a unit each)
constexpr int kMaxGridY = 65535;       // lanes a grid spans; more loop
constexpr int kDeltaThreads = 256;     // threads of a decode block (a segment)
constexpr int kDeltaPer = 64;          // bytes of words a decode thread holds: 16 KiB a segment
constexpr int kWalkThreads = 256;      // threads of a column-walk block

// Units of 16 bytes: one a thread, blockIdx.y the lane (strided past 65,535).
template <int K>
__global__ void __launch_bounds__(kThreads)
    word_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long L,
                const int32_t* __restrict__ valid, const int64_t* __restrict__ ip, int n_lanes,
                int encoding, int vec) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u * kUnit >= L) return;
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y)
    word_unit<K>(in + lane * L, out + lane * L, L, u, (uint32_t)valid[lane],
                 (uint32_t)ip[lane], encoding != 0, vec != 0);
}

// Eight output halfwords a thread; the output row is 2 * H = L // 2 * 2.
__global__ void __launch_bounds__(kThreads)
    armt_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long L,
                const int32_t* __restrict__ valid, const int64_t* __restrict__ ip, int n_lanes,
                int encoding, int vec) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x, H = L / 2;
  if (u * 8 >= H) return;
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y)
    armt_unit(in + lane * L, out + lane * 2 * H, H, u, (uint32_t)valid[lane],
              (uint32_t)ip[lane], encoding != 0, vec != 0);
}

// A bundle a thread; the thread past the last bundle copies the tail.
__global__ void __launch_bounds__(kThreads)
    ia64_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long L,
                const int32_t* __restrict__ valid, const int64_t* __restrict__ ip, int n_lanes,
                int encoding, int vec) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u * kUnit >= L) return;
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y)
    ia64_unit(in + lane * L, out + lane * L, L, u, (uint32_t)valid[lane], (uint32_t)ip[lane],
              encoding != 0, vec != 0);
}

// Encode: a unit of 16 bytes a thread, blockIdx.y the lane (strided past
// 65,535), as the converters.
__global__ void __launch_bounds__(kThreads)
    delta_encode_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long L,
                        const int32_t* __restrict__ valid, long long dist, int n_lanes, int vec) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u * kUnit >= L) return;
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y)
    delta_encode_unit(in + lane * L, out + lane * L, L, u, dist, delta_end(valid[lane], L),
                      vec != 0);
}

// The scan of the block's chunk totals, over k for each column: by warp
// shuffles where a row is one unit (dist 1, 2 and 4), else by Hillis-Steele
// steps over tot[k * nc + cu] (branch_filters_lane.cuh:
// delta_scan_addend).  Returns the sum of chunks 0 .. k of t's column.
// The caller syncs before it writes tot or wsum again.
__device__ __forceinline__ uint32_t chunk_scan(uint32_t* tot, uint32_t* wsum, int t, uint32_t own,
                                               const DeltaGeom& g) {
  if (g.nc == 1) {
    uint32_t v = own;
    const int lane = t & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t n = __shfl_up_sync(0xFFFFFFFFu, v, off);
      if (lane >= off) v = vadd4(v, n);
    }
    if (lane == 31) wsum[t >> 5] = v;
    __syncthreads();
    return vadd4(delta_warp_prefix(wsum, t >> 5), v);
  }
  const int active = g.nc * g.K;
  tot[t] = own;
  __syncthreads();
  for (int off = g.nc; off < active; off <<= 1) {
    const uint32_t v = t < active ? delta_scan_addend(tot, t, off) : 0;
    __syncthreads();
    tot[t] = vadd4(tot[t], v);
    __syncthreads();
  }
  return tot[t];
}

// Decode, launch 1 of 3: a block per (segment, lane) with bytes below the
// lane's end; each column's total over the segment into the scratch entry.
template <int KIND, int RK, bool AL>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_reduce_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ scratch,
                        long long L, const int32_t* __restrict__ valid, int dist, int n_lanes,
                        DeltaGeom g) {
  __shared__ uint32_t tot[kDeltaThreads], wsum[kDeltaThreads / 32];
  const int t = threadIdx.x, cu = t % g.nc, k = t / g.nc;
  const int64_t base = (int64_t)blockIdx.x * g.seg, at0 = delta_chunk_at(g, base, cu, k);
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y) {
    if (base >= delta_end(valid[lane], L)) continue;   // the same for the whole block
    uint32_t own = 0;
    if (k < g.K) {
      uint32_t x[RK];
      delta_chunk_load<KIND, RK, AL>(in + lane * L + at0, g.nc * g.us, L - at0, x);
      own = delta_chunk_total<KIND, RK>(x);
    }
    const uint32_t incl = chunk_scan(tot, wsum, t, own, g);
    uint8_t* entry = scratch + ((int64_t)lane * g.nseg + blockIdx.x) * g.ent;
    if (k == g.K - 1) delta_put_total<KIND>(entry, cu, incl);
    if (KIND == kDByte && t < g.ent - dist) entry[dist + t] = 0;   // the entry's padding
    __syncthreads();   // tot and wsum are written again for the next lane
  }
}

// The scan of the staged byte columns' chunk totals, chunk-fastest (t = cu
// * K + k; branch_filters_lane.cuh: delta_scan_addend_k).
__device__ __forceinline__ uint32_t chunk_scan_k(uint32_t* tot, int t, int k, uint32_t own,
                                                 const DeltaGeom& g) {
  const int active = g.nc * g.K;
  tot[t] = own;
  __syncthreads();
  for (int off = 1; off < g.K; off <<= 1) {
    const uint32_t v = t < active ? delta_scan_addend_k(tot, t, k, off) : 0;
    __syncthreads();
    tot[t] = vadd4(tot[t], v);
    __syncthreads();
  }
  return tot[t];
}

// Decode, launch 1 of 3, byte columns: the segment staged in shared memory
// (delta_staged_bytes of it, dynamic), each column's total into the
// scratch entry.
template <bool AL>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_reduce_bytes_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ scratch,
                              long long L, const int32_t* __restrict__ valid, int dist,
                              int n_lanes, DeltaGeom g) {
  extern __shared__ __align__(16) uint8_t staged[];
  __shared__ uint32_t tot[kDeltaThreads];
  const int t = threadIdx.x, cu = t / g.K, k = t % g.K, active = g.nc * g.K;
  const int64_t base = (int64_t)blockIdx.x * g.seg;
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y) {
    if (base >= delta_end(valid[lane], L)) continue;   // the same for the whole block
    for (int u = t; 16 * u < g.seg; u += kDeltaThreads)
      delta_stage_unit<AL>(staged, in + lane * L, base, L, g, u);
    __syncthreads();
    const uint32_t own =
        t < active ? delta_bytes_total(staged + k * (g.rk * g.nc + 4), g.nc, g.rk, cu) : 0;
    const uint32_t incl = chunk_scan_k(tot, t, k, own, g);
    uint8_t* entry = scratch + ((int64_t)lane * g.nseg + blockIdx.x) * g.ent;
    if (t < active && k == g.K - 1) delta_put_total<kDByte>(entry, cu, incl);
    if (t < g.ent - dist) entry[dist + t] = 0;   // the entry's padding
    __syncthreads();   // staged and tot are written again for the next lane
  }
}

// Decode, launch 3 of 3, byte columns: stage, scan each column's chunk in
// place from its carry, write the segment out.
template <bool AL>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_scan_bytes_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                            const uint8_t* __restrict__ scratch, long long L,
                            const int32_t* __restrict__ valid, int n_lanes, DeltaGeom g) {
  extern __shared__ __align__(16) uint8_t staged[];
  __shared__ uint32_t tot[kDeltaThreads];
  const int t = threadIdx.x, cu = t / g.K, k = t % g.K, active = g.nc * g.K;
  const int64_t base = (int64_t)blockIdx.x * g.seg;
  uint8_t* chunk = staged + k * (g.rk * g.nc + 4);
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y) {
    const int64_t end = delta_end(valid[lane], L);
    const bool scan = base < end;   // the same for the whole block
    uint32_t carry = 0;
    if (scan && t < active)
      carry = delta_get_total<kDByte>(scratch + ((int64_t)lane * g.nseg + blockIdx.x) * g.ent, cu);
    for (int u = t; 16 * u < g.seg; u += kDeltaThreads)
      delta_stage_unit<AL>(staged, in + lane * L, base, L, g, u);
    __syncthreads();
    if (scan) {
      const uint32_t own = t < active ? delta_bytes_total(chunk, g.nc, g.rk, cu) : 0;
      const uint32_t incl = chunk_scan_k(tot, t, k, own, g);
      if (t < active)
        delta_bytes_scan(chunk, g.nc, g.rk, cu, end - (base + (int64_t)k * g.rk * g.nc),
                         vadd4(carry, vsub4(incl, own)));
      __syncthreads();
    }
    for (int u = t; 16 * u < g.seg; u += kDeltaThreads)
      delta_unstage_unit<AL>(out + lane * L, staged, base, L, g, u);
    __syncthreads();   // staged and tot are written again for the next lane
  }
}

// Decode, launch 2 of 3: a thread per (lane, entry word) turns the lane's
// segment totals into carries, in place.
__global__ void __launch_bounds__(kWalkThreads)
    delta_carry_kernel(uint8_t* scratch, long long L, const int32_t* __restrict__ valid,
                       int n_lanes, DeltaGeom g) {
  const long long i = (long long)blockIdx.x * kWalkThreads + threadIdx.x;
  const int words = g.ent / 4;
  if (i >= (long long)n_lanes * words) return;
  const long long lane = i / words;
  const int64_t end = delta_end(valid[lane], L);
  delta_carry_words(scratch + lane * g.nseg * g.ent, g.ent, (int)(i % words),
                    (end + g.seg - 1) / g.seg);
}

// Decode, launch 3 of 3: a block per (segment, lane) scans its chunks from
// the segment's carry (read first: the carry launch has finished) into the
// output; a segment from the lane's end on is copied.  `out` differs from
// `in`.
template <int KIND, int RK, bool AL>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_scan_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                      const uint8_t* __restrict__ scratch, long long L,
                      const int32_t* __restrict__ valid, int n_lanes, DeltaGeom g) {
  __shared__ uint32_t tot[kDeltaThreads], wsum[kDeltaThreads / 32];
  const int t = threadIdx.x, cu = t % g.nc, k = t / g.nc;
  const int64_t base = (int64_t)blockIdx.x * g.seg, at0 = delta_chunk_at(g, base, cu, k);
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y) {
    const int64_t end = delta_end(valid[lane], L);
    const bool scan = base < end;   // the same for the whole block
    uint32_t carry = 0, x[RK], own = 0;
    if (scan && k < g.K)
      carry = delta_get_total<KIND>(scratch + ((int64_t)lane * g.nseg + blockIdx.x) * g.ent, cu);
    if (k < g.K) {
      delta_chunk_load<KIND, RK, AL>(in + lane * L + at0, g.nc * g.us, L - at0, x);
      own = delta_chunk_total<KIND, RK>(x);
    }
    uint32_t run = 0;
    if (scan) {
      run = vadd4(carry, vsub4(chunk_scan(tot, wsum, t, own, g), own));
      __syncthreads();   // tot and wsum are written again for the next lane
    }
    if (k < g.K)
      delta_chunk_store<KIND, RK, AL>(out + lane * L + at0, g.nc * g.us, L - at0, end - at0,
                                      run, x);
  }
}

// Decode for the distances the segments leave out (over 256): a thread per
// column unit of a lane walks its rows (branch_filters_lane.cuh:
// delta_walk_column).
__global__ void __launch_bounds__(kWalkThreads)
    delta_walk_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long L,
                      const int32_t* __restrict__ valid, long long dist, int n_lanes,
                      int words) {
  const long long c = (long long)blockIdx.x * kWalkThreads + threadIdx.x;
  if (c >= (words ? dist / 4 : dist)) return;
  for (int lane = blockIdx.y; lane < n_lanes; lane += gridDim.y)
    delta_walk_column(in + lane * L, out + lane * L, L, delta_end(valid[lane], L), dist, c,
                      words != 0);
}

template <int KIND, int RK, bool AL>
int delta_segments(const uint8_t* in, uint8_t* out, uint8_t* scratch, long long L,
                   const int32_t* valid, int dist, int n_lanes, const DeltaGeom& g,
                   cudaStream_t st) {
  const dim3 grid((unsigned)g.nseg, (unsigned)(n_lanes < kMaxGridY ? n_lanes : kMaxGridY));
  delta_reduce_kernel<KIND, RK, AL><<<grid, kDeltaThreads, 0, st>>>(in, scratch, L, valid, dist,
                                                                    n_lanes, g);
  const long long words = (long long)n_lanes * (g.ent / 4);
  delta_carry_kernel<<<(unsigned)((words + kWalkThreads - 1) / kWalkThreads), kWalkThreads, 0,
                       st>>>(scratch, L, valid, n_lanes, g);
  delta_scan_kernel<KIND, RK, AL><<<grid, kDeltaThreads, 0, st>>>(in, out, scratch, L, valid,
                                                                  n_lanes, g);
  return (int)cudaGetLastError();
}

template <int KIND, int RK>
int delta_segments(const uint8_t* in, uint8_t* out, uint8_t* scratch, long long L,
                   const int32_t* valid, int dist, int n_lanes, const DeltaGeom& g, bool al,
                   cudaStream_t st) {
  return al ? delta_segments<KIND, RK, true>(in, out, scratch, L, valid, dist, n_lanes, g, st)
            : delta_segments<KIND, RK, false>(in, out, scratch, L, valid, dist, n_lanes, g, st);
}

template <bool AL>
int delta_segments_bytes(const uint8_t* in, uint8_t* out, uint8_t* scratch, long long L,
                         const int32_t* valid, int dist, int n_lanes, const DeltaGeom& g,
                         cudaStream_t st) {
  const dim3 grid((unsigned)g.nseg, (unsigned)(n_lanes < kMaxGridY ? n_lanes : kMaxGridY));
  const int smem = delta_staged_bytes(g);
  delta_reduce_bytes_kernel<AL><<<grid, kDeltaThreads, smem, st>>>(in, scratch, L, valid, dist,
                                                                   n_lanes, g);
  const long long words = (long long)n_lanes * (g.ent / 4);
  delta_carry_kernel<<<(unsigned)((words + kWalkThreads - 1) / kWalkThreads), kWalkThreads, 0,
                       st>>>(scratch, L, valid, n_lanes, g);
  delta_scan_bytes_kernel<AL><<<grid, kDeltaThreads, smem, st>>>(in, out, scratch, L, valid,
                                                                 n_lanes, g);
  return (int)cudaGetLastError();
}

bool aligned(const void* in, const void* out, long long row, int to) {
  return (((uintptr_t)in | (uintptr_t)out | (uintptr_t)row) & (uintptr_t)(to - 1)) == 0;
}

dim3 unit_grid(long long units, int n_lanes) {
  return dim3((unsigned)((units + kThreads - 1) / kThreads),
              (unsigned)(n_lanes < kMaxGridY ? n_lanes : kMaxGridY));
}

}  // namespace

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was taken).  Rows are `row` bytes,
// lanes n_lanes; valid is int32 and ip int64 (its low 32 bits) per lane.

// kind 0 ARM, 1 PPC, 2 SPARC; row % 4 == 0; out [n_lanes, row].
extern "C" int lzt_word_filter_batch(int kind, const void* in, void* out, long long row,
                                     const void* valid, const void* ip, int n_lanes,
                                     int encoding, void* stream) {
  if (n_lanes <= 0 || row == 0) return 0;
  if (row < 0 || row % 4 != 0 || row >= (1ll << 31) || kind < kArm || kind > kSparc)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = unit_grid((row + kUnit - 1) / kUnit, n_lanes);
  const int vec = aligned(in, out, row, 16);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* i8 = (const uint8_t*)in;
  uint8_t* o8 = (uint8_t*)out;
  const int32_t* v = (const int32_t*)valid;
  const int64_t* p = (const int64_t*)ip;
  if (kind == kArm)
    word_kernel<kArm><<<grid, kThreads, 0, st>>>(i8, o8, row, v, p, n_lanes, encoding, vec);
  else if (kind == kPpc)
    word_kernel<kPpc><<<grid, kThreads, 0, st>>>(i8, o8, row, v, p, n_lanes, encoding, vec);
  else
    word_kernel<kSparc><<<grid, kThreads, 0, st>>>(i8, o8, row, v, p, n_lanes, encoding, vec);
  return (int)cudaGetLastError();
}

// out [n_lanes, row / 2 * 2].
extern "C" int lzt_armt_batch(const void* in, void* out, long long row, const void* valid,
                              const void* ip, int n_lanes, int encoding, void* stream) {
  if (n_lanes <= 0 || row < 2) return 0;
  if (row >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  armt_kernel<<<unit_grid((row / 2 + 7) / 8, n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, row, (const int32_t*)valid, (const int64_t*)ip,
      n_lanes, encoding, aligned(in, out, row, 16));
  return (int)cudaGetLastError();
}

// out [n_lanes, row].
extern "C" int lzt_ia64_batch(const void* in, void* out, long long row, const void* valid,
                              const void* ip, int n_lanes, int encoding, void* stream) {
  if (n_lanes <= 0 || row == 0) return 0;
  if (row < 0 || row >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  ia64_kernel<<<unit_grid((row + kUnit - 1) / kUnit, n_lanes), kThreads, 0,
                (cudaStream_t)stream>>>((const uint8_t*)in, (uint8_t*)out, row,
                                        (const int32_t*)valid, (const int64_t*)ip, n_lanes,
                                        encoding, aligned(in, out, row, 16));
  return (int)cudaGetLastError();
}

// Bytes of scratch lzt_delta_batch needs: a decode at dist <= 256 (after
// clamping to the row), one entry of dist rounded up to 4 bytes per
// segment per lane; 0 otherwise.
extern "C" long long lzt_delta_scratch_bytes(long long row, long long dist, int n_lanes,
                                             int encoding) {
  if (encoding || n_lanes <= 0 || row <= 0 || dist < 1) return 0;
  const long long d = dist < row ? dist : row;
  if (!delta_segmented(d, kDeltaThreads)) return 0;
  return (long long)n_lanes * delta_geom(d, row, kDeltaThreads, kDeltaPer).nseg *
         ((d + 3) & ~3ll);
}

// dist >= 1 (a dist past the row acts as the row's length); out [n_lanes,
// row]; scratch of lzt_delta_scratch_bytes(row, dist, n_lanes, encoding)
// bytes, 4-aligned (unused, and may be null, where that is 0).  Encode is
// one launch, decode three (dist <= 256) or one column walk.
extern "C" int lzt_delta_batch(const void* in, void* out, long long row, const void* valid,
                               long long dist, int n_lanes, int encoding, void* scratch,
                               void* stream) {
  if (n_lanes <= 0 || row == 0) return 0;
  if (row < 0 || row >= (1ll << 31) || dist < 1) return (int)cudaErrorInvalidValue;
  const long long d = dist < row ? dist : row;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* i8 = (const uint8_t*)in;
  uint8_t* o8 = (uint8_t*)out;
  const int32_t* v = (const int32_t*)valid;
  const int al = aligned(in, out, row, 4), vec = aligned(in, out, row, 16);
  if (encoding) {
    delta_encode_kernel<<<unit_grid((row + kUnit - 1) / kUnit, n_lanes), kThreads, 0, st>>>(
        i8, o8, row, v, d, n_lanes, vec);
    return (int)cudaGetLastError();
  }
  if (!delta_segmented(d, kDeltaThreads)) {
    const int words = al && d % 4 == 0;
    const long long cols = words ? d / 4 : d;
    const dim3 grid((unsigned)((cols + kWalkThreads - 1) / kWalkThreads),
                    (unsigned)(n_lanes < kMaxGridY ? n_lanes : kMaxGridY));
    delta_walk_kernel<<<grid, kWalkThreads, 0, st>>>(i8, o8, row, v, d, n_lanes, words);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || ((uintptr_t)scratch & 3)) return (int)cudaErrorInvalidValue;
  const DeltaGeom g = delta_geom(d, row, kDeltaThreads, kDeltaPer);
  uint8_t* sc = (uint8_t*)scratch;
  const int di = (int)d;
  switch (g.kind) {
    case kD1:
      return delta_segments<kD1, kDeltaPer / 4>(i8, o8, sc, row, v, di, n_lanes, g, vec, st);
    case kD2:
      return delta_segments<kD2, kDeltaPer / 4>(i8, o8, sc, row, v, di, n_lanes, g, vec, st);
    case kDWord:
      return delta_segments<kDWord, kDeltaPer / 4>(i8, o8, sc, row, v, di, n_lanes, g, vec, st);
    default:
      return vec ? delta_segments_bytes<true>(i8, o8, sc, row, v, di, n_lanes, g, st)
                 : delta_segments_bytes<false>(i8, o8, sc, row, v, di, n_lanes, g, st);
  }
}
