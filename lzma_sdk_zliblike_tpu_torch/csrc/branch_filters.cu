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
// thread.  Delta encode is a gather too.  Delta decode is a prefix sum per
// residue class mod `dist`, so besides its bytes it is bound by a chain:
// the sum carried from one part of a lane to the next.  A block owns a lane
// and walks it in 16 KiB tiles staged in shared memory (a ring of two, so
// the tile before stays readable): log2(16 KiB / dist) passes of byte-
// vector adds (four classes a word) scan a tile in place, each byte then
// adds its class's last output before the tile, and the tile goes out.
// The chain is one tile step per 16 KiB of a lane, so a lane of 1 MiB is
// 64 steps; lanes run side by side, one block each.  Encode takes the same
// tiles with no passes.  Bytes from a lane's `valid` on are copied.
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
constexpr int kDeltaThreads = 512;     // threads of a delta block (a lane)
constexpr int kDeltaTile = 16384;      // bytes of a delta tile
constexpr int kDeltaWords = kDeltaTile / 4;
constexpr int kDeltaPer = kDeltaWords / kDeltaThreads;   // words a thread owns

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

// A block per lane, tile by tile (branch_filters_lane.cuh: delta by
// tiles).  `out` is read back (decode's carry for dist > a tile), so it is
// not __restrict__.
__global__ void __launch_bounds__(kDeltaThreads)
    delta_kernel(const uint8_t* __restrict__ in, uint8_t* out, long long L,
                 const int32_t* __restrict__ valid, long long dist, int encoding, int al) {
  __shared__ uint32_t ring[2 * kDeltaWords];
  const int t = threadIdx.x;
  const uint8_t* lin = in + blockIdx.x * L;
  uint8_t* lout = out + blockIdx.x * L;
  const int64_t end = delta_end(valid[blockIdx.x], L);
  const bool a = al != 0;
  int64_t base = 0;
  for (; base < end; base += kDeltaTile) {
    const int n = L - base < kDeltaTile ? (int)(L - base) : kDeltaTile;
    const int half = (int)((base / kDeltaTile) & 1) * kDeltaWords;
#pragma unroll
    for (int k = 0; k < kDeltaPer; ++k)
      delta_get(ring, half, lin, base, n, t + k * kDeltaThreads, a, kDeltaWords);
    __syncthreads();
    uint32_t v[kDeltaPer];
    if (encoding) {
#pragma unroll
      for (int k = 0; k < kDeltaPer; ++k)
        v[k] = delta_encode(ring, half, lin, base, dist, t + k * kDeltaThreads, kDeltaWords);
    } else {
      for (int sh = (int)dist; sh < kDeltaTile; sh *= 2) {   // none for dist >= a tile
#pragma unroll
        for (int k = 0; k < kDeltaPer; ++k)
          v[k] = delta_pass(ring, half, sh, t + k * kDeltaThreads, kDeltaWords);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kDeltaPer; ++k)
          ring_word(ring, half, t + k * kDeltaThreads, kDeltaWords) = v[k];
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < kDeltaPer; ++k) {   // the carry reads the tile before only
        v[k] = delta_carry(ring, half, lout, base, dist, t + k * kDeltaThreads, kDeltaWords);
        ring_word(ring, half, t + k * kDeltaThreads, kDeltaWords) = v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kDeltaPer; ++k)
      delta_put(lout, lin, base, n, end, t + k * kDeltaThreads, v[k], a);
    __syncthreads();   // the next tile overwrites the one before this
  }
  delta_copy(lout, lin, base < L ? base : L, L, t, kDeltaThreads, a);
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

// dist >= 1 (a dist past the row acts as the row's length); out [n_lanes, row].
extern "C" int lzt_delta_batch(const void* in, void* out, long long row, const void* valid,
                               long long dist, int n_lanes, int encoding, void* stream) {
  if (n_lanes <= 0 || row == 0) return 0;
  if (row < 0 || row >= (1ll << 31) || dist < 1) return (int)cudaErrorInvalidValue;
  delta_kernel<<<n_lanes, kDeltaThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, row, (const int32_t*)valid, dist < row ? dist : row,
      encoding, aligned(in, out, row, 4));
  return (int)cudaGetLastError();
}
