// X3 on Hopper: CRC32 and CRC64 of a byte string, as table-driven tile
// states and one fold.
//
// Replaces lzma_sdk_zliblike_tpu/ops/checksum.py::_crc32_blocks and
// ::_crc64_blocks (plain XLA under jax.jit, no Pallas).  The JAX package
// pads the input to a power of two, advances every 64-byte block one bit a
// step in lockstep and joins the blocks up a tree of 2^k leaves; on this
// card that design is neither needed nor cheap.  What is computed here
// (the identities are in checksum_lane.cuh):
//
//  * crc_tiles_kernel: the unconditioned state of each tile of kTile =
//    64 KiB, a short last tile staged right-aligned in a zero tile.  A
//    persistent grid (a block per SM, each walking tiles with a grid
//    stride) keeps the slicing tables (16 x 256 entries: 32 KiB for
//    CRC64, 16 KiB for CRC32) and the tile's join matrices in shared
//    memory.  Tiles are staged by coalesced 16-byte cp.async into two
//    buffers, so the next tile lands while this one is hashed; each of the
//    256 threads runs slicing-by-16 over its own 256-byte segment (a padded
//    row), and the segment states are joined by a warp shuffle tree (5
//    levels) and the 8 warps' states in warp 0 (3 levels, while the other
//    warps hash the next tile), with Z^(256 * 2^k).  One int64 state per
//    tile.
//  * crc_fold_kernel: one block, the powers in shared memory, joins the
//    tile states: the full tiles and the init state as the leaves of a tree
//    with zero states in front (checksum_lane.cuh fold_leaf), then the last
//    tile with Z^r, then the final xor.  One word comes back.
//  * crc_init_kernel: the tables and the powers Z^(2^k), k = 0..63, from
//    the polynomial, once per width; the wrapper keeps them on the card.
//
// What bounds it on this card: the bytes bound (the input read once at
// 3.35 TB/s) is 40 us for 128 MiB.  The tile launch is bound by the
// shared-memory table reads: 16 random 8-byte (CRC64) or 4-byte (CRC32)
// reads per 16 input bytes, several wavefronts a warp read, about 6.4
// input bytes per SM cycle for CRC64 -- 2-3 x the bytes bound.  The join
// matrices and the fold are a few percent of it.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/checksum.py calls lzt_crc_init, lzt_crc_tiles and
// lzt_crc_fold through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "checksum_lane.cuh"

using namespace lzt::crc;

namespace {

constexpr int kThreads = 256;                    // threads of a tile block
constexpr int kSeg = 256;                        // bytes a thread's segment
constexpr int kTile = kThreads * kSeg;           // 65536 bytes a tile
constexpr int kSteps = kSeg / kSlices;           // slicing steps a segment
constexpr int kLevels = 8;                       // log2(kThreads): the tile's join levels
constexpr int kWarps = kThreads / 32;
constexpr int kWarpLevels = 5;                   // log2(32): the levels inside a warp
constexpr int kSegLog = 8;                       // log2(kSeg): Z^(kSeg * 2^k) = powers[kSegLog + k]
constexpr int kTileLog = 16;                     // log2(kTile)
constexpr int kRow = kSeg + kRowPad;
constexpr int kStage = kThreads * kRow;          // bytes of one staging buffer
constexpr int kFoldThreads = 256;                // no spills: up to 255 registers a thread
static_assert(kTile == 1 << kTileLog && kSeg == 1 << kSegLog && kThreads == 1 << kLevels,
              "tile geometry");

template <int W>
__host__ __device__ constexpr int head_bytes() {   // tables, join matrices and warp states, 16-byte aligned
  return ((kTableWords + kLevels * W + 2 * kWarps) * (int)sizeof(state_t<W>) + 15) / 16 * 16;
}

template <int W>
constexpr int tile_smem_bytes() {
  return head_bytes<W>() + 2 * kStage;
}

__device__ __forceinline__ void copy16_async(uint8_t* dst, const uint8_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_async_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// All 16-byte parts of a full tile into its staging buffer, coalesced.
__device__ __forceinline__ void stage_tile_async(uint8_t* dst, const uint8_t* src) {
  for (int c = threadIdx.x; c < kTile / 16; c += kThreads)
    copy16_async(dst + stage_offset(c * 16, kSeg), src + c * 16);
}

// Warp 0's part of a tile's join: the warps' states (lanes past them zero)
// joined with Z^(kSeg * 2^k), k = 5..kLevels - 1; lane 0 stores the tile's
// state.
template <int W>
__device__ __forceinline__ void join_warps(const state_t<W>* warp_s, const state_t<W>* M,
                                           int lane, uint64_t* state) {
  state_t<W> v = lane < kWarps ? warp_s[lane] : 0;
#pragma unroll
  for (int k = kWarpLevels; k < kLevels; ++k) {
    const state_t<W> right = __shfl_down_sync(0xffffffffu, v, 1 << (k - kWarpLevels));
    if (tree_joins(lane, k - kWarpLevels)) v = join<W>(M + k * W, v, right);
  }
  if (lane == 0) *state = (uint64_t)v;
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    crc_tiles_kernel(const uint8_t* __restrict__ src, long long n,
                     const state_t<W>* __restrict__ consts, uint64_t* __restrict__ states) {
  extern __shared__ __align__(16) uint8_t smem[];
  state_t<W>* T = reinterpret_cast<state_t<W>*>(smem);
  state_t<W>* M = T + kTableWords;              // kLevels x W
  state_t<W>* warp_s = M + kLevels * W;         // 2 x kWarps: this tile's and the last one's
  uint8_t* stage = smem + head_bytes<W>();      // 2 x kStage
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tiles = (n + kTile - 1) / kTile;
  const int last = (int)(n - (tiles - 1) * kTile);   // bytes of the last tile
  const bool short_last = last < kTile;
  long long tile = blockIdx.x;
  if (tile >= tiles) return;
  if (!(short_last && tile == tiles - 1)) stage_tile_async(stage, src + tile * kTile);
  commit_async();
  for (int i = t; i < kTableWords; i += kThreads) T[i] = consts[i];
  for (int i = t; i < kLevels * W; i += kThreads) M[i] = consts[kTableWords + kSegLog * W + i];
  int it = 0;
  for (; tile < tiles; ++it, tile += gridDim.x) {
    uint8_t* cur = stage + (it & 1) * kStage;
    const long long next = tile + gridDim.x;
    if (next < tiles && !(short_last && next == tiles - 1))
      stage_tile_async(stage + ((it + 1) & 1) * kStage, src + next * kTile);
    commit_async();
    wait_async_but_one();                       // this tile's parts have landed
    if (short_last && tile == tiles - 1) {      // right-aligned, byte by byte
      const uint8_t* s = src + tile * kTile;
      for (int p = t; p < kTile; p += kThreads)
        cur[stage_offset(p, kSeg)] = short_tile_byte(s, kTile, last, p);
    }
    __syncthreads();
    // the last tile's join of the warps runs here, beside the other warps'
    // segments, and not between tiles, where every warp would wait for it
    if (warp == 0 && it > 0)
      join_warps<W>(warp_s + ((it - 1) & 1) * kWarps, M, lane, states + tile - gridDim.x);
    state_t<W> v = segment_state<W>(T, reinterpret_cast<const uint32_t*>(cur + t * kRow), kSteps);
#pragma unroll
    for (int k = 0; k < kWarpLevels; ++k) {
      const state_t<W> right = __shfl_down_sync(0xffffffffu, v, 1 << k);
      if (tree_joins(lane, k)) v = join<W>(M + k * W, v, right);
    }
    if (lane == 0) warp_s[(it & 1) * kWarps + warp] = v;
    __syncthreads();                            // also: every segment read of `cur` is done
  }
  if (warp == 0) join_warps<W>(warp_s + ((it - 1) & 1) * kWarps, M, lane, states + tile - gridDim.x);
}

template <int W>
__global__ void __launch_bounds__(kFoldThreads)
    crc_fold_kernel(const uint64_t* __restrict__ states, long long n, state_t<W> init,
                    const state_t<W>* __restrict__ consts, uint64_t* __restrict__ out) {
  __shared__ state_t<W> s[kFoldThreads];
  __shared__ __align__(16) state_t<W> powers[kPowers * W];   // 32 KiB for CRC64
  const int t = threadIdx.x;
  for (int i = t; i < kPowers * W; i += kFoldThreads) powers[i] = consts[kTableWords + i];
  __syncthreads();
  const long long f = (n - 1) / kTile;          // full tiles before the last
  long long p = 1;
  while (p <= f) p <<= 1;                       // leaves: a power of two above f
  const int nt = p < kFoldThreads ? (int)p : kFoldThreads;
  const long long per = p / nt;
  s[t] = t < nt ? fold_run<W>(states, t * per, per, p, f, init, powers + kTileLog * W) : 0;
  __syncthreads();
  const int lv = kTileLog + log2_floor((unsigned long long)per);
  for (int k = 0; (1 << k) < nt; ++k) {
    if (t < nt && tree_joins(t, k)) s[t] = join<W>(powers + (lv + k) * W, s[t], s[t + (1 << k)]);
    __syncthreads();
  }
  if (t == 0)
    out[0] = (uint64_t)fold_finish<W>(powers, s[0], (uint64_t)(n - f * kTile), (state_t<W>)states[f]);
}

template <int W>
__global__ void crc_init_kernel(state_t<W>* __restrict__ consts) {
  __shared__ __align__(16) state_t<W> cur[W];
  const int t = threadIdx.x;
  for (int i = t; i < kTableWords; i += blockDim.x) consts[i] = table_entry<W>(i >> 8, i & 255);
  if (t < W) cur[t] = zero_byte_column<W>(t);
  __syncthreads();
  for (int k = 0; k < kPowers; ++k) {
    state_t<W> col = 0;
    if (t < W) {
      consts[kTableWords + k * W + t] = cur[t];
      col = apply<W>(cur, cur[t]);               // column t of (Z^(2^k))^2
    }
    __syncthreads();
    if (t < W) cur[t] = col;
    __syncthreads();
  }
}

template <int W>
int launch_tiles(const void* buf, long long n, const void* consts, void* states,
                 cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(crc_tiles_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile_smem_bytes<W>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc_tiles_kernel<W>, kThreads,
                                                      tile_smem_bytes<W>());
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + kTile - 1) / kTile, blocks = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  crc_tiles_kernel<W><<<grid, kThreads, tile_smem_bytes<W>(), stream>>>(
      (const uint8_t*)buf, n, (const state_t<W>*)consts, (uint64_t*)states);
  return (int)cudaGetLastError();
}

}  // namespace

// Fills `consts` (const_words<width>() words of width / 8 bytes) with the
// slicing tables and the powers Z^(2^k), on `stream`.  Returns the CUDA
// error code (0 = launched).
extern "C" int lzt_crc_init(int width, void* consts, void* stream) {
  if (width == 64)
    crc_init_kernel<64><<<1, 256, 0, (cudaStream_t)stream>>>((uint64_t*)consts);
  else if (width == 32)
    crc_init_kernel<32><<<1, 256, 0, (cudaStream_t)stream>>>((uint32_t*)consts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Launches the tile states of the n bytes at `buf` (16-byte aligned; n > 0)
// on `stream` without synchronising: one uint64 per tile of 64 KiB into
// `states`, the last tile short when n is not a multiple.  No byte past n
// is read.  Returns the CUDA error code (0 = launched).
extern "C" int lzt_crc_tiles(const void* buf, long long n, int width, const void* consts,
                             void* states, void* stream) {
  if (n <= 0 || ((uintptr_t)buf & 15)) return (int)cudaErrorInvalidValue;
  if (width == 64) return launch_tiles<64>(buf, n, consts, states, (cudaStream_t)stream);
  if (width == 32) return launch_tiles<32>(buf, n, consts, states, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// Launches the fold of the ceil(n / 64 KiB) tile states of an input of n
// bytes (n > 0) from the init state `init` (value ^ all-ones) on `stream`:
// the CRC lands in out[0].  Returns the CUDA error code (0 = launched).
extern "C" int lzt_crc_fold(const void* states, long long n, int width,
                            unsigned long long init, const void* consts, void* out,
                            void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (width == 64)
    crc_fold_kernel<64><<<1, kFoldThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)states, n, (uint64_t)init, (const uint64_t*)consts, (uint64_t*)out);
  else if (width == 32)
    crc_fold_kernel<32><<<1, kFoldThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)states, n, (uint32_t)init, (const uint32_t*)consts, (uint64_t*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
