// X3 on Hopper: CRC32 and CRC64 of a byte string, as block states and a
// tree combine.
//
// Replaces lzma_sdk_zliblike_tpu/ops/checksum.py::_crc32_blocks and
// ::_crc64_blocks (plain XLA under jax.jit, no Pallas).  What it computes is
// unchanged: the input, padded with zeros to a power of two of at least 64
// bytes, is cut into 64-byte blocks; each block's unconditioned state is
// advanced bit by bit (checksum_lane.cuh), and the states are joined up a
// binary tree with one GF(2) zero-feed matrix per level.  The host removes
// the padding and applies the init value (ops/checksum.py).  The TPU's
// lo/hi uint32 pairs are left behind: CRC64 runs on native uint64_t.
//
// What bounds it on this card: the bytes bound (the input read once at
// 3.35 TB/s) is 40 us for 128 MiB, but the bit-serial block step costs
// about 8 integer operations per input bit, so the block launch is bound by
// operations, a few times above the bytes bound.  The design does nothing
// about that (a first, simple kernel): one thread per block, its 64 bytes
// read as four 16-byte loads; the combine reduces 2^nlev neighbouring
// states per block of threads in shared memory, up to 8 levels a launch, so
// a 128 MiB input (2^21 blocks, 21 levels) takes three combine launches.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/checksum.py calls lzt_crc_blocks and
// lzt_crc_combine through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "checksum_lane.cuh"

using namespace lzt::crc;

namespace {

constexpr int kThreads = 256;    // block-state launch
constexpr int kMaxLevels = 8;    // tree levels per combine launch (256 states)

__global__ void __launch_bounds__(kThreads)
    crc_blocks_kernel(const uint4* __restrict__ words, long long lanes, uint64_t poly,
                      uint64_t* __restrict__ states) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t w[kBlockWords];
  const uint4* src = words + lane * (kBlockBytes / 16);
#pragma unroll
  for (int q = 0; q < kBlockBytes / 16; ++q) {
    const uint4 v = src[q];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  states[lane] = block_state(w, poly);
}

// Block b joins states [b << nlev, (b + 1) << nlev) with the matrices of
// levels 0..nlev-1 of this launch (mats: nlev x width columns).
__global__ void __launch_bounds__(1 << kMaxLevels)
    crc_combine_kernel(const uint64_t* __restrict__ in, const uint64_t* __restrict__ mats,
                       int nlev, int width, uint64_t* __restrict__ out) {
  __shared__ uint64_t s[1 << kMaxLevels];
  __shared__ uint64_t m[kMaxLevels * 64];
  const int t = threadIdx.x;
  s[t] = in[((long long)blockIdx.x << nlev) + t];
  for (int i = t; i < nlev * width; i += blockDim.x) m[i] = mats[i];
  __syncthreads();
  for (int j = 0; j < nlev; ++j) {
    const int step = 1 << j;
    if ((t & (2 * step - 1)) == 0) s[t] = join(m + j * width, s[t], s[t + step], width);
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = s[0];
}

}  // namespace

// Launches the block states on `stream` without synchronising: words holds
// `lanes` blocks of 64 bytes (16-byte aligned), states gets one uint64 per
// block.  width is 32 or 64.  Returns the CUDA error code (0 = launched).
extern "C" int lzt_crc_blocks(const void* words, long long lanes, int width, void* states,
                              void* stream) {
  if (lanes <= 0) return 0;
  if (width != 32 && width != 64) return (int)cudaErrorInvalidValue;
  const long long grid = (lanes + kThreads - 1) / kThreads;
  crc_blocks_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, lanes, width == 32 ? kPoly32 : kPoly64, (uint64_t*)states);
  return (int)cudaGetLastError();
}

// Launches one combine step on `stream`: n states (a multiple of 2^nlev,
// 1 <= nlev <= 8) become n >> nlev, joined with the nlev matrices of `mats`
// (nlev x width uint64 columns, the first for neighbours of one state's
// size).  Returns the CUDA error code (0 = launched).
extern "C" int lzt_crc_combine(const void* in, long long n, const void* mats, int nlev,
                               int width, void* out, void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || (width != 32 && width != 64) ||
      n <= 0 || (n & ((1ll << nlev) - 1)))
    return (int)cudaErrorInvalidValue;
  crc_combine_kernel<<<(unsigned)(n >> nlev), 1 << nlev, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (const uint64_t*)mats, nlev, width, (uint64_t*)out);
  return (int)cudaGetLastError();
}
