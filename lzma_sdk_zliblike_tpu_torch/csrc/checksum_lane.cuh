// Per-block arithmetic of X3, the device CRC32 / CRC64 (checksum.cu, after
// ops/checksum.py of the JAX package): a 64-byte block's unconditioned CRC
// state (init 0, no final xor), advanced one bit at a time, and the GF(2)
// matrix step that joins two neighbouring blocks of a tree level.  The
// kernels run these functions on the card; cpu_harness.cc builds the very
// same code with g++ so the tests can hold it against the plain PyTorch
// version on a machine without a GPU.
//
// Both widths use reflected CRC registers: CRC32 poly 0xEDB88320
// (7zCrcOpt.c:10-27), CRC64 poly 0xC96C5795D7870F42 (XzCrc64.c:6-33).  A
// block is 16 little-endian 32-bit words; each word is xored into the low
// 32 bits of the state and absorbed by 32 bit steps, as the JAX lockstep
// does.  A matrix is `width` columns: column j is the image of bit j.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace lzt {
namespace crc {

constexpr int kBlockBytes = 64;               // bytes per block state
constexpr int kBlockWords = kBlockBytes / 4;
constexpr uint64_t kPoly32 = 0xEDB88320ull;
constexpr uint64_t kPoly64 = 0xC96C5795D7870F42ull;

// The unconditioned state of one block of 16 words: for width 32 the poly is
// kPoly32 and the state stays below 2^32.
__host__ __device__ __forceinline__ uint64_t block_state(const uint32_t* w, uint64_t poly) {
  uint64_t s = 0;
  for (int k = 0; k < kBlockWords; ++k) {
    s ^= w[k];
    for (int b = 0; b < 32; ++b) s = (s >> 1) ^ (poly & (0ull - (s & 1)));
  }
  return s;
}

// M v over GF(2): the xor of the columns of M selected by the bits of v.
__host__ __device__ __forceinline__ uint64_t apply(const uint64_t* cols, uint64_t v,
                                                   int width) {
  uint64_t r = 0;
  for (int j = 0; j < width; ++j) r ^= cols[j] & (0ull - ((v >> j) & 1));
  return r;
}

// The state of A || B from the states of A and B, where `cols` feeds |B|
// zero bytes: state(A || B) = Z^|B| state(A) ^ state(B).
__host__ __device__ __forceinline__ uint64_t join(const uint64_t* cols, uint64_t a,
                                                  uint64_t b, int width) {
  return apply(cols, a, width) ^ b;
}

}  // namespace crc
}  // namespace lzt
