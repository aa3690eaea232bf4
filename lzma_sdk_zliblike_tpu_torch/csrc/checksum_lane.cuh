// Per-thread pieces of X3, the device CRC32 / CRC64 (checksum.cu, after
// ops/checksum.py of the JAX package): the slicing tables and the cached
// powers of the zero-feed matrix, the slicing-by-16 step and a segment's
// state, the GF(2) join, the right-aligned staging of a short tile, and the
// fold's leaves.  The kernels run these functions on the card;
// cpu_harness.cc builds the very same code with g++ and plays the kernels'
// schedule with it, so the tests can hold it against the plain PyTorch
// versions on a machine without a GPU.
//
// Both widths use reflected registers: CRC32 poly 0xEDB88320
// (7zCrcOpt.c:10-27), CRC64 poly 0xC96C5795D7870F42 (XzCrc64.c:6-33).  A
// state is *unconditioned*: init 0, no final xor.  Two identities carry
// the design:
//  * leading zeros are free: zero bytes fed into a zero register leave it
//    zero, so state(0^k || M) = state(M).  A short tile staged right-aligned
//    in a zero tile has the state of its own bytes, and zero states can pad
//    the front of a tree; nothing is ever padded at the end, so no inverse
//    matrix is needed;
//  * joining: state(A || B) = Z^|B| state(A) ^ state(B), Z the matrix of
//    one zero byte.
// A matrix is `W` columns: column j is the image of bit j.
#pragma once

#include <stdint.h>

#include <type_traits>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace lzt {
namespace crc {

constexpr uint64_t kPoly32 = 0xEDB88320ull;
constexpr uint64_t kPoly64 = 0xC96C5795D7870F42ull;
constexpr int kSlices = 16;                    // bytes a slicing step, tables T_0..T_15
constexpr int kTableWords = kSlices * 256;     // T_k[b] at k * 256 + b
constexpr int kPowers = 64;                    // cached Z^(2^k), k = 0..63
constexpr int kRowPad = 16;                    // bytes after each segment's row when staged

// The state type of a width: CRC32's tables and matrices take half the
// shared memory and half the bank traffic of CRC64's.
template <int W>
using state_t = typename std::conditional<W == 64, uint64_t, uint32_t>::type;

// 16 bytes as four little-endian words: one vector load on the card.
#ifdef __CUDACC__
using word4 = uint4;
#else
struct alignas(16) word4 {
  uint32_t x, y, z, w;
};
#endif

// Words of the constants of a width: the tables, then the powers
// (Z^(2^k) as W columns at kTableWords + k * W).
template <int W>
__host__ __device__ constexpr int const_words() {
  return kTableWords + kPowers * W;
}

template <int W>
__host__ __device__ __forceinline__ state_t<W> bit_step(state_t<W> s) {
  const state_t<W> poly = (state_t<W>)(W == 64 ? kPoly64 : kPoly32);
  return (s >> 1) ^ (poly & (state_t<W>)(0 - (s & 1)));
}

// T_k[b]: the state of byte b followed by k zero bytes.
template <int W>
__host__ __device__ __forceinline__ state_t<W> table_entry(int k, int b) {
  state_t<W> s = (state_t<W>)b;
  for (int i = 0; i < 8 * (k + 1); ++i) s = bit_step<W>(s);
  return s;
}

// Column j of Z: one zero byte fed into a register holding bit j alone.
template <int W>
__host__ __device__ __forceinline__ state_t<W> zero_byte_column(int j) {
  state_t<W> s = (state_t<W>)1 << j;
  for (int i = 0; i < 8; ++i) s = bit_step<W>(s);
  return s;
}

// M v over GF(2): the xor of the columns of M selected by the bits of v (two
// accumulators, so the chain of xors is half as long); `cols` is 16-byte
// aligned.
template <int W>
__host__ __device__ __forceinline__ state_t<W> apply(const state_t<W>* cols, state_t<W> v) {
  constexpr int kPer = 16 / (int)sizeof(state_t<W>);   // columns a 16-byte load
  state_t<W> r0 = 0, r1 = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int j = 0; j < W; j += kPer) {
    const word4 q = *reinterpret_cast<const word4*>(cols + j);
    state_t<W> c[kPer];
    if constexpr (kPer == 2) {
      c[0] = (state_t<W>)(((uint64_t)q.y << 32) | q.x);
      c[1] = (state_t<W>)(((uint64_t)q.w << 32) | q.z);
    } else {
      c[0] = q.x, c[1] = q.y, c[2] = q.z, c[3] = q.w;
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int i = 0; i < kPer; i += 2) {   // a bit test and a predicated xor a column
      const int b = j + i;
      const uint32_t word = b < 32 ? (uint32_t)v : (uint32_t)((uint64_t)v >> 32);
      if (word & (1u << (b & 31))) r0 ^= c[i];
      if (word & (2u << (b & 31))) r1 ^= c[i + 1];
    }
  }
  return r0 ^ r1;
}

// The state of A || B from the states of A and B, where `cols` is Z^|B|.
template <int W>
__host__ __device__ __forceinline__ state_t<W> join(const state_t<W>* cols, state_t<W> a,
                                                    state_t<W> b) {
  return apply<W>(cols, a) ^ b;
}

// Z^m v through the cached powers: one product per set bit of m, never a
// squaring.
template <int W>
__host__ __device__ __forceinline__ state_t<W> zpow_apply(const state_t<W>* powers, uint64_t m,
                                                          state_t<W> v) {
  for (int k = 0; m; ++k, m >>= 1)
    if (m & 1) v = apply<W>(powers + k * W, v);
  return v;
}

// T_k[x's byte 0] ^ T_(k-1)[byte 1] ^ T_(k-2)[byte 2] ^ T_(k-3)[byte 3].
template <int W>
__host__ __device__ __forceinline__ state_t<W> slice4(const state_t<W>* T, int k, uint32_t x) {
  return T[k * 256 + (x & 255)] ^ T[(k - 1) * 256 + ((x >> 8) & 255)] ^
         T[(k - 2) * 256 + ((x >> 16) & 255)] ^ T[(k - 3) * 256 + (x >> 24)];
}

// The slicing-by-16 step: the state after 16 bytes (four little-endian
// words d0..d3) from state s.  The state is xored into the first 4 (CRC32)
// or 8 (CRC64) bytes, and byte i of the 16 adds T_(15-i)[byte].
template <int W>
__host__ __device__ __forceinline__ state_t<W> slice16_step(const state_t<W>* T, state_t<W> s,
                                                            uint32_t d0, uint32_t d1,
                                                            uint32_t d2, uint32_t d3) {
  d0 ^= (uint32_t)s;
  if constexpr (W == 64) d1 ^= (uint32_t)((uint64_t)s >> 32);
  return slice4<W>(T, 15, d0) ^ slice4<W>(T, 11, d1) ^ slice4<W>(T, 7, d2) ^
         slice4<W>(T, 3, d3);
}

// The state of a segment of `steps` x 16 bytes (16-byte aligned words).
template <int W>
__host__ __device__ __forceinline__ state_t<W> segment_state(const state_t<W>* T,
                                                             const uint32_t* row, int steps) {
  state_t<W> s = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int i = 0; i < steps; ++i) {
    const word4 d = reinterpret_cast<const word4*>(row)[i];
    s = slice16_step<W>(T, s, d.x, d.y, d.z, d.w);
  }
  return s;
}

// Where byte p of a tile is staged: segments of `seg` bytes, one a row,
// each row followed by kRowPad bytes so that a quarter-warp's 16-byte reads
// of its rows fall in distinct banks.
__host__ __device__ __forceinline__ int stage_offset(int p, int seg) {
  return (p / seg) * (seg + kRowPad) + p % seg;
}

// Byte p of a short tile of r bytes (0 < r <= tile) staged right-aligned in
// a zero tile: src[p - (tile - r)], zero before.  Reads src[0, r) only.
__host__ __device__ __forceinline__ uint8_t short_tile_byte(const uint8_t* src, int tile, int r,
                                                            int p) {
  return p >= tile - r ? src[p - (tile - r)] : 0;
}

// Whether lane (or thread) l joins its neighbour 2^k on at tree level k.
__host__ __device__ __forceinline__ bool tree_joins(int l, int k) {
  return (l & ((2 << k) - 1)) == 0;
}

// The fold's leaves: a tree over p leaves (a power of two above f), zero
// states in front, the init state at leaf p - f - 1 and the states of the f
// full tiles after it.  The tree applies Z^(tile * f) to the init state and
// the last tile's join Z^r, so it gets Z^n without a chain of its own.
template <int W>
__host__ __device__ __forceinline__ state_t<W> fold_leaf(const uint64_t* states, long long g,
                                                         long long p, long long f,
                                                         state_t<W> init) {
  const long long i = g - (p - f);
  return i >= 0 ? (state_t<W>)states[i] : (i == -1 ? init : 0);
}

// A fold thread's run of `per` leaves from leaf g0, joined in order with
// Z^tile (`ztile`).
template <int W>
__host__ __device__ __forceinline__ state_t<W> fold_run(const uint64_t* states, long long g0,
                                                        long long per, long long p, long long f,
                                                        state_t<W> init,
                                                        const state_t<W>* ztile) {
  state_t<W> v = 0;
  for (long long g = g0; g < g0 + per; ++g)
    v = join<W>(ztile, v, fold_leaf<W>(states, g, p, f, init));
  return v;
}

// The last step of the fold: the tree's state (the init state and the full
// tiles) joined with the last tile of r bytes (1 <= r <= tile), then the
// final xor.
template <int W>
__host__ __device__ __forceinline__ state_t<W> fold_finish(const state_t<W>* powers,
                                                           state_t<W> tree, uint64_t r,
                                                           state_t<W> last) {
  return zpow_apply<W>(powers, r, tree) ^ last ^ (state_t<W>)~(state_t<W>)0;
}

// floor(log2(v)) of v >= 1
__host__ __device__ __forceinline__ int log2_floor(unsigned long long v) {
  int k = 0;
  while (v >>= 1) ++k;
  return k;
}

}  // namespace crc
}  // namespace lzt
