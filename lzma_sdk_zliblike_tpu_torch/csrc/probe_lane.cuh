// Per-element arithmetic of the two bit-call microbenchmarks, P1
// (v12_probe.cu, after tools/dev_v12_probe.py) and P2 (compact_probe.cu,
// after tools/compact_probe.py): one range-coder-bit-shaped call on
// synthetic state.  The kernels run these functions on the card;
// cpu_harness.cc builds the very same code with g++ so the tests can hold
// it against the plain PyTorch versions on a machine without a GPU.
//
// The two probes differ in their integer types, and the outputs must be
// bit-identical to the TPU kernels':
// * P1 keeps rng and code as uint32 (logical >>, products and differences
//   wrap mod 2^32); probabilities and indices are int32.
// * P2 runs entirely in signed int32: products, differences and left
//   shifts wrap, >> is arithmetic, and rng does go negative.  Signed
//   overflow is undefined in C++, so every wrapping step is computed in
//   uint32_t and cast back.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace lzt {
namespace probe {

constexpr int kCalls = 28;          // bit calls per iteration (both probes)
constexpr int kLanes = 128;         // P1 row width, P2 stream count
constexpr int kTables = 8;          // P1 probability tables
constexpr int32_t kProbInit = 1024;

__host__ __device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wrap_shl(int32_t a, int n) {
  return (int32_t)((uint32_t)a << n);
}

// The adapted probability after a bit (both probes, int32).
__host__ __device__ __forceinline__ int32_t adapt(int32_t p, bool bit0) {
  return bit0 ? wrap_add(p, wrap_sub(2048, p) >> 5) : wrap_sub(p, p >> 5);
}

// ---- P1 (dev_v12_probe.py:54-64, :80-95, :106-129) -------------------------

// bound = (rng >> 11) * uint32(p)
__host__ __device__ __forceinline__ uint32_t v12_bound(uint32_t rng, int32_t p) {
  return (rng >> 11) * (uint32_t)p;
}

// The range and code after a bit with bound `bound`; only where `live` (the
// masked variants' `do`) do they take the bit, but the renormalisation
// shift always runs.
__host__ __device__ __forceinline__ void v12_settle(uint32_t& rng, uint32_t& code,
                                                    uint32_t bound, bool bit0,
                                                    bool live) {
  if (live) {
    rng = bit0 ? bound : rng - bound;
    code = bit0 ? code : code - bound;
  }
  if (rng < (1u << 24)) rng <<= 8;
}

// The 26-trip direct-bits-shaped tail of the tail* variants (:196-201).
__host__ __device__ __forceinline__ void v12_tail(uint32_t& r, uint32_t& c) {
  for (int i = 0; i < 26; ++i) {
    r = c > r ? r ^ (c >> 1) : r;
    c += r & 0xFFu;
  }
}

// ---- P2 (compact_probe.py:55-66) -------------------------------------------

// The shared per-call ALU `_alu` in signed int32; returns the new
// probability and updates rng, code and st.
__host__ __device__ __forceinline__ int32_t compact_alu(int32_t& rng, int32_t& code,
                                                        int32_t& st, int32_t prob) {
  const int32_t bound = wrap_mul(rng >> 11, prob);
  const bool bit = code < bound;
  rng = bit ? bound : wrap_sub(rng, bound);
  code = bit ? code : wrap_sub(code, bound);
  const int32_t newp = adapt(prob, bit);
  if (rng < (1 << 24)) {
    rng = wrap_shl(rng, 8);
    code = (wrap_shl(code, 8) | 0x5A) & 0x7FFFFFFF;
  }
  st = ((bit ? wrap_add(wrap_shl(st, 1), 1) : wrap_shl(st, 1)) ^ (code >> 17)) & 0x3FFF;
  return newp;
}

// The table slot of a call: (st + (code >> 7)) & 127 (bcast, mxu, tpose).
__host__ __device__ __forceinline__ int32_t compact_slot(int32_t st, int32_t code) {
  return wrap_add(st, code >> 7) & 127;
}

// JAX's floor modulo: the result has the sign of m (C's % truncates).
__host__ __device__ __forceinline__ int32_t floor_mod(int32_t x, int32_t m) {
  const int32_t r = x % m;
  return r < 0 ? r + m : r;
}

// The submask variant's slot: (st + (code >> 7)) % 192, a floor modulo whose
// left side can be negative.
__host__ __device__ __forceinline__ int32_t compact_slot_mod(int32_t st, int32_t code,
                                                             int32_t slots) {
  return floor_mod(wrap_add(st, code >> 7), slots);
}

// The initial code of stream (or row) i: i * 7919 + 13 + seed.
__host__ __device__ __forceinline__ int32_t compact_code0(int32_t i, int32_t seed) {
  return wrap_add(wrap_add(wrap_mul(i, 7919), 13), seed);
}

}  // namespace probe
}  // namespace lzt
