// Per-lane LZMA range encode: one dict-reset group's op records replayed
// through the adaptive model and the carry/cache range coder, the semantics
// of the JAX package's models/lzma/op_replay.py (LzmaEnc.c:456-573 range
// coder, :1733-1893 symbol coding).  range_encode.cu runs it as the body of one CUDA thread;
// cpu_harness.cc builds the very same code with g++ so the tests can run it
// on a machine without a GPU.
//
// Op record (2 uint32 words, native encode_segment):
//   a = kind | (rep_index << 2) | (length << 4)
//       kind 0 literal, 1 match, 2 rep, 3 short rep; length is the full
//       length (1 for literals and short reps, 2..273 otherwise)
//   b = match: wire distance (dist - 1); rep / short rep: 0;
//       literal: sym | (prev << 8) | (match_byte << 16)
// Every bit value and probability index follows from the record and the
// lane's position within its group, so the lane never reads the input data
// and never reads its own output.  Rep distances are never coded (a rep
// codes its index), so the lane does not track them.
//
// Contract of one lane (ops/range_encode.py shares it):
//   ops[0, op_cap)            the group's op words back to back
//   op_ends[0, n_chunks)      cumulative op-word end of each chunk; a chunk
//                             with no ops (padding repeats the last end)
//                             writes no body
//   out[0, out_cap)           the chunk bodies back to back
//   tab[0, n_chunks)          cumulative body end of each finished chunk
// The model (probabilities, state) carries across the chunks of the lane;
// each chunk starts a fresh range coder and ends with 5 ShiftLows, so its
// body begins with the coder's initial cache byte 0.  err: 1 = op_ends out
// of order, odd or past op_cap; 2 = an op record of impossible kind/length;
// 3 = the body would pass out_cap (the bytes up to out_cap are written).
// After an error the lane writes nothing more and stops at the end of the
// op; tab entries of unfinished chunks are left as they were.
#pragma once

#include <stdint.h>

#include "lzma_lane.cuh"   // probability layout, __host__/__device__ shims

namespace lzt {
namespace enc {

constexpr int kErrTable = 1;
constexpr int kErrOp = 2;
constexpr int kErrOverflow = 3;

struct Coder {
  uint8_t* out;
  int64_t cap;
  int64_t opos;         // bytes written
  uint16_t* probs;
  uint64_t low;         // 33 bits used: bit 32 is the carry
  uint32_t range;
  uint32_t cache;       // the byte held back for a carry
  int64_t cache_size;   // cache + the pending 0xFF bytes, no limit
  int err;
};

__host__ __device__ __forceinline__ void put(Coder& C, uint32_t byte) {
  if (C.err) return;
  if (C.opos >= C.cap) {
    C.err = kErrOverflow;
    return;
  }
  C.out[C.opos++] = (uint8_t)byte;
}

// ShiftLow (LzmaEnc.c:509-531): the top byte of low is final once low is
// below 0xFF000000 or has carried; until then it joins the pending run.
__host__ __device__ __forceinline__ void shift_low(Coder& C) {
  if (C.low < 0xFF000000ull || C.low > 0xFFFFFFFFull) {
    const uint32_t carry = (uint32_t)(C.low >> 32);
    put(C, C.cache + carry);
    for (; C.cache_size > 1; --C.cache_size) put(C, 0xFF + carry);
    C.cache = (uint32_t)(C.low >> 24) & 0xFF;
    C.cache_size = 0;
  }
  C.cache_size++;
  C.low = (C.low & 0x00FFFFFFull) << 8;
}

// One renormalisation is enough: probabilities stay in [31, 2017], so a bit
// leaves range >= 31 * (range >> 11) > 2^16 and a direct bit >= 2^23.
__host__ __device__ __forceinline__ void normalize(Coder& C) {
  if (C.range < kTop) {
    C.range <<= 8;
    shift_low(C);
  }
}

__host__ __device__ __forceinline__ void bit(Coder& C, int idx, uint32_t b) {
  const uint32_t p = C.probs[idx];
  const uint32_t bound = (C.range >> kModelBits) * p;
  if (b == 0) {
    C.range = bound;
    C.probs[idx] = (uint16_t)(p + ((kModelTotal - p) >> kMoveBits));
  } else {
    C.low += bound;
    C.range -= bound;
    C.probs[idx] = (uint16_t)(p - (p >> kMoveBits));
  }
  normalize(C);
}

__host__ __device__ __forceinline__ void direct_bits(Coder& C, uint32_t v, int n) {
  for (int i = n - 1; i >= 0; --i) {
    C.range >>= 1;
    if ((v >> i) & 1) C.low += C.range;
    normalize(C);
  }
}

__host__ __device__ __forceinline__ void tree(Coder& C, int base, int nbits,
                                              uint32_t sym) {
  uint32_t m = 1;
  for (int i = nbits - 1; i >= 0; --i) {
    const uint32_t b = (sym >> i) & 1;
    bit(C, base + (int)m, b);
    m = (m << 1) | b;
  }
}

__host__ __device__ __forceinline__ void tree_reverse(Coder& C, int base, int nbits,
                                                      uint32_t sym) {
  uint32_t m = 1;
  for (int i = 0; i < nbits; ++i) {
    const uint32_t b = sym & 1;
    sym >>= 1;
    bit(C, base + (int)m, b);
    m = (m << 1) | b;
  }
}

__host__ __device__ __forceinline__ void encode_len(Coder& C, int base,
                                                    uint32_t pos_state, uint32_t len) {
  const uint32_t sym = len - 2;
  if (sym < 8) {
    bit(C, base, 0);
    tree(C, base + kLenLow + (int)(pos_state << 3), 3, sym);
  } else if (sym < 16) {
    bit(C, base, 1);
    bit(C, base + kLenChoice2, 0);
    tree(C, base + kLenMid + (int)(pos_state << 3), 3, sym - 8);
  } else {
    bit(C, base, 1);
    bit(C, base + kLenChoice2, 1);
    tree(C, base + kLenHigh, 8, sym - 16);
  }
}

__host__ __device__ __forceinline__ uint32_t pos_slot(uint32_t dist) {
  if (dist < 4) return dist;
#ifdef __CUDA_ARCH__
  const uint32_t n = 31 - (uint32_t)__clz(dist);
#else
  const uint32_t n = 31 - (uint32_t)__builtin_clz(dist);
#endif
  return (n << 1) | ((dist >> (n - 1)) & 1);
}

__host__ __device__ __forceinline__ void encode_dist(Coder& C, uint32_t len,
                                                     uint32_t dist) {
  const uint32_t lt = len - 2 < 4 ? len - 2 : 3;
  const uint32_t slot = pos_slot(dist);
  tree(C, kPosSlot + (int)(lt << 6), 6, slot);
  if (slot < 4) return;
  const int nd = (int)(slot >> 1) - 1;
  const uint32_t base = (2 | (slot & 1)) << nd;
  const uint32_t rem = dist - base;
  if (slot < 14) {
    tree_reverse(C, kSpecPos + (int)base - (int)slot - 1, nd, rem);
  } else {
    direct_bits(C, rem >> 4, nd - 4);   // up to 26 bits
    tree_reverse(C, kAlign, 4, rem & 15);
  }
}

__host__ __device__ __forceinline__ bool op_valid(uint32_t a) {
  const uint32_t kind = a & 3, len = a >> 4;
  return (kind == 0 || kind == 3) ? len == 1 : (len >= 2 && len <= 273);
}

// One op record at group position pos; updates the state machine.
__host__ __device__ __forceinline__ void encode_op(Coder& C, uint32_t& state,
                                                   uint32_t a, uint32_t b, int64_t pos,
                                                   int lc, uint32_t lp_mask,
                                                   uint32_t pb_mask) {
  const uint32_t kind = a & 3, ri = (a >> 2) & 3, len = a >> 4;
  const uint32_t ps = (uint32_t)pos & pb_mask;
  bit(C, kIsMatch + (int)((state << 4) + ps), kind != 0);
  if (kind == 0) {
    const uint32_t sym = b & 0xFF, prev = (b >> 8) & 0xFF;
    const int base = kLiteral + 0x300 * (int)((((uint32_t)pos & lp_mask) << lc) +
                                              (prev >> (8 - lc)));
    if (state < 7) {
      tree(C, base, 8, sym);
    } else {   // matched literal: the byte at rep0 steers the model
      uint32_t mb = (b >> 16) & 0xFF, offs = 0x100, m = 1;
      for (int i = 7; i >= 0; --i) {
        const uint32_t bb = (sym >> i) & 1;
        mb <<= 1;
        const uint32_t bc = mb & offs;
        bit(C, base + (int)(offs + bc + m), bb);
        m = (m << 1) | bb;
        offs &= bb ? bc : ~bc;
      }
    }
    state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
    return;
  }
  if (kind == 1) {
    bit(C, kIsRep + (int)state, 0);
    encode_len(C, kLenCoder, ps, len);
    encode_dist(C, len, b);
    state = state < 7 ? 7 : 10;
    return;
  }
  bit(C, kIsRep + (int)state, 1);
  if (kind == 3 || ri == 0) {
    bit(C, kIsRepG0 + (int)state, 0);
    bit(C, kIsRep0Long + (int)((state << 4) + ps), kind == 2);
  } else {
    bit(C, kIsRepG0 + (int)state, 1);
    bit(C, kIsRepG1 + (int)state, ri >= 2);
    if (ri >= 2) bit(C, kIsRepG2 + (int)state, ri == 3);
  }
  if (kind == 3) {
    state = state < 7 ? 9 : 11;
    return;
  }
  encode_len(C, kRepLenCoder, ps, len);
  state = state < 7 ? 8 : 11;
}

// Encodes one lane's chunks.  probs holds num_probs(lc, lp) entries of
// scratch.  Writes tab, ok (0/1), bytes written and err.
__host__ __device__ inline void encode_lane(
    const uint32_t* ops, int64_t op_cap, const int32_t* op_ends, int n_chunks,
    uint8_t* out, int64_t out_cap, uint16_t* probs, int lc, int lp, int pb,
    int32_t* tab, int32_t* ok, int32_t* bytes, int32_t* err) {
  const int np = num_probs(lc, lp);
  for (int i = 0; i < np; ++i) probs[i] = kProbInit;
  const uint32_t lp_mask = (1u << lp) - 1, pb_mask = (1u << pb) - 1;
  Coder C;
  C.out = out;
  C.cap = out_cap;
  C.opos = 0;
  C.probs = probs;
  C.err = 0;
  uint32_t state = 0;
  int64_t pos = 0, k = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int64_t end = op_ends[c];
    if (end < k || end > op_cap || (end & 1)) {
      C.err = kErrTable;
      break;
    }
    if (end > k) {
      C.low = 0;
      C.range = 0xFFFFFFFFu;
      C.cache = 0;
      C.cache_size = 1;
      for (; k < end && !C.err; k += 2) {
        const uint32_t a = ops[k];
        if (!op_valid(a)) {
          C.err = kErrOp;
          break;
        }
        encode_op(C, state, a, ops[k + 1], pos, lc, lp_mask, pb_mask);
        pos += a >> 4;
      }
      for (int i = 0; i < 5; ++i) shift_low(C);
      if (C.err) break;
    }
    tab[c] = (int32_t)C.opos;
  }
  *ok = C.err == 0;
  *bytes = (int32_t)C.opos;
  *err = C.err;
}

}  // namespace enc
}  // namespace lzt
