// Per-lane machines of X4's two scanning filters (device_filters.cu, after
// ops/device_filters.py of the JAX package): the x86 BCJ converter
// (Bra86.c:11-85) and the BCJ2 4-stream decoder (Bcj2.c:28-127), each run
// start to end over one lane.  The kernel runs these functions one thread
// per lane on the card; cpu_harness.cc builds the very same code with g++ so
// the tests can hold it against the plain PyTorch versions on a machine
// without a GPU.
//
// Both reproduce the JAX batch functions' rows bit for bit, which pins a
// few choices the host filters leave open: x86 starts from mask state 0,
// converts only p < valid - 4 and bounds the dest retry (Bra86.c:58-67) at
// 8 trips; BCJ2 takes its initial code from rc bytes 1-4 of the row
// whatever rc_len says, reads rc bytes past rc_len as 0, and fills a row
// as the JAX scatter does (see bcj2_lane).  Neither reads or writes outside
// a lane's rows, whatever the lengths: an index past a row reads (x86:
// and writes) the row's last byte, as the JAX gathers clamp it.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace lzt {
namespace filt {

__host__ __device__ __forceinline__ bool test86(uint32_t b) { return b == 0 || b == 0xFF; }

// kMaskToBitNumber of Bra86.c:16: 0, 1, 2, 2, 3, 3, 3, 3.
__host__ __device__ __forceinline__ uint32_t mask_to_bit(uint32_t m) {
  return m == 0 ? 0 : m == 1 ? 1 : m < 4 ? 2 : 3;
}

// kMaskToAllowedStatus of Bra86.c:15: masks 0, 1, 2 and 4 allowed.
__host__ __device__ __forceinline__ bool mask_allowed(uint32_t m) { return (0x17u >> m) & 1; }

// Byte i of a row of w bytes, the last one for i >= w.
__host__ __device__ __forceinline__ uint32_t byte_at(const uint8_t* row, int32_t w, int32_t i) {
  return row[i < w ? i : w - 1];
}

// The first E8/E9 byte of `in` at or after q (q past `last` reads from
// `last`), or `stop` when there is none below it: the JAX next-candidate
// table gives the row's length for none, and both end the scan unless the
// position is below the limit.
__host__ __device__ __forceinline__ int32_t x86_next(const uint8_t* in, int32_t q,
                                                    int32_t last, int32_t stop) {
  for (q = q < last ? q : last; q < stop; ++q)
    if ((in[q] & 0xFE) == 0xE8) return q;
  return stop;
}

// x86 BCJ over one lane: the row `in` of `row` bytes, of which the first
// `valid` are the stream at offset `ip`, converted into `out`, which holds a
// copy of the row on entry; bytes the scan does not rewrite stay as they
// are.  As in the JAX batch function, the scan steps from one E8/E9 byte of
// `in` to the next while the position is below valid - 4, for at most `row`
// steps, and every read and write index past the row is clamped to its last
// byte; for valid <= row no index reaches past the row and this is the
// reference's machine.
__host__ __device__ inline void x86_lane(const uint8_t* in, uint8_t* out, int32_t row,
                                         int32_t valid, uint32_t ip, bool encoding) {
  const int64_t limit = (int64_t)valid - 4;
  const int32_t stop = limit < row ? (int32_t)limit : row;
  const int32_t last = row - 1;
  uint32_t mask = 0;
  int32_t prev_pos = -1;
  int32_t p = x86_next(in, 0, last, stop);
  for (int32_t it = 0; it < row && p < limit; ++it) {
    const int32_t d = p - prev_pos;
    prev_pos = p;
    mask = d > 3 ? 0 : (mask << (d > 1 ? d - 1 : 0)) & 7;
    const uint32_t m2b = mask_to_bit(mask);
    const bool skip =
        (mask != 0 && (!mask_allowed(mask) || test86(byte_at(in, row, p + 4 - m2b)))) ||
        !test86(byte_at(in, row, p + 4));
    if (skip) {
      mask = ((mask << 1) & 7) | 1;
      p = x86_next(in, p + 1, last, stop);
      continue;
    }
    uint32_t src = byte_at(in, row, p + 1) | (byte_at(in, row, p + 2) << 8) |
                   (byte_at(in, row, p + 3) << 16) | (byte_at(in, row, p + 4) << 24);
    const uint32_t pos = ip + (uint32_t)p + 5;
    const uint32_t idx8 = m2b * 8;
    uint32_t dest = 0;
    for (int t = 0; t < 8; ++t) {
      dest = encoding ? src + pos : src - pos;
      if (mask == 0 || !test86((dest >> (24 - idx8)) & 0xFF)) break;
      src = dest ^ ((1u << (32 - idx8)) - 1);
    }
    dest &= 0x01FFFFFF;
    if (dest & 0x01000000) dest |= 0xFE000000;
    for (int j = 0; j < 4; ++j)
      out[p + 1 + j < last ? p + 1 + j : last] = (uint8_t)(dest >> (8 * j));
    p = x86_next(in, p + 5, last, stop);
  }
}

// One lane's four BCJ2 streams: each pointer is the lane's row of `w` bytes,
// of which the first `len` are the stream.  As in the JAX batch function, a
// len past its row reads the row's last byte for every index past it (the
// main stream's sites stop at the row's end).
struct Bcj2Lane {
  const uint8_t* main;
  int32_t main_w, main_len;
  const uint8_t* call;
  int32_t call_w, call_len;
  const uint8_t* jump;
  int32_t jump_w, jump_len;
  const uint8_t* rc;
  int32_t rc_w, rc_len;
  int32_t out_size;
};

constexpr int kBcj2Probs = 2 + 256;

__host__ __device__ __forceinline__ uint32_t be32(const uint8_t* row, int32_t w, int32_t i) {
  return (byte_at(row, w, i) << 24) | (byte_at(row, w, i + 1) << 16) |
         (byte_at(row, w, i + 2) << 8) | byte_at(row, w, i + 3);
}

// One walk over the main stream's sites.  With out == nullptr it only counts
// the conversions (*nconv) and flags a call or jump stream that runs out
// (returns false); with `out` it also writes the lane's row: main byte p <
// main_used at p + 4 * (conversions before p), and each conversion's rel32
// (LE) right after its site byte, where it falls inside out_cap.
__host__ __device__ inline bool bcj2_walk(const Bcj2Lane& L, uint16_t* probs, uint8_t* out,
                                          int32_t out_cap, int32_t main_used,
                                          int32_t* nconv_out) {
  for (int i = 0; i < kBcj2Probs; ++i) probs[i] = 1024;
  uint32_t code = be32(L.rc, L.rc_w, 1);
  uint32_t rng = 0xFFFFFFFFu;
  int32_t rcpos = 5, nconv = 0, cpos = 0, jpos = 0, lastc = -2;
  uint32_t last_top = 0;
  const int32_t main_end = L.main_len < L.main_w ? L.main_len : L.main_w;
  for (int32_t p = 0; p < main_end; ++p) {
    const uint32_t b = L.main[p];
    if (out && p < main_used) {
      const int32_t o = p + 4 * nconv;
      if (o < out_cap) out[o] = (uint8_t)b;
    }
    if ((b & 0xFE) != 0xE8 && (b & 0xF0) != 0x80) continue;
    const int32_t out_after = p + 4 * nconv + 1;
    if (out_after >= L.out_size) {   // no flag once the output is full
      if (!out) break;
      continue;
    }
    const uint32_t prev = lastc == p - 1 ? last_top : p > 0 ? L.main[p - 1] : 0;
    const bool e8 = b == 0xE8, e9 = b == 0xE9;
    if (!e8 && !e9 && prev != 0x0F) continue;
    const int pidx = e8 ? 2 + (int)prev : e9 ? 0 : 1;
    if (rng < (1u << 24)) {
      code = (code << 8) | (rcpos < L.rc_len ? byte_at(L.rc, L.rc_w, rcpos) : 0u);
      rng <<= 8;
      ++rcpos;
    }
    const uint32_t pr = probs[pidx];
    const uint32_t bound = (rng >> 11) * pr;
    if (code < bound) {
      rng = bound;
      probs[pidx] = (uint16_t)(pr + ((2048 - pr) >> 5));
      continue;
    }
    rng -= bound;
    code -= bound;
    probs[pidx] = (uint16_t)(pr - (pr >> 5));
    int32_t& spos = e8 ? cpos : jpos;
    if (spos + 4 > (e8 ? L.call_len : L.jump_len)) return false;
    const uint32_t rel = (e8 ? be32(L.call, L.call_w, spos) : be32(L.jump, L.jump_w, spos)) -
                         (uint32_t)(out_after + 4);
    spos += 4;
    if (out)
      for (int j = 0; j < 4; ++j)
        if (out_after + j < out_cap) out[out_after + j] = (uint8_t)(rel >> (8 * j));
    lastc = p;
    last_top = rel >> 24;
    ++nconv;
  }
  *nconv_out = nconv;
  return true;
}

// BCJ2 decode of one lane into its row `out` (out_cap bytes, zeroed on
// entry).  Returns ok: no call or jump stream ran out, and the main bytes
// the output needs, main_used = out_size - 4 * conversions, lie within
// 0..main_len.  A lane that is not ok leaves `out` as it was.
__host__ __device__ inline bool bcj2_lane(const Bcj2Lane& L, uint16_t* probs, uint8_t* out,
                                          int32_t out_cap) {
  int32_t nconv = 0;
  if (!bcj2_walk(L, probs, nullptr, out_cap, 0, &nconv)) return false;
  const int32_t main_used = L.out_size - 4 * nconv;
  if (main_used < 0 || main_used > L.main_len) return false;
  bcj2_walk(L, probs, out, out_cap, main_used, &nconv);
  return true;
}

}  // namespace filt
}  // namespace lzt
