// Per-thread pieces of X4's fixed-alignment filters (branch_filters.cu,
// after ops/device_filters.py of the JAX package): the ARM, PPC and SPARC
// word converters (Bra.c:6-31, 69-133), ARM Thumb (Bra.c:33-67), IA64
// (BraIA64.c:14-67) and the distance-`dist` byte delta (Delta.c:20-62).
// cpu_harness.cc builds the very same code with g++ and calls the pieces in
// the kernels' order and geometry, so the tests can hold it against the
// plain PyTorch versions and the JAX functions on a machine without a GPU.
//
// Every piece reproduces the JAX batch functions' rows bit for bit: the
// converters compare a position with `valid` as uint32 (a negative valid
// covers the whole row), positions and offsets wrap mod 2^32, and bytes a
// converter does not rewrite come back as they went in.  Delta compares
// with `valid` as a signed int and leaves bytes from it on as they were.
//
// Units.  The converters are stateless: a thread owns 16 bytes of a lane
// (four words, eight Thumb halfwords or one IA64 bundle) and writes exactly
// those.  A Thumb BL pair spans two halfwords, so a thread also reads the
// halfwords on either side of its own and takes each output halfword as a
// gather: the pair that starts at it (its first half) or the pair that
// started one before (its second half).  The two exclude each other (the
// middle byte would need both 0xF0 and 0xF8 in its top five bits), so no
// two threads write one byte.
//
// Delta.  Encode is a gather with no carry: a thread owns 16 bytes and
// subtracts the 16 bytes `dist` before them, read from the row.  Decode is
// a prefix sum per residue class mod `dist`, cut into segments of whole
// rows (branch_filters.cu says how the launches use the pieces below): a
// reduce gives each segment's per-class totals, a carry step turns them
// into the sums before each segment, and a scan adds those to the
// segment's own prefix sums.  Bytes are added as vectors, four to a
// 32-bit word with no carries between them (vadd4), so a word holds four
// classes.
#pragma once

#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace lzt {
namespace bra {

constexpr int kUnit = 16;   // bytes a converter thread owns

enum WordKind { kArm = 0, kPpc = 1, kSparc = 2 };

__host__ __device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

// dest +- pos mod 2^32 (the JAX functions' jnp.where(encoding, ...)).
__host__ __device__ __forceinline__ uint32_t branch(uint32_t dest, uint32_t pos, bool enc) {
  return enc ? dest + pos : dest - pos;
}

// Four byte lanes added and subtracted mod 256, no carry between them.
__host__ __device__ __forceinline__ uint32_t vadd4(uint32_t a, uint32_t b) {
  return ((a & 0x7F7F7F7Fu) + (b & 0x7F7F7F7Fu)) ^ ((a ^ b) & 0x80808080u);
}

__host__ __device__ __forceinline__ uint32_t vsub4(uint32_t a, uint32_t b) {
  return ((a | 0x80808080u) - (b & 0x7F7F7F7Fu)) ^ ((a ^ ~b) & 0x80808080u);
}

// 16 bytes at p as four little-endian words: one 16-byte access where the
// caller found every address 16-aligned, else byte by byte.
__host__ __device__ __forceinline__ void load_unit(uint32_t w[4], const uint8_t* p, bool vec) {
  if (vec) {
#ifdef __CUDA_ARCH__
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
#else
    memcpy(w, p, 16);
#endif
    return;
  }
  for (int k = 0; k < 4; ++k)
    w[k] = p[4 * k] | (p[4 * k + 1] << 8) | (p[4 * k + 2] << 16) | ((uint32_t)p[4 * k + 3] << 24);
}

__host__ __device__ __forceinline__ void store_unit(uint8_t* p, const uint32_t w[4], bool vec) {
  if (vec) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
#else
    memcpy(p, w, 16);
#endif
    return;
  }
  for (int k = 0; k < 16; ++k) p[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
}

// ---------------------------------------------------------------------------
// ARM, PPC, SPARC: one 4-aligned word at a time
// ---------------------------------------------------------------------------

// The word at byte pos_in of a lane, as it lies in memory (little-endian),
// after the converter K: arm_convert_batch (ops/device_filters.py:62),
// ppc_ (:81) and sparc_ (:99) of the JAX package.
template <int K>
__host__ __device__ __forceinline__ uint32_t word_convert(uint32_t w, uint32_t pos_in,
                                                          uint32_t valid, uint32_t ip, bool enc) {
  if (!(pos_in + 4 <= valid)) return w;
  if (K == kArm) {   // BL: byte 3 is 0xEB, bytes 0-2 a word offset
    if ((w >> 24) != 0xEB) return w;
    const uint32_t c = branch((w & 0xFFFFFFu) << 2, pos_in + ip + 8, enc) >> 2;
    return (c & 0xFFFFFFu) | 0xEB000000u;
  }
  const uint32_t b = bswap32(w);   // the big-endian word
  if (K == kPpc) {   // bl: (b0 & 0xFC) == 0x48, (b3 & 3) == 1
    if ((b >> 26) != (0x48 >> 2) || (b & 3) != 1) return w;
    const uint32_t c = branch(b & 0x03FFFFFCu, pos_in + ip, enc);
    return bswap32(0x48000000u | (c & 0x03FFFFFCu) | (b & 3));
  }
  // SPARC call: 0x40 then two clear top bits, or 0x7F then two set ones
  const uint32_t b0 = b >> 24, b1 = (b >> 16) & 0xC0;
  if (!((b0 == 0x40 && b1 == 0) || (b0 == 0x7F && b1 == 0xC0))) return w;
  uint32_t c = branch(b << 2, pos_in + ip, enc) >> 2;
  // Bra.c:124 sign-replicates bit 22 over bits 22-29; bits 0-21 survive
  c = (c & 0x003FFFFFu) | 0x40000000u | ((c & 0x400000u) ? 0x3FC00000u : 0u);
  return bswap32(c);
}

// Unit u (bytes 16u .. 16u + 15, cut at L) of a lane of L bytes, L % 4 == 0.
template <int K>
__host__ __device__ __forceinline__ void word_unit(const uint8_t* in, uint8_t* out, int64_t L,
                                                   int64_t u, uint32_t valid, uint32_t ip,
                                                   bool enc, bool vec) {
  const int64_t at = u * kUnit;
  if (vec && at + kUnit <= L) {
    uint32_t w[4];
    load_unit(w, in + at, true);
    for (int k = 0; k < 4; ++k)
      w[k] = word_convert<K>(w[k], (uint32_t)(at + 4 * k), valid, ip, enc);
    store_unit(out + at, w, true);
    return;
  }
  for (int64_t p = at; p < at + kUnit && p + 4 <= L; p += 4) {
    const uint8_t* s = in + p;
    uint32_t w = s[0] | (s[1] << 8) | (s[2] << 16) | ((uint32_t)s[3] << 24);
    w = word_convert<K>(w, (uint32_t)p, valid, ip, enc);
    for (int k = 0; k < 4; ++k) out[p + k] = (uint8_t)(w >> (8 * k));
  }
}

// ---------------------------------------------------------------------------
// ARM Thumb: a gather per output halfword
// ---------------------------------------------------------------------------

// The BL pair at halfwords h, h + 1 (bytes 2h .. 2h + 3 = b0 .. b3, at
// pos_in = 2h): both markers, and the pair inside `valid`.
__host__ __device__ __forceinline__ bool armt_hit(uint32_t b1, uint32_t b3, uint32_t pos_in,
                                                  uint32_t valid) {
  return (b1 & 0xF8) == 0xF0 && (b3 & 0xF8) == 0xF8 && pos_in + 4 <= valid;
}

__host__ __device__ __forceinline__ uint32_t armt_dest(uint32_t h0, uint32_t h1, uint32_t pos_in,
                                                       uint32_t ip, bool enc) {
  const uint32_t src = (((h0 >> 8 & 7) << 19) | ((h0 & 0xFF) << 11) | ((h1 >> 8 & 7) << 8) |
                        (h1 & 0xFF)) << 1;
  return branch(src, pos_in + ip + 4, enc) >> 1;
}

// Output halfword h (lo | hi << 8) of armt_convert_batch
// (ops/device_filters.py:120) from input halfwords h - 1, h and h + 1 (p,
// c, n); has_prev = h > 0, has_next = h + 1 < L / 2.
__host__ __device__ __forceinline__ uint32_t armt_half(uint32_t p, uint32_t c, uint32_t n,
                                                       bool has_prev, bool has_next, uint32_t h,
                                                       uint32_t valid, uint32_t ip, bool enc) {
  const uint32_t pos = h << 1;
  if (has_next && armt_hit(c >> 8, n >> 8, pos, valid)) {   // the pair's first half
    const uint32_t d = armt_dest(c, n, pos, ip, enc);
    return ((d >> 11) & 0xFF) | ((0xF0 | ((d >> 19) & 7)) << 8);
  }
  if (has_prev && armt_hit(p >> 8, c >> 8, pos - 2, valid)) {   // its second half
    const uint32_t d = armt_dest(p, c, pos - 2, ip, enc);
    return (d & 0xFF) | ((0xF8 | ((d >> 8) & 7)) << 8);
  }
  return c;
}

// Unit u (output halfwords 8u .. 8u + 7, cut at H = L / 2) of a lane whose
// input row is `in` and output row `out` (2H bytes).
__host__ __device__ __forceinline__ void armt_unit(const uint8_t* in, uint8_t* out, int64_t H,
                                                   int64_t u, uint32_t valid, uint32_t ip,
                                                   bool enc, bool vec) {
  const int64_t h0 = u * 8;
  uint32_t hw[10];   // halfwords h0 - 1 .. h0 + 8 (0 where the lane has none)
  const int n = H - h0 < 8 ? (int)(H - h0) : 8;
  if (vec && n == 8) {
    uint32_t w[4];
    load_unit(w, in + 2 * h0, true);
    for (int k = 0; k < 4; ++k) {
      hw[1 + 2 * k] = w[k] & 0xFFFF;
      hw[2 + 2 * k] = w[k] >> 16;
    }
  } else {
    for (int k = 0; k < 8; ++k)
      hw[1 + k] = k < n ? in[2 * (h0 + k)] | (in[2 * (h0 + k) + 1] << 8) : 0;
  }
  hw[0] = h0 > 0 ? in[2 * h0 - 2] | (in[2 * h0 - 1] << 8) : 0;
  hw[9] = h0 + 8 < H ? in[2 * h0 + 16] | (in[2 * h0 + 17] << 8) : 0;
  uint32_t o[8];
  for (int k = 0; k < 8; ++k)
    o[k] = armt_half(hw[k], hw[k + 1], hw[k + 2], h0 + k > 0, h0 + k + 1 < H,
                     (uint32_t)(h0 + k), valid, ip, enc);
  if (vec && n == 8) {
    const uint32_t w[4] = {o[0] | o[1] << 16, o[2] | o[3] << 16, o[4] | o[5] << 16,
                           o[6] | o[7] << 16};
    store_unit(out + 2 * h0, w, true);
    return;
  }
  for (int k = 0; k < n; ++k) {
    out[2 * (h0 + k)] = (uint8_t)o[k];
    out[2 * (h0 + k) + 1] = (uint8_t)(o[k] >> 8);
  }
}

// ---------------------------------------------------------------------------
// IA64: a bundle at a time
// ---------------------------------------------------------------------------

// The slot mask of a template (_IA64_BR_TABLE, BraIA64.c:5-12): templates
// come in pairs with one mask, 3 bits a pair; pairs 8, 9, 11, 12 and 14
// (templates 16-19, 22-25 and 28-29) give 4, 6, 7, 4 and 4, the rest 0.
__host__ __device__ __forceinline__ uint32_t ia64_slot_mask(uint32_t tmpl) {
  constexpr uint64_t kPairs = (4ull << 24) | (6ull << 27) | (7ull << 33) | (4ull << 36) |
                              (4ull << 42);
  return (uint32_t)(kPairs >> (3 * ((tmpl & 0x1F) >> 1))) & 7;
}

// One bundle of ia64_convert_batch (ops/device_filters.py:165) in place:
// its three 41-bit slots in order, each read after the one before wrote
// (the windows share bytes 5 and 10), as the JAX function reads `out`.
__host__ __device__ __forceinline__ void ia64_bundle(uint8_t b[16], uint32_t pos, bool ok,
                                                     bool enc) {
  const uint32_t mask = ia64_slot_mask(b[0]);
#pragma unroll
  for (int slot = 0; slot < 3; ++slot) {
    const int bit_pos = 5 + slot * 41, bp = bit_pos >> 3, br = bit_pos & 7;   // br 5, 6, 7
    const uint32_t lo32 =
        b[bp] | (b[bp + 1] << 8) | (b[bp + 2] << 16) | ((uint32_t)b[bp + 3] << 24);
    const uint32_t hi16 = b[bp + 4] | (b[bp + 5] << 8);
    const uint32_t norm_lo = (lo32 >> br) | (hi16 << (32 - br));
    const uint32_t norm_hi = hi16 >> br;
    const bool is_brl = ((norm_hi >> 5) & 0xF) == 0x5 && ((norm_lo >> 9) & 0x7) == 0;
    if (!(((mask >> slot) & 1) && is_brl && ok)) continue;
    const uint32_t src = ((((norm_lo >> 13) | (norm_hi << 19)) & 0xFFFFFu) |
                          (((norm_hi >> 4) & 1) << 20)) << 4;
    const uint32_t dest = branch(src, pos, enc) >> 4;
    const uint32_t nlo = (norm_lo & 0x1FFFu) | ((dest & 0x7FFFFu) << 13);
    const uint32_t nhi = (norm_hi & ~0x11u) | ((dest >> 19) & 1) | (((dest >> 20) & 1) << 4);
    const uint32_t new_lo32 = (lo32 & ((1u << br) - 1)) | (nlo << br);
    const uint32_t new_hi16 = ((nlo >> (32 - br)) | (nhi << br)) & 0xFFFF;
    for (int j = 0; j < 4; ++j) b[bp + j] = (uint8_t)(new_lo32 >> (8 * j));
    b[bp + 4] = (uint8_t)new_hi16;
    b[bp + 5] = (uint8_t)(new_hi16 >> 8);
  }
}

// Unit u of a lane of L bytes: bundle u, or the copied tail L % 16.
__host__ __device__ __forceinline__ void ia64_unit(const uint8_t* in, uint8_t* out, int64_t L,
                                                   int64_t u, uint32_t valid, uint32_t ip,
                                                   bool enc, bool vec) {
  const int64_t at = u * kUnit;
  if (at + kUnit > L) {
    for (int64_t i = at; i < L; ++i) out[i] = in[i];
    return;
  }
  uint8_t b[16];
  if (vec) {
    uint32_t w[4];
    load_unit(w, in + at, true);
    for (int k = 0; k < 16; ++k) b[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
  } else {
    for (int k = 0; k < 16; ++k) b[k] = in[at + k];
  }
  ia64_bundle(b, (uint32_t)at + ip, (uint32_t)at + 16 <= valid, enc);
  if (vec) {
    uint32_t w[4];
    for (int k = 0; k < 4; ++k)
      w[k] = b[4 * k] | (b[4 * k + 1] << 8) | (b[4 * k + 2] << 16) | ((uint32_t)b[4 * k + 3] << 24);
    store_unit(out + at, w, true);
  } else {
    for (int k = 0; k < 16; ++k) out[at + k] = b[k];
  }
}

// ---------------------------------------------------------------------------
// Delta: encode a gather, decode reduce-then-scan over segments
// ---------------------------------------------------------------------------

// The bytes a lane transforms: [0, end), end = valid clamped to [0, L]
// (delta_batch, ops/device_filters.py:316, compares signed).
__host__ __device__ __forceinline__ int64_t delta_end(int32_t valid, int64_t L) {
  return valid <= 0 ? 0 : (valid < L ? valid : L);
}

// Bytes r .. r + 3 of the 8 bytes hi:lo (0 <= r < 4).
__host__ __device__ __forceinline__ uint32_t funnel8(uint32_t lo, uint32_t hi, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, 8 * r);
#else
  return r ? (lo >> (8 * r)) | (hi << (32 - 8 * r)) : lo;
#endif
}

// v's bytes below `e` (bytes of the word before the lane's end), x's from
// there on.
__host__ __device__ __forceinline__ uint32_t blend_end(uint32_t v, uint32_t x, int64_t e) {
  if (e >= 4) return v;
  const uint32_t m = e <= 0 ? 0u : 0xFFFFFFFFu >> (32 - 8 * e);
  return (v & m) | (x & ~m);
}

// Encode, unit u (bytes 16u .. 16u + 15, cut at L): out[i] = d[i] -
// d[i - dist] for i < end (d[i] for i < dist), d[i] from end on.  With
// `vec` (row and buffers 16-aligned) the unit is one 16-byte load and
// store, and the shifted bytes one unaligned window funnelled out of the
// two aligned units that hold it (dist is one for the grid, so every
// thread takes the same branch).
__host__ __device__ __forceinline__ void delta_encode_unit(const uint8_t* in, uint8_t* out,
                                                           int64_t L, int64_t u, int64_t dist,
                                                           int64_t end, bool vec) {
  const int64_t at = u * kUnit;
  if (vec && at + kUnit <= L) {
    uint32_t x[4];
    load_unit(x, in + at, true);
    if (at < end) {
      uint32_t s[4] = {0, 0, 0, 0};
      const int64_t from = at - dist;
      if (from >= 0) {
        const int sh = (int)(from & 15), k = sh >> 2, r = sh & 3;
        uint32_t c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        load_unit(c, in + (from - sh), true);
        if (sh) load_unit(c + 4, in + (from - sh) + kUnit, true);   // from - sh + 16 <= at
        uint32_t q[5];
        for (int j = 0; j < 5; ++j)
          q[j] = k == 0 ? c[j] : k == 1 ? c[j + 1] : k == 2 ? c[j + 2] : c[j + 3];
        for (int j = 0; j < 4; ++j) s[j] = funnel8(q[j], q[j + 1], r);
      } else if (from + kUnit > 0) {   // the unit that holds byte dist
        for (int b = 0; b < kUnit; ++b)
          if (from + b >= 0) s[b >> 2] |= (uint32_t)in[from + b] << (8 * (b & 3));
      }
      for (int j = 0; j < 4; ++j) x[j] = blend_end(vsub4(x[j], s[j]), x[j], end - at - 4 * j);
    }
    store_unit(out + at, x, true);
    return;
  }
  for (int64_t p = at; p < at + kUnit && p < L; ++p)
    out[p] = p < end ? (uint8_t)(in[p] - (p >= dist ? in[p - dist] : 0)) : in[p];
}

// Decode by segments.  A lane is cut into segments of whole rows of `dist`
// bytes (the JAX formulation's [rows, dist] view), so every segment starts
// at class 0 and its per-class totals are a vector indexed by column.  A
// block owns a segment: its threads take (column unit, chunk) pairs, a
// column unit being a byte (kDByte) or a 32-bit word of four classes (the
// rest), and a chunk `rk` consecutive rows of it.  Words go column-fastest
// (a warp reads a row's consecutive words) straight from the row into
// registers; for dist 1 and 2 a word is 4 / dist rows.  Bytes go through
// shared memory (delta_stage_unit) and are taken chunk-fastest.
//
// A class vector is a word whose byte j holds the sum mod 256 of class j
// (classes repeated for dist 1 and 2; byte 0 alone for kDByte): chunk
// totals, the block's scan of them, the segments' entries in the scratch
// and their carries are class vectors, added by vadd4.  Within a thread
// the sums are cheaper: dist 1 and 2 take a word's prefix sums as dot
// products of its bytes with 0/1 masks (dp4a) from 32-bit running sums,
// whose low bytes are the sums mod 256, and pack the four low bytes back
// into a word (byte_perm); dist a multiple of 4 adds words as byte
// vectors; kDByte adds plain integers.
enum DeltaKind { kD1 = 0, kD2 = 1, kDWord = 2, kDByte = 3 };

constexpr int kDeltaMaxSegmented = 256;   // longer distances walk

struct DeltaGeom {
  int kind;      // DeltaKind
  int us;        // bytes of a column unit: 4, or 1 for kDByte
  int nc;        // column units a row (1 for dist 1, 2 and 4)
  int K;         // chunks a column: threads nc * K of the block take part
  int rk;        // rows a chunk: per / 4 words or per bytes
  int64_t seg;   // bytes a segment: rk * K * nc * us, a multiple of dist
  int64_t nseg;  // segments a lane of L bytes
  int ent;       // bytes of a segment's entry in the scratch: dist rounded up to 4
};

__host__ __device__ __forceinline__ int delta_kind(int64_t dist) {
  return dist == 1 ? kD1 : dist == 2 ? kD2 : dist % 4 == 0 ? kDWord : kDByte;
}

// Column units a row.
__host__ __device__ __forceinline__ int64_t delta_columns(int64_t dist) {
  const int kind = delta_kind(dist);
  return kind == kDWord ? dist / 4 : kind == kDByte ? dist : 1;
}

// The segment path takes dist <= 256 where a row's columns fit in a block;
// longer distances walk their columns (delta_walk_column).
__host__ __device__ __forceinline__ bool delta_segmented(int64_t dist, int threads) {
  return dist <= kDeltaMaxSegmented && delta_columns(dist) <= threads;
}

// The geometry at `threads` threads a block, a thread holding `per` bytes
// of words (per / 4 of them) or `per` rows of a byte column.
__host__ __device__ __forceinline__ DeltaGeom delta_geom(int64_t dist, int64_t L, int threads,
                                                        int per) {
  DeltaGeom g;
  g.kind = delta_kind(dist);
  g.us = g.kind == kDByte ? 1 : 4;
  g.nc = (int)delta_columns(dist);
  g.K = threads / g.nc;
  g.rk = g.kind == kDByte ? per : per / 4;
  g.seg = (int64_t)g.rk * g.K * g.nc * g.us;
  g.nseg = (L + g.seg - 1) / g.seg;
  g.ent = (int)((dist + 3) & ~3);
  return g;
}

// The sum of x's four bytes times m's, plus c; and the low bytes of four
// words as one.
__host__ __device__ __forceinline__ uint32_t dot4(uint32_t x, uint32_t m, uint32_t c) {
#ifdef __CUDA_ARCH__
  return __dp4a(x, m, c);
#else
  for (int j = 0; j < 4; ++j) c += ((x >> (8 * j)) & 0xFF) * ((m >> (8 * j)) & 0xFF);
  return c;
#endif
}

__host__ __device__ __forceinline__ uint32_t pack_low(uint32_t a, uint32_t b, uint32_t c,
                                                      uint32_t d) {
#ifdef __CUDA_ARCH__
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
#else
  return (a & 0xFF) | (b & 0xFF) << 8 | (c & 0xFF) << 16 | (d & 0xFF) << 24;
#endif
}

// Byte offset, in its lane, of the first unit of the chunk (cu, k) of the
// segment at `base`; its rows follow nc * us bytes apart.
__host__ __device__ __forceinline__ int64_t delta_chunk_at(const DeltaGeom& g, int64_t base,
                                                           int cu, int k) {
  return base + ((int64_t)k * g.rk * g.nc + cu) * g.us;
}

// A chunk's words (not kDByte) from `p`, its first byte, `n` bytes of the
// lane from p on (bytes past them read as 0).  AL: the rows and buffers are
// 16-aligned, so a unit is in the lane or past it whole, and a chunk of
// consecutive words (stride 4: dist 1, 2 and 4) loads four at once.
template <int KIND, int RK, bool AL>
__host__ __device__ __forceinline__ void delta_chunk_load(const uint8_t* p, int stride, int64_t n,
                                                          uint32_t x[RK]) {
  if (AL && RK % 4 == 0 && stride == 4) {
#pragma unroll
    for (int i = 0; i < RK; i += 4) {
      if (4 * i < n) {
        load_unit(x + i, p + 4 * i, true);
      } else {
        x[i] = x[i + 1] = x[i + 2] = x[i + 3] = 0;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int q = i * stride;
    if (AL) {
      x[i] = q < n ? *reinterpret_cast<const uint32_t*>(p + q) : 0;
    } else {
      x[i] = 0;
      for (int b = 0; b < 4; ++b)
        if (q + b < n) x[i] |= (uint32_t)p[q + b] << (8 * b);
    }
  }
}

// The chunk's class vector (not kDByte).
template <int KIND, int RK>
__host__ __device__ __forceinline__ uint32_t delta_chunk_total(const uint32_t x[RK]) {
  uint32_t s0 = 0, s1 = 0;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    if (KIND == kD1) {
      s0 = dot4(x[i], 0x01010101u, s0);
    } else if (KIND == kD2) {
      s0 = dot4(x[i], 0x00010001u, s0);
      s1 = dot4(x[i], 0x01000100u, s1);
    } else {
      s0 = vadd4(s0, x[i]);
    }
  }
  if (KIND == kD1) return (s0 & 0xFF) * 0x01010101u;
  if (KIND == kD2) return ((s0 & 0xFF) | (s1 & 0xFF) << 8) * 0x00010001u;
  return s0;
}

// One step of the block's scan of chunk totals, tot[k * nc + cu] over k
// for each column (Hillis-Steele at offsets nc, 2 nc, ... < nc * K; rows
// of more than one unit): thread t's addend, read before any thread of the
// step writes.
__host__ __device__ __forceinline__ uint32_t delta_scan_addend(const uint32_t* tot, int t,
                                                              int off) {
  return t >= off ? tot[t - off] : 0;
}

// Rows of one unit (nc == 1) scan by warps instead: each warp's inclusive
// scan by shuffles, then the totals of the warps before this one's.
__host__ __device__ __forceinline__ uint32_t delta_warp_prefix(const uint32_t* wsum, int warp) {
  uint32_t s = 0;
  for (int w = 0; w < warp; ++w) s = vadd4(s, wsum[w]);
  return s;
}

// A segment's entry in the scratch: column unit cu's class vector, a word
// at byte 4 cu (kD1 and kD2: the one word, classes repeated), or a byte.
template <int KIND>
__host__ __device__ __forceinline__ void delta_put_total(uint8_t* entry, int cu, uint32_t v) {
  if (KIND == kDByte) entry[cu] = (uint8_t)v;
  else *reinterpret_cast<uint32_t*>(entry + 4 * cu) = v;
}

template <int KIND>
__host__ __device__ __forceinline__ uint32_t delta_get_total(const uint8_t* entry, int cu) {
  if (KIND == kDByte) return entry[cu];
  return *reinterpret_cast<const uint32_t*>(entry + 4 * cu);
}

// Byte columns (kDByte) through shared memory.  The segment is staged by
// 16-byte units into its chunks of rk * nc bytes, each followed by 4 bytes
// of padding: threads take chunks k-fastest (t = cu * K + k), and the odd
// pitch in words puts the 32 chunks a warp reads in 32 different banks.
// Each thread totals its column down its chunk and later scans it in place;
// the segment then goes back out by 16-byte units.
__host__ __device__ __forceinline__ int delta_staged_at(const DeltaGeom& g, int o) {
  const int cb = g.rk * g.nc;
  return o / cb * (cb + 4) + o % cb;
}

// Bytes of the staged segment.
__host__ __device__ __forceinline__ int delta_staged_bytes(const DeltaGeom& g) {
  return g.K * (g.rk * g.nc + 4);
}

// Unit u (segment bytes 16u .. 16u + 15, cut at the segment's end) of the
// segment at `base` of a row into the staged segment `s`, bytes past L as
// 0.  AL: row and L 16-aligned.
template <bool AL>
__host__ __device__ __forceinline__ void delta_stage_unit(uint8_t* s, const uint8_t* row,
                                                          int64_t base, int64_t L,
                                                          const DeltaGeom& g, int u) {
  const int o = 16 * u, m = g.seg - o < 16 ? (int)(g.seg - o) : 16;
  const int64_t p = base + o;
  if (AL && m == 16 && (g.rk * g.nc) % 16 == 0) {   // the unit lies in one chunk
    uint32_t w[4] = {0, 0, 0, 0};
    if (p < L) load_unit(w, row + p, true);
    uint32_t* d = reinterpret_cast<uint32_t*>(s + delta_staged_at(g, o));
    for (int j = 0; j < 4; ++j) d[j] = w[j];
    return;
  }
  for (int b = 0; b < m; ++b) s[delta_staged_at(g, o + b)] = p + b < L ? row[p + b] : 0;
}

template <bool AL>
__host__ __device__ __forceinline__ void delta_unstage_unit(uint8_t* row, const uint8_t* s,
                                                            int64_t base, int64_t L,
                                                            const DeltaGeom& g, int u) {
  const int o = 16 * u, m = g.seg - o < 16 ? (int)(g.seg - o) : 16;
  const int64_t p = base + o;
  if (AL && m == 16 && (g.rk * g.nc) % 16 == 0) {
    if (p >= L) return;
    const uint32_t* d = reinterpret_cast<const uint32_t*>(s + delta_staged_at(g, o));
    const uint32_t w[4] = {d[0], d[1], d[2], d[3]};
    store_unit(row + p, w, true);
    return;
  }
  for (int b = 0; b < m && p + b < L; ++b) row[p + b] = s[delta_staged_at(g, o + b)];
}

// Column cu of the staged chunk at c: its bytes' total, and its scan in
// place from run (bytes from e on, the lane's end counted from the chunk's
// start, stay as they are).
__host__ __device__ __forceinline__ uint32_t delta_bytes_total(const uint8_t* c, int nc, int rk,
                                                              int cu) {
  uint32_t s = 0;
  for (int i = 0; i < rk; ++i) s += c[i * nc + cu];
  return s & 0xFF;
}

__host__ __device__ __forceinline__ void delta_bytes_scan(uint8_t* c, int nc, int rk, int cu,
                                                         int64_t e, uint32_t run) {
  for (int i = 0; i < rk; ++i) {
    const int q = i * nc + cu;
    run += c[q];
    if (q < e) c[q] = (uint8_t)run;
  }
}

// One step of the staged columns' scan, chunk-fastest (t = cu * K + k):
// thread t's addend.
__host__ __device__ __forceinline__ uint32_t delta_scan_addend_k(const uint32_t* tot, int t, int k,
                                                                int off) {
  return k >= off ? tot[t - off] : 0;
}

// Carries: word w of a lane's n segment entries (`ent` bytes each), in
// place, each becomes the sum of the entries before it.  Eight entries are
// loaded before any is summed, so the loads do not wait on the chain.
__host__ __device__ __forceinline__ void delta_carry_words(uint8_t* lane_entries, int ent, int w,
                                                           int64_t n) {
  uint32_t run = 0;
  for (int64_t s0 = 0; s0 < n; s0 += 8) {
    uint32_t v[8];
    const int m = n - s0 < 8 ? (int)(n - s0) : 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < m) v[j] = *reinterpret_cast<const uint32_t*>(lane_entries + (s0 + j) * ent + 4 * w);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < m) {
        *reinterpret_cast<uint32_t*>(lane_entries + (s0 + j) * ent + 4 * w) = run;
        run = vadd4(run, v[j]);
      }
  }
}

// One unit of output at p + q: y's bytes below e (the lane's end, from p),
// x's (the input) from there to n (the lane's length, from p), none past.
template <int KIND, bool AL>
__host__ __device__ __forceinline__ void delta_put_unit(uint8_t* p, int q, int64_t n, int64_t e,
                                                        uint32_t y, uint32_t x) {
  if (KIND == kDByte) {
    if (q < n) p[q] = (uint8_t)(q < e ? y : x);
    return;
  }
  if (AL) {
    if (q < n) *reinterpret_cast<uint32_t*>(p + q) = blend_end(y, x, e - q);
    return;
  }
  const uint32_t v = blend_end(y, x, e - q);
  for (int b = 0; b < 4 && q + b < n; ++b) p[q + b] = (uint8_t)(v >> (8 * b));
}

// Scan: the chunk's words (not kDByte) from `run` (the class vector of the
// sums before it: the segment's carry plus the chunks above it) into the
// output at p;
// n and e as for delta_put_unit.
template <int KIND, int RK, bool AL>
__host__ __device__ __forceinline__ void delta_chunk_store(uint8_t* p, int stride, int64_t n,
                                                           int64_t e, uint32_t run,
                                                           const uint32_t x[RK]) {
  uint32_t c0 = run & 0xFF, c1 = (run >> 8) & 0xFF, y[4];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    uint32_t v;
    if (KIND == kD1) {
      const uint32_t p0 = dot4(x[i], 0x1u, c0), p1 = dot4(x[i], 0x101u, c0),
                     p2 = dot4(x[i], 0x10101u, c0);
      c0 = dot4(x[i], 0x01010101u, c0);
      v = pack_low(p0, p1, p2, c0);
    } else if (KIND == kD2) {
      const uint32_t p0 = dot4(x[i], 0x1u, c0), p1 = dot4(x[i], 0x100u, c1);
      c0 = dot4(x[i], 0x10001u, c0);
      c1 = dot4(x[i], 0x01000100u, c1);
      v = pack_low(p0, p1, c0, c1);
    } else {
      v = run = vadd4(run, x[i]);
    }
    if (AL && RK % 4 == 0 && stride == 4) {   // four words at once
      y[i & 3] = v;
      if ((i & 3) == 3) {
        const int q = 4 * (i - 3);
        if (q + 16 <= e) {
          store_unit(p + q, y, true);
        } else {
          for (int j = 0; j < 4; ++j)
            delta_put_unit<KIND, AL>(p, q + 4 * j, n, e, y[j], x[i - 3 + j]);
        }
      }
    } else {
      delta_put_unit<KIND, AL>(p, i * stride, n, e, v, x[i]);
    }
  }
}

// Decode for the distances delta_segmented leaves out: column unit c (a
// word where dist % 4 == 0 and the rows are 4-aligned, else a byte) down
// every row of the lane, eight rows loaded before they are summed.
// dist <= L.
__host__ __device__ __forceinline__ void delta_walk_column(const uint8_t* in, uint8_t* out,
                                                           int64_t L, int64_t end, int64_t dist,
                                                           int64_t c, bool words) {
  uint32_t run = 0;
  for (int64_t p0 = words ? 4 * c : c; p0 < L; p0 += 8 * dist) {
    uint32_t x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t p = p0 + j * dist;
      x[j] = p >= L ? 0 : words ? *reinterpret_cast<const uint32_t*>(in + p) : in[p];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t p = p0 + j * dist;
      if (p >= L) break;
      run = vadd4(run, x[j]);
      if (words) delta_put_unit<kDWord, true>(out + p, 0, L - p, end - p, run, x[j]);
      else delta_put_unit<kDByte, false>(out + p, 0, L - p, end - p, run, x[j]);
    }
  }
}

}  // namespace bra
}  // namespace lzt
