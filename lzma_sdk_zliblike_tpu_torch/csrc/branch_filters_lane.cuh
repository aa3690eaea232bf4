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
// Delta by tiles.  A block owns a lane and walks it in tiles of `tile`
// bytes through a ring of two tiles in shared memory (a tile's 32-bit
// words at their absolute word index mod twice the tile's words).  Encode
// is a gather: out[i] = d[i] - d[i - dist], each word's shifted source
// taken from the ring by a funnel of two words (dist <= tile) or bytewise
// from the row (dist > tile).  Decode is a prefix sum per residue class
// mod `dist`: within a tile, Hillis-Steele passes at shifts dist, 2 dist,
// 4 dist, ... < tile add byte vectors four classes a word (bytes added
// without carries between them); then each byte adds the last output of
// its class before the tile (the carry), from the ring's other tile or,
// for dist > tile, from the output row itself, which the block wrote in an
// earlier tile.
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
// Delta: tiles through a ring of two in shared memory
// ---------------------------------------------------------------------------

// The bytes a lane transforms: [0, end), end = valid clamped to [0, L]
// (delta_batch, ops/device_filters.py:316, compares signed).
__host__ __device__ __forceinline__ int64_t delta_end(int32_t valid, int64_t L) {
  return valid <= 0 ? 0 : (valid < L ? valid : L);
}

// The ring: two tiles of `tw` words (a power of two), the tile at `base`
// in the half `half` = (base / tile) % 2 * tw.  Offsets below are relative
// to the current tile's start, in words (r) or bytes (b), -tile <= b.
__host__ __device__ __forceinline__ uint32_t& ring_word(uint32_t* ring, int half, int r, int tw) {
  return ring[(half + r) & (2 * tw - 1)];
}

__host__ __device__ __forceinline__ uint32_t ring_byte(const uint32_t* ring, int half, int b,
                                                      int tw) {
  return reinterpret_cast<const uint8_t*>(ring)[(4 * half + b) & (8 * tw - 1)];
}

// Bytes pr - sh .. pr - sh + 3 of the ring (pr 4-aligned) as a word, those
// below `lower` (4-aligned, >= -tile) read as 0.
__host__ __device__ __forceinline__ uint32_t ring_shifted(uint32_t* ring, int half, int pr, int sh,
                                                          int lower, int tw) {
  const int a = pr - sh;
  if (a <= lower - 4) return 0;
  const int r = a & 3, q = (a - r) / 4;   // the word holding byte a
  const uint32_t lo = 4 * q >= lower ? ring_word(ring, half, q, tw) : 0;
  if (r == 0) return lo;
  const uint32_t hi = ring_word(ring, half, q + 1, tw);   // 4 (q + 1) >= lower
  return (lo >> (8 * r)) | (hi << (32 - 8 * r));
}

// Word w of the tile at base (n of its bytes in the row) from the row into
// the ring; bytes past the row read as 0.  `al`: the row's address and L
// are 4-aligned.
__host__ __device__ __forceinline__ void delta_get(uint32_t* ring, int half, const uint8_t* row,
                                                   int64_t base, int n, int w, bool al, int tw) {
  const int pr = 4 * w;
  uint32_t v = 0;
  if (al && pr + 4 <= n) {
    v = *reinterpret_cast<const uint32_t*>(row + base + pr);
  } else {
    for (int k = 0; k < 4; ++k)
      if (pr + k < n) v |= (uint32_t)row[base + pr + k] << (8 * k);
  }
  ring_word(ring, half, w, tw) = v;
}

// One decode pass at shift sh (< the tile): word w's new value, the word
// plus the one sh bytes before it within the tile.
__host__ __device__ __forceinline__ uint32_t delta_pass(uint32_t* ring, int half, int sh, int w,
                                                        int tw) {
  return vadd4(ring_word(ring, half, w, tw), ring_shifted(ring, half, 4 * w, sh, 0, tw));
}

// Decode: word w after its carry, each byte i plus the output at
// base - dist + ((i - base) mod dist), the last of its class before the
// tile (0 before the lane's start): from the ring's other tile for
// dist <= tile, else from the output row.
__host__ __device__ __forceinline__ uint32_t delta_carry(uint32_t* ring, int half,
                                                         const uint8_t* out_row, int64_t base,
                                                         int64_t dist, int w, int tw) {
  const uint32_t own = ring_word(ring, half, w, tw);
  uint32_t c = 0;
  if (dist <= 4 * tw) {
    if (base == 0) return own;
    int m = (4 * w) % (int)dist;
    for (int k = 0; k < 4; ++k) {
      c |= ring_byte(ring, half, m - (int)dist, tw) << (8 * k);
      if (++m == dist) m = 0;
    }
  } else {
    for (int k = 0; k < 4; ++k) {
      const int64_t j = base + 4 * w + k - dist;
      if (j >= 0) c |= (uint32_t)out_row[j] << (8 * k);
    }
  }
  return vadd4(own, c);
}

// Encode: word w as d[i] - d[i - dist] (d[i] for i < dist), the shifted
// bytes from the ring for dist <= tile, else from the input row.
__host__ __device__ __forceinline__ uint32_t delta_encode(uint32_t* ring, int half,
                                                          const uint8_t* in_row, int64_t base,
                                                          int64_t dist, int w, int tw) {
  uint32_t s = 0;
  if (dist <= 4 * tw) {
    s = ring_shifted(ring, half, 4 * w, (int)dist, base == 0 ? 0 : -4 * tw, tw);
  } else {
    for (int k = 0; k < 4; ++k) {
      const int64_t j = base + 4 * w + k - dist;
      if (j >= 0) s |= (uint32_t)in_row[j] << (8 * k);
    }
  }
  return vsub4(ring_word(ring, half, w, tw), s);
}

// Word w of the tile at base into the output row: byte i (i < n, the
// tile's bytes in the row) is v's for i < end and the input's from end on.
__host__ __device__ __forceinline__ void delta_put(uint8_t* out_row, const uint8_t* in_row,
                                                   int64_t base, int n, int64_t end, int w,
                                                   uint32_t v, bool al) {
  const int pr = 4 * w;
  const int64_t i = base + pr;
  if (al && pr + 4 <= n && i + 4 <= end) {
    *reinterpret_cast<uint32_t*>(out_row + i) = v;
    return;
  }
  for (int k = 0; k < 4 && pr + k < n; ++k)
    out_row[i + k] = i + k < end ? (uint8_t)(v >> (8 * k)) : in_row[i + k];
}

// Bytes [from, L) of a lane copied as they are, word `t` of `threads`.
__host__ __device__ __forceinline__ void delta_copy(uint8_t* out_row, const uint8_t* in_row,
                                                    int64_t from, int64_t L, int t, int threads,
                                                    bool al) {
  if (al) {   // from is a multiple of the tile, so 4-aligned
    for (int64_t i = from + 4 * (int64_t)t; i < L; i += 4 * (int64_t)threads)
      *reinterpret_cast<uint32_t*>(out_row + i) = *reinterpret_cast<const uint32_t*>(in_row + i);
  } else {
    for (int64_t i = from + t; i < L; i += threads) out_row[i] = in_row[i];
  }
}

}  // namespace bra
}  // namespace lzt
