// Per-lane LZMA2 group decode: the serial range decoder of
// models/lzma/decoder_ref.py (LzmaDec.c:131-426 semantics) walking one
// lane's chunk table, run by the 32 threads of one warp.  group_decode.cu
// runs it as the body of a one-warp block; cpu_harness.cc builds the very
// same code with g++ and plays the 32 threads in a loop, so the tests can
// run it on a machine without a GPU.
//
// Contract of one lane (the scheduler and ops/group_decode.py share it):
//   src[0, pack_cap)         the group's chunk bodies back to back
//   pe/ue/fl[0, n_chunks)    cumulative pack ends, unpack ends, flag bits:
//                            bit0 valid (padding entries are 0 and skipped),
//                            bit1 reset probs/state/reps,
//                            bit2 uncompressed copy chunk,
//                            bit3 rebase the dictionary (dbase = outpos)
//   out[0, dic_cap)          the lane's dictionary and output
// Chunk 0 starts fresh without bit1.  ok = no error, and the lane ended at
// the last entry's cumulative ends.  A lane stops at its first error: it
// consumes no more input and writes no more output after it, so `consumed`
// and `out` of a failed lane are defined too.  pack_cap and dic_cap are
// below 2^31, so positions are 32-bit.
//
// How a warp runs a lane.  Every thread runs the scalar decoder with the
// same values, so control flow stays uniform inside the warp: a probability
// is read as a shared-memory broadcast and every thread stores the same
// updated value.  The threads split the work only where bytes move -- match
// copies, input refills, copy chunks, output flushes, model resets -- in
// loops over a thread index t in [0, kT); each such step begins and ends
// with warp_sync().  Threads{t, t + 1} plays one thread (the card),
// Threads{0, kT} all of them in order (the host): the same result, since no
// step reads what another thread writes in that step.
//
// Memory of a lane (shared memory on the card):
//   probs   the model, num_probs(lc, lp) uint16
//   inbuf   kStageBuf bytes staging the packed input (a Stage, below).
//           The check runs once per packet, not per byte: a packet reads
//           fewer than kPacketBytes
//   ring    the last `window` output bytes, the dictionary window, a power
//           of two >= kMinWindow, in two segments of window / 2.  Output
//           reaches `out` only by flushes: of a segment as soon as the
//           decoder has filled it, and of the partial last one when the lane
//           ends, failed or not.  A byte at distance d is read from the ring
//           while d <= window (d <= window - len for a match of len bytes),
//           else from `out`, where it already is (see copy_match).
#pragma once

#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

// Loops of bit calls stay rolled on the card, but for the literal's: it is
// most packets, and unrolled it runs 5% faster (the others gain nothing).
#ifdef __CUDA_ARCH__
#define LZT_ROLLED _Pragma("unroll 1")
#define LZT_UNROLLED _Pragma("unroll")
#else
#define LZT_ROLLED
#define LZT_UNROLLED
#endif

namespace lzt {

constexpr uint32_t kTop = 1u << 24;
constexpr int kModelBits = 11;
constexpr uint32_t kModelTotal = 1u << kModelBits;
constexpr int kMoveBits = 5;
constexpr uint16_t kProbInit = 1024;

// probability-array layout of models/lzma/spec.py
constexpr int kIsMatch = 0;
constexpr int kIsRep = kIsMatch + (12 << 4);
constexpr int kIsRepG0 = kIsRep + 12;
constexpr int kIsRepG1 = kIsRepG0 + 12;
constexpr int kIsRepG2 = kIsRepG1 + 12;
constexpr int kIsRep0Long = kIsRepG2 + 12;
constexpr int kPosSlot = kIsRep0Long + (12 << 4);
constexpr int kSpecPos = kPosSlot + 4 * 64;
constexpr int kAlign = kSpecPos + 114;
constexpr int kLenCoder = kAlign + 16;
constexpr int kNumLenProbs = 2 + 16 * 8 + 16 * 8 + 256;
constexpr int kRepLenCoder = kLenCoder + kNumLenProbs;
constexpr int kLiteral = kRepLenCoder + kNumLenProbs;
static_assert(kLiteral == 1846, "LzmaDec.c:107-110 base probability count");
constexpr int kLenChoice2 = 1;
constexpr int kLenLow = 2;
constexpr int kLenMid = kLenLow + 16 * 8;
constexpr int kLenHigh = kLenMid + 16 * 8;

constexpr int kFlagValid = 1;
constexpr int kFlagReset = 2;
constexpr int kFlagCopy = 4;
constexpr int kFlagRebase = 8;

__host__ __device__ __forceinline__ int num_probs(int lc, int lp) {
  return kLiteral + (0x300 << (lc + lp));
}

constexpr int kT = 32;                     // threads of one lane (a warp)
constexpr uint32_t kMaxLen = 273;          // longest match
constexpr uint32_t kPiece = 512;           // staging (Stage): a ring of
constexpr uint32_t kStageBuf = 4 * kPiece; // four pieces
// more than the input bytes of a packet: at most 48 bit calls (a match:
// 1 + 1 + 10 + 6 + 26 + 4), each of which reads at most one byte
constexpr uint32_t kPacketBytes = 64;
constexpr uint32_t kMinWindow = 2048;      // see copy_match: >= 4 * kMaxLen

struct Threads {
  int begin, end;   // the thread indices t in [0, kT) this caller plays
};

// A row of global memory that a warp reads forward, staged in shared memory
// through a ring of four pieces of kPiece bytes: the piece the reader is in
// and the next have landed, and a third is in flight (cp.async on the card),
// requested when the reader enters the second.  K1 stages a lane's packed
// input through it, K2 a lane's op words and a chunk's coder stream.
struct Stage {
  const uint8_t* src;   // the row (global)
  uint32_t cap;         // its bytes
  uint8_t* buf;         // kStageBuf bytes
  uint32_t ahead;       // bytes a step reads from its position on, <= kPiece
  uint32_t ready;       // bytes below this have landed in buf
  bool src16;           // row 16-byte aligned: 16-byte copies
  Threads thr;
  uint32_t pending[3];  // the host's requested pieces, not yet copied
  int n_pending;
};

struct Lane {
  Stage input;          // the lane's packed bytes, src[0, pack_cap)
  uint8_t* out;         // the lane's output row (global)
  uint16_t* probs;
  uint8_t* ring;
  uint32_t window, mask, seg;
  bool out16;           // row 16-byte aligned: 16-byte copies
  Threads thr;
  uint32_t in;          // next input byte
  uint32_t in_end;      // end of the current chunk's bytes
  uint32_t pos;         // output position
  uint32_t dbase;       // output position of the last dictionary reset
  uint32_t flushed;     // out[0, flushed) is written; a multiple of seg
  uint32_t range, code;
  uint32_t state, rep0, rep1, rep2, rep3;
  uint32_t prev;        // the last output byte
  uint32_t bits;        // range-coder bit calls (direct bits included)
  bool err;
};

// -- the warp's primitives (plain code on the host) -------------------------

__host__ __device__ __forceinline__ void warp_sync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// 16 bytes global -> shared without waiting for them (cp.async)
__host__ __device__ __forceinline__ void copy16_async(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

// 16 bytes shared -> global
__host__ __device__ __forceinline__ void store16(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

// -- staging ------------------------------------------------------------------

// Copies piece k of the row, src[k * kPiece, +kPiece) cut at cap, into its
// slot of buf; with cp.async the 16-byte parts land at a wait.
__host__ __device__ inline void stage_copy(Stage& S, uint32_t k) {
  uint8_t* dst = S.buf + (k & 3) * kPiece;
  const uint32_t lo = k * kPiece;
  const uint32_t left = lo < S.cap ? S.cap - lo : 0;
  const uint32_t n = left < kPiece ? left : kPiece;
  const uint32_t n16 = S.src16 ? n & ~15u : 0;
  for (int t = S.thr.begin; t < S.thr.end; ++t) {
    for (uint32_t i = 16 * t; i < n16; i += 16 * kT) copy16_async(dst + i, S.src + lo + i);
    for (uint32_t i = n16 + t; i < n; i += kT) dst[i] = S.src[lo + i];
  }
}

// Requests piece k as one copy group.  The host copies it only at the wait
// that needs it, as late as the card may, so a piece read before its wait
// shows in the tests.
__host__ __device__ inline void stage_fetch(Stage& S, uint32_t k) {
#ifdef __CUDA_ARCH__
  stage_copy(S, k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#else
  S.pending[S.n_pending++] = k;
#endif
}

// Waits for every requested piece but the `keep` (0 or 1) newest.
__host__ __device__ __forceinline__ void stage_wait(Stage& S, int keep) {
#ifdef __CUDA_ARCH__
  if (keep)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#else
  const int copy = S.n_pending > keep ? S.n_pending - keep : 0;
  for (int i = 0; i < copy; ++i) stage_copy(S, S.pending[i]);
  for (int i = copy; i < S.n_pending; ++i) S.pending[i - copy] = S.pending[i];
  S.n_pending -= copy;
#endif
}

__host__ __device__ inline void stage_init(Stage& S, const uint8_t* src, uint32_t cap,
                                           uint8_t* buf, uint32_t ahead, Threads thr) {
  S.src = src;
  S.cap = cap;
  S.buf = buf;
  S.ahead = ahead;
  S.ready = 0;
  S.src16 = ((uintptr_t)src & 15) == 0;
  S.thr = thr;
  S.n_pending = 0;
}

// Stages the row from byte p on: the piece of p and the next landed, the
// one after in flight (at the start, and in K1 after a copy chunk, which
// reads its bytes from src directly).
__host__ __device__ inline void stage_seek(Stage& S, uint32_t p) {
  stage_wait(S, 0);
  warp_sync();
  const uint32_t k = p / kPiece;
  for (uint32_t i = 0; i < 3; ++i) stage_fetch(S, k + i);
  stage_wait(S, 1);
  warp_sync();
  S.ready = (k + 2) * kPiece;
}

// Before a step that reads at most `ahead` bytes from p on and moves p at
// most as far: those bytes have landed.  When they have not, p is in the
// second landed piece, so the piece before it is free: the piece in flight
// is waited for and the next one requested into that slot.
__host__ __device__ __forceinline__ void stage_ensure(Stage& S, uint32_t p) {
  if (p + S.ahead > S.ready) {
    warp_sync();
    stage_fetch(S, S.ready / kPiece + 1);
    stage_wait(S, 1);
    warp_sync();
    S.ready += kPiece;
  }
}

// Byte p, below `ready`.
__host__ __device__ __forceinline__ uint32_t stage_byte(const Stage& S, uint32_t p) {
  return S.buf[p & (kStageBuf - 1)];
}

// -- range decoder ------------------------------------------------------------

// An input overrun (the chunk's bytes ran out mid-symbol) sets err and
// leaves range and in as they are.  Errors are lazy: the packet runs on to
// its end on what it decodes (every loop is bounded, every index stays
// inside the model and the lane) and is checked once before it writes
// anything, so in, out and the failure are those of a decoder that stops
// at the overrun.  Selects, not branches: the staged byte at `in` is read
// whether it is taken or not.
__host__ __device__ __forceinline__ void normalize(Lane& L) {
  const bool need = L.range < kTop;
  const bool take = need & (L.in < L.in_end);
  const uint32_t byte = stage_byte(L.input, L.in);
  L.err |= need & !take;
  L.range = take ? L.range << 8 : L.range;
  L.code = take ? (L.code << 8) | byte : L.code;
  L.in += take;
}

// Written with selects, not branches: the bit's outcome picks values.
__host__ __device__ __forceinline__ uint32_t bit(Lane& L, uint32_t idx) {
  normalize(L);
  ++L.bits;
  const uint32_t p = L.probs[idx];
  const uint32_t bound = (L.range >> kModelBits) * p;
  const uint32_t b = L.code >= bound;
  L.range = b ? L.range - bound : bound;
  L.code = b ? L.code - bound : L.code;
  L.probs[idx] = (uint16_t)(b ? p - (p >> kMoveBits) : p + ((kModelTotal - p) >> kMoveBits));
  return b;
}

__host__ __device__ __forceinline__ uint32_t tree(Lane& L, uint32_t base, int nbits) {
  uint32_t m = 1;
  LZT_ROLLED
  for (int i = 0; i < nbits; ++i) m = (m << 1) | bit(L, base + m);
  return m - (1u << nbits);
}

__host__ __device__ __forceinline__ uint32_t tree_reverse(Lane& L, uint32_t base,
                                                          int nbits) {
  uint32_t m = 1, sym = 0;
  LZT_ROLLED
  for (int i = 0; i < nbits; ++i) {
    const uint32_t b = bit(L, base + m);
    m = (m << 1) | b;
    sym |= b << i;
  }
  return sym;
}

__host__ __device__ __forceinline__ uint32_t direct_bits(Lane& L, int n) {
  uint32_t res = 0;
  for (int i = 0; i < n; ++i) {
    normalize(L);
    ++L.bits;
    L.range >>= 1;
    L.code -= L.range;
    const uint32_t t = 0u - (L.code >> 31);
    L.code += L.range & t;
    res = (res << 1) + (t + 1);
  }
  return res;
}

// match length 2..273 (reference length-coder grammar)
__host__ __device__ __forceinline__ uint32_t decode_len(Lane& L, uint32_t base,
                                                        uint32_t pos_state) {
  if (!bit(L, base)) return 2 + tree(L, base + kLenLow + (pos_state << 3), 3);
  if (!bit(L, base + kLenChoice2)) return 10 + tree(L, base + kLenMid + (pos_state << 3), 3);
  return 18 + tree(L, base + kLenHigh, 8);
}

// -- the dictionary window ----------------------------------------------------

// The output byte at distance d (1 <= d <= pos - dbase).
__host__ __device__ __forceinline__ uint32_t byte_back(const Lane& L, uint32_t d) {
  return d <= L.window ? L.ring[(L.pos - d) & L.mask] : L.out[L.pos - d];
}

// One byte written by every thread alike.
__host__ __device__ __forceinline__ void put(Lane& L, uint32_t b) {
  L.ring[L.pos & L.mask] = (uint8_t)b;
  L.prev = b;
  ++L.pos;
}

// Writes out[flushed, end) from the ring, 16 bytes a thread where the row
// allows.  The range lies inside one segment of the ring.
__host__ __device__ inline void flush(Lane& L, uint32_t end) {
  warp_sync();
  const uint32_t a = L.flushed, n = end - a;
  const uint8_t* s = L.ring + (a & L.mask);
  uint8_t* d = L.out + a;
  const uint32_t n16 = L.out16 ? n & ~15u : 0;
  for (int t = L.thr.begin; t < L.thr.end; ++t) {
    for (uint32_t i = 16 * t; i < n16; i += 16 * kT) store16(d + i, s + i);
    for (uint32_t i = n16 + t; i < n; i += kT) d[i] = s[i];
  }
  warp_sync();
  L.flushed = end;
}

// Segment bookkeeping after each packet.  At a packet's start pos - flushed
// < seg, so its at most kMaxLen bytes overwrite ring slots of bytes below
// pos + kMaxLen - window < flushed: bytes already in out.
__host__ __device__ __forceinline__ void flush_full_segment(Lane& L) {
  if (L.pos - L.flushed >= L.seg) flush(L, L.flushed + L.seg);
}

// A match: byte j of len at distance d is byte pos - d + (j mod d), always
// below pos, so the bytes are independent even where the match overlaps
// itself, and the threads copy them 32 at a time.
// Near (d <= window - len): every source slot holds its byte, and no slot
// written here is a source slot (that would need d > window - len).
// Far: then d > window - len > len, so source bytes are below
// pos - d + len < pos - window + 2 * kMaxLen <= pos - seg < flushed, since
// seg = window / 2 >= 2 * kMaxLen: they are in out.
__host__ __device__ inline void copy_match(Lane& L, uint32_t d, uint32_t len) {
  warp_sync();
  const uint32_t p = L.pos, s = p - d, m = L.mask;
  uint8_t* r = L.ring;
  for (int t = L.thr.begin; t < L.thr.end; ++t) {
    if (d > L.window - len) {
      for (uint32_t j = t; j < len; j += kT) r[(p + j) & m] = L.out[s + j];
    } else if (d >= len) {
      for (uint32_t j = t; j < len; j += kT) r[(p + j) & m] = r[(s + j) & m];
    } else {
      for (uint32_t j = t; j < len; j += kT) r[(p + j) & m] = r[(s + j % d) & m];
    }
  }
  warp_sync();
  L.prev = r[(p + len - 1) & m];
  L.pos = p + len;
}

// An uncompressed chunk of n bytes from src[in] to out[pos], through the
// ring, one piece up to the end of the current segment at a time.
__host__ __device__ inline void copy_chunk(Lane& L, uint32_t n) {
  while (n) {
    const uint32_t room = L.flushed + L.seg - L.pos;
    const uint32_t k = n < room ? n : room;
    const uint32_t p = L.pos, i0 = L.in;
    warp_sync();
    for (int t = L.thr.begin; t < L.thr.end; ++t)
      for (uint32_t j = t; j < k; j += kT) L.ring[(p + j) & L.mask] = L.input.src[i0 + j];
    warp_sync();
    L.prev = L.ring[(p + k - 1) & L.mask];
    L.pos += k;
    L.in += k;
    n -= k;
    flush_full_segment(L);
  }
  stage_seek(L.input, L.in);
}

__host__ __device__ inline void reset_model(Lane& L, int np) {
  warp_sync();
  for (int t = L.thr.begin; t < L.thr.end; ++t)
    for (int i = t; i < np; i += kT) L.probs[i] = kProbInit;
  warp_sync();
  L.state = 0;
  L.rep0 = L.rep1 = L.rep2 = L.rep3 = 0;
}

// -- packets and chunks -------------------------------------------------------

// One packet (literal, match, rep or short rep).  Returns false on error.
__host__ __device__ __forceinline__ bool packet(Lane& L, uint32_t out_end, int lc,
                                                uint32_t lp_mask, uint32_t pb_mask) {
  const uint32_t ctx = L.pos - L.dbase;   // position since the dict reset
  const uint32_t ps = ctx & pb_mask;
  if (!bit(L, kIsMatch + (L.state << 4) + ps)) {
    const uint32_t prev = ctx ? L.prev : 0;
    const uint32_t base = kLiteral + 0x300 * (((ctx & lp_mask) << lc) + (prev >> (8 - lc)));
    uint32_t sym = 1;
    if (L.state < 7) {
      LZT_UNROLLED
      for (int i = 0; i < 8; ++i) sym = (sym << 1) | bit(L, base + sym);
    } else {
      if (L.rep0 >= ctx) return false;
      uint32_t mb = byte_back(L, L.rep0 + 1);
      uint32_t offs = 0x100;
      LZT_ROLLED
      while (sym < 0x100) {
        mb <<= 1;
        const uint32_t bc = mb & offs;
        const uint32_t b = bit(L, base + offs + bc + sym);
        sym = (sym << 1) | b;
        offs &= b ? bc : ~bc;
      }
    }
    if (L.err) return false;
    put(L, sym & 0xFF);
    L.state = L.state < 4 ? 0 : (L.state < 10 ? L.state - 3 : L.state - 6);
    return true;
  }
  const uint32_t rep = bit(L, kIsRep + L.state);
  if (rep) {
    if (ctx == 0) return false;
    if (!bit(L, kIsRepG0 + L.state)) {
      if (!bit(L, kIsRep0Long + (L.state << 4) + ps)) {
        if (L.rep0 >= ctx) return false;
        const uint32_t b = byte_back(L, L.rep0 + 1);
        if (L.err) return false;
        put(L, b);
        L.state = L.state < 7 ? 9 : 11;
        return true;
      }
    } else {
      uint32_t dist;
      if (!bit(L, kIsRepG1 + L.state)) {
        dist = L.rep1;
      } else {
        if (!bit(L, kIsRepG2 + L.state)) {
          dist = L.rep2;
        } else {
          dist = L.rep3;
          L.rep3 = L.rep2;
        }
        L.rep2 = L.rep1;
      }
      L.rep1 = L.rep0;
      L.rep0 = dist;
    }
  } else {
    L.rep3 = L.rep2;
    L.rep2 = L.rep1;
    L.rep1 = L.rep0;
  }
  const uint32_t len = decode_len(L, rep ? kRepLenCoder : kLenCoder, ps);
  if (rep) {
    L.state = L.state < 7 ? 8 : 11;
  } else {
    L.state = L.state < 7 ? 7 : 10;
    const uint32_t lps = len - 2 < 4 ? len - 2 : 3;
    const uint32_t slot = tree(L, kPosSlot + (lps << 6), 6);
    uint32_t dist = slot;
    if (slot >= 4) {
      const int nd = (int)(slot >> 1) - 1;
      dist = (2 | (slot & 1)) << nd;
      if (slot < 14) {
        dist += tree_reverse(L, kSpecPos + dist - slot - 1, nd);
      } else {
        dist += direct_bits(L, nd - 4) << 4;
        dist += tree_reverse(L, kAlign, 4);
      }
    }
    if (dist == 0xFFFFFFFFu) return false;   // end marker inside a sized chunk
    L.rep0 = dist;
  }
  if (L.err) return false;
  if (L.rep0 >= ctx) return false;           // distance beyond the dictionary
  if (len > out_end - L.pos) return false;   // match past the chunk's end
  copy_match(L, L.rep0 + 1, len);
  return true;
}

struct LaneStatus {
  int32_t ok, consumed, iterations, bit_calls;
};

// Decodes one lane's chunk list.  probs holds num_probs(lc, lp) entries,
// inbuf kStageBuf bytes, ring `window` bytes (a power of two >= kMinWindow).
// Every thread of the lane returns the same status.
__host__ __device__ inline LaneStatus decode_lane(
    const uint8_t* src, uint32_t pack_cap, const int32_t* pe, const int32_t* ue,
    const int32_t* fl, int n_chunks, uint8_t* out, uint32_t dic_cap,
    uint16_t* probs, uint8_t* inbuf, uint8_t* ring, uint32_t window, int lc,
    int lp, int pb, Threads thr) {
  const int np = num_probs(lc, lp);
  const uint32_t lp_mask = (1u << lp) - 1, pb_mask = (1u << pb) - 1;
  Lane L;
  stage_init(L.input, src, pack_cap, inbuf, kPacketBytes, thr);
  L.out = out;
  L.probs = probs;
  L.ring = ring;
  L.window = window;
  L.mask = window - 1;
  L.seg = window / 2;
  L.out16 = ((uintptr_t)out & 15) == 0;
  L.thr = thr;
  L.in = L.in_end = 0;
  L.pos = L.dbase = L.flushed = 0;
  L.range = L.code = 0;
  L.prev = 0;
  L.bits = 0;
  L.err = false;
  reset_model(L, np);
  stage_seek(L.input, 0);
  int32_t iters = 0;
  for (int j = 0; j < n_chunks && !L.err; ++j) {
    const int f = fl[j];
    if (!(f & kFlagValid)) continue;
    const int64_t pend = pe[j], uend = ue[j];
    if (pend < L.in || pend > pack_cap || uend < L.pos || uend > dic_cap) {
      L.err = true;
      break;
    }
    if (f & kFlagRebase) L.dbase = L.pos;
    if (f & kFlagReset) reset_model(L, np);
    if (f & kFlagCopy) {
      if (pend - L.in != uend - L.pos) {
        L.err = true;
        break;
      }
      copy_chunk(L, (uint32_t)(uend - L.pos));
      continue;
    }
    // range coder init from the chunk's 5 header bytes; the first must be 0
    stage_ensure(L.input, L.in);
    if (pend - L.in < 5 || stage_byte(L.input, L.in) != 0) {
      L.err = true;
      break;
    }
    L.code = 0;
    for (int k = 1; k <= 4; ++k) L.code = (L.code << 8) | stage_byte(L.input, L.in + k);
    L.range = 0xFFFFFFFFu;
    L.in += 5;
    L.in_end = (uint32_t)pend;
    const uint32_t out_end = (uint32_t)uend;
    while (L.pos < out_end) {
      ++iters;
      stage_ensure(L.input, L.in);
      if (!packet(L, out_end, lc, lp_mask, pb_mask)) {
        L.err = true;
        break;
      }
      flush_full_segment(L);
    }
    if (L.err) break;
    // trailing renormalize (LzmaDec.c:412): exact input consumption
    if (L.range < kTop && L.in < pend) {
      L.range <<= 8;
      L.code = (L.code << 8) | stage_byte(L.input, L.in++);
    }
    if (L.in != pend) L.err = true;
  }
  flush(L, L.pos);
  stage_wait(L.input, 0);
  LaneStatus s;
  s.ok = !L.err && L.pos == (uint32_t)ue[n_chunks - 1] && L.in == (uint32_t)pe[n_chunks - 1];
  s.consumed = (int32_t)L.in;
  s.iterations = iters;
  s.bit_calls = (int32_t)L.bits;
  return s;
}

}  // namespace lzt
