// LZMA range encode of dict-reset groups: one group's op records replayed
// through the adaptive model and the carry/cache range coder, the semantics
// of the JAX package's models/lzma/op_replay.py (LzmaEnc.c:456-573 range
// coder, :1733-1893 symbol coding).  range_encode.cu runs it as three
// launches on the card; cpu_harness.cc builds the very same code with g++
// and plays the threads in loops, so the tests can run it on a machine
// without a GPU.
//
// Op record (2 uint32 words, native encode_segment):
//   a = kind | (rep_index << 2) | (length << 4)
//       kind 0 literal, 1 match, 2 rep, 3 short rep; length is the full
//       length (1 for literals and short reps, 2..273 otherwise)
//   b = match: wire distance (dist - 1); rep / short rep: 0;
//       literal: sym | (prev << 8) | (match_byte << 16)
// Every bit value and probability index follows from the record, the state
// and the lane's position within its group, so the lane never reads the
// input data and never reads its own output.  Rep distances are never
// coded (a rep codes its index), so the lane does not track them.
//
// Contract of one lane (ops/range_encode.py shares it):
//   ops[0, op_cap)            the group's op words back to back
//   op_ends[0, n_chunks)      cumulative op-word end of each chunk; a chunk
//                             with no ops (padding repeats the last end)
//                             writes no body
//   out[0, out_cap)           the chunk bodies back to back
//   tab[0, n_chunks)          cumulative body end of each finished chunk
//   status                    ok, bytes written, err, bit calls
// The model (probabilities, state) carries across the chunks of the lane;
// each chunk starts a fresh range coder and ends with 5 ShiftLows, so its
// body begins with the coder's initial cache byte 0.  err: 1 = op_ends out
// of order, odd or past op_cap; 2 = an op record of impossible kind/length
// (the chunk keeps the bytes it put before that record and gets no final
// flush); 3 = the body would pass out_cap (the first out_cap bytes are
// written).  tab entries of unfinished chunks are left as they were.  Bit
// calls count direct bits, and only calls that begin before an error.
//
// How the work is split.  Only the probability values and the coder's
// range/low are serial; the state and the position are serial too, but
// cheap, and the state forgets (lookback_state).  Three facts make the rest
// parallel:
// * Every index and bit follows from the op, its state and its position.
// * A probability index always belongs to the same slot (a region of the
//   model and, in a tree, a level), and no two calls of one op share a
//   slot.  So a warp walks the model with one thread per slot, each making
//   every update of its indices in op order, with no barrier between ops.
// * Each chunk restarts the coder, and the coder needs only each call's
//   probability and bit, which the walk sees as it updates the model.
// Hence three steps over a scratch area per lane (scratch_layout):
//   walk    (one warp per lane) steps the model through the lane's ops a
//           batch at a time, validates the chunk table and the records,
//           writes each call's (probability, bit) -- the coder's stream --
//           and records each chunk's span of it and where the walk stopped;
//   code    (one warp per chunk) range-codes the chunk's stream into the
//           chunk's slot, thread 0 coding while the warp stages the stream
//           in shared memory; a group's chunks code in parallel;
//   gather  (one block per lane) sums the chunks' body lengths into tab,
//           copies the slots back to back into out, and writes the status;
//           where out_cap cuts a chunk it codes that chunk again from its
//           stream with a byte limit, which gives the exact bit calls.
// Steps of a warp are written over a thread index t in [thr.begin,
// thr.end): the card runs one t per thread, the host all of them in order;
// the same result, since no step reads what another thread writes in that
// step.
#pragma once

#include <stdint.h>

#include "lzma_lane.cuh"   // probability layout, Threads, Stage, warp primitives

namespace lzt {
namespace enc {

constexpr int kErrTable = 1;
constexpr int kErrOp = 2;
constexpr int kErrOverflow = 3;

// bytes a step reads from a Stage: a batch's op words (2 words for each of
// kT ops), or the 4 kT stream entries the coder takes between two ensures
constexpr uint32_t kAhead = 8 * kT;
constexpr int kGatherT = 256;                // threads of a gather block

// -- the scratch area of one lane ----------------------------------------------
//
//   walk     16 B        int32 err (0, 1, 2), stop chunk (n_chunks if none),
//                        op word of the bad record (err 2)
//   info     C x 16 B    per chunk (Info): its stream span (walk), its body
//                        length and bit calls (code)
//   stream   at most 25 uint16 entries per op, and at most 7 of padding per
//            batch; a chunk of n ops has at most n / 32 + 1 batches, so the
//            lane needs at most 50 + 7/16 bytes per op and 14 per chunk:
//            26 bytes per op word and 16 per chunk
//   slots    per chunk c at 32 c + round16(10 k_c), k_c its first op word.
//
// The slot bound.  A probability stays in [31, 2017] of 2048, so a bit
// leaves at least 31/2048 of range (2^-6.05), a direct bit half; the floor
// in range >> 11 (range >= 2^24 before a bit) costs less than a factor
// 1 + 2^-12.  An op has at most 22 probability bits and 26 direct bits:
// at most 22 * 6.05 + 26 + 48 * 2^-11 < 159.2 bits of range.  Each
// renormalisation shifts 8 bits and range starts at 2^32 - 1 and stays
// below 2^32, so a chunk of n ops renormalises at most floor(159.2 n / 8)
// < 20 n times; its bytes are at most the ShiftLows, < 20 n + 5.  From
// one slot's start to the next: 32 + round16(10 k_{c+1}) - round16(10 k_c)
// >= 32 + 10 (k_{c+1} - k_c) - 15 = 20 n + 17 bytes.  The lane needs
// round16(10 op_cap) + 32 C bytes of slots.
struct Layout {
  int64_t info, stream, slots, lane;   // offsets and the lane's stride (bytes)
  int64_t stream_bytes;
};

__host__ __device__ __forceinline__ int64_t round16(int64_t v) { return (v + 15) & ~15ll; }

__host__ __device__ inline Layout scratch_layout(int64_t op_cap, int n_chunks) {
  Layout L;
  L.info = 16;
  L.stream = L.info + 16 * (int64_t)n_chunks;
  L.stream_bytes = round16(26 * op_cap) + 16 * (int64_t)n_chunks;
  L.slots = L.stream + L.stream_bytes;
  L.lane = L.slots + round16(10 * op_cap) + 32 * (int64_t)n_chunks;
  return L;
}

__host__ __device__ __forceinline__ int64_t slot_offset(int c, uint32_t k0) {
  return 32 * (int64_t)c + round16(10 * (int64_t)k0);
}

// Word k of a Stage over uint32 words (bytes 4k to 4k + 4 have landed).
__host__ __device__ __forceinline__ uint32_t stage_word(const Stage& S, uint32_t k) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(S.buf + ((4 * k) & (kStageBuf - 1)));
#else
  uint32_t w;
  memcpy(&w, S.buf + ((4 * k) & (kStageBuf - 1)), 4);
  return w;
#endif
}

// -- the model step ------------------------------------------------------------

__host__ __device__ __forceinline__ bool op_valid(uint32_t a) {
  const uint32_t kind = a & 3, len = a >> 4;
  return (kind == 0 || kind == 3) ? len == 1 : (len >= 2 && len <= 273);
}

__host__ __device__ __forceinline__ uint32_t next_state(uint32_t kind, uint32_t s) {
  if (kind == 0) return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6);
  if (kind == 1) return s < 7 ? 7 : 10;
  if (kind == 2) return s < 7 ? 8 : 11;
  return s < 7 ? 9 : 11;
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

// -- a batch of ops ----------------------------------------------------------
//
// Every probability index has a fixed slot in [0, kSlots): the slot of its
// region and, in a tree, of its node's level (the kSlot* constants).  An op's calls take
// ascending slots, and no two calls of one op take the same slot.  The warp
// takes up to kBatch ops of one chunk at a time:
//   scan     thread i finds op i's state and position: the position as
//            the batch's start plus the lengths before op i; the state from
//            at most the 5 ops before it (lookback_state), since the state
//            machine forgets: the state after a match, rep or short rep
//            depends only on whether the op before it was a literal, and
//            three literals in a row always leave state 0;
//   expand   thread i writes op i's calls into row i of `Batch.e`, each at
//            its slot: (idx << 1) | bit with its position among the op's
//            stream entries in bits 16-20 for a probability bit, 1 << 31 |
//            n << 26 | value for n direct bits, kNone in the slots it does
//            not use; then each op's first entry in the batch's stream
//            (`Batch.off`, from the ops' entry counts);
//   update   thread j takes slot j of every op of the batch in order: loads,
//            adapts and stores the probability, and writes (p << 1) | bit
//            to its place in `Batch.list`, the batch's stream; then thread
//            i writes op i's direct bits there.  An index always lands in
//            the same slot, so one thread makes every update of it, in op
//            order: the threads need no barrier between the ops;
//   copy     the batch's stream, padded, to the lane's stream in the scratch
//            area with 16-byte stores.

constexpr int kBatch = kT;          // ops per batch
constexpr uint32_t kNone = 0xFFFFFFFFu;
// slots: isMatch; isRep or literal level 0; the rep choices (isRep0Long
// shares isRepG1's slot: an op takes one of them) and literal levels 1-7;
// the length choices and the length tree's levels; posSlot's levels; the
// direct bits; the reverse tree's levels (specPos or align)
constexpr int kSlotIsMatch = 0, kSlotLiteral = 1, kSlotIsRep = 1, kSlotG0 = 2,
              kSlotG1 = 3, kSlotRep0Long = 3, kSlotG2 = 4, kSlotChoice = 5,
              kSlotChoice2 = 6, kSlotLenTree = 7, kSlotPosSlot = 15, kSlotDirect = 21,
              kSlotReverse = 22, kSlots = 27;
constexpr int kRow = kSlots;        // words per op's row (odd: no bank conflicts)

// The coder's stream: one uint16 entry per probability bit, (p << 1) | bit,
// and the direct bits in entries of at most 10, most significant first,
// 0x8000 | n << 10 | value.  An op has at most 22 + 3 entries.  A batch's
// entries go to the stream padded with 0x8000 (no bits) to a multiple of 8,
// so every batch and every chunk starts 16 bytes aligned.
constexpr int kDirectPer = 10;
constexpr int kMaxEntries = 25;
constexpr int kQuad = 8;            // entries in 16 bytes
constexpr uint16_t kPad = 0x8000;

struct Batch {                      // shared memory of the walk
  uint32_t e[kBatch * kRow];
  uint32_t count[kBatch];           // per op: its entries
  uint32_t off[kBatch];             // per op: its first entry in `list`
  uint32_t direct[kBatch];          // per op: the position of its direct bits
  uint32_t len[kBatch];             // per op: its length (kNone: invalid record)
  uint32_t pos[kBatch];             // per op: its position less the batch's
  uint16_t list[kBatch * kMaxEntries + kQuad + kBatch];   // the batch's stream,
                                                         // padded; spare entries
};

struct Emit {
  uint32_t* row;
  uint32_t n;      // entries so far: the position of the next in the op's stream
};

// A probability bit at its slot: (idx << 1) | bit, and its position in the
// op's stream in bits 16-20.
__host__ __device__ __forceinline__ void emit(Emit& E, int slot, uint32_t idx, uint32_t b) {
  E.row[slot] = (idx << 1) | b | E.n++ << 16;
}

// A bit tree, most significant bit first; level i at slot + i.
__host__ __device__ __forceinline__ void emit_tree(Emit& E, int slot, uint32_t base,
                                                   int nbits, uint32_t sym) {
  uint32_t m = 1;
  for (int i = 0; i < nbits; ++i) {
    const uint32_t b = (sym >> (nbits - 1 - i)) & 1;
    emit(E, slot + i, base + m, b);
    m = (m << 1) | b;
  }
}

// A reverse bit tree, least significant bit first; level i at slot + i.
__host__ __device__ __forceinline__ void emit_reverse(Emit& E, int slot, uint32_t base,
                                                      int nbits, uint32_t sym) {
  uint32_t m = 1;
  for (int i = 0; i < nbits; ++i) {
    const uint32_t b = (sym >> i) & 1;
    emit(E, slot + i, base + m, b);
    m = (m << 1) | b;
  }
}

__host__ __device__ __forceinline__ void emit_len(Emit& E, uint32_t base, uint32_t ps,
                                                  uint32_t len) {
  const uint32_t sym = len - 2;
  emit(E, kSlotChoice, base, sym >= 8);
  if (sym < 8) {
    emit_tree(E, kSlotLenTree, base + kLenLow + (ps << 3), 3, sym);
  } else {
    emit(E, kSlotChoice2, base + kLenChoice2, sym >= 16);
    if (sym < 16)
      emit_tree(E, kSlotLenTree, base + kLenMid + (ps << 3), 3, sym - 8);
    else
      emit_tree(E, kSlotLenTree, base + kLenHigh, 8, sym - 16);
  }
}

// Op (a, b) at state `state` and group position `pos` as its calls, each
// at its slot (LzmaEnc.c:1733-1893 makes them in ascending slot order).
// Returns the op's stream entries; `direct` is the position of its direct
// bits' first entry.
__host__ __device__ inline uint32_t op_entries(uint32_t a, uint32_t b, uint32_t state,
                                               uint32_t pos, int lc, uint32_t lp_mask,
                                               uint32_t pb_mask, uint32_t* row,
                                               uint32_t& direct) {
  const uint32_t kind = a & 3, ri = (a >> 2) & 3, len = a >> 4;
  const uint32_t ps = pos & pb_mask;
  for (int j = 0; j < kSlots; ++j) row[j] = kNone;
  Emit E = {row, 0};
  emit(E, kSlotIsMatch, kIsMatch + (state << 4) + ps, kind != 0);
  if (kind == 0) {
    const uint32_t sym = b & 0xFF, prev = (b >> 8) & 0xFF;
    const uint32_t base = kLiteral + 0x300 * (((pos & lp_mask) << lc) + (prev >> (8 - lc)));
    if (state < 7) {
      emit_tree(E, kSlotLiteral, base, 8, sym);
    } else {   // matched literal: the byte at rep0 steers the model; level i's
               // index base + offs + bc + m has m in [2^i, 2^(i+1))
      uint32_t mb = (b >> 16) & 0xFF, offs = 0x100, m = 1;
      for (int i = 0; i < 8; ++i) {
        const uint32_t bb = (sym >> (7 - i)) & 1;
        mb <<= 1;
        const uint32_t bc = mb & offs;
        emit(E, kSlotLiteral + i, base + offs + bc + m, bb);
        m = (m << 1) | bb;
        offs &= bb ? bc : ~bc;
      }
    }
  } else if (kind == 1) {
    emit(E, kSlotIsRep, kIsRep + state, 0);
    emit_len(E, kLenCoder, ps, len);
    const uint32_t lt = len - 2 < 4 ? len - 2 : 3;
    const uint32_t slot = pos_slot(b);
    emit_tree(E, kSlotPosSlot, kPosSlot + (lt << 6), 6, slot);
    if (slot >= 4) {
      const int nd = (int)(slot >> 1) - 1;
      const uint32_t dbase = (2 | (slot & 1)) << nd;
      const uint32_t rem = b - dbase;
      if (slot < 14) {
        emit_reverse(E, kSlotReverse, kSpecPos + dbase - slot - 1, nd, rem);
      } else {
        row[kSlotDirect] = (1u << 31) | ((uint32_t)(nd - 4) << 26) | (rem >> 4);
        direct = E.n;
        E.n += (uint32_t)(nd - 4 + kDirectPer - 1) / kDirectPer;
        emit_reverse(E, kSlotReverse, kAlign, 4, rem & 15);
      }
    }
  } else {
    emit(E, kSlotIsRep, kIsRep + state, 1);
    if (kind == 3 || ri == 0) {
      emit(E, kSlotG0, kIsRepG0 + state, 0);
      emit(E, kSlotRep0Long, kIsRep0Long + (state << 4) + ps, kind == 2);
    } else {
      emit(E, kSlotG0, kIsRepG0 + state, 1);
      emit(E, kSlotG1, kIsRepG1 + state, ri >= 2);
      if (ri >= 2) emit(E, kSlotG2, kIsRepG2 + state, ri == 3);
    }
    if (kind == 2) emit_len(E, kRepLenCoder, ps, len);
  }
  return E.n;
}

// The state before op i of a batch that starts at op word k in state s_in:
// the ops from i - 4 on, from state s_in when they start the batch, else
// from 0 or 7 after a literal or not (the state after those 4 ops depends
// on nothing else, see above).
__host__ __device__ __forceinline__ uint32_t lookback_state(const Stage& S, uint32_t k,
                                                           uint32_t i, uint32_t s_in) {
  const uint32_t j0 = i > 4 ? i - 4 : 0;
  uint32_t s = i > 4 ? ((stage_word(S, k + 2 * (i - 5)) & 3) ? 7 : 0) : s_in;
  for (uint32_t j = j0; j < i; ++j) s = next_state(stage_word(S, k + 2 * j) & 3, s);
  return s;
}

// One batch from op word k, the chunk's ops ending at `end`: scans,
// expands and updates the model, and writes the batch's entries to the
// coder's stream from entry `spos` on.  Returns the ops taken; `bad` is set
// where the next op record is invalid.  state, pos and spos advance past
// the batch.
__host__ __device__ inline uint32_t model_batch(const Stage& S, uint32_t k, uint32_t end,
                                                uint32_t& state, uint32_t& pos, bool& bad,
                                                uint16_t* stream, uint32_t& spos, int lc,
                                                uint32_t lp_mask, uint32_t pb_mask,
                                                uint16_t* probs, uint32_t np, Batch& B,
                                                Threads thr) {
  const uint32_t room = (end - k) / 2;
  const uint32_t nmax = room < (uint32_t)kBatch ? room : (uint32_t)kBatch;
  for (int t = thr.begin; t < thr.end; ++t) {   // op t's length, or invalid
    if ((uint32_t)t >= nmax) continue;
    const uint32_t a = stage_word(S, k + 2 * t);
    B.len[t] = op_valid(a) ? a >> 4 : kNone;
  }
  warp_sync();
  uint32_t n = nmax, total = 0;
  for (int t = thr.begin; t < thr.end; ++t) {
    // the same n in every thread: the first invalid op; and op t's position
    uint32_t invalid = 0, len_t = 0;
#ifdef __CUDA_ARCH__
#pragma unroll 8
#endif
    for (uint32_t j = 0; j < nmax; ++j) {
      const uint32_t len = B.len[j];
      invalid |= (uint32_t)(len == kNone) << j;
      len_t += j < (uint32_t)t ? len : 0;
    }
#ifdef __CUDA_ARCH__
    n = invalid ? (uint32_t)__ffs(invalid) - 1 : nmax;
#else
    n = invalid ? (uint32_t)__builtin_ctz(invalid) : nmax;
#endif
    if ((uint32_t)t < n) {
      B.pos[t] = len_t;
      B.count[t] = op_entries(stage_word(S, k + 2 * t), stage_word(S, k + 2 * t + 1),
                              lookback_state(S, k, t, state), pos + len_t, lc, lp_mask,
                              pb_mask, B.e + t * kRow, B.direct[t]);
    }
  }
  warp_sync();
  bad = n < nmax;
  state = lookback_state(S, k, n, state);
  pos += n ? B.pos[n - 1] + B.len[n - 1] : 0;
  for (int t = thr.begin; t < thr.end; ++t) {   // each op's first entry
    uint32_t off = 0;
    total = 0;
    for (uint32_t i = 0; i < n; ++i) {
      off += i < (uint32_t)t ? B.count[i] : 0;
      total += B.count[i];
    }
    if ((uint32_t)t < n) B.off[t] = off;
  }
  warp_sync();
  // the updates; a slot an op does not use (or its direct bits) updates
  // the thread's own spare probability (after the model's np) and list
  // entry instead: no branch
  for (int t = thr.begin; t < thr.end; ++t) {
    if (t >= kSlots || n == 0) continue;
    const uint32_t spare = kBatch * kMaxEntries + kQuad + t;
    uint32_t q = B.e[t], off = B.off[0];
    for (uint32_t i = 0; i < n; ++i) {
      // the next op's entry is loaded ahead of this one's stores
      const uint32_t qn = i + 1 < n ? B.e[(i + 1) * kRow + t] : kNone;
      const uint32_t offn = i + 1 < n ? B.off[i + 1] : 0;
      const bool skip = q >> 31;
      const uint32_t idx = skip ? np + t : (q >> 1) & 0x7FFF, bit = q & 1, p = probs[idx];
      probs[idx] =
          (uint16_t)(bit ? p - (p >> kMoveBits) : p + ((kModelTotal - p) >> kMoveBits));
      B.list[skip ? spare : off + ((q >> 16) & 31)] = (uint16_t)((p << 1) | bit);
      q = qn;
      off = offn;
    }
  }
  warp_sync();
  for (int t = thr.begin; t < thr.end; ++t) {   // direct bits, thread per op
    const uint32_t q = (uint32_t)t < n ? B.e[t * kRow + kSlotDirect] : kNone;
    if (q == kNone) continue;
    const uint32_t nd = (q >> 26) & 31, v = q & 0x3FFFFFF;
    const uint32_t extra = (nd - 1) / kDirectPer, at = B.off[t] + B.direct[t];
    uint32_t r = nd - kDirectPer * extra;
    for (uint32_t x = 0; x <= extra; ++x) {
      const uint32_t sh = kDirectPer * (extra - x);
      B.list[at + x] = (uint16_t)(0x8000 | r << 10 | ((v >> sh) & ((1u << r) - 1)));
      r = kDirectPer;
    }
  }
  // the padding, then the batch to the stream
  const uint32_t padded = (total + kQuad - 1) & ~(uint32_t)(kQuad - 1);
  for (int t = thr.begin; t < thr.end; ++t)
    if (total + t < padded) B.list[total + t] = kPad;
  warp_sync();
  for (int t = thr.begin; t < thr.end; ++t)
    for (uint32_t i = kQuad * t; i < padded; i += kQuad * kT)
      store16((uint8_t*)(stream + spos + i), (const uint8_t*)(B.list + i));
  spos += padded;
  warp_sync();
  return n;
}

// -- the range coder (one thread) -------------------------------------------------

struct Coder {
  uint8_t* out;
  uint32_t limit;       // bytes it may put; the next one sets `over`
  uint32_t opos;        // bytes put
  uint64_t low;         // 33 bits used: bit 32 is the carry
  uint32_t range;
  uint32_t cache;       // the byte held back for a carry
  uint32_t cache_size;  // cache + the pending 0xFF bytes, no limit
  uint32_t bits;        // bit calls begun before `over`
  bool over;
};

__host__ __device__ __forceinline__ void coder_start(Coder& C, uint8_t* out, uint32_t limit) {
  C.out = out;
  C.limit = limit;
  C.opos = 0;
  C.low = 0;
  C.range = 0xFFFFFFFFu;
  C.cache = 0;
  C.cache_size = 1;
  C.bits = 0;
  C.over = false;
}

__host__ __device__ __forceinline__ void put(Coder& C, uint32_t byte) {
  if (C.over) return;
  if (C.opos >= C.limit) {
    C.over = true;
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

// One stream entry.  Bit calls count while `over` is clear: only the
// gather's second coding of a chunk that out_cap cuts reaches its limit.
__host__ __device__ __forceinline__ void code_entry(Coder& C, uint32_t q) {
  if (q & 0x8000) {   // direct bits, most significant first (none: padding)
    for (int d = (int)((q >> 10) & 31) - 1; d >= 0; --d) {
      C.bits += !C.over;
      C.range >>= 1;
      C.low += ((q >> d) & 1) ? C.range : 0;
      normalize(C);
    }
    return;
  }
  C.bits += !C.over;
  const uint32_t bound = (C.range >> kModelBits) * (q >> 1);
  C.low += (q & 1) ? bound : 0;
  C.range = (q & 1) ? C.range - bound : bound;
  normalize(C);
}

// Four words of a Stage from word j on (j a multiple of 4): one 16-byte load.
struct Quad {
  uint32_t x, y, z, w;
};

__host__ __device__ __forceinline__ Quad stage_quad(const Stage& S, uint32_t j) {
#ifdef __CUDA_ARCH__
  const uint4 v = *reinterpret_cast<const uint4*>(S.buf + ((4 * j) & (kStageBuf - 1)));
  return Quad{v.x, v.y, v.z, v.w};
#else
  return Quad{stage_word(S, j), stage_word(S, j + 1), stage_word(S, j + 2),
              stage_word(S, j + 3)};
#endif
}

// Codes stream entries [e0, e1), multiples of kQuad; the next 8 entries are
// loaded while these 8 are coded.
__host__ __device__ __forceinline__ void code_entries(Coder& C, const Stage& S, uint32_t e0,
                                                      uint32_t e1) {
  Quad q = stage_quad(S, e0 / 2);
  for (uint32_t j = e0 / 2; j < e1 / 2; j += 4) {
    const Quad next = stage_quad(S, j + 4);
    code_entry(C, q.x & 0xFFFF);
    code_entry(C, q.x >> 16);
    code_entry(C, q.y & 0xFFFF);
    code_entry(C, q.y >> 16);
    code_entry(C, q.z & 0xFFFF);
    code_entry(C, q.z >> 16);
    code_entry(C, q.w & 0xFFFF);
    code_entry(C, q.w >> 16);
    q = next;
  }
}

// -- the three steps ----------------------------------------------------------

struct Walk {
  int32_t err, stop_chunk, stop_k, pad;
};

struct Info {        // per chunk
  int32_t begin, end;   // its entries in the stream (walk)
  int32_t bytes, bits;  // its body's length and bit calls (code)
};

// Walk: the model through the lane's ops from the start, the coder's stream
// of every chunk it reached, and where it stopped.
__host__ __device__ inline void walk_lane(const uint32_t* ops, uint32_t op_cap,
                                          const int32_t* op_ends, int n_chunks,
                                          uint8_t* scratch, const Layout& L, uint16_t* probs,
                                          uint8_t* ring, Batch& B, int lc, int lp, int pb,
                                          Threads thr) {
  const int np = num_probs(lc, lp);
  const uint32_t lp_mask = (1u << lp) - 1, pb_mask = (1u << pb) - 1;
  for (int t = thr.begin; t < thr.end; ++t)
    for (int i = t; i < np + kT; i += kT) probs[i] = kProbInit;   // + the spares
  warp_sync();
  Stage S;
  stage_init(S, (const uint8_t*)ops, 4 * op_cap, ring, kAhead, thr);
  stage_seek(S, 0);
  Info* info = (Info*)(scratch + L.info);
  uint16_t* stream = (uint16_t*)(scratch + L.stream);
  uint32_t state = 0, pos = 0, k = 0, spos = 0;
  Walk w = {0, n_chunks, 0, 0};
  for (int c = 0; c < n_chunks && !w.err; ++c) {
    const int64_t end = op_ends[c];
    if (end < k || end > op_cap || (end & 1)) {
      w.err = kErrTable;
      w.stop_chunk = c;
      break;
    }
    if (end == k) continue;
    const uint32_t begin = spos;
    while (k < (uint32_t)end) {
      stage_ensure(S, 4 * k);
      bool bad;
      k += 2 * model_batch(S, k, (uint32_t)end, state, pos, bad, stream, spos, lc, lp_mask,
                           pb_mask, probs, (uint32_t)np, B, thr);
      if (bad) {
        w.err = kErrOp;
        w.stop_chunk = c;
        w.stop_k = (int32_t)k;
        break;
      }
    }
    if (thr.begin == 0) {
      info[c].begin = (int32_t)begin;
      info[c].end = (int32_t)spos;
    }
  }
  stage_wait(S, 0);
  if (thr.begin == 0) *(Walk*)scratch = w;
}

// The first op word of chunk c and the end of the ops the lane coded in it
// (the bad record for err 2), from a walk that reached the chunk.
__host__ __device__ __forceinline__ void chunk_span(const int32_t* op_ends, int c,
                                                    const Walk& w, uint32_t& k0,
                                                    uint32_t& k1) {
  k0 = c ? (uint32_t)op_ends[c - 1] : 0;
  k1 = c == w.stop_chunk ? (uint32_t)w.stop_k : (uint32_t)op_ends[c];
}

// Codes stream entries [e0, e1) of a lane into out (at most `limit` bytes;
// 0xFFFFFFFF: no limit), with the final flush if `flush`; the warp stages
// the stream, thread 0 codes and holds the result.
__host__ __device__ inline Coder code_chunk(const uint8_t* scratch, const Layout& L,
                                            uint32_t e0, uint32_t e1, bool flush,
                                            uint8_t* out, uint32_t limit, uint8_t* ring,
                                            Threads thr) {
  Stage S;
  stage_init(S, scratch + L.stream, (uint32_t)L.stream_bytes, ring, kAhead, thr);
  stage_seek(S, 2 * e0);
  const bool lead = thr.begin == 0;
  Coder C;
  coder_start(C, out, limit);
  for (uint32_t e = e0; e < e1;) {
    stage_ensure(S, 2 * e);   // entries [e, e + 4 kT) have landed
    const uint32_t stop = e + 4 * kT;
    const uint32_t e2 = e1 < stop ? e1 : stop;
    if (lead) code_entries(C, S, e, e2);
    warp_sync();
    e = e2;
  }
  if (lead && flush)
    for (int i = 0; i < 5; ++i) shift_low(C);
  stage_wait(S, 0);
  return C;
}

// Code: chunk c of a lane, if the walk reached it and it has ops, into its
// slot; its bytes and bit calls go to the lane's info.
__host__ __device__ inline void code_lane_chunk(const int32_t* op_ends, int c,
                                                uint8_t* scratch, const Layout& L,
                                                uint8_t* ring, Threads thr) {
  const Walk w = *(const Walk*)scratch;
  if (c > w.stop_chunk || (c == w.stop_chunk && w.err != kErrOp)) return;
  uint32_t k0, k1;
  chunk_span(op_ends, c, w, k0, k1);
  if (k1 <= k0) return;
  Info* info = (Info*)(scratch + L.info) + c;
  const Coder C = code_chunk(scratch, L, (uint32_t)info->begin, (uint32_t)info->end,
                             c != w.stop_chunk, scratch + L.slots + slot_offset(c, k0),
                             0xFFFFFFFFu, ring, thr);
  if (thr.begin == 0) {
    info->bytes = (int32_t)C.opos;
    info->bits = (int32_t)C.bits;
  }
}

struct Status {
  int32_t ok, bytes, err, bits;
};

// Gather: the lane's bodies back to back into out, tab and the status, as
// the serial coder leaves them.  thr ranges over [0, kGatherT); where
// out_cap cuts a chunk, threads [0, kT) code it again with that limit.
__host__ __device__ inline Status gather_lane(const int32_t* op_ends, uint8_t* out,
                                              uint32_t out_cap, int32_t* tab,
                                              const uint8_t* scratch, const Layout& L,
                                              uint8_t* ring, Threads thr) {
  const Walk w = *(const Walk*)scratch;
  Status s = {0, 0, w.err, 0};
  uint32_t cum = 0, bits = 0;
  const int last = w.err == kErrOp ? w.stop_chunk : w.stop_chunk - 1;
  for (int c = 0; c <= last; ++c) {
    uint32_t k0, k1;
    chunk_span(op_ends, c, w, k0, k1);
    const Info& info = ((const Info*)(scratch + L.info))[c];
    const uint32_t n = k1 > k0 ? (uint32_t)info.bytes : 0;
    if (n > out_cap - cum) {   // out_cap cuts this chunk: code it again
      Threads warp = {thr.begin, thr.end < kT ? thr.end : kT};
      if (warp.begin < warp.end) {
        const Coder C = code_chunk(scratch, L, (uint32_t)info.begin, (uint32_t)info.end,
                                   c != w.stop_chunk, out + cum, out_cap - cum, ring, warp);
        bits += C.bits;
      }
      s.err = kErrOverflow;
      cum = out_cap;
      break;
    }
    const uint8_t* slot = scratch + L.slots + slot_offset(c, k0);
    for (int t = thr.begin; t < thr.end; ++t) {
#ifdef __CUDA_ARCH__
#pragma unroll 4
#endif
      for (uint32_t i = t; i < n; i += kGatherT) out[cum + i] = slot[i];
    }
    cum += n;
    bits += k1 > k0 ? (uint32_t)info.bits : 0;
    if (c != w.stop_chunk && thr.begin == 0) tab[c] = (int32_t)cum;
  }
  s.ok = s.err == 0;
  s.bytes = (int32_t)cum;
  s.bits = (int32_t)bits;
  return s;
}

}  // namespace enc
}  // namespace lzt
