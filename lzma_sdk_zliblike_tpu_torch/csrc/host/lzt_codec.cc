// lzt_codec.cc — native host engine for the TPU-LZMA framework.
//
// From-scratch C++ implementation of the scalar LZMA codec (decode+encode),
// LZMA2 framing, and CRC kernels, exposed through a small C ABI consumed via
// ctypes (lzma_sdk_zliblike_tpu/native.py).  This is the framework's fast
// host path — the role the reference's C plays (LzmaDec.c/LzmaEnc.c/
// Lzma2*.c as behavioral parity targets; the code here shares no structure
// with them).  The encoder mirrors the Python reference encoder's decisions
// exactly (same hash chains, same lazy heuristics) so the two backends are
// byte-for-byte cross-checkable.

#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace lzt {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;

// SRes-compatible status codes (Types.h:25-43)
enum Status {
  OK = 0,
  ERR_DATA = 1,
  ERR_MEM = 2,
  ERR_UNSUPPORTED = 4,
  ERR_PARAM = 5,
  ERR_INPUT_EOF = 6,
  ERR_OUTPUT_EOF = 7,
  // internal (never crosses the C ABI): resumable decode stopped at a
  // symbol boundary because fewer than `input_margin` input bytes remain
  PAUSED = 100,
};

// ---- probability-model layout (mirrors models/lzma/spec.py) --------------
constexpr int kNumStates = 12;
constexpr int kPosBitsMax = 4;
constexpr int kMatchMinLen = 2;
constexpr int kMatchMaxLen = kMatchMinLen + 16 + 255;  // 273
constexpr u32 kTop = 1u << 24;
constexpr int kProbBits = 11;
constexpr int kProbTotal = 1 << kProbBits;
constexpr int kMoveBits = 5;
constexpr int kProbInit = kProbTotal / 2;

constexpr int IS_MATCH = 0;
constexpr int IS_REP = IS_MATCH + (kNumStates << kPosBitsMax);
constexpr int IS_REP_G0 = IS_REP + kNumStates;
constexpr int IS_REP_G1 = IS_REP_G0 + kNumStates;
constexpr int IS_REP_G2 = IS_REP_G1 + kNumStates;
constexpr int IS_REP0_LONG = IS_REP_G2 + kNumStates;
constexpr int POS_SLOT = IS_REP0_LONG + (kNumStates << kPosBitsMax);
constexpr int SPEC_POS = POS_SLOT + 4 * 64;
constexpr int ALIGN_ = SPEC_POS + 114;
constexpr int LEN_CODER = ALIGN_ + 16;
constexpr int REP_LEN_CODER = LEN_CODER + 514;
constexpr int LITERAL = REP_LEN_CODER + 514;

constexpr int LEN_CHOICE = 0, LEN_CHOICE2 = 1, LEN_LOW = 2,
              LEN_MID = 2 + 16 * 8, LEN_HIGH = 2 + 16 * 8 + 16 * 8;

inline int num_probs(int lc, int lp) { return LITERAL + (0x300 << (lc + lp)); }

inline int state_after_literal(int s) {
  return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6);
}

// word-at-a-time common-prefix length (the hot comparison in match finding)
inline size_t match_len(const u8* a, const u8* b, size_t lim) {
  size_t ln = 0;
  while (ln + 8 <= lim) {
    u64 x, y;
    std::memcpy(&x, a + ln, 8);
    std::memcpy(&y, b + ln, 8);
    const u64 d = x ^ y;
    if (d) return ln + (__builtin_ctzll(d) >> 3);
    ln += 8;
  }
  while (ln < lim && a[ln] == b[ln]) ln++;
  return ln;
}

// ==========================================================================
// decoder
// ==========================================================================

class Decoder {
 public:
  Decoder(int lc, int lp, int pb, u32 dict_size)
      : lc_(lc), lp_(lp), pb_(pb), dict_size_(dict_size),
        probs_(num_probs(lc, lp), kProbInit) {}

  void reset_state() {
    std::fill(probs_.begin(), probs_.end(), (u16)kProbInit);
    state_ = 0;
    rep_[0] = rep_[1] = rep_[2] = rep_[3] = 0;
    rc_primed_ = false;
  }

  // Decode one raw-LZMA segment into out (history buffer == output).
  // Positions/contexts are counted from dic_start (processedPos
  // semantics; may be negative after the caller trims the window front).
  // Returns consumed input position via *src_pos.
  //
  // Resumable mode (persist_rc): the range-coder header is read once and
  // range/code survive across calls; with input_margin > 0 the loop
  // PAUSEs at a symbol boundary when fewer than margin input bytes remain
  // (the role the reference's LzmaDec_TryDummy speculation plays,
  // LzmaDec.c:487-675, solved by holding input back instead).
  //
  // Hot loop keeps the range-coder state (range/code/ip) and the output
  // cursor in locals: writes through the u8 output pointer may legally
  // alias class members, so member-resident state would be reloaded from
  // memory after every emitted byte.
  int decode(const u8* src_user, size_t src_len, std::vector<u8>& out,
             size_t unpack_limit, bool until_mark, long long dic_start,
             size_t* consumed, bool* saw_mark, size_t input_margin = 0,
             bool persist_rc = false) {
    // Work from a zero-padded copy so renormalization needs no per-bit
    // bounds check (the reference guarantees LZMA_REQUIRED_INPUT_MAX
    // caller-side instead, LzmaDec.h:45-48).  Shifting in the zero
    // padding is byte-identical to the reference's `code <<= 8` overrun
    // behaviour; input exhaustion is detected per packet via ip > iend.
    inbuf_.resize(src_len + 64);
    std::memcpy(inbuf_.data(), src_user, src_len);
    std::memset(inbuf_.data() + src_len, 0, 64);
    const u8* src = inbuf_.data();
    const u8* ip;
    u32 code, range;
    if (persist_rc && rc_primed_) {
      ip = src;
      code = rc_code_;
      range = rc_range_;
    } else {
      if (src_len < 5) return ERR_INPUT_EOF;
      if (src_user[0] != 0) return ERR_DATA;
      ip = src + 5;
      code = ((u32)src[1] << 24) | ((u32)src[2] << 16) |
             ((u32)src[3] << 8) | src[4];
      range = 0xFFFFFFFFu;
      rc_primed_ = persist_rc;
    }
    const u8* const iend = src + src_len;
    *saw_mark = false;

    const u32 pb_mask = (1u << pb_) - 1;
    const u32 lp_mask = (1u << lp_) - 1;
    const size_t out_target = until_mark ? SIZE_MAX : out.size() + unpack_limit;

    size_t opos = out.size();
    // give the cursor a slack region so literals need no capacity check;
    // out is truncated back to the cursor on every exit path
    size_t ocap = until_mark ? opos + (64u << 10) : out_target;
    out.resize(ocap);
    u8* ob = out.data();
    u16* const P = probs_.data();

    int state = state_;
    u32 rep0 = rep_[0], rep1 = rep_[1], rep2 = rep_[2], rep3 = rep_[3];

    auto bitp = [&](u16* p) -> unsigned {
      if (range < kTop) {
        range <<= 8;
        code = (code << 8) | *ip++;
      }
      const u32 bound = (range >> kProbBits) * *p;
      if (code < bound) {
        range = bound;
        *p += (kProbTotal - *p) >> kMoveBits;
        return 0;
      }
      range -= bound;
      code -= bound;
      *p -= *p >> kMoveBits;
      return 1;
    };
    auto tree = [&](int base, int nbits) -> unsigned {
      unsigned m = 1;
      for (int i = 0; i < nbits; i++) m = (m << 1) | bitp(&P[base + m]);
      return m - (1u << nbits);
    };
    auto tree_rev = [&](int base, int nbits) -> unsigned {
      unsigned m = 1, sym = 0;
      for (int i = 0; i < nbits; i++) {
        const unsigned b = bitp(&P[base + m]);
        m = (m << 1) | b;
        sym |= b << i;
      }
      return sym;
    };
    auto direct_bits = [&](int n) -> u32 {
      u32 res = 0;
      for (int i = 0; i < n; i++) {
        if (range < kTop) {
          range <<= 8;
          code = (code << 8) | *ip++;
        }
        range >>= 1;
        code -= range;
        const u32 t = 0 - (code >> 31);
        code += range & t;
        res = (res << 1) + t + 1;
      }
      return res;
    };
    auto decode_len = [&](int base, u32 pos_state) -> unsigned {
      if (!bitp(&P[base + LEN_CHOICE]))
        return kMatchMinLen + tree(base + LEN_LOW + (pos_state << 3), 3);
      if (!bitp(&P[base + LEN_CHOICE2]))
        return kMatchMinLen + 8 + tree(base + LEN_MID + (pos_state << 3), 3);
      return kMatchMinLen + 16 + tree(base + LEN_HIGH, 8);
    };
    auto fail = [&](int err) { out.resize(opos); return err; };

    bool paused = false;
    while (opos < out_target) {
      if (input_margin && (size_t)(iend - ip) < input_margin) {
        paused = true;
        break;
      }
      if (until_mark && opos + kMatchMaxLen + 1 > ocap) {
        ocap = ocap * 2 > opos + 512 ? ocap * 2 : opos + 512;
        out.resize(ocap);
        ob = out.data();
      }
      const u32 ctx_pos = (u32)((long long)opos - dic_start);
      const u32 pos_state = ctx_pos & pb_mask;

      if (!bitp(&P[IS_MATCH + (state << kPosBitsMax) + pos_state])) {
        // literal
        const u8 prev = (long long)opos > dic_start ? ob[opos - 1] : 0;
        const u32 lit_state = ((ctx_pos & lp_mask) << lc_) + (prev >> (8 - lc_));
        u16* base = &P[LITERAL + 0x300 * lit_state];
        unsigned sym = 1;
        if (state < 7) {
          while (sym < 0x100) sym = (sym << 1) | bitp(&base[sym]);
        } else {
          if ((long long)opos - dic_start < (long long)rep0 + 1)
            return fail(ERR_DATA);
          unsigned mb = ob[opos - rep0 - 1];
          unsigned offs = 0x100;
          while (sym < 0x100) {
            mb <<= 1;
            const unsigned bc = mb & offs;
            const unsigned b = bitp(&base[offs + bc + sym]);
            sym = (sym << 1) | b;
            offs &= b ? bc : ~bc;
          }
        }
        ob[opos++] = (u8)sym;
        state = state_after_literal(state);
        if (ip > iend) return fail(ERR_INPUT_EOF);
        continue;
      }

      unsigned len;
      if (bitp(&P[IS_REP + state])) {
        if ((long long)opos == dic_start) return fail(ERR_DATA);
        if (!bitp(&P[IS_REP_G0 + state])) {
          if (!bitp(&P[IS_REP0_LONG + (state << kPosBitsMax) + pos_state])) {
            ob[opos] = ob[opos - rep0 - 1];
            opos++;
            state = state < 7 ? 9 : 11;
            if (ip > iend) return fail(ERR_INPUT_EOF);
            continue;
          }
        } else {
          u32 dist;
          if (!bitp(&P[IS_REP_G1 + state])) {
            dist = rep1;
            rep1 = rep0;
          } else {
            if (!bitp(&P[IS_REP_G2 + state])) {
              dist = rep2;
            } else {
              dist = rep3;
              rep3 = rep2;
            }
            rep2 = rep1;
            rep1 = rep0;
          }
          rep0 = dist;
        }
        len = decode_len(REP_LEN_CODER, pos_state);
        state = state < 7 ? 8 : 11;
      } else {
        rep3 = rep2;
        rep2 = rep1;
        rep1 = rep0;
        len = decode_len(LEN_CODER, pos_state);
        state = state < 7 ? 7 : 10;
        const unsigned lt = len - kMatchMinLen < 4 ? len - kMatchMinLen : 3;
        unsigned slot = tree(POS_SLOT + (lt << 6), 6);
        u32 dist;
        if (slot < 4) {
          dist = slot;
        } else {
          const unsigned nd = (slot >> 1) - 1;
          dist = (2 | (slot & 1)) << nd;
          if (slot < 14) {
            dist += tree_rev(SPEC_POS + dist - slot - 1, nd);
          } else {
            dist += direct_bits(nd - 4) << 4;
            dist += tree_rev(ALIGN_, 4);
          }
        }
        if (dist == 0xFFFFFFFFu) {
          *saw_mark = true;
          break;
        }
        rep0 = dist;
      }
      if (ip > iend) return fail(ERR_INPUT_EOF);
      if ((long long)rep0 + 1 > (long long)opos - dic_start ||
          (u64)rep0 + 1 > dict_size_)
        return fail(ERR_DATA);
      if (opos + len > out_target) return fail(ERR_DATA);
      u8* dst = ob + opos;
      const u8* sp = ob + (opos - rep0 - 1);
      const u32 d = rep0 + 1;
      if (d >= len) {
        std::memcpy(dst, sp, len);
      } else if (d == 1) {
        std::memset(dst, *sp, len);
      } else if (len <= 16) {
        for (unsigned i = 0; i < len; i++) dst[i] = sp[i];
      } else {
        // overlap: seed one period, then double it (len <= 273)
        std::memcpy(dst, sp, d);
        u32 filled = d;
        while (filled < len) {
          const u32 n = filled < len - filled ? filled : len - filled;
          std::memcpy(dst + filled, dst, n);
          filled += n;
        }
      }
      opos += len;
    }

    out.resize(opos);
    if (paused) {
      state_ = state;
      rep_[0] = rep0; rep_[1] = rep1; rep_[2] = rep2; rep_[3] = rep3;
      rc_range_ = range;
      rc_code_ = code;
      *consumed = (size_t)(ip - src);
      return PAUSED;
    }
    if (*saw_mark && code != 0) return ERR_DATA;
    // trailing renormalize (LzmaDec.c:412 semantics): exact consumption
    if (range < kTop && ip < iend) ip++;
    if (ip > iend) return ERR_INPUT_EOF;

    state_ = state;
    rep_[0] = rep0; rep_[1] = rep1; rep_[2] = rep2; rep_[3] = rep3;
    rc_range_ = range;
    rc_code_ = code;
    *consumed = (size_t)(ip - src);
    return OK;
  }

  int lc_, lp_, pb_;
  u32 dict_size_;

 private:
  std::vector<u16> probs_;
  std::vector<u8> inbuf_;   // zero-padded input copy (margin-free renorm)
  int state_ = 0;
  u32 rep_[4] = {0, 0, 0, 0};
  bool rc_primed_ = false;  // resumable mode: range/code carried here
  u32 rc_range_ = 0;
  u32 rc_code_ = 0;
};

// ==========================================================================
// encoder (mirrors models/lzma/encoder_ref.py decision-for-decision)
// ==========================================================================

class RangeEncoder {
 public:
  void encode_bit(u16* p, int b) {
    const u32 bound = (range_ >> kProbBits) * *p;
    if (b == 0) {
      range_ = bound;
      *p += (kProbTotal - *p) >> kMoveBits;
    } else {
      low_ += bound;
      range_ -= bound;
      *p -= *p >> kMoveBits;
    }
    while (range_ < kTop) {
      range_ <<= 8;
      shift_low();
    }
  }

  void direct_bits(u32 v, int n) {
    for (int i = n - 1; i >= 0; i--) {
      range_ >>= 1;
      if ((v >> i) & 1) low_ += range_;
      while (range_ < kTop) {
        range_ <<= 8;
        shift_low();
      }
    }
  }

  void tree(u16* base, int nbits, unsigned sym) {
    unsigned m = 1;
    for (int i = nbits - 1; i >= 0; i--) {
      const unsigned b = (sym >> i) & 1;
      encode_bit(base + m, b);
      m = (m << 1) | b;
    }
  }

  void tree_rev(u16* base, int nbits, unsigned sym) {
    unsigned m = 1;
    for (int i = 0; i < nbits; i++) {
      const unsigned b = sym & 1;
      sym >>= 1;
      encode_bit(base + m, b);
      m = (m << 1) | b;
    }
  }

  void flush() {
    for (int i = 0; i < 5; i++) shift_low();
  }

  std::vector<u8> out;

 private:
  void shift_low() {
    if (low_ < 0xFF000000ull || low_ > 0xFFFFFFFFull) {
      const unsigned carry = (unsigned)(low_ >> 32);
      out.push_back((u8)(cache_ + carry));
      for (; cache_size_ > 1; cache_size_--) out.push_back((u8)(0xFF + carry));
      cache_ = (u8)(low_ >> 24);
      cache_size_ = 0;
    }
    cache_size_++;
    low_ = (low_ & 0x00FFFFFFull) << 8;
  }

  u64 low_ = 0;
  u32 range_ = 0xFFFFFFFFu;
  u8 cache_ = 0;
  u32 cache_size_ = 1;
};

// hash-chain match finder — flat-table heads + prev links; the Python
// reference uses the identical hash/table so both backends make the same
// decisions byte-for-byte
class MatchFinder {
 public:
  // hash table sized to the dictionary (LzFind.c sizes hs from dictSize):
  // a fixed 2^17 table over a 16 MB window makes every chain ~99%
  // false-prefix collisions and the bounded walk spends its budget on
  // cache misses; 2^bits >= dict keeps chains mostly true-prefix.
  static u32 hash_bits_for(u32 dict_size) {
    u32 hb = 17;
    while (hb < 24 && (1u << hb) < dict_size) hb++;
    return hb;
  }
  MatchFinder(const u8* data, size_t n, u32 dict_size, int max_chain,
              int nice_len, bool short_hashes = false, size_t cap = 0)
      : data_(data), n_(n), dict_size_(dict_size), max_chain_(max_chain),
        nice_len_(nice_len < 273 ? nice_len : 273),
        hash_bits_(hash_bits_for(dict_size)),
        head_(1u << hash_bits_, -1), prev_(n > cap ? n : cap, 0) {
    if (short_hashes) {
      head2_.assign(1u << 16, -1);
      head3_.assign(1u << 16, -1);
    }
  }

  void set_n(size_t n) { n_ = n; }

  // Window slide (the reference's MoveBlock + position normalization,
  // LzFind.c:92-121,285-320): the caller memmoves the data buffer down by
  // `delta`; all recorded positions rebase, entries that fall off become
  // empty.  O(window) per slide, amortized O(1)/byte at the StreamEnc
  // slide cadence (~dict/2 bytes between slides).
  void slide(size_t delta) {
    const int32_t d = (int32_t)delta;
    auto fix = [&](std::vector<int32_t>& v) {
      for (auto& x : v) x = x >= d ? x - d : -1;
    };
    fix(head_);
    if (!head2_.empty()) {
      fix(head2_);
      fix(head3_);
    }
    const size_t keep = n_ - delta;
    std::memmove(prev_.data(), prev_.data() + delta,
                 keep * sizeof(int32_t));
    for (size_t i = 0; i < keep; i++)
      prev_[i] = prev_[i] >= d ? prev_[i] - d : -1;
    n_ = keep;
  }

  inline u32 hash_at(size_t i) const {
    const u32 le = (u32)data_[i] | ((u32)data_[i + 1] << 8) |
                   ((u32)data_[i + 2] << 16) | ((u32)data_[i + 3] << 24);
    return (le * 2654435761u) >> (32 - hash_bits_);
  }

  inline u32 hash2_at(size_t i) const {
    return (u32)data_[i] | ((u32)data_[i + 1] << 8);
  }

  inline u32 hash3_at(size_t i) const {
    const u32 le = (u32)data_[i] | ((u32)data_[i + 1] << 8) |
                   ((u32)data_[i + 2] << 16);
    return (u32)(((u64)le * 2654435761ull) >> 16) & 0xFFFFu;
  }

  void insert(size_t i) {
    if (!head2_.empty() && i + 2 <= n_) {
      head2_[hash2_at(i)] = (int32_t)i;
      if (i + 3 <= n_) head3_[hash3_at(i)] = (int32_t)i;
    }
    if (i + 4 > n_) return;
    const u32 h = hash_at(i);
    prev_[i] = head_[h];
    head_[h] = (int32_t)i;
  }

  // collect (len, dist) candidate pairs of strictly increasing length
  // (shortest-distance-first chain order), for the optimal parser.
  // With short_hashes the order-2/order-3 heads seed the list (BT4's
  // HASH2/HASH3 role, LzmaEnc.c GetMatches): they are the *nearest*
  // occurrences of the 2-/3-byte prefix, so any chain entry has a larger
  // distance and the frontier stays minimal-distance-per-length.
  int candidates(size_t i, unsigned (*lens)[32], u32 (*dists)[32]) {
    int cnt = 0;
    if (i + 2 > n_) return 0;
    const size_t limit = (n_ - i) < 273 ? (n_ - i) : 273;
    const int64_t min_pos = (int64_t)i - (int64_t)dict_size_;
    unsigned bl = 0;
    if (!head2_.empty()) {
      const int64_t p2 = head2_[hash2_at(i)];
      if (p2 >= min_pos && p2 >= 0 && (size_t)p2 < i) {
        const size_t ln = match_len(data_ + p2, data_ + i, limit);
        if (ln >= 2) {
          bl = (unsigned)ln;
          (*lens)[cnt] = bl;
          (*dists)[cnt] = (u32)(i - p2);
          cnt++;
        }
      }
      if (i + 3 <= n_) {
        const int64_t p3 = head3_[hash3_at(i)];
        if (p3 >= min_pos && p3 >= 0 && (size_t)p3 < i &&
            data_[p3] == data_[i] && data_[p3 + 1] == data_[i + 1] &&
            data_[p3 + 2] == data_[i + 2]) {
          const size_t ln = 3 + match_len(data_ + p3 + 3, data_ + i + 3,
                                          limit - 3);
          if (ln > bl) {
            bl = (unsigned)ln;
            (*lens)[cnt] = bl;
            (*dists)[cnt] = (u32)(i - p3);
            cnt++;
          }
        }
      }
    }
    if (i + 4 > n_) return cnt;
    int64_t cand = head_[hash_at(i)];
    int chain = max_chain_;
    while (cand >= 0 && chain > 0 && cand >= min_pos && cnt < 32) {
      // hoist the next-link load and warm the step-after-next while the
      // byte compare below runs (the chain walk is a serial miss chain)
      const int64_t nxt = prev_[cand];
      __builtin_prefetch(&prev_[nxt]);
      __builtin_prefetch(data_ + nxt + bl);
      if (i + bl < n_ && data_[cand + bl] == data_[i + bl]) {
        const size_t ln = match_len(data_ + cand, data_ + i, limit);
        if (ln > bl) {
          bl = (unsigned)ln;
          (*lens)[cnt] = bl;
          (*dists)[cnt] = (u32)(i - cand);
          cnt++;
          if (bl >= (unsigned)nice_len_) break;
        }
      }
      cand = nxt;
      chain--;
    }
    return cnt;
  }

  void best_match(size_t i, size_t hard_end, unsigned* best_len,
                  u32* best_dist) {
    *best_len = 0;
    *best_dist = 0;
    if (i + 4 > n_) return;
    int64_t cand = head_[hash_at(i)];
    int chain = max_chain_;
    const size_t limit = (n_ - i) < 273 ? (n_ - i) : 273;
    const int64_t min_pos = (int64_t)i - (int64_t)dict_size_;
    unsigned bl = 0;
    u32 bd = 0;
    while (cand >= 0 && chain > 0 && cand >= min_pos) {
      const int64_t nxt = prev_[cand];       // same look-ahead pattern
      __builtin_prefetch(&prev_[nxt]);       // as candidates()
      __builtin_prefetch(data_ + nxt + bl);
      if (i + bl < n_ && data_[cand + bl] == data_[i + bl]) {
        const size_t ln = match_len(data_ + cand, data_ + i, limit);
        if (ln > bl) {
          bl = (unsigned)ln;
          bd = (u32)(i - cand);
          if (bl >= (unsigned)nice_len_) break;
        }
      }
      cand = nxt;
      chain--;
    }
    *best_len = bl;
    *best_dist = bd;
  }

 private:
  const u8* data_;
  size_t n_;
  u32 dict_size_;
  int max_chain_, nice_len_;
  u32 hash_bits_;
  // 32-bit refs (the reference's CLzRef, LzFind.h): halves the table
  // cache traffic of the chain walk vs the old int64 entries
  std::vector<int32_t> head_;
  std::vector<int32_t> prev_;
  std::vector<int32_t> head2_, head3_;  // opt-parse only (short_hashes)
};

// Binary-tree match finder (reference parity target: LzFind.c:353-406 BT4;
// this is an independent implementation).  Each position is a node in a
// binary search tree over suffixes, bucketed by a 4-byte hash; newer
// positions sit nearer the root, so a search walk yields the candidate
// frontier nearest-first with strictly increasing match lengths.  2-/3-byte
// hash heads seed the short end of the frontier.
class BtMatchFinder {
 public:
  static constexpr u32 kEmpty = 0xFFFFFFFFu;

  BtMatchFinder(const u8* data, size_t n, u32 dict_size, int cutoff,
                int nice_len, size_t cap = 0)
      : data_(data), n_(n), dict_size_(dict_size), cutoff_(cutoff),
        nice_len_(nice_len < 273 ? nice_len : 273) {
    const size_t sz = n > cap ? n : cap;
    u32 hb = 16;
    const u64 span = (u64)(sz < dict_size ? sz : dict_size);
    while ((1ull << hb) < span && hb < 23) hb++;
    hash_bits_ = hb;
    head_.assign((size_t)1 << hb, kEmpty);
    head2_.assign(1u << 16, kEmpty);
    head3_.assign(1u << 16, kEmpty);
    son_.assign(2 * sz + 2, kEmpty);
  }

  void set_n(size_t n) { n_ = n; }

  // Window slide (MoveBlock + position normalization analog; see
  // MatchFinder::slide).  All stored positions rebase by -delta; entries
  // that fall off the window become empty.
  void slide(size_t delta) {
    const u32 d = (u32)delta;
    auto fix = [&](std::vector<u32>& v) {
      for (auto& x : v) x = (x != kEmpty && x >= d) ? x - d : kEmpty;
    };
    fix(head_);
    fix(head2_);
    fix(head3_);
    const size_t keep = n_ - delta;
    std::memmove(son_.data(), son_.data() + 2 * delta,
                 2 * keep * sizeof(u32));
    for (size_t i = 0; i < 2 * keep; i++)
      son_[i] = (son_[i] != kEmpty && son_[i] >= d) ? son_[i] - d : kEmpty;
    n_ = keep;
  }

  inline u32 h4(size_t i) const {
    u32 le;
    std::memcpy(&le, data_ + i, 4);
    return (u32)(((u64)le * 2654435761ull) >> (48 - hash_bits_)) &
           ((1u << hash_bits_) - 1);
  }
  inline u32 h2(size_t i) const {
    return (u32)data_[i] | ((u32)data_[i + 1] << 8);
  }
  inline u32 h3(size_t i) const {
    const u32 le = (u32)data_[i] | ((u32)data_[i + 1] << 8) |
                   ((u32)data_[i + 2] << 16);
    return (u32)(((u64)le * 2654435761ull) >> 16) & 0xFFFFu;
  }

  // Insert position p and collect the (len, dist) candidate frontier:
  // strictly increasing lengths, minimal distance per length.  Returns the
  // candidate count; lens/dists hold up to 64 entries.
  int get_matches(size_t p, unsigned* lens, u32* dists) {
    int cnt = 0;
    if (p + 2 > n_) return 0;
    if (p + 5 <= n_) {
      // the very first misses of the NEXT call are its three head
      // lookups — their addresses are computable now from warm bytes
      __builtin_prefetch(&head_[h4(p + 1)], 1);
      __builtin_prefetch(&head3_[h3(p + 1)], 1);
      __builtin_prefetch(&head2_[h2(p + 1)], 1);
    }
    const size_t lim = (n_ - p) < 273 ? (n_ - p) : 273;
    const u64 min_pos1 = (u64)p >= dict_size_ ? p - dict_size_ + 1 : 0;
    unsigned bl = 1;

    const u32 p2 = head2_[h2(p)];
    head2_[h2(p)] = (u32)p;
    if (p2 != kEmpty && p2 >= min_pos1 && data_[p2] == data_[p]) {
      const size_t ln = 1 + match_len(data_ + p2 + 1, data_ + p + 1, lim - 1);
      if (ln >= 2) {
        bl = (unsigned)ln;
        lens[cnt] = bl;
        dists[cnt] = (u32)(p - p2);
        cnt++;
      }
    }
    if (p + 3 <= n_) {
      const u32 hh3 = h3(p);
      const u32 p3 = head3_[hh3];
      head3_[hh3] = (u32)p;
      if (p3 != kEmpty && p3 != p2 && p3 >= min_pos1 &&
          data_[p3] == data_[p] && data_[p3 + 1] == data_[p + 1] &&
          data_[p3 + 2] == data_[p + 2]) {
        const size_t ln = 3 + match_len(data_ + p3 + 3, data_ + p + 3,
                                        lim - 3);
        if (ln > bl) {
          bl = (unsigned)ln;
          lens[cnt] = bl;
          dists[cnt] = (u32)(p - p3);
          cnt++;
        }
      }
    }
    if (p + 4 > n_) return cnt;

    const u32 hh = h4(p);
    u32 cur = head_[hh];
    head_[hh] = (u32)p;
    __builtin_prefetch(&son_[2 * (size_t)cur]);
    __builtin_prefetch(data_ + cur);
    u32* ptr0 = &son_[2 * p + 1];  // subtree of suffixes > ours
    u32* ptr1 = &son_[2 * p];      // subtree of suffixes < ours
    size_t len0 = 0, len1 = 0;
    int depth = cutoff_;
    for (;;) {
      if (cur == kEmpty || cur < min_pos1 || depth-- == 0) {
        *ptr0 = *ptr1 = kEmpty;
        break;
      }
      u32* pair = &son_[2 * (size_t)cur];
      size_t len = len0 < len1 ? len0 : len1;
      // the walk's stalls are the serial node->node cache-miss chain:
      // once this node's pair is loaded, BOTH possible next nodes are
      // known, so warm their son_ entries and comparison bytes while
      // match_len below gives the loads time to land (gprof r4: 48% of
      // opt-parse time was these misses)
      {
        const u32 c0 = pair[0], c1 = pair[1];
        __builtin_prefetch(&son_[2 * (size_t)c0]);
        __builtin_prefetch(&son_[2 * (size_t)c1]);
        __builtin_prefetch(data_ + c0 + len);
        __builtin_prefetch(data_ + c1 + len);
      }
      len += match_len(data_ + cur + len, data_ + p + len, lim - len);
      if (len > bl && cnt < 64) {
        bl = (unsigned)len;
        lens[cnt] = bl;
        dists[cnt] = (u32)(p - cur);
        cnt++;
        if (len >= (size_t)nice_len_ || len == lim) {
          // adopt the node's subtrees and stop — everything below repeats
          // the frontier we already have
          *ptr1 = pair[0];
          *ptr0 = pair[1];
          break;
        }
      } else if (len == lim) {
        *ptr1 = pair[0];
        *ptr0 = pair[1];
        break;
      }
      if (data_[cur + len] < data_[p + len]) {
        *ptr1 = cur;
        ptr1 = &pair[1];
        cur = *ptr1;
        len1 = len;
      } else {
        *ptr0 = cur;
        ptr0 = &pair[0];
        cur = *ptr0;
        len0 = len;
      }
    }
    return cnt;
  }

  // Insert without collecting matches (tree health on skipped positions).
  void skip(size_t p) {
    if (p + 2 > n_) return;
    if (p + 5 <= n_) {
      __builtin_prefetch(&head_[h4(p + 1)], 1);   // as in get_matches
      __builtin_prefetch(&head3_[h3(p + 1)], 1);
      __builtin_prefetch(&head2_[h2(p + 1)], 1);
    }
    head2_[h2(p)] = (u32)p;
    if (p + 3 <= n_) head3_[h3(p)] = (u32)p;
    if (p + 4 > n_) return;
    const size_t lim = (n_ - p) < 273 ? (n_ - p) : 273;
    const u64 min_pos1 = (u64)p >= dict_size_ ? p - dict_size_ + 1 : 0;
    const u32 hh = h4(p);
    u32 cur = head_[hh];
    head_[hh] = (u32)p;
    __builtin_prefetch(&son_[2 * (size_t)cur]);
    __builtin_prefetch(data_ + cur);
    u32* ptr0 = &son_[2 * p + 1];
    u32* ptr1 = &son_[2 * p];
    size_t len0 = 0, len1 = 0;
    int depth = cutoff_;
    for (;;) {
      if (cur == kEmpty || cur < min_pos1 || depth-- == 0) {
        *ptr0 = *ptr1 = kEmpty;
        break;
      }
      u32* pair = &son_[2 * (size_t)cur];
      size_t len = len0 < len1 ? len0 : len1;
      {
        const u32 c0 = pair[0], c1 = pair[1];  // same speculative
        __builtin_prefetch(&son_[2 * (size_t)c0]);  // warm-both-children
        __builtin_prefetch(&son_[2 * (size_t)c1]);  // pattern as
        __builtin_prefetch(data_ + c0 + len);       // get_matches
        __builtin_prefetch(data_ + c1 + len);
      }
      len += match_len(data_ + cur + len, data_ + p + len, lim - len);
      if (len == lim) {
        *ptr1 = pair[0];
        *ptr0 = pair[1];
        break;
      }
      if (data_[cur + len] < data_[p + len]) {
        *ptr1 = cur;
        ptr1 = &pair[1];
        cur = *ptr1;
        len1 = len;
      } else {
        *ptr0 = cur;
        ptr0 = &pair[0];
        cur = *ptr0;
        len0 = len;
      }
    }
  }

 private:
  const u8* data_;
  size_t n_;
  u32 dict_size_;
  int cutoff_, nice_len_;
  u32 hash_bits_;
  std::vector<u32> head_, head2_, head3_, son_;
};

class Encoder {
 public:
  Encoder(int lc, int lp, int pb, u32 dict_size, int max_chain = 16,
          int nice_len = 64)
      : lc_(lc), lp_(lp), pb_(pb), dict_size_(dict_size),
        max_chain_(max_chain), nice_len_(nice_len),
        probs_(num_probs(lc, lp), kProbInit) {}

  void reset_state() {
    std::fill(probs_.begin(), probs_.end(), (u16)kProbInit);
    state_ = 0;
    rep_[0] = rep_[1] = rep_[2] = rep_[3] = 0;
  }

  struct Snapshot {
    std::vector<u16> probs;
    int state;
    u32 rep[4];
  };

  Snapshot save() const {
    Snapshot s{probs_, state_, {rep_[0], rep_[1], rep_[2], rep_[3]}};
    return s;
  }

  void restore(const Snapshot& s) {
    probs_ = s.probs;
    state_ = s.state;
    for (int i = 0; i < 4; i++) rep_[i] = s.rep[i];
  }

  // ---- price tables (1/16-bit fixed point) -------------------------------
  // ProbPrice[v] ≈ -16·log2(((v<<4)|8)/2048): the reference quantizes the
  // same way (LzmaEnc_InitPriceTables, LzmaEnc.c:600-621 as parity target).
  static const u16* prob_prices() {
    static u16 t[128];
    static bool init = false;
    if (!init) {
      for (int v = 0; v < 128; v++) {
        double pr = ((v << 4) | 8) / 2048.0;
        double bits = -std::log2(pr);
        t[v] = (u16)(bits * 16 + 0.5);
      }
      init = true;
    }
    return t;
  }

  inline u32 price_bit(int idx, int b) const {
    const u16 p = probs_[idx];
    const u16* pp = prob_prices();
    return b ? pp[(2048 - p) >> 4] : pp[p >> 4];
  }

  u32 price_tree(int base, int nbits, unsigned sym) const {
    u32 m = 1, price = 0;
    for (int i = nbits - 1; i >= 0; i--) {
      const unsigned b = (sym >> i) & 1;
      price += price_bit(base + m, b);
      m = (m << 1) | b;
    }
    return price;
  }

  u32 price_tree_rev(int base, int nbits, unsigned sym) const {
    u32 m = 1, price = 0;
    for (int i = 0; i < nbits; i++) {
      const unsigned b = sym & 1;
      sym >>= 1;
      price += price_bit(base + m, b);
      m = (m << 1) | b;
    }
    return price;
  }

  u32 price_len(int base, u32 pos_state, unsigned len) const {
    const unsigned sym = len - kMatchMinLen;
    if (sym < 8)
      return price_bit(base + LEN_CHOICE, 0) +
             price_tree(base + LEN_LOW + (pos_state << 3), 3, sym);
    if (sym < 16)
      return price_bit(base + LEN_CHOICE, 1) +
             price_bit(base + LEN_CHOICE2, 0) +
             price_tree(base + LEN_MID + (pos_state << 3), 3, sym - 8);
    return price_bit(base + LEN_CHOICE, 1) + price_bit(base + LEN_CHOICE2, 1) +
           price_tree(base + LEN_HIGH, 8, sym - 16);
  }

  u32 price_dist(unsigned len, u32 dist) const {
    const unsigned lt = (len - kMatchMinLen) < 4 ? len - kMatchMinLen : 3;
    const unsigned slot = pos_slot(dist);
    u32 price = price_tree(POS_SLOT + (lt << 6), 6, slot);
    if (slot >= 4) {
      const unsigned nd = (slot >> 1) - 1;
      const u32 base = (2 | (slot & 1)) << nd;
      const u32 rem = dist - base;
      if (slot < 14)
        price += price_tree_rev(SPEC_POS + base - slot - 1, nd, rem);
      else
        price += (nd - 4) * 16 + price_tree_rev(ALIGN_, 4, rem & 15);
    }
    return price;
  }

  u32 price_literal(u32 pos_state_unused, u32 pos, const u8* data, size_t i,
                    size_t dic_start, int state, u32 rep0) const {
    const u32 lp_mask = (1u << lp_) - 1;
    const u8 prev = i > dic_start ? data[i - 1] : 0;
    const u32 lit_state = ((pos & lp_mask) << lc_) + (prev >> (8 - lc_));
    const u16* base = &probs_[LITERAL + 0x300 * lit_state];
    const unsigned sym = data[i];
    const u16* pp = prob_prices();
    u32 price = 0;
    if (state < 7) {
      unsigned m = 1;
      for (int bi = 7; bi >= 0; bi--) {
        const unsigned b = (sym >> bi) & 1;
        const u16 p = base[m];
        price += b ? pp[(2048 - p) >> 4] : pp[p >> 4];
        m = (m << 1) | b;
      }
    } else {
      // matched literal (needs the match byte)
      if ((int64_t)i - rep0 - 1 < (int64_t)dic_start) return 0xFFFFFFF;
      unsigned mb = data[i - rep0 - 1];
      unsigned offs = 0x100;
      unsigned m = 1;
      for (int bi = 7; bi >= 0; bi--) {
        const unsigned b = (sym >> bi) & 1;
        mb <<= 1;
        const unsigned bc = mb & offs;
        const u16 p = base[offs + bc + m];
        price += b ? pp[(2048 - p) >> 4] : pp[p >> 4];
        m = (m << 1) | b;
        offs &= b ? bc : ~bc;
      }
    }
    return price;
  }

  // Optimal parse: shortest-path DP with live-prob prices over blocks
  // (LzmaEnc.c GetOptimum equivalent).  Each node tracks the arrival
  // (state, rep0..rep3) from its best predecessor; transitions cover
  // literal, short-rep, rep0..rep3 (rep-coded pricing), and normal
  // matches.  Candidates come from a persistent binary-tree finder (BT4
  // quality, LzFind.c:353-406 as parity target) shared across the
  // sub-chunks of a group; distance prices are cached per block the way
  // LzmaEnc.c:600-621 caches them.  Parity target: compressed size ≤ the
  // reference's BT4+optimal at comparable single-thread speed.
  std::vector<u8> encode_segment_opt(const u8* data, size_t total_n,
                                     size_t start, size_t end,
                                     size_t dic_start, bool end_mark) {
    RangeEncoder rc;
    const u32 pb_mask = (1u << pb_) - 1;
    if (!ext_) {
      if (!bt_ || bt_data_ != data || bt_next_ > start) {
        bt_.reset(new BtMatchFinder(data, total_n, dict_size_, max_chain_,
                                    nice_len_, stream_cap_));
        bt_data_ = data;
        bt_next_ = dic_start;
      }
      bt_->set_n(total_n);
      while (bt_next_ < start) bt_->skip(bt_next_++);
    }

    // Device-assisted candidates for the optimal parse (the LzFindMt
    // role, LzFindMt.c:311-429 as the behavioral target): the TPU
    // sorted-bucket finder supplies nearest-first distances, true
    // lengths are re-measured here, and the Pareto set (strictly
    // increasing length over increasing distance) feeds the DP exactly
    // like BT4's len-ascending match list.
    auto ext_matches = [&](size_t pos_abs, unsigned* lens_o,
                           u32* dists_o) -> int {
      const size_t lim =
          (total_n - pos_abs) < kMatchMaxLen ? total_n - pos_abs
                                             : kMatchMaxLen;
      u32 cd[64];
      unsigned cl[64];
      int m = 0;
      for (int k = 0; k < ext_k_ && m < 64; k++) {
        const int32_t d = ext_[pos_abs * (size_t)ext_k_ + k];
        if (d <= 0 || (int64_t)pos_abs - d < (int64_t)dic_start ||
            (u32)d > dict_size_)
          continue;
        if (data[pos_abs - d] != data[pos_abs]) continue;
        const size_t ln = match_len(data + pos_abs - d, data + pos_abs, lim);
        if (ln >= 2) {
          cd[m] = (u32)d;
          cl[m] = (unsigned)ln;
          m++;
        }
      }
      // insertion sort by distance ascending (tiny m)
      for (int a = 1; a < m; a++) {
        const u32 d0 = cd[a];
        const unsigned l0 = cl[a];
        int b = a - 1;
        for (; b >= 0 && cd[b] > d0; b--) {
          cd[b + 1] = cd[b];
          cl[b + 1] = cl[b];
        }
        cd[b + 1] = d0;
        cl[b + 1] = l0;
      }
      int nc = 0;
      unsigned best = 1;
      for (int t = 0; t < m; t++)
        if (cl[t] > best) {
          lens_o[nc] = cl[t];
          dists_o[nc] = cd[t];
          best = cl[t];
          nc++;
        }
      return nc;
    };

    const size_t BLOCK = 0x400;
    const size_t WMAX = BLOCK + kMatchMaxLen;
    std::vector<u32> cost, from, op_len, op_dist;
    std::vector<u8> arr_state;
    std::vector<std::array<u32, 4>> arr_rep(WMAX + 1);
    const u32 nps = pb_mask + 1;
    std::vector<u32> lenp(nps * 274), replenp(nps * 274);
    u32 slotp[4][64], alignp[16], distp[4][128];

    size_t i = start;
    while (i < end) {
      const size_t bend = (i + BLOCK < end) ? i + BLOCK : end;
      const size_t W = bend - i;
      // DP over [0..W] plus an extension region: ops started inside the
      // block may finish up to kMatchMaxLen past it, so block boundaries
      // never truncate a match (the endpoint is chosen below)
      const size_t WX = W + kMatchMaxLen;
      cost.assign(WX + 1, 0xFFFFFFFFu);
      from.assign(WX + 1, 0);
      op_len.assign(WX + 1, 0);
      // op_dist: 0 = literal; 1 = short rep; else dist+2 (the emitter
      // re-derives the rep form when the distance matches a live rep)
      op_dist.assign(WX + 1, 0);
      arr_state.assign(WX + 1, 0);
      cost[0] = 0;
      arr_state[0] = (u8)state_;
      arr_rep[0] = {rep_[0], rep_[1], rep_[2], rep_[3]};
      // length prices are pos_state x len only — table them per block
      for (u32 ps = 0; ps < nps; ps++)
        for (unsigned l = 2; l <= kMatchMaxLen; l++) {
          lenp[ps * 274 + l] = price_len(LEN_CODER, ps, l);
          replenp[ps * 274 + l] = price_len(REP_LEN_CODER, ps, l);
        }
      // distance prices: slot tree (direct bits folded in for slots ≥ 14),
      // align tree, and the full price for every distance < 128
      for (unsigned lt = 0; lt < 4; lt++)
        for (unsigned s = 0; s < 64; s++) {
          u32 pr = price_tree(POS_SLOT + (lt << 6), 6, s);
          if (s >= 14) pr += (((s >> 1) - 1) - 4) << 4;
          slotp[lt][s] = pr;
        }
      for (unsigned a = 0; a < 16; a++)
        alignp[a] = price_tree_rev(ALIGN_, 4, a);
      {
        u32 spec[128] = {0, 0, 0, 0};
        for (u32 d = 4; d < 128; d++) {
          const unsigned s = pos_slot(d);
          const unsigned nd = (s >> 1) - 1;
          const u32 base = (2 | (s & 1)) << nd;
          spec[d] = price_tree_rev(SPEC_POS + base - s - 1, nd, d - base);
        }
        for (unsigned lt = 0; lt < 4; lt++)
          for (u32 d = 0; d < 128; d++)
            distp[lt][d] = slotp[lt][pos_slot(d)] + spec[d];
      }
      unsigned lens[64];
      u32 dists[64];
      size_t skip_search_until = 0;
      for (size_t j = 0; j < W; j++) {
        if (cost[j] == 0xFFFFFFFFu) {
          if (!ext_) bt_->skip(bt_next_++);
          continue;
        }
        const size_t pos_abs = i + j;
        const u32 pos = (u32)(pos_abs - dic_start) + pos_base_;
        const u32 pos_state = pos & pb_mask;
        const int st = arr_state[j];
        const std::array<u32, 4>& rq = arr_rep[j];
        const int ism_idx = IS_MATCH + (st << kPosBitsMax) + pos_state;
        const u32 match_head = cost[j] + price_bit(ism_idx, 1);
        const u32 rep_head = match_head + price_bit(IS_REP + st, 1);
        // literal
        {
          const u32 c = cost[j] + price_bit(ism_idx, 0) +
                        price_literal(0, pos, data, pos_abs, dic_start, st,
                                      rq[0]);
          if (c < cost[j + 1]) {
            cost[j + 1] = c;
            from[j + 1] = (u32)j;
            op_len[j + 1] = 1;
            op_dist[j + 1] = 0;
            arr_state[j + 1] = (u8)state_after_literal(st);
            arr_rep[j + 1] = rq;
          }
        }
        // rep matches (incl. short rep for ri == 0)
        for (int ri = 0; ri < 4; ri++) {
          const u32 rd = rq[ri];
          bool dup = false;
          for (int q = 0; q < ri; q++) dup |= rq[q] == rd;
          if (dup) continue;
          const int64_t fromp = (int64_t)pos_abs - rd - 1;
          if (fromp < (int64_t)dic_start) continue;
          const size_t lim = (end - pos_abs) < 273 ? end - pos_abs : 273;
          const size_t ln = match_len(data + fromp, data + pos_abs, lim);
          if (ln == 0) continue;
          u32 sel_price = rep_head;
          if (ri == 0) {
            sel_price += price_bit(IS_REP_G0 + st, 0);
            // short rep: single byte at rep0 (LzmaDec's IS_REP0_LONG=0 arm)
            const u32 c0 = sel_price +
                price_bit(IS_REP0_LONG + (st << kPosBitsMax) + pos_state, 0);
            if (c0 < cost[j + 1]) {
              cost[j + 1] = c0;
              from[j + 1] = (u32)j;
              op_len[j + 1] = 1;
              op_dist[j + 1] = 1;
              arr_state[j + 1] = (u8)(st < 7 ? 9 : 11);
              arr_rep[j + 1] = rq;
            }
            sel_price +=
                price_bit(IS_REP0_LONG + (st << kPosBitsMax) + pos_state, 1);
          } else if (ri == 1) {
            sel_price += price_bit(IS_REP_G0 + st, 1) +
                         price_bit(IS_REP_G1 + st, 0);
          } else {
            sel_price += price_bit(IS_REP_G0 + st, 1) +
                         price_bit(IS_REP_G1 + st, 1) +
                         price_bit(IS_REP_G2 + st, ri == 2 ? 0 : 1);
          }
          if (ln < 2) continue;
          std::array<u32, 4> nq = rq;
          if (ri == 1) {
            nq = {rq[1], rq[0], rq[2], rq[3]};
          } else if (ri == 2) {
            nq = {rq[2], rq[0], rq[1], rq[3]};
          } else if (ri == 3) {
            nq = {rq[3], rq[0], rq[1], rq[2]};
          }
          const size_t maxl = ln;
          const u32* rlp = &replenp[pos_state * 274];
          for (size_t l = 2; l <= maxl; l++) {
            const u32 c = sel_price + rlp[l];
            if (c < cost[j + l]) {
              cost[j + l] = c;
              from[j + l] = (u32)j;
              op_len[j + l] = (u32)l;
              op_dist[j + l] = rd + 2;
              arr_state[j + l] = (u8)(st < 7 ? 8 : 11);
              arr_rep[j + l] = nq;
            }
          }
        }
        // normal matches (search skipped inside a dominating long match)
        int nc = 0;
        if (ext_) {
          if (pos_abs >= skip_search_until)
            nc = ext_matches(pos_abs, lens, dists);
        } else {
          if (pos_abs >= skip_search_until)
            nc = bt_->get_matches(pos_abs, lens, dists);
          else
            bt_->skip(pos_abs);
          bt_next_++;
        }
        if (nc > 0 && lens[nc - 1] >= 128)
          skip_search_until = pos_abs + lens[nc - 1] - 1;
        const u32 nm_head = match_head + price_bit(IS_REP + st, 0);
        unsigned prev_len = 1;
        for (int k = 0; k < nc; k++) {
          unsigned ml = lens[k];
          const u32 dist = dists[k] - 1;
          if (ml > end - pos_abs) ml = (unsigned)(end - pos_abs);
          if (ml < 2) continue;
          // distances equal to a live rep are covered (cheaper) above
          if (dist == rq[0] || dist == rq[1] || dist == rq[2] ||
              dist == rq[3]) {
            prev_len = ml;
            continue;
          }
          // distance price depends on len only through the 4-way slot
          // context — read the 4 variants from the block's cached tables
          u32 pd[4];
          if (dist < 128) {
            for (unsigned lt = 0; lt < 4; lt++) pd[lt] = distp[lt][dist];
          } else {
            const unsigned s = pos_slot(dist);
            const u32 al = alignp[dist & 15];
            for (unsigned lt = 0; lt < 4; lt++) pd[lt] = slotp[lt][s] + al;
          }
          const u32* lp = &lenp[pos_state * 274];
          for (unsigned l = prev_len + 1; l <= ml; l++) {
            if (l < 2) continue;
            const u32 c = nm_head + lp[l] +
                          pd[(l - 2) < 4 ? (l - 2) : 3];
            if (c < cost[j + l]) {
              cost[j + l] = c;
              from[j + l] = (u32)j;
              op_len[j + l] = l;
              op_dist[j + l] = dist + 2;
              arr_state[j + l] = (u8)(st < 7 ? 7 : 10);
              arr_rep[j + l] = {dist, rq[0], rq[1], rq[2]};
            }
          }
          prev_len = ml;
        }
      }
      // endpoint: prefer an overshoot node when its cost, net of the
      // block's average bits/byte for the extra bytes it encodes, wins
      size_t je = W;
      {
        const double bpb = (double)cost[W] / (double)W;
        double best = (double)cost[W];
        for (size_t j = W + 1; j <= WX; j++) {
          if (cost[j] == 0xFFFFFFFFu) continue;
          const double adj = (double)cost[j] - bpb * (double)(j - W);
          if (adj < best) { best = adj; je = j; }
        }
      }
      // backtrack the block, then emit forward through the adaptive coder
      std::vector<size_t> order;
      for (size_t j = je; j > 0; j = from[j]) order.push_back(j);
      for (size_t oi = order.size(); oi-- > 0;) {
        const size_t j = order[oi];
        const size_t pos_abs = i + from[j];
        const unsigned l = op_len[j];
        const u32 od = op_dist[j];
        if (od == 0) {
          emit_literal(rc, data, pos_abs, dic_start);
        } else if (od == 1) {
          emit_shortrep(rc, pos_abs, dic_start);
        } else {
          emit_match(rc, data, pos_abs, dic_start, od - 2, l);
        }
      }
      if (!ext_) {
        while (bt_next_ < i + je) bt_->skip(bt_next_++);
      }
      i += je;
    }

    if (end_mark) {
      const u32 pos_state = ((u32)(end - dic_start) + pos_base_) & pb_mask;
      rc.encode_bit(&probs_[IS_MATCH + (state_ << kPosBitsMax) + pos_state], 1);
      rc.encode_bit(&probs_[IS_REP + state_], 0);
      encode_len(rc, LEN_CODER, pos_state, kMatchMinLen);
      encode_dist(rc, kMatchMinLen, 0xFFFFFFFFu);
      state_ = state_ < 7 ? 7 : 10;
      rep_[3] = rep_[2]; rep_[2] = rep_[1]; rep_[1] = rep_[0];
      rep_[0] = 0xFFFFFFFFu;
    }
    rc.flush();
    return std::move(rc.out);
  }

  // ---- emission helpers (update the real adaptive model) ----------------
  void emit_literal(RangeEncoder& rc, const u8* data, size_t i,
                    size_t dic_start) {
    const u32 pb_mask = (1u << pb_) - 1;
    const u32 lp_mask = (1u << lp_) - 1;
    const u32 pos = (u32)(i - dic_start) + pos_base_;
    const u32 pos_state = pos & pb_mask;
    rc.encode_bit(&probs_[IS_MATCH + (state_ << kPosBitsMax) + pos_state], 0);
    const u8 prev = i > dic_start ? data[i - 1] : 0;
    const u32 lit_state = ((pos & lp_mask) << lc_) + (prev >> (8 - lc_));
    u16* base = &probs_[LITERAL + 0x300 * lit_state];
    const unsigned sym = data[i];
    if (state_ < 7) {
      unsigned m = 1;
      for (int bi = 7; bi >= 0; bi--) {
        const unsigned b = (sym >> bi) & 1;
        rc.encode_bit(&base[m], b);
        m = (m << 1) | b;
      }
    } else {
      unsigned mb = data[i - rep_[0] - 1];
      unsigned offs = 0x100;
      unsigned m = 1;
      for (int bi = 7; bi >= 0; bi--) {
        const unsigned b = (sym >> bi) & 1;
        mb <<= 1;
        const unsigned bc = mb & offs;
        rc.encode_bit(&base[offs + bc + m], b);
        m = (m << 1) | b;
        offs &= b ? bc : ~bc;
      }
    }
    state_ = state_after_literal(state_);
  }

  void emit_rep(RangeEncoder& rc, const u8* data, size_t i, size_t dic_start,
                int ri, unsigned len) {
    const u32 pb_mask = (1u << pb_) - 1;
    const u32 pos_state = ((u32)(i - dic_start) + pos_base_) & pb_mask;
    rc.encode_bit(&probs_[IS_MATCH + (state_ << kPosBitsMax) + pos_state], 1);
    rc.encode_bit(&probs_[IS_REP + state_], 1);
    if (ri == 0) {
      rc.encode_bit(&probs_[IS_REP_G0 + state_], 0);
      rc.encode_bit(
          &probs_[IS_REP0_LONG + (state_ << kPosBitsMax) + pos_state], 1);
    } else {
      rc.encode_bit(&probs_[IS_REP_G0 + state_], 1);
      if (ri == 1) {
        rc.encode_bit(&probs_[IS_REP_G1 + state_], 0);
        const u32 d = rep_[1];
        rep_[1] = rep_[0];
        rep_[0] = d;
      } else if (ri == 2) {
        rc.encode_bit(&probs_[IS_REP_G1 + state_], 1);
        rc.encode_bit(&probs_[IS_REP_G2 + state_], 0);
        const u32 d = rep_[2];
        rep_[2] = rep_[1]; rep_[1] = rep_[0]; rep_[0] = d;
      } else {
        rc.encode_bit(&probs_[IS_REP_G1 + state_], 1);
        rc.encode_bit(&probs_[IS_REP_G2 + state_], 1);
        const u32 d = rep_[3];
        rep_[3] = rep_[2]; rep_[2] = rep_[1]; rep_[1] = rep_[0]; rep_[0] = d;
      }
    }
    encode_len(rc, REP_LEN_CODER, pos_state, len);
    state_ = state_ < 7 ? 8 : 11;
  }

  // single-byte rep0 copy (decoder's IS_REP0_LONG==0 arm)
  void emit_shortrep(RangeEncoder& rc, size_t i, size_t dic_start) {
    const u32 pb_mask = (1u << pb_) - 1;
    const u32 pos_state = ((u32)(i - dic_start) + pos_base_) & pb_mask;
    rc.encode_bit(&probs_[IS_MATCH + (state_ << kPosBitsMax) + pos_state], 1);
    rc.encode_bit(&probs_[IS_REP + state_], 1);
    rc.encode_bit(&probs_[IS_REP_G0 + state_], 0);
    rc.encode_bit(
        &probs_[IS_REP0_LONG + (state_ << kPosBitsMax) + pos_state], 0);
    state_ = state_ < 7 ? 9 : 11;
  }

  void emit_match(RangeEncoder& rc, const u8* data, size_t i, size_t dic_start,
                  u32 dist, unsigned len) {
    // if the distance equals a current rep, emit the cheaper rep form
    for (int ri = 0; ri < 4; ri++) {
      if (rep_[ri] == dist) {
        emit_rep(rc, data, i, dic_start, ri, len);
        return;
      }
    }
    const u32 pb_mask = (1u << pb_) - 1;
    const u32 pos_state = ((u32)(i - dic_start) + pos_base_) & pb_mask;
    rc.encode_bit(&probs_[IS_MATCH + (state_ << kPosBitsMax) + pos_state], 1);
    rc.encode_bit(&probs_[IS_REP + state_], 0);
    rep_[3] = rep_[2]; rep_[2] = rep_[1]; rep_[1] = rep_[0];
    rep_[0] = dist;
    encode_len(rc, LEN_CODER, pos_state, len);
    encode_dist(rc, len, dist);
    state_ = state_ < 7 ? 7 : 10;
  }

  // Encode data[start:end); data[dic_start:start) is dictionary history.
  // total_n is the full buffer length — the match finder may look past
  // `end` when measuring candidates (caller caps emitted lengths), which
  // keeps decisions identical to the Python reference encoder.
  // External (device-computed) match candidates for the fast parse: row
  // ``ext[pos * ext_k + k]`` holds the k-th candidate distance for data
  // position ``pos`` (0 = none), nearest-first.  Produced by the TPU
  // sorted-bucket finder (ops/match_find.py); true lengths are re-measured
  // here with a memcmp, so candidates only need to be *valid*, not exact.
  void set_ext_candidates(const int32_t* ext, int k) {
    ext_ = ext;
    ext_k_ = k;
  }

  // Op record exported to the device range coder (2 u32 words per op):
  //   a = kind | (rep_index << 2) | (length << 4)
  //       kind: 0 literal, 1 match, 2 rep, 3 shortrep
  //   b = wire distance (match only; = best_dist - 1)
  // The op stream fully determines the emission: replaying it through the
  // adaptive model + range coder reproduces encode_segment's bytes.
  std::vector<u8> encode_segment(const u8* data, size_t total_n, size_t start,
                                 size_t end, size_t dic_start, bool end_mark,
                                 std::vector<u32>* ops_out = nullptr) {
    RangeEncoder rc;
    const u32 pb_mask = (1u << pb_) - 1;
    const u32 lp_mask = (1u << lp_) - 1;

    // persistent hash-chain finder: one table build per group/window (the
    // old per-sub-chunk rebuild re-inserted the whole prefix every 48KB)
    if (!ext_) {
      if (!hc_ || hc_data_ != data || hc_next_ > start) {
        hc_.reset(new MatchFinder(data, total_n, dict_size_, max_chain_,
                                  nice_len_, false, stream_cap_));
        hc_data_ = data;
        hc_next_ = dic_start;
      }
      hc_->set_n(total_n);
      while (hc_next_ < start) hc_->insert(hc_next_++);
    }
    auto mf_ins = [&](size_t j) {
      if (!ext_ && j >= hc_next_) {
        hc_->insert(j);
        hc_next_ = j + 1;
      }
    };
    auto probe = [&](size_t pi, unsigned* bl, u32* bd) {
      if (!ext_) {
        hc_->best_match(pi, end, bl, bd);
        return;
      }
      *bl = 0;
      *bd = 0;
      const size_t limit = (total_n - pi) < 273 ? (total_n - pi) : 273;
      for (int k = 0; k < ext_k_; k++) {
        const int32_t d = ext_[pi * (size_t)ext_k_ + k];
        if (d <= 0 || (int64_t)pi - d < (int64_t)dic_start ||
            (u32)d > dict_size_)
          continue;
        if (data[pi - d] != data[pi]) continue;
        const size_t ln = match_len(data + pi - d, data + pi, limit);
        if (ln > *bl) {
          *bl = (unsigned)ln;
          *bd = (u32)d;
        }
      }
    };

    int state = state_;
    u32 rep0 = rep_[0], rep1 = rep_[1], rep2 = rep_[2], rep3 = rep_[3];

    // lazy-probe carry: when the lookahead probe at i+1 rejects the match
    // at i, the loop advances to i+1 and would re-run the identical probe
    // (same finder state: i was inserted before the lookahead) — reuse it
    size_t carry_pos = (size_t)-1;
    unsigned carry_len = 0;
    u32 carry_dist = 0;

    size_t i = start;
    while (i < end) {
      const u32 pos = (u32)(i - dic_start) + pos_base_;
      const u32 pos_state = pos & pb_mask;

      unsigned best_len;
      u32 best_dist;
      if (i == carry_pos) {
        best_len = carry_len;
        best_dist = carry_dist;
      } else {
        probe(i, &best_len, &best_dist);
      }
      if (best_len > end - i) best_len = (unsigned)(end - i);
      if (best_len < kMatchMinLen) best_len = 0;

      unsigned rep_len[4] = {0, 0, 0, 0};
      const size_t avail = (end - i) < 273 ? end - i : 273;
      const u32 reps[4] = {rep0, rep1, rep2, rep3};
      for (int ri = 0; ri < 4; ri++) {
        const int64_t from = (int64_t)i - reps[ri] - 1;
        if (from < (int64_t)dic_start) continue;
        rep_len[ri] = (unsigned)match_len(data + from, data + i, avail);
      }
      int best_ri = 0;
      for (int ri = 1; ri < 4; ri++)
        if (rep_len[ri] > rep_len[best_ri]) best_ri = ri;
      const unsigned best_rep_len = rep_len[best_ri];

      bool use_match = best_len >= kMatchMinLen;
      if (use_match && best_len == 2 && best_dist > 512) use_match = false;
      // rep preference (GetOptimumFast parity, LzmaEnc.c:1489-1595
      // semantics): a rep within 1 of the main match always wins; within
      // 2 it wins against match distances >= 2^9; within 3 against
      // >= 2^15.  A chosen rep is taken WITHOUT lookahead (the reference
      // returns immediately on this branch).
      bool use_rep =
          best_rep_len >= 2 &&
          (!use_match || best_rep_len + 1 >= best_len ||
           (best_rep_len + 2 >= best_len && best_dist >= (1u << 9)) ||
           (best_rep_len + 3 >= best_len && best_dist >= (1u << 15)));
      if (use_rep) use_match = false;
      const unsigned chosen_len = use_rep ? best_rep_len : best_len;
      bool mf_inserted = false;
      if (use_match && i + 1 < end && best_len < (unsigned)nice_len_) {
        mf_ins(i);
        mf_inserted = true;
        unsigned nl;
        u32 nd;
        probe(i + 1, &nl, &nd);
        carry_pos = i + 1;
        carry_len = nl;
        carry_dist = nd;
        // ChangePair(s, b) := b > s * 128 — "the bigger distance is not
        // worth it unless 128x closer" rule of the reference's lazy
        // probe; the four defer-to-literal conditions mirror
        // GetOptimumFast's newLen/newDist tests verbatim-in-semantics
        const auto change_pair = [](u32 s, u32 b) {
          return (b >> 7) > s;
        };
        if ((nl >= best_len && nd < best_dist) ||
            (nl == best_len + 1 && !change_pair(best_dist, nd)) ||
            (nl > best_len + 1) ||
            (nl + 1 >= best_len && best_len >= 3 &&
             change_pair(nd, best_dist))) {
          use_match = false;
        } else {
          // a rep at i+1 within 1 of the match also defers to literal
          const unsigned lim =
              best_len - 1 < (unsigned)(end - (i + 1))
                  ? best_len - 1 : (unsigned)(end - (i + 1));
          for (int ri = 0; ri < 4 && use_match; ri++) {
            const int64_t from = (int64_t)(i + 1) - reps[ri] - 1;
            if (from < (int64_t)dic_start) continue;
            const unsigned l2 =
                (unsigned)match_len(data + from, data + i + 1, lim);
            if (l2 >= 2 && l2 + 1 >= best_len) use_match = false;
          }
        }
      }

      if (use_match || use_rep) {
        const bool is_rep = use_rep && !use_match;
        const unsigned length = is_rep ? best_rep_len : best_len;
        if (ops_out) {
          if (is_rep) {
            ops_out->push_back(2u | ((u32)best_ri << 2) | ((u32)length << 4));
            ops_out->push_back(0);
          } else {
            ops_out->push_back(1u | ((u32)length << 4));
            ops_out->push_back(best_dist - 1);
          }
        }
        rc.encode_bit(&probs_[IS_MATCH + (state << kPosBitsMax) + pos_state], 1);
        if (is_rep) {
          rc.encode_bit(&probs_[IS_REP + state], 1);
          if (best_ri == 0) {
            rc.encode_bit(&probs_[IS_REP_G0 + state], 0);
            rc.encode_bit(
                &probs_[IS_REP0_LONG + (state << kPosBitsMax) + pos_state], 1);
          } else {
            rc.encode_bit(&probs_[IS_REP_G0 + state], 1);
            if (best_ri == 1) {
              rc.encode_bit(&probs_[IS_REP_G1 + state], 0);
            } else {
              rc.encode_bit(&probs_[IS_REP_G1 + state], 1);
              rc.encode_bit(&probs_[IS_REP_G2 + state], best_ri == 3 ? 1 : 0);
            }
            const u32 dist = reps[best_ri];
            if (best_ri == 1) {
              rep1 = rep0;
            } else if (best_ri == 2) {
              rep2 = rep1;
              rep1 = rep0;
            } else {
              rep3 = rep2;
              rep2 = rep1;
              rep1 = rep0;
            }
            rep0 = dist;
          }
          encode_len(rc, REP_LEN_CODER, pos_state, length);
          state = state < 7 ? 8 : 11;
        } else {
          const u32 dist = best_dist - 1;
          rc.encode_bit(&probs_[IS_REP + state], 0);
          rep3 = rep2;
          rep2 = rep1;
          rep1 = rep0;
          rep0 = dist;
          encode_len(rc, LEN_CODER, pos_state, length);
          encode_dist(rc, length, dist);
          state = state < 7 ? 7 : 10;
        }
        if (!mf_inserted) mf_ins(i);
        for (size_t j = i + 1; j < i + length; j++) mf_ins(j);
        i += length;
      } else {
        // short-rep opportunity in match states
        if (rep_len[0] >= 1 && (int64_t)i - rep0 - 1 >= (int64_t)dic_start &&
            data[i - rep0 - 1] == data[i] && state >= 7) {
          if (ops_out) {
            ops_out->push_back(3u | (1u << 4));
            ops_out->push_back(0);
          }
          rc.encode_bit(&probs_[IS_MATCH + (state << kPosBitsMax) + pos_state], 1);
          rc.encode_bit(&probs_[IS_REP + state], 1);
          rc.encode_bit(&probs_[IS_REP_G0 + state], 0);
          rc.encode_bit(
              &probs_[IS_REP0_LONG + (state << kPosBitsMax) + pos_state], 0);
          state = state < 7 ? 9 : 11;
          if (!mf_inserted) mf_ins(i);
          i += 1;
          continue;
        }
        if (ops_out) {
          // literal record carries every data byte the coder needs, so a
          // replaying device lane never touches the raw data: the symbol,
          // the previous byte (literal context), and the matched byte
          // (only meaningful in states >= 7)
          const u8 pv = i > dic_start ? data[i - 1] : 0;
          const u8 mbv =
              (state >= 7 && (int64_t)i - rep0 - 1 >= (int64_t)dic_start)
                  ? data[i - rep0 - 1] : 0;
          ops_out->push_back(0u | (1u << 4));
          ops_out->push_back((u32)data[i] | ((u32)pv << 8) | ((u32)mbv << 16));
        }
        rc.encode_bit(&probs_[IS_MATCH + (state << kPosBitsMax) + pos_state], 0);
        const u8 prev = i > dic_start ? data[i - 1] : 0;
        const u32 lit_state = ((pos & lp_mask) << lc_) + (prev >> (8 - lc_));
        u16* base = &probs_[LITERAL + 0x300 * lit_state];
        const unsigned sym = data[i];
        if (state < 7) {
          unsigned m = 1;
          for (int bi = 7; bi >= 0; bi--) {
            const unsigned b = (sym >> bi) & 1;
            rc.encode_bit(&base[m], b);
            m = (m << 1) | b;
          }
        } else {
          unsigned mb = data[i - rep0 - 1];
          unsigned offs = 0x100;
          unsigned m = 1;
          for (int bi = 7; bi >= 0; bi--) {
            const unsigned b = (sym >> bi) & 1;
            mb <<= 1;
            const unsigned bc = mb & offs;
            rc.encode_bit(&base[offs + bc + m], b);
            m = (m << 1) | b;
            offs &= b ? bc : ~bc;
          }
        }
        state = state_after_literal(state);
        if (!mf_inserted) mf_ins(i);
        i += 1;
      }
    }

    if (end_mark) {
      const u32 pos_state = ((u32)(end - dic_start) + pos_base_) & pb_mask;
      rc.encode_bit(&probs_[IS_MATCH + (state << kPosBitsMax) + pos_state], 1);
      rc.encode_bit(&probs_[IS_REP + state], 0);
      encode_len(rc, LEN_CODER, pos_state, kMatchMinLen);
      encode_dist(rc, kMatchMinLen, 0xFFFFFFFFu);
      state = state < 7 ? 7 : 10;
      rep3 = rep2;
      rep2 = rep1;
      rep1 = rep0;
      rep0 = 0xFFFFFFFFu;
    }

    state_ = state;
    rep_[0] = rep0; rep_[1] = rep1; rep_[2] = rep2; rep_[3] = rep3;
    rc.flush();
    return std::move(rc.out);
  }

 private:
  static unsigned pos_slot(u32 dist) {
    if (dist < 4) return dist;
    int n = 31 - __builtin_clz(dist);
    return (n << 1) | ((dist >> (n - 1)) & 1);
  }

  void encode_len(RangeEncoder& rc, int base, u32 pos_state, unsigned len) {
    const unsigned sym = len - kMatchMinLen;
    if (sym < 8) {
      rc.encode_bit(&probs_[base + LEN_CHOICE], 0);
      rc.tree(&probs_[base + LEN_LOW + (pos_state << 3)], 3, sym);
    } else if (sym < 16) {
      rc.encode_bit(&probs_[base + LEN_CHOICE], 1);
      rc.encode_bit(&probs_[base + LEN_CHOICE2], 0);
      rc.tree(&probs_[base + LEN_MID + (pos_state << 3)], 3, sym - 8);
    } else {
      rc.encode_bit(&probs_[base + LEN_CHOICE], 1);
      rc.encode_bit(&probs_[base + LEN_CHOICE2], 1);
      rc.tree(&probs_[base + LEN_HIGH], 8, sym - 16);
    }
  }

  void encode_dist(RangeEncoder& rc, unsigned len, u32 dist) {
    const unsigned lt = (len - kMatchMinLen) < 4 ? len - kMatchMinLen : 3;
    const unsigned slot = pos_slot(dist);
    rc.tree(&probs_[POS_SLOT + (lt << 6)], 6, slot);
    if (slot >= 4) {
      const unsigned nd = (slot >> 1) - 1;
      const u32 base = (2 | (slot & 1)) << nd;
      const u32 rem = dist - base;
      if (slot < 14) {
        rc.tree_rev(&probs_[SPEC_POS + base - slot - 1], nd, rem);
      } else {
        rc.direct_bits(rem >> 4, nd - 4);
        rc.tree_rev(&probs_[ALIGN_], 4, rem & 15);
      }
    }
  }

  int lc_, lp_, pb_;
  u32 dict_size_;
  int max_chain_, nice_len_;
  std::vector<u16> probs_;
  int state_ = 0;
  u32 rep_[4] = {0, 0, 0, 0};
  const int32_t* ext_ = nullptr;   // device-computed match candidates
  int ext_k_ = 0;
  // persistent binary-tree finder for the optimal parse: one tree per
  // input buffer, fed forward across sub-chunk calls so a group is only
  // inserted once (recreated on buffer switch or rewind)
  std::unique_ptr<BtMatchFinder> bt_;
  const u8* bt_data_ = nullptr;
  size_t bt_next_ = 0;
  // persistent hash-chain finder (fast parse), same lifecycle
  std::unique_ptr<MatchFinder> hc_;
  const u8* hc_data_ = nullptr;
  size_t hc_next_ = 0;
  // streaming mode: finder tables sized for a sliding window of stream_cap_
  // bytes; pos_base_ = stream position of window byte `dic_start` (position
  // context must track the STREAM offset, not the window offset)
  size_t stream_cap_ = 0;
  u32 pos_base_ = 0;

 public:
  void set_stream_cap(size_t cap) { stream_cap_ = cap; }
  void set_pos_base(u32 b) { pos_base_ = b; }

  // slide the window by `delta` bytes (caller memmoves the data buffer)
  void slide_window(size_t delta) {
    if (hc_) {
      hc_->slide(delta);
      hc_next_ -= delta;
    }
    if (bt_) {
      bt_->slide(delta);
      bt_next_ -= delta;
    }
  }
};

// ==========================================================================
// CRC kernels (slicing-by-8)
// ==========================================================================

struct CrcTables {
  u32 t32[8][256];
  u64 t64[8][256];
  CrcTables() {
    for (u32 i = 0; i < 256; i++) {
      u32 r = i;
      for (int k = 0; k < 8; k++) r = (r >> 1) ^ (0xEDB88320u & (0u - (r & 1)));
      t32[0][i] = r;
      u64 q = i;
      for (int k = 0; k < 8; k++)
        q = (q >> 1) ^ (0xC96C5795D7870F42ull & (0ull - (q & 1)));
      t64[0][i] = q;
    }
    for (int k = 1; k < 8; k++)
      for (u32 i = 0; i < 256; i++) {
        t32[k][i] = (t32[k - 1][i] >> 8) ^ t32[0][t32[k - 1][i] & 0xFF];
        t64[k][i] = (t64[k - 1][i] >> 8) ^ t64[0][t64[k - 1][i] & 0xFF];
      }
  }
};

static const CrcTables g_crc;

u32 crc32(const u8* p, size_t n, u32 v) {
  u32 crc = ~v;
  while (n >= 8) {
    const u32 lo = crc ^ ((u32)p[0] | ((u32)p[1] << 8) | ((u32)p[2] << 16) |
                          ((u32)p[3] << 24));
    crc = g_crc.t32[7][lo & 0xFF] ^ g_crc.t32[6][(lo >> 8) & 0xFF] ^
          g_crc.t32[5][(lo >> 16) & 0xFF] ^ g_crc.t32[4][lo >> 24] ^
          g_crc.t32[3][p[4]] ^ g_crc.t32[2][p[5]] ^ g_crc.t32[1][p[6]] ^
          g_crc.t32[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ g_crc.t32[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

u64 crc64(const u8* p, size_t n, u64 v) {
  u64 crc = ~v;
  while (n--) crc = (crc >> 8) ^ g_crc.t64[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

}  // namespace lzt

// ==========================================================================
// C ABI
// ==========================================================================

extern "C" {

int lzt_lzma_decode(const uint8_t* src, size_t src_len, uint8_t* dst,
                    size_t* dst_len, int lc, int lp, int pb,
                    uint32_t dict_size, int has_size) {
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4)
    return lzt::ERR_PARAM;
  lzt::Decoder dec(lc, lp, pb, dict_size);
  std::vector<lzt::u8> out;
  out.reserve(has_size ? *dst_len : src_len * 4);
  size_t consumed = 0;
  bool mark = false;
  const size_t cap = *dst_len;
  int r = dec.decode(src, src_len, out, cap, !has_size, 0, &consumed,
                     &mark);
  if (r != lzt::OK) return r;
  if (out.size() > cap) return lzt::ERR_OUTPUT_EOF;
  std::memcpy(dst, out.data(), out.size());
  *dst_len = out.size();
  return lzt::OK;
}

// effort-10 BT walk cutoff (A/B knob; reference level-9 mc = 32)
static int opt_chain() {
  const char* e = getenv("LZT_OPT_CHAIN");
  return e ? atoi(e) : 48;
}

int lzt_lzma_encode(const uint8_t* src, size_t n, uint8_t* dst,
                    size_t* dst_len, int lc, int lp, int pb,
                    uint32_t dict_size, int end_mark, int effort) {
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4)
    return lzt::ERR_PARAM;
  const bool opt = effort >= 10;
  // opt mode: max_chain_ is the BT walk cutoff (reference mc=32 at fb=32),
  // nice_len_ the early-accept length; deeper/never-stop at effort ≥ 11
  const int chain = opt ? (effort >= 11 ? 128 : opt_chain()) : 16;
  const int nice = opt ? (effort >= 11 ? 273 : 64) : 64;
  lzt::Encoder enc(lc, lp, pb, dict_size, chain, nice);
  auto out = opt ? enc.encode_segment_opt(src, n, 0, n, 0, end_mark != 0)
                 : enc.encode_segment(src, n, 0, n, 0, end_mark != 0);
  if (out.size() > *dst_len) return lzt::ERR_OUTPUT_EOF;
  std::memcpy(dst, out.data(), out.size());
  *dst_len = out.size();
  return lzt::OK;
}

// Parse one dict-reset group for the device range coder: run the fast
// parse sub-chunk by sub-chunk (identical decisions to lzt_lzma2_encode's
// fast path), exporting the op stream, per-chunk table, and the native
// chunk bodies (ground truth for byte-identity checks / host fallback).
//
// chunk_tab: 3 int32 per chunk: [cum op words, cum unpack bytes,
// cum body bytes].  Returns SRes; ops_cap/body_cap/n_chunks are inout.
int lzt_lzma2_group_ops(const uint8_t* src, size_t n, uint32_t dict_size,
                        int lc, int lp, int pb, uint32_t sub_size,
                        uint32_t* ops, size_t* ops_cap,
                        int32_t* chunk_tab, int* n_chunks_io,
                        uint8_t* body, size_t* body_cap) {
  using namespace lzt;
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4)
    return ERR_PARAM;
  const size_t sub = sub_size ? sub_size : (48u << 10);
  // finder budget MUST match lzma2_encode_impl's fast path (chain 16 /
  // nice 64 + the same env knobs): the device range coder replays these
  // ops and its stream is asserted byte-identical to the host MT encoder
  int fchain = 16, fnice = 64;
  if (const char* ec = getenv("LZT_FAST_CHAIN")) fchain = atoi(ec);
  if (const char* en = getenv("LZT_FAST_NICE")) fnice = atoi(en);
  Encoder enc(lc, lp, pb, dict_size, fchain, fnice);
  enc.reset_state();
  std::vector<u32> all_ops;
  std::vector<u8> all_body;
  std::vector<int32_t> tab;
  size_t pos = 0;
  while (pos < n) {
    const size_t end = pos + sub < n ? pos + sub : n;
    auto b = enc.encode_segment(src, n, pos, end, 0, false, &all_ops);
    all_body.insert(all_body.end(), b.begin(), b.end());
    tab.push_back((int32_t)all_ops.size());
    tab.push_back((int32_t)end);
    tab.push_back((int32_t)all_body.size());
    pos = end;
  }
  if ((int)(tab.size() / 3) > *n_chunks_io) return ERR_OUTPUT_EOF;
  if (all_ops.size() > *ops_cap || all_body.size() > *body_cap)
    return ERR_OUTPUT_EOF;
  std::memcpy(ops, all_ops.data(), all_ops.size() * 4);
  std::memcpy(chunk_tab, tab.data(), tab.size() * 4);
  std::memcpy(body, all_body.data(), all_body.size());
  *ops_cap = all_ops.size();
  *body_cap = all_body.size();
  *n_chunks_io = (int)(tab.size() / 3);
  return OK;
}

uint32_t lzt_crc32(const uint8_t* p, size_t n, uint32_t v) {
  return lzt::crc32(p, n, v);
}

uint64_t lzt_crc64(const uint8_t* p, size_t n, uint64_t v) {
  return lzt::crc64(p, n, v);
}

}  // extern "C"

// ==========================================================================
// LZMA2 framing (chunk grammar of Lzma2Dec.c:14-26) over the scalar codec
// ==========================================================================

extern "C" {

// Encode to a raw LZMA2 stream with dict-reset groups (parallel=1) or a
// single continued stream (parallel=0).  Returns SRes; *prop_out gets the
// dict-size prop byte.
static int lzma2_encode_impl(const uint8_t* src, size_t n, uint8_t* dst,
                             size_t* dst_len, uint32_t dict_size,
                             uint32_t chunk_size, int parallel, int lc, int lp,
                             int pb, int effort, int* prop_out,
                             const int32_t* ext, int ext_k) {
  using namespace lzt;
  // smallest prop byte covering dict_size: size = (2|(k&1)) << (k/2+11)
  int prop = 40;
  for (int k = 0; k < 40; k++) {
    if (((u64)(2 | (k & 1)) << (k / 2 + 11)) >= dict_size) {
      prop = k;
      break;
    }
  }
  const u32 real_dict =
      prop == 40 ? 0xFFFFFFFFu : ((u32)(2 | (prop & 1)) << (prop / 2 + 11));
  *prop_out = prop;

  const size_t cap = *dst_len;
  size_t w = 0;
  const size_t sub_max = 48u << 10;  // packed must stay < 64 KB
  const size_t group_size = chunk_size ? chunk_size : (1u << 20);
  if (group_size > (1u << 21)) return ERR_PARAM;
  const size_t sub = sub_max < group_size ? sub_max : group_size;

  // effort ≤ 9 matches the Python reference finder parameters (48/64) so
  // the two backends stay byte-for-byte cross-checkable; effort ≥ 10 uses
  // the price-based optimal parser with a deeper finder
  const bool opt = effort >= 10;
  // fast-parse finder budget (effort < 10): HC4 chain walk 16 deep with
  // nice_len 64 — the reference level-1 work class (mc = 16+fb/2 >> 1 =
  // 16, LzmaEnc.c:70-74).  Measured on the bench slice: 12.4 MB/s at
  // 1.3% smaller than the oracle's level-1 output; the old 48-deep walk
  // bought 2.2% more size at 0.74x the speed (env knobs for A/B sweeps).
  int fchain = 16, fnice = 64;
  if (!opt) {
    const char* ec = getenv("LZT_FAST_CHAIN");
    const char* en = getenv("LZT_FAST_NICE");
    if (ec) fchain = atoi(ec);
    if (en) fnice = atoi(en);
  }
  Encoder enc(lc, lp, pb, real_dict, opt ? (effort >= 11 ? 128 : opt_chain()) : fchain,
              opt ? (effort >= 11 ? 273 : 64) : fnice);
  const u8 props_byte = (u8)((pb * 5 + lp) * 9 + lc);

  bool props_sent = false;
  size_t group_start = 0;
  while (group_start < n) {
    const size_t group_end =
        parallel ? (group_start + group_size < n ? group_start + group_size : n)
                 : n;
    // each dict-reset group is an independent slice: no match-finder state
    // or lookahead crosses group boundaries (also keeps multi-threaded
    // group encoding byte-identical to this single-threaded loop)
    const u8* gsrc = src + group_start;
    const size_t gn = group_end - group_start;
    // device candidates index positions relative to the group slice; the
    // optimal parser keeps its own deeper finder
    if (ext)
      enc.set_ext_candidates(ext + group_start * (size_t)ext_k, ext_k);
    enc.reset_state();
    bool first = true;
    bool need_reset = true;
    size_t pos = 0;
    while (pos < gn) {
      const size_t end = pos + sub < gn ? pos + sub : gn;
      const size_t unpack = end - pos;
      auto snap = enc.save();
      auto body = opt ? enc.encode_segment_opt(gsrc, gn, pos, end, 0, false)
                      : enc.encode_segment(gsrc, gn, pos, end, 0, false);
      const size_t lim = unpack < (1u << 16) ? unpack : (1u << 16);
      if (body.size() < lim) {
        int mode = first ? 3 : (need_reset ? (props_sent ? 1 : 2) : 0);
        props_sent = true;
        const size_t hdr = 5 + (mode >= 2 ? 1 : 0);
        if (w + hdr + body.size() > cap) return ERR_OUTPUT_EOF;
        const u32 u = (u32)unpack - 1;
        dst[w++] = (u8)(0x80 | (mode << 5) | (u >> 16));
        dst[w++] = (u8)(u >> 8);
        dst[w++] = (u8)u;
        dst[w++] = (u8)((body.size() - 1) >> 8);
        dst[w++] = (u8)(body.size() - 1);
        if (mode >= 2) dst[w++] = props_byte;
        std::memcpy(dst + w, body.data(), body.size());
        w += body.size();
        need_reset = false;
      } else {
        enc.restore(snap);
        // the next LZMA chunk carries a state-reset flag (the grammar
        // requires it after a copy chunk) and the decoder re-inits
        // probs/state/reps; the encoder must match, not merely restore
        enc.reset_state();
        size_t cpos = pos;
        while (cpos < end) {
          const size_t cend =
              cpos + (1u << 16) < end ? cpos + (1u << 16) : end;
          if (w + 3 + (cend - cpos) > cap) return ERR_OUTPUT_EOF;
          dst[w++] = first ? 1 : 2;
          dst[w++] = (u8)((cend - cpos - 1) >> 8);
          dst[w++] = (u8)(cend - cpos - 1);
          std::memcpy(dst + w, gsrc + cpos, cend - cpos);
          w += cend - cpos;
          first = false;
          cpos = cend;
        }
        need_reset = true;
      }
      first = false;
      pos = end;
    }
    group_start = group_end;
  }
  if (w + 1 > cap) return ERR_OUTPUT_EOF;
  dst[w++] = 0;  // EOS
  *dst_len = w;
  return OK;
}

int lzt_lzma2_encode(const uint8_t* src, size_t n, uint8_t* dst,
                     size_t* dst_len, uint32_t dict_size, uint32_t chunk_size,
                     int parallel, int lc, int lp, int pb, int effort,
                     int* prop_out) {
  return lzma2_encode_impl(src, n, dst, dst_len, dict_size, chunk_size,
                           parallel, lc, lp, pb, effort, prop_out, nullptr, 0);
}

// Same as lzt_lzma2_encode but the fast parse consumes device-computed
// match candidates: ext[pos * ext_k + k] = k-th candidate distance for
// absolute position pos of src (0 = none).  Candidate distances must not
// reach across dict-reset group boundaries (the TPU finder runs per chunk,
// so this holds by construction when chunk_size matches).
int lzt_lzma2_encode_ext(const uint8_t* src, size_t n, uint8_t* dst,
                         size_t* dst_len, uint32_t dict_size,
                         uint32_t chunk_size, int parallel, int lc, int lp,
                         int pb, int effort, int* prop_out,
                         const int32_t* ext, int ext_k) {
  return lzma2_encode_impl(src, n, dst, dst_len, dict_size, chunk_size,
                           parallel, lc, lp, pb, effort, prop_out, ext, ext_k);
}

// ---------------------------------------------------------------------------
// Streaming LZMA2 encoder: bounded-memory sliding window.  The reference
// streams through LzmaEnc_Encode2's <=32KB block loop (LzmaEnc.c:2154-2184)
// over a window with refill+MoveBlock (LzFind.c:57-121); here the window is
// a fixed-capacity buffer of dict + dict/2 + slack bytes, slid with finder
// position rebasing (the LzFind.c:285-320 normalization analog), so memory
// stays O(dict) for arbitrarily long inputs.
// ---------------------------------------------------------------------------

namespace lzt {

class StreamEnc {
 public:
  static constexpr size_t kSub = 48u << 10;   // packed must stay < 64 KB

  StreamEnc(u32 dict_size, int lc, int lp, int pb, int effort)
      : opt_(effort >= 10),
        props_byte_((u8)((pb * 5 + lp) * 9 + lc)) {
    // streaming dict cap 1 GB (the reference encoder's 64-bit max,
    // LzmaEnc.c:397-398) — keeps the 1.5x window arithmetic in range
    if (dict_size > (1u << 30)) dict_size = 1u << 30;
    // smallest LZMA2 prop covering dict_size (Lzma2Enc_WriteProperties)
    prop_ = 40;
    for (int k = 0; k < 40; k++) {
      if (((u64)(2 | (k & 1)) << (k / 2 + 11)) >= dict_size) {
        prop_ = k;
        break;
      }
    }
    real_dict_ = prop_ == 40 ? 0xFFFFFFFFu
                             : ((u32)(2 | (prop_ & 1)) << (prop_ / 2 + 11));
    enc_.reset(new Encoder(lc, lp, pb, real_dict_,
                           opt_ ? (effort >= 11 ? 128 : opt_chain()) : 16,
                           opt_ ? (effort >= 11 ? 273 : 64) : 64));
    // window: full dict history + dict/2 slide slack + lookahead margin
    cap_ = (size_t)real_dict_ + (size_t)real_dict_ / 2 + 4 * kSub + 1024;
    buf_.reserve(cap_);
    enc_->set_stream_cap(cap_);
    enc_->reset_state();
  }

  int prop() const { return prop_; }

  void feed(const u8* p, size_t n) {
    while (n) {
      const size_t room = cap_ - buf_.size();
      const size_t take = n < room ? n : room;
      buf_.insert(buf_.end(), p, p + take);
      p += take;
      n -= take;
      // keep a lookahead margin unencoded so sub-chunk-boundary match
      // decisions see up to kMatchMaxLen bytes ahead
      while (buf_.size() - local_pos() >= kSub + kMatchMaxLen)
        encode_sub(kSub);
      slide_if_needed();
    }
  }

  void finish() {
    while (local_pos() < buf_.size())
      encode_sub(kSub);
    out_.push_back(0);  // EOS
  }

  size_t drain(u8* dst, size_t cap) {
    const size_t n = out_.size() - drained_ < cap ? out_.size() - drained_
                                                  : cap;
    std::memcpy(dst, out_.data() + drained_, n);
    drained_ += n;
    if (drained_ == out_.size()) {
      out_.clear();
      drained_ = 0;
    }
    return n;
  }

  size_t pending() const { return out_.size() - drained_; }

 private:
  size_t local_pos() const { return (size_t)(pos_ - base_); }

  void encode_sub(size_t want) {
    const size_t lo = local_pos();
    const size_t avail = buf_.size() - lo;
    const size_t len = want < avail ? want : avail;
    if (!len) return;
    // position of window byte i is base_ + i; LZMA position context wraps
    // mod 2^32 exactly like the reference's UInt32 positions
    enc_->set_pos_base((u32)base_);
    auto snap = enc_->save();
    auto body = opt_
        ? enc_->encode_segment_opt(buf_.data(), buf_.size(), lo, lo + len,
                                   0, false)
        : enc_->encode_segment(buf_.data(), buf_.size(), lo, lo + len,
                               0, false);
    const size_t lim = len < (1u << 16) ? len : (1u << 16);
    if (body.size() < lim) {
      const int mode = first_ ? 3 : (need_reset_ ? (props_sent_ ? 1 : 2)
                                                 : 0);
      props_sent_ = true;
      const u32 u = (u32)len - 1;
      out_.push_back((u8)(0x80 | (mode << 5) | (u >> 16)));
      out_.push_back((u8)(u >> 8));
      out_.push_back((u8)u);
      out_.push_back((u8)((body.size() - 1) >> 8));
      out_.push_back((u8)(body.size() - 1));
      if (mode >= 2) out_.push_back(props_byte_);
      out_.insert(out_.end(), body.begin(), body.end());
      need_reset_ = false;
    } else {
      enc_->restore(snap);
      enc_->reset_state();  // decoder re-inits on the post-copy reset flag
      size_t cpos = lo;
      while (cpos < lo + len) {
        const size_t cend = cpos + (1u << 16) < lo + len ? cpos + (1u << 16)
                                                         : lo + len;
        out_.push_back(first_ ? 1 : 2);
        out_.push_back((u8)((cend - cpos - 1) >> 8));
        out_.push_back((u8)(cend - cpos - 1));
        out_.insert(out_.end(), buf_.data() + cpos, buf_.data() + cend);
        first_ = false;
        cpos = cend;
      }
      need_reset_ = true;
    }
    first_ = false;
    pos_ += len;
  }

  void slide_if_needed() {
    const size_t lo = local_pos();
    if (lo <= (size_t)real_dict_ + (size_t)real_dict_ / 2) return;
    const size_t delta = lo - real_dict_;   // keep exactly one dict of
    std::memmove(buf_.data(), buf_.data() + delta,   // history before pos
                 buf_.size() - delta);
    buf_.resize(buf_.size() - delta);
    enc_->slide_window(delta);
    base_ += delta;
  }

  bool opt_;
  u8 props_byte_;
  int prop_ = 40;
  u32 real_dict_ = 0;
  size_t cap_ = 0;
  std::unique_ptr<Encoder> enc_;
  std::vector<u8> buf_;      // window: [base_, base_ + buf_.size()) of stream
  u64 base_ = 0;             // stream offset of buf_[0]
  u64 pos_ = 0;              // stream offset of next byte to encode
  std::vector<u8> out_;
  size_t drained_ = 0;
  bool first_ = true;
  bool props_sent_ = false;
  bool need_reset_ = true;
};

}  // namespace lzt

void* lzt_stream_enc_new(uint32_t dict_size, int lc, int lp, int pb,
                         int effort, int* prop_out) {
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4)
    return nullptr;
  auto* h = new lzt::StreamEnc(dict_size, lc, lp, pb, effort);
  *prop_out = h->prop();
  return h;
}

void lzt_stream_enc_feed(void* h, const uint8_t* p, size_t n) {
  static_cast<lzt::StreamEnc*>(h)->feed(p, n);
}

void lzt_stream_enc_finish(void* h) {
  static_cast<lzt::StreamEnc*>(h)->finish();
}

size_t lzt_stream_enc_pending(void* h) {
  return static_cast<lzt::StreamEnc*>(h)->pending();
}

size_t lzt_stream_enc_drain(void* h, uint8_t* dst, size_t cap) {
  return static_cast<lzt::StreamEnc*>(h)->drain(dst, cap);
}

void lzt_stream_enc_free(void* h) {
  delete static_cast<lzt::StreamEnc*>(h);
}

// Decode a raw LZMA2 stream (no leading prop byte in src).
int lzt_lzma2_decode(const uint8_t* src, size_t n, uint8_t* dst,
                     size_t* dst_len, int prop) {
  using namespace lzt;
  if (prop > 40) return ERR_PARAM;
  const u32 dict =
      prop == 40 ? 0xFFFFFFFFu : ((u32)(2 | (prop & 1)) << (prop / 2 + 11));
  const size_t cap = *dst_len;
  std::vector<u8> out;
  std::unique_ptr<Decoder> dec;
  size_t pos = 0;
  size_t dic_start = 0;
  bool need_init_state = true;
  while (true) {
    if (pos >= n) return ERR_INPUT_EOF;
    const u8 ctrl = src[pos++];
    if (ctrl == 0) break;
    if (ctrl < 3) {  // copy chunk
      if (pos + 2 > n) return ERR_INPUT_EOF;
      const size_t size = ((size_t)src[pos] << 8 | src[pos + 1]) + 1;
      pos += 2;
      if (pos + size > n) return ERR_INPUT_EOF;
      if (ctrl == 1) dic_start = out.size();
      out.insert(out.end(), src + pos, src + pos + size);
      pos += size;
      need_init_state = true;
      continue;
    }
    if (ctrl < 0x80) return ERR_DATA;
    const int mode = (ctrl >> 5) & 3;
    if (pos + 4 > n) return ERR_INPUT_EOF;
    const size_t unpack =
        ((((size_t)ctrl & 0x1F) << 16) | ((size_t)src[pos] << 8) |
         src[pos + 1]) + 1;
    const size_t pack = (((size_t)src[pos + 2] << 8) | src[pos + 3]) + 1;
    pos += 4;
    if (mode >= 2) {
      if (pos >= n) return ERR_INPUT_EOF;
      const u8 d = src[pos++];
      if (d >= 9 * 5 * 5) return ERR_UNSUPPORTED;
      const int lc = d % 9, lp = (d / 9) % 5, pb = d / 45;
      if (!dec || dec->lc_ != lc || dec->lp_ != lp || dec->pb_ != pb)
        dec.reset(new Decoder(lc, lp, pb, dict));
      else
        dec->reset_state();
      need_init_state = false;
    } else if (mode == 1) {
      if (!dec) return ERR_DATA;
      dec->reset_state();
      need_init_state = false;
    } else if (!dec || need_init_state) {
      return ERR_DATA;
    }
    if (mode == 3) dic_start = out.size();
    if (pos + pack > n) return ERR_INPUT_EOF;
    size_t consumed = 0;
    bool mark = false;
    const size_t before = out.size();
    int r = dec->decode(src + pos, pack, out, unpack, false, dic_start,
                        &consumed, &mark);
    if (r != OK) return r;
    if (out.size() - before != unpack || consumed != pack) return ERR_DATA;
    pos += pack;
  }
  if (out.size() > cap) return ERR_OUTPUT_EOF;
  std::memcpy(dst, out.data(), out.size());
  *dst_len = out.size();
  return OK;
}

// ---------------------------------------------------------------------------
// Resumable streaming decoders — the native engine behind every streaming
// decode surface (zlike decompressobj, the xz push parser's block step,
// streaming 7z extraction).  The reference's equivalent is the C-hot
// LzmaDec_DecodeToBuf / LzmaDec_DecodeToDic pair (LzmaDec.c:719-878) and
// Lzma2Dec's header state machine (Lzma2Dec.c:47-157).
//
// Contract (both variants): feed(p, n, finish) consumes as much of p as a
// symbol/chunk boundary allows and RETURNS the consumed count — no input is
// retained, the caller re-presents the remainder (so the Python side keeps
// exactly one buffer).  Decoded bytes accumulate in an internal window
// (full dictionary history + undrained output) drained via read(); drained
// bytes older than the dictionary are trimmed, keeping memory O(dict).
// ---------------------------------------------------------------------------

namespace lzt {

// window-with-virtual-origin shared by both stream decoders
struct DecWindow {
  std::vector<u8> win;
  size_t emit_from = 0;        // first undrained byte
  long long dic_start = 0;     // may go negative after trims
  u64 total_out = 0;

  size_t pending() const { return win.size() - emit_from; }

  size_t read(u8* dst, size_t cap, u64 keep_hist) {
    const size_t n = pending() < cap ? pending() : cap;
    std::memcpy(dst, win.data() + emit_from, n);
    emit_from += n;
    trim(keep_hist);
    return n;
  }

  void trim(u64 keep_hist) {
    const long long drop0 = (long long)win.size() - (long long)keep_hist;
    long long drop = (long long)emit_from < drop0 ? (long long)emit_from
                                                  : drop0;
    if (drop > (64 << 10)) {   // amortize the front erase
      win.erase(win.begin(), win.begin() + drop);
      emit_from -= (size_t)drop;
      dic_start -= drop;
    }
  }
};

class StreamLzmaDec {
 public:
  // unpack < 0: decode until the end marker
  StreamLzmaDec(int lc, int lp, int pb, u32 dict, long long unpack)
      : dec_(lc, lp, pb, dict), dict_(dict), unpack_(unpack) {}

  // returns consumed bytes; check status() afterwards
  size_t feed(const u8* p, size_t n, bool finish) {
    if (status_ != 0) return 0;
    if (unpack_ == 0) {
      status_ = 1;
      return 0;
    }
    const size_t margin = finish ? 0 : 64;
    if (!finish) {
      // wait for the RC header + a full margin before starting; once
      // primed, skip the call (and its input copy) when below margin
      if (!started_ && n < 5 + margin) return 0;
      if (started_ && n < margin) return 0;
    }
    const bool until_mark = unpack_ < 0;
    const size_t remaining =
        until_mark ? 0 : (size_t)((u64)unpack_ - w_.total_out);
    size_t consumed = 0;
    bool mark = false;
    const size_t before = w_.win.size();
    int r = dec_.decode(p, n, w_.win, remaining, until_mark, w_.dic_start,
                        &consumed, &mark, margin, /*persist_rc=*/true);
    started_ = true;
    w_.total_out += w_.win.size() - before;
    if (r == PAUSED) return consumed;
    if (r != OK) {
      status_ = -r;
      return 0;
    }
    status_ = 1;  // done: mark seen or unpack target reached
    return consumed;
  }

  int status() const { return status_; }  // 0 running, 1 done, -err
  size_t pending() const { return w_.pending(); }
  u64 total_out() const { return w_.total_out; }
  size_t read(u8* dst, size_t cap) { return w_.read(dst, cap, dict_); }

 private:
  Decoder dec_;
  u64 dict_;
  long long unpack_;
  DecWindow w_;
  bool started_ = false;
  int status_ = 0;
};

class StreamLzma2Dec {
 public:
  explicit StreamLzma2Dec(u32 dict) : dict_(dict) {}

  size_t feed(const u8* p, size_t n, bool finish) {
    if (status_ != 0) return 0;
    size_t pos = 0;
    while (true) {
      if (pos >= n) {
        if (finish) status_ = -ERR_INPUT_EOF;  // no EOS marker
        return pos;
      }
      const u8 ctrl = p[pos];
      if (ctrl == 0) {  // EOS
        status_ = 1;
        return pos + 1;
      }
      if (ctrl < 3) {  // copy chunk
        if (pos + 3 > n) {
          if (finish) status_ = -ERR_INPUT_EOF;
          return pos;
        }
        const size_t size = ((size_t)p[pos + 1] << 8 | p[pos + 2]) + 1;
        if (pos + 3 + size > n) {
          if (finish) status_ = -ERR_INPUT_EOF;
          return pos;
        }
        if (ctrl == 1) w_.dic_start = (long long)w_.win.size();
        w_.win.insert(w_.win.end(), p + pos + 3, p + pos + 3 + size);
        w_.total_out += size;
        pos += 3 + size;
        need_init_state_ = true;
        continue;
      }
      if (ctrl < 0x80) {
        status_ = -ERR_DATA;
        return pos;
      }
      const int mode = (ctrl >> 5) & 3;
      const size_t hdr = 5 + (mode >= 2 ? 1 : 0);
      if (pos + hdr > n) {
        if (finish) status_ = -ERR_INPUT_EOF;
        return pos;
      }
      const size_t unpack =
          ((((size_t)ctrl & 0x1F) << 16) | ((size_t)p[pos + 1] << 8) |
           p[pos + 2]) + 1;
      const size_t pack = (((size_t)p[pos + 3] << 8) | p[pos + 4]) + 1;
      if (pos + hdr + pack > n) {
        if (finish) status_ = -ERR_INPUT_EOF;
        return pos;
      }
      if (mode >= 2) {
        const u8 d = p[pos + 5];
        if (d >= 9 * 5 * 5) {
          status_ = -ERR_UNSUPPORTED;
          return pos;
        }
        const int lc = d % 9, lp = (d / 9) % 5, pb = d / 45;
        if (!dec_ || dec_->lc_ != lc || dec_->lp_ != lp || dec_->pb_ != pb)
          dec_.reset(new Decoder(lc, lp, pb, dict_));
        else
          dec_->reset_state();
        need_init_state_ = false;
      } else if (mode == 1) {
        if (!dec_) {
          status_ = -ERR_DATA;
          return pos;
        }
        dec_->reset_state();
        need_init_state_ = false;
      } else if (!dec_ || need_init_state_) {
        status_ = -ERR_DATA;
        return pos;
      }
      if (mode == 3) w_.dic_start = (long long)w_.win.size();
      size_t consumed = 0;
      bool mark = false;
      const size_t before = w_.win.size();
      int r = dec_->decode(p + pos + hdr, pack, w_.win, unpack, false,
                           w_.dic_start, &consumed, &mark);
      if (r != OK) {
        status_ = -r;
        return pos;
      }
      if (w_.win.size() - before != unpack || consumed != pack) {
        status_ = -ERR_DATA;
        return pos;
      }
      w_.total_out += unpack;
      pos += hdr + pack;
    }
  }

  int status() const { return status_; }
  size_t pending() const { return w_.pending(); }
  u64 total_out() const { return w_.total_out; }
  size_t read(u8* dst, size_t cap) { return w_.read(dst, cap, dict_); }

 private:
  u64 dict_;
  std::unique_ptr<Decoder> dec_;
  DecWindow w_;
  bool need_init_state_ = true;
  int status_ = 0;
};

}  // namespace lzt

// raw LZMA resumable decoder ------------------------------------------------

void* lzt_stream_dec_new(int lc, int lp, int pb, uint32_t dict_size,
                         long long unpack_size) {
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4)
    return nullptr;
  return new lzt::StreamLzmaDec(lc, lp, pb, dict_size, unpack_size);
}

long long lzt_stream_dec_feed(void* h, const uint8_t* p, size_t n,
                              int finish) {
  return (long long)static_cast<lzt::StreamLzmaDec*>(h)->feed(p, n,
                                                              finish != 0);
}

int lzt_stream_dec_status(void* h) {
  return static_cast<lzt::StreamLzmaDec*>(h)->status();
}

size_t lzt_stream_dec_pending(void* h) {
  return static_cast<lzt::StreamLzmaDec*>(h)->pending();
}

unsigned long long lzt_stream_dec_total_out(void* h) {
  return static_cast<lzt::StreamLzmaDec*>(h)->total_out();
}

size_t lzt_stream_dec_read(void* h, uint8_t* dst, size_t cap) {
  return static_cast<lzt::StreamLzmaDec*>(h)->read(dst, cap);
}

void lzt_stream_dec_free(void* h) {
  delete static_cast<lzt::StreamLzmaDec*>(h);
}

// LZMA2 resumable decoder ---------------------------------------------------

void* lzt_stream2_dec_new(uint32_t dict_size) {
  return new lzt::StreamLzma2Dec(dict_size);
}

long long lzt_stream2_dec_feed(void* h, const uint8_t* p, size_t n,
                               int finish) {
  return (long long)static_cast<lzt::StreamLzma2Dec*>(h)->feed(p, n,
                                                               finish != 0);
}

int lzt_stream2_dec_status(void* h) {
  return static_cast<lzt::StreamLzma2Dec*>(h)->status();
}

size_t lzt_stream2_dec_pending(void* h) {
  return static_cast<lzt::StreamLzma2Dec*>(h)->pending();
}

unsigned long long lzt_stream2_dec_total_out(void* h) {
  return static_cast<lzt::StreamLzma2Dec*>(h)->total_out();
}

size_t lzt_stream2_dec_read(void* h, uint8_t* dst, size_t cap) {
  return static_cast<lzt::StreamLzma2Dec*>(h)->read(dst, cap);
}

void lzt_stream2_dec_free(void* h) {
  delete static_cast<lzt::StreamLzma2Dec*>(h);
}

}  // extern "C"
