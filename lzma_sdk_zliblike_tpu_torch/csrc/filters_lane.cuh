// Lane machines of X4's two scanning filters (device_filters.cu, after
// ops/device_filters.py of the JAX package), cut into the pieces that the
// kernels run on many threads of a block: the x86 BCJ converter
// (Bra86.c:11-85) and the BCJ2 4-stream decoder (Bcj2.c:28-127).
// cpu_harness.cc builds the very same code with g++ and calls the pieces in
// the kernels' order, with the thread count as an argument, so the tests
// can hold it against the plain PyTorch versions on a machine without a GPU.
//
// Both reproduce the JAX batch functions' rows bit for bit, which pins a
// few choices the host filters leave open: x86 starts from mask state 0,
// converts only p < valid - 4 and bounds the dest retry (Bra86.c:58-67) at
// 8 trips; BCJ2 takes its initial code from rc bytes 1-4 of the row
// whatever rc_len says, reads rc bytes past rc_len as 0, and fills a row
// as the JAX scatter does (see bcj2_place_run).  Neither reads or writes
// outside a lane's rows, whatever the lengths: an index past a row reads
// (x86: and writes) the row's last byte, as the JAX gathers clamp it.
//
// x86 in spans.  Call position s a sync point if in[s-4..s-1] holds no
// E8/E9 byte (position 0 is one).  The sequential machine enters a sync
// point in the state of a fresh start: its last visit lay at s - 5 or
// before, a conversion there patched at most up to s - 1, and its next
// visit, the first E8/E9 at or after s, has distance >= 5 and so mask 0.
// Every read goes to the unmodified input, so the stretches between sync
// points are independent and exact.  A block stages a tile of the row in
// two copies, one read and one patched; each thread moves the start of its
// span to the first sync point in it (x86_span_start) and runs the machine
// from there up to the next thread's start (x86_span).  A span with no sync
// point starts in a state the spans before it decide, one of at most 17
// (x86_entry_keys): its thread runs it from each and keeps the exit state
// each leads to, one thread chains the states through the tile
// (x86_chain_keys), and the span runs again from its own.  The run that
// reaches the tile's end hands its state on to the next tile's first
// thread, and the run whose conversion reaches past the tile its patched
// bytes there.  Visits at p >= row - 1 (only a valid past row + 3 leads
// there, where the JAX function keeps stepping at the clamped last
// position up to `row` times) are left to x86_tail: one thread, after all
// others, with the visits summed over the block.
//
// BCJ2 over compacted sites.  Only the range decoder is serial, and it
// steps only at sites.  A block lists the lane's candidate sites
// (bcj2_is_cand) in order; one walk over the list (bcj2_walk) records
// each conversion's output position and rel32; a block then writes every
// output byte from the conversions before it (bcj2_place_run).
#pragma once

#include <stdint.h>
#include <string.h>

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

__host__ __device__ __forceinline__ bool x86_cand(uint32_t b) { return (b & 0xFE) == 0xE8; }

// ---------------------------------------------------------------------------
// x86 BCJ
// ---------------------------------------------------------------------------

// The first E8/E9 byte of `in` at or after q (q past `last` reads from
// `last`), or `stop` when there is none below it: the JAX next-candidate
// table gives the row's length for none, and both end the scan unless the
// position is below the limit.
__host__ __device__ __forceinline__ int32_t x86_next(const uint8_t* in, int32_t q,
                                                    int32_t last, int32_t stop) {
  for (q = q < last ? q : last; q < stop; ++q)
    if (x86_cand(in[q])) return q;
  return stop;
}

// The machine between two visits: the position to scan on from, the
// prev-mask and the last visited position.
struct X86Scan {
  int32_t q;
  uint32_t mask;
  int32_t prev;
};

// The state in which the machine enters a sync point s.
__host__ __device__ __forceinline__ X86Scan x86_fresh(int32_t s) { return {s, 0u, s - 5}; }

__host__ __device__ __forceinline__ int ctz32(uint32_t f) {
#ifdef __CUDA_ARCH__
  return __ffs((int)f) - 1;
#else
  return __builtin_ctz(f);
#endif
}

__host__ __device__ __forceinline__ int popc32(uint32_t f) {
#ifdef __CUDA_ARCH__
  return __popc(f);
#else
  return __builtin_popcount(f);
#endif
}

// The E8/E9 bytes among b[0..cnt) (cnt <= 32, b 4-byte aligned), as bit j
// for b[j]: a word of a staged tile's bitmap.
__host__ __device__ __forceinline__ uint32_t x86_cand_bits(const uint8_t* b, int32_t cnt) {
  uint32_t f = 0;
  if (cnt == 32) {
    for (int k = 0; k < 8; ++k) {
#ifdef __CUDA_ARCH__
      const uint32_t w = reinterpret_cast<const uint32_t*>(b)[k];
#else
      uint32_t w;
      memcpy(&w, b + 4 * k, 4);
#endif
      for (int j = 0; j < 4; ++j)
        if (x86_cand(w >> (8 * j))) f |= 1u << (4 * k + j);
    }
  } else {
    for (int j = 0; j < cnt; ++j)
      if (x86_cand(b[j])) f |= 1u << j;
  }
  return f;
}

// The first E8/E9 byte at or after q and below lim, from the bitmap `cm`
// of the tile that starts at base (q >= base), or lim for none; q itself
// when it is at or past lim.
__host__ __device__ __forceinline__ int32_t x86_tile_next(const uint32_t* cm, int32_t base,
                                                         int32_t q, int32_t lim) {
  if (q >= lim) return q;
  for (int32_t k = q - base; base + k < lim; k = (k | 31) + 1) {
    const uint32_t w = cm[k >> 5] >> (k & 31);
    if (w) return base + k + ctz32(w) < lim ? base + k + ctz32(w) : lim;
  }
  return lim;
}

// Visits below this position run in spans: min(valid - 4, row - 1), and 0
// when no visit is left.
__host__ __device__ __forceinline__ int32_t x86_body_end(int64_t limit, int32_t row) {
  return limit <= 0 ? 0 : limit < row - 1 ? (int32_t)limit : row - 1;
}

// A lane's unmodified input: positions base..base+n-1 from the staged tile
// `buf` (the copy no run patches), any other from the row `in`; an index
// past the row reads its last byte.
struct X86Src {
  const uint8_t* in;
  const uint8_t* buf;
  int32_t base, n, last;
  __host__ __device__ __forceinline__ uint32_t operator()(int32_t i) const {
    if (i > last) i = last;
    const uint32_t k = (uint32_t)(i - base);
    return k < (uint32_t)n ? buf[k] : in[i];
  }
};

// Patch writes that fall past a tile (at most the 4 bytes of one
// conversion), applied to the next tile in order.
struct X86Pending {
  int32_t pos[4];
  uint8_t val[4];
  int32_t n;
};

// A range's patch writes: into the tile's output copy, or past it into
// `pend`.
struct X86Put {
  uint8_t* buf;
  int32_t base, n;
  X86Pending* pend;
  __host__ __device__ __forceinline__ void operator()(int32_t i, uint8_t v) {
    const uint32_t k = (uint32_t)(i - base);
    if (k < (uint32_t)n) {
      buf[k] = v;
    } else {
      pend->pos[pend->n] = i;
      pend->val[pend->n] = v;
      ++pend->n;
    }
  }
};

// The patch writes of a run whose entry state is a guess: dropped.
struct X86Drop {
  __host__ __device__ __forceinline__ void operator()(int32_t, uint8_t) {}
};

// The nominal start of span t of `spans` over the staged tile
// base..base+n-1: base + t * ceil(n / spans), cut to the tile's end.
__host__ __device__ __forceinline__ int32_t x86_span_a(int32_t t, int32_t spans, int32_t base,
                                                      int32_t n) {
  const int64_t a = base + (int64_t)t * ((n + spans - 1) / spans);
  return a < base + n ? (int32_t)a : base + n;
}

// The first sync point in [a, end), or -1 for none.  Reads the 4 bytes
// before a, which may lie in the tile before.
__host__ __device__ inline int32_t x86_sync_in(const X86Src& src, int32_t a, int32_t end) {
  int32_t run = a < 4 ? 4 - a : 0;   // bytes without E8/E9 just before s
  for (int32_t i = a < 4 ? 0 : a - 4; i < a; ++i) run = x86_cand(src(i)) ? 0 : run + 1;
  for (int32_t s = a; s < end; ++s) {
    if (run >= 4) return s;
    run = x86_cand(src(s)) ? 0 : run + 1;
  }
  return -1;
}

// Where span t's range starts, and whether the machine's state there is
// known before the spans ahead of it have run: span 0 starts at the tile's
// start (in the state the tile before handed on), a span with a sync point
// at its first one (the fresh state), a span without one at its nominal
// start (state unknown: x86_entry_keys), a span past the tile's end at
// that end (empty).  A range runs to the next span's start.
struct X86Start {
  int32_t s;
  bool known;
};

__host__ __device__ inline X86Start x86_span_start(const X86Src& src, int32_t t, int32_t spans,
                                                   int32_t base, int32_t n) {
  if (t == 0) return {base, true};
  const int32_t a = x86_span_a(t, spans, base, n), a1 = x86_span_a(t + 1, spans, base, n);
  if (a >= a1) return {base + n, true};
  const int32_t s = x86_sync_in(src, a, a1);
  return s >= 0 ? X86Start{s, true} : X86Start{a, false};
}

// The machine's state at a range boundary b (st.q >= b, as x86_span
// leaves it), as a key under which states behave alike from b on: 0 for a
// scan at b whose next visit has distance > 3 (the fresh state), 1..4 for
// a scan resuming at b + 1..b + 4 after a conversion at b - 4..b - 1, and
// 5 + 8 (k - 1) + mask after a skip at b - k (k = 1..3).
constexpr int kX86EntryKeys = 17;   // most keys x86_entry_keys lists

__host__ __device__ __forceinline__ int x86_state_key(const X86Scan& st, int32_t b) {
  if (st.q > b) return st.q - b;
  const int32_t k = b - st.prev;
  return k > 3 ? 0 : 5 + 8 * (k - 1) + (int)st.mask;
}

__host__ __device__ __forceinline__ X86Scan x86_key_state(int key, int32_t b) {
  if (key == 0) return x86_fresh(b);
  if (key <= 4) return {b + key, 0u, b + key - 5};
  return {b, (uint32_t)((key - 5) & 7), b - 1 - (key - 5) / 8};
}

// The keys of every state the machine can enter position a in, from the
// bytes before it: the fresh state; a conversion at an E8/E9 at a - 4..
// a - 1; a skip at an E8/E9 at a - 3..a - 1, whose mask is odd.  Writes
// them to keys[] and returns how many (at most kX86EntryKeys).
__host__ __device__ inline int x86_entry_keys(const X86Src& src, int32_t a, uint8_t* keys) {
  int n = 0;
  keys[n++] = 0;
  for (int r = 1; r <= 4; ++r)
    if (a + r - 5 >= 0 && x86_cand(src(a + r - 5))) keys[n++] = (uint8_t)r;
  for (int k = 1; k <= 3; ++k)
    if (a - k >= 0 && x86_cand(src(a - k)))
      for (int m = 1; m < 8; m += 2) keys[n++] = (uint8_t)(5 + 8 * (k - 1) + m);
  return n;
}

// One visit of the machine at E8/E9 position p (or at the clamped end, in
// x86_tail): updates mask and prev and returns true, with the word to
// write in `dest`, where the site converts.
__host__ __device__ __forceinline__ bool x86_visit(const X86Src& src, int32_t p, uint32_t& mask,
                                                   int32_t& prev, uint32_t ip, bool encoding,
                                                   uint32_t& dest) {
  const int32_t d = p - prev;
  prev = p;
  mask = d > 3 ? 0 : (mask << (d > 1 ? d - 1 : 0)) & 7;
  const uint32_t m2b = mask_to_bit(mask);
  if ((mask != 0 && (!mask_allowed(mask) || test86(src(p + 4 - m2b)))) || !test86(src(p + 4))) {
    mask = ((mask << 1) & 7) | 1;
    return false;
  }
  uint32_t s = src(p + 1) | (src(p + 2) << 8) | (src(p + 3) << 16) | (src(p + 4) << 24);
  const uint32_t pos = ip + (uint32_t)p + 5;
  const uint32_t idx8 = m2b * 8;
  dest = 0;
  for (int t = 0; t < 8; ++t) {
    dest = encoding ? s + pos : s - pos;
    if (mask == 0 || !test86((dest >> (24 - idx8)) & 0xFF)) break;
    s = dest ^ ((1u << (32 - idx8)) - 1);
  }
  dest &= 0x01FFFFFF;
  if (dest & 0x01000000) dest |= 0xFE000000;
  return true;
}

// Runs the machine from `st` over the E8/E9 bytes below min(end, vend),
// which lie in the staged tile whose E8/E9 bitmap is `cm` (a span's sites:
// the caller's st.q is at or past the tile's start wherever one is left),
// patching through `put`
// (indexes past the row go to its last byte).  Returns the visits and
// leaves the state after them in `st`.  Runs read the input copy and patch
// the output copy, and only a run from the machine's true state patches:
// each byte is patched by the one run that visits its site.
template <class Put>
__host__ __device__ inline int32_t x86_span(const X86Src& src, const uint32_t* cm, Put& put,
                                            X86Scan& st, int32_t end, int32_t vend, uint32_t ip,
                                            bool encoding) {
  const int32_t lim = end < vend ? end : vend;
  int32_t q = st.q, prev = st.prev, visits = 0;
  uint32_t mask = st.mask;
  for (;;) {
    q = x86_tile_next(cm, src.base, q, lim);
    if (q >= lim) break;
    ++visits;
    uint32_t dest;
    if (x86_visit(src, q, mask, prev, ip, encoding, dest)) {
      for (int j = 0; j < 4; ++j) {
        const int32_t w = q + 1 + j;
        put(w < src.last ? w : src.last, (uint8_t)(dest >> (8 * j)));
      }
      q += 5;
    } else {
      q += 1;
    }
  }
  st = {q, mask, prev};
  return visits;
}

// The entry keys of the ranges whose state was unknown, in order: range
// u enters in range u - 1's exit state.  A known range's exit key is
// key_out[u]; an unknown range's is looked up in its table (keys[] and
// exits[], kX86EntryKeys a range, nkeys[u] of them) or, were its entry key
// missing there, found by running the range.  One thread, once every
// range has run or been tabulated.
__host__ __device__ inline void x86_chain_keys(const X86Src& src, const uint32_t* cm,
                                               const int32_t* start, const uint8_t* known,
                                               const uint8_t* key_out, const uint8_t* nkeys,
                                               const uint8_t* keys, const uint8_t* exits,
                                               uint8_t* key_in, int spans, int32_t vend,
                                               uint32_t ip, bool encoding) {
  const int32_t end = src.base + src.n;
  int key = key_out[0];
  for (int u = 1; u < spans && start[u] < end; ++u) {
    if (known[u]) {
      key = key_out[u];
      continue;
    }
    key_in[u] = (uint8_t)key;
    int j = 0;
    while (j < nkeys[u] && keys[u * kX86EntryKeys + j] != key) ++j;
    if (j < nkeys[u]) {
      key = exits[u * kX86EntryKeys + j];
      continue;
    }
    X86Scan st = x86_key_state(key, start[u]);
    X86Drop drop;
    x86_span(src, cm, drop, st, start[u + 1], vend, ip, encoding);
    key = x86_state_key(st, start[u + 1]);
  }
}

// The visits at p >= row - 1 that follow the spans' (`it` of them), from
// the state `st` of the last span: the JAX function's scan there stays at
// the row's last byte (an E8/E9) or at `row` until it has made `row` steps
// or passes the limit, reading and writing the clamped last byte.  Reads
// the row `in`; every write goes to the last byte, through `put`.
template <class Put>
__host__ __device__ inline void x86_tail(const uint8_t* in, int32_t row, int64_t limit,
                                         uint32_t ip, bool encoding, X86Scan st, int32_t it,
                                         Put& put) {
  if (limit <= 0) return;
  const int32_t stop = limit < row ? (int32_t)limit : row;
  const int32_t last = row - 1;
  const X86Src src = {in, nullptr, 0, 0, last};
  uint32_t mask = st.mask;
  int32_t prev = st.prev;
  for (int32_t p = x86_next(in, st.q, last, stop); it < row && p < limit; ++it) {
    uint32_t dest;
    if (x86_visit(src, p, mask, prev, ip, encoding, dest)) {
      for (int j = 0; j < 4; ++j) put(last, (uint8_t)(dest >> (8 * j)));
      p = x86_next(in, p + 5, last, stop);
    } else {
      p = x86_next(in, p + 1, last, stop);
    }
  }
}

// ---------------------------------------------------------------------------
// BCJ2 decode
// ---------------------------------------------------------------------------

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
constexpr int kBcj2Seg = 16;   // main or output bytes a thread takes per tile

// Conversions whose site byte lies in an output range of `tile` + 4 bytes
// (sites lie 5 or more apart): at most this many.
__host__ __device__ constexpr int32_t bcj2_tile_cap(int32_t tile) { return (tile + 4) / 5 + 1; }

__host__ __device__ __forceinline__ int32_t main_end_of(int32_t main_len, int32_t main_w) {
  return main_len < 0 ? 0 : main_len < main_w ? main_len : main_w;
}

__host__ __device__ __forceinline__ uint32_t be32(const uint8_t* row, int32_t w, int32_t i) {
  return (byte_at(row, w, i) << 24) | (byte_at(row, w, i + 1) << 16) |
         (byte_at(row, w, i + 2) << 8) | byte_at(row, w, i + 3);
}

// An entry of a lane's site list: before the walk, a candidate's position
// and its byte | the main byte before it << 8 (0 at position 0); after it,
// a conversion's site byte's position in the output and its rel32.
struct alignas(8) Bcj2Entry {
  uint32_t a, b;
};

// Whether main byte b at p > 0 after byte pb, or at p == 0, can be a site:
// E8/E9, or 8x after 0F or after a byte that could be a converted site
// itself (whose rel32 may end in 0F).  A Jcc after any other byte never
// is: the decoder's prev is then that byte.
__host__ __device__ __forceinline__ bool bcj2_is_cand(uint32_t b, uint32_t pb, int32_t p) {
  if ((b & 0xFE) == 0xE8) return true;
  return (b & 0xF0) == 0x80 && p > 0 &&
         (pb == 0x0F || (pb & 0xFE) == 0xE8 || (pb & 0xF0) == 0x80);
}

// The candidate sites among main bytes p0..p0+cnt-1 (cnt <= kBcj2Seg), as
// bit j for p0 + j; w[j] is byte p0 + j, and w[-1] the one before it when
// p0 > 0.
__host__ __device__ __forceinline__ uint32_t bcj2_seg_flags(const uint8_t* w, int32_t p0,
                                                           int32_t cnt) {
  uint32_t f = 0, pb = p0 > 0 ? w[-1] : 0;
  for (int j = 0; j < cnt; ++j) {
    const uint32_t b = w[j];
    if (bcj2_is_cand(b, pb, p0 + j)) f |= 1u << j;
    pb = b;
  }
  return f;
}

// Writes the candidates of bcj2_seg_flags's `f` to out[0..], in order.
__host__ __device__ __forceinline__ void bcj2_seg_write(const uint8_t* w, int32_t p0, uint32_t f,
                                                       Bcj2Entry* out) {
  for (int k = 0; f; f &= f - 1, ++k) {
    const int j = ctz32(f);
    const uint32_t pb = p0 + j > 0 ? w[j - 1] : 0;
    out[k] = {(uint32_t)(p0 + j), w[j] | (pb << 8)};
  }
}

struct Bcj2Walk {
  int32_t nconv, steps;
  bool ok;
};

// The BE target words of a call or jump row of w bytes, as the walk reads
// them: word k is be32(row, w, 4 k) (bytes past the row read its last
// byte), stored for k < bcj2_words(w); every word past those equals the
// last one.  A pass over the rows before the walk fills them, so that a
// conversion reads one word.
__host__ __device__ __forceinline__ int32_t bcj2_words(int32_t w) { return (w + 3) / 4 + 1; }

// A load through the card's read-only (non-coherent) data path, for data
// that no thread writes while the kernel reads it; a plain load on the
// host.
template <class T>
__host__ __device__ __forceinline__ T ldg(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// The walk's streams, read in order: list(i) for i = 0, 1, 2, ..., the
// target words call(k) and jump(k) for k = 0, 4, 8, ... and the rc bytes
// rc(k) for k = 5, 6, 7, ... (0 past rc_len).
struct Bcj2Streams {
  const Bcj2Entry* cand;
  const uint32_t *cw, *jw;   // bcj2_words(call_w) and bcj2_words(jump_w) words
  const Bcj2Lane* L;
  // (through the read-only cache too: the walk writes entry k over the
  // list only after reading it)
  __host__ __device__ __forceinline__ Bcj2Entry list(int32_t i) const {
#ifdef __CUDA_ARCH__
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(cand + i));
    return {v.x, v.y};
#else
    return cand[i];
#endif
  }
  __host__ __device__ __forceinline__ uint32_t call(int32_t k) const {
    const int32_t n = bcj2_words(L->call_w);
    return ldg(cw + ((k >> 2) < n ? k >> 2 : n - 1));
  }
  __host__ __device__ __forceinline__ uint32_t jump(int32_t k) const {
    const int32_t n = bcj2_words(L->jump_w);
    return ldg(jw + ((k >> 2) < n ? k >> 2 : n - 1));
  }
  __host__ __device__ __forceinline__ uint32_t rc(int32_t k) const {
    return k < L->rc_len ? ldg(L->rc + (k < L->rc_w ? k : L->rc_w - 1)) : 0u;
  }
};

// The range decoder over the lane's candidates in.list(0..ncand-1), in
// order: the sequential machine's decisions at its sites, with its
// prev/last_top (a Jcc or E8 right after a converted site takes the top
// byte of that site's rel32), its stop once the output is full and its
// failure where a call or jump stream runs out.  Hands conversion k to
// put(k, {the output position of its site byte, its rel32}) (put may write
// over the list: entry k is handed on after entries 0..k+2 are read).
// probs holds the 258 probabilities.  Every stream is read ahead of the
// step that needs it: the list two entries ahead, the rc bytes and the
// call and jump words one.  Returns the conversions, the decoder steps and ok: no stream ran out,
// and main_used = out_size - 4 * conversions lies within 0..main_len.
template <class Put>
__host__ __device__ inline Bcj2Walk bcj2_walk(const Bcj2Lane& L, uint16_t* probs,
                                              const Bcj2Streams& in, int32_t ncand, Put& put) {
  for (int i = 0; i < kBcj2Probs; ++i) probs[i] = 1024;
  uint32_t code = be32(L.rc, L.rc_w, 1);
  uint32_t rng = 0xFFFFFFFFu;
  int32_t rcpos = 5, nconv = 0, cpos = 0, jpos = 0, lastc = -2, steps = 0;
  uint32_t last_top = 0;
  uint32_t rcnext = in.rc(rcpos), cword = in.call(0), jword = in.jump(0);
  Bcj2Entry e1 = ncand > 0 ? in.list(0) : Bcj2Entry{0, 0};
  Bcj2Entry e2 = ncand > 1 ? in.list(1) : Bcj2Entry{0, 0};
  for (int32_t i = 0; i < ncand; ++i) {
    const Bcj2Entry e = e1;
    e1 = e2;
    if (i + 2 < ncand) e2 = in.list(i + 2);
    const int32_t p = (int32_t)e.a;
    const uint32_t b = e.b & 0xFF;
    const int32_t out_after = p + 4 * nconv + 1;
    if (out_after >= L.out_size) break;   // no flag once the output is full
    const uint32_t prev = lastc == p - 1 ? last_top : e.b >> 8;
    const bool e8 = b == 0xE8, e9 = b == 0xE9;
    if (!e8 && !e9 && prev != 0x0F) continue;
    ++steps;
    const int pidx = e8 ? 2 + (int)prev : e9 ? 0 : 1;
    if (rng < (1u << 24)) {
      code = (code << 8) | rcnext;
      rng <<= 8;
      rcnext = in.rc(++rcpos);
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
    uint32_t dest;
    if (e8) {
      if (cpos + 4 > L.call_len) return {nconv, steps, false};
      dest = cword;
      cpos += 4;
      cword = in.call(cpos);
    } else {
      if (jpos + 4 > L.jump_len) return {nconv, steps, false};
      dest = jword;
      jpos += 4;
      jword = in.jump(jpos);
    }
    const uint32_t rel = dest - (uint32_t)(out_after + 4);
    put(nconv, Bcj2Entry{(uint32_t)(out_after - 1), rel});
    lastc = p;
    last_top = rel >> 24;
    ++nconv;
  }
  const int32_t main_used = L.out_size - 4 * nconv;
  return {nconv, steps, main_used >= 0 && main_used <= L.main_len};
}

// A block's search for how many of a lane's conversions (ascending sites)
// lie below `key`, T threads at a time: probe(t) is the index thread t
// tests (or -1), and update(c) takes how many tests found a site below
// key (the tests of threads 0..c-1).  Entries [0, lo) lie below key and
// [hi, n) do not; done() when lo == hi, the answer.
struct Bcj2Search {
  int32_t lo, hi, stride;
  __host__ __device__ __forceinline__ bool done() const { return lo >= hi; }
  __host__ __device__ __forceinline__ int32_t probe(int32_t t, int32_t T) {
    stride = (hi - lo + T - 1) / T;
    const int64_t k = lo + (int64_t)t * stride;
    return k < hi ? (int32_t)k : -1;
  }
  __host__ __device__ __forceinline__ void update(int32_t c) {
    if (c == 0) {
      hi = lo;
      return;
    }
    const int64_t first_not = lo + (int64_t)c * stride;
    lo += (c - 1) * stride + 1;
    if (first_not < hi) hi = (int32_t)first_not;
  }
};

// How many of site[0..n) (ascending) lie below o.
__host__ __device__ __forceinline__ int32_t bcj2_sites_below(const int32_t* site, int32_t n,
                                                            int32_t o) {
  int32_t lo = 0, hi = n;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (site[mid] < o)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Output bytes o0..o1-1 of a lane, through put(o, byte), as the sequential
// machine leaves its zeroed row: byte o is the rel32 (LE) of the last
// conversion whose site byte lies before it where it lies in that rel32,
// else main byte p = o - 4 * (conversions before o) where p < main_lim
// (main_used, cut to the main stream's row), else 0.  site/rel[0..n) are
// conversions kbase..kbase+n-1 (ascending sites), which hold every
// conversion with a site byte in o0 - 4..o1-1; the ones before lie below
// o0 - 4.
template <class Put>
__host__ __device__ inline void bcj2_place_run(int32_t o0, int32_t o1, const int32_t* site,
                                               const uint32_t* rel, int32_t n, int32_t kbase,
                                               const uint8_t* main, int32_t main_lim, Put& put) {
  int32_t c = bcj2_sites_below(site, n, o0);
  for (int32_t o = o0; o < o1; ++o) {
    while (c < n && site[c] < o) ++c;
    uint8_t v;
    if (c > 0 && o - site[c - 1] <= 4) {
      v = (uint8_t)(rel[c - 1] >> (8 * (o - site[c - 1] - 1)));
    } else {
      const int32_t p = o - 4 * (kbase + c);
      v = p < main_lim ? main[p] : 0;
    }
    put(o, v);
  }
}

}  // namespace filt
}  // namespace lzt
