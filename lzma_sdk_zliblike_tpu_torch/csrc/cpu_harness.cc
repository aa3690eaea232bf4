// Test-only CPU build of the per-lane code that group_decode.cu (K1) and
// range_encode.cu (K2) run on the GPU, of the per-element bit call of
// the probes v12_probe.cu (P1) and compact_probe.cu (P2), of the block step
// and tree join of checksum.cu (X3) and of the pieces of
// device_filters.cu (X4): the same lzma_lane.cuh, lzma_enc_lane.cuh,
// probe_lane.cuh, checksum_lane.cuh and filters_lane.cuh, compiled by g++,
// looping over lanes or elements on the host (and, for K1, K2 and X4, over
// the threads of a block).  The tests/test_torch_*.py
// files build it and hold it against the plain versions in ops/ and tools/;
// the package never loads it.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libcpu_harness.so cpu_harness.cc

#include <stdint.h>

#include <algorithm>
#include <vector>

#include "checksum_lane.cuh"
#include "filters_lane.cuh"
#include "lzma_enc_lane.cuh"
#include "lzma_lane.cuh"
#include "probe_lane.cuh"

// lzt_group_decode (group_decode.cu) on the host, same arguments but the
// stream, plus the ring's `window` (a power of two >= lzt::kMinWindow; the
// card's launcher derives it).  One call plays the lane's 32 threads.
extern "C" int lzt_group_decode_cpu(const void* src, long long pack_cap,
                                    const void* pack_ends, const void* unpack_ends,
                                    const void* flags, int n_chunks,
                                    const void* active, void* out, long long dic_cap,
                                    void* ok, void* consumed, void* iterations,
                                    void* bit_calls, int n_lanes, int lc, int lp,
                                    int pb, int window) {
  if (window < (int)lzt::kMinWindow || (window & (window - 1))) return 1;
  std::vector<uint16_t> probs(lzt::num_probs(lc, lp));
  std::vector<uint8_t> inbuf(lzt::kStageBuf), ring(window);
  for (int lane = 0; lane < n_lanes; ++lane) {
    lzt::LaneStatus s = {1, 0, 0, 0};
    if (((const int32_t*)active)[lane]) {
      const int64_t t = (int64_t)lane * n_chunks;
      s = lzt::decode_lane((const uint8_t*)src + (int64_t)lane * pack_cap,
                           (uint32_t)pack_cap, (const int32_t*)pack_ends + t,
                           (const int32_t*)unpack_ends + t, (const int32_t*)flags + t,
                           n_chunks, (uint8_t*)out + (int64_t)lane * dic_cap,
                           (uint32_t)dic_cap, probs.data(), inbuf.data(), ring.data(),
                           (uint32_t)window, lc, lp, pb, lzt::Threads{0, lzt::kT});
    }
    ((int32_t*)ok)[lane] = s.ok;
    ((int32_t*)consumed)[lane] = s.consumed;
    ((int32_t*)iterations)[lane] = s.iterations;
    ((int32_t*)bit_calls)[lane] = s.bit_calls;
  }
  return 0;
}

// lzt_range_encode (range_encode.cu) on the host, same arguments but the
// marks and the stream: the walk of every lane, then the code step of every
// (lane, chunk), then the gather of every lane, each playing its block's
// threads in a loop, over the same scratch layout.
extern "C" int lzt_range_encode_cpu(const void* ops, long long op_cap, const void* op_ends,
                                    int n_chunks, const void* active, void* out,
                                    long long out_cap, void* tab, void* ok, void* bytes,
                                    void* err, void* bits, int n_lanes, int lc, int lp,
                                    int pb, void* scratch, long long scratch_stride) {
  using namespace lzt::enc;
  Layout L = scratch_layout(op_cap, n_chunks);
  if (scratch_stride < L.lane || (scratch_stride & 15)) return 1;
  L.lane = scratch_stride;
  std::vector<uint16_t> probs(lzt::num_probs(lc, lp) + lzt::kT);   // + the walk's spares
  std::vector<uint8_t> ring(lzt::kStageBuf);
  Batch batch;
  const uint32_t* o = (const uint32_t*)ops;
  const int32_t* ends = (const int32_t*)op_ends;
  const int32_t* act = (const int32_t*)active;
  uint8_t* sc = (uint8_t*)scratch;
  const lzt::Threads warp = {0, lzt::kT};
  for (int lane = 0; lane < n_lanes; ++lane)
    if (act[lane])
      walk_lane(o + lane * op_cap, (uint32_t)op_cap, ends + (int64_t)lane * n_chunks,
                n_chunks, sc + lane * L.lane, L, probs.data(), ring.data(), batch, lc, lp,
                pb, warp);
  for (int lane = 0; lane < n_lanes; ++lane)
    for (int c = 0; act[lane] && c < n_chunks; ++c)
      code_lane_chunk(ends + (int64_t)lane * n_chunks, c, sc + lane * L.lane, L, ring.data(),
                      warp);
  for (int lane = 0; lane < n_lanes; ++lane) {
    Status s = {1, 0, 0, 0};
    if (act[lane])
      s = gather_lane(ends + (int64_t)lane * n_chunks, (uint8_t*)out + lane * out_cap,
                      (uint32_t)out_cap, (int32_t*)tab + (int64_t)lane * n_chunks,
                      sc + lane * L.lane, L, ring.data(), lzt::Threads{0, kGatherT});
    ((int32_t*)ok)[lane] = s.ok;
    ((int32_t*)bytes)[lane] = s.bytes;
    ((int32_t*)err)[lane] = s.err;
    ((int32_t*)bits)[lane] = s.bits;
  }
  return 0;
}

// Bytes of scratch one lane needs (scratch_layout in lzma_enc_lane.cuh),
// for the test that holds ops/range_encode.scratch_lane_bytes to it.
extern "C" long long lzt_range_encode_scratch_cpu(long long op_cap, int n_chunks) {
  return lzt::enc::scratch_layout(op_cap, n_chunks).lane;
}

// n ShiftLows of lzma_enc_lane.cuh from a given coder state, per lane
// (low, cache, cache_size and bytes written are in/out; out_cap bytes of
// output per lane; err in/out, 3 once a byte would pass out_cap).  For the
// ShiftLow unit test.
extern "C" int lzt_shift_low_cpu(void* low, void* cache, void* cache_size, void* opos,
                                 void* err, void* out, long long out_cap, int n,
                                 int n_lanes) {
  for (int lane = 0; lane < n_lanes; ++lane) {
    lzt::enc::Coder C;
    lzt::enc::coder_start(C, (uint8_t*)out + (int64_t)lane * out_cap, (uint32_t)out_cap);
    C.opos = (uint32_t)((int64_t*)opos)[lane];
    C.low = ((uint64_t*)low)[lane];
    C.cache = (uint32_t)((int64_t*)cache)[lane];
    C.cache_size = (uint32_t)((int64_t*)cache_size)[lane];
    C.over = ((int64_t*)err)[lane] != 0;
    for (int i = 0; i < n; ++i) lzt::enc::shift_low(C);
    ((uint64_t*)low)[lane] = C.low;
    ((int64_t*)cache)[lane] = C.cache;
    ((int64_t*)cache_size)[lane] = C.cache_size;
    ((int64_t*)opos)[lane] = C.opos;
    if (C.over && !((int64_t*)err)[lane]) ((int64_t*)err)[lane] = lzt::enc::kErrOverflow;
  }
  return 0;
}

// One P1 bit call per element (probe_lane.cuh): rng and code (uint32) in and
// out, p and live (int32) in, the adapted probability and the bit out.
extern "C" int lzt_v12_call_cpu(void* rng, void* code, const void* p, const void* live,
                                void* newp, void* bit0, int n) {
  using namespace lzt::probe;
  for (int i = 0; i < n; ++i) {
    uint32_t& r = ((uint32_t*)rng)[i];
    uint32_t& c = ((uint32_t*)code)[i];
    const int32_t pi = ((const int32_t*)p)[i];
    const uint32_t bound = v12_bound(r, pi);
    const bool b = c < bound;
    ((int32_t*)newp)[i] = adapt(pi, b);
    ((int32_t*)bit0)[i] = b;
    v12_settle(r, c, bound, b, ((const int32_t*)live)[i] != 0);
  }
  return 0;
}

// P1's 26-trip tail per element (uint32 in and out).
extern "C" int lzt_v12_tail_cpu(void* r, void* c, int n) {
  for (int i = 0; i < n; ++i) lzt::probe::v12_tail(((uint32_t*)r)[i], ((uint32_t*)c)[i]);
  return 0;
}

// One P2 call per element (all int32): the slot it reads (& 127 for
// slots == 128, else the floor modulo), then the ALU; rng, code and st in
// and out, prob in, slot and the new probability out.
extern "C" int lzt_compact_call_cpu(void* rng, void* code, void* st, const void* prob,
                                    void* slot, void* newp, int slots, int n) {
  using namespace lzt::probe;
  for (int i = 0; i < n; ++i) {
    int32_t& r = ((int32_t*)rng)[i];
    int32_t& c = ((int32_t*)code)[i];
    int32_t& s = ((int32_t*)st)[i];
    ((int32_t*)slot)[i] = slots == kLanes ? compact_slot(s, c) : compact_slot_mod(s, c, slots);
    ((int32_t*)newp)[i] = compact_alu(r, c, s, ((const int32_t*)prob)[i]);
  }
  return 0;
}

// P2's initial code of each index i (int32) for `seed`.
extern "C" int lzt_compact_code0_cpu(const void* i, void* out, int seed, int n) {
  for (int k = 0; k < n; ++k)
    ((int32_t*)out)[k] = lzt::probe::compact_code0(((const int32_t*)i)[k], seed);
  return 0;
}

// X3's block states (checksum.cu's first launch): `lanes` blocks of 16
// uint32 words, width 32 or 64, one uint64 state per block.
extern "C" int lzt_crc_blocks_cpu(const void* words, long long lanes, int width,
                                  void* states) {
  using namespace lzt::crc;
  if (width != 32 && width != 64) return 1;
  for (long long lane = 0; lane < lanes; ++lane)
    ((uint64_t*)states)[lane] = block_state((const uint32_t*)words + lane * kBlockWords,
                                            width == 32 ? kPoly32 : kPoly64);
  return 0;
}

// X3's tree combine (checksum.cu's combine launches, every level): n states
// (a power of two) joined level by level with mats (levels x width
// columns); the result in *out.
extern "C" int lzt_crc_combine_cpu(const void* states, long long n, const void* mats,
                                   int width, void* out) {
  std::vector<uint64_t> s((const uint64_t*)states, (const uint64_t*)states + n);
  for (int lv = 0; n > 1; ++lv, n /= 2)
    for (long long i = 0; i < n / 2; ++i)
      s[i] = lzt::crc::join((const uint64_t*)mats + lv * width, s[2 * i], s[2 * i + 1],
                            width);
  *(uint64_t*)out = s[0];
  return 0;
}

// X4's x86 BCJ (device_filters.cu) over n_lanes rows of `row` bytes of
// `in` into `out` (written whole); valid int32 and ip int64 per lane.  The
// block's threads are `spans` spans over tiles of `tile` bytes (>= 4); each
// tile's threads run last to first, so a range that read or patched a byte
// of another would show.
extern "C" int lzt_x86_batch_cpu(const void* in, void* out, long long row, const void* valid,
                                 const void* ip, int n_lanes, int encoding, int spans,
                                 int tile) {
  using namespace lzt::filt;
  if (spans < 1 || tile < 4 || row <= 0 || row >= (1ll << 31) - 16) return 1;
  const int32_t R = (int32_t)row;
  const bool enc = encoding != 0;
  std::vector<uint8_t> ibuf(tile), obuf(tile), known(spans), key_out(spans), key_in(spans),
      nkeys(spans), keys(spans * kX86EntryKeys), exits(spans * kX86EntryKeys);
  std::vector<uint32_t> cm((tile + 31) / 32);
  std::vector<int32_t> start(spans + 1);
  std::vector<X86Start> s0(spans);
  for (long long lane = 0; lane < n_lanes; ++lane) {
    const uint8_t* lin = (const uint8_t*)in + lane * row;
    uint8_t* lout = (uint8_t*)out + lane * row;
    const int64_t limit = (int64_t)((const int32_t*)valid)[lane] - 4;
    const int32_t vend = x86_body_end(limit, R);
    const uint32_t ipl = (uint32_t)((const int64_t*)ip)[lane];
    X86Scan carry = x86_fresh(0);
    X86Pending pend;
    pend.n = 0;
    int32_t total = 0;
    for (int32_t base = 0; base < R; base += tile) {
      const int32_t n = R - base < tile ? R - base : tile;
      std::copy(lin + base, lin + base + n, ibuf.begin());
      std::copy(ibuf.begin(), ibuf.begin() + n, obuf.begin());
      for (int32_t w = 0; w < (n + 31) / 32; ++w)
        cm[w] = x86_cand_bits(ibuf.data() + 32 * w, n - 32 * w < 32 ? n - 32 * w : 32);
      const X86Src src = {lin, ibuf.data(), base, n, R - 1};
      bool guessed = false;
      for (int t = 0; t < spans; ++t) {
        s0[t] = x86_span_start(src, t, spans, base, n);
        start[t] = s0[t].s;
        known[t] = s0[t].known;
        guessed = guessed || !s0[t].known;
      }
      start[spans] = base + n;
      const X86Scan carried = carry;
      for (int k = 0; k < pend.n; ++k) obuf[pend.pos[k] - base] = pend.val[k];
      pend.n = 0;
      auto run = [&](int t, X86Scan st) {
        X86Pending pd;
        pd.n = 0;
        X86Put put = {obuf.data(), base, n, &pd};
        total += x86_span(src, cm.data(), put, st, start[t + 1], vend, ipl, enc);
        if (start[t + 1] == base + n) carry = st;
        if (pd.n) pend = pd;   // one conversion at most reaches past a tile
        return st;
      };
      for (int t = spans - 1; t >= 0; --t) {   // the known ranges run, the others tabulate
        const int32_t s = s0[t].s, end = start[t + 1];
        if (s >= end) continue;
        if (s0[t].known) {
          const X86Scan st = run(t, t == 0 ? carried : x86_fresh(s));
          key_out[t] = (uint8_t)x86_state_key(st, end);
          continue;
        }
        uint8_t* k = keys.data() + t * kX86EntryKeys;
        nkeys[t] = (uint8_t)x86_entry_keys(src, s, k);
        X86Drop drop;
        for (int j = 0; j < nkeys[t]; ++j) {
          X86Scan e = x86_key_state(k[j], s);
          x86_span(src, cm.data(), drop, e, end, vend, ipl, enc);
          exits[t * kX86EntryKeys + j] = (uint8_t)x86_state_key(e, end);
        }
      }
      if (guessed) {
        x86_chain_keys(src, cm.data(), start.data(), known.data(), key_out.data(), nkeys.data(),
                       keys.data(), exits.data(), key_in.data(), spans, vend, ipl, enc);
        for (int t = spans - 1; t >= 0; --t)
          if (s0[t].s < start[t + 1] && !s0[t].known) run(t, x86_key_state(key_in[t], s0[t].s));
      }
      if (base + n == R) {
        X86Pending pd;
        pd.n = 0;
        X86Put put = {obuf.data(), base, n, &pd};
        x86_tail(lin, R, limit, ipl, enc, carry, total, put);
      }
      std::copy(obuf.begin(), obuf.begin() + n, lout + base);
    }
  }
  return 0;
}

// X4's BCJ2 decode (device_filters.cu), same arguments but the stream and
// the scratch, plus `threads`, the listing and placing blocks' width
// (chunks of main and output bytes of threads * kBcj2Seg; each chunk's
// threads run last to first), and info int32 [n_lanes, 4] (candidates,
// conversions, decoder steps, ok).
extern "C" int lzt_bcj2_batch_cpu(const void* main, int main_w, const void* main_len,
                                  const void* call, int call_w, const void* call_len,
                                  const void* jump, int jump_w, const void* jump_len,
                                  const void* rc, int rc_w, const void* rc_len,
                                  const void* out_size, void* out, int out_cap, void* ok,
                                  int n_lanes, void* info, int threads) {
  using namespace lzt::filt;
  if (threads < 1 || main_w <= 0 || out_cap <= 0) return 1;
  const int32_t tile = threads * kBcj2Seg, cap = bcj2_tile_cap(tile);
  std::vector<Bcj2Entry> list(main_w);
  std::vector<uint32_t> flags(threads);
  std::vector<int32_t> counts((main_w + tile - 1) / tile), site(cap);
  std::vector<uint32_t> rel(cap), cw(bcj2_words(call_w)), jw(bcj2_words(jump_w));
  uint16_t probs[kBcj2Probs];
  for (long long s = 0; s < n_lanes; ++s) {
    const Bcj2Lane L = {(const uint8_t*)main + s * main_w, main_w, ((const int32_t*)main_len)[s],
                        (const uint8_t*)call + s * call_w, call_w, ((const int32_t*)call_len)[s],
                        (const uint8_t*)jump + s * jump_w, jump_w, ((const int32_t*)jump_len)[s],
                        (const uint8_t*)rc + s * rc_w,     rc_w,   ((const int32_t*)rc_len)[s],
                        ((const int32_t*)out_size)[s]};
    const int32_t main_end = main_end_of(L.main_len, main_w);
    const int32_t nchunk = (main_end + tile - 1) / tile;
    // 1. the candidate sites: each chunk's flags and count, then each
    // chunk's list after the counts of the chunks before
    auto chunk_flags = [&](int32_t c) {
      for (int t = threads - 1; t >= 0; --t) {
        const int32_t p0 = c * tile + t * kBcj2Seg;
        const int32_t cnt = main_end - p0 < kBcj2Seg ? main_end - p0 : kBcj2Seg;
        flags[t] = cnt > 0 ? bcj2_seg_flags(L.main + p0, p0, cnt) : 0;
      }
    };
    for (int32_t c = nchunk - 1; c >= 0; --c) {
      chunk_flags(c);
      counts[c] = 0;
      for (int t = 0; t < threads; ++t) counts[c] += popc32(flags[t]);
    }
    int32_t ncand = 0;
    for (int32_t c = nchunk - 1; c >= 0; --c) {
      int32_t off = 0;
      for (int32_t k = 0; k < c; ++k) off += counts[k];
      chunk_flags(c);
      for (int t = 0; t < threads; ++t) {
        const int32_t p0 = c * tile + t * kBcj2Seg;
        bcj2_seg_write(L.main + p0, p0, flags[t], list.data() + off);
        off += popc32(flags[t]);
      }
      if (c == nchunk - 1) ncand = off;
    }
    // 2. the walk
    auto put_conv = [&list](int32_t k, Bcj2Entry e) { list[k] = e; };
    for (int32_t k = 0; k < bcj2_words(call_w); ++k) cw[k] = be32(L.call, call_w, 4 * k);
    for (int32_t k = 0; k < bcj2_words(jump_w); ++k) jw[k] = be32(L.jump, jump_w, 4 * k);
    const Bcj2Streams in = {list.data(), cw.data(), jw.data(), &L};
    const Bcj2Walk r = bcj2_walk(L, probs, in, ncand, put_conv);
    int32_t* inf = (int32_t*)info + s * 4;
    inf[0] = ncand;
    inf[1] = r.nconv;
    inf[2] = r.steps;
    inf[3] = r.ok;
    ((int32_t*)ok)[s] = r.ok;
    // 3. every output byte, a chunk at a time, last to first
    const int32_t nconv = r.ok ? r.nconv : 0;
    const int32_t used = L.out_size - 4 * nconv;
    const int32_t main_lim = !r.ok ? 0 : used < main_end ? used : main_end;
    uint8_t* row = (uint8_t*)out + s * out_cap;
    struct Put {
      uint8_t* row;
      void operator()(int32_t o, uint8_t v) { row[o] = v; }
    } put = {row};
    for (int32_t tb = (out_cap - 1) / tile * tile; tb >= 0; tb -= tile) {
      Bcj2Search q = {0, nconv, 1};
      while (!q.done()) {
        int32_t c = 0;
        for (int t = 0; t < threads; ++t) {
          const int32_t k = q.probe(t, threads);
          c += k >= 0 && (int32_t)list[k].a < tb - 4;
        }
        q.update(c);
      }
      const int32_t kbase = q.lo;
      const int32_t nload = nconv - kbase < cap ? nconv - kbase : cap;
      for (int32_t i = 0; i < nload; ++i) {
        site[i] = (int32_t)list[kbase + i].a;
        rel[i] = list[kbase + i].b;
      }
      for (int t = threads - 1; t >= 0; --t) {
        const int32_t o0 = tb + t * kBcj2Seg;
        if (o0 >= out_cap) continue;
        const int32_t o1 = out_cap - o0 < kBcj2Seg ? out_cap : o0 + kBcj2Seg;
        bcj2_place_run(o0, o1, site.data(), rel.data(), nload, kbase, L.main, main_lim, put);
      }
    }
  }
  return 0;
}
