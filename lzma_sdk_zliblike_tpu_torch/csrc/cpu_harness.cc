// Test-only CPU build of the per-lane code that group_decode.cu (K1) and
// range_encode.cu (K2) run on the GPU, of the per-element bit call of
// the probes v12_probe.cu (P1) and compact_probe.cu (P2), of the block step
// and tree join of checksum.cu (X3) and of the lane machines of
// device_filters.cu (X4): the same lzma_lane.cuh, lzma_enc_lane.cuh,
// probe_lane.cuh, checksum_lane.cuh and filters_lane.cuh, compiled by g++,
// looping over lanes or elements on the host (and, for K1 and K2, over the
// threads of a block).  The tests/test_torch_*.py
// files build it and hold it against the plain versions in ops/ and tools/;
// the package never loads it.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libcpu_harness.so cpu_harness.cc

#include <stdint.h>

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
// `in` into `out`, which holds a copy of `in`; valid int32 and ip int64 per
// lane.
extern "C" int lzt_x86_batch_cpu(const void* in, void* out, long long row, const void* valid,
                                 const void* ip, int n_lanes, int encoding) {
  for (int lane = 0; lane < n_lanes; ++lane)
    lzt::filt::x86_lane((const uint8_t*)in + lane * row, (uint8_t*)out + lane * row,
                        (int32_t)row, ((const int32_t*)valid)[lane],
                        (uint32_t)((const int64_t*)ip)[lane], encoding != 0);
  return 0;
}

// X4's BCJ2 decode (device_filters.cu), same arguments but the stream.
extern "C" int lzt_bcj2_batch_cpu(const void* main, int main_w, const void* main_len,
                                  const void* call, int call_w, const void* call_len,
                                  const void* jump, int jump_w, const void* jump_len,
                                  const void* rc, int rc_w, const void* rc_len,
                                  const void* out_size, void* out, int out_cap, void* ok,
                                  int n_lanes) {
  using namespace lzt::filt;
  uint16_t probs[kBcj2Probs];
  for (long long s = 0; s < n_lanes; ++s) {
    Bcj2Lane L = {(const uint8_t*)main + s * main_w, main_w, ((const int32_t*)main_len)[s],
                  (const uint8_t*)call + s * call_w, call_w, ((const int32_t*)call_len)[s],
                  (const uint8_t*)jump + s * jump_w, jump_w, ((const int32_t*)jump_len)[s],
                  (const uint8_t*)rc + s * rc_w,     rc_w,   ((const int32_t*)rc_len)[s],
                  ((const int32_t*)out_size)[s]};
    ((int32_t*)ok)[s] = bcj2_lane(L, probs, (uint8_t*)out + s * out_cap, out_cap);
  }
  return 0;
}
