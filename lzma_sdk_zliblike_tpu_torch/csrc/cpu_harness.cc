// Test-only CPU build of the per-lane code that group_decode.cu (K1) and
// range_encode.cu (K2) run on the GPU, of the per-element bit call of
// the probes v12_probe.cu (P1) and compact_probe.cu (P2), of the tile and
// fold schedule of checksum.cu (X3), of the pieces of device_filters.cu
// (X4) and of the tile sort, merge rounds and slot step of match_find.cu
// (X2): the same lzma_lane.cuh, lzma_enc_lane.cuh, probe_lane.cuh,
// checksum_lane.cuh, filters_lane.cuh, branch_filters_lane.cuh (X4's
// converters and delta, branch_filters.cu) and match_find_lane.cuh,
// compiled by g++, looping over lanes or elements on the host (and, for K1,
// K2, X2 and X4, over the threads of a block).  The tests/test_torch_*.py
// files build it and hold it against the plain versions in ops/ and tools/;
// the package never loads it.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libcpu_harness.so cpu_harness.cc

#include <stdint.h>

#include <algorithm>
#include <array>
#include <cstring>
#include <functional>
#include <utility>
#include <vector>

#include "branch_filters_lane.cuh"
#include "checksum_lane.cuh"
#include "filters_lane.cuh"
#include "lzma_enc_lane.cuh"
#include "lzma_lane.cuh"
#include "match_find_lane.cuh"
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

// ---- the probes' kernels, thread by thread --------------------------------
//
// Plays one launch of v12_probe.cu (P1) or compact_probe.cu (P2) on the
// host in the kernels' barrier schedule.  Each phase between two barriers
// (or grid votes) runs one thread after another, first to last (rev = 0)
// or last to first (rev = 1): a thread runs its whole phase before the next
// one starts, the most one-sided order a barrier allows, so any read of a
// slot that another thread writes in the same phase would show.  A phase
// with warp collectives (mxu's mma.sync and shuffle, submask's reduction)
// runs warp after warp, and within a warp, lane after lane up to the next
// collective.  A phase that reads a region (a P1 table, a bcast table
// copy, an mxu vector buffer) that it also writes is a race, whatever its
// output: the call then returns 4.

namespace {

using namespace lzt::probe;

// The steps of one phase: per-thread actions and warp collectives, run on
// `barrier()` in the order above over `n` threads in warps of `warp`.
struct Player {
  int n, warp;
  bool rev;
  std::vector<std::pair<bool, std::function<void(int)>>> steps;   // (collective, fn)
  unsigned read = 0, wrote = 0;    // the regions the phase read and wrote, as bits
  bool race = false;

  void thread(std::function<void(int)> fn) { steps.emplace_back(false, std::move(fn)); }
  void collective(std::function<void(int)> fn) { steps.emplace_back(true, std::move(fn)); }
  int at(int k, int m) const { return rev ? m - 1 - k : k; }
  void barrier() {
    for (int wk = 0; wk < n / warp; ++wk) {
      const int w = at(wk, n / warp);
      size_t i = 0;
      while (i < steps.size()) {
        size_t j = i;
        while (j < steps.size() && !steps[j].first) ++j;     // [i, j): per-thread
        for (int lk = 0; lk < warp; ++lk)
          for (size_t k = i; k < j; ++k) steps[k].second(w * warp + at(lk, warp));
        if (j < steps.size()) steps[j].second(w);
        i = j + 1;
      }
    }
    steps.clear();
    race = race || (read & wrote) != 0;
    read = wrote = 0;
  }
};

// P1's row variants: S rows of 128 threads (v12_row_kernel).
template <bool kMask, bool kFuse, bool kStore2>
bool v12_rows(int32_t* out, int S, int iters, int V, int extra, bool rev) {
  const int n = S * kLanes;
  std::vector<int32_t> tbl((size_t)S * kTables * kLanes);
  std::vector<V12Row> th(n);
  std::vector<int32_t> cs((size_t)n * (extra > 0 ? extra : 1));
  Player P = {n, n, rev, {}};
  auto row_tbl = [&](int i) { return tbl.data() + (size_t)(i / kLanes) * kTables * kLanes; };
  P.thread([&](int i) {
    for (int t = 0; t < kTables; ++t) row_tbl(i)[t * kLanes + i % kLanes] = kProbInit;
    th[i] = {0xFFFFFFFFu, 0, 0, 0, 0, 0, true, false};
    for (int e = 0; e < extra; ++e) cs[(size_t)i * extra + e] = 3 + e;
  });
  P.barrier();
  auto any = [&](bool (*pred)(const V12Row&)) {   // a grid vote: a barrier, then any()
    P.barrier();
    bool a = false;
    for (const V12Row& s : th) a = a || pred(s);
    return a;
  };
  bool busy = true;
  for (int it = 0; it < iters && busy; ++it) {
    if (V == kWhileCond && (it & 63) == 0)
      busy = any([](const V12Row& s) { return s.idx < (1 << 30); });
    P.thread([&](int i) { th[i].live = th[i].idx < 96; });
    for (int b = 0; b < kCalls; ++b) {
      P.thread([&, b](int i) { P.read |= v12_row_gather<kFuse>(row_tbl(i), b, th[i]); });
      P.barrier();
      P.thread([&, b](int i) {
        P.wrote |= v12_row_store<kStore2>(row_tbl(i), b, i % kLanes, th[i]);
      });
      if (v12_store_barrier(kStore2)) P.barrier();
      P.thread([&, b](int i) {
        V12Row& s = th[i];
        if (V == kLive) {
          int32_t& c = cs[(size_t)i * extra + b % extra];
          c = wrap_add(c, s.idx);
        }
        v12_row_settle<kMask>(s);
      });
    }
    const bool tail = V == kTailAlways ||
                      (V == kTailCond && any([](const V12Row& s) { return s.idx > 120; }));
    if (tail) P.thread([&](int i) { v12_tail(th[i].rng, th[i].code); });
  }
  P.thread([&](int i) {
    int32_t acc = th[i].idx;
    for (int e = 0; V == kLive && e < extra; ++e) acc ^= cs[(size_t)i * extra + e];
    out[i] = acc;
  });
  P.barrier();
  return !P.race;
}

// P1's lane variants (v12_lane_kernel): stream s alone, rows 0..7 of out.
template <bool kTables8>
void v12_lanes(int32_t* out, int S, int iters) {
  std::vector<int32_t> slots(kTables * kLanes);
  for (int s = 0; s < S; ++s) {
    std::fill(slots.begin(), slots.end(), kProbInit);
    uint32_t rng = (uint32_t)out[0 * kLanes + s], code = (uint32_t)out[1 * kLanes + s];
    int32_t idx = out[2 * kLanes + s];
    for (int it = 0; it < iters; ++it)
      for (int b = 0; b < kCalls; ++b)
        v12_lane_call<kTables8>(&slots[(b % kTables) * kLanes + clip127(idx)],
                                &slots[(b % kTables) * kLanes + (idx & 127)], rng, code, idx);
    out[0 * kLanes + s] = (int32_t)rng;
    out[1 * kLanes + s] = (int32_t)code;
    out[2 * kLanes + s] = idx;
    for (int r = 3; r < 8; ++r) out[r * kLanes + s] = 0;
  }
}

// One P2 thread's state: its stream's (or element's) rng, code and st, the
// value it holds (`mine`: bcast's slot, mxu's relayout input), a relayout's
// or a reduction's result (`part`) and the slot of the call (`slot`).
struct Compact {
  int32_t rng, code, st, mine, part, slot;
};

bool compact_bcast(int32_t* out, int32_t seed, int iters, bool rev) {
  constexpr int kRows = 64;
  const int n = kRows * kLanes;
  std::vector<int32_t> tbl((size_t)kRows * 2 * kLanes);
  std::vector<Compact> th(n);
  Player P = {n, n, rev, {}};
  auto copy = [&](int i, int c) { return tbl.data() + ((size_t)(i / kLanes) * 2 + c) * kLanes; };
  P.thread([&](int i) {
    th[i] = {0x7FFFFF00, compact_code0(i / kLanes, seed), 3, kProbInit, 0, 0};
    copy(i, 0)[i % kLanes] = kProbInit;
  });
  P.barrier();
  for (int it = 0; it < iters; ++it)
    for (int b = 0; b < kCalls; ++b) {
      P.thread([&, b](int i) {
        Compact& c = th[i];
        const int32_t idx = compact_slot(c.st, c.code);
        const int32_t newp = compact_alu(c.rng, c.code, c.st, copy(i, bcast_read_copy(b))[idx]);
        c.mine = owned_slot(c.mine, i % kLanes, idx, newp);
        copy(i, bcast_write_copy(b))[i % kLanes] = c.mine;
        P.read |= 1u << bcast_read_copy(b);
        P.wrote |= 1u << bcast_write_copy(b);
      });
      P.barrier();
    }
  for (int i = 0; i < n; ++i)
    out[i] = wrap_add(wrap_add(wrap_add(th[i].rng, th[i].code), th[i].st), th[i].mine);
  return !P.race;
}

// mma.sync.m16n8k16 on a warp's fragments, through the maps of
// probe_lane.cuh: A and B as f16, the products summed in f32 in k order
// onto C.  Returns false if a map misses or repeats an entry.
bool mma_16816(const uint32_t (*a)[4], const uint32_t (*b)[2], float (*d)[4]) {
  float A[16][16], B[16][8], D[16][8];
  int seen_a[16][16] = {}, seen_b[16][8] = {}, seen_c[16][8] = {};
  auto half = [](uint32_t reg, int hi) {
    const uint16_t bits = (uint16_t)(hi ? reg >> 16 : reg);
    _Float16 h;
    std::memcpy(&h, &bits, 2);
    return (float)h;
  };
  for (int lane = 0; lane < 32; ++lane) {
    for (int e = 0; e < 8; ++e) {
      const RowCol rc = mma_a_entry(lane, e);
      A[rc.row][rc.col] = half(a[lane][e >> 1], e & 1);
      ++seen_a[rc.row][rc.col];
    }
    for (int e = 0; e < 4; ++e) {
      const RowCol rb = mma_b_entry(lane, e), rd = mma_c_entry(lane, e);
      B[rb.row][rb.col] = half(b[lane][e >> 1], e & 1);
      D[rd.row][rd.col] = d[lane][e];
      ++seen_b[rb.row][rb.col];
      ++seen_c[rd.row][rd.col];
    }
  }
  for (int m = 0; m < 16; ++m)
    for (int k = 0; k < 16; ++k)
      if (seen_a[m][k] != 1 || (k < 8 && (seen_b[m][k] != 1 || seen_c[m][k] != 1))) return false;
  for (int m = 0; m < 16; ++m)
    for (int nn = 0; nn < 8; ++nn)
      for (int k = 0; k < 16; ++k) D[m][nn] += A[m][k] * B[k][nn];
  for (int lane = 0; lane < 32; ++lane)
    for (int e = 0; e < 4; ++e) {
      const RowCol rd = mma_c_entry(lane, e);
      d[lane][e] = D[rd.row][rd.col];
    }
  return true;
}

// mxu (mxu_kernel; `mxu` = 1) and tpose (tpose_kernel; `mxu` = 0): one block
// of 128 threads.
int compact_block(int32_t* out, int32_t seed, int iters, bool mxu, bool rev) {
  std::vector<int32_t> tbl(kLanes * kLanes);
  std::vector<Compact> th(kLanes);
  std::vector<uint16_t> vec(2 * kLanes);             // f16 bits, two buffers
  std::vector<std::array<std::array<std::array<uint32_t, 4>, 8>, 2>> a(kLanes);
  std::vector<std::array<std::array<uint32_t, 2>, 8>> bf(kLanes);
  std::vector<std::array<std::array<std::array<float, 4>, 8>, 2>> d(kLanes);   // [tile][ks]
  std::vector<float> send(kLanes);
  bool maps_ok = true;
  Player P = {kLanes, 32, rev, {}};
  P.thread([&](int l) {
    const int w = l >> 5, lane = l & 31;
    for (int t = 0; t < 2; ++t)
      for (int ks = 0; ks < 8; ++ks)
        for (int r = 0; r < 4; ++r)
          a[l][t][ks][r] = (mxu_a_one(w, t, ks, lane, 2 * r) ? 0x3C00u : 0u) |
                           (mxu_a_one(w, t, ks, lane, 2 * r + 1) ? 0x3C000000u : 0u);
    for (int j = 0; j < kLanes; ++j) tbl[j * kLanes + l] = kProbInit;
    th[l] = {0x7FFFFF00, compact_code0(l, seed), 3, 0, 0, 0};
  });
  if (!mxu) P.barrier();
  // relayout into buffer `buf` of th[l].mine, as relayout() in compact_probe.cu;
  // `then` runs on each thread after it, in the same phase
  auto relayout = [&](int buf, std::function<void(int)> then) {
    P.thread([&, buf](int l) {
      const _Float16 h = (_Float16)(float)th[l].mine;
      std::memcpy(&vec[buf * kLanes + l], &h, 2);
      P.wrote |= 1u << buf;
    });
    P.barrier();
    P.thread([&, buf](int l) {
      const uint32_t* v2 = reinterpret_cast<const uint32_t*>(vec.data() + buf * kLanes);
      for (int ks = 0; ks < 8; ++ks)
        for (int r = 0; r < 2; ++r) bf[l][ks][r] = v2[mxu_b_word(l & 31, ks, r)];
      d[l] = {};
      P.read |= 1u << buf;
    });
    P.collective([&](int w) {
      uint32_t aw[32][4], bw[32][2];
      float dw[32][4];
      for (int t = 0; t < 2; ++t)
        for (int ks = 0; ks < 8; ++ks) {
          for (int lane = 0; lane < 32; ++lane) {
            const int l = 32 * w + lane;
            for (int r = 0; r < 4; ++r) aw[lane][r] = a[l][t][ks][r];
            for (int r = 0; r < 2; ++r) bw[lane][r] = bf[l][ks][r];
            for (int e = 0; e < 4; ++e) dw[lane][e] = d[l][t][ks][e];
          }
          maps_ok = mma_16816(aw, bw, dw) && maps_ok;
          for (int lane = 0; lane < 32; ++lane)
            for (int e = 0; e < 4; ++e) d[32 * w + lane][t][ks][e] = dw[lane][e];
        }
    });
    P.thread([&](int l) {
      const int lane = l & 31, t = mxu_send_tile(lane), e = mxu_send_elem(lane);
      const auto& p = d[l][t];
      send[l] = ((p[0][e] + p[1][e]) + (p[2][e] + p[3][e])) +
                ((p[4][e] + p[5][e]) + (p[6][e] + p[7][e]));
    });
    P.collective([&](int w) {
      float got[32];
      for (int lane = 0; lane < 32; ++lane) got[lane] = send[32 * w + mxu_src_lane(lane)];
      for (int lane = 0; lane < 32; ++lane) th[32 * w + lane].part = (int32_t)got[lane];
    });
    P.thread(std::move(then));
  };
  for (int it = 0; it < iters; ++it)
    for (int b = 0; b < kCalls; ++b) {
      if (!mxu) {
        P.thread([&](int l) {
          Compact& c = th[l];
          const int32_t idx = compact_slot(c.st, c.code);
          tbl[idx * kLanes + l] = compact_alu(c.rng, c.code, c.st, tbl[idx * kLanes + l]);
        });
        continue;
      }
      const int par = b & 1;
      P.thread([&](int l) { th[l].mine = compact_slot(th[l].st, th[l].code); });
      relayout(mxu_buffer(par, 0), [&](int l) {
        th[l].slot = th[l].part;
        th[l].mine = tbl[th[l].slot * kLanes + l];
      });
      relayout(mxu_buffer(par, 1), [&](int l) {
        Compact& c = th[l];
        c.mine = compact_alu(c.rng, c.code, c.st, c.part);
      });
      relayout(mxu_buffer(par, 2), [&](int l) { tbl[th[l].slot * kLanes + l] = th[l].part; });
    }
  P.barrier();
  for (int l = 0; l < kLanes; ++l) {
    int32_t col = 0;
    for (int s = 0; s < kLanes; ++s) col = wrap_add(col, tbl[l * kLanes + s]);
    out[l] = wrap_add(wrap_add(wrap_add(th[l].rng, th[l].code), th[l].st), col);
  }
  return !maps_ok ? 3 : P.race ? 4 : 0;
}

// submask (submask_kernel) with T threads a stream (the kernel's T is 32).
template <int T>
int compact_submask(int32_t* out, int32_t seed, int iters, bool rev) {
  constexpr int kPer = kSubSlots / T;
  const int n = kLanes * T;
  std::vector<Compact> th(n);
  std::vector<std::array<int32_t, kPer>> v(n);
  bool agree = true;
  Player P = {n, T, rev, {}};
  P.thread([&](int i) {
    th[i] = {0x7FFFFF00, compact_code0(i / T, seed), 3, 0, 0, 0};
    v[i].fill(kProbInit);
  });
  auto reduce = [&](int s) {      // the warp reduction; every lane gets the sum
    int32_t sum = 0;
    for (int j = 0; j < T; ++j) sum = wrap_add(sum, th[s * T + j].part);
    for (int j = 0; j < T; ++j) th[s * T + j].part = sum;
  };
  for (int it = 0; it < iters; ++it)
    for (int b = 0; b < kCalls; ++b) {
      P.thread([&](int i) {
        Compact& c = th[i];
        c.slot = compact_slot_mod(c.st, c.code, kSubSlots);
        c.part = submask_read<T>(v[i].data(), i % T, c.slot);
      });
      P.collective(reduce);
      P.thread([&](int i) {
        Compact& c = th[i];
        submask_select<T>(v[i].data(), i % T, c.slot, compact_alu(c.rng, c.code, c.st, c.part));
      });
    }
  P.thread([&](int i) { th[i].part = submask_sum<T>(v[i].data()); });
  P.collective(reduce);
  P.barrier();
  for (int s = 0; s < kLanes; ++s) {
    const Compact& c = th[s * T];
    for (int j = 1; j < T; ++j) {
      const Compact& o = th[s * T + j];
      agree = agree && o.rng == c.rng && o.code == c.code && o.st == c.st && o.part == c.part;
    }
    out[s] = wrap_add(wrap_add(wrap_add(c.rng, c.code), c.st), c.part);
  }
  return agree ? 0 : 3;
}

}  // namespace

// P1 (v12_probe.cu) on the host: `variant` a V12Variant code, `extra` the N
// of live<N>; out int32 [S, 128], zeroed by the caller (the lane variants'
// start state).  The row variants play the kernel's threads phase by phase
// in order `rev` (see above); 4 if a phase read a table it wrote.
extern "C" int lzt_v12_probe_cpu(void* out_, int S, int iters, int variant, int extra,
                                 int rev) {
  int32_t* out = (int32_t*)out_;
  if (S <= 0 || iters < 0 || (variant == kLive) != (extra > 0)) return 1;
  bool ok = true;
  switch (variant) {
    case kMasked: ok = v12_rows<true, false, false>(out, S, iters, variant, 0, rev); break;
    case kFused2: ok = v12_rows<true, true, true>(out, S, iters, variant, 0, rev); break;
    case kLive: ok = v12_rows<true, true, false>(out, S, iters, variant, extra, rev); break;
    case kBroadcast: case kTailAlways: case kTailNever: case kTailCond: case kWhile:
    case kWhileCond:
      ok = v12_rows<false, false, false>(out, S, iters, variant, 0, rev);
      break;
    case kLane: v12_lanes<true>(out, S, iters); break;
    case kLaneNotr: v12_lanes<false>(out, S, iters); break;
    default: return 1;
  }
  return ok ? 0 : 4;
}

// P2 (compact_probe.cu) on the host: `kind` 0 bcast, 1 mxu, 2 tpose, 3
// submask; out int32 [64, 128] for bcast, [1, 128] else; `threads` is
// submask's threads a stream (16, 32, 64 or 192; the kernel's is 32).
// Returns 3 if the mma maps miss an entry (mxu) or a stream's lanes
// disagree on its state (submask), 4 if a phase read a table copy (bcast)
// or a vector buffer (mxu) that it wrote.
extern "C" int lzt_compact_probe_cpu(int kind, int seed, void* out_, int iters, int rev,
                                     int threads) {
  int32_t* out = (int32_t*)out_;
  if (iters < 0) return 1;
  switch (kind) {
    case 0: return compact_bcast(out, seed, iters, rev) ? 0 : 4;
    case 1: return compact_block(out, seed, iters, true, rev);
    case 2: return compact_block(out, seed, iters, false, rev);
    case 3:
      switch (threads) {
        case 16: return compact_submask<16>(out, seed, iters, rev);
        case 32: return compact_submask<32>(out, seed, iters, rev);
        case 64: return compact_submask<64>(out, seed, iters, rev);
        case 192: return compact_submask<192>(out, seed, iters, rev);
        default: return 1;
      }
    default: return 1;
  }
}

// One m16n8k16 product through the fragment maps: A (16 x 16) and B
// (16 x 8) row-major float, rounded to f16 as they enter the lanes'
// registers; D (16 x 8) = A B + D in f32.  Returns 3 if a map misses or
// repeats an entry.
extern "C" int lzt_mma_16816_cpu(const void* A_, const void* B_, void* D_) {
  const float* A = (const float*)A_;
  const float* B = (const float*)B_;
  float* D = (float*)D_;
  uint32_t a[32][4] = {}, b[32][2] = {};
  float d[32][4];
  auto bits = [](float f) {
    const _Float16 h = (_Float16)f;
    uint16_t u;
    std::memcpy(&u, &h, 2);
    return (uint32_t)u;
  };
  for (int lane = 0; lane < 32; ++lane) {
    for (int e = 0; e < 8; ++e) {
      const RowCol rc = mma_a_entry(lane, e);
      a[lane][e >> 1] |= bits(A[rc.row * 16 + rc.col]) << (16 * (e & 1));
    }
    for (int e = 0; e < 4; ++e) {
      const RowCol rb = mma_b_entry(lane, e), rd = mma_c_entry(lane, e);
      b[lane][e >> 1] |= bits(B[rb.row * 8 + rb.col]) << (16 * (e & 1));
      d[lane][e] = D[rd.row * 8 + rd.col];
    }
  }
  if (!mma_16816(a, b, d)) return 3;
  for (int lane = 0; lane < 32; ++lane)
    for (int e = 0; e < 4; ++e) {
      const RowCol rd = mma_c_entry(lane, e);
      D[rd.row * 8 + rd.col] = d[lane][e];
    }
  return 0;
}

// X3 (checksum.cu) on the host.  The kernels' schedule at a given tile,
// thread count and piece size: a tile's segments, the warp tree in shuffle
// order (a lane past the warp reads its own value, as __shfl_down_sync
// gives it), the warps' join in warp 0, the short last tile staged
// right-aligned; the wrapper's per-piece launches, each piece copied into a
// buffer of its own length followed by poison bytes, so a read past it
// would show; and the fold.
namespace {

using namespace lzt::crc;

template <int W>
void crc_init_host(state_t<W>* consts) {
  for (int i = 0; i < kTableWords; ++i) consts[i] = table_entry<W>(i >> 8, i & 255);
  alignas(16) state_t<W> cur[W];
  state_t<W> next[W];
  for (int t = 0; t < W; ++t) cur[t] = zero_byte_column<W>(t);
  for (int k = 0; k < kPowers; ++k) {
    for (int t = 0; t < W; ++t) {
      consts[kTableWords + k * W + t] = cur[t];
      next[t] = apply<W>(cur, cur[t]);
    }
    std::copy(next, next + W, cur);
  }
}

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

// The warp tree of crc_tiles_kernel over `lanes` values: level k reads the
// value 2^(k - k0) lanes on (its own past the warp) and joins where
// tree_joins says, with Z^(seg * 2^k).
template <int W>
void warp_tree(std::vector<state_t<W>>& v, int lanes, int k0, int k1, const state_t<W>* M) {
  for (int k = k0; k < k1; ++k) {
    const int d = 1 << (k - k0);
    std::vector<state_t<W>> right(lanes);
    for (int l = 0; l < lanes; ++l) right[l] = l + d < lanes ? v[l + d] : v[l];
    for (int l = 0; l < lanes; ++l)
      if (tree_joins(l, k - k0)) v[l] = join<W>(M + k * W, v[l], right[l]);
  }
}

template <int W>
int crc_tiles_host(const uint8_t* buf, long long n, int tile, int threads,
                   const state_t<W>* consts, uint64_t* states) {
  if (n <= 0 || !pow2(tile) || !pow2(threads) || threads > 1024 || tile % threads ||
      (tile / threads) % kSlices)
    return 1;
  const int seg = tile / threads, ws = threads < 32 ? threads : 32, warps = threads / ws;
  const int levels = log2_floor(threads), wlevels = log2_floor(ws);
  const state_t<W>* T = consts;
  const state_t<W>* M = consts + kTableWords + log2_floor(seg) * W;
  const long long tiles = (n + tile - 1) / tile;
  const int last = (int)(n - (tiles - 1) * tile);
  std::vector<uint32_t> stage_words(threads * (seg + kRowPad) / 4);
  uint8_t* cur = (uint8_t*)stage_words.data();
  for (long long i = 0; i < tiles; ++i) {
    const uint8_t* s = buf + i * tile;
    if (i == tiles - 1 && last < tile) {
      for (int p = 0; p < tile; ++p) cur[stage_offset(p, seg)] = short_tile_byte(s, tile, last, p);
    } else {
      for (int c = 0; c < tile / 16; ++c) std::memcpy(cur + stage_offset(c * 16, seg), s + c * 16, 16);
    }
    std::vector<state_t<W>> warp_s(ws, 0);
    for (int w = 0; w < warps; ++w) {
      std::vector<state_t<W>> v(ws);
      for (int l = 0; l < ws; ++l)
        v[l] = segment_state<W>(T, (const uint32_t*)(cur + (w * ws + l) * (seg + kRowPad)),
                                seg / kSlices);
      warp_tree<W>(v, ws, 0, wlevels, M);
      warp_s[w] = v[0];
    }
    // warp 0: lanes below `warps` hold the warps' states, the rest zero
    warp_tree<W>(warp_s, ws, wlevels, levels, M);
    states[i] = (uint64_t)warp_s[0];
  }
  return 0;
}

template <int W>
uint64_t crc_fold_host(const uint64_t* states, long long n, int tile, int fold_threads,
                       state_t<W> init, const state_t<W>* consts) {
  const state_t<W>* powers = consts + kTableWords;
  const int tile_log = log2_floor(tile);
  const long long f = (n - 1) / tile;
  long long p = 1;
  while (p <= f) p <<= 1;
  const int nt = p < fold_threads ? (int)p : fold_threads;
  const long long per = p / nt;
  std::vector<state_t<W>> s(nt);
  for (int t = 0; t < nt; ++t)
    s[t] = fold_run<W>(states, t * per, per, p, f, init, powers + tile_log * W);
  const int lv = tile_log + log2_floor(per);
  for (int k = 0; (1 << k) < nt; ++k)
    for (int t = nt - 1; t >= 0; --t)      // last to first: no thread reads a joined slot
      if (tree_joins(t, k)) s[t] = join<W>(powers + (lv + k) * W, s[t], s[t + (1 << k)]);
  return (uint64_t)fold_finish<W>(powers, s[0], (uint64_t)(n - f * tile), (state_t<W>)states[f]);
}

template <int W>
int crc_call_host(const uint8_t* data, long long n, unsigned long long value, int tile,
                  int threads, long long piece, int fold_threads, const state_t<W>* consts,
                  uint64_t* out) {
  const unsigned long long ones = W == 64 ? ~0ull : 0xFFFFFFFFull;
  if (n == 0) {
    *out = value & ones;
    return 0;
  }
  if (!pow2(fold_threads) || fold_threads > 1024 || piece <= 0 || piece % tile) return 1;
  std::vector<uint64_t> states((n + tile - 1) / tile);
  for (long long off = 0; off < n; off += piece) {
    const long long m = n - off < piece ? n - off : piece;
    std::vector<uint32_t> words((m + 64 + 3) / 4);
    uint8_t* b = (uint8_t*)words.data();
    std::memset(b + m, 0xA5, words.size() * 4 - m);
    std::memcpy(b, data + off, m);
    const int rc = crc_tiles_host<W>(b, m, tile, threads, consts, states.data() + off / tile);
    if (rc) return rc;
  }
  *out = crc_fold_host<W>(states.data(), n, tile, fold_threads,
                          (state_t<W>)((value ^ ones) & ones), consts);
  return 0;
}

}  // namespace

// crc_init_kernel: `consts` gets const_words<width>() words of width / 8
// bytes (the tables, then the powers Z^(2^k)).
extern "C" int lzt_crc_init_cpu(int width, void* consts) {
  if (width == 64) crc_init_host<64>((uint64_t*)consts);
  else if (width == 32) crc_init_host<32>((uint32_t*)consts);
  else return 1;
  return 0;
}

// crc_tiles_kernel over the n bytes of buf at `tile` bytes and `threads`
// threads a tile: one uint64 state per tile into states.
extern "C" int lzt_crc_tiles_cpu(const void* buf, long long n, int width, int tile, int threads,
                                 const void* consts, void* states) {
  if (width == 64)
    return crc_tiles_host<64>((const uint8_t*)buf, n, tile, threads, (const uint64_t*)consts,
                              (uint64_t*)states);
  if (width == 32)
    return crc_tiles_host<32>((const uint8_t*)buf, n, tile, threads, (const uint32_t*)consts,
                              (uint64_t*)states);
  return 1;
}

// crc_fold_kernel with `fold_threads` threads: the CRC of n bytes from the
// ceil(n / tile) tile states and the init state (value ^ all-ones) in *out.
extern "C" int lzt_crc_fold_cpu(const void* states, long long n, int width, int tile,
                                int fold_threads, unsigned long long init, const void* consts,
                                void* out) {
  if (n <= 0 || !pow2(tile) || !pow2(fold_threads) || fold_threads > 1024) return 1;
  if (width == 64)
    *(uint64_t*)out = crc_fold_host<64>((const uint64_t*)states, n, tile, fold_threads,
                                        (uint64_t)init, (const uint64_t*)consts);
  else if (width == 32)
    *(uint64_t*)out = crc_fold_host<32>((const uint64_t*)states, n, tile, fold_threads,
                                        (uint32_t)init, (const uint32_t*)consts);
  else
    return 1;
  return 0;
}

// A whole call (ops/checksum.py's crc*_device on the card): pieces of
// `piece` bytes (a multiple of tile), a tile launch each, then the fold;
// the CRC of data from `value` in *out.
extern "C" int lzt_crc_call_cpu(const void* data, long long n, int width,
                                unsigned long long value, int tile, int threads,
                                long long piece, int fold_threads, const void* consts,
                                void* out) {
  if (width == 64)
    return crc_call_host<64>((const uint8_t*)data, n, value, tile, threads, piece, fold_threads,
                             (const uint64_t*)consts, (uint64_t*)out);
  if (width == 32)
    return crc_call_host<32>((const uint8_t*)data, n, value, tile, threads, piece, fold_threads,
                             (const uint32_t*)consts, (uint64_t*)out);
  return 1;
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

// X2 (match_find.cu) over S lanes of L bytes, same arguments as
// lzt_match_find but the scratch and the stream, plus the kernels'
// geometry: `tile` keys a sorted tile, `run` positions a row block owns and
// `threads` threads of a row block (each cut as the kernels cut them), and
// `staged`: the row block reads its row from a staged copy (1, the row in
// shared memory) or from the row itself (0, through global memory).  Each
// pass plays the tile sort (every bitonic stage's pairs last to first) and
// the merge rounds (rc 2 if a round's destinations are not a permutation
// of the lane); the launch that puts the keys in their final order, the
// last round or the tile sort of a one-tile lane, places them with their
// ranks (rc 3 if the ranks are not a permutation).  Then the row launch,
// its blocks last to first: the row's staging, and per chunk its threads'
// parts, each group's best (the kernel's shuffles), then the stores of
// the three staged arrays, threads last to first.
extern "C" int lzt_match_find_cpu(const void* data, const void* valid, int S, int L, int n_cand,
                                  int n_cand8, int hash_bits, int tile, int run, int threads,
                                  int staged, void* best_len, void* best_dist, void* cands) {
  using namespace lzt::mf;
  int lb = 0;
  while ((1ll << lb) < L) ++lb;
  if (S < 1 || L < 1 || (1 << lb) != L || lb > 30 || n_cand < 1 || n_cand > 1024 ||
      n_cand8 < 0 || n_cand8 > 1024 || hash_bits < 1 || hash_bits > 31 || tile < 1 ||
      (tile & (tile - 1)) || run < 1 || (run & (run - 1)) || threads < 1 ||
      (threads & (threads - 1)))
    return 1;
  if (tile > L) tile = L;
  int rounds = 0;
  while ((tile << rounds) < L) ++rounds;
  const uint8_t* d = (const uint8_t*)data;
  const int32_t* v = (const int32_t*)valid;
  const size_t SL = (size_t)S * L;
  const int ktot = n_cand + n_cand8;
  std::vector<int32_t> sorted(2 * SL), rank(2 * SL), spare(SL), s(tile);
  std::vector<char> hit(L);
  for (int pass = 0; pass < (n_cand8 ? 2 : 1); ++pass) {
    int32_t* sp = sorted.data() + pass * SL;
    int32_t* rk = rank.data() + pass * SL;
    int32_t* src = rounds & 1 ? spare.data() : sp;
    int32_t* dst = rounds & 1 ? sp : spare.data();
    for (int lane = 0; lane < S; ++lane) {
      const uint8_t* row = d + (size_t)lane * L;
      const size_t at = (size_t)lane * L;
      for (int base = 0; base < L; base += tile) {
        for (int j = 0; j < tile; ++j) s[j] = pass_key(row, L, lb, base + j, v[lane], pass, hash_bits);
        for (int k = 2; k <= tile; k <<= 1)
          for (int j = k >> 1; j > 0; j >>= 1)
            for (int m = tile / 2 - 1; m >= 0; --m) bitonic_pair(s.data(), k, j, m);
        for (int j = tile - 1; j >= 0; --j) {
          if (rounds) src[at + base + j] = s[j];
          else place_key(src + at, rk + at, L, base + j, s[j]);
        }
      }
    }
    for (int w = tile; w < L; w <<= 1) {
      for (int lane = 0; lane < S; ++lane) {
        const size_t row = (size_t)lane * L;
        std::fill(hit.begin(), hit.end(), 0);
        for (int i = L - 1; i >= 0; --i) {
          const int at = merge_dest(src + row, w, i);
          if (at < 0 || at >= L || hit[at]++) return 2;
          if (2 * w == L) place_key(dst + row, rk + row, L, at, src[row + i]);
          else dst[row + at] = src[row + i];
        }
      }
      std::swap(src, dst);
    }
    for (int lane = 0; lane < S; ++lane) {
      std::fill(hit.begin(), hit.end(), 0);
      for (int p = 0; p < L; ++p) {
        const int32_t r = rk[(size_t)lane * L + p];
        if (r < 0 || r >= L || hit[r]++) return 3;
      }
    }
  }
  int chunk, run_len;
  row_geometry(threads, run, L, ktot, &chunk, &run_len);
  const int active = chunk * kGroup;
  std::vector<int32_t> stage((size_t)chunk * ktot), sbl(chunk), sbd(chunk);
  std::vector<Best> b1(active), b2(active), r1(chunk), r2(chunk);
  std::vector<uint32_t> words(staged_row_words(L));
  int32_t* bl_out = (int32_t*)best_len;
  int32_t* bd_out = (int32_t*)best_dist;
  int32_t* c_out = (int32_t*)cands;
  for (int lane = 0; lane < S; ++lane) {
    const size_t at = (size_t)lane * L;
    const uint8_t* row = d + at;
    const PassKeys k1 = pass_keys(sorted.data(), rank.data(), SL, at, 0);
    const PassKeys k2 = pass_keys(sorted.data(), rank.data(), SL, at, 1);
    for (int r0 = L - run_len; r0 >= 0; r0 -= run_len) {
      for (int i = (int)words.size() - 1; staged && i >= 0; --i)
        stage_row_word(row, L, words.data(), i);
      for (int c0 = r0; c0 < r0 + run_len; c0 += chunk) {
        for (int t = active - 1; t >= 0; --t) {
          b1[t] = b2[t] = Best{-1, 0, 0};
          if (staged)
            chunk_part(StagedRow{words.data()}, k1, k2, n_cand, n_cand8, lb, L, v[lane], c0, t,
                       stage.data(), b1[t], b2[t]);
          else
            chunk_part(GlobalRow{row, L}, k1, k2, n_cand, n_cand8, lb, L, v[lane], c0, t,
                       stage.data(), b1[t], b2[t]);
        }
        for (int i = chunk - 1; i >= 0; --i) {     // the group shuffles
          r1[i] = b1[i * kGroup];
          r2[i] = b2[i * kGroup];
          for (int g = 1; g < kGroup; ++g) {
            keep_better(r1[i], b1[i * kGroup + g]);
            keep_better(r2[i], b2[i * kGroup + g]);
          }
        }
        for (int i = chunk - 1; i >= 0; --i)
          best_of_passes(r1[i], r2[i], n_cand8, &sbl[i], &sbd[i]);
        for (int t = threads - 1; t >= 0; --t) {
          store_staged(stage.data(), c_out + (at + c0) * ktot, chunk * ktot, t, threads);
          store_staged(sbl.data(), bl_out + at + c0, chunk, t, threads);
          store_staged(sbd.data(), bd_out + at + c0, chunk, t, threads);
        }
      }
    }
  }
  return 0;
}

// X4's fixed-alignment filters (branch_filters.cu) over n_lanes rows of
// `row` bytes of `in` into `out`, valid int32 and ip int64 per lane, at the
// kernels' units: each lane's units run last to first, through the 16-byte
// path where the kernels would take it (both buffers and `row` 16-aligned).
// kind 0 ARM, 1 PPC, 2 SPARC (row % 4 == 0), 3 ARM Thumb (out rows of
// row / 2 * 2 bytes), 4 IA64.
extern "C" int lzt_branch_batch_cpu(int kind, const void* in, void* out, long long row,
                                    const void* valid, const void* ip, int n_lanes,
                                    int encoding) {
  using namespace lzt::bra;
  if (kind < 0 || kind > 4 || row < 0 || (kind < 3 && row % 4 != 0)) return 1;
  const bool vec = (((uintptr_t)in | (uintptr_t)out | (uintptr_t)row) & 15) == 0;
  const bool enc = encoding != 0;
  const int64_t H = row / 2;
  const int64_t units = kind == 3 ? (H + 7) / 8 : (row + kUnit - 1) / kUnit;
  const int64_t out_row = kind == 3 ? 2 * H : row;
  for (int64_t lane = 0; lane < n_lanes; ++lane) {
    const uint8_t* li = (const uint8_t*)in + lane * row;
    uint8_t* lo = (uint8_t*)out + lane * out_row;
    const uint32_t v = (uint32_t)((const int32_t*)valid)[lane];
    const uint32_t ipl = (uint32_t)((const int64_t*)ip)[lane];
    for (int64_t u = units - 1; u >= 0; --u) {
      if (kind == kArm) word_unit<kArm>(li, lo, row, u, v, ipl, enc, vec);
      else if (kind == kPpc) word_unit<kPpc>(li, lo, row, u, v, ipl, enc, vec);
      else if (kind == kSparc) word_unit<kSparc>(li, lo, row, u, v, ipl, enc, vec);
      else if (kind == 3) armt_unit(li, lo, H, u, v, ipl, enc, vec);
      else ia64_unit(li, lo, row, u, v, ipl, enc, vec);
    }
  }
  return 0;
}

// X4's delta decode by segments (branch_filters.cu), one lane's blocks at
// a time in the order `backward` gives.  Each block plays its threads last
// to first within each phase between two barriers, every read of a phase
// before the writes of the next: the chunk loads and totals, the chunk
// scan (each Hillis-Steele step all reads, then all writes; or each warp's
// shuffle steps, every lane reading the step before's values, then the
// warp totals), then the block's writes.  The scratch and the shared
// totals start as 0xA5 bytes, so a read of a byte no launch wrote shows.
template <int KIND, int RK, bool AL>
void delta_segments_cpu(const uint8_t* in, uint8_t* out, int64_t L, const int32_t* valid,
                        int dist, int n_lanes, int threads, int per, bool backward) {
  using namespace lzt::bra;
  const DeltaGeom g = delta_geom(dist, L, threads, per);
  std::vector<uint32_t> scratch_words((size_t)n_lanes * g.nseg * g.ent / 4, 0xA5A5A5A5u);
  uint8_t* scratch = reinterpret_cast<uint8_t*>(scratch_words.data());
  const int warps = (threads + 31) / 32;
  std::vector<uint32_t> tot(threads), own(threads), incl(threads), add(threads), wsum(warps);
  std::vector<std::array<uint32_t, 32>> x(threads);
  const int active = g.nc * g.K;
  const int64_t nblocks = (int64_t)n_lanes * g.nseg;
  auto block_at = [&](int64_t b) { return backward ? nblocks - 1 - b : b; };
  // the chunk loads and totals of block (lane, s), then (where `scan`)
  // the chunk scan into incl
  auto load_and_scan = [&](int64_t lane, int64_t s, bool scan) {
    const int64_t base = s * g.seg;
    for (int t = threads - 1; t >= 0; --t) {
      own[t] = 0;
      const int cu = t % g.nc, k = t / g.nc;
      if (k < g.K) {
        const int64_t at0 = delta_chunk_at(g, base, cu, k);
        delta_chunk_load<KIND, RK, AL>(in + lane * L + at0, g.nc * g.us, L - at0, x[t].data());
        own[t] = delta_chunk_total<KIND, RK>(x[t].data());
      }
    }
    if (!scan) return;
    std::fill(tot.begin(), tot.end(), 0xA5A5A5A5u);
    std::fill(wsum.begin(), wsum.end(), 0xA5A5A5A5u);
    if (g.nc == 1) {
      for (int t = threads - 1; t >= 0; --t) incl[t] = own[t];
      for (int off = 1; off < 32; off <<= 1) {   // each lane reads lane - off's value
        for (int t = threads - 1; t >= 0; --t)
          add[t] = (t & 31) >= off ? incl[t - off] : 0;
        for (int t = threads - 1; t >= 0; --t) incl[t] = vadd4(incl[t], add[t]);
      }
      for (int t = threads - 1; t >= 0; --t)
        if ((t & 31) == 31 || t == threads - 1) wsum[t >> 5] = incl[t];
      for (int t = threads - 1; t >= 0; --t)
        incl[t] = vadd4(delta_warp_prefix(wsum.data(), t >> 5), incl[t]);
      return;
    }
    for (int t = threads - 1; t >= 0; --t) tot[t] = own[t];
    for (int off = g.nc; off < active; off <<= 1) {
      for (int t = threads - 1; t >= 0; --t)
        add[t] = t < active ? delta_scan_addend(tot.data(), t, off) : 0;
      for (int t = threads - 1; t >= 0; --t) tot[t] = vadd4(tot[t], add[t]);
    }
    for (int t = threads - 1; t >= 0; --t) incl[t] = tot[t];
  };
  for (int64_t b = 0; b < nblocks; ++b) {   // launch 1: reduce
    const int64_t lane = block_at(b) / g.nseg, s = block_at(b) % g.nseg;
    if (s * g.seg >= delta_end(valid[lane], L)) continue;
    load_and_scan(lane, s, true);
    uint8_t* entry = scratch + (lane * g.nseg + s) * g.ent;
    for (int t = threads - 1; t >= 0; --t) {
      if (t / g.nc == g.K - 1) delta_put_total<KIND>(entry, t % g.nc, incl[t]);
      if (KIND == kDByte && t < g.ent - dist) entry[dist + t] = 0;
    }
  }
  const int words = g.ent / 4;   // launch 2: carries
  for (int64_t b = 0; b < (int64_t)n_lanes * words; ++b) {
    const int64_t i = backward ? (int64_t)n_lanes * words - 1 - b : b;
    const int64_t lane = i / words, end = delta_end(valid[lane], L);
    delta_carry_words(scratch + lane * g.nseg * g.ent, g.ent, (int)(i % words),
                      (end + g.seg - 1) / g.seg);
  }
  for (int64_t b = 0; b < nblocks; ++b) {   // launch 3: scan
    const int64_t lane = block_at(b) / g.nseg, s = block_at(b) % g.nseg;
    const int64_t base = s * g.seg, end = delta_end(valid[lane], L);
    const bool scan = base < end;
    load_and_scan(lane, s, scan);
    const uint8_t* entry = scratch + (lane * g.nseg + s) * g.ent;
    for (int t = threads - 1; t >= 0; --t) {
      const int cu = t % g.nc, k = t / g.nc;
      if (k >= g.K) continue;
      const uint32_t run =
          scan ? vadd4(delta_get_total<KIND>(entry, cu), vsub4(incl[t], own[t])) : 0;
      const int64_t at0 = delta_chunk_at(g, base, cu, k);
      delta_chunk_store<KIND, RK, AL>(out + lane * L + at0, g.nc * g.us, L - at0, end - at0, run,
                                      x[t].data());
    }
  }
}

// The byte columns' launches (kDByte, branch_filters.cu), as
// delta_segments_cpu plays the word columns': each block stages its
// segment (threads last to first) into shared memory that starts as 0xA5
// bytes, totals or scans its columns' chunks there, and writes it out.
template <bool AL>
void delta_bytes_cpu(const uint8_t* in, uint8_t* out, int64_t L, const int32_t* valid, int dist,
                     int n_lanes, int threads, int per, bool backward) {
  using namespace lzt::bra;
  const DeltaGeom g = delta_geom(dist, L, threads, per);
  std::vector<uint32_t> scratch_words((size_t)n_lanes * g.nseg * g.ent / 4, 0xA5A5A5A5u);
  uint8_t* scratch = reinterpret_cast<uint8_t*>(scratch_words.data());
  std::vector<uint32_t> staged_words((delta_staged_bytes(g) + 3) / 4);
  uint8_t* staged = reinterpret_cast<uint8_t*>(staged_words.data());
  std::vector<uint32_t> tot(threads), own(threads), add(threads);
  const int active = g.nc * g.K, pitch = g.rk * g.nc + 4;
  const int64_t nblocks = (int64_t)n_lanes * g.nseg;
  auto block_at = [&](int64_t b) { return backward ? nblocks - 1 - b : b; };
  auto stage = [&](const uint8_t* row, int64_t base) {
    std::fill(staged_words.begin(), staged_words.end(), 0xA5A5A5A5u);
    for (int t = threads - 1; t >= 0; --t)
      for (int u = t; 16 * u < g.seg; u += threads)
        delta_stage_unit<AL>(staged, row, base, L, g, u);
  };
  auto scan = [&]() {   // the chunk totals and their scan into tot
    for (int t = threads - 1; t >= 0; --t)
      own[t] = t < active ? delta_bytes_total(staged + t % g.K * pitch, g.nc, g.rk, t / g.K) : 0;
    for (int t = threads - 1; t >= 0; --t) tot[t] = own[t];
    for (int off = 1; off < g.K; off <<= 1) {
      for (int t = threads - 1; t >= 0; --t)
        add[t] = t < active ? delta_scan_addend_k(tot.data(), t, t % g.K, off) : 0;
      for (int t = threads - 1; t >= 0; --t) tot[t] = vadd4(tot[t], add[t]);
    }
  };
  for (int64_t b = 0; b < nblocks; ++b) {   // launch 1: reduce
    const int64_t lane = block_at(b) / g.nseg, s = block_at(b) % g.nseg;
    if (s * g.seg >= delta_end(valid[lane], L)) continue;
    stage(in + lane * L, s * g.seg);
    scan();
    uint8_t* entry = scratch + (lane * g.nseg + s) * g.ent;
    for (int t = threads - 1; t >= 0; --t) {
      if (t < active && t % g.K == g.K - 1) delta_put_total<kDByte>(entry, t / g.K, tot[t]);
      if (t < g.ent - dist) entry[dist + t] = 0;
    }
  }
  const int words = g.ent / 4;   // launch 2: carries
  for (int64_t b = 0; b < (int64_t)n_lanes * words; ++b) {
    const int64_t i = backward ? (int64_t)n_lanes * words - 1 - b : b;
    const int64_t lane = i / words, end = delta_end(valid[lane], L);
    delta_carry_words(scratch + lane * g.nseg * g.ent, g.ent, (int)(i % words),
                      (end + g.seg - 1) / g.seg);
  }
  for (int64_t b = 0; b < nblocks; ++b) {   // launch 3: scan
    const int64_t lane = block_at(b) / g.nseg, s = block_at(b) % g.nseg;
    const int64_t base = s * g.seg, end = delta_end(valid[lane], L);
    stage(in + lane * L, base);
    if (base < end) {
      const uint8_t* entry = scratch + (lane * g.nseg + s) * g.ent;
      scan();
      for (int t = active - 1; t >= 0; --t) {
        const int cu = t / g.K, k = t % g.K;
        delta_bytes_scan(staged + k * pitch, g.nc, g.rk, cu,
                         end - (base + (int64_t)k * g.rk * g.nc),
                         vadd4(delta_get_total<kDByte>(entry, cu), vsub4(tot[t], own[t])));
      }
    }
    for (int t = threads - 1; t >= 0; --t)
      for (int u = t; 16 * u < g.seg; u += threads)
        delta_unstage_unit<AL>(out + lane * L, staged, base, L, g, u);
  }
}

template <int KIND, bool AL>
int delta_segments_rk(const uint8_t* in, uint8_t* out, int64_t L, const int32_t* valid,
                      int dist, int n_lanes, int threads, int per, bool backward) {
#define LZT_DELTA_RK(n)                                                                     \
  case n:                                                                                   \
    delta_segments_cpu<KIND, n, AL>(in, out, L, valid, dist, n_lanes, threads, per, backward); \
    return 0;
  switch (per / 4) {
    LZT_DELTA_RK(1) LZT_DELTA_RK(2) LZT_DELTA_RK(4) LZT_DELTA_RK(8) LZT_DELTA_RK(16)
    LZT_DELTA_RK(32)
  }
#undef LZT_DELTA_RK
  return 1;
}

template <int KIND>
int delta_segments_al(const uint8_t* in, uint8_t* out, int64_t L, const int32_t* valid,
                      int dist, int n_lanes, int threads, int per, bool backward, bool al) {
  return al ? delta_segments_rk<KIND, true>(in, out, L, valid, dist, n_lanes, threads, per,
                                            backward)
            : delta_segments_rk<KIND, false>(in, out, L, valid, dist, n_lanes, threads, per,
                                             backward);
}

// X4's delta (branch_filters.cu) over n_lanes rows of `row` bytes, valid
// int32 per lane, at `threads` threads a decode block whose threads hold
// `per` bytes of words or `per` rows of a byte column (per 4, 8, 16, 32 or
// 64; the kernel's 256 and 64).  Encode plays its units, decode its three launches
// (delta_segmented) or its column walk, the aligned path where the kernel
// takes it (buffers and row 16-aligned); `backward`: every launch's blocks
// (or units, or columns) last to first instead of first to last.
extern "C" int lzt_delta_batch_cpu(const void* in, void* out, long long row, const void* valid,
                                   long long dist, int n_lanes, int encoding, int threads,
                                   int per, int backward) {
  using namespace lzt::bra;
  if (dist < 1 || row < 0 || threads < 1 || threads > 4096 ||
      (per != 4 && per != 8 && per != 16 && per != 32 && per != 64))
    return 1;
  if (n_lanes <= 0 || row == 0) return 0;
  const int64_t L = row, d = dist < row ? dist : row;
  const uint8_t* i8 = (const uint8_t*)in;
  uint8_t* o8 = (uint8_t*)out;
  const int32_t* v = (const int32_t*)valid;
  const uintptr_t bits = (uintptr_t)in | (uintptr_t)out | (uintptr_t)row;
  const bool vec = (bits & 15) == 0;
  if (encoding) {
    const int64_t units = (L + kUnit - 1) / kUnit;
    for (int64_t lane = 0; lane < n_lanes; ++lane)
      for (int64_t j = 0; j < units; ++j) {
        const int64_t u = backward ? units - 1 - j : j;
        delta_encode_unit(i8 + lane * L, o8 + lane * L, L, u, d, delta_end(v[lane], L), vec);
      }
    return 0;
  }
  if (!delta_segmented(d, threads)) {
    const bool words = (bits & 3) == 0 && d % 4 == 0;
    const int64_t cols = words ? d / 4 : d;
    for (int64_t lane = 0; lane < n_lanes; ++lane)
      for (int64_t j = 0; j < cols; ++j)
        delta_walk_column(i8 + lane * L, o8 + lane * L, L, delta_end(v[lane], L), d,
                          backward ? cols - 1 - j : j, words);
    return 0;
  }
  const int di = (int)d;
  const bool bw = backward != 0;
  switch (delta_kind(d)) {
    case kD1: return delta_segments_al<kD1>(i8, o8, L, v, di, n_lanes, threads, per, bw, vec);
    case kD2: return delta_segments_al<kD2>(i8, o8, L, v, di, n_lanes, threads, per, bw, vec);
    case kDWord: return delta_segments_al<kDWord>(i8, o8, L, v, di, n_lanes, threads, per, bw, vec);
    default:
      if (vec) delta_bytes_cpu<true>(i8, o8, L, v, di, n_lanes, threads, per, bw);
      else delta_bytes_cpu<false>(i8, o8, L, v, di, n_lanes, threads, per, bw);
      return 0;
  }
}
