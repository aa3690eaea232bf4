// Per-element arithmetic of the two bit-call microbenchmarks, P1
// (v12_probe.cu, after tools/dev_v12_probe.py) and P2 (compact_probe.cu,
// after tools/compact_probe.py): one range-coder-bit-shaped call on
// synthetic state, and the per-thread pieces of the kernels' layouts (the
// phases of a P1 row call, the owned-slot stores, submask's slots across a
// warp, the m16n8k16 fragment maps of mxu's relayouts).  The kernels run
// these functions on the card; cpu_harness.cc builds the very same code
// with g++ and plays the kernels' threads, barrier by barrier, so the
// tests can hold it against the plain PyTorch versions on a machine
// without a GPU.
//
// The two probes differ in their integer types, and the outputs must be
// bit-identical to the TPU kernels':
// * P1 keeps rng and code as uint32 (logical >>, products and differences
//   wrap mod 2^32); probabilities and indices are int32.
// * P2 runs entirely in signed int32: products, differences and left
//   shifts wrap, >> is arithmetic, and rng does go negative.  Signed
//   overflow is undefined in C++, so every wrapping step is computed in
//   uint32_t and cast back.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace lzt {
namespace probe {

constexpr int kCalls = 28;          // bit calls per iteration (both probes)
constexpr int kLanes = 128;         // P1 row width, P2 stream count
constexpr int kTables = 8;          // P1 probability tables
constexpr int32_t kProbInit = 1024;

__host__ __device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wrap_shl(int32_t a, int n) {
  return (int32_t)((uint32_t)a << n);
}

// The adapted probability after a bit (both probes, int32).
__host__ __device__ __forceinline__ int32_t adapt(int32_t p, bool bit0) {
  return bit0 ? wrap_add(p, wrap_sub(2048, p) >> 5) : wrap_sub(p, p >> 5);
}

// ---- P1 (dev_v12_probe.py:54-64, :80-95, :106-129) -------------------------

// variant codes; tools/dev_v12_probe.py's VARIANTS holds the same order
enum V12Variant {
  kBroadcast = 0, kMasked, kFused2, kLive, kTailAlways, kTailNever, kTailCond,
  kWhile, kWhileCond, kLane, kLaneNotr
};

__host__ __device__ __forceinline__ int clip127(int32_t i) {
  return i < 0 ? 0 : i > kLanes - 1 ? kLanes - 1 : i;
}

// bound = (rng >> 11) * uint32(p)
__host__ __device__ __forceinline__ uint32_t v12_bound(uint32_t rng, int32_t p) {
  return (rng >> 11) * (uint32_t)p;
}

// The range and code after a bit with bound `bound`; only where `live` (the
// masked variants' `do`) do they take the bit, but the renormalisation
// shift always runs.
__host__ __device__ __forceinline__ void v12_settle(uint32_t& rng, uint32_t& code,
                                                    uint32_t bound, bool bit0,
                                                    bool live) {
  if (live) {
    rng = bit0 ? bound : rng - bound;
    code = bit0 ? code : code - bound;
  }
  if (rng < (1u << 24)) rng <<= 8;
}

// The 26-trip direct-bits-shaped tail of the tail* variants (:196-201).
__host__ __device__ __forceinline__ void v12_tail(uint32_t& r, uint32_t& c) {
  for (int i = 0; i < 26; ++i) {
    r = c > r ? r ^ (c >> 1) : r;
    c += r & 0xFFu;
  }
}

// The owned-slot store: slot l of a table is only ever written by thread
// l, and only when the index it stores at points there.  Returns whether it
// wrote.
__host__ __device__ __forceinline__ bool owned_store(int32_t* table, int l, int32_t target,
                                                    int32_t v) {
  const bool mine = l == (target & (kLanes - 1));
  if (mine) table[l] = v;
  return mine;
}

// One thread of a P1 row (lane l of row s): its state, and what a call's
// gather phase hands its store phase.
struct V12Row {
  uint32_t rng, code, bound;
  int32_t idx, p, newp;
  bool live, bit0;
};

// A row call's first phase on one thread: the gather from table b % 8 (and,
// with kFuse, from table (b + 1) % 8) of the row's tables tbl[t * 128 + j],
// the bound and the adapted probability.  No table is written.  Returns
// the tables it read as a bit mask (the CPU harness checks that no phase
// reads a table that it writes; the kernels drop it).
template <bool kFuse>
__host__ __device__ __forceinline__ unsigned v12_row_gather(const int32_t* tbl, int b,
                                                            V12Row& s) {
  const int t0 = b % kTables, t1 = (b + 1) % kTables;
  int32_t p = tbl[t0 * kLanes + clip127(s.idx)];
  if (kFuse) {
    const int32_t p2 = tbl[t1 * kLanes + clip127(s.idx + 1)];
    p = s.live ? p : p2;
  }
  s.p = p;
  s.bound = v12_bound(s.rng, p);
  s.bit0 = s.code < s.bound;
  s.newp = adapt(p, s.bit0);
  return 1u << t0 | (kFuse ? 1u << t1 : 0u);
}

// A row call's second phase on thread l: the owned-slot store into table
// b % 8 (kStore2, fused2: also into table (b + 1) % 8 where not live).
// Call b stores only into table b % 8 and call b + 1 gathers only from
// tables (b + 1) % 8 and (b + 2) % 8, so a call's stores and the next
// call's gathers may share a phase: one barrier a call, between the
// gathers and the stores.  fused2's second store goes into the table the
// next call reads, so it alone needs a barrier after its stores too.
// Returns the tables it wrote as a bit mask.  The range update
// (v12_row_settle) follows, after fused2's second barrier: the next
// gather does not wait for it.
template <bool kStore2>
__host__ __device__ __forceinline__ unsigned v12_row_store(int32_t* tbl, int b, int l,
                                                           const V12Row& s) {
  const int t0 = b % kTables, t1 = (b + 1) % kTables;
  unsigned wrote = owned_store(tbl + t0 * kLanes, l, s.idx, s.newp) ? 1u << t0 : 0u;
  if (kStore2 && !s.live && owned_store(tbl + t1 * kLanes, l, s.idx + 1, s.newp))
    wrote |= 1u << t1;
  return wrote;
}

// The rest of a row call on one thread: the range update (only where live
// for the masked variants) and the next index, which advances by the
// gathered probability.
template <bool kMask>
__host__ __device__ __forceinline__ void v12_row_settle(V12Row& s) {
  v12_settle(s.rng, s.code, s.bound, s.bit0, kMask ? s.live : true);
  s.idx = wrap_add(s.idx, s.p) & 127;
}

// Whether a row call needs a barrier after its stores as well (see
// v12_row_store): only when it has fused2's second store.
__host__ __device__ constexpr bool v12_store_barrier(bool store2) { return store2; }

// One call of the lane variants on one stream: `lane` gathers from its
// slot (b % 8, clip(idx)) and stores at (b % 8, idx & 127); `lane-notr`
// takes code & 2047 as its probability and touches no table (both pointers
// unused).
template <bool kTables8>
__host__ __device__ __forceinline__ void v12_lane_call(const int32_t* from, int32_t* to,
                                                       uint32_t& rng, uint32_t& code,
                                                       int32_t& idx) {
  const int32_t p = kTables8 ? *from : (int32_t)(code & 2047u);
  const uint32_t bound = v12_bound(rng, p);
  const bool bit0 = code < bound;
  const int32_t newp = adapt(p, bit0);
  if (kTables8) *to = newp;
  v12_settle(rng, code, bound, bit0, true);
  idx = wrap_add(idx, newp) & 127;
}

// ---- P2 (compact_probe.py:55-66) -------------------------------------------

// The shared per-call ALU `_alu` in signed int32; returns the new
// probability and updates rng, code and st.
__host__ __device__ __forceinline__ int32_t compact_alu(int32_t& rng, int32_t& code,
                                                        int32_t& st, int32_t prob) {
  const int32_t bound = wrap_mul(rng >> 11, prob);
  const bool bit = code < bound;
  rng = bit ? bound : wrap_sub(rng, bound);
  code = bit ? code : wrap_sub(code, bound);
  const int32_t newp = adapt(prob, bit);
  if (rng < (1 << 24)) {
    rng = wrap_shl(rng, 8);
    code = (wrap_shl(code, 8) | 0x5A) & 0x7FFFFFFF;
  }
  st = ((bit ? wrap_add(wrap_shl(st, 1), 1) : wrap_shl(st, 1)) ^ (code >> 17)) & 0x3FFF;
  return newp;
}

// The table slot of a call: (st + (code >> 7)) & 127 (bcast, mxu, tpose).
__host__ __device__ __forceinline__ int32_t compact_slot(int32_t st, int32_t code) {
  return wrap_add(st, code >> 7) & 127;
}

// JAX's floor modulo: the result has the sign of m (C's % truncates).
__host__ __device__ __forceinline__ int32_t floor_mod(int32_t x, int32_t m) {
  const int32_t r = x % m;
  return r < 0 ? r + m : r;
}

// The submask variant's slot: (st + (code >> 7)) % 192, a floor modulo whose
// left side can be negative.
__host__ __device__ __forceinline__ int32_t compact_slot_mod(int32_t st, int32_t code,
                                                             int32_t slots) {
  return floor_mod(wrap_add(st, code >> 7), slots);
}

// The initial code of stream (or row) i: i * 7919 + 13 + seed.
__host__ __device__ __forceinline__ int32_t compact_code0(int32_t i, int32_t seed) {
  return wrap_add(wrap_add(wrap_mul(i, 7919), 13), seed);
}

constexpr int kSubSlots = 192;      // submask: table slots per stream
constexpr int kSubLanes = 32;       // submask: threads per stream (a warp)

// The owned slot after a call that stores `v` at `target`: thread l keeps
// slot l of the table, updated or not (bcast writes it into the next copy).
__host__ __device__ __forceinline__ int32_t owned_slot(int32_t mine, int l, int32_t target,
                                                       int32_t v) {
  return l == target ? v : mine;
}

// bcast's two table copies: call b reads copy b & 1 and writes every slot
// into copy (b + 1) & 1 (kCalls is even, so each iteration starts on copy
// 0).
__host__ __device__ constexpr int bcast_read_copy(int b) { return b & 1; }
__host__ __device__ constexpr int bcast_write_copy(int b) { return (b + 1) & 1; }

// submask across T threads of a stream: thread j holds slots j, j + T, ...
// (kSubSlots / T of them) in v.  Its part of the masked read is the masked
// sum of its own slots (the stream's read is the sum of the T parts, a warp
// reduction on the card); the masked select writes newp into its own slots
// where the slot is idx.  Every slot is visited by both, as in the TPU
// probe; neither gathers.
template <int T>
__host__ __device__ __forceinline__ int32_t submask_read(const int32_t* v, int j, int32_t idx) {
  int32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kSubSlots / T; ++k) acc = wrap_add(acc, j + T * k == idx ? v[k] : 0);
  return acc;
}

template <int T>
__host__ __device__ __forceinline__ void submask_select(int32_t* v, int j, int32_t idx,
                                                        int32_t newp) {
#pragma unroll
  for (int k = 0; k < kSubSlots / T; ++k) v[k] = j + T * k == idx ? newp : v[k];
}

// Thread j's part of the final column sum of its stream's slots.
template <int T>
__host__ __device__ __forceinline__ int32_t submask_sum(const int32_t* v) {
  int32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kSubSlots / T; ++k) acc = wrap_add(acc, v[k]);
  return acc;
}

// ---- mxu's relayouts as mma.sync.m16n8k16 (f16 inputs, f32 accumulator) ----
//
// A relayout is y = E v with E the 128 x 128 one-hot (identity) matrix and
// v the 128 streams' values.  Every value a relayout carries is an integer
// below 2048 (slot indices < 128, probabilities 31..2017), which fp16 holds
// exactly, and each row of E has one 1, so the f32 sum is that value: the
// product is exact, as the TPU kernel's f32 HIGHEST product is.  Warp w
// computes rows 32w .. 32w + 31 (its own streams) as two M-tiles of 16
// rows, over 8 K-steps of 16 columns.  The vector fills all 8 columns of
// the N = 8 operand (the mma computes 8 columns whatever they hold), so
// every lane of a group holds the group's two rows of each M-tile, and one
// shuffle brings each stream's entry home.  The maps below are PTX's
// fragment layouts for m16n8k16 with .f16 A/B and .f32 C/D: lane =
// 4 * group + tig.

struct RowCol {
  int row, col;
};

// Element e (0..7; register e / 2, half e % 2, low half first) of a lane's
// A fragment: its row and column in the 16 x 16 tile.
__host__ __device__ __forceinline__ RowCol mma_a_entry(int lane, int e) {
  const int group = lane >> 2, tig = lane & 3;
  return {group + ((e >> 1) & 1) * 8, tig * 2 + (e & 1) + (e >> 2) * 8};
}

// Element e (0..3) of a lane's B fragment: its row (k) and column (n) in
// the 16 x 8 tile.
__host__ __device__ __forceinline__ RowCol mma_b_entry(int lane, int e) {
  const int group = lane >> 2, tig = lane & 3;
  return {tig * 2 + (e & 1) + (e >> 1) * 8, group};
}

// Element e (0..3) of a lane's C/D fragment: its row and column in the
// 16 x 8 tile.
__host__ __device__ __forceinline__ RowCol mma_c_entry(int lane, int e) {
  const int group = lane >> 2, tig = lane & 3;
  return {group + (e >> 1) * 8, tig * 2 + (e & 1)};
}

// The one-hot matrix entry of element e of warp w's A fragment for M-tile
// t and K-step ks: 1 on the diagonal.
__host__ __device__ __forceinline__ bool mxu_a_one(int w, int t, int ks, int lane, int e) {
  const RowCol rc = mma_a_entry(lane, e);
  return 32 * w + 16 * t + rc.row == 16 * ks + rc.col;
}

// The 32-bit word of the f16 vector (two entries) that register reg (0, 1)
// of a lane's B fragment for K-step ks holds: entries 16 ks + k for its
// mma_b_entry rows k (the same in every column).
__host__ __device__ __forceinline__ int mxu_b_word(int lane, int ks, int reg) {
  return 8 * ks + 4 * reg + (lane & 3);
}

// mxu's vector buffers: a call of parity P (call b, P = b & 1) puts
// relayout r's vector (r = 0, 1, 2) in buffer (P + r) & 1, so consecutive
// relayouts alternate and no write lands in a buffer that a thread may
// still read: one barrier a relayout, before its product.
__host__ __device__ constexpr int mxu_buffer(int P, int r) { return (P + r) & 1; }

// Which of a lane's results it sends, and which lane stream r (0..31 in its
// warp) reads from: the lane with tig = 2 * tile + half sends tile `tile`'s
// row group + 8 * half (C element 2 * half of that tile), and row r =
// 16 * tile + 8 * half + group is read from lane 4 * group + 2 * tile + half.
__host__ __device__ __forceinline__ int mxu_send_tile(int lane) { return (lane & 3) >> 1; }
__host__ __device__ __forceinline__ int mxu_send_elem(int lane) { return 2 * (lane & 1); }
__host__ __device__ __forceinline__ int mxu_src_lane(int r) {
  return 4 * (r & 7) + 2 * (r >> 4) + ((r >> 3) & 1);
}

}  // namespace probe
}  // namespace lzt
