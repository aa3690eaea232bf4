// Per-thread pieces of X2, the sorted-bucket match finder (match_find.cu,
// after ops/match_find.py of the JAX package): a position's pass key, a
// compare-exchange of the bitonic tile sort, a key's place in a merge of two
// sorted runs, the final placing of a key with its rank, and the row step:
// a position's candidates of both passes measured against a lane's row,
// staged, then stored by a block four words at a time.  The kernels run
// these functions on the card; cpu_harness.cc builds the very same code
// with g++ and plays the kernels' schedule with it, so the tests can hold it
// against the JAX function on a machine without a GPU.
//
// The contract (JAX match_find.py:48-120), per lane of L bytes (L a power
// of two, lb = log2 L) and pass (min_pref 4, then 8):
//  * key = int32((hh << lb) mod 2^32) | pos, hh the pass's hash, or
//    1 << hash_bits where pos + min_pref > valid.  The shift wraps: at
//    lb + hash_bits >= 32 the marker lands in bucket 0, and hash bits above
//    32 - lb are lost.  Keys are unique in a lane (their low bits are pos);
//  * bucket = key >> lb, arithmetic, so buckets are signed and a real
//    bucket can be -1;
//  * slot i's candidate k (k = 1..K) is slot i - k of the lane's keys in
//    ascending signed order; before slot 0 the lane is padded with slots of
//    bucket -1, position 0 and zero bytes (JAX pads sb with -1, sp and the
//    words with 0);
//  * a candidate of the same bucket has distance p - q and length
//    min(lcp16(p, q), max(valid - p, 0)), lcp16 the equal leading bytes of
//    the 16 from p and q (0 past L, bytes past valid as they are); any
//    other has distance 0 and length 0;
//  * the best of a pass is the first of the longest (nearest first); pass
//    2's best replaces pass 1's only where it is strictly longer.
#pragma once

#include <stdint.h>

#include <cstring>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace lzt {
namespace mf {

constexpr uint32_t kFib = 2654435761u;     // JAX match_find.py FIB
constexpr uint32_t kFib2 = 2246822519u;    // FIB2
constexpr int kStageBytes = 40960;         // a chunk's staged candidate rows at most

// 16 bytes as four little-endian words.
#ifdef __CUDACC__
using word4 = uint4;
#else
struct alignas(16) word4 {
  uint32_t x, y, z, w;
};
#endif

__host__ __device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);    // 4-byte aligned
#else
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
#endif
}

// The bits [sh, sh + 32) of hi:lo, sh in [0, 32).
__host__ __device__ __forceinline__ uint32_t funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
#endif
}

__host__ __device__ __forceinline__ int ctz32(uint32_t x) {   // x != 0
#ifdef __CUDA_ARCH__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// The little-endian word of bytes p..p+3 of a row of L bytes, 0 past L.
// The row starts 4-byte aligned; two aligned loads where both lie in the
// row, byte by byte at its end.
__host__ __device__ __forceinline__ uint32_t row_word(const uint8_t* row, int L, int p) {
  const int a = p & ~3;
  if (a + 8 <= L) return funnel(load_u32(row + a), load_u32(row + a + 4), (p & 3) * 8);
  uint32_t v = 0;
  for (int j = 0; j < 4; ++j)
    if (p + j < L) v |= (uint32_t)row[p + j] << (8 * j);
  return v;
}

// Position p's sort key in pass 0 (4-byte prefixes) or 1 (8-byte).
__host__ __device__ __forceinline__ int32_t pass_key(const uint8_t* row, int L, int lb, int p,
                                                     int valid, int pass, int hash_bits) {
  const uint32_t h0 = row_word(row, L, p) * kFib;
  uint32_t h = (pass ? h0 ^ (row_word(row, L, p + 4) * kFib2) : h0) >> (32 - hash_bits);
  if (p + (pass ? 8 : 4) > valid) h = 1u << hash_bits;
  return (int32_t)((h << lb) | (uint32_t)p);
}

// The key of the padded slots before slot 0: bucket -1, position 0.
__host__ __device__ __forceinline__ int32_t pad_key(int lb) {
  return (int32_t)(0xFFFFFFFFu << lb);
}

// Compare-exchange m (m < n / 2) of the bitonic stage (k, j) over n keys:
// the pair (i, i + j), i with bit j clear, in ascending order where
// i & k == 0 and descending elsewhere; after the last stage (k = n) the
// keys ascend.  The pairs of a stage are disjoint.
__host__ __device__ __forceinline__ void bitonic_pair(int32_t* keys, int k, int j, int m) {
  const int i = ((m & ~(j - 1)) << 1) | (m & (j - 1));
  const int32_t a = keys[i], b = keys[i + j];
  if ((a > b) == ((i & k) == 0)) {     // keys are unique: a != b
    keys[i] = b;
    keys[i + j] = a;
  }
}

// Where key i of a lane goes when its sorted runs of w keys are merged in
// pairs into runs of 2w: its index in its own run plus the count of keys
// of the other run below it (a binary search; keys are unique).
__host__ __device__ __forceinline__ int merge_dest(const int32_t* keys, int w, int i) {
  const int base = i & ~(2 * w - 1);
  const int32_t* other = keys + base + ((i & w) ? 0 : w);
  const int32_t x = keys[i];
  int lo = 0, hi = w;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (other[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return base + (i & (w - 1)) + lo;
}

// The launch that puts a lane's keys in their final order puts `key` at
// slot s of `sorted` and records the inverse permutation: rank[pos] = s.
__host__ __device__ __forceinline__ void place_key(int32_t* sorted, int32_t* rank, int L, int s,
                                                   int32_t key) {
  sorted[s] = key;
  rank[key & (L - 1)] = s;
}

// Equal leading bytes of two 16-byte strings whose words differ by d0..d3.
__host__ __device__ __forceinline__ int first_diff(uint32_t d0, uint32_t d1, uint32_t d2,
                                                   uint32_t d3) {
  return d0   ? ctz32(d0) >> 3
         : d1 ? 4 + (ctz32(d1) >> 3)
         : d2 ? 8 + (ctz32(d2) >> 3)
         : d3 ? 12 + (ctz32(d3) >> 3)
              : 16;
}

// A lane's row as the row step reads it: words(x) is bytes x..x+15 as
// four little-endian words, 0 past L.  StagedRow reads a copy of the row
// in shared memory, its words followed by 4 zero words (staged_row_words,
// stage_row_word), so five aligned loads and funnels give any 16 bytes;
// GlobalRow reads the row in device memory, for a lane longer than shared
// memory holds.
struct StagedRow {
  const uint32_t* w;
  __host__ __device__ __forceinline__ word4 words(int x) const {
    const uint32_t* a = w + (x >> 2);
    const int sh = (x & 3) * 8;
    return word4{funnel(a[0], a[1], sh), funnel(a[1], a[2], sh), funnel(a[2], a[3], sh),
                 funnel(a[3], a[4], sh)};
  }
};

struct GlobalRow {
  const uint8_t* row;
  int L;
  __host__ __device__ __forceinline__ word4 words(int x) const {
    return word4{row_word(row, L, x), row_word(row, L, x + 4), row_word(row, L, x + 8),
                 row_word(row, L, x + 12)};
  }
};

// Equal leading bytes of the 16 at x of the row and the 16 in w.
template <class Row>
__host__ __device__ __forceinline__ int len16(const Row& row, int x, const word4& w) {
  const word4 v = row.words(x);
  return first_diff(v.x ^ w.x, v.y ^ w.y, v.z ^ w.z, v.w ^ w.w);
}

// Words of a row's staged copy: every word at x < L + 12 lies in it.
__host__ __device__ __forceinline__ int staged_row_words(int L) { return (L + 3) / 4 + 4; }

// Word i (i < staged_row_words(L)) of a row's staged copy.
__host__ __device__ __forceinline__ void stage_row_word(const uint8_t* row, int L, uint32_t* out,
                                                        int i) {
  out[i] = 4 * i < L ? row_word(row, L, 4 * i) : 0;
}

// Equal leading bytes of w and 16 zero bytes (a padded slot's).
__host__ __device__ __forceinline__ int zero_len(const word4& w) {
  return first_diff(w.x, w.y, w.z, w.w);
}

// A best candidate so far: its length (-1: none yet), its k and distance.
struct Best {
  int len, k, dist;
};

// Threads a position's candidates are dealt to: thread g of its group
// takes k = g + 1, g + 1 + kGroup, ...
constexpr int kGroup = 2;

// b becomes o where o is better: longer, or as long with a smaller k (the
// first of the longest over the whole pass).  k differs between the
// threads of a group, so the best of a group is one whatever the order.
__host__ __device__ __forceinline__ void keep_better(Best& b, const Best& o) {
  if (o.len > b.len || (o.len == b.len && o.k < b.k)) b = o;
}

// Thread g's share of one pass of position p (16 bytes w, avail = max(valid
// - p, 0)), whose key sits at slot s of the pass's sorted keys: its
// candidates k (k = 1..K, k - 1 = g mod kGroup) are slots s - k (a padded
// slot below 0).  A candidate of p's bucket has distance p - q and length
// min(its equal leading bytes with w, avail); any other, distance 0 and
// length 0.  Each distance goes to out[k - 1]; returns the first of the
// longest ({-1, K + 1, 0} where the thread has no candidate).  Four
// candidates at a time: their keys loaded, then their bytes, then their
// lengths met in ascending k.
template <class Row>
__host__ __device__ __forceinline__ Best pass_part(const Row& row, const int32_t* sorted, int s,
                                                   int K, int g, int lb, int L, int p, int avail,
                                                   const word4& w, int32_t* out) {
  const int32_t bucket = sorted[s] >> lb;
  Best b = {-1, K + 1, 0};
  for (int k0 = g + 1; k0 <= K; k0 += 4 * kGroup) {
    int32_t q[4];
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * kGroup;
      q[j] = k <= K && s - k >= 0 ? sorted[s - k] : pad_key(lb);
    }
    int len[4];
    for (int j = 0; j < 4; ++j) {
      const bool pad = s - (k0 + j * kGroup) < 0;
      len[j] = (q[j] >> lb) != bucket ? 0 : pad ? zero_len(w) : len16(row, q[j] & (L - 1), w);
    }
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * kGroup;
      if (k > K) break;
      const bool same = (q[j] >> lb) == bucket;
      const int dist = same ? p - (q[j] & (L - 1)) : 0;
      const int n = len[j] < avail ? len[j] : avail;
      out[k - 1] = dist;
      if (n > b.len) b = Best{n, k, dist};
    }
  }
  return b;
}

// A row block's geometry, in powers of two: `chunk` positions measured
// between two stores (a group of kGroup of its `threads` each, as many
// rows of ktot distances as the staging holds, at most L) and a run of
// `run` positions a block (at most run_max and L, at least a chunk).
__host__ __device__ __forceinline__ void row_geometry(int threads, int run_max, int L, int ktot,
                                                      int* chunk, int* run) {
  int c = 1;
  while (2 * c * kGroup <= threads && 2 * c <= L && 2 * c * ktot * 4 <= kStageBytes) c *= 2;
  int r = run_max < L ? run_max : L;
  *chunk = c;
  *run = r > c ? r : c;
}

// A pass's sorted keys and ranks of the lane whose keys start at `at`, in
// scratch laid out [pass][S][L] (S * L = SL).
struct PassKeys {
  const int32_t* sorted;
  const int32_t* rank;
};

__host__ __device__ __forceinline__ PassKeys pass_keys(const int32_t* sorted, const int32_t* rank,
                                                       long long SL, long long at, int pass) {
  return PassKeys{sorted + pass * SL + at, rank + pass * SL + at};
}

// Thread t of a row block on the chunk of positions c0.. of a lane (t <
// chunk * kGroup): thread g = t mod kGroup of position i = t / kGroup,
// p = c0 + i, found in each pass by its rank.  Its candidates' distances
// go to row i of the staging (pass 1's K1, then pass 2's K2; K2 = 0: no
// pass 2); its best of each pass to b1 and b2.
template <class Row>
__host__ __device__ __forceinline__ void chunk_part(const Row& row, const PassKeys& k1,
                                                    const PassKeys& k2, int K1, int K2, int lb,
                                                    int L, int valid, int c0, int t,
                                                    int32_t* stage, Best& b1, Best& b2) {
  const int i = t / kGroup, g = t % kGroup, p = c0 + i;
  const word4 w = row.words(p);
  const int avail = valid - p > 0 ? valid - p : 0;
  int32_t* out = stage + i * (K1 + K2);
  b1 = pass_part(row, k1.sorted, k1.rank[p], K1, g, lb, L, p, avail, w, out);
  if (K2 > 0) b2 = pass_part(row, k2.sorted, k2.rank[p], K2, g, lb, L, p, avail, w, out + K1);
}

// A position's best length and distance from its groups' bests of each
// pass: pass 1's, replaced by pass 2's where it is strictly longer.
__host__ __device__ __forceinline__ void best_of_passes(const Best& b1, const Best& b2, int K2,
                                                        int32_t* best_len, int32_t* best_dist) {
  const Best& b = K2 > 0 && b2.len > b1.len ? b2 : b1;
  *best_len = b.len;
  *best_dist = b.dist;
}

// Four words to a 16-byte aligned out[0..3]: one streaming vector store on
// the card (the candidates are written once and read by the copy to the
// host, so they need not stay in L2).
__host__ __device__ __forceinline__ void store4(int32_t* out, int32_t a, int32_t b, int32_t c,
                                                int32_t d) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<int4*>(out), make_int4(a, b, c, d));
#else
  out[0] = a;
  out[1] = b;
  out[2] = c;
  out[3] = d;
#endif
}

// Thread t of T's share of storing n staged words to dst[0..n) (dst 4-byte
// aligned): the words before dst's first 16-byte boundary and after the
// last whole group of four one at a time, every group between by one
// 16-byte store (from one 16-byte load of the staging where it is
// aligned), group g by thread g mod T, so a warp writes 512 contiguous
// bytes.
__host__ __device__ __forceinline__ void store_staged(const int32_t* stage, int32_t* dst, int n,
                                                      int t, int T) {
  int head = (int)((16 - ((uintptr_t)dst & 15)) & 15) >> 2;
  if (head > n) head = n;
  const int groups = (n - head) >> 2;
  for (int i = t; i < head; i += T) dst[i] = stage[i];
  for (int g = t; g < groups; g += T) {
    const int i = head + 4 * g;
#ifdef __CUDA_ARCH__
    if (!((uintptr_t)(stage + i) & 15)) {
      __stcs(reinterpret_cast<int4*>(dst + i), *reinterpret_cast<const int4*>(stage + i));
      continue;
    }
#endif
    store4(dst + i, stage[i], stage[i + 1], stage[i + 2], stage[i + 3]);
  }
  for (int i = head + 4 * groups + t; i < n; i += T) dst[i] = stage[i];
}

}  // namespace mf
}  // namespace lzt
