// Per-thread pieces of X2, the sorted-bucket match finder (match_find.cu,
// after ops/match_find.py of the JAX package): a position's pass key, a
// compare-exchange of the bitonic tile sort, a key's place in a merge of two
// sorted runs, a slot's 16 bytes, and the step of one sorted slot over its
// K predecessors.  The kernels run these functions on the card;
// cpu_harness.cc builds the very same code with g++ and plays the kernels'
// schedule with it, so the tests can hold it against the JAX function on a
// machine without a GPU.
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

__host__ __device__ __forceinline__ word4 row_words(const uint8_t* row, int L, int p) {
  word4 w;
  w.x = row_word(row, L, p);
  w.y = row_word(row, L, p + 4);
  w.z = row_word(row, L, p + 8);
  w.w = row_word(row, L, p + 12);
  return w;
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

// Slot s of a lane as the slot step reads it: its key and the 16 bytes at
// its position; a padded slot (s < 0) has pad_key and zero bytes.
__host__ __device__ __forceinline__ void stage_slot(const uint8_t* row, const int32_t* sorted,
                                                    int L, int lb, int s, int32_t* key,
                                                    word4* words) {
  if (s < 0) {
    *key = pad_key(lb);
    words->x = words->y = words->z = words->w = 0;
    return;
  }
  *key = sorted[s];
  *words = row_words(row, L, *key & (L - 1));
}

// Equal leading bytes of two 16-byte strings.
__host__ __device__ __forceinline__ int lcp16(const word4& a, const word4& b) {
  const uint32_t x[4] = {a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w};
  for (int j = 0; j < 4; ++j)
    if (x[j]) return 4 * j + (ctz32(x[j]) >> 3);
  return 16;
}

// Four candidates' distances to a 16-byte aligned out[0..3]: one streaming
// vector store on the card (the candidates are written once and read by
// the copy to the host, so they need not stay in L2).
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

// Candidate k of a slot of position p and bucket `bucket` whose 16 bytes
// are w: its distance (0 unless it shares the bucket); its length raises
// the running best (bl, bd) only where it is longer.
__host__ __device__ __forceinline__ int32_t candidate(const int32_t* keys, const word4* words,
                                                      int k, int lb, int L, int p, int32_t bucket,
                                                      int avail, const word4& w, int& bl,
                                                      int& bd) {
  const int32_t q = keys[-k];
  if ((q >> lb) != bucket) {
    if (bl < 0) bl = bd = 0;
    return 0;
  }
  const int dist = p - (q & (L - 1));
  int len = lcp16(w, words[-k]);
  if (len > avail) len = avail;
  if (len > bl) {
    bl = len;
    bd = dist;
  }
  return dist;
}

// The step of one sorted slot: keys[0] and words[0] are the slot's,
// keys[-k] and words[-k] its predecessor k (k = 1..K).  Candidate k's
// distance goes to out[k - 1], four at a time from where out is 16-byte
// aligned; the pass's best length and its distance (the first of the
// longest) to *best_len and *best_dist.
__host__ __device__ __forceinline__ void slot_step(const int32_t* keys, const word4* words, int K,
                                                   int lb, int L, int valid, int32_t* out,
                                                   int32_t* best_len, int32_t* best_dist) {
  const int32_t key = keys[0];
  const int p = key & (L - 1);
  const int32_t bucket = key >> lb;
  const int avail = valid - p > 0 ? valid - p : 0;
  const word4 w = words[0];
  int bl = -1, bd = 0, k = 1;
  for (; k <= K && ((uintptr_t)(out + k - 1) & 15); ++k)
    out[k - 1] = candidate(keys, words, k, lb, L, p, bucket, avail, w, bl, bd);
  for (; k + 3 <= K; k += 4) {
    const int32_t d0 = candidate(keys, words, k, lb, L, p, bucket, avail, w, bl, bd);
    const int32_t d1 = candidate(keys, words, k + 1, lb, L, p, bucket, avail, w, bl, bd);
    const int32_t d2 = candidate(keys, words, k + 2, lb, L, p, bucket, avail, w, bl, bd);
    const int32_t d3 = candidate(keys, words, k + 3, lb, L, p, bucket, avail, w, bl, bd);
    store4(out + k - 1, d0, d1, d2, d3);
  }
  for (; k <= K; ++k)
    out[k - 1] = candidate(keys, words, k, lb, L, p, bucket, avail, w, bl, bd);
  *best_len = bl;
  *best_dist = bd;
}

}  // namespace mf
}  // namespace lzt
