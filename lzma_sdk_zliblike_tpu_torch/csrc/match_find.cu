// X2 on Hopper: the sorted-bucket match finder, per position the K nearest
// earlier positions of its hash bucket in two passes (4-byte, then 8-byte
// prefixes), their distances, and the best 16-byte-capped length with its
// distance.
//
// Replaces lzma_sdk_zliblike_tpu/ops/match_find.py::_find (:48, plain XLA
// under jax.jit, no Pallas; find_matches :123).  The JAX function sorts
// each lane's keys with four payload words, measures every candidate as a
// shifted copy of the sorted lane, and sorts back by position.  Here a
// pass is three kinds of launch over a lane's L unique int32 keys (the
// contract and the per-thread pieces are in match_find_lane.cuh):
//
//  * tile_sort_kernel: a block per tile of kSortTile keys of a lane (the
//    whole lane when it is shorter) computes its positions' keys from the
//    row and sorts them ascending with a bitonic network in shared memory
//    (32 KiB); one barrier a stage;
//  * merge_kernel: a thread per key puts it at its place in the merge of
//    its run of w keys with the neighbouring run (its index plus a binary
//    search of the other run), from one scratch buffer into the other; w
//    doubles from the tile to L / 2 (3 rounds at 64 KiB).  The two buffers
//    (2 x 8 MiB at 32 x 64 KiB) stay in the 50 MB L2;
//  * slot_kernel: a thread per sorted slot, kThreads slots a block.  The
//    block stages its slots and the K before them (keys and the 16 bytes at
//    each position; padded slots before slot 0) in shared memory, so each
//    slot's bytes are read once; each thread then measures its K
//    candidates and writes their distances straight to
//    cands[lane, p, off + k - 1], the [S, L, K] layout the host coder
//    reads, four at a time by a 16-byte streaming store where the row is
//    aligned (every store at 24 + 12).  That scatter by the sorted
//    position replaces the JAX sort back.  Pass 1 writes the best length
//    and distance at p; pass 2 replaces them where its best is strictly
//    longer.
//
// What bounds it on this card: the work reads the rows (L bytes a lane)
// and writes (K + 2) int32 a position: 320,864,384 B for 32 x 64 KiB at
// 24 + 12, 0.0958 ms at 3.35 TB/s.  The design moves more: the keys (4
// bytes a position) through shared memory and, per merge round, through
// L2 with a binary search of dependent L2 reads per key; and the slot
// step's stores are scattered by position, each warp store touching 32
// rows, so the L2 takes many partial-sector writes for each full one the
// bound counts.  The slot step takes most of the time (PERF.md, X2).
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/match_find.py calls lzt_match_find through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_find_lane.cuh"

using namespace lzt::mf;

namespace {

constexpr int kSortTile = 8192;       // keys a tile sorted in shared memory
constexpr int kSortThreads = 1024;    // threads of a tile block
constexpr int kThreads = 256;         // threads of a merge or slot block
constexpr int kMaxCand = 1024;        // candidates a pass at most

__global__ void __launch_bounds__(kSortThreads)
    tile_sort_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid, int L,
                     int lb, int tile, int pass, int hash_bits, int32_t* __restrict__ keys) {
  __shared__ int32_t s[kSortTile];
  const int lane = blockIdx.y, base = blockIdx.x * tile, t = threadIdx.x;
  const uint8_t* row = data + (long long)lane * L;
  const int v = valid[lane];
  for (int j = t; j < tile; j += blockDim.x)
    s[j] = pass_key(row, L, lb, base + j, v, pass, hash_bits);
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int m = t; m < tile / 2; m += blockDim.x) bitonic_pair(s, k, j, m);
      __syncthreads();
    }
  int32_t* out = keys + (long long)lane * L + base;
  for (int j = t; j < tile; j += blockDim.x) out[j] = s[j];
}

__global__ void __launch_bounds__(kThreads)
    merge_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst, int L, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = (long long)blockIdx.y * L;
  dst[row + merge_dest(src + row, w, i)] = src[row + i];
}

__global__ void __launch_bounds__(kThreads)
    slot_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
                const int32_t* __restrict__ sorted, int L, int lb, int K, int off, int ktot,
                int first_pass, int32_t* __restrict__ best_len, int32_t* __restrict__ best_dist,
                int32_t* __restrict__ cands) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int B = blockDim.x, lane = blockIdx.y, i0 = blockIdx.x * B, t = threadIdx.x;
  word4* words = reinterpret_cast<word4*>(smem);              // B + K
  int32_t* keys = reinterpret_cast<int32_t*>(words + B + K);  // B + K
  const uint8_t* row = data + (long long)lane * L;
  const int32_t* sk = sorted + (long long)lane * L;
  for (int e = t; e < B + K; e += B) stage_slot(row, sk, L, lb, i0 - K + e, keys + e, words + e);
  __syncthreads();
  const int e = K + t;
  const long long at = (long long)lane * L + (keys[e] & (L - 1));
  int32_t bl, bd;
  slot_step(keys + e, words + e, K, lb, L, valid[lane], cands + at * ktot + off, &bl, &bd);
  if (first_pass || bl > best_len[at]) {
    best_len[at] = bl;
    best_dist[at] = bd;
  }
}

int log2_exact(long long x) {
  int r = 0;
  while ((1ll << r) < x) ++r;
  return (1ll << r) == x ? r : -1;
}

}  // namespace

// X2 over S lanes of L bytes (L a power of two, data 4-byte aligned) with
// valid lengths `valid` (int32 [S]) on `stream`, without synchronising:
// pass 1 (n_cand 4-byte-bucket candidates) and, when n_cand8 > 0, pass 2
// (n_cand8 8-byte-bucket candidates).  Writes best_len and best_dist
// (int32 [S, L]) and cands (int32 [S, L, n_cand + n_cand8]); keys_a and
// keys_b are scratch of S * L int32 each.  Returns the CUDA error code
// (0 = launched).
extern "C" int lzt_match_find(const void* data, const void* valid, int S, int L, int n_cand,
                              int n_cand8, int hash_bits, void* keys_a, void* keys_b,
                              void* best_len, void* best_dist, void* cands, void* stream) {
  const int lb = log2_exact(L);
  if (S < 1 || S > 65535 || lb < 0 || lb > 30 || n_cand < 1 || n_cand > kMaxCand ||
      n_cand8 < 0 || n_cand8 > kMaxCand || hash_bits < 1 || hash_bits > 31 ||
      ((uintptr_t)data & 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ktot = n_cand + n_cand8;
  const int tile = L < kSortTile ? L : kSortTile;
  const int sort_threads = tile / 2 < kSortThreads ? (tile / 2 > 0 ? tile / 2 : 1) : kSortThreads;
  const int B = L < kThreads ? L : kThreads;
  for (int pass = 0; pass < (n_cand8 ? 2 : 1); ++pass) {
    const int K = pass ? n_cand8 : n_cand;
    int32_t* src = (int32_t*)keys_a;
    int32_t* dst = (int32_t*)keys_b;
    tile_sort_kernel<<<dim3(L / tile, S), sort_threads, 0, st>>>(
        (const uint8_t*)data, (const int32_t*)valid, L, lb, tile, pass, hash_bits, src);
    cudaError_t e = cudaGetLastError();
    for (int w = tile; e == cudaSuccess && w < L; w <<= 1) {
      merge_kernel<<<dim3(L / B, S), B, 0, st>>>(src, dst, L, w);
      e = cudaGetLastError();
      int32_t* tmp = src;
      src = dst;
      dst = tmp;
    }
    if (e != cudaSuccess) return (int)e;
    const size_t smem = (size_t)(B + K) * (sizeof(word4) + sizeof(int32_t));
    slot_kernel<<<dim3(L / B, S), B, smem, st>>>(
        (const uint8_t*)data, (const int32_t*)valid, src, L, lb, K, pass ? n_cand : 0, ktot,
        pass == 0, (int32_t*)best_len, (int32_t*)best_dist, (int32_t*)cands);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
