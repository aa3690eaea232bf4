// X2 on Hopper: the sorted-bucket match finder, per position the K nearest
// earlier positions of its hash bucket in two passes (4-byte, then 8-byte
// prefixes), their distances, and the best 16-byte-capped length with its
// distance.
//
// Replaces lzma_sdk_zliblike_tpu/ops/match_find.py::_find (:48, plain XLA
// under jax.jit, no Pallas; find_matches :123).  The JAX function sorts
// each lane's keys with four payload words, measures every candidate as a
// shifted copy of the sorted lane, and sorts back by position.  Here each
// pass sorts a lane's L unique int32 keys and records where each position
// went, and one launch then writes every output row in position order (the
// contract and the per-thread pieces are in match_find_lane.cuh):
//
//  * tile_sort_kernel: a block per tile of kSortTile keys of a lane (the
//    whole lane when it is shorter) computes its positions' keys from the
//    row and sorts them ascending with a bitonic network in shared memory
//    (32 KiB); one barrier a stage;
//  * merge_kernel: a thread per key puts it at its place in the merge of
//    its run of w keys with the neighbouring run (its index plus a binary
//    search of the other run), from one scratch buffer into the other; w
//    doubles from the tile to L / 2 (3 rounds at 64 KiB).
//    The launch that puts the keys in their final order (the last round,
//    or the tile sort where one tile holds the lane) also writes the
//    inverse permutation, rank[pos] = slot.  Both passes' sorted keys and
//    ranks stay for the row launch (4 x 8 MiB at 32 x 64 KiB, in the 50 MB
//    L2, with the merge rounds' other buffer);
//  * row_kernel: a block of kRowThreads threads owns a run of kRun
//    positions of a lane.  It copies the lane's row into shared memory
//    once (its words and 16 zero bytes: 64 KiB fits, two blocks an SM); a
//    lane longer than shared memory holds reads the row through L2 instead
//    (the template parameter).  Then a chunk of positions at a time, a
//    group of kGroup threads a position: each finds the position's slot s
//    in each pass by its rank, loads its share of the K keys before s (the
//    group's loads are contiguous; below slot 0 the padded slots), four at
//    a time, measures each candidate of the position's bucket against the
//    position's own 16 bytes from the row copy, and writes the distances
//    to the chunk's rows in shared memory; the group's bests meet by warp
//    shuffles.  The block then writes the chunk's rows, best lengths and
//    best distances out, contiguous in position order, by 16-byte
//    streaming stores, a warp 512 contiguous bytes at a time.  Every
//    output word is written once, and nothing is read back from the
//    outputs.
//
// What bounds it on this card: the work reads the rows (L bytes a lane)
// and writes (K + 2) int32 a position: 320,864,384 B for 32 x 64 KiB at
// 24 + 12, 0.0958 ms at 3.35 TB/s.  The output rows are the one stream to
// device memory now, and the stores are a small part of the row launch;
// what is left above the bound is the sorts (the tile sort's barriers and
// each merge round's binary search of dependent L2 reads per key, about
// half the time) and, in the row launch, the reads of K + 1 keys per
// position and pass from L2 and the candidates' 16 bytes from shared
// memory at random addresses (PERF.md, X2).
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
constexpr int kThreads = 256;         // threads of a merge block
constexpr int kRowThreads = 512;      // threads of a row block
constexpr int kRun = 2048;            // positions a row block owns
constexpr int kMaxCand = 1024;        // candidates a pass at most
constexpr int kMaxShared = 232448;    // dynamic shared memory a block can have

// Sorts tile blockIdx.x of lane blockIdx.y into keys; where one tile holds
// the lane (rank != nullptr) the keys are final and their ranks recorded.
__global__ void __launch_bounds__(kSortThreads)
    tile_sort_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid, int L,
                     int lb, int tile, int pass, int hash_bits, int32_t* __restrict__ keys,
                     int32_t* __restrict__ rank) {
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
  int32_t* out = keys + (long long)lane * L;
  if (rank) {
    for (int j = t; j < tile; j += blockDim.x)
      place_key(out, rank + (long long)lane * L, L, base + j, s[j]);
  } else {
    for (int j = t; j < tile; j += blockDim.x) out[base + j] = s[j];
  }
}

// One merge round of runs of w keys; the last (rank != nullptr) records
// the ranks.
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                 int32_t* __restrict__ rank, int L, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = (long long)blockIdx.y * L;
  const int32_t x = src[row + i];
  const int at = merge_dest(src + row, w, i);
  if (rank) place_key(dst + row, rank + row, L, at, x);
  else dst[row + at] = x;
}

// b becomes the best of b and the other threads of its group.
__device__ __forceinline__ void group_best(Best& b) {
  for (int off = 1; off < kGroup; off <<= 1) {
    const Best o = {__shfl_xor_sync(0xffffffffu, b.len, off),
                    __shfl_xor_sync(0xffffffffu, b.k, off),
                    __shfl_xor_sync(0xffffffffu, b.dist, off)};
    keep_better(b, o);
  }
}

// The rows of positions [blockIdx.x * run, + run) of lane blockIdx.y, both
// passes, `chunk` positions between two stores, kGroup threads a position.
// Shared memory: the staging (chunk x ktot distances, chunk best lengths,
// chunk best distances), then with kStaged the row's staged copy.
template <bool kStaged>
__global__ void __launch_bounds__(kRowThreads, 2)
    row_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
               const int32_t* __restrict__ sorted, const int32_t* __restrict__ rank,
               long long pass_stride, int L, int lb, int K1, int K2, int run, int chunk,
               int32_t* __restrict__ best_len, int32_t* __restrict__ best_dist,
               int32_t* __restrict__ cands) {
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = blockIdx.y, r0 = blockIdx.x * run, t = threadIdx.x, T = blockDim.x;
  const int ktot = K1 + K2;
  int32_t* stage = smem;
  int32_t* sbl = stage + chunk * ktot;
  int32_t* sbd = sbl + chunk;
  const long long at = (long long)lane * L;
  const uint8_t* src = data + at;
  const PassKeys k1 = pass_keys(sorted, rank, pass_stride, at, 0);
  const PassKeys k2 = pass_keys(sorted, rank, pass_stride, at, 1);
  const int v = valid[lane];
  const bool active = t < chunk * kGroup;     // whole groups, whole warps but one
  uint32_t* words = reinterpret_cast<uint32_t*>(sbd + chunk);
  if constexpr (kStaged) {
    for (int i = t; i < staged_row_words(L); i += T) stage_row_word(src, L, words, i);
    __syncthreads();
  }
  for (int c0 = r0; c0 < r0 + run; c0 += chunk) {
    Best b1 = {-1, 0, 0}, b2 = {-1, 0, 0};
    if (active) {
      if constexpr (kStaged)
        chunk_part(StagedRow{words}, k1, k2, K1, K2, lb, L, v, c0, t, stage, b1, b2);
      else
        chunk_part(GlobalRow{src, L}, k1, k2, K1, K2, lb, L, v, c0, t, stage, b1, b2);
    }
    group_best(b1);
    group_best(b2);
    if (active && t % kGroup == 0)
      best_of_passes(b1, b2, K2, sbl + t / kGroup, sbd + t / kGroup);
    __syncthreads();
    store_staged(stage, cands + (at + c0) * ktot, chunk * ktot, t, T);
    store_staged(sbl, best_len + at + c0, chunk, t, T);
    store_staged(sbd, best_dist + at + c0, chunk, t, T);
    __syncthreads();
  }
}

// The row launch at L and ktot candidates: its chunk and run, whether the
// row is staged in shared memory (where it fits with the staging), and
// its dynamic shared memory.
size_t row_launch(int L, int ktot, int* chunk, int* run, bool* fits) {
  row_geometry(kRowThreads, kRun, L, ktot, chunk, run);
  const size_t stage = (size_t)*chunk * (ktot + 2) * sizeof(int32_t);
  const size_t staged = stage + (size_t)staged_row_words(L) * sizeof(uint32_t);
  *fits = staged <= (size_t)kMaxShared;
  return *fits ? staged : stage;
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
// (int32 [S, L]) and cands (int32 [S, L, n_cand + n_cand8]).  Scratch:
// keys_a holds 2 * S * L int32 (each pass's sorted keys), keys_b 3 * S * L
// (each pass's ranks, then the merge rounds' other buffer).  Returns the
// CUDA error code (0 = launched).
extern "C" int lzt_match_find(const void* data, const void* valid, int S, int L, int n_cand,
                              int n_cand8, int hash_bits, void* keys_a, void* keys_b,
                              void* best_len, void* best_dist, void* cands, void* stream) {
  const int lb = log2_exact(L);
  if (S < 1 || S > 65535 || lb < 0 || lb > 30 || n_cand < 1 || n_cand > kMaxCand ||
      n_cand8 < 0 || n_cand8 > kMaxCand || hash_bits < 1 || hash_bits > 31 ||
      ((uintptr_t)data & 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long SL = (long long)S * L;
  int32_t* sorted = (int32_t*)keys_a;
  int32_t* rank = (int32_t*)keys_b;
  int32_t* spare = rank + 2 * SL;
  const int tile = L < kSortTile ? L : kSortTile;
  const int sort_threads = tile / 2 < kSortThreads ? (tile / 2 > 0 ? tile / 2 : 1) : kSortThreads;
  const int B = L < kThreads ? L : kThreads;
  const int rounds = lb - log2_exact(tile);
  for (int pass = 0; pass < (n_cand8 ? 2 : 1); ++pass) {
    // the rounds alternate between the pass's sorted keys and the spare,
    // ending in the sorted keys
    int32_t* src = rounds & 1 ? spare : sorted + pass * SL;
    int32_t* dst = rounds & 1 ? sorted + pass * SL : spare;
    tile_sort_kernel<<<dim3(L / tile, S), sort_threads, 0, st>>>(
        (const uint8_t*)data, (const int32_t*)valid, L, lb, tile, pass, hash_bits, src,
        rounds ? nullptr : rank + pass * SL);
    cudaError_t e = cudaGetLastError();
    for (int w = tile; e == cudaSuccess && w < L; w <<= 1) {
      merge_kernel<<<dim3(L / B, S), B, 0, st>>>(src, dst, 2 * w == L ? rank + pass * SL : nullptr,
                                                 L, w);
      e = cudaGetLastError();
      int32_t* tmp = src;
      src = dst;
      dst = tmp;
    }
    if (e != cudaSuccess) return (int)e;
  }
  int chunk, run;
  bool fits;
  const size_t smem = row_launch(L, n_cand + n_cand8, &chunk, &run, &fits);
  auto* kernel = fits ? row_kernel<true> : row_kernel<false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(L / run, S), kRowThreads, smem, st>>>(
      (const uint8_t*)data, (const int32_t*)valid, sorted, rank, SL, L, lb, n_cand, n_cand8, run,
      chunk, (int32_t*)best_len, (int32_t*)best_dist, (int32_t*)cands);
  return (int)cudaGetLastError();
}

// The row launch's dynamic shared memory for lanes of L bytes at n_cand +
// n_cand8 candidates (the row staged where this exceeds the staging).
extern "C" long long lzt_match_find_shared(int L, int n_cand, int n_cand8) {
  int chunk, run;
  bool fits;
  return (long long)row_launch(L, n_cand + n_cand8, &chunk, &run, &fits);
}
