// Kernel P2 on Hopper: the compact-layout bit-call microbenchmark.
//
// Replaces tools/compact_probe.py::kern_bcast / kern_mxu / kern_tpose /
// kern_submask (the Pallas probes, launched by run).  What each computes is
// unchanged and bit-identical: `iters` iterations of 28 calls of the shared
// signed-int32 ALU `_alu` (probe_lane.cuh: compact_alu), each call reading
// and updating one probability-table slot, in four layouts:
//   bcast    64 rows x 128 lanes of broadcast state, a table per row; one
//            block per row, one thread per lane, the row's table in shared
//            memory, a barrier between the gathers and the stores
//   mxu      128 streams of compact state and a 128 x 128 table (one row
//            per stream); the slot index goes from the compact to the
//            stream-per-row layout, the gathered probability back, and the
//            new probability out again, each as a product with a 128 x 128
//            one-hot f32 matrix held in shared memory (an f32 FMA loop per
//            thread; exact, every value is below 2048)
//   tpose    the same with the relayouts as transposes: on the card a
//            thread holds its stream in both layouts, so they cost nothing
//   submask  128 streams, a 192-slot table per stream; the read is a masked
//            sum over all 192 slots and the update a masked select over all
//            of them, as in the TPU probe (no gather at all)
// mxu, tpose and submask run one block of 128 threads, thread l = stream l,
// with the tables slot-major (stream fastest) in dynamic shared memory:
// 64 KB (+ 64 KB of one-hot matrix for mxu) and 96 KB.
//
// What bounds it on this card: integer operations (f32 FMAs too for mxu),
// and more, each call's dependent chain.  tools/compact_probe.py's bound
// counts the operations of each call from this source over 132 SMs x 64
// INT32 (128 FP32) lanes per clock.  This simple design does nothing about
// the chain: it is what the probe measures.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; tools/compact_probe.py calls lzt_compact_probe through
// ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_lane.cuh"

using namespace lzt::probe;

namespace {

// kernel codes; tools/compact_probe.py's KERNELS holds the same order
enum Kind { kBcast = 0, kMxu, kTpose, kSubmask };

constexpr int kBcastRows = 64;
constexpr int kSubSlots = 192;
constexpr int32_t kRng0 = 0x7FFFFF00;

__global__ void __launch_bounds__(kLanes) bcast_kernel(int32_t seed, int32_t* __restrict__ out,
                                                       int iters) {
  __shared__ int32_t tbl[kLanes];
  const int l = threadIdx.x, r = blockIdx.x;
  tbl[l] = kProbInit;
  __syncthreads();
  int32_t rng = kRng0, code = compact_code0(r, seed), st = 3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int b = 0; b < kCalls; ++b) {
      const int32_t idx = compact_slot(st, code);
      const int32_t prob = tbl[idx];
      const int32_t newp = compact_alu(rng, code, st, prob);
      __syncthreads();                   // every gather before any store
      if (l == idx) tbl[l] = newp;
      __syncthreads();                   // every store before the next gather
    }
  }
  out[r * kLanes + l] = wrap_add(wrap_add(wrap_add(rng, code), st), tbl[l]);
}

// mxu's relayout on thread l: entry l of the product of the one-hot matrix
// with the vector that the block's threads put in `vec` (one entry each).
// The matrix is symmetric, so entry (j, l) is row l's j-th; reading it so
// puts neighbouring threads on neighbouring banks.
__device__ __forceinline__ int32_t onehot_product(const float* eye, float* vec, int l,
                                                  int32_t mine) {
  vec[l] = (float)mine;
  __syncthreads();
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < kLanes; ++j) acc = fmaf(eye[j * kLanes + l], vec[j], acc);
  __syncthreads();                       // every read of vec before the next write
  return (int32_t)acc;
}

// mxu (kMxu) and tpose: thread l is stream l; its table row is tbl[j][l].
template <bool kMxuLayout>
__global__ void __launch_bounds__(kLanes) compact_kernel(int32_t seed,
                                                         int32_t* __restrict__ out, int iters) {
  extern __shared__ int32_t smem[];
  int32_t* tbl = smem;                                    // [128 slots][128 streams]
  float* eye = (float*)(smem + kLanes * kLanes);          // [128][128] one-hot (mxu)
  float* vec = eye + kLanes * kLanes;                     // [128] (mxu)
  const int l = threadIdx.x;
  for (int j = 0; j < kLanes; ++j) tbl[j * kLanes + l] = kProbInit;
  if (kMxuLayout)
    for (int j = 0; j < kLanes; ++j) eye[j * kLanes + l] = j == l ? 1.f : 0.f;
  __syncthreads();
  int32_t rng = kRng0, code = compact_code0(l, seed), st = 3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int b = 0; b < kCalls; ++b) {
      int32_t idx = compact_slot(st, code);
      if (kMxuLayout) idx = onehot_product(eye, vec, l, idx);      // compact -> rows
      int32_t prob = tbl[idx * kLanes + l];
      if (kMxuLayout) prob = onehot_product(eye, vec, l, prob);    // rows -> compact
      int32_t newp = compact_alu(rng, code, st, prob);
      if (kMxuLayout) newp = onehot_product(eye, vec, l, newp);    // compact -> rows
      tbl[idx * kLanes + l] = newp;
    }
  }
  __syncthreads();
  int32_t col = 0;                       // slot l summed over the streams
  for (int s = 0; s < kLanes; ++s) col = wrap_add(col, tbl[l * kLanes + s]);
  out[l] = wrap_add(wrap_add(wrap_add(rng, code), st), col);
}

__global__ void __launch_bounds__(kLanes) submask_kernel(int32_t seed,
                                                         int32_t* __restrict__ out, int iters) {
  extern __shared__ int32_t smem[];
  int32_t* tbl = smem;                                    // [192 slots][128 streams]
  const int l = threadIdx.x;
  for (int t = 0; t < kSubSlots; ++t) tbl[t * kLanes + l] = kProbInit;
  int32_t rng = kRng0, code = compact_code0(l, seed), st = 3;
  for (int it = 0; it < iters; ++it) {
    for (int b = 0; b < kCalls; ++b) {
      const int32_t idx = compact_slot_mod(st, code, kSubSlots);
      int32_t prob = 0;
#pragma unroll 8
      for (int t = 0; t < kSubSlots; ++t)
        prob = wrap_add(prob, t == idx ? tbl[t * kLanes + l] : 0);
      const int32_t newp = compact_alu(rng, code, st, prob);
#pragma unroll 8
      for (int t = 0; t < kSubSlots; ++t) {
        int32_t& v = tbl[t * kLanes + l];
        v = t == idx ? newp : v;
      }
    }
  }
  int32_t col = 0;                       // stream l's slots summed
  for (int t = 0; t < kSubSlots; ++t) col = wrap_add(col, tbl[t * kLanes + l]);
  out[l] = wrap_add(wrap_add(wrap_add(rng, code), st), col);
}

cudaError_t launch_big(const void* kern, size_t smem, int32_t seed, int32_t* out, int iters,
                       cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&seed, &out, &iters};
  return cudaLaunchKernel(kern, dim3(1), dim3(kLanes), args, smem, stream);
}

}  // namespace

// Launches P2 kernel `kind` (a Kind code) on `stream` without
// synchronising.  out is int32 [64, 128] for bcast, [1, 128] for the
// others.  Returns the CUDA error code of the attribute call or the launch
// (0 = launched).
extern "C" int lzt_compact_probe(int kind, int seed, void* out_, int iters, void* stream_) {
  int32_t* out = (int32_t*)out_;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (iters < 0) return (int)cudaErrorInvalidValue;
  const size_t tbl128 = (size_t)kLanes * kLanes * sizeof(int32_t);   // 64 KB
  switch (kind) {
    case kBcast:
      bcast_kernel<<<kBcastRows, kLanes, 0, stream>>>(seed, out, iters);
      return (int)cudaGetLastError();
    case kMxu:
      return (int)launch_big((const void*)compact_kernel<true>,
                             2 * tbl128 + kLanes * sizeof(float), seed, out, iters, stream);
    case kTpose:
      return (int)launch_big((const void*)compact_kernel<false>, tbl128, seed, out, iters,
                             stream);
    case kSubmask:
      return (int)launch_big((const void*)submask_kernel,
                             (size_t)kSubSlots * kLanes * sizeof(int32_t), seed, out, iters,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
