// Kernel P2 on Hopper: the compact-layout bit-call microbenchmark.
//
// Replaces tools/compact_probe.py::kern_bcast / kern_mxu / kern_tpose /
// kern_submask (the Pallas probes, launched by run).  What each computes is
// unchanged and bit-identical: `iters` iterations of 28 calls of the shared
// signed-int32 ALU `_alu` (probe_lane.cuh: compact_alu), each call reading
// and updating one probability-table slot, in four layouts:
//   bcast    64 rows x 128 lanes of broadcast state, a table per row; one
//            block per row, one thread per lane, two copies of the row's
//            table in shared memory: call b reads copy b & 1 and every
//            thread writes its own slot, updated or not, into the other
//            copy, so a call has one barrier
//   mxu      128 streams of compact state and a 128 x 128 table (one row
//            per stream); the slot index goes from the compact to the
//            stream-per-row layout, the gathered probability back, and the
//            new probability out again, each as a product with the whole
//            128 x 128 one-hot matrix on the tensor cores
//            (mma.sync.m16n8k16, f16 in, f32 accumulator; exact, every
//            value is below 2048).  One block of 128 threads, since the
//            products couple the streams; the vector crosses shared memory
//            in two alternating buffers, one barrier a product
//   tpose    the same with the relayouts as transposes: on the card a
//            thread holds its stream in both layouts, so they cost nothing
//   submask  128 streams, a 192-slot table per stream; the read is a masked
//            sum over all 192 slots and the update a masked select over all
//            of them, as in the TPU probe (no gather at all).  A warp per
//            stream, a block per warp (128 blocks over the card's SMs, no
//            SM shared by two streams): lane j holds slots j, j + 32, ...
//            (6) in registers, the scalar state runs in every lane, the
//            read is each lane's masked sum and a warp reduction
//            (redux.sync), the select each lane's own; no shared memory
// tpose's table (64 KB) and mxu's (64 KB + 512 B of vector buffers) are
// slot-major (stream fastest) in dynamic shared memory; thread l owns
// column l, so neither needs a barrier for its table.
//
// What bounds it on this card: integer operations (mxu's products on the
// tensor cores), and more, each call's dependent chain.
// tools/compact_probe.py counts the operations of each call from this
// source; chip_smoke.py divides them over 132 SMs x 64 INT32 lanes per
// clock, and mxu's multiply-adds over the dense fp16 tensor-core rate.
// The design spreads submask's independent streams over the card and takes
// its table walk off shared memory, runs mxu's products where the TPU ran
// them, and drops bcast's needless barrier; the chain is the probe itself.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; tools/compact_probe.py calls lzt_compact_probe through
// ctypes.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_lane.cuh"

using namespace lzt::probe;

namespace {

// kernel codes; tools/compact_probe.py's KERNELS holds the same order
enum Kind { kBcast = 0, kMxu, kTpose, kSubmask };

constexpr int kBcastRows = 64;
constexpr int32_t kRng0 = 0x7FFFFF00;
constexpr int kSubPer = kSubSlots / kSubLanes;   // submask slots per lane
static_assert(kCalls % 2 == 0, "bcast's table copy and mxu's buffers alternate per call");

__global__ void __launch_bounds__(kLanes) bcast_kernel(int32_t seed, int32_t* __restrict__ out,
                                                       int iters) {
  __shared__ int32_t tbl[2][kLanes];
  const int l = threadIdx.x, r = blockIdx.x;
  int32_t mine = kProbInit;              // slot l, as this thread last wrote it
  tbl[0][l] = mine;
  __syncthreads();
  int32_t rng = kRng0, code = compact_code0(r, seed), st = 3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int b = 0; b < kCalls; ++b) {
      const int32_t idx = compact_slot(st, code);
      const int32_t prob = tbl[bcast_read_copy(b)][idx];
      const int32_t newp = compact_alu(rng, code, st, prob);
      mine = owned_slot(mine, l, idx, newp);
      tbl[bcast_write_copy(b)][l] = mine;
      __syncthreads();                   // the next call's copy whole
    }
  }
  out[r * kLanes + l] = wrap_add(wrap_add(wrap_add(rng, code), st), mine);
}

// D += A B for one m16n8k16 tile: A 16 x 16 f16 (4 registers), B 16 x 8 f16
// (2 registers), D 16 x 8 f32.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mxu's relayout on thread l: entry l of E v, E the one-hot matrix whose
// rows 32w .. 32w + 31 warp w holds as A fragments `a` ([M-tile][K-step]),
// v the block's values, which each thread puts into `vec` (a buffer that no
// thread reads until the barrier of the relayout after next).  Every
// (M-tile, K-step) product has its own accumulator, so the 16 mma's of a
// warp do not wait on each other; the 8 partial sums of a row are one
// value and seven exact zeros, so the f32 result stays exact.
__device__ __forceinline__ int32_t relayout(const uint32_t (&a)[2][8][4], __half* vec, int l,
                                            int32_t mine) {
  vec[l] = __int2half_rn(mine);          // exact: |mine| < 2048
  __syncthreads();                       // every entry of v written
  const int lane = l & 31;
  const uint32_t* v2 = reinterpret_cast<const uint32_t*>(vec);
  float d[2][8][4] = {};                 // [M-tile][K-step][C element]
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const uint32_t b0 = v2[mxu_b_word(lane, ks, 0)], b1 = v2[mxu_b_word(lane, ks, 1)];
    mma_16816(d[0][ks], a[0][ks], b0, b1);
    mma_16816(d[1][ks], a[1][ks], b0, b1);
  }
  auto sum8 = [&](int t, int e) {
    return ((d[t][0][e] + d[t][1][e]) + (d[t][2][e] + d[t][3][e])) +
           ((d[t][4][e] + d[t][5][e]) + (d[t][6][e] + d[t][7][e]));
  };
  // send C element mxu_send_elem of M-tile mxu_send_tile
  const float lo0 = sum8(0, 0), hi0 = sum8(0, 2), lo1 = sum8(1, 0), hi1 = sum8(1, 2);
  const bool hi = mxu_send_elem(lane) == 2;
  const float send = mxu_send_tile(lane) ? (hi ? hi1 : lo1) : (hi ? hi0 : lo0);
  return __float2int_rn(__shfl_sync(0xFFFFFFFFu, send, mxu_src_lane(lane)));
}

// One mxu call of parity P on thread l (stream l): the slot index to the
// rows, the gathered probability back, the new one out again.
template <int P>
__device__ __forceinline__ void mxu_call(const uint32_t (&a)[2][8][4], int32_t* tbl,
                                         __half* vec, int l, int32_t& rng, int32_t& code,
                                         int32_t& st) {
  const int32_t idx = relayout(a, vec + mxu_buffer(P, 0) * kLanes, l, compact_slot(st, code));
  const int32_t prob = relayout(a, vec + mxu_buffer(P, 1) * kLanes, l, tbl[idx * kLanes + l]);
  const int32_t newp = relayout(a, vec + mxu_buffer(P, 2) * kLanes, l,
                                compact_alu(rng, code, st, prob));
  tbl[idx * kLanes + l] = newp;
}

__global__ void __launch_bounds__(kLanes) mxu_kernel(int32_t seed, int32_t* __restrict__ out,
                                                     int iters) {
  extern __shared__ int32_t smem[];
  int32_t* tbl = smem;                                    // [128 slots][128 streams]
  __half* vec = reinterpret_cast<__half*>(smem + kLanes * kLanes);   // [2][128]
  const int l = threadIdx.x, w = l >> 5, lane = l & 31;
  uint32_t a[2][8][4];                   // the one-hot matrix's A fragments, loaded once
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[t][ks][r] = (mxu_a_one(w, t, ks, lane, 2 * r) ? 0x3C00u : 0u) |
                      (mxu_a_one(w, t, ks, lane, 2 * r + 1) ? 0x3C000000u : 0u);   // f16 1.0
  for (int j = 0; j < kLanes; ++j) tbl[j * kLanes + l] = kProbInit;
  int32_t rng = kRng0, code = compact_code0(l, seed), st = 3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 1
    for (int b = 0; b < kCalls; b += 2) {
      mxu_call<0>(a, tbl, vec, l, rng, code, st);
      mxu_call<1>(a, tbl, vec, l, rng, code, st);
    }
  }
  __syncthreads();
  int32_t col = 0;                       // slot l summed over the streams
  for (int s = 0; s < kLanes; ++s) col = wrap_add(col, tbl[l * kLanes + s]);
  out[l] = wrap_add(wrap_add(wrap_add(rng, code), st), col);
}

// tpose: thread l is stream l; its table row is tbl[j][l].
__global__ void __launch_bounds__(kLanes) tpose_kernel(int32_t seed, int32_t* __restrict__ out,
                                                       int iters) {
  extern __shared__ int32_t smem[];
  int32_t* tbl = smem;                                    // [128 slots][128 streams]
  const int l = threadIdx.x;
  for (int j = 0; j < kLanes; ++j) tbl[j * kLanes + l] = kProbInit;
  __syncthreads();
  int32_t rng = kRng0, code = compact_code0(l, seed), st = 3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int b = 0; b < kCalls; ++b) {
      const int32_t idx = compact_slot(st, code);
      const int32_t prob = tbl[idx * kLanes + l];
      tbl[idx * kLanes + l] = compact_alu(rng, code, st, prob);
    }
  }
  __syncthreads();
  int32_t col = 0;                       // slot l summed over the streams
  for (int s = 0; s < kLanes; ++s) col = wrap_add(col, tbl[l * kLanes + s]);
  out[l] = wrap_add(wrap_add(wrap_add(rng, code), st), col);
}

// submask: block s is stream s, lane j of its warp holds slots j + 32 k.
__global__ void __launch_bounds__(kSubLanes) submask_kernel(int32_t seed,
                                                            int32_t* __restrict__ out, int iters) {
  const int s = blockIdx.x, j = threadIdx.x;
  int32_t v[kSubPer];
#pragma unroll
  for (int k = 0; k < kSubPer; ++k) v[k] = kProbInit;
  int32_t rng = kRng0, code = compact_code0(s, seed), st = 3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int b = 0; b < kCalls; ++b) {
      const int32_t idx = compact_slot_mod(st, code, kSubSlots);
      const int32_t prob = (int32_t)__reduce_add_sync(
          0xFFFFFFFFu, (uint32_t)submask_read<kSubLanes>(v, j, idx));
      const int32_t newp = compact_alu(rng, code, st, prob);
      submask_select<kSubLanes>(v, j, idx, newp);
    }
  }
  const int32_t col = (int32_t)__reduce_add_sync(   // stream s's slots summed
      0xFFFFFFFFu, (uint32_t)submask_sum<kSubLanes>(v));
  if (j == 0) out[s] = wrap_add(wrap_add(wrap_add(rng, code), st), col);
}

cudaError_t launch_smem(const void* kern, size_t smem, int32_t seed, int32_t* out, int iters,
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
      return (int)launch_smem((const void*)mxu_kernel, tbl128 + 2 * kLanes * sizeof(__half),
                              seed, out, iters, stream);
    case kTpose:
      return (int)launch_smem((const void*)tpose_kernel, tbl128, seed, out, iters, stream);
    case kSubmask:
      submask_kernel<<<kLanes, kSubLanes, 0, stream>>>(seed, out, iters);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}
