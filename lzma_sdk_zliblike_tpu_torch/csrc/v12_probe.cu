// Kernel P1 on Hopper: the v12 bit-call microbenchmark.
//
// Replaces tools/dev_v12_probe.py::make_kernel.kernel (the Pallas probe,
// launched by run).  What it computes is unchanged and bit-identical: `iters`
// iterations of 28 range-coder-bit-shaped calls (a gather from one of 8
// probability tables, bound, probability update, masked store, range
// update, renormalisation) on synthetic state, in the TPU probe's variants:
//   broadcast    one element per (row s, lane l), [S, 128], tables per row
//   masked       + a per-iteration live mask on the range and code update
//   fused2       + a second gather and store in the next table
//   live<N>      fused2 without its second store, + N extra long-lived
//                carries (N >= 1)
//   tailalways   broadcast + a 26-trip tail loop every iteration
//   tailnever    broadcast (the tail never runs)
//   tailcond     broadcast + the tail gated on any(idx > 120) over all S x 128
//   while        broadcast as a while loop
//   whilecond    broadcast as a while loop with a busy check over all
//                S x 128 every 64th iteration
//   lane         one scalar state per stream, tables per stream
//   lane-notr    one scalar state per stream, a fake probability, no tables
//
// The TPU layout is left behind.  A row-variant block is one row s: 128
// threads, one per lane, and the row's 8 tables (4 KB) in shared memory.
// Every read of a table in a call comes before any write (the Pallas body
// gathers from the old table), and thread l only ever writes slot l of a
// table (probe_lane.cuh: owned_store).  Call b stores only into table
// b % 8, and call b + 1 gathers only from tables (b + 1) % 8 and
// (b + 2) % 8, so a call's stores and the next call's gathers share a
// phase: each call has one barrier, between its gathers and its stores.
// fused2 alone stores into table (b + 1) % 8 as well, the table the next
// call reads, and keeps a second barrier after its stores.  A lane-variant
// thread is one stream; its 8 x 128 table slots sit in shared memory with
// the stream index fastest, so a warp's gathers never share a bank.  The
// reductions over all S x 128 elements (tailcond, whilecond) need the whole
// grid: those two launch cooperatively and meet at a grid barrier, voting
// into one of three rotating global slots.
//
// What bounds it on this card: integer operations (the probe moves no
// memory but its output), and more, the dependent chain of each call:
// every call waits on the previous range, index and table.  The bound that
// tools/dev_v12_probe.py reports counts the int32 operations of each
// call from this source over 132 SMs x 64 INT32 lanes per clock.  The
// design takes the barrier that the table rotation makes needless out of
// each row call's chain; the lane variants' chain is the probe itself.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; tools/dev_v12_probe.py calls lzt_v12_probe through
// ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_lane.cuh"

namespace cg = cooperative_groups;
using namespace lzt::probe;

namespace {

constexpr int kLaneBlock = 32;   // streams per block of the lane variant

// any(pred) over every thread of the grid.  Slot k % 3 of `votes` collects
// the k-th vote; block 0 clears the slot of vote k + 1, whose last reader
// passed the grid barrier of vote k - 1 before this one can start.
// votes[3] counts the votes that came out true.
__device__ bool grid_any(bool pred, int* votes, unsigned k) {
  int* slot = votes + k % 3;
  if (__syncthreads_or(pred) && threadIdx.x == 0) atomicOr(slot, 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) votes[(k + 1) % 3] = 0;
  cg::this_grid().sync();
  const bool any = *(volatile int*)slot != 0;
  if (any && blockIdx.x == 0 && threadIdx.x == 0) votes[3] += 1;
  return any;
}

// The row variants: block s is row s, thread l lane l.  NREG > 0 keeps
// live<NREG>'s carries in registers; NREG == 0 keeps `extra` of them in
// dynamic shared memory (column l of each), for live<N> with N > 8.
template <int V, int NREG>
__global__ void __launch_bounds__(kLanes) v12_row_kernel(int32_t* __restrict__ out,
                                                         int iters, int extra,
                                                         int* votes) {
  constexpr bool kMask = V == kMasked || V == kFused2 || V == kLive;
  constexpr bool kFuse = V == kFused2 || V == kLive;
  constexpr int kReg = NREG > 0 ? NREG : 1;
  __shared__ int32_t tbl[kTables][kLanes];
  extern __shared__ int32_t cs_smem[];
  const int l = threadIdx.x;
  for (int t = 0; t < kTables; ++t) tbl[t][l] = kProbInit;
  int32_t cs[kReg];
  if (V == kLive) {
    if (NREG > 0) {
#pragma unroll
      for (int e = 0; e < NREG; ++e) cs[e] = 3 + e;
    } else {
      for (int e = 0; e < extra; ++e) cs_smem[e * kLanes + l] = 3 + e;
    }
  }
  __syncthreads();
  V12Row s = {0xFFFFFFFFu, 0, 0, 0, 0, 0, true, false};
  unsigned nvote = 0;
  bool busy = true;
  for (int it = 0; it < iters && busy; ++it) {
    if (V == kWhileCond) busy = (it & 63) != 0 || grid_any(s.idx < (1 << 30), votes, nvote++);
    s.live = s.idx < 96;
#pragma unroll
    for (int b = 0; b < kCalls; ++b) {
      v12_row_gather<kFuse>(&tbl[0][0], b, s);
      __syncthreads();                   // every gather of call b before any store
      v12_row_store<V == kFused2>(&tbl[0][0], b, l, s);
      if (v12_store_barrier(V == kFused2)) __syncthreads();   // read by call b + 1
      if (V == kLive) {
        if (NREG > 0) {
          cs[b % kReg] = wrap_add(cs[b % kReg], s.idx);
        } else {
          int32_t& c = cs_smem[(b % extra) * kLanes + l];
          c = wrap_add(c, s.idx);
        }
      }
      v12_row_settle<kMask>(s);
    }
    if (V == kTailAlways || (V == kTailCond && grid_any(s.idx > 120, votes, nvote++)))
      v12_tail(s.rng, s.code);
  }
  int32_t acc = s.idx;
  if (V == kLive) {
    if (NREG > 0) {
#pragma unroll
      for (int e = 0; e < NREG; ++e) acc ^= cs[e];
    } else {
      for (int e = 0; e < extra; ++e) acc ^= cs_smem[e * kLanes + l];
    }
  }
  out[blockIdx.x * kLanes + l] = acc;
}

// The lane variants: thread s is stream s, with rng/code/idx as scalars.
// `lane` gathers from and stores to its own 8 x 128 slots in shared memory
// (slot-major, stream fastest); `lane-notr` takes code & 2047 as its
// probability and touches no table.  The state starts from rows 0..2 of
// out, which the caller zeroes (the TPU kernel's zeroed state scratch): a
// start the compiler cannot see keeps it from folding lane-notr's loop,
// whose zero state is a fixed point.  Rows 0..7 of out get the final state
// rows (rng, code, idx, then five zero rows); rows 8.. stay as the caller
// made them.
template <bool kTables8>
__global__ void v12_lane_kernel(int32_t* __restrict__ out, int n_streams, int iters) {
  extern __shared__ int32_t ltbl[];
  const int tid = threadIdx.x;
  const int s = blockIdx.x * blockDim.x + tid;
  if (s >= n_streams) return;
  auto slot = [&](int t, int j) -> int32_t& {
    return ltbl[(t * kLanes + j) * kLaneBlock + tid];
  };
  if (kTables8)
    for (int t = 0; t < kTables; ++t)
      for (int j = 0; j < kLanes; ++j) slot(t, j) = kProbInit;
  uint32_t rng = (uint32_t)out[0 * kLanes + s], code = (uint32_t)out[1 * kLanes + s];
  int32_t idx = out[2 * kLanes + s];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int b = 0; b < kCalls; ++b)
      v12_lane_call<kTables8>(&slot(b % kTables, clip127(idx)), &slot(b % kTables, idx & 127),
                              rng, code, idx);
  }
  out[0 * kLanes + s] = (int32_t)rng;
  out[1 * kLanes + s] = (int32_t)code;
  out[2 * kLanes + s] = idx;
  for (int r = 3; r < 8; ++r) out[r * kLanes + s] = 0;
}

template <int V, int NREG>
cudaError_t launch_row(int32_t* out, int S, int iters, int extra, int* votes,
                       cudaStream_t stream) {
  const size_t smem = NREG == 0 && V == kLive ? (size_t)extra * kLanes * sizeof(int32_t) : 0;
  auto* kern = v12_row_kernel<V, NREG>;
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (V == kTailCond || V == kWhileCond) {
    void* args[] = {&out, &iters, &extra, &votes};
    return cudaLaunchCooperativeKernel((const void*)kern, dim3(S), dim3(kLanes), args, smem,
                                       stream);
  }
  kern<<<S, kLanes, smem, stream>>>(out, iters, extra, votes);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_live(int32_t* out, int S, int iters, int extra, int* votes,
                        cudaStream_t stream) {
  if (extra == N) return launch_row<kLive, N>(out, S, iters, extra, votes, stream);
  if constexpr (N > 1) return launch_live<N - 1>(out, S, iters, extra, votes, stream);
  return launch_row<kLive, 0>(out, S, iters, extra, votes, stream);
}

}  // namespace

// Launches P1 on `stream` without synchronising: `variant` is a Variant
// code (V12Variant), `extra` the N of live<N>.  out is int32 [S, 128] and votes int32
// [4] (the grid-wide reductions' slots and their count of true votes), both
// zeroed by the caller.  Returns the CUDA error code of the attribute call
// or the launch (0 = launched).
extern "C" int lzt_v12_probe(void* out_, void* votes_, int S, int iters, int variant,
                             int extra, void* stream_) {
  int32_t* out = (int32_t*)out_;
  int* votes = (int*)votes_;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (S <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  switch (variant) {
    case kBroadcast: e = launch_row<kBroadcast, 1>(out, S, iters, 0, votes, stream); break;
    case kMasked: e = launch_row<kMasked, 1>(out, S, iters, 0, votes, stream); break;
    case kFused2: e = launch_row<kFused2, 1>(out, S, iters, 0, votes, stream); break;
    case kLive:
      if (extra < 1) return (int)cudaErrorInvalidValue;
      e = launch_live<8>(out, S, iters, extra, votes, stream);
      break;
    case kTailAlways: e = launch_row<kTailAlways, 1>(out, S, iters, 0, votes, stream); break;
    case kTailNever: e = launch_row<kTailNever, 1>(out, S, iters, 0, votes, stream); break;
    case kTailCond: e = launch_row<kTailCond, 1>(out, S, iters, 0, votes, stream); break;
    case kWhile: e = launch_row<kWhile, 1>(out, S, iters, 0, votes, stream); break;
    case kWhileCond: e = launch_row<kWhileCond, 1>(out, S, iters, 0, votes, stream); break;
    case kLane: {
      const int smem = kTables * kLanes * kLaneBlock * (int)sizeof(int32_t);   // 128 KB
      e = cudaFuncSetAttribute(v12_lane_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) break;
      v12_lane_kernel<true><<<(S + kLaneBlock - 1) / kLaneBlock, kLaneBlock, smem, stream>>>(
          out, S, iters);
      e = cudaGetLastError();
      break;
    }
    case kLaneNotr:
      v12_lane_kernel<false><<<(S + kLanes - 1) / kLanes, kLanes, 0, stream>>>(out, S, iters);
      e = cudaGetLastError();
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
