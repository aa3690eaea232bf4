// Kernel K2 on Hopper: lane-parallel LZMA range encode of dict-reset groups.
//
// Replaces lzma_sdk_zliblike_tpu/ops/pallas_encode.py::_make_kernel.kernel
// (the Pallas range encoder, launched by _encode_call_cached).  What it
// computes is unchanged: each lane replays one group's op records (from the
// host's fast parse) through the adaptive model and the carry/cache range
// coder, and its chunk bodies are byte-identical to native encode_segment.
// The TPU layout is left behind: 128-lane pages, packed probability
// families, parity output windows with their DMA flushes and event bits, the
// fused slot schedule, and the 0xFF-run workaround that flagged runs longer
// than 3 bytes for a host retry; ShiftLow writes a pending 0xFF run of any
// length exactly.
//
// What bounds it on this card: the serial dependencies, not bandwidth.  The
// bytes bound -- op words read once, bodies written once, the scratch
// written and read once -- is under a millisecond for 128 groups of 1 MiB.
// A lane's model is one chain of dependent probability updates, and each
// chunk's coder one chain of dependent bit calls.  The design
// (lzma_enc_lane.cuh) takes them apart:
//   walk    one warp per lane, one lane per block: the model in shared
//           memory, op words staged there by a cp.async ring, 32 ops a
//           batch, one thread per probability slot updating every op of the
//           batch with no barrier between ops; writes the coder's stream of
//           (probability, bit) entries into the scratch area;
//   code    one warp per (lane, chunk): the warp stages the chunk's stream
//           by cp.async, thread 0 range-codes it 8 entries per 16-byte load;
//           a group's chunks code in parallel (2,816 chains instead of 128
//           on 128 groups of 1 MiB in 48 KiB chunks), all resident at once
//           (2 KiB of shared memory a block); bytes go straight to the
//           chunk's slot in the scratch area, whose size is proved enough;
//   gather  one block of 256 threads per lane: slots back to back into the
//           bodies, tab and status.
// The three launches run in order on the caller's stream.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/range_encode.py calls lzt_range_encode through
// ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lzma_enc_lane.cuh"

namespace {

using lzt::Threads;
using lzt::enc::Layout;

// Shared memory: the op-word or stream ring; the walk adds its batch and
// the model.
constexpr int kRingBytes = (int)lzt::kStageBuf;

int walk_smem_bytes(int lc, int lp) {
  return kRingBytes + (int)sizeof(lzt::enc::Batch) + 2 * (lzt::num_probs(lc, lp) + lzt::kT);
}

__global__ void __launch_bounds__(lzt::kT) walk_kernel(
    const uint32_t* __restrict__ ops, uint32_t op_cap, const int32_t* __restrict__ op_ends,
    int n_chunks, const int32_t* __restrict__ active, uint8_t* scratch, Layout L, int lc,
    int lp, int pb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  if (!active[lane]) return;
  uint8_t* ring = smem;
  lzt::enc::Batch* batch = (lzt::enc::Batch*)(smem + kRingBytes);
  uint16_t* probs = (uint16_t*)(batch + 1);
  const int me = (int)threadIdx.x;
  lzt::enc::walk_lane(ops + (int64_t)lane * op_cap, op_cap,
                      op_ends + (int64_t)lane * n_chunks, n_chunks,
                      scratch + (int64_t)lane * L.lane, L, probs, ring, *batch, lc, lp, pb,
                      Threads{me, me + 1});
}

__global__ void __launch_bounds__(lzt::kT) code_kernel(const int32_t* __restrict__ op_ends,
                                                       int n_chunks,
                                                       const int32_t* __restrict__ active,
                                                       uint8_t* scratch, Layout L) {
  __shared__ __align__(16) uint8_t ring[lzt::kStageBuf];
  const int lane = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  if (!active[lane]) return;
  const int me = (int)threadIdx.x;
  lzt::enc::code_lane_chunk(op_ends + (int64_t)lane * n_chunks, c,
                            scratch + (int64_t)lane * L.lane, L, ring, Threads{me, me + 1});
}

__global__ void __launch_bounds__(lzt::enc::kGatherT) gather_kernel(
    const int32_t* __restrict__ op_ends, int n_chunks, const int32_t* __restrict__ active,
    uint8_t* __restrict__ out, uint32_t out_cap, int32_t* __restrict__ tab,
    int32_t* __restrict__ ok, int32_t* __restrict__ bytes, int32_t* __restrict__ err,
    int32_t* __restrict__ bits, const uint8_t* scratch, Layout L) {
  __shared__ __align__(16) uint8_t ring[lzt::kStageBuf];
  const int lane = blockIdx.x;
  lzt::enc::Status st = {1, 0, 0, 0};   // an inactive lane reports ok
  if (active[lane]) {
    const int me = (int)threadIdx.x;
    st = lzt::enc::gather_lane(op_ends + (int64_t)lane * n_chunks,
                               out + (int64_t)lane * out_cap, out_cap,
                               tab + (int64_t)lane * n_chunks,
                               scratch + (int64_t)lane * L.lane, L, ring,
                               Threads{me, me + 1});
  }
  if (threadIdx.x == 0) {
    ok[lane] = st.ok;
    bytes[lane] = st.bytes;
    err[lane] = st.err;
    bits[lane] = st.bits;
  }
}

}  // namespace

// Launches K2 -- walk, code and gather -- on `stream` without
// synchronising.  `scratch` holds `scratch_stride` bytes per lane, at least
// scratch_layout's (lzma_enc_lane.cuh); its contents on entry do not matter.
// `marks`, if not null, points at two cudaEvent_t recorded after the walk
// and after the code launch.  op_cap must be below 2^27 (the bytes of a
// lane's coder stream, about 26 per op word, stay below 2^32) and out_cap
// below 2^31.
// Returns the CUDA error code of the attribute calls, the launches or the
// records (0 = launched).
extern "C" int lzt_range_encode(const void* ops, long long op_cap, const void* op_ends,
                                int n_chunks, const void* active, void* out,
                                long long out_cap, void* tab, void* ok, void* bytes,
                                void* err, void* bits, int n_lanes, int lc, int lp, int pb,
                                void* scratch, long long scratch_stride, void* marks,
                                void* stream) {
  if (n_lanes <= 0) return 0;
  if (op_cap <= 0 || op_cap >= (1ll << 27) || out_cap <= 0 || out_cap >= (1ll << 31) ||
      n_chunks <= 0 || (long long)n_lanes * n_chunks >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Layout L = lzt::enc::scratch_layout(op_cap, n_chunks);
  if (scratch_stride < L.lane || (scratch_stride & 15)) return (int)cudaErrorInvalidValue;
  L.lane = scratch_stride;
  const int smem = walk_smem_bytes(lc, lp);
  cudaError_t e = cudaFuncSetAttribute(walk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t* ev = (cudaEvent_t*)marks;
  const int32_t* ends = (const int32_t*)op_ends;
  const int32_t* act = (const int32_t*)active;
  uint8_t* sc = (uint8_t*)scratch;
  walk_kernel<<<n_lanes, lzt::kT, smem, s>>>((const uint32_t*)ops, (uint32_t)op_cap, ends,
                                              n_chunks, act, sc, L, lc, lp, pb);
  e = cudaGetLastError();
  if (e == cudaSuccess && ev) e = cudaEventRecord(ev[0], s);
  if (e != cudaSuccess) return (int)e;
  code_kernel<<<n_lanes * n_chunks, lzt::kT, 0, s>>>(ends, n_chunks, act, sc, L);
  e = cudaGetLastError();
  if (e == cudaSuccess && ev) e = cudaEventRecord(ev[1], s);
  if (e != cudaSuccess) return (int)e;
  gather_kernel<<<n_lanes, lzt::enc::kGatherT, 0, s>>>(
      ends, n_chunks, act, (uint8_t*)out, (uint32_t)out_cap, (int32_t*)tab, (int32_t*)ok,
      (int32_t*)bytes, (int32_t*)err, (int32_t*)bits, sc, L);
  return (int)cudaGetLastError();
}
