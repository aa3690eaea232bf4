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
// than 3 bytes for a host retry.  A CUDA thread has its own control flow, so
// one thread runs one lane's serial coder (lzma_enc_lane.cuh) and ShiftLow
// writes a pending 0xFF run of any length exactly.
//
// What bounds it on this card: the serial dependency inside a lane (every
// bit waits on the previous range and probability), not bandwidth.  The
// bytes bound -- op words read once plus bodies written once at 3.35 TB/s --
// is tens of microseconds for 128 groups of 1 MiB.  This simple design does
// nothing about that yet, by intent: one thread per lane, the lane's
// probability model (num_probs(lc, lp) uint16) in shared memory, op words
// read and body bytes written one at a time in the lane's rows.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/range_encode.py calls lzt_range_encode through
// ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lzma_enc_lane.cuh"

namespace {

__global__ void range_encode_kernel(
    const uint32_t* __restrict__ ops, int64_t op_cap,
    const int32_t* __restrict__ op_ends, int n_chunks,
    const int32_t* __restrict__ active, uint8_t* __restrict__ out, int64_t out_cap,
    int32_t* __restrict__ tab, int32_t* __restrict__ ok, int32_t* __restrict__ bytes,
    int32_t* __restrict__ err, int n_lanes, int lc, int lp, int pb, int probs_stride) {
  extern __shared__ uint16_t probs_smem[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  if (!active[lane]) {
    ok[lane] = 1;
    bytes[lane] = 0;
    err[lane] = 0;
    return;
  }
  const int64_t t = (int64_t)lane * n_chunks;
  lzt::enc::encode_lane(ops + (int64_t)lane * op_cap, op_cap, op_ends + t, n_chunks,
                        out + (int64_t)lane * out_cap, out_cap,
                        probs_smem + threadIdx.x * probs_stride, lc, lp, pb, tab + t,
                        ok + lane, bytes + lane, err + lane);
}

}  // namespace

// Launches K2 on `stream` without synchronising.  Lanes are spread over the
// SMs first (one lane per block while there are SMs to spare); a block holds
// as many lanes as its shared memory allows.  Returns the CUDA error code of
// the attribute call or the launch (0 = launched).
extern "C" int lzt_range_encode(const void* ops, long long op_cap, const void* op_ends,
                                int n_chunks, const void* active, void* out,
                                long long out_cap, void* tab, void* ok, void* bytes,
                                void* err, int n_lanes, int lc, int lp, int pb,
                                void* stream) {
  if (n_lanes <= 0) return 0;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int stride = (lzt::num_probs(lc, lp) + 7) & ~7;   // 16-byte rows
  const int lane_bytes = stride * (int)sizeof(uint16_t);
  int per_block = (n_lanes + sms - 1) / sms;
  if (per_block * lane_bytes > smem_max) per_block = smem_max / lane_bytes;
  if (per_block < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)per_block * lane_bytes;
  e = cudaFuncSetAttribute(range_encode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n_lanes + per_block - 1) / per_block;
  range_encode_kernel<<<blocks, per_block, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)ops, op_cap, (const int32_t*)op_ends, n_chunks,
      (const int32_t*)active, (uint8_t*)out, out_cap, (int32_t*)tab, (int32_t*)ok,
      (int32_t*)bytes, (int32_t*)err, n_lanes, lc, lp, pb, stride);
  return (int)cudaGetLastError();
}
