// Kernel K1 on Hopper: lane-parallel decode of LZMA2 dict-reset groups.
//
// Replaces lzma_sdk_zliblike_tpu/ops/pallas_decode.py::_make_kernel.kernel
// (the Pallas group decoder, launched by _decode_call).  What it computes is
// unchanged: each lane decodes whole dict-reset groups bit-exactly to
// LzmaDec.c:131-426, with per-chunk range-coder re-init, state resets, copy
// chunks moved in the kernel and in-lane dictionary rebase (flag bits in
// lzma_lane.cuh).  The TPU layout (streams on sublanes, 128-lane pages,
// packed word pages, staging words, tune flags) is left behind; the chunk
// table lives in global memory with no 128-entry cap.
//
// What bounds it on this card: the serial dependency inside a lane (every
// range-coder bit waits on the previous one), not bandwidth: the bytes
// bound -- packed input read once plus output written once at 3.35 TB/s --
// is tens of microseconds for a 128 MiB batch.  The design keeps device
// memory off that chain.  A block is one warp and decodes one lane
// (lzma_lane.cuh): the 32 threads run the scalar decoder alike and share
// the byte moves.  Its dynamic shared memory holds the lane's model, a
// ring of four 512-byte pieces of its packed input (cp.async, 16 bytes a
// thread, one piece in flight ahead of the decoder) and a ring of its last
// output bytes, the dictionary window, which reaches `out` in whole
// segments with 16-byte stores.  Literal contexts, matched bytes,
// short reps and match sources come from the ring, or for the few distances
// beyond the window from `out`, one warp-wide load per match.
//
// The window: ceil(n_lanes / SMs) blocks share an SM, so each gets that
// share of the SM's shared memory; the window is the largest power of two
// that fits beside the model and the input buffer, at least kMinWindow and
// no larger than a power of two that covers dic_cap.  One lane per SM gets
// 128 KiB; eight lanes per SM get 8 KiB.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/group_decode.py calls lzt_group_decode through
// ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lzma_lane.cuh"

namespace {

__global__ void __launch_bounds__(lzt::kT) group_decode_kernel(
    const uint8_t* __restrict__ src, uint32_t pack_cap,
    const int32_t* __restrict__ pack_ends, const int32_t* __restrict__ unpack_ends,
    const int32_t* __restrict__ flags, int n_chunks,
    const int32_t* __restrict__ active, uint8_t* out, uint32_t dic_cap,
    int32_t* __restrict__ ok, int32_t* __restrict__ consumed,
    int32_t* __restrict__ iterations, int32_t* __restrict__ bit_calls, int lc,
    int lp, int pb, int probs_bytes, uint32_t window) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  lzt::LaneStatus s = {1, 0, 0, 0};   // an inactive lane reports ok
  if (active[lane]) {
    const int64_t t = (int64_t)lane * n_chunks;
    const int me = (int)threadIdx.x;
    s = lzt::decode_lane(src + (int64_t)lane * pack_cap, pack_cap, pack_ends + t,
                         unpack_ends + t, flags + t, n_chunks,
                         out + (int64_t)lane * dic_cap, dic_cap, (uint16_t*)smem,
                         smem + probs_bytes, smem + probs_bytes + lzt::kStageBuf, window,
                         lc, lp, pb, lzt::Threads{me, me + 1});
  }
  if (threadIdx.x == 0) {
    ok[lane] = s.ok;
    consumed[lane] = s.consumed;
    iterations[lane] = s.iterations;
    bit_calls[lane] = s.bit_calls;
  }
}

struct Geometry {
  int probs_bytes, window, smem;
};

// The launch geometry of the header comment; also sets the kernel's shared
// memory attributes for it.
cudaError_t geometry(int n_lanes, long long dic_cap, int lc, int lp, Geometry* g) {
  int dev = 0, sms = 0, per_sm = 0, per_block = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return e;
  g->probs_bytes = ((lzt::num_probs(lc, lp) + 7) & ~7) * (int)sizeof(uint16_t);
  const long long fixed = g->probs_bytes + (long long)lzt::kStageBuf;
  const long long per_sm_lanes = (n_lanes + sms - 1) / sms;
  long long room = per_sm / per_sm_lanes - reserved;
  if (room > per_block) room = per_block;
  room -= fixed;
  long long w = lzt::kMinWindow;
  while (2 * w <= room && w < dic_cap) w *= 2;
  g->window = (int)w;
  g->smem = (int)(fixed + w);
  if (g->smem > per_block) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(group_decode_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(group_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem);
  return e;
}

}  // namespace

// The geometry lzt_group_decode launches with for these arguments:
// out int32[3] = window bytes, dynamic shared memory per block, blocks
// resident per SM.  Returns the CUDA error code (0 = ok).
extern "C" int lzt_group_decode_geometry(int n_lanes, long long dic_cap, int lc, int lp,
                                         void* out) {
  Geometry g;
  cudaError_t e = geometry(n_lanes > 0 ? n_lanes : 1, dic_cap, lc, lp, &g);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_decode_kernel,
                                                      lzt::kT, g.smem);
  if (e != cudaSuccess) return (int)e;
  int32_t* o = (int32_t*)out;
  o[0] = g.window;
  o[1] = g.smem;
  o[2] = per_sm;
  return 0;
}

// Launches K1 on `stream` without synchronising: one block of one warp per
// lane.  pack_cap and dic_cap must be below 2^31.  Returns the CUDA error
// code of the attribute calls or the launch (0 = launched).
extern "C" int lzt_group_decode(const void* src, long long pack_cap,
                                const void* pack_ends, const void* unpack_ends,
                                const void* flags, int n_chunks, const void* active,
                                void* out, long long dic_cap, void* ok,
                                void* consumed, void* iterations, void* bit_calls,
                                int n_lanes, int lc, int lp, int pb, void* stream) {
  if (n_lanes <= 0) return 0;
  if (pack_cap <= 0 || pack_cap >= (1ll << 31) || dic_cap <= 0 || dic_cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  cudaError_t e = geometry(n_lanes, dic_cap, lc, lp, &g);
  if (e != cudaSuccess) return (int)e;
  group_decode_kernel<<<n_lanes, lzt::kT, g.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint32_t)pack_cap, (const int32_t*)pack_ends,
      (const int32_t*)unpack_ends, (const int32_t*)flags, n_chunks,
      (const int32_t*)active, (uint8_t*)out, (uint32_t)dic_cap, (int32_t*)ok,
      (int32_t*)consumed, (int32_t*)iterations, (int32_t*)bit_calls, lc, lp, pb,
      g.probs_bytes, (uint32_t)g.window);
  return (int)cudaGetLastError();
}
