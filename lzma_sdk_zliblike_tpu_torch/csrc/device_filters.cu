// X4's scanning filters on Hopper: x86 BCJ and BCJ2 decode over a batch of
// lanes.
//
// Replaces lzma_sdk_zliblike_tpu/ops/device_filters.py::x86_convert_batch
// and ::bcj2_decode_batch (plain XLA under jax.jit, no Pallas).  What they
// compute is unchanged, row for row (filters_lane.cuh).  The TPU versions
// are lax.while_loop scans that step every lane from one E8/E9 (or Jcc)
// candidate to the next in lockstep, a dozen vector operations per step;
// here each lane runs the reference's sequential machine (Bra86.c:11-85,
// Bcj2.c:28-127) on its own thread.
//
// What bounds it on this card: the bytes bound (each lane read once and
// written once at 3.35 TB/s) is tens of microseconds for a 132 MiB batch,
// but each lane's walk is serial: every byte is a dependent load and test,
// so the time follows the longest lane, at the latency of one thread's byte
// loop.  The design does nothing about that chain (a first, simple kernel):
// one thread per lane and one lane per block, so lanes spread over the SMs
// and no two lanes share a warp (a lane's walk branches at every site, and
// lanes that shared a warp would wait on each other's branches); the BCJ2
// probabilities sit in the thread's local memory.  BCJ2 walks its main
// stream twice, once to count the conversions (which fix where the main
// bytes land) and once to write.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/device_filters.py calls lzt_x86_batch and
// lzt_bcj2_batch through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "filters_lane.cuh"

using namespace lzt::filt;

namespace {

// One block of one thread per lane.
__global__ void __launch_bounds__(1)
    x86_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long row,
               const int32_t* __restrict__ valid, const int64_t* __restrict__ ip, int encoding) {
  const long long lane = blockIdx.x;
  x86_lane(in + lane * row, out + lane * row, (int32_t)row, valid[lane], (uint32_t)ip[lane],
           encoding != 0);
}

__global__ void __launch_bounds__(1)
    bcj2_kernel(const uint8_t* __restrict__ main, int main_w, const int32_t* main_len,
                const uint8_t* __restrict__ call, int call_w, const int32_t* call_len,
                const uint8_t* __restrict__ jump, int jump_w, const int32_t* jump_len,
                const uint8_t* __restrict__ rc, int rc_w, const int32_t* rc_len,
                const int32_t* out_size, uint8_t* __restrict__ out, int out_cap,
                int32_t* __restrict__ ok) {
  const long long s = blockIdx.x;
  Bcj2Lane L = {main + s * main_w, main_w, main_len[s], call + s * call_w, call_w,
                call_len[s], jump + s * jump_w, jump_w, jump_len[s], rc + s * rc_w,
                rc_w, rc_len[s], out_size[s]};
  uint16_t probs[kBcj2Probs];
  ok[s] = bcj2_lane(L, probs, out + s * out_cap, out_cap);
}

}  // namespace

// Launches x86 BCJ on `stream` without synchronising: in and out are
// [n_lanes, row] uint8, out holding a copy of in, valid int32 and ip int64
// (uint32 values) per lane.  Returns the CUDA error code (0 = launched).
extern "C" int lzt_x86_batch(const void* in, void* out, long long row, const void* valid,
                             const void* ip, int n_lanes, int encoding, void* stream) {
  if (n_lanes <= 0) return 0;
  if (row <= 0 || row >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  x86_kernel<<<n_lanes, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, row, (const int32_t*)valid, (const int64_t*)ip, encoding);
  return (int)cudaGetLastError();
}

// Launches BCJ2 decode on `stream` without synchronising: the four streams
// are [n_lanes, *_w] uint8 rows with int32 lengths, out_size int32 per lane,
// out [n_lanes, out_cap] uint8 zeroed, ok int32 per lane.  Returns the CUDA
// error code (0 = launched).
extern "C" int lzt_bcj2_batch(const void* main, int main_w, const void* main_len,
                              const void* call, int call_w, const void* call_len,
                              const void* jump, int jump_w, const void* jump_len,
                              const void* rc, int rc_w, const void* rc_len,
                              const void* out_size, void* out, int out_cap, void* ok,
                              int n_lanes, void* stream) {
  if (n_lanes <= 0) return 0;
  if (main_w <= 0 || call_w <= 0 || jump_w <= 0 || rc_w <= 0 || out_cap <= 0)
    return (int)cudaErrorInvalidValue;
  bcj2_kernel<<<n_lanes, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)main, main_w, (const int32_t*)main_len, (const uint8_t*)call, call_w,
      (const int32_t*)call_len, (const uint8_t*)jump, jump_w, (const int32_t*)jump_len,
      (const uint8_t*)rc, rc_w, (const int32_t*)rc_len, (const int32_t*)out_size,
      (uint8_t*)out, out_cap, (int32_t*)ok);
  return (int)cudaGetLastError();
}
