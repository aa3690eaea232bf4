// Test-only CPU build of the per-lane code that group_decode.cu (K1) and
// range_encode.cu (K2) run on the GPU: the same lzma_lane.cuh and
// lzma_enc_lane.cuh, compiled by g++, looping over lanes on the host.
// tests/test_torch_group_decode.py and tests/test_torch_range_encode.py build
// it and hold it against the plain versions in ops/; the package never loads
// it.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libcpu_harness.so cpu_harness.cc

#include <stdint.h>

#include <vector>

#include "lzma_enc_lane.cuh"
#include "lzma_lane.cuh"

extern "C" int lzt_group_decode_cpu(const void* src, long long pack_cap,
                                    const void* pack_ends, const void* unpack_ends,
                                    const void* flags, int n_chunks,
                                    const void* active, void* out, long long dic_cap,
                                    void* ok, void* consumed, void* iterations,
                                    int n_lanes, int lc, int lp, int pb) {
  std::vector<uint16_t> probs(lzt::num_probs(lc, lp));
  for (int lane = 0; lane < n_lanes; ++lane) {
    int32_t* ok_l = (int32_t*)ok + lane;
    int32_t* consumed_l = (int32_t*)consumed + lane;
    int32_t* iters_l = (int32_t*)iterations + lane;
    if (!((const int32_t*)active)[lane]) {
      *ok_l = 1;
      *consumed_l = 0;
      *iters_l = 0;
      continue;
    }
    const int64_t t = (int64_t)lane * n_chunks;
    lzt::decode_lane((const uint8_t*)src + (int64_t)lane * pack_cap, pack_cap,
                     (const int32_t*)pack_ends + t, (const int32_t*)unpack_ends + t,
                     (const int32_t*)flags + t, n_chunks,
                     (uint8_t*)out + (int64_t)lane * dic_cap, dic_cap, probs.data(),
                     lc, lp, pb, ok_l, consumed_l, iters_l);
  }
  return 0;
}

// lzt_range_encode (range_encode.cu) on the host, same arguments but the
// stream.
extern "C" int lzt_range_encode_cpu(const void* ops, long long op_cap,
                                    const void* op_ends, int n_chunks,
                                    const void* active, void* out, long long out_cap,
                                    void* tab, void* ok, void* bytes, void* err,
                                    int n_lanes, int lc, int lp, int pb) {
  std::vector<uint16_t> probs(lzt::num_probs(lc, lp));
  for (int lane = 0; lane < n_lanes; ++lane) {
    int32_t* ok_l = (int32_t*)ok + lane;
    int32_t* bytes_l = (int32_t*)bytes + lane;
    int32_t* err_l = (int32_t*)err + lane;
    if (!((const int32_t*)active)[lane]) {
      *ok_l = 1;
      *bytes_l = 0;
      *err_l = 0;
      continue;
    }
    const int64_t t = (int64_t)lane * n_chunks;
    lzt::enc::encode_lane((const uint32_t*)ops + (int64_t)lane * op_cap, op_cap,
                          (const int32_t*)op_ends + t, n_chunks,
                          (uint8_t*)out + (int64_t)lane * out_cap, out_cap, probs.data(),
                          lc, lp, pb, (int32_t*)tab + t, ok_l, bytes_l, err_l);
  }
  return 0;
}

// n ShiftLows of lzma_enc_lane.cuh from a given coder state, per lane
// (low, cache, cache_size and bytes written are in/out; out_cap bytes of
// output per lane).  For the ShiftLow unit test.
extern "C" int lzt_shift_low_cpu(void* low, void* cache, void* cache_size, void* opos,
                                 void* err, void* out, long long out_cap, int n,
                                 int n_lanes) {
  for (int lane = 0; lane < n_lanes; ++lane) {
    lzt::enc::Coder C;
    C.out = (uint8_t*)out + (int64_t)lane * out_cap;
    C.cap = out_cap;
    C.opos = ((int64_t*)opos)[lane];
    C.probs = nullptr;
    C.low = ((uint64_t*)low)[lane];
    C.range = 0xFFFFFFFFu;
    C.cache = (uint32_t)((int64_t*)cache)[lane];
    C.cache_size = ((int64_t*)cache_size)[lane];
    C.err = (int)((int64_t*)err)[lane];
    for (int i = 0; i < n; ++i) lzt::enc::shift_low(C);
    ((uint64_t*)low)[lane] = C.low;
    ((int64_t*)cache)[lane] = C.cache;
    ((int64_t*)cache_size)[lane] = C.cache_size;
    ((int64_t*)opos)[lane] = C.opos;
    ((int64_t*)err)[lane] = C.err;
  }
  return 0;
}
