// X4's scanning filters on Hopper: x86 BCJ and BCJ2 decode over a batch of
// lanes.
//
// Replaces lzma_sdk_zliblike_tpu/ops/device_filters.py::x86_convert_batch
// and ::bcj2_decode_batch (plain XLA under jax.jit, no Pallas).  What they
// compute is unchanged, row for row (filters_lane.cuh).  The TPU versions
// are lax.while_loop scans that step every lane from one E8/E9 (or Jcc)
// candidate to the next in lockstep, a dozen vector operations per step.
//
// What bounds them on this card.  x86 is bound by its bytes (each lane
// read once and written once at 3.35 TB/s) once its scan is spread over
// threads: a block per lane stages the row through shared memory in 32 KiB
// tiles (16-byte loads and stores where the row allows) with a bitmap of
// the tile's E8/E9 bytes, and each of its 512 threads runs the sequential
// machine over the stretch between two sync points (filters_lane.cuh),
// patching an output copy of the tile.  A span without a sync point (E8/E9
// every 3 bytes has none) is run from each state it can be entered in and
// again from its true one, a few times the work of a span.  BCJ2 is bound
// by a chain: its range decoder steps serially, once per site.  One submit
// is five launches: blocks over
// each lane's main row count and then list its candidate sites in order
// (flags and a block scan per 8 KiB of staged main bytes), a pass turns
// the call and jump rows into BE words, one thread per lane walks the list
// with the probabilities in shared memory and its streams read ahead
// (through the read-only data cache), and blocks over each output row
// write every byte, zeros included, from the conversions before it.  The
// walk takes most of the time: one thread runs its loop at about 200 ns a
// site on an H100 (chip_smoke.py phase 18), several times the cost of the
// dependent bit calls alone.
//
// Built by ops/_build.py with nvcc for sm_90a into a shared library with a
// plain C interface; ops/device_filters.py calls lzt_x86_batch and
// lzt_bcj2_batch through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "filters_lane.cuh"

using namespace lzt::filt;

namespace {

constexpr int kX86Threads = 512;    // spans per tile
constexpr int kX86Tile = 32768;     // bytes of a row staged at a time
constexpr int kBcj2Threads = 512;   // threads of the listing and placing blocks
constexpr int kBcj2Tile = kBcj2Threads * kBcj2Seg;
constexpr int kBcj2Cap = bcj2_tile_cap(kBcj2Tile);

// n bytes from src to dst by the block: 16 bytes a thread where both ends
// and n allow it.
__device__ __forceinline__ void block_copy(uint8_t* dst, const uint8_t* src, int32_t n) {
  if ((((uintptr_t)dst | (uintptr_t)src | (uintptr_t)n) & 15) == 0) {
    for (int32_t i = threadIdx.x; i < n / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int32_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the sum.  `warp` holds one int per warp.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* warp, int32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int32_t s = lane < nw ? warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) warp[lane] = s;
  }
  __syncthreads();
  const int32_t excl = x - v + (w > 0 ? warp[w - 1] : 0);
  *total = warp[nw - 1];
  __syncthreads();
  return excl;
}

// A tile's shared state in x86_kernel (dynamic shared memory).
struct X86Tile {
  uint8_t in[kX86Tile];     // the staged input, never patched
  uint8_t out[kX86Tile];    // the output copy, patched
  uint32_t cm[kX86Tile / 32];   // the input's E8/E9 bytes
  int32_t start[kX86Threads + 1];
  uint8_t known[kX86Threads], key_out[kX86Threads], key_in[kX86Threads];
  uint8_t nkeys[kX86Threads];
  uint8_t keys[kX86Threads * kX86EntryKeys], exits[kX86Threads * kX86EntryKeys];
};

// A block per lane, a range per thread per tile (filters_lane.cuh: x86 in
// spans).  A range whose entry state is unknown (no sync point in its
// span) first tabulates its exit key for each possible entry; one thread
// chains the keys through the tile, and the range runs again from its
// entry state to patch.
__global__ void __launch_bounds__(kX86Threads)
    x86_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long row,
               const int32_t* __restrict__ valid, const int64_t* __restrict__ ip, int encoding) {
  extern __shared__ __align__(16) uint8_t smem[];
  X86Tile& sh = *reinterpret_cast<X86Tile*>(smem);
  __shared__ X86Scan carry;
  __shared__ X86Pending pend;
  __shared__ int32_t total;
  const int t = threadIdx.x;
  const int32_t R = (int32_t)row;
  const uint8_t* lin = in + blockIdx.x * row;
  uint8_t* lout = out + blockIdx.x * row;
  const int64_t limit = (int64_t)valid[blockIdx.x] - 4;
  const int32_t vend = x86_body_end(limit, R);
  const uint32_t ipl = (uint32_t)ip[blockIdx.x];
  const bool enc = encoding != 0;
  if (t == 0) {
    carry = x86_fresh(0);
    pend.n = 0;
    total = 0;
  }
  int32_t visits = 0;
  for (int32_t base = 0; base < R; base += kX86Tile) {
    const int32_t n = R - base < kX86Tile ? R - base : kX86Tile;
    block_copy(sh.in, lin + base, n);
    __syncthreads();   // also: the tile before handed on carry and pend
    block_copy(sh.out, sh.in, n);
    for (int32_t w = t; w < (n + 31) / 32; w += kX86Threads)
      sh.cm[w] = x86_cand_bits(sh.in + 32 * w, n - 32 * w < 32 ? n - 32 * w : 32);
    const X86Src src = {lin, sh.in, base, n, R - 1};
    const X86Start s0 = x86_span_start(src, t, kX86Threads, base, n);
    sh.start[t] = s0.s;
    sh.known[t] = s0.known;
    if (t == 0) sh.start[kX86Threads] = base + n;
    X86Scan st = x86_fresh(s0.s);
    X86Pending pd;
    if (t == 0) {
      st = carry;
      pd = pend;
      pend.n = 0;
    }
    // every start, bitmap word and output byte in place before any run
    const bool guessed = __syncthreads_or(!s0.known);
    const int32_t end = sh.start[t + 1];
    if (t == 0)
      for (int k = 0; k < pd.n; ++k) sh.out[pd.pos[k] - base] = pd.val[k];
    pd.n = 0;
    X86Put put = {sh.out, base, n, &pd};
    if (s0.s < end && s0.known) {
      visits += x86_span(src, sh.cm, put, st, end, vend, ipl, enc);
      sh.key_out[t] = (uint8_t)x86_state_key(st, end);
      if (end == base + n) carry = st;
      if (pd.n) pend = pd;   // one conversion at most reaches past a tile
    } else if (s0.s < end) {   // the exit key of each possible entry
      uint8_t* keys = sh.keys + t * kX86EntryKeys;
      const int nk = x86_entry_keys(src, s0.s, keys);
      sh.nkeys[t] = (uint8_t)nk;
      X86Drop drop;
      for (int j = 0; j < nk; ++j) {
        X86Scan e = x86_key_state(keys[j], s0.s);
        x86_span(src, sh.cm, drop, e, end, vend, ipl, enc);
        sh.exits[t * kX86EntryKeys + j] = (uint8_t)x86_state_key(e, end);
      }
    }
    if (guessed) {
      __syncthreads();
      if (t == 0)
        x86_chain_keys(src, sh.cm, sh.start, sh.known, sh.key_out, sh.nkeys, sh.keys, sh.exits,
                       sh.key_in, kX86Threads, vend, ipl, enc);
      __syncthreads();
      if (s0.s < end && !s0.known) {
        st = x86_key_state(sh.key_in[t], s0.s);
        visits += x86_span(src, sh.cm, put, st, end, vend, ipl, enc);
        if (end == base + n) carry = st;
        if (pd.n) pend = pd;
      }
    }
    if (base + n == R) {   // the last tile: the visits at p >= row - 1
      atomicAdd(&total, visits);
      __syncthreads();
      if (t == 0) {
        X86Put last = {sh.out, base, n, &pd};
        x86_tail(lin, R, limit, ipl, enc, carry, total, last);
      }
    }
    __syncthreads();
    block_copy(lout + base, sh.out, n);
    __syncthreads();
  }
}

// The candidate flags of thread t's kBcj2Seg main bytes of the chunk at
// base (n bytes, staged in buf + 16, the byte before in buf[15]).
__device__ __forceinline__ uint32_t seg_flags(const uint8_t* buf, int32_t base, int32_t n) {
  const int32_t j0 = threadIdx.x * kBcj2Seg;
  const int32_t cnt = n - j0 < kBcj2Seg ? n - j0 : kBcj2Seg;
  return cnt > 0 ? bcj2_seg_flags(buf + 16 + j0, base + j0, cnt) : 0;
}

// Stages main bytes base..base+n-1 of row m, and the one before, into buf.
__device__ __forceinline__ void stage_main(uint8_t* buf, const uint8_t* m, int32_t base,
                                           int32_t n) {
  block_copy(buf + 16, m + base, n);
  if (threadIdx.x == 0) buf[15] = base > 0 ? m[base - 1] : 0;
  __syncthreads();
}

// BCJ2 1a: a block per chunk of kBcj2Tile main bytes of a lane counts its
// candidate sites into info[lane][4 + chunk].
__global__ void __launch_bounds__(kBcj2Threads)
    bcj2_count_kernel(const uint8_t* __restrict__ main, int main_w,
                      const int32_t* __restrict__ main_len, int32_t* __restrict__ info,
                      int info_w) {
  __shared__ __align__(16) uint8_t buf[16 + kBcj2Tile];
  __shared__ int32_t total;
  const int32_t base = blockIdx.x * kBcj2Tile;
  const int32_t end = main_end_of(main_len[blockIdx.y], main_w);
  int32_t* inf = info + (long long)blockIdx.y * info_w;
  if (threadIdx.x == 0) total = 0;
  if (base >= end) {
    if (threadIdx.x == 0) inf[4 + blockIdx.x] = 0;
    return;
  }
  const int32_t n = end - base < kBcj2Tile ? end - base : kBcj2Tile;
  stage_main(buf, main + (long long)blockIdx.y * main_w, base, n);
  const int c = popc32(seg_flags(buf, base, n));
  if (c) atomicAdd(&total, c);
  __syncthreads();
  if (threadIdx.x == 0) inf[4 + blockIdx.x] = total;
}

// BCJ2 1b: the same blocks list their candidates in order into cand, after
// the counts of the chunks before; the last chunk's block writes the
// lane's count to info[lane][0].
__global__ void __launch_bounds__(kBcj2Threads)
    bcj2_list_kernel(const uint8_t* __restrict__ main, int main_w,
                     const int32_t* __restrict__ main_len, Bcj2Entry* __restrict__ cand,
                     int32_t* __restrict__ info, int info_w) {
  __shared__ __align__(16) uint8_t buf[16 + kBcj2Tile];
  __shared__ int32_t warp[32];
  const int t = threadIdx.x;
  const int32_t base = blockIdx.x * kBcj2Tile;
  const int32_t end = main_end_of(main_len[blockIdx.y], main_w);
  int32_t* inf = info + (long long)blockIdx.y * info_w;
  const int32_t nchunk = (end + kBcj2Tile - 1) / kBcj2Tile;
  if (end == 0 && blockIdx.x == 0 && t == 0) inf[0] = 0;
  if (base >= end) return;
  int32_t part = 0, before, total;   // the sites of the chunks before
  for (int32_t k = t; k < (int32_t)blockIdx.x; k += kBcj2Threads) part += inf[4 + k];
  block_scan(part, warp, &before);
  const int32_t n = end - base < kBcj2Tile ? end - base : kBcj2Tile;
  stage_main(buf, main + (long long)blockIdx.y * main_w, base, n);
  const uint32_t f = seg_flags(buf, base, n);
  const int32_t off = block_scan(popc32(f), warp, &total);
  if (f)
    bcj2_seg_write(buf + 16 + t * kBcj2Seg, base + t * kBcj2Seg, f,
                   cand + (long long)blockIdx.y * main_w + before + off);
  if (t == 0 && (int32_t)blockIdx.x == nchunk - 1) inf[0] = before + total;
}

// BCJ2 1c: the call and jump rows as BE words for the walk (bcj2_words):
// words[lane] holds bcj2_words(call_w) call words, then bcj2_words(jump_w)
// jump words.
__global__ void __launch_bounds__(kBcj2Threads)
    bcj2_words_kernel(const uint8_t* __restrict__ call, int call_w,
                      const uint8_t* __restrict__ jump, int jump_w, uint32_t* __restrict__ words,
                      int words_w) {
  const int32_t k = blockIdx.x * kBcj2Threads + threadIdx.x;
  const long long s = blockIdx.y;
  const int32_t nc = bcj2_words(call_w);
  if (k < nc) words[s * words_w + k] = be32(call + s * call_w, call_w, 4 * k);
  if (k < bcj2_words(jump_w))
    words[s * words_w + nc + k] = be32(jump + s * jump_w, jump_w, 4 * k);
}

// BCJ2 2: a block of one thread per lane walks its list (bcj2_walk, the
// probabilities in shared memory), writing the conversions over it, and
// info[lane][1..3] = conversions, decoder steps, ok; ok[lane] = ok.
__global__ void __launch_bounds__(1)
    bcj2_walk_kernel(const uint8_t* main, int main_w, const int32_t* main_len,
                     const uint8_t* call, int call_w, const int32_t* call_len,
                     const uint8_t* jump, int jump_w, const int32_t* jump_len, const uint8_t* rc,
                     int rc_w, const int32_t* rc_len, const int32_t* out_size, Bcj2Entry* cand,
                     const uint32_t* words, int words_w, int32_t* info, int info_w,
                     int32_t* ok) {
  __shared__ uint16_t probs[kBcj2Probs];
  const long long s = blockIdx.x;
  const Bcj2Lane L = {main + s * main_w, main_w,      main_len[s], call + s * call_w, call_w,
                      call_len[s],       jump + s * jump_w, jump_w, jump_len[s],
                      rc + s * rc_w,     rc_w,        rc_len[s],   out_size[s]};
  Bcj2Entry* list = cand + s * main_w;
  int32_t* inf = info + s * info_w;
  const uint32_t* cw = words + s * words_w;
  const Bcj2Streams in = {list, cw, cw + bcj2_words(call_w), &L};
  auto put = [list](int32_t k, Bcj2Entry e) { list[k] = e; };
  const Bcj2Walk r = bcj2_walk(L, probs, in, inf[0], put);
  inf[1] = r.nconv;
  inf[2] = r.steps;
  inf[3] = r.ok;
  ok[s] = r.ok;
}

struct OutPut {
  uint8_t* v;   // a thread's kBcj2Seg bytes, from o0
  int32_t o0;
  __device__ __forceinline__ void operator()(int32_t o, uint8_t b) { v[o - o0] = b; }
};

// BCJ2 3: a block per kBcj2Tile output bytes of a lane writes them,
// kBcj2Seg a thread, from the conversions the walk listed (zeros on a lane
// that is not ok): the block finds the first conversion that can reach
// its bytes (Bcj2Search) and stages that and the next ones.
__global__ void __launch_bounds__(kBcj2Threads)
    bcj2_place_kernel(const uint8_t* __restrict__ main, int main_w,
                      const int32_t* __restrict__ main_len, const int32_t* __restrict__ out_size,
                      const Bcj2Entry* __restrict__ cand, const int32_t* __restrict__ info,
                      int info_w, uint8_t* __restrict__ out, int out_cap) {
  __shared__ int32_t site[kBcj2Cap];
  __shared__ uint32_t rel[kBcj2Cap];
  const int t = threadIdx.x;
  const long long s = blockIdx.y;
  const int32_t tb = blockIdx.x * kBcj2Tile;
  const uint8_t* m = main + s * main_w;
  const Bcj2Entry* list = cand + s * main_w;
  const int32_t* inf = info + s * info_w;
  uint8_t* row = out + s * out_cap;
  const bool ok = inf[3] != 0;
  const int32_t nconv = ok ? inf[1] : 0;
  const int32_t main_end = main_end_of(main_len[s], main_w);
  const int32_t used = out_size[s] - 4 * nconv;
  const int32_t main_lim = !ok ? 0 : used < main_end ? used : main_end;
  Bcj2Search q = {0, nconv, 1};
  while (!q.done()) {
    const int32_t k = q.probe(t, kBcj2Threads);
    q.update(__syncthreads_count(k >= 0 && (int32_t)list[k].a < tb - 4));
  }
  const int32_t kbase = q.lo;
  const int32_t nload = nconv - kbase < kBcj2Cap ? nconv - kbase : kBcj2Cap;
  for (int32_t i = t; i < nload; i += kBcj2Threads) {
    const Bcj2Entry e = list[kbase + i];
    site[i] = (int32_t)e.a;
    rel[i] = e.b;
  }
  __syncthreads();
  const int32_t o0 = tb + t * kBcj2Seg;
  if (o0 >= out_cap) return;
  const int32_t o1 = out_cap - o0 < kBcj2Seg ? out_cap : o0 + kBcj2Seg;
  __align__(16) uint8_t v[kBcj2Seg];
  OutPut put = {v, o0};
  bcj2_place_run(o0, o1, site, rel, nload, kbase, m, main_lim, put);
  if ((((uintptr_t)row | (uintptr_t)out_cap) & 15) == 0)
    *reinterpret_cast<uint4*>(row + o0) = *reinterpret_cast<const uint4*>(v);
  else
    for (int32_t o = o0; o < o1; ++o) row[o] = v[o - o0];
}

}  // namespace

// Launches x86 BCJ on `stream` without synchronising: in and out are
// [n_lanes, row] uint8 (out written whole), valid int32 and ip int64
// (uint32 values) per lane.  Returns the CUDA error code (0 = launched).
extern "C" int lzt_x86_batch(const void* in, void* out, long long row, const void* valid,
                             const void* ip, int n_lanes, int encoding, void* stream) {
  if (n_lanes <= 0) return 0;
  if (row <= 0 || row >= (1ll << 31) - 16) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      x86_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(X86Tile));
  if (e != cudaSuccess) return (int)e;
  x86_kernel<<<n_lanes, kX86Threads, sizeof(X86Tile), (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, row, (const int32_t*)valid, (const int64_t*)ip, encoding);
  return (int)cudaGetLastError();
}

// Launches BCJ2 decode on `stream` without synchronising, as five
// launches: the four streams are [n_lanes, *_w] uint8 rows with int32
// lengths, out_size int32 per lane, out [n_lanes, out_cap] uint8 (written
// whole), ok int32 per lane; cand is scratch of n_lanes * main_w 8-byte
// entries, words of n_lanes * words_w uint32 (words_w >=
// lzt_bcj2_words(call_w, jump_w)), info int32 [n_lanes, info_w]
// (candidates, conversions, decoder steps, ok, then a count per chunk of
// main bytes: info_w >= 4 + lzt_bcj2_chunks(main_w)).  Returns the first
// CUDA error code (0 = launched).
extern "C" int lzt_bcj2_chunks(int main_w) { return (main_w + kBcj2Tile - 1) / kBcj2Tile; }

extern "C" int lzt_bcj2_words(int call_w, int jump_w) {
  return bcj2_words(call_w) + bcj2_words(jump_w);
}

extern "C" int lzt_bcj2_batch(const void* main, int main_w, const void* main_len,
                              const void* call, int call_w, const void* call_len,
                              const void* jump, int jump_w, const void* jump_len,
                              const void* rc, int rc_w, const void* rc_len,
                              const void* out_size, void* out, int out_cap, void* ok,
                              void* cand, void* words, int words_w, void* info, int info_w,
                              int n_lanes, void* stream) {
  if (n_lanes <= 0) return 0;
  if (main_w <= 0 || call_w <= 0 || jump_w <= 0 || rc_w <= 0 || out_cap <= 0 ||
      info_w < 4 + lzt_bcj2_chunks(main_w) || words_w < lzt_bcj2_words(call_w, jump_w) ||
      n_lanes > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 chunks(lzt_bcj2_chunks(main_w), n_lanes);
  bcj2_count_kernel<<<chunks, kBcj2Threads, 0, st>>>(
      (const uint8_t*)main, main_w, (const int32_t*)main_len, (int32_t*)info, info_w);
  bcj2_list_kernel<<<chunks, kBcj2Threads, 0, st>>>(
      (const uint8_t*)main, main_w, (const int32_t*)main_len, (Bcj2Entry*)cand, (int32_t*)info,
      info_w);
  const int32_t nw = bcj2_words(call_w > jump_w ? call_w : jump_w);
  bcj2_words_kernel<<<dim3((nw + kBcj2Threads - 1) / kBcj2Threads, n_lanes), kBcj2Threads, 0,
                      st>>>((const uint8_t*)call, call_w, (const uint8_t*)jump, jump_w,
                            (uint32_t*)words, words_w);
  int rc_ = (int)cudaGetLastError();
  if (rc_ != 0) return rc_;
  bcj2_walk_kernel<<<n_lanes, 1, 0, st>>>(
      (const uint8_t*)main, main_w, (const int32_t*)main_len, (const uint8_t*)call, call_w,
      (const int32_t*)call_len, (const uint8_t*)jump, jump_w, (const int32_t*)jump_len,
      (const uint8_t*)rc, rc_w, (const int32_t*)rc_len, (const int32_t*)out_size,
      (Bcj2Entry*)cand, (const uint32_t*)words, words_w, (int32_t*)info, info_w, (int32_t*)ok);
  rc_ = (int)cudaGetLastError();
  if (rc_ != 0) return rc_;
  bcj2_place_kernel<<<dim3((out_cap + kBcj2Tile - 1) / kBcj2Tile, n_lanes), kBcj2Threads, 0,
                      st>>>((const uint8_t*)main, main_w, (const int32_t*)main_len,
                            (const int32_t*)out_size, (const Bcj2Entry*)cand,
                            (const int32_t*)info, info_w, (uint8_t*)out, out_cap);
  return (int)cudaGetLastError();
}
