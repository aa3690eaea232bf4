// SHA-256 (FIPS 180-4), from scratch — the owned counterpart of the
// reference's Sha256.c:25-59 surface (Init/Update/Final), exposed to
// Python through the same ctypes boundary as the codec runtime.
//
// The context is a flat 112-byte blob the caller allocates (8 u32 state
// words + u64 length + 64-byte block buffer + u32 fill), so the Python
// side needs no struct mirroring.

#include <cstdint>
#include <cstring>

namespace {

typedef uint8_t u8;
typedef uint32_t u32;
typedef uint64_t u64;

struct Ctx {
  u32 h[8];
  u64 total;
  u8 buf[64];
  u32 fill;
};

static_assert(sizeof(Ctx) <= 112, "ctx blob size");

const u32 K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

void compress(u32 h[8], const u8* p) {
  u32 w[64];
  for (int i = 0; i < 16; i++)
    w[i] = ((u32)p[4 * i] << 24) | ((u32)p[4 * i + 1] << 16) |
           ((u32)p[4 * i + 2] << 8) | p[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    const u32 s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    const u32 s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  u32 a = h[0], b = h[1], c = h[2], d = h[3];
  u32 e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int i = 0; i < 64; i++) {
    const u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const u32 ch = (e & f) ^ (~e & g);
    const u32 t1 = hh + S1 + ch + K[i] + w[i];
    const u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const u32 maj = (a & b) ^ (a & c) ^ (b & c);
    const u32 t2 = S0 + maj;
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// The caller-supplied blob is a plain byte array (ctypes/stack) with no
// alignment guarantee; Ctx holds a u64, so every entry point memcpys the
// context in/out of the blob instead of casting the pointer.

void ctx_init(Ctx& c) {
  static const u32 iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  std::memcpy(c.h, iv, sizeof(iv));
  c.total = 0;
  c.fill = 0;
}

void ctx_update(Ctx& c, const u8* data, size_t n) {
  c.total += n;
  if (c.fill) {
    const size_t take = (64 - c.fill < n) ? 64 - c.fill : n;
    std::memcpy(c.buf + c.fill, data, take);
    c.fill += (u32)take;
    data += take;
    n -= take;
    if (c.fill == 64) {
      compress(c.h, c.buf);
      c.fill = 0;
    }
  }
  while (n >= 64) {
    compress(c.h, data);
    data += 64;
    n -= 64;
  }
  if (n) {
    std::memcpy(c.buf, data, n);
    c.fill = (u32)n;
  }
}

void ctx_final(Ctx& c, u8 out[32]) {
  const u64 bits = c.total << 3;
  u8 pad[72];
  size_t pn = 0;
  pad[pn++] = 0x80;
  while ((c.total + pn) % 64 != 56) pad[pn++] = 0;
  for (int i = 7; i >= 0; i--) pad[pn++] = (u8)(bits >> (8 * i));
  ctx_update(c, pad, pn);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (u8)(c.h[i] >> 24);
    out[4 * i + 1] = (u8)(c.h[i] >> 16);
    out[4 * i + 2] = (u8)(c.h[i] >> 8);
    out[4 * i + 3] = (u8)c.h[i];
  }
}

}  // namespace

extern "C" {

void lzt_sha256_init(void* blob) {
  Ctx c;
  ctx_init(c);
  std::memcpy(blob, &c, sizeof(Ctx));
}

void lzt_sha256_update(void* blob, const u8* data, size_t n) {
  Ctx c;
  std::memcpy(&c, blob, sizeof(Ctx));
  ctx_update(c, data, n);
  std::memcpy(blob, &c, sizeof(Ctx));
}

void lzt_sha256_final(void* blob, u8 out[32]) {
  Ctx c;
  std::memcpy(&c, blob, sizeof(Ctx));
  ctx_final(c, out);
  std::memcpy(blob, &c, sizeof(Ctx));
}

void lzt_sha256(const u8* data, size_t n, u8 out[32]) {
  Ctx c;
  ctx_init(c);
  ctx_update(c, data, n);
  ctx_final(c, out);
}

}  // extern "C"
