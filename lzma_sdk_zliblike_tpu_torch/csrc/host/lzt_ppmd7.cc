// Native PPMd var.H (PPMd7) codec — 7z method 0x030401.
//
// C++ port of the validated Python implementation in
// lzma_sdk_zliblike_tpu/models/ppmd7/codec.py (itself bit-exact with the
// reference Ppmd7.c/Ppmd7Dec.c/Ppmd7Enc.c, based on Shkarin's public-domain
// PPMd var.H).  The model is a suffix tree of contexts in a hand-managed
// pool whose address arithmetic is semantically meaningful, so the pool is
// a flat byte array and every reference is a u32 offset — exactly the
// reference's non-PPMD_32BIT representation (Ppmd7.c:22-28).
//
// Exported C API (ctypes): lzt_ppmd7_decode / lzt_ppmd7_encode.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;

constexpr int kIntBits = 7;
constexpr int kPeriodBits = 7;
constexpr u32 kBinScale = 1u << (kIntBits + kPeriodBits);
constexpr u32 kMaxFreq = 124;
constexpr u32 kUnit = 12;
constexpr int kNIndexes = 38;
constexpr u32 kTop = 1u << 24;

constexpr u16 kInitBinEsc[8] = {0x3CDD, 0x1F3F, 0x59BF, 0x48F3,
                                0x64A1, 0x5ABC, 0x6632, 0x6051};
constexpr u8 kExpEscape[16] = {25, 14, 9, 7, 5, 5, 4, 4,
                               4, 3, 3, 3, 2, 2, 2, 2};

inline u32 Mean(u32 summ) {
  return (summ + (1u << (kPeriodBits - 2))) >> kPeriodBits;
}

constexpr int ERR_OK = 0;
constexpr int ERR_PARAM = -4;
constexpr int ERR_DATA = -1;
constexpr int ERR_CAP = -90;

struct Ppmd7 {
  int max_order;
  u32 size, align_offset;
  std::vector<u8> pool;

  u32 i2u[kNIndexes];
  u8 u2i[128];
  u8 ns2bs[256];
  u8 ns2i[256];
  u8 hb2flag[256];

  u16 see_summ[25][16];
  u8 see_shift[25][16];
  u16 see_count[25][16];
  u16 bin_summ[128][64];

  u32 free_list[kNIndexes];
  u32 text, hi_unit, lo_unit, units_start;
  u32 glue_count;
  int order_fall;
  int init_rl, run_length;
  u32 prev_success, init_esc, hi_bits_flag;
  u32 min_ctx, max_ctx, found;

  // --- pool accessors ---
  u8 r8(u32 a) const { return pool[a]; }
  void w8(u32 a, u32 v) { pool[a] = (u8)v; }
  u16 r16(u32 a) const { u16 v; std::memcpy(&v, &pool[a], 2); return v; }
  void w16(u32 a, u32 v) { u16 t = (u16)v; std::memcpy(&pool[a], &t, 2); }
  u32 r32(u32 a) const { u32 v; std::memcpy(&v, &pool[a], 4); return v; }
  void w32(u32 a, u32 v) { std::memcpy(&pool[a], &v, 4); }

  // context fields: NumStats u16, SummFreq u16, Stats u32, Suffix u32
  u32 ns(u32 c) const { return r16(c); }
  void set_ns(u32 c, u32 v) { w16(c, v); }
  u32 summ(u32 c) const { return r16(c + 2); }
  void set_summ(u32 c, u32 v) { w16(c + 2, v); }
  u32 stats(u32 c) const { return r32(c + 4); }
  void set_stats(u32 c, u32 v) { w32(c + 4, v); }
  u32 suffix(u32 c) const { return r32(c + 8); }
  void set_suffix(u32 c, u32 v) { w32(c + 8, v); }
  u32 one_state(u32 c) const { return c + 2; }

  // state fields (6 bytes): Symbol, Freq, Successor (u16 lo, u16 hi)
  u8 sym(u32 s) const { return pool[s]; }
  void set_sym(u32 s, u32 v) { pool[s] = (u8)v; }
  u8 freq(u32 s) const { return pool[s + 1]; }
  void set_freq(u32 s, u32 v) { pool[s + 1] = (u8)v; }
  u32 succ(u32 s) const { return (u32)r16(s + 2) | ((u32)r16(s + 4) << 16); }
  void set_succ(u32 s, u32 v) {
    w16(s + 2, v & 0xFFFF);
    w16(s + 4, (v >> 16) & 0xFFFF);
  }
  void copy_state(u32 dst, u32 src) {
    std::memmove(&pool[dst], &pool[src], 6);
  }
  void swap_states(u32 a, u32 b) {
    u8 tmp[6];
    std::memcpy(tmp, &pool[a], 6);
    std::memcpy(&pool[a], &pool[b], 6);
    std::memcpy(&pool[b], tmp, 6);
  }

  // --- sub-allocator (Ppmd7.c:118-258) ---
  void insert_node(u32 node, int indx) {
    w32(node, free_list[indx]);
    free_list[indx] = node;
  }
  u32 remove_node(int indx) {
    u32 node = free_list[indx];
    free_list[indx] = r32(node);
    return node;
  }
  void split_block(u32 ptr, int old_i, int new_i) {
    u32 nu = i2u[old_i] - i2u[new_i];
    ptr += i2u[new_i] * kUnit;
    int i = u2i[nu - 1];
    if (i2u[i] != nu) {
      i -= 1;
      u32 k = i2u[i];
      insert_node(ptr + k * kUnit, (int)(nu - k - 1));
    }
    insert_node(ptr, i);
  }
  // node record (12B): Stamp u16 @0, NU u16 @2, Next u32 @4, Prev u32 @8
  void glue_free_blocks() {
    u32 head = align_offset + size;
    u32 n = head;
    glue_count = 255;
    for (int i = 0; i < kNIndexes; i++) {
      u32 nu = i2u[i];
      u32 nxt = free_list[i];
      free_list[i] = 0;
      while (nxt != 0) {
        u32 node = nxt;
        u32 nxt2 = r32(node);
        w32(node + 4, n);
        w32(n + 8, node);
        n = node;
        w16(node, 0);
        w16(node + 2, nu);
        nxt = nxt2;
      }
    }
    w16(head, 1);
    w32(head + 4, n);
    w32(n + 8, head);
    if (lo_unit != hi_unit) w16(lo_unit, 1);
    n = r32(head + 4);
    while (n != head) {
      u32 nu = r16(n + 2);
      for (;;) {
        u32 node2 = n + nu * kUnit;
        u32 nu2 = r16(node2 + 2);
        if (r16(node2) != 0 || nu + nu2 >= 0x10000) break;
        u32 prev2 = r32(node2 + 8);
        u32 next2 = r32(node2 + 4);
        w32(prev2 + 4, next2);
        w32(next2 + 8, prev2);
        nu += nu2;
        w16(n + 2, nu);
      }
      n = r32(n + 4);
    }
    n = r32(head + 4);
    while (n != head) {
      u32 nxt = r32(n + 4);
      u32 nu = r16(n + 2);
      u32 node = n;
      while (nu > 128) {
        insert_node(node, kNIndexes - 1);
        nu -= 128;
        node += 128 * kUnit;
      }
      int i = u2i[nu - 1];
      if (i2u[i] != nu) {
        i -= 1;
        u32 k = i2u[i];
        insert_node(node + k * kUnit, (int)(nu - k - 1));
      }
      insert_node(node, i);
      n = nxt;
    }
  }
  u32 alloc_units_rare(int indx) {
    if (glue_count == 0) {
      glue_free_blocks();
      if (free_list[indx] != 0) return remove_node(indx);
    }
    int i = indx;
    for (;;) {
      i += 1;
      if (i == kNIndexes) {
        u32 num_bytes = i2u[indx] * kUnit;
        glue_count -= 1;
        if (units_start - text > num_bytes) {
          units_start -= num_bytes;
          return units_start;
        }
        return 0;
      }
      if (free_list[i] != 0) break;
    }
    u32 ret = remove_node(i);
    split_block(ret, i, indx);
    return ret;
  }
  u32 alloc_units(int indx) {
    if (free_list[indx] != 0) return remove_node(indx);
    u32 num_bytes = i2u[indx] * kUnit;
    if (num_bytes <= hi_unit - lo_unit) {
      u32 ret = lo_unit;
      lo_unit += num_bytes;
      return ret;
    }
    return alloc_units_rare(indx);
  }
  void mem12cpy(u32 dst, u32 src, u32 nu) {
    std::memmove(&pool[dst], &pool[src], nu * kUnit);
  }
  u32 shrink_units(u32 old_ptr, u32 old_nu, u32 new_nu) {
    int i0 = u2i[old_nu - 1];
    int i1 = u2i[new_nu - 1];
    if (i0 == i1) return old_ptr;
    if (free_list[i1] != 0) {
      u32 ptr = remove_node(i1);
      mem12cpy(ptr, old_ptr, new_nu);
      insert_node(old_ptr, i0);
      return ptr;
    }
    split_block(old_ptr, i0, i1);
    return old_ptr;
  }

  // --- construct + restart ---
  void construct(int order, u32 mem_size) {
    max_order = order;
    size = mem_size;
    align_offset = 4 - (mem_size & 3);
    pool.assign(align_offset + mem_size + kUnit, 0);

    int k = 0;
    for (int i = 0; i < kNIndexes; i++) {
      int step = (i >= 12) ? 4 : (i >> 2) + 1;
      for (int j = 0; j < step; j++) u2i[k++] = (u8)i;
      i2u[i] = (u32)k;
    }
    ns2bs[0] = 0;
    ns2bs[1] = 2;
    for (int i = 2; i < 11; i++) ns2bs[i] = 4;
    for (int i = 11; i < 256; i++) ns2bs[i] = 6;
    ns2i[0] = 0;
    ns2i[1] = 1;
    ns2i[2] = 2;
    {
      int m = 3, kk = 1;
      for (int i = 3; i < 256; i++) {
        ns2i[i] = (u8)m;
        if (--kk == 0) {
          m += 1;
          kk = m - 2;
        }
      }
    }
    for (int i = 0; i < 0x40; i++) hb2flag[i] = 0;
    for (int i = 0x40; i < 0x100; i++) hb2flag[i] = 8;
    restart();
  }

  void restart() {
    std::memset(free_list, 0, sizeof(free_list));
    text = align_offset;
    hi_unit = text + size;
    lo_unit = units_start = hi_unit - size / 8 / kUnit * 7 * kUnit;
    glue_count = 0;

    order_fall = max_order;
    init_rl = -(max_order < 12 ? max_order : 12) - 1;
    run_length = init_rl;
    prev_success = 0;
    init_esc = 0;
    hi_bits_flag = 0;

    hi_unit -= kUnit;
    min_ctx = max_ctx = hi_unit;
    u32 c = min_ctx;
    set_suffix(c, 0);
    set_ns(c, 256);
    set_summ(c, 256 + 1);
    found = lo_unit;
    lo_unit += (256 / 2) * kUnit;
    set_stats(c, found);
    for (u32 i = 0; i < 256; i++) {
      u32 s = found + 6 * i;
      set_sym(s, i);
      set_freq(s, 1);
      set_succ(s, 0);
    }
    for (int i = 0; i < 128; i++)
      for (int kk = 0; kk < 8; kk++) {
        u16 val = (u16)(kBinScale - kInitBinEsc[kk] / (u32)(i + 2));
        for (int m = 0; m < 64; m += 8) bin_summ[i][kk + m] = val;
      }
    for (int i = 0; i < 25; i++)
      for (int kk = 0; kk < 16; kk++) {
        see_summ[i][kk] = (u16)((5 * i + 10) << (kPeriodBits - 4));
        see_shift[i][kk] = kPeriodBits - 4;
        see_count[i][kk] = 4;
      }
  }

  // --- CreateSuccessors (Ppmd7.c:340-410) ---
  u32 create_successors(bool skip) {
    u32 c = min_ctx;
    u32 up_branch = succ(found);
    u32 ps[64];
    int nps = 0;
    if (!skip) ps[nps++] = found;
    while (suffix(c)) {
      c = suffix(c);
      u32 s;
      if (ns(c) != 1) {
        s = stats(c);
        u8 fs_sym = sym(found);
        while (sym(s) != fs_sym) s += 6;
      } else {
        s = one_state(c);
      }
      u32 successor = succ(s);
      if (successor != up_branch) {
        c = successor;
        if (nps == 0) return c;
        break;
      }
      ps[nps++] = s;
    }

    u8 up_sym = pool[up_branch];
    u32 up_succ = up_branch + 1;
    u32 up_freq;
    if (ns(c) == 1) {
      up_freq = freq(one_state(c));
    } else {
      u32 s = stats(c);
      while (sym(s) != up_sym) s += 6;
      u32 cf = (u32)freq(s) - 1;
      u32 s0 = summ(c) - ns(c) - cf;
      up_freq = 1 + ((2 * cf <= s0) ? (u32)(5 * cf > s0)
                                    : ((2 * cf + 3 * s0 - 1) / (2 * s0)));
    }

    for (;;) {
      u32 c1;
      if (hi_unit != lo_unit) {
        hi_unit -= kUnit;
        c1 = hi_unit;
      } else if (free_list[0] != 0) {
        c1 = remove_node(0);
      } else {
        c1 = alloc_units_rare(0);
        if (!c1) return 0;
      }
      set_ns(c1, 1);
      u32 os = one_state(c1);
      set_sym(os, up_sym);
      set_freq(os, up_freq);
      set_succ(os, up_succ);
      set_suffix(c1, c);
      set_succ(ps[--nps], c1);
      c = c1;
      if (nps == 0) break;
    }
    return c;
  }

  // --- UpdateModel (Ppmd7.c:421-568) ---
  void update_model() {
    u32 f_succ = succ(found);
    u8 fs_sym = sym(found);
    u32 fs_freq = freq(found);

    if (fs_freq < kMaxFreq / 4 && suffix(min_ctx) != 0) {
      u32 c = suffix(min_ctx);
      if (ns(c) == 1) {
        u32 s = one_state(c);
        if (freq(s) < 32) set_freq(s, freq(s) + 1);
      } else {
        u32 s = stats(c);
        if (sym(s) != fs_sym) {
          do {
            s += 6;
          } while (sym(s) != fs_sym);
          if (freq(s) >= freq(s - 6)) {
            swap_states(s, s - 6);
            s -= 6;
          }
        }
        if (freq(s) < kMaxFreq - 9) {
          set_freq(s, freq(s) + 2);
          set_summ(c, summ(c) + 2);
        }
      }
    }

    if (order_fall == 0) {
      u32 nc = create_successors(true);
      if (nc == 0) {
        restart();
        return;
      }
      min_ctx = max_ctx = nc;
      set_succ(found, nc);
      return;
    }

    pool[text] = fs_sym;
    text += 1;
    u32 successor = text;
    if (text >= units_start) {
      restart();
      return;
    }

    if (f_succ) {
      if (f_succ <= successor) {
        u32 cs = create_successors(false);
        if (cs == 0) {
          restart();
          return;
        }
        f_succ = cs;
      }
      order_fall -= 1;
      if (order_fall == 0) {
        successor = f_succ;
        if (max_ctx != min_ctx) text -= 1;
      }
    } else {
      set_succ(found, successor);
      f_succ = min_ctx;
    }

    u32 nsv = ns(min_ctx);
    u32 s0 = summ(min_ctx) - nsv - (fs_freq - 1);

    u32 c = max_ctx;
    while (c != min_ctx) {
      u32 ns1 = ns(c);
      if (ns1 != 1) {
        if ((ns1 & 1) == 0) {
          u32 old_nu = ns1 >> 1;
          int i = u2i[old_nu - 1];
          if (i != u2i[old_nu]) {
            u32 ptr = alloc_units(i + 1);
            if (!ptr) {
              restart();
              return;
            }
            u32 old_ptr = stats(c);
            mem12cpy(ptr, old_ptr, old_nu);
            insert_node(old_ptr, i);
            set_stats(c, ptr);
          }
        }
        u32 sf_add = (u32)(2 * ns1 < nsv) +
                     2 * (u32)((4 * ns1 <= nsv) && (summ(c) <= 8 * ns1));
        set_summ(c, summ(c) + sf_add);
      } else {
        u32 s = alloc_units(0);
        if (!s) {
          restart();
          return;
        }
        copy_state(s, one_state(c));
        set_stats(c, s);
        u32 fr = freq(s);
        if (fr < kMaxFreq / 4 - 1)
          set_freq(s, fr << 1);
        else
          set_freq(s, kMaxFreq - 4);
        set_summ(c, freq(s) + init_esc + (u32)(nsv > 3));
      }
      u32 cf = 2 * fs_freq * (summ(c) + 6);
      u32 sf = s0 + summ(c);
      if (cf < 6 * sf) {
        cf = 1 + (u32)(cf > sf) + (u32)(cf >= 4 * sf);
        set_summ(c, summ(c) + 3);
      } else {
        cf = 4 + (u32)(cf >= 9 * sf) + (u32)(cf >= 12 * sf) +
             (u32)(cf >= 15 * sf);
        set_summ(c, summ(c) + cf);
      }
      u32 s = stats(c) + ns1 * 6;
      set_succ(s, successor);
      set_sym(s, fs_sym);
      set_freq(s, cf);
      set_ns(c, ns1 + 1);
      c = suffix(c);
    }
    max_ctx = min_ctx = f_succ;
  }

  // --- Rescale (Ppmd7.c:570-632) ---
  void rescale() {
    u32 statsp = stats(min_ctx);
    u32 s = found;
    if (s != statsp) {
      u8 tmp[6];
      std::memcpy(tmp, &pool[s], 6);
      while (s != statsp) {
        copy_state(s, s - 6);
        s -= 6;
      }
      std::memcpy(&pool[statsp], tmp, 6);
    }
    s = statsp;
    u32 esc_freq = summ(min_ctx) - freq(s);
    set_freq(s, freq(s) + 4);
    u32 adder = (order_fall != 0) ? 1 : 0;
    set_freq(s, (freq(s) + adder) >> 1);
    u32 sum_freq = freq(s);
    u32 i = ns(min_ctx) - 1;
    while (i) {
      s += 6;
      esc_freq -= freq(s);
      set_freq(s, (freq(s) + adder) >> 1);
      sum_freq += freq(s);
      if (freq(s) > freq(s - 6)) {
        u32 s1 = s;
        u8 tmp[6];
        std::memcpy(tmp, &pool[s1], 6);
        u8 tmp_freq = tmp[1];
        for (;;) {
          copy_state(s1, s1 - 6);
          s1 -= 6;
          if (s1 == statsp || tmp_freq <= freq(s1 - 6)) break;
        }
        std::memcpy(&pool[s1], tmp, 6);
      }
      i -= 1;
    }
    if (freq(s) == 0) {
      u32 num_stats = ns(min_ctx);
      u32 cnt = 0;
      do {
        cnt += 1;
        s -= 6;
      } while (freq(s) == 0);
      esc_freq += cnt;
      set_ns(min_ctx, num_stats - cnt);
      if (ns(min_ctx) == 1) {
        u8 tmp[6];
        std::memcpy(tmp, &pool[statsp], 6);
        do {
          tmp[1] = (u8)(tmp[1] - (tmp[1] >> 1));
          esc_freq >>= 1;
        } while (esc_freq > 1);
        insert_node(statsp, u2i[((num_stats + 1) >> 1) - 1]);
        found = one_state(min_ctx);
        std::memcpy(&pool[found], tmp, 6);
        return;
      }
      u32 n0 = (num_stats + 1) >> 1;
      u32 n1 = (ns(min_ctx) + 1) >> 1;
      if (n0 != n1) set_stats(min_ctx, shrink_units(statsp, n0, n1));
    }
    set_summ(min_ctx, sum_freq + esc_freq - (esc_freq >> 1));
    found = stats(min_ctx);
  }

  // --- MakeEscFreq (Ppmd7.c:634-660).  see_idx: r*16+c, or -1 ---
  int make_esc_freq(u32 num_masked, u32* esc_out) {
    u32 mc = min_ctx;
    u32 nsv = ns(mc);
    u32 non_masked = nsv - num_masked;
    if (nsv != 256) {
      u32 sfx = suffix(mc);
      int r_idx = ns2i[non_masked - 1];
      u32 diff = (u32)(ns(sfx) - nsv);  // unsigned wrap intended
      int c_idx = (int)((u32)(non_masked < diff) +
                        2u * (u32)(summ(mc) < 11 * nsv) +
                        4u * (u32)(num_masked > non_masked) + hi_bits_flag);
      u32 r = (u32)(see_summ[r_idx][c_idx] >> see_shift[r_idx][c_idx]);
      see_summ[r_idx][c_idx] = (u16)(see_summ[r_idx][c_idx] - r);
      *esc_out = r + (u32)(r == 0);
      return r_idx * 16 + c_idx;
    }
    *esc_out = 1;
    return -1;
  }
  void see_update(int see) {
    if (see < 0) return;
    int r = see / 16, c = see % 16;
    if (see_shift[r][c] < kPeriodBits) {
      if (--see_count[r][c] == 0) {
        see_summ[r][c] = (u16)(see_summ[r][c] << 1);
        see_count[r][c] = (u16)(3 << see_shift[r][c]);
        see_shift[r][c] += 1;
      }
    }
  }

  // --- per-symbol updates (Ppmd7.c:662-708) ---
  void next_context() {
    u32 c = succ(found);
    if (order_fall == 0 && c > text) {
      min_ctx = max_ctx = c;
    } else {
      update_model();
    }
  }
  void update1() {
    u32 s = found;
    set_freq(s, freq(s) + 4);
    set_summ(min_ctx, summ(min_ctx) + 4);
    if (freq(s) > freq(s - 6)) {
      swap_states(s, s - 6);
      found = s = s - 6;
      if (freq(s) > kMaxFreq) rescale();
    }
    next_context();
  }
  void update1_0() {
    prev_success = (u32)(2 * (u32)freq(found) > summ(min_ctx));
    run_length += (int)prev_success;
    set_summ(min_ctx, summ(min_ctx) + 4);
    set_freq(found, freq(found) + 4);
    if (freq(found) > kMaxFreq) rescale();
    next_context();
  }
  void update_bin() {
    u32 f = freq(found);
    set_freq(found, f + (f < 128 ? 1 : 0));
    prev_success = 1;
    run_length += 1;
    next_context();
  }
  void update2() {
    set_summ(min_ctx, summ(min_ctx) + 4);
    set_freq(found, freq(found) + 4);
    if (freq(found) > kMaxFreq) rescale();
    run_length = init_rl;
    update_model();
  }
  void bin_summ_idx(int* bi, int* bj) {
    u32 os = one_state(min_ctx);
    hi_bits_flag = hb2flag[sym(found)];
    *bi = (int)freq(os) - 1;
    *bj = (int)(prev_success + ns2bs[ns(suffix(min_ctx)) - 1] +
                hi_bits_flag + 2u * hb2flag[sym(os)] +
                ((u32)(run_length >> 26) & 0x20));
  }
};

// --- 7z range coder pair (Ppmd7Dec.c / Ppmd7Enc.c) ---

struct RangeDec {
  const u8* data;
  size_t len, pos = 0;
  u32 code = 0, range = 0xFFFFFFFFu;

  u8 byte() { return pos < len ? data[pos++] : 0; }
  bool init() {
    if (byte() != 0) return false;
    for (int i = 0; i < 4; i++) code = (code << 8) | byte();
    return code < 0xFFFFFFFFu;
  }
  u32 threshold(u32 total) {
    range /= total;
    return code / range;
  }
  void normalize() {
    if (range < kTop) {
      code = (code << 8) | byte();
      range <<= 8;
      if (range < kTop) {
        code = (code << 8) | byte();
        range <<= 8;
      }
    }
  }
  void decode(u32 start, u32 size) {
    code -= start * range;
    range *= size;
    normalize();
  }
  int decode_bit(u32 size0) {
    u32 bound = (range >> 14) * size0;
    int symb;
    if (code < bound) {
      range = bound;
      symb = 0;
    } else {
      code -= bound;
      range -= bound;
      symb = 1;
    }
    normalize();
    return symb;
  }
};

struct RangeEnc {
  u64 low = 0;
  u32 range = 0xFFFFFFFFu;
  u8 cache = 0;
  u64 cache_size = 1;
  std::vector<u8> out;

  void shift_low() {
    if ((u32)low < 0xFF000000u || (low >> 32) != 0) {
      u8 tmp = cache;
      u8 carry = (u8)(low >> 32);
      do {
        out.push_back((u8)(tmp + carry));
        tmp = 0xFF;
      } while (--cache_size != 0);
      cache = (u8)(low >> 24);
    }
    cache_size += 1;
    low = (low & 0x00FFFFFFu) << 8;
  }
  void encode(u32 start, u32 size, u32 total) {
    range /= total;
    low += (u64)start * range;
    range *= size;
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }
  void encode_bit0(u32 size0) {
    range = (range >> 14) * size0;
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }
  void encode_bit1(u32 size0) {
    u32 bound = (range >> 14) * size0;
    low += bound;
    range -= bound;
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }
  void flush() {
    for (int i = 0; i < 5; i++) shift_low();
  }
};

// --- symbol decode / encode (Ppmd7Dec.c:79-190, Ppmd7Enc.c:77-190) ---

int DecodeSymbol(Ppmd7& p, RangeDec& rc) {
  u8 mask[256];
  u32 s;
  if (p.ns(p.min_ctx) != 1) {
    s = p.stats(p.min_ctx);
    u32 count = rc.threshold(p.summ(p.min_ctx));
    u32 hi_cnt = p.freq(s);
    if (count < hi_cnt) {
      rc.decode(0, p.freq(s));
      p.found = s;
      int symb = p.sym(s);
      p.update1_0();
      return symb;
    }
    p.prev_success = 0;
    u32 i = p.ns(p.min_ctx) - 1;
    while (i) {
      s += 6;
      hi_cnt += p.freq(s);
      if (hi_cnt > count) {
        rc.decode(hi_cnt - p.freq(s), p.freq(s));
        p.found = s;
        int symb = p.sym(s);
        p.update1();
        return symb;
      }
      i -= 1;
    }
    if (count >= p.summ(p.min_ctx)) return -2;
    p.hi_bits_flag = p.hb2flag[p.sym(p.found)];
    rc.decode(hi_cnt, p.summ(p.min_ctx) - hi_cnt);
    std::memset(mask, 1, 256);
    mask[p.sym(s)] = 0;
    i = p.ns(p.min_ctx) - 1;
    while (i) {
      s -= 6;
      mask[p.sym(s)] = 0;
      i -= 1;
    }
  } else {
    int bi, bj;
    p.bin_summ_idx(&bi, &bj);
    u16 prob = p.bin_summ[bi][bj];
    if (rc.decode_bit(prob) == 0) {
      p.bin_summ[bi][bj] = (u16)(prob + (1u << kIntBits) - Mean(prob));
      p.found = p.one_state(p.min_ctx);
      int symb = p.sym(p.found);
      p.update_bin();
      return symb;
    }
    p.bin_summ[bi][bj] = (u16)(prob - Mean(prob));
    p.init_esc = kExpEscape[p.bin_summ[bi][bj] >> 10];
    std::memset(mask, 1, 256);
    mask[p.sym(p.one_state(p.min_ctx))] = 0;
    p.prev_success = 0;
  }

  for (;;) {
    u32 num_masked = p.ns(p.min_ctx);
    do {
      p.order_fall += 1;
      if (!p.suffix(p.min_ctx)) return -1;
      p.min_ctx = p.suffix(p.min_ctx);
    } while (p.ns(p.min_ctx) == num_masked);
    u32 hi_cnt = 0;
    s = p.stats(p.min_ctx);
    u32 ps[256];
    u32 nps = 0;
    u32 num = p.ns(p.min_ctx) - num_masked;
    while (nps != num) {
      if (mask[p.sym(s)]) {
        hi_cnt += p.freq(s);
        ps[nps++] = s;
      }
      s += 6;
    }
    u32 esc;
    int see = p.make_esc_freq(num_masked, &esc);
    u32 freq_sum = esc + hi_cnt;
    u32 count = rc.threshold(freq_sum);
    if (count < hi_cnt) {
      hi_cnt = 0;
      u32 k = 0;
      for (;;) {
        hi_cnt += p.freq(ps[k]);
        if (hi_cnt > count) break;
        k += 1;
      }
      s = ps[k];
      rc.decode(hi_cnt - p.freq(s), p.freq(s));
      p.see_update(see);
      p.found = s;
      int symb = p.sym(s);
      p.update2();
      return symb;
    }
    if (count >= freq_sum) return -2;
    rc.decode(hi_cnt, freq_sum - hi_cnt);
    if (see >= 0) {
      int r = see / 16, c = see % 16;
      p.see_summ[r][c] = (u16)(p.see_summ[r][c] + freq_sum);
    }
    for (u32 k = 0; k < nps; k++) mask[p.sym(ps[k])] = 0;
  }
}

void EncodeSymbol(Ppmd7& p, RangeEnc& rc, int symbol) {
  u8 mask[256];
  u32 s;
  if (p.ns(p.min_ctx) != 1) {
    s = p.stats(p.min_ctx);
    if (p.sym(s) == symbol) {
      rc.encode(0, p.freq(s), p.summ(p.min_ctx));
      p.found = s;
      p.update1_0();
      return;
    }
    p.prev_success = 0;
    u32 total = p.freq(s);
    u32 i = p.ns(p.min_ctx) - 1;
    while (i) {
      s += 6;
      if (p.sym(s) == symbol) {
        rc.encode(total, p.freq(s), p.summ(p.min_ctx));
        p.found = s;
        p.update1();
        return;
      }
      total += p.freq(s);
      i -= 1;
    }
    p.hi_bits_flag = p.hb2flag[p.sym(p.found)];
    std::memset(mask, 1, 256);
    mask[p.sym(s)] = 0;
    i = p.ns(p.min_ctx) - 1;
    while (i) {
      s -= 6;
      mask[p.sym(s)] = 0;
      i -= 1;
    }
    rc.encode(total, p.summ(p.min_ctx) - total, p.summ(p.min_ctx));
  } else {
    int bi, bj;
    p.bin_summ_idx(&bi, &bj);
    u16 prob = p.bin_summ[bi][bj];
    u32 os = p.one_state(p.min_ctx);
    if (p.sym(os) == symbol) {
      rc.encode_bit0(prob);
      p.bin_summ[bi][bj] = (u16)(prob + (1u << kIntBits) - Mean(prob));
      p.found = os;
      p.update_bin();
      return;
    }
    rc.encode_bit1(prob);
    p.bin_summ[bi][bj] = (u16)(prob - Mean(prob));
    p.init_esc = kExpEscape[p.bin_summ[bi][bj] >> 10];
    std::memset(mask, 1, 256);
    mask[p.sym(os)] = 0;
    p.prev_success = 0;
  }

  for (;;) {
    u32 num_masked = p.ns(p.min_ctx);
    do {
      p.order_fall += 1;
      if (!p.suffix(p.min_ctx)) return;  // end-marker case
      p.min_ctx = p.suffix(p.min_ctx);
    } while (p.ns(p.min_ctx) == num_masked);
    u32 esc;
    int see = p.make_esc_freq(num_masked, &esc);
    s = p.stats(p.min_ctx);
    u32 total = 0;
    u32 i = p.ns(p.min_ctx);
    bool found_sym = false;
    while (i) {
      int cur = p.sym(s);
      if (cur == symbol) {
        u32 low = total;
        u32 s1 = s;
        while (i) {
          if (mask[p.sym(s)]) total += p.freq(s);
          s += 6;
          i -= 1;
        }
        rc.encode(low, p.freq(s1), total + esc);
        p.see_update(see);
        p.found = s1;
        p.update2();
        found_sym = true;
        break;
      }
      if (mask[cur]) total += p.freq(s);
      mask[cur] = 0;
      s += 6;
      i -= 1;
    }
    if (found_sym) return;
    rc.encode(total, esc, total + esc);
    if (see >= 0) {
      int r = see / 16, c = see % 16;
      p.see_summ[r][c] = (u16)(p.see_summ[r][c] + total + esc);
    }
  }
}

}  // namespace

// --- C API -----------------------------------------------------------------

extern "C" {

int lzt_ppmd7_decode(const u8* src, size_t src_len, const u8* props5,
                     u8* dst, size_t out_size) {
  int order = props5[0];
  u32 mem;
  std::memcpy(&mem, props5 + 1, 4);
  if (order < 2 || order > 64 || mem < (1u << 11)) return ERR_PARAM;
  Ppmd7 p;
  p.construct(order, mem);
  RangeDec rc{src, src_len};
  if (!rc.init()) return ERR_DATA;
  for (size_t i = 0; i < out_size; i++) {
    int symb = DecodeSymbol(p, rc);
    if (symb < 0) return ERR_DATA;
    dst[i] = (u8)symb;
  }
  if (rc.code != 0) return ERR_DATA;
  return ERR_OK;
}

// out_len: in = capacity, out = produced size (or required size on ERR_CAP)
int lzt_ppmd7_encode(const u8* data, size_t n, int order, u32 mem_size,
                     u8* out, size_t* out_len) {
  if (order < 2 || order > 64 || mem_size < (1u << 11)) return ERR_PARAM;
  Ppmd7 p;
  p.construct(order, mem_size);
  RangeEnc rc;
  rc.out.reserve(n / 2 + 64);
  for (size_t i = 0; i < n; i++) EncodeSymbol(p, rc, data[i]);
  rc.flush();
  if (rc.out.size() > *out_len) {
    *out_len = rc.out.size();
    return ERR_CAP;
  }
  std::memcpy(out, rc.out.data(), rc.out.size());
  *out_len = rc.out.size();
  return ERR_OK;
}

}  // extern "C"
