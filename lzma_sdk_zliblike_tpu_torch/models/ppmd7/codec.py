"""PPMd var.H (PPMd7) codec — 7z method 0x030401.

From-scratch Python implementation bit-exact with the reference
(``Ppmd7.c``/``Ppmd7Dec.c``/``Ppmd7Enc.c``, itself based on Shkarin's public
domain PPMd var.H).  The model is a suffix tree of contexts allocated from a
hand-managed pool whose *address arithmetic is semantically meaningful*
(successor refs below ``UnitsStart`` are positions in the grown text area),
so the pool is emulated byte-for-byte: refs are integer offsets exactly as
the reference's non-PPMD_32BIT build computes them (``Ppmd7.c:22-28``).

Layout parity notes (behavioral targets, not copied code):
* context record: NumStats u16, SummFreq u16, Stats u32, Suffix u32; a
  1-symbol context stores its single state inline over SummFreq/Stats
  (``Ppmd7.h:33-40``)
* state record: Symbol u8, Freq u8, Successor u16+u16 (``Ppmd.h:45-50``)
* sub-allocator: 38 unit-size classes, free lists, split/glue
  (``Ppmd7.c:118-258``); model restart exactly at the same alloc-failure
  points (``RestartModel``, ``Ppmd7.c:300-338``)
* SEE and binary-context escape estimation (``Ppmd7.c:634-660``,
  ``Ppmd7_GetBinSumm`` ``Ppmd7.h:94-100``)
* the 7z range coder pair (``Ppmd7Dec.c:9-75``, ``Ppmd7Enc.c:9-63``)

Props (5 bytes): order u8, memSize u32 LE (``7zDec.c:83-90``).

The port's copy of the JAX package's ``models/ppmd7/codec.py``.  Engines:
``"auto"`` / ``"native"`` the port's C++ codec (``csrc/host/lzt_ppmd7.cc``,
byte-identical, always built), ``"python"`` the model below.  Any other
name raises UnsupportedError (``engine.check_engine``): PPMd is one serial
model with no device route in either package, and the JAX functions run
this Python model for every name but ``"auto"``.
"""

from __future__ import annotations

from ...engine import check_engine
from ...utils.errors import DataError, ParamError

MIN_ORDER = 2
MAX_ORDER = 64
MIN_MEM = 1 << 11
MAX_MEM = 0xFFFFFFFF - 12 * 3

INT_BITS = 7
PERIOD_BITS = 7
BIN_SCALE = 1 << (INT_BITS + PERIOD_BITS)
MAX_FREQ = 124
UNIT_SIZE = 12
N_INDEXES = 4 + 4 + 4 + (128 + 3 - 1 * 4 - 2 * 4 - 3 * 4) // 4  # 38

K_EXP_ESCAPE = (25, 14, 9, 7, 5, 5, 4, 4, 4, 3, 3, 3, 2, 2, 2, 2)
INIT_BIN_ESC = (0x3CDD, 0x1F3F, 0x59BF, 0x48F3, 0x64A1, 0x5ABC, 0x6632, 0x6051)

_TOP = 1 << 24
_M32 = 0xFFFFFFFF


def _mean(summ: int) -> int:
    return (summ + (1 << (PERIOD_BITS - 2))) >> PERIOD_BITS


class Ppmd7:
    """The shared PPMd7 model (used by both encoder and decoder)."""

    def __init__(self, order: int, mem_size: int):
        if not MIN_ORDER <= order <= MAX_ORDER:
            raise ParamError(f"ppmd order {order}")
        if not MIN_MEM <= mem_size <= MAX_MEM:
            raise ParamError(f"ppmd memSize {mem_size}")
        self.max_order = order
        self.size = mem_size
        self.align_offset = 4 - (mem_size & 3)
        self.pool = bytearray(self.align_offset + mem_size + UNIT_SIZE)

        # Units2Indx / Indx2Units (Ppmd7_Construct)
        self.i2u = [0] * N_INDEXES
        self.u2i = [0] * 128
        k = 0
        for i in range(N_INDEXES):
            step = 4 if i >= 12 else (i >> 2) + 1
            for _ in range(step):
                self.u2i[k] = i
                k += 1
            self.i2u[i] = k
        self.ns2bs = [0, 2] + [4] * 9 + [6] * (256 - 11)
        self.ns2i = [0, 1, 2]
        m, k = 3, 1
        for i in range(3, 256):
            self.ns2i.append(m)
            k -= 1
            if k == 0:
                m += 1
                k = m - 2
        self.hb2flag = [0] * 0x40 + [8] * (0x100 - 0x40)

        self.see_summ = [[0] * 16 for _ in range(25)]
        self.see_shift = [[0] * 16 for _ in range(25)]
        self.see_count = [[0] * 16 for _ in range(25)]
        self.dummy_see_shift = PERIOD_BITS
        self.bin_summ = [[0] * 64 for _ in range(128)]
        self.restart()

    # ---- pool struct accessors -------------------------------------------
    def _r8(self, a):
        return self.pool[a]

    def _w8(self, a, v):
        self.pool[a] = v & 0xFF

    def _r16(self, a):
        return self.pool[a] | (self.pool[a + 1] << 8)

    def _w16(self, a, v):
        self.pool[a] = v & 0xFF
        self.pool[a + 1] = (v >> 8) & 0xFF

    def _r32(self, a):
        p = self.pool
        return p[a] | (p[a + 1] << 8) | (p[a + 2] << 16) | (p[a + 3] << 24)

    def _w32(self, a, v):
        p = self.pool
        p[a] = v & 0xFF
        p[a + 1] = (v >> 8) & 0xFF
        p[a + 2] = (v >> 16) & 0xFF
        p[a + 3] = (v >> 24) & 0xFF

    # context fields
    def ns(self, c):
        return self._r16(c)

    def set_ns(self, c, v):
        self._w16(c, v)

    def summ(self, c):
        return self._r16(c + 2)

    def set_summ(self, c, v):
        self._w16(c + 2, v)

    def stats(self, c):
        return self._r32(c + 4)

    def set_stats(self, c, v):
        self._w32(c + 4, v)

    def suffix(self, c):
        return self._r32(c + 8)

    def set_suffix(self, c, v):
        self._w32(c + 8, v)

    def one_state(self, c):
        return c + 2  # state stored over SummFreq/Stats

    # state fields (6 bytes)
    def sym(self, s):
        return self.pool[s]

    def set_sym(self, s, v):
        self.pool[s] = v

    def freq(self, s):
        return self.pool[s + 1]

    def set_freq(self, s, v):
        self.pool[s + 1] = v & 0xFF

    def succ(self, s):
        return self._r16(s + 2) | (self._r16(s + 4) << 16)

    def set_succ(self, s, v):
        self._w16(s + 2, v & 0xFFFF)
        self._w16(s + 4, (v >> 16) & 0xFFFF)

    def copy_state(self, dst, src):
        self.pool[dst:dst + 6] = self.pool[src:src + 6]

    # ---- sub-allocator ---------------------------------------------------
    def _insert_node(self, node, indx):
        self._w32(node, self.free_list[indx])
        self.free_list[indx] = node

    def _remove_node(self, indx):
        node = self.free_list[indx]
        self.free_list[indx] = self._r32(node)
        return node

    def _split_block(self, ptr, old_i, new_i):
        nu = self.i2u[old_i] - self.i2u[new_i]
        ptr += self.i2u[new_i] * UNIT_SIZE
        i = self.u2i[nu - 1]
        if self.i2u[i] != nu:
            i -= 1
            k = self.i2u[i]
            self._insert_node(ptr + k * UNIT_SIZE, nu - k - 1)
        self._insert_node(ptr, i)

    # node record (12B): Stamp u16 @0, NU u16 @2, Next u32 @4, Prev u32 @8
    def _glue_free_blocks(self):
        head = self.align_offset + self.size
        n = head
        self.glue_count = 255
        for i in range(N_INDEXES):
            nu = self.i2u[i]
            nxt = self.free_list[i]
            self.free_list[i] = 0
            while nxt != 0:
                node = nxt
                nxt2 = self._r32(node)
                self._w32(node + 4, n)       # node->Next = n
                self._w32(n + 8, node)       # NODE(n)->Prev = node
                n = node
                self._w16(node, 0)           # Stamp = 0
                self._w16(node + 2, nu)      # NU
                nxt = nxt2
        self._w16(head, 1)
        self._w32(head + 4, n)
        self._w32(n + 8, head)
        if self.lo_unit != self.hi_unit:
            self._w16(self.lo_unit, 1)
        # glue adjacent free blocks
        n = self._r32(head + 4)
        while n != head:
            nu = self._r16(n + 2)
            while True:
                node2 = n + nu * UNIT_SIZE
                nu2 = self._r16(node2 + 2)
                if self._r16(node2) != 0 or nu + nu2 >= 0x10000:
                    break
                prev2 = self._r32(node2 + 8)
                next2 = self._r32(node2 + 4)
                self._w32(prev2 + 4, next2)
                self._w32(next2 + 8, prev2)
                nu += nu2
                self._w16(n + 2, nu)
            n = self._r32(n + 4)
        # refill lists
        n = self._r32(head + 4)
        while n != head:
            nxt = self._r32(n + 4)
            nu = self._r16(n + 2)
            node = n
            while nu > 128:
                self._insert_node(node, N_INDEXES - 1)
                nu -= 128
                node += 128 * UNIT_SIZE
            i = self.u2i[nu - 1]
            if self.i2u[i] != nu:
                i -= 1
                k = self.i2u[i]
                self._insert_node(node + k * UNIT_SIZE, nu - k - 1)
            self._insert_node(node, i)
            n = nxt

    def _alloc_units_rare(self, indx):
        if self.glue_count == 0:
            self._glue_free_blocks()
            if self.free_list[indx] != 0:
                return self._remove_node(indx)
        i = indx
        while True:
            i += 1
            if i == N_INDEXES:
                num_bytes = self.i2u[indx] * UNIT_SIZE
                self.glue_count -= 1
                if self.units_start - self.text > num_bytes:
                    self.units_start -= num_bytes
                    return self.units_start
                return 0
            if self.free_list[i] != 0:
                break
        ret = self._remove_node(i)
        self._split_block(ret, i, indx)
        return ret

    def _alloc_units(self, indx):
        if self.free_list[indx] != 0:
            return self._remove_node(indx)
        num_bytes = self.i2u[indx] * UNIT_SIZE
        if num_bytes <= self.hi_unit - self.lo_unit:
            ret = self.lo_unit
            self.lo_unit += num_bytes
            return ret
        return self._alloc_units_rare(indx)

    def _mem12cpy(self, dst, src, nu):
        self.pool[dst:dst + nu * UNIT_SIZE] = self.pool[src:src + nu * UNIT_SIZE]

    def _shrink_units(self, old_ptr, old_nu, new_nu):
        i0 = self.u2i[old_nu - 1]
        i1 = self.u2i[new_nu - 1]
        if i0 == i1:
            return old_ptr
        if self.free_list[i1] != 0:
            ptr = self._remove_node(i1)
            self._mem12cpy(ptr, old_ptr, new_nu)
            self._insert_node(old_ptr, i0)
            return ptr
        self._split_block(old_ptr, i0, i1)
        return old_ptr

    # ---- model -----------------------------------------------------------
    def restart(self):
        self.free_list = [0] * N_INDEXES
        self.text = self.align_offset + 0
        self.hi_unit = self.text + self.size
        self.lo_unit = self.units_start = \
            self.hi_unit - self.size // 8 // UNIT_SIZE * 7 * UNIT_SIZE
        self.glue_count = 0

        self.order_fall = self.max_order
        self.init_rl = -(self.max_order if self.max_order < 12 else 12) - 1
        self.run_length = self.init_rl
        self.prev_success = 0
        self.init_esc = 0
        self.hi_bits_flag = 0

        self.hi_unit -= UNIT_SIZE
        self.min_ctx = self.max_ctx = self.hi_unit
        c = self.min_ctx
        self.set_suffix(c, 0)
        self.set_ns(c, 256)
        self.set_summ(c, 256 + 1)
        self.found = self.lo_unit
        self.lo_unit += (256 // 2) * UNIT_SIZE
        self.set_stats(c, self.found)
        for i in range(256):
            s = self.found + 6 * i
            self.set_sym(s, i)
            self.set_freq(s, 1)
            self.set_succ(s, 0)

        for i in range(128):
            for k in range(8):
                val = BIN_SCALE - INIT_BIN_ESC[k] // (i + 2)
                for m in range(0, 64, 8):
                    self.bin_summ[i][k + m] = val

        for i in range(25):
            for k in range(16):
                self.see_summ[i][k] = (5 * i + 10) << (PERIOD_BITS - 4)
                self.see_shift[i][k] = PERIOD_BITS - 4
                self.see_count[i][k] = 4

    # ---- CreateSuccessors (Ppmd7.c:340-410) ------------------------------
    def _create_successors(self, skip: bool):
        c = self.min_ctx
        up_branch = self.succ(self.found)
        ps = []
        if not skip:
            ps.append(self.found)
        while self.suffix(c):
            c = self.suffix(c)
            if self.ns(c) != 1:
                s = self.stats(c)
                fs_sym = self.sym(self.found)
                while self.sym(s) != fs_sym:
                    s += 6
            else:
                s = self.one_state(c)
            successor = self.succ(s)
            if successor != up_branch:
                c = successor
                if not ps:
                    return c
                break
            ps.append(s)

        up_sym = self.pool[up_branch]
        up_succ = up_branch + 1
        if self.ns(c) == 1:
            up_freq = self.freq(self.one_state(c))
        else:
            s = self.stats(c)
            while self.sym(s) != up_sym:
                s += 6
            cf = self.freq(s) - 1
            s0 = self.summ(c) - self.ns(c) - cf
            up_freq = 1 + ((5 * cf > s0) if 2 * cf <= s0
                           else ((2 * cf + 3 * s0 - 1) // (2 * s0)))

        while True:
            if self.hi_unit != self.lo_unit:
                self.hi_unit -= UNIT_SIZE
                c1 = self.hi_unit
            elif self.free_list[0] != 0:
                c1 = self._remove_node(0)
            else:
                c1 = self._alloc_units_rare(0)
                if not c1:
                    return 0
            self.set_ns(c1, 1)
            os = self.one_state(c1)
            self.set_sym(os, up_sym)
            self.set_freq(os, up_freq)
            self.set_succ(os, up_succ)
            self.set_suffix(c1, c)
            self.set_succ(ps.pop(), c1)
            c = c1
            if not ps:
                break
        return c

    # ---- UpdateModel (Ppmd7.c:421-568) -----------------------------------
    def _update_model(self):
        f_succ = self.succ(self.found)
        fs_sym = self.sym(self.found)
        fs_freq = self.freq(self.found)

        if fs_freq < MAX_FREQ // 4 and self.suffix(self.min_ctx) != 0:
            c = self.suffix(self.min_ctx)
            if self.ns(c) == 1:
                s = self.one_state(c)
                if self.freq(s) < 32:
                    self.set_freq(s, self.freq(s) + 1)
            else:
                s = self.stats(c)
                if self.sym(s) != fs_sym:
                    while True:
                        s += 6
                        if self.sym(s) == fs_sym:
                            break
                    if self.freq(s) >= self.freq(s - 6):
                        self._swap_states(s, s - 6)
                        s -= 6
                if self.freq(s) < MAX_FREQ - 9:
                    self.set_freq(s, self.freq(s) + 2)
                    self.set_summ(c, self.summ(c) + 2)

        if self.order_fall == 0:
            nc = self._create_successors(True)
            if nc == 0:
                self.restart()
                return
            self.min_ctx = self.max_ctx = nc
            self.set_succ(self.found, nc)
            return

        self.pool[self.text] = fs_sym
        self.text += 1
        successor = self.text
        if self.text >= self.units_start:
            self.restart()
            return

        if f_succ:
            if f_succ <= successor:
                cs = self._create_successors(False)
                if cs == 0:
                    self.restart()
                    return
                f_succ = cs
            self.order_fall -= 1
            if self.order_fall == 0:
                successor = f_succ
                if self.max_ctx != self.min_ctx:
                    self.text -= 1
        else:
            self.set_succ(self.found, successor)
            f_succ = self.min_ctx

        ns = self.ns(self.min_ctx)
        s0 = self.summ(self.min_ctx) - ns - (fs_freq - 1)

        c = self.max_ctx
        while c != self.min_ctx:
            ns1 = self.ns(c)
            if ns1 != 1:
                if (ns1 & 1) == 0:
                    old_nu = ns1 >> 1
                    i = self.u2i[old_nu - 1]
                    if i != self.u2i[old_nu]:
                        ptr = self._alloc_units(i + 1)
                        if not ptr:
                            self.restart()
                            return
                        old_ptr = self.stats(c)
                        self._mem12cpy(ptr, old_ptr, old_nu)
                        self._insert_node(old_ptr, i)
                        self.set_stats(c, ptr)
                sf_add = (2 * ns1 < ns) + 2 * ((4 * ns1 <= ns) &
                                               (self.summ(c) <= 8 * ns1))
                self.set_summ(c, self.summ(c) + sf_add)
            else:
                s = self._alloc_units(0)
                if not s:
                    self.restart()
                    return
                self.copy_state(s, self.one_state(c))
                self.set_stats(c, s)
                fr = self.freq(s)
                if fr < MAX_FREQ // 4 - 1:
                    self.set_freq(s, fr << 1)
                else:
                    self.set_freq(s, MAX_FREQ - 4)
                self.set_summ(c, self.freq(s) + self.init_esc + (ns > 3))
            cf = 2 * fs_freq * (self.summ(c) + 6)
            sf = s0 + self.summ(c)
            if cf < 6 * sf:
                cf = 1 + (cf > sf) + (cf >= 4 * sf)
                self.set_summ(c, self.summ(c) + 3)
            else:
                cf = 4 + (cf >= 9 * sf) + (cf >= 12 * sf) + (cf >= 15 * sf)
                self.set_summ(c, self.summ(c) + cf)
            s = self.stats(c) + ns1 * 6
            self.set_succ(s, successor)
            self.set_sym(s, fs_sym)
            self.set_freq(s, cf)
            self.set_ns(c, ns1 + 1)
            c = self.suffix(c)
        self.max_ctx = self.min_ctx = f_succ

    def _swap_states(self, a, b):
        tmp = bytes(self.pool[a:a + 6])
        self.pool[a:a + 6] = self.pool[b:b + 6]
        self.pool[b:b + 6] = tmp

    # ---- Rescale (Ppmd7.c:570-632) ---------------------------------------
    def _rescale(self):
        stats = self.stats(self.min_ctx)
        s = self.found
        # move found to front
        if s != stats:
            tmp = bytes(self.pool[s:s + 6])
            while s != stats:
                self.copy_state(s, s - 6)
                s -= 6
            self.pool[stats:stats + 6] = tmp
        s = stats
        esc_freq = self.summ(self.min_ctx) - self.freq(s)
        self.set_freq(s, self.freq(s) + 4)
        adder = 1 if self.order_fall != 0 else 0
        self.set_freq(s, (self.freq(s) + adder) >> 1)
        sum_freq = self.freq(s)
        i = self.ns(self.min_ctx) - 1
        while i:
            s += 6
            esc_freq -= self.freq(s)
            self.set_freq(s, (self.freq(s) + adder) >> 1)
            sum_freq += self.freq(s)
            if self.freq(s) > self.freq(s - 6):
                s1 = s
                tmp = bytes(self.pool[s1:s1 + 6])
                tmp_freq = tmp[1]
                while True:
                    self.copy_state(s1, s1 - 6)
                    s1 -= 6
                    if s1 == stats or tmp_freq <= self.freq(s1 - 6):
                        break
                self.pool[s1:s1 + 6] = tmp
            i -= 1
        if self.freq(s) == 0:
            num_stats = self.ns(self.min_ctx)
            i = 0
            while True:
                i += 1
                s -= 6
                if self.freq(s) != 0:
                    break
            esc_freq += i
            self.set_ns(self.min_ctx, num_stats - i)
            if self.ns(self.min_ctx) == 1:
                tmp = bytearray(self.pool[stats:stats + 6])
                while True:
                    tmp[1] = tmp[1] - (tmp[1] >> 1)
                    esc_freq >>= 1
                    if esc_freq <= 1:
                        break
                self._insert_node(stats, self.u2i[((num_stats + 1) >> 1) - 1])
                self.found = self.one_state(self.min_ctx)
                self.pool[self.found:self.found + 6] = tmp
                return
            n0 = (num_stats + 1) >> 1
            n1 = (self.ns(self.min_ctx) + 1) >> 1
            if n0 != n1:
                self.set_stats(self.min_ctx,
                               self._shrink_units(stats, n0, n1))
        self.set_summ(self.min_ctx, sum_freq + esc_freq - (esc_freq >> 1))
        self.found = self.stats(self.min_ctx)

    # ---- MakeEscFreq (Ppmd7.c:634-660) -----------------------------------
    def _make_esc_freq(self, num_masked):
        mc = self.min_ctx
        ns = self.ns(mc)
        non_masked = ns - num_masked
        if ns != 256:
            sfx = self.suffix(mc)
            r_idx = self.ns2i[non_masked - 1]
            # the reference computes suffix->NumStats - NumStats in unsigned
            # arithmetic; a negative difference wraps to a huge value
            diff = (self.ns(sfx) - ns) & 0xFFFFFFFF
            c_idx = ((non_masked < diff) +
                     2 * (self.summ(mc) < 11 * ns) +
                     4 * (num_masked > non_masked) +
                     self.hi_bits_flag)
            r = self.see_summ[r_idx][c_idx] >> self.see_shift[r_idx][c_idx]
            self.see_summ[r_idx][c_idx] -= r
            return (r_idx, c_idx), r + (r == 0)
        return None, 1

    def _see_update(self, see):
        if see is None:
            return
        r_idx, c_idx = see
        if self.see_shift[r_idx][c_idx] < PERIOD_BITS:
            self.see_count[r_idx][c_idx] -= 1
            if self.see_count[r_idx][c_idx] == 0:
                self.see_summ[r_idx][c_idx] = (self.see_summ[r_idx][c_idx] << 1) & 0xFFFF
                self.see_count[r_idx][c_idx] = 3 << self.see_shift[r_idx][c_idx]
                self.see_shift[r_idx][c_idx] += 1

    # ---- per-symbol updates (Ppmd7.c:662-708) ----------------------------
    def _next_context(self):
        c = self.succ(self.found)
        if self.order_fall == 0 and c > self.text:
            self.min_ctx = self.max_ctx = c
        else:
            self._update_model()

    def _update1(self):
        s = self.found
        self.set_freq(s, self.freq(s) + 4)
        self.set_summ(self.min_ctx, self.summ(self.min_ctx) + 4)
        if self.freq(s) > self.freq(s - 6):
            self._swap_states(s, s - 6)
            self.found = s = s - 6
            if self.freq(s) > MAX_FREQ:
                self._rescale()
        self._next_context()

    def _update1_0(self):
        self.prev_success = int(2 * self.freq(self.found) >
                                self.summ(self.min_ctx))
        self.run_length += self.prev_success
        self.set_summ(self.min_ctx, self.summ(self.min_ctx) + 4)
        self.set_freq(self.found, self.freq(self.found) + 4)
        if self.freq(self.found) > MAX_FREQ:
            self._rescale()
        self._next_context()

    def _update_bin(self):
        f = self.freq(self.found)
        self.set_freq(self.found, f + (1 if f < 128 else 0))
        self.prev_success = 1
        self.run_length += 1
        self._next_context()

    def _update2(self):
        self.set_summ(self.min_ctx, self.summ(self.min_ctx) + 4)
        self.set_freq(self.found, self.freq(self.found) + 4)
        if self.freq(self.found) > MAX_FREQ:
            self._rescale()
        self.run_length = self.init_rl
        self._update_model()

    def _bin_summ_idx(self):
        os = self.one_state(self.min_ctx)
        self.hi_bits_flag = self.hb2flag[self.sym(self.found)]
        i = self.freq(os) - 1
        j = (self.prev_success +
             self.ns2bs[self.ns(self.suffix(self.min_ctx)) - 1] +
             self.hi_bits_flag +
             2 * self.hb2flag[self.sym(os)] +
             ((self.run_length >> 26) & 0x20))
        return i, j


# ---------------------------------------------------------------------------
# 7z range coder pair (Ppmd7Dec.c / Ppmd7Enc.c)
# ---------------------------------------------------------------------------

class _RangeDec:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.code = 0
        self.range_ = _M32

    def _byte(self):
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def init(self) -> bool:
        if self._byte() != 0:
            return False
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & _M32
        return self.code < _M32

    def threshold(self, total):
        self.range_ //= total
        return self.code // self.range_

    def _normalize(self):
        if self.range_ < _TOP:
            self.code = ((self.code << 8) | self._byte()) & _M32
            self.range_ = (self.range_ << 8) & _M32
            if self.range_ < _TOP:
                self.code = ((self.code << 8) | self._byte()) & _M32
                self.range_ = (self.range_ << 8) & _M32

    def decode(self, start, size):
        self.code = (self.code - start * self.range_) & _M32
        self.range_ = (self.range_ * size) & _M32
        self._normalize()

    def decode_bit(self, size0):
        bound = (self.range_ >> 14) * size0
        if self.code < bound:
            self.range_ = bound
            sym = 0
        else:
            self.code -= bound
            self.range_ -= bound
            sym = 1
        self._normalize()
        return sym


class _RangeEnc:
    def __init__(self):
        self.low = 0
        self.range_ = _M32
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if (self.low & _M32) < 0xFF000000 or (self.low >> 32) != 0:
            tmp = self.cache
            carry = self.low >> 32
            while True:
                self.out.append((tmp + carry) & 0xFF)
                tmp = 0xFF
                self.cache_size -= 1
                if self.cache_size == 0:
                    break
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low & 0x00FFFFFF) << 8

    def encode(self, start, size, total):
        self.range_ //= total
        self.low += start * self.range_
        self.range_ = (self.range_ * size) & _M32
        while self.range_ < _TOP:
            self.range_ = (self.range_ << 8) & _M32
            self._shift_low()

    def encode_bit0(self, size0):
        self.range_ = (self.range_ >> 14) * size0
        while self.range_ < _TOP:
            self.range_ = (self.range_ << 8) & _M32
            self._shift_low()

    def encode_bit1(self, size0):
        bound = (self.range_ >> 14) * size0
        self.low += bound
        self.range_ -= bound
        while self.range_ < _TOP:
            self.range_ = (self.range_ << 8) & _M32
            self._shift_low()

    def flush(self):
        for _ in range(5):
            self._shift_low()


# ---------------------------------------------------------------------------
# symbol decode / encode (Ppmd7Dec.c:79-190, Ppmd7Enc.c:77-190)
# ---------------------------------------------------------------------------

def _decode_symbol(p: Ppmd7, rc: _RangeDec) -> int:
    mask = bytearray(256)
    if p.ns(p.min_ctx) != 1:
        s = p.stats(p.min_ctx)
        count = rc.threshold(p.summ(p.min_ctx))
        hi_cnt = p.freq(s)
        if count < hi_cnt:
            rc.decode(0, p.freq(s))
            p.found = s
            sym = p.sym(s)
            p._update1_0()
            return sym
        p.prev_success = 0
        i = p.ns(p.min_ctx) - 1
        while i:
            s += 6
            hi_cnt += p.freq(s)
            if hi_cnt > count:
                rc.decode(hi_cnt - p.freq(s), p.freq(s))
                p.found = s
                sym = p.sym(s)
                p._update1()
                return sym
            i -= 1
        if count >= p.summ(p.min_ctx):
            return -2
        p.hi_bits_flag = p.hb2flag[p.sym(p.found)]
        rc.decode(hi_cnt, p.summ(p.min_ctx) - hi_cnt)
        for k in range(256):
            mask[k] = 1
        mask[p.sym(s)] = 0
        i = p.ns(p.min_ctx) - 1
        while i:
            s -= 6
            mask[p.sym(s)] = 0
            i -= 1
    else:
        bi, bj = p._bin_summ_idx()
        prob = p.bin_summ[bi][bj]
        if rc.decode_bit(prob) == 0:
            p.bin_summ[bi][bj] = (prob + (1 << INT_BITS) - _mean(prob)) & 0xFFFF
            p.found = p.one_state(p.min_ctx)
            sym = p.sym(p.found)
            p._update_bin()
            return sym
        p.bin_summ[bi][bj] = (prob - _mean(prob)) & 0xFFFF
        p.init_esc = K_EXP_ESCAPE[p.bin_summ[bi][bj] >> 10]
        for k in range(256):
            mask[k] = 1
        mask[p.sym(p.one_state(p.min_ctx))] = 0
        p.prev_success = 0

    while True:
        num_masked = p.ns(p.min_ctx)
        while True:
            p.order_fall += 1
            if not p.suffix(p.min_ctx):
                return -1
            p.min_ctx = p.suffix(p.min_ctx)
            if p.ns(p.min_ctx) != num_masked:
                break
        hi_cnt = 0
        s = p.stats(p.min_ctx)
        ps = []
        num = p.ns(p.min_ctx) - num_masked
        while len(ps) != num:
            if mask[p.sym(s)]:
                hi_cnt += p.freq(s)
                ps.append(s)
            s += 6
        see, freq_sum = p._make_esc_freq(num_masked)
        freq_sum += hi_cnt
        count = rc.threshold(freq_sum)
        if count < hi_cnt:
            hi_cnt = 0
            k = 0
            while True:
                hi_cnt += p.freq(ps[k])
                if hi_cnt > count:
                    break
                k += 1
            s = ps[k]
            rc.decode(hi_cnt - p.freq(s), p.freq(s))
            p._see_update(see)
            p.found = s
            sym = p.sym(s)
            p._update2()
            return sym
        if count >= freq_sum:
            return -2
        rc.decode(hi_cnt, freq_sum - hi_cnt)
        if see is not None:
            ri, ci = see
            p.see_summ[ri][ci] = (p.see_summ[ri][ci] + freq_sum) & 0xFFFF
        for st in ps:
            mask[p.sym(st)] = 0


def _encode_symbol(p: Ppmd7, rc: _RangeEnc, symbol: int) -> None:
    mask = bytearray(256)
    if p.ns(p.min_ctx) != 1:
        s = p.stats(p.min_ctx)
        if p.sym(s) == symbol:
            rc.encode(0, p.freq(s), p.summ(p.min_ctx))
            p.found = s
            p._update1_0()
            return
        p.prev_success = 0
        total = p.freq(s)
        i = p.ns(p.min_ctx) - 1
        while i:
            s += 6
            if p.sym(s) == symbol:
                rc.encode(total, p.freq(s), p.summ(p.min_ctx))
                p.found = s
                p._update1()
                return
            total += p.freq(s)
            i -= 1
        p.hi_bits_flag = p.hb2flag[p.sym(p.found)]
        for k in range(256):
            mask[k] = 1
        mask[p.sym(s)] = 0
        i = p.ns(p.min_ctx) - 1
        while i:
            s -= 6
            mask[p.sym(s)] = 0
            i -= 1
        rc.encode(total, p.summ(p.min_ctx) - total, p.summ(p.min_ctx))
    else:
        bi, bj = p._bin_summ_idx()
        prob = p.bin_summ[bi][bj]
        os = p.one_state(p.min_ctx)
        if p.sym(os) == symbol:
            rc.encode_bit0(prob)
            p.bin_summ[bi][bj] = (prob + (1 << INT_BITS) - _mean(prob)) & 0xFFFF
            p.found = os
            p._update_bin()
            return
        rc.encode_bit1(prob)
        p.bin_summ[bi][bj] = (prob - _mean(prob)) & 0xFFFF
        p.init_esc = K_EXP_ESCAPE[p.bin_summ[bi][bj] >> 10]
        for k in range(256):
            mask[k] = 1
        mask[p.sym(os)] = 0
        p.prev_success = 0

    while True:
        num_masked = p.ns(p.min_ctx)
        while True:
            p.order_fall += 1
            if not p.suffix(p.min_ctx):
                return  # caller encodes nothing further (end marker case)
            p.min_ctx = p.suffix(p.min_ctx)
            if p.ns(p.min_ctx) != num_masked:
                break
        see, esc_freq = p._make_esc_freq(num_masked)
        s = p.stats(p.min_ctx)
        total = 0
        i = p.ns(p.min_ctx)
        while i:
            cur = p.sym(s)
            if cur == symbol:
                low = total
                s1 = s
                while i:
                    if mask[p.sym(s)]:
                        total += p.freq(s)
                    s += 6
                    i -= 1
                rc.encode(low, p.freq(s1), total + esc_freq)
                p._see_update(see)
                p.found = s1
                p._update2()
                return
            if mask[cur]:
                total += p.freq(s)
            mask[cur] = 0
            s += 6
            i -= 1
        rc.encode(total, esc_freq, total + esc_freq)
        if see is not None:
            ri, ci = see
            p.see_summ[ri][ci] = (p.see_summ[ri][ci] + total + esc_freq) & 0xFFFF


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def decode(src: bytes, props: bytes, out_size: int, *,
           engine: str = "auto") -> bytes:
    """Decode ``out_size`` bytes of a PPMd7 stream (7z method 0x030401
    payload); ``engine`` as in the module docstring."""
    if len(props) != 5:
        raise ParamError("ppmd props must be 5 bytes")
    order = props[0]
    mem = int.from_bytes(props[1:5], "little")
    if not MIN_ORDER <= order <= MAX_ORDER or not MIN_MEM <= mem <= MAX_MEM:
        raise ParamError(f"ppmd props order={order} mem={mem}")
    if check_engine(engine, "PPMd7") != "python":
        from ... import native
        return native.ppmd7_decode(src, props, out_size)
    p = Ppmd7(order, mem)
    rc = _RangeDec(src)
    if not rc.init():
        raise DataError("ppmd rc init")
    out = bytearray()
    while len(out) < out_size:
        sym = _decode_symbol(p, rc)
        if sym < 0:
            raise DataError(f"ppmd decode error {sym}")
        out.append(sym)
    if rc.code != 0:
        raise DataError("ppmd rc not finished")
    return bytes(out)


def encode(data: bytes, order: int = 6, mem_size: int = 1 << 24, *,
           engine: str = "auto") -> tuple[bytes, bytes]:
    """Encode with PPMd7; returns (stream, props)."""
    props = bytes([order]) + mem_size.to_bytes(4, "little")
    if check_engine(engine, "PPMd7") != "python":
        from ... import native
        return native.ppmd7_encode(data, order, mem_size), props
    p = Ppmd7(order, mem_size)
    rc = _RangeEnc()
    for b in data:
        _encode_symbol(p, rc, b)
    rc.flush()
    return bytes(rc.out), props
