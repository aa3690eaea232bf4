"""Scalar reference LZMA encoder (pure Python).

From-scratch implementation of the LZMA encode side: a carry-correct range
encoder (the semantics of the reference's ``CRangeEnc``/``ShiftLow``,
``LzmaEnc.c:456-573``) driving the 12-state LZ grammar, fed by a hash-chain
match finder with one-step lazy evaluation (the spirit of the reference's
fast mode, ``GetOptimumFast`` ``LzmaEnc.c:1489-1595``; the optimal-parse DP
is a separate, later stage).  Output is valid LZMA decodable by any
conforming decoder.  The port's copy of the JAX package's
``models/lzma/encoder_ref.py``: the ``engine="python"`` encoder of
``engine.lzma_raw_encode`` and ``framing.encode``, byte-identical to the
JAX package's on the same input.
"""

from __future__ import annotations

from . import spec as S

_MASK32 = 0xFFFFFFFF


class RangeEncoder:
    """Carry-correct binary range encoder producing a byte stream."""

    __slots__ = ("out", "low", "range", "cache", "cache_size")

    def __init__(self):
        self.out = bytearray()
        self.low = 0
        self.range = _MASK32
        self.cache = 0
        self.cache_size = 1

    def _shift_low(self) -> None:
        low = self.low
        if low < 0xFF000000 or low > _MASK32:
            carry = low >> 32
            out = self.out
            out.append((self.cache + carry) & 0xFF)
            if self.cache_size > 1:
                out.extend(bytes([(0xFF + carry) & 0xFF]) * (self.cache_size - 1))
            self.cache = (low >> 24) & 0xFF
            self.cache_size = 0
        self.cache_size += 1
        self.low = (low & 0x00FFFFFF) << 8

    def encode_bit(self, probs, i: int, bit: int) -> None:
        p = probs[i]
        bound = (self.range >> S.RC_BIT_MODEL_TOTAL_BITS) * p
        if bit == 0:
            self.range = bound
            probs[i] = p + ((S.RC_BIT_MODEL_TOTAL - p) >> S.RC_MOVE_BITS)
        else:
            self.low += bound
            self.range -= bound
            probs[i] = p - (p >> S.RC_MOVE_BITS)
        while self.range < S.RC_TOP:
            self.range = (self.range << 8) & _MASK32
            self._shift_low()

    def encode_direct_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.range >>= 1
            if (value >> i) & 1:
                self.low += self.range
            while self.range < S.RC_TOP:
                self.range = (self.range << 8) & _MASK32
                self._shift_low()

    def encode_tree(self, probs, offset: int, num_bits: int, sym: int) -> None:
        m = 1
        for i in range(num_bits - 1, -1, -1):
            b = (sym >> i) & 1
            self.encode_bit(probs, offset + m, b)
            m = (m << 1) | b

    def encode_tree_reverse(self, probs, offset: int, num_bits: int, sym: int) -> None:
        m = 1
        for _ in range(num_bits):
            b = sym & 1
            sym >>= 1
            self.encode_bit(probs, offset + m, b)
            m = (m << 1) | b

    def flush(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


def _encode_len(rc: RangeEncoder, probs, base: int, pos_state: int, length: int) -> None:
    sym = length - S.MATCH_MIN_LEN
    if sym < S.LEN_LOW_SYMBOLS:
        rc.encode_bit(probs, base + S.LEN_CHOICE, 0)
        rc.encode_tree(probs, base + S.LEN_LOW + (pos_state << S.LEN_LOW_BITS),
                       S.LEN_LOW_BITS, sym)
    elif sym < S.LEN_LOW_SYMBOLS + S.LEN_MID_SYMBOLS:
        rc.encode_bit(probs, base + S.LEN_CHOICE, 1)
        rc.encode_bit(probs, base + S.LEN_CHOICE2, 0)
        rc.encode_tree(probs, base + S.LEN_MID + (pos_state << S.LEN_MID_BITS),
                       S.LEN_MID_BITS, sym - S.LEN_LOW_SYMBOLS)
    else:
        rc.encode_bit(probs, base + S.LEN_CHOICE, 1)
        rc.encode_bit(probs, base + S.LEN_CHOICE2, 1)
        rc.encode_tree(probs, base + S.LEN_HIGH, S.LEN_HIGH_BITS,
                       sym - S.LEN_LOW_SYMBOLS - S.LEN_MID_SYMBOLS)


_SLOTS = []  # distance → posSlot lookup for dist < 128


def _pos_slot(dist: int) -> int:
    if dist < S.NUM_FULL_DISTANCES:
        return _SLOTS[dist]
    n = dist.bit_length() - 1
    return (n << 1) | ((dist >> (n - 1)) & 1)


def _init_slots():
    for dist in range(S.NUM_FULL_DISTANCES):
        if dist < 4:
            _SLOTS.append(dist)
        else:
            n = dist.bit_length() - 1
            _SLOTS.append((n << 1) | ((dist >> (n - 1)) & 1))


_init_slots()


def _encode_dist(rc: RangeEncoder, probs, length: int, dist: int) -> None:
    slot = _pos_slot(dist)
    rc.encode_tree(probs,
                   S.POS_SLOT + (S.len_to_pos_state(length) << S.NUM_POS_SLOT_BITS),
                   S.NUM_POS_SLOT_BITS, slot)
    if slot >= 4:
        num_direct = (slot >> 1) - 1
        base = (2 | (slot & 1)) << num_direct
        rem = dist - base
        if slot < S.END_POS_MODEL_INDEX:
            rc.encode_tree_reverse(probs, S.SPEC_POS + base - slot - 1,
                                   num_direct, rem)
        else:
            rc.encode_direct_bits(rem >> S.NUM_ALIGN_BITS,
                                  num_direct - S.NUM_ALIGN_BITS)
            rc.encode_tree_reverse(probs, S.ALIGN, S.NUM_ALIGN_BITS,
                                   rem & (S.ALIGN_TABLE_SIZE - 1))


class MatchFinder:
    """Hash-chain match finder over the whole input buffer.

    4-byte-hash chains (the HC4 idea, ``LzFind.c:322-351``) with a bounded
    walk; returns the longest match and its distance.
    """

    __slots__ = ("data", "n", "head", "prev", "pos", "max_chain", "nice_len",
                 "dict_size", "hash_bits")

    @staticmethod
    def hash_bits_for(dict_size: int) -> int:
        """Dict-adaptive table size, identical to the native engine
        (LzFind.c sizes the hash from dictSize for the same reason:
        an undersized table makes chains collision-dominated)."""
        hb = 17
        while hb < 24 and (1 << hb) < dict_size:
            hb += 1
        return hb

    def __init__(self, data: bytes, dict_size: int,
                 max_chain: int = 16, nice_len: int = 64):
        self.data = data
        self.n = len(data)
        self.hash_bits = self.hash_bits_for(dict_size)
        self.head = [-1] * (1 << self.hash_bits)
        self.prev = [0] * self.n  # chain links
        self.pos = 0
        self.max_chain = max_chain
        self.nice_len = min(nice_len, S.MATCH_MAX_LEN)
        self.dict_size = dict_size

    def _hash(self, i: int) -> int:
        d = self.data
        le = d[i] | (d[i + 1] << 8) | (d[i + 2] << 16) | (d[i + 3] << 24)
        return ((le * 2654435761) & 0xFFFFFFFF) >> (32 - self.hash_bits)

    def insert(self, i: int) -> None:
        if i + 4 > self.n:
            return
        h = self._hash(i)
        self.prev[i] = self.head[h]
        self.head[h] = i

    def best_match(self, i: int) -> tuple[int, int]:
        """Longest match at position i → (length, dist) with dist ≥ 1; (0,0) if none."""
        d = self.data
        n = self.n
        if i + 4 > n:
            return 0, 0
        h = self._hash(i)
        cand = self.head[h]
        best_len = 0
        best_dist = 0
        chain = self.max_chain
        limit = min(n - i, S.MATCH_MAX_LEN)
        min_pos = i - self.dict_size
        while cand >= 0 and chain > 0 and cand >= min_pos:
            # quick reject: check the byte that would extend the best match
            if i + best_len < n and d[cand + best_len] == d[i + best_len]:
                ln = 0
                while ln < limit and d[cand + ln] == d[i + ln]:
                    ln += 1
                if ln > best_len:
                    best_len = ln
                    best_dist = i - cand
                    if ln >= self.nice_len:
                        break
            cand = self.prev[cand]
            chain -= 1
        return best_len, best_dist


class LzmaEncoder:
    """Stateful scalar LZMA encoder (state carried across LZMA2 chunks)."""

    def __init__(self, props: S.LzmaProps, *, max_chain: int = 16,
                 nice_len: int = 64):
        self.props = props
        self.max_chain = max_chain
        self.nice_len = nice_len
        self.reset_state()

    def reset_state(self) -> None:
        self.probs = [S.PROB_INIT] * self.props.num_probs
        self.state = 0
        self.reps = [0, 0, 0, 0]

    def save_state(self):
        """Model snapshot (LzmaEnc_SaveState semantics, ``LzmaEnc.c:339-389``)
        so LZMA2 can roll back a chunk that compressed poorly."""
        return (list(self.probs), self.state, list(self.reps))

    def restore_state(self, snap) -> None:
        probs, state, reps = snap
        self.probs = list(probs)
        self.state = state
        self.reps = list(reps)

    def encode_segment(self, data, start: int, end: int, *,
                       dic_start: int = 0,
                       write_end_mark: bool = False) -> bytes:
        """Encode data[start:end] as one raw-LZMA segment.

        ``data[dic_start:start]`` is usable dictionary history (for LZMA2
        chunks without dict reset); context positions are counted from
        ``dic_start`` (processedPos semantics).  The range coder is
        (re)initialized per segment, per LZMA2 chunk rules.
        """
        props = self.props
        probs = self.probs
        rc = RangeEncoder()
        state = self.state
        rep0, rep1, rep2, rep3 = self.reps
        pb_mask = (1 << props.pb) - 1
        lp_mask = (1 << props.lp) - 1
        lc = props.lc

        mf = MatchFinder(data, props.dict_size, self.max_chain, self.nice_len)
        # seed the finder with dictionary history
        for j in range(dic_start, start):
            mf.insert(j)

        i = start
        while i < end:
            # context positions relative to the dict-reset point (processedPos)
            pos = i - dic_start
            pos_state = pos & pb_mask
            # --- candidate: rep0 short/long, rep matches, normal match
            best_len, best_dist = mf.best_match(i)
            if best_len > end - i:
                best_len = end - i
            # never let a match cross the segment end with len<2
            if best_len < S.MATCH_MIN_LEN:
                best_len = 0
            # rep candidates
            rep_len = [0, 0, 0, 0]
            avail = min(end - i, S.MATCH_MAX_LEN)
            for ri, r in enumerate((rep0, rep1, rep2, rep3)):
                src = i - r - 1
                if src < dic_start:
                    continue
                ln = 0
                while ln < avail and data[src + ln] == data[i + ln]:
                    ln += 1
                rep_len[ri] = ln
            best_rep_idx = max(range(4), key=lambda k: rep_len[k])
            best_rep_len = rep_len[best_rep_idx]

            # --- GetOptimumFast-parity decisions (LzmaEnc.c:1489-1595
            # semantics, kept byte-identical to the native engine):
            use_match = best_len >= S.MATCH_MIN_LEN and best_len >= 2
            # normal match of len 2 only worthwhile if dist small
            if use_match and best_len == 2 and best_dist > 512:
                use_match = False
            # rep preference: within 1 of the main match always wins;
            # within 2 against distances >= 2^9; within 3 against
            # >= 2^15.  A chosen rep is taken WITHOUT lookahead.
            use_rep = best_rep_len >= 2 and (
                not use_match or best_rep_len + 1 >= best_len
                or (best_rep_len + 2 >= best_len and best_dist >= 1 << 9)
                or (best_rep_len + 3 >= best_len and best_dist >= 1 << 15))
            if use_rep:
                use_match = False
            mf_inserted = False
            if use_match and i + 1 < end and best_len < self.nice_len:
                mf.insert(i)
                mf_inserted = True
                nl, nd = mf.best_match(i + 1)

                def change_pair(s, b):
                    # "bigger distance only if 128x closer" lazy rule
                    return (b >> 7) > s

                if ((nl >= best_len and nd < best_dist)
                        or (nl == best_len + 1
                            and not change_pair(best_dist, nd))
                        or (nl > best_len + 1)
                        or (nl + 1 >= best_len and best_len >= 3
                            and change_pair(nd, best_dist))):
                    use_match = False
                else:
                    # a rep at i+1 within 1 of the match defers to literal
                    lim = min(best_len - 1, end - (i + 1))
                    for r in (rep0, rep1, rep2, rep3):
                        src = i + 1 - r - 1
                        if src < dic_start:
                            continue
                        l2 = 0
                        while l2 < lim and data[src + l2] == data[i + 1 + l2]:
                            l2 += 1
                        if l2 >= 2 and l2 + 1 >= best_len:
                            use_match = False
                            break

            if use_match or use_rep:
                is_rep = use_rep and not use_match
                length = best_rep_len if is_rep else best_len
                rc.encode_bit(probs, S.IS_MATCH + (state << S.NUM_POS_BITS_MAX) + pos_state, 1)
                if is_rep:
                    rc.encode_bit(probs, S.IS_REP + state, 1)
                    ri = best_rep_idx
                    if ri == 0:
                        rc.encode_bit(probs, S.IS_REP_G0 + state, 0)
                        rc.encode_bit(probs, S.IS_REP0_LONG + (state << S.NUM_POS_BITS_MAX) + pos_state, 1)
                    else:
                        rc.encode_bit(probs, S.IS_REP_G0 + state, 1)
                        if ri == 1:
                            rc.encode_bit(probs, S.IS_REP_G1 + state, 0)
                        else:
                            rc.encode_bit(probs, S.IS_REP_G1 + state, 1)
                            rc.encode_bit(probs, S.IS_REP_G2 + state, 1 if ri == 3 else 0)
                        # move-to-front
                        dist = (rep0, rep1, rep2, rep3)[ri]
                        if ri == 1:
                            rep1 = rep0
                        elif ri == 2:
                            rep2, rep1 = rep1, rep0
                        else:
                            rep3, rep2, rep1 = rep2, rep1, rep0
                        rep0 = dist
                    _encode_len(rc, probs, S.REP_LEN_CODER, pos_state, length)
                    state = S.state_after_rep(state)
                else:
                    dist = best_dist - 1
                    rc.encode_bit(probs, S.IS_REP + state, 0)
                    rep3, rep2, rep1, rep0 = rep2, rep1, rep0, dist
                    _encode_len(rc, probs, S.LEN_CODER, pos_state, length)
                    _encode_dist(rc, probs, length, dist)
                    state = S.state_after_match(state)
                if not mf_inserted:
                    mf.insert(i)
                for j in range(i + 1, i + length):
                    mf.insert(j)
                i += length
            else:
                # literal (also the best_rep_len==1 "short rep" opportunity:
                # cheap single-byte rep0 copy)
                if (rep_len[0] >= 1 and i - rep0 - 1 >= dic_start
                        and data[i - rep0 - 1] == data[i] and state >= 7):
                    # short rep is a win mostly in match states; encode it
                    rc.encode_bit(probs, S.IS_MATCH + (state << S.NUM_POS_BITS_MAX) + pos_state, 1)
                    rc.encode_bit(probs, S.IS_REP + state, 1)
                    rc.encode_bit(probs, S.IS_REP_G0 + state, 0)
                    rc.encode_bit(probs, S.IS_REP0_LONG + (state << S.NUM_POS_BITS_MAX) + pos_state, 0)
                    state = S.state_after_short_rep(state)
                    if not mf_inserted:
                        mf.insert(i)
                    i += 1
                    continue
                rc.encode_bit(probs, S.IS_MATCH + (state << S.NUM_POS_BITS_MAX) + pos_state, 0)
                prev = data[i - 1] if i > dic_start else 0
                lit_state = ((pos & lp_mask) << lc) + (prev >> (8 - lc))
                base = S.LITERAL + 0x300 * lit_state
                sym = data[i]
                if state < 7:
                    m = 1
                    for b_i in range(7, -1, -1):
                        b = (sym >> b_i) & 1
                        rc.encode_bit(probs, base + m, b)
                        m = (m << 1) | b
                else:
                    match_byte = data[i - rep0 - 1]
                    offs = 0x100
                    m = 1
                    for b_i in range(7, -1, -1):
                        b = (sym >> b_i) & 1
                        match_byte <<= 1
                        bit_ctx = match_byte & offs
                        rc.encode_bit(probs, base + offs + bit_ctx + m, b)
                        m = (m << 1) | b
                        if b:
                            offs &= bit_ctx
                        else:
                            offs &= ~bit_ctx
                state = S.state_after_literal(state)
                if not mf_inserted:
                    mf.insert(i)
                i += 1

        if write_end_mark:
            pos_state = (end - dic_start) & pb_mask
            rc.encode_bit(probs, S.IS_MATCH + (state << S.NUM_POS_BITS_MAX) + pos_state, 1)
            rc.encode_bit(probs, S.IS_REP + state, 0)
            _encode_len(rc, probs, S.LEN_CODER, pos_state, S.MATCH_MIN_LEN)
            _encode_dist(rc, probs, S.MATCH_MIN_LEN, _MASK32)
            state = S.state_after_match(state)
            rep3, rep2, rep1, rep0 = rep2, rep1, rep0, _MASK32

        self.state = state
        self.reps = [rep0, rep1, rep2, rep3]
        return rc.flush()


def lzma_encode(data: bytes, props: S.LzmaProps | None = None, *,
                write_end_mark: bool = False) -> bytes:
    """One-call raw-LZMA encode of a whole buffer."""
    props = props or S.LzmaProps()
    enc = LzmaEncoder(props)
    return enc.encode_segment(bytes(data), 0, len(data),
                              write_end_mark=write_end_mark)
