"""LZMA2 chunked stream framing.

Chunk grammar (as documented at ``Lzma2Dec.c:14-26``):

* ``00``                  — end of stream
* ``01 u16BE(n-1) data``  — copy chunk, with dict reset
* ``02 u16BE(n-1) data``  — copy chunk, no dict reset
* ``1uuuuuuu u16BE(ulow-1) u16BE(pack-1) [props] data``
    LZMA chunk; unpackSize-1 = (control & 0x1F) << 16 | u16BE; the two mode
    bits ``(control >> 5) & 3`` select what resets before the chunk:
    0 nothing / 1 state / 2 state+new props / 3 state+new props+dict.

Framing-level facts that make LZMA2 the device data-parallel unit:
chunks with dict reset start an independently decodable *group*; the chunk
scanner below splits a stream into such groups without decoding any payload,
which is what the lane-parallel device decoder consumes.  ``encode`` writes
such streams and ``decode`` reads them on the host (the native or the
pure-Python coder).

The dict-size prop byte maps 40 values k → ``(2 | (k & 1)) << (k // 2 + 11)``
(``Lzma2Enc.c:423-432`` / ``Lzma2Dec.c:61-73``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...utils.errors import DataError, InputEofError, ParamError
from ..lzma.spec import LzmaProps

CTRL_EOS = 0x00
CTRL_COPY_RESET_DIC = 0x01
CTRL_COPY_NO_RESET = 0x02

MODE_NOTHING = 0
MODE_STATE = 1
MODE_STATE_PROPS = 2
MODE_STATE_PROPS_DIC = 3

CHUNK_UNPACK_MAX = 1 << 21          # <= 2 MB unpacked per chunk
CHUNK_PACK_MAX = 1 << 16            # <= 64 KB packed per chunk
# default dict-reset group size of encode (the python engine cuts each group
# into 48 KiB sub-chunks; copy chunks cover what does not shrink)
DEFAULT_SUBCHUNK = 1 << 20


def encode_dict_prop(dict_size: int) -> int:
    """Smallest prop byte whose dict size is ≥ dict_size (40 sizes)."""
    for k in range(40):
        if (2 | (k & 1)) << (k // 2 + 11) >= dict_size:
            return k
    return 40


def decode_dict_prop(prop: int) -> int:
    if prop > 40:
        raise ParamError(f"bad LZMA2 dict prop {prop}")
    if prop == 40:
        return 0xFFFFFFFF
    return (2 | (prop & 1)) << (prop // 2 + 11)


@dataclass(frozen=True)
class Chunk:
    """One parsed chunk record (payload not decoded)."""

    is_lzma: bool
    mode: int               # MODE_* for LZMA chunks; dict-reset flag for copy
    reset_dic: bool
    unpack_size: int
    pack_size: int          # == unpack_size for copy chunks
    props: LzmaProps | None  # present when mode >= MODE_STATE_PROPS
    data_off: int           # offset of payload in stream
    unpack_off: int         # cumulative output offset


def scan(stream: bytes, start: int = 0) -> tuple[list[Chunk], int]:
    """Parse chunk headers without decoding payloads.

    Returns ``(chunks, end_offset)``; ``end_offset`` is just past the EOS
    byte (or == len(stream) if the stream ends without EOS, which we reject).
    """
    chunks: list[Chunk] = []
    pos = start
    n = len(stream)
    out_off = 0
    while True:
        if pos >= n:
            raise InputEofError("LZMA2 stream missing EOS control byte")
        ctrl = stream[pos]
        pos += 1
        if ctrl == CTRL_EOS:
            return chunks, pos
        if ctrl in (CTRL_COPY_RESET_DIC, CTRL_COPY_NO_RESET):
            if pos + 2 > n:
                raise InputEofError("truncated copy-chunk header")
            size = ((stream[pos] << 8) | stream[pos + 1]) + 1
            pos += 2
            if pos + size > n:
                raise InputEofError("truncated copy-chunk payload")
            chunks.append(Chunk(
                is_lzma=False, mode=MODE_NOTHING,
                reset_dic=(ctrl == CTRL_COPY_RESET_DIC),
                unpack_size=size, pack_size=size, props=None,
                data_off=pos, unpack_off=out_off))
            pos += size
            out_off += size
            continue
        if ctrl < 0x80:
            raise DataError(f"bad LZMA2 control byte {ctrl:#x}")
        mode = (ctrl >> 5) & 3
        if pos + 4 > n:
            raise InputEofError("truncated LZMA-chunk header")
        unpack = (((ctrl & 0x1F) << 16) | (stream[pos] << 8) | stream[pos + 1]) + 1
        pack = ((stream[pos + 2] << 8) | stream[pos + 3]) + 1
        pos += 4
        props = None
        if mode >= MODE_STATE_PROPS:
            if pos >= n:
                raise InputEofError("truncated LZMA2 props byte")
            props = LzmaProps.from_bytes(
                bytes([stream[pos]]) + (1 << 24).to_bytes(4, "little"))
            pos += 1
        if pos + pack > n:
            raise InputEofError("truncated LZMA-chunk payload")
        chunks.append(Chunk(
            is_lzma=True, mode=mode, reset_dic=(mode == MODE_STATE_PROPS_DIC),
            unpack_size=unpack, pack_size=pack, props=props,
            data_off=pos, unpack_off=out_off))
        pos += pack
        out_off += unpack


def split_groups(chunks: list[Chunk]) -> list[list[Chunk]]:
    """Split a chunk list into independently decodable dict-reset groups."""
    groups: list[list[Chunk]] = []
    for c in chunks:
        if c.reset_dic or not groups:
            if not c.reset_dic:
                raise DataError("LZMA2 stream does not start with a dict reset")
            groups.append([])
        groups[-1].append(c)
    return groups


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode(stream: bytes, dict_prop: int, *, engine: str = "auto") -> bytes:
    """Decode a raw LZMA2 stream (no leading prop byte) on the host:
    ``"auto"`` / ``"native"`` with the port's C++ decoder, ``"python"``
    with the scalar reference (``decode_chunks``); any other name raises
    UnsupportedError, where the JAX function sends it to ``decode_chunks``.
    The device engines take a stream through ``api.lzma2_uncompress``."""
    from ...engine import check_engine
    dict_size = decode_dict_prop(dict_prop)
    if check_engine(engine, "framing.decode") != "python":
        from ... import native
        return native.lzma2_decode(stream, dict_prop)
    chunks, _end = scan(stream)
    return decode_chunks(stream, chunks, dict_size=dict_size)


def decode_chunks(stream: bytes, chunks: list[Chunk], *,
                  dict_size: int = 0xFFFFFFFF) -> bytes:
    """Decode a chunk list on the host with the scalar reference decoder."""
    from ..lzma.decoder_ref import LzmaDecoder
    out = bytearray()
    dec: LzmaDecoder | None = None
    dic_start = 0
    need_init_state = True
    props: LzmaProps | None = None
    for c in chunks:
        if c.reset_dic:
            dic_start = len(out)
        if not c.is_lzma:
            out += stream[c.data_off:c.data_off + c.pack_size]
            need_init_state = True
            continue
        if c.mode >= MODE_STATE_PROPS:
            props = LzmaProps(lc=c.props.lc, lp=c.props.lp, pb=c.props.pb,
                              dict_size=min(dict_size, 0xFFFFFFFF))
            if dec is None or dec.props != props:
                dec = LzmaDecoder(props)
            else:
                dec.reset_state()
            need_init_state = False
        elif c.mode == MODE_STATE:
            if dec is None:
                raise DataError("LZMA2 state reset before props")
            dec.reset_state()
            need_init_state = False
        else:
            if dec is None or need_init_state:
                raise DataError("LZMA2 chunk needs state reset after copy chunk")
        expected_end = len(out) + c.unpack_size
        src_end, _mark = dec.decode(
            stream, out,
            unpack_limit=c.unpack_size,
            src_pos=c.data_off, src_limit=c.data_off + c.pack_size,
            dic_start=dic_start)
        if len(out) != expected_end:
            raise DataError("LZMA2 chunk produced wrong unpack size")
        if src_end != c.data_off + c.pack_size:
            raise DataError("LZMA2 chunk consumed wrong pack size")
    return bytes(out)


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def _chunk_header(is_lzma: bool, mode: int, unpack: int, pack: int,
                  props: LzmaProps | None, reset_dic: bool) -> bytes:
    if not is_lzma:
        return bytes([CTRL_COPY_RESET_DIC if reset_dic else CTRL_COPY_NO_RESET,
                      (unpack - 1) >> 8, (unpack - 1) & 0xFF])
    u = unpack - 1
    hdr = bytearray([0x80 | (mode << 5) | (u >> 16), (u >> 8) & 0xFF, u & 0xFF,
                     (pack - 1) >> 8, (pack - 1) & 0xFF])
    if mode >= MODE_STATE_PROPS:
        hdr.append(props.to_bytes()[0])
    return bytes(hdr)


def encode(data: bytes, *, dict_size: int = 1 << 24,
           chunk_size: int | None = None,
           parallel_groups: bool = True,
           lc: int = 3, lp: int = 0, pb: int = 2,
           effort: int = 9,
           engine: str = "auto") -> tuple[bytes, int]:
    """Encode bytes to a raw LZMA2 stream on the host; returns ``(stream,
    dict_prop)``.

    ``parallel_groups=True`` resets the dictionary every ``chunk_size``
    bytes, so each group decodes on its own (the device decoder's unit);
    with False only the first chunk resets (the reference's single stream,
    better ratio).  ``engine``: ``"auto"`` / ``"native"`` the port's C++
    encoder, ``"python"`` the pure-Python one (``encoder_ref``, a lazy parse
    that ignores ``effort``), each byte-identical to the JAX package's of
    that engine; any other name raises UnsupportedError (``engine.py``).
    """
    from ...engine import check_engine
    if check_engine(engine) != "python":
        from ... import native
        return native.lzma2_encode(data, dict_size, chunk_size,
                                   parallel_groups, lc=lc, lp=lp, pb=pb,
                                   effort=effort)

    prop_k = encode_dict_prop(dict_size)
    dict_size = decode_dict_prop(prop_k)
    chunk_size = chunk_size or DEFAULT_SUBCHUNK
    if chunk_size > CHUNK_UNPACK_MAX:
        raise ParamError("chunk_size > 2 MB")
    props = LzmaProps(lc=lc, lp=lp, pb=pb, dict_size=dict_size)

    from ..lzma.encoder_ref import LzmaEncoder
    enc = LzmaEncoder(props)
    out = bytearray()
    n = len(data)
    # the packed size field is 16-bit, so encode in sub-chunks whose packed
    # output stays < 64 KB; state continues across sub-chunks within a group
    # (the reference's subblock loop, Lzma2Enc.c:72-164)
    sub_unpack = min(chunk_size, 48 << 10)
    group_start = 0
    props_sent = False
    while group_start < n:
        group_end = min(group_start + chunk_size, n) if parallel_groups else n
        # each dict-reset group is an independent slice: no finder state or
        # lookahead crosses group boundaries
        gdata = data[group_start:group_end]
        gn = group_end - group_start
        enc.reset_state()
        first_of_group = True
        need_state_reset = True  # fresh group: state must be (re)declared
        pos = 0
        while pos < gn:
            end = min(pos + sub_unpack, gn)
            unpack = end - pos
            snap = enc.save_state()
            body = enc.encode_segment(gdata, pos, end, dic_start=0)
            if len(body) < min(unpack, CHUNK_PACK_MAX):
                if first_of_group:
                    mode = MODE_STATE_PROPS_DIC
                elif need_state_reset:
                    mode = MODE_STATE_PROPS if not props_sent else MODE_STATE
                else:
                    mode = MODE_NOTHING
                props_sent = True
                out += _chunk_header(True, mode, unpack, len(body), props,
                                     first_of_group)
                out += body
                need_state_reset = False
            else:
                # incompressible: roll the model back and emit copy chunks
                # (LzmaEnc_RestoreState + copy-chunk fallback,
                #  Lzma2Enc.c:87-164)
                enc.restore_state(snap)
                cpos = pos
                while cpos < end:
                    cend = min(cpos + CHUNK_PACK_MAX, end)
                    out += _chunk_header(False, 0, cend - cpos, cend - cpos,
                                         None, first_of_group)
                    out += gdata[cpos:cend]
                    first_of_group = False
                    cpos = cend
                # the next LZMA chunk carries a state reset (the grammar
                # requires one after a copy chunk) and the decoder re-inits
                # probs, state and reps: the encoder must match
                enc.reset_state()
                need_state_reset = True
            first_of_group = False
            pos = end
        group_start = group_end
    out.append(CTRL_EOS)
    return bytes(out), prop_k
