"""X3: CRC32 and CRC64 of a byte string on the card.

The counterpart of the JAX package's ``ops/checksum.py``, bit-exact to
``binascii.crc32`` (the reference's CRC32, ``7zCrcOpt.c:10-27``) and to the
xz CRC64 (``XzCrc64.c:6-33``, ``native.crc64``).  CRC is linear, so:

* the input is padded with zeros to a power of two of at least 64 bytes and
  cut into 64-byte blocks, and every block's *unconditioned* state (init 0)
  is computed on its own (``crc_blocks``);
* the states are joined up a binary tree, ``state(A||B) = Z^|B| state(A) ^
  state(B)`` with ``Z`` the one-zero-byte feed matrix: one GF(2) matrix per
  level, since a level's halves are all of one size (``crc_combine``);
* the host removes the padding with the inverse matrix and applies the init
  value and the final xor, with ``O(log n)`` GF(2) matrix squarings.

On a CUDA tensor ``crc_blocks`` and ``crc_combine`` launch the hand-written
kernels (``csrc/checksum.cu``, the per-block code in
``csrc/checksum_lane.cuh``) or raise; on a CPU tensor they run the plain
versions, ``block_states_plain`` and ``combine_plain``, a transcription of
the JAX package's lockstep in torch ops with every state an int64 (CRC64's
as its two's complement).  ``launches`` counts block-state launches,
``combine_launches`` combine launches.  No caller of the package routes its
checks here yet: xz and 7z check on the host.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

CRC32_POLY = 0xEDB88320
CRC64_POLY = 0xC96C5795D7870F42
BLOCK = 64            # bytes per block state (csrc/checksum_lane.cuh)
MAX_LEVELS = 8        # tree levels per combine launch (csrc/checksum.cu)

launches = 0          # block-state launches on the card; set to 0 to count
combine_launches = 0  # combine launches on the card

_M64 = (1 << 64) - 1
_I64_LOW63 = (1 << 63) - 1

# lzt_crc_blocks(words, lanes, width, states, stream) and
# lzt_crc_combine(in, n, mats, nlev, width, out, stream) in csrc/checksum.cu
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BLOCKS_ARGTYPES = [_P, _L, _I, _P, _P]
_COMBINE_ARGTYPES = [_P, _L, _P, _I, _I, _P, _P]


# ---------------------------------------------------------------------------
# GF(2) matrix helpers (host side, numpy; copied from the JAX package)
# ---------------------------------------------------------------------------

def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """c[i] = XOR_j b[i] bit j ? a[j]  (columns are integers)."""
    w = a.shape[0]
    c = np.zeros(w, dtype=a.dtype)
    for j in range(w):
        sel = ((b >> np.uint64(j)) & np.uint64(1)).astype(bool)
        c = np.where(sel, c ^ a[j], c)
    return c


def _zero_byte_matrix(poly: int, width: int) -> np.ndarray:
    """Matrix of feeding ONE zero byte into the reflected CRC register."""
    bit = np.zeros(width, dtype=np.uint64)
    for j in range(width):
        s = np.uint64(1) << np.uint64(j)
        bit[j] = (s >> np.uint64(1)) ^ (np.uint64(poly) * (s & np.uint64(1)))
    m = bit
    for _ in range(3):  # bit -> 2 bits -> 4 bits -> one byte
        m = _gf2_matmul(m, m)
    return m


def _matrix_power(m: np.ndarray, n: int) -> np.ndarray:
    """m^n by square-and-multiply (n >= 0)."""
    w = m.shape[0]
    r = np.uint64(1) << np.arange(w, dtype=np.uint64)  # identity
    b = m
    while n:
        if n & 1:
            r = _gf2_matmul(b, r)
        b = _gf2_matmul(b, b)
        n >>= 1
    return r


def _apply(m: np.ndarray, v: int) -> int:
    r = 0
    for j in range(m.shape[0]):
        if (v >> j) & 1:
            r ^= int(m[j])
    return r


def _inverse(m: np.ndarray) -> np.ndarray:
    """GF(2) matrix inverse by Gauss-Jordan on the columns."""
    w = m.shape[0]
    a = [int(m[j]) for j in range(w)]
    b = [1 << j for j in range(w)]
    for bit in range(w):
        piv = next((j for j in range(bit, w) if (a[j] >> bit) & 1), None)
        if piv is None:
            raise ArithmeticError("singular CRC shift matrix")
        a[bit], a[piv] = a[piv], a[bit]
        b[bit], b[piv] = b[piv], b[bit]
        for j in range(w):
            if j != bit and (a[j] >> bit) & 1:
                a[j] ^= a[bit]
                b[j] ^= b[bit]
    return np.array(b, dtype=np.uint64)


def _poly(width: int) -> int:
    if width == 32:
        return CRC32_POLY
    if width == 64:
        return CRC64_POLY
    raise ValueError(f"width must be 32 or 64, got {width}")


@functools.lru_cache(maxsize=4)
def _z1(width: int) -> bytes:
    return _zero_byte_matrix(_poly(width), width).tobytes()


def zero_byte_matrix(width: int) -> np.ndarray:
    """Z for ``width`` (cached): column j is the image of bit j."""
    return np.frombuffer(_z1(width), dtype=np.uint64).copy()


@functools.lru_cache(maxsize=8)
def _levels(width: int, levels: int) -> bytes:
    m = _matrix_power(zero_byte_matrix(width), BLOCK)
    out = np.zeros((max(levels, 1), width), np.uint64)
    for lv in range(levels):
        out[lv] = m
        m = _gf2_matmul(m, m)
    return out.tobytes()


def level_matrices(width: int, levels: int) -> np.ndarray:
    """uint64 [max(levels, 1), width]: row lv feeds BLOCK * 2^lv zero bytes,
    the size of one half at tree level lv."""
    return np.frombuffer(_levels(width, levels),
                         dtype=np.uint64).reshape(-1, width).copy()


# ---------------------------------------------------------------------------
# block states and the tree combine
# ---------------------------------------------------------------------------

def prep(data) -> tuple[np.ndarray, int]:
    """``data`` zero-padded to a power of two of at least BLOCK bytes (uint8)
    and its length."""
    n = len(data)
    padded = BLOCK
    while padded < n:
        padded *= 2
    buf = np.zeros(padded, np.uint8)
    buf[:n] = np.frombuffer(bytes(data), np.uint8)
    return buf, n


def _check_buf(buf: torch.Tensor) -> None:
    if not isinstance(buf, torch.Tensor) or buf.dtype != torch.uint8 \
            or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous 1-D uint8 tensor")
    if buf.numel() == 0 or buf.numel() % BLOCK:
        raise ValueError(f"buf's length must be a positive multiple of {BLOCK}")
    if buf.device.type == "cuda" and buf.data_ptr() % 16:
        raise ValueError("buf must be 16-byte aligned (the kernel loads "
                         "16 bytes at a time)")


def crc_blocks(buf: torch.Tensor, width: int) -> torch.Tensor:
    """The unconditioned state of each BLOCK-byte block of ``buf``: int64
    [len(buf) // BLOCK] on buf's device (CRC64's as two's complement).

    On the card this launches the block-state kernel on the current stream;
    on the CPU it runs ``block_states_plain``."""
    global launches
    _check_buf(buf)
    _poly(width)
    lanes = buf.numel() // BLOCK
    if buf.device.type == "cpu":
        return block_states_plain(buf, width)
    from . import _build
    states = torch.empty(lanes, dtype=torch.int64, device=buf.device)
    fn = _build.library("checksum").lzt_crc_blocks
    fn.restype = ctypes.c_int
    fn.argtypes = _BLOCKS_ARGTYPES
    with torch.cuda.device(buf.device):
        rc = fn(buf.data_ptr(), lanes, width, states.data_ptr(),
                torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crc block kernel launch failed: CUDA error {rc}")
    launches += 1
    return states


def block_states_plain(buf: torch.Tensor, width: int) -> torch.Tensor:
    """``crc_blocks`` in torch ops: all blocks advance in lockstep, one
    vectorised step per input bit (the JAX package's ``_crc*_blocks``)."""
    poly = _poly(width)
    poly = poly - (1 << 64) if poly >> 63 else poly
    words = buf.view(torch.int32).reshape(-1, BLOCK // 4).to(torch.int64) \
        & 0xFFFFFFFF
    s = torch.zeros(words.shape[0], dtype=torch.int64, device=buf.device)
    for k in range(BLOCK // 4):
        s = s ^ words[:, k]
        for _ in range(32):
            s = ((s >> 1) & _I64_LOW63) ^ (poly & -(s & 1))
    return s


def crc_combine(states: torch.Tensor, width: int) -> int:
    """The state of the whole input from its blocks' states (a power of two
    of them), as an unsigned int.

    On the card this launches the combine kernel once per ``MAX_LEVELS``
    tree levels and reads the one state back; on the CPU it runs
    ``combine_plain``."""
    global combine_launches
    n = states.numel()
    if n == 0 or n & (n - 1):
        raise ValueError(f"need a power of two of states, got {n}")
    levels = n.bit_length() - 1
    if states.device.type == "cpu":
        return combine_plain(states, width)
    from . import _build
    mats = torch.from_numpy(level_matrices(width, levels).view(np.int64)).to(
        states.device)
    fn = _build.library("checksum").lzt_crc_combine
    fn.restype = ctypes.c_int
    fn.argtypes = _COMBINE_ARGTYPES
    cur, lv = states, 0
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        while lv < levels:
            nlev = min(MAX_LEVELS, levels - lv)
            out = torch.empty(cur.numel() >> nlev, dtype=torch.int64,
                              device=states.device)
            rc = fn(cur.data_ptr(), cur.numel(), mats[lv].data_ptr(), nlev,
                    width, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"crc combine kernel launch failed: CUDA error {rc}")
            combine_launches += 1
            cur, lv = out, lv + nlev
    return int(cur[0]) & _M64


def combine_plain(states: torch.Tensor, width: int) -> int:
    """``crc_combine`` in torch ops, one tree level at a time (the JAX
    package's ``level``)."""
    n = states.numel()
    mats = level_matrices(width, n.bit_length() - 1).view(np.int64)
    st = states
    for lv in range(n.bit_length() - 1):
        a, b = st[0::2], st[1::2]
        shifted = torch.zeros_like(a)
        for j in range(width):
            sel = ((a >> j) & 1).bool()
            shifted = torch.where(sel, shifted ^ int(mats[lv, j]), shifted)
        st = shifted ^ b
    return int(st[0]) & _M64


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _crc(data, value: int, width: int, device) -> int:
    from ..api import check_device
    device = check_device(device)
    buf, n = prep(data)
    t = torch.from_numpy(buf).to(device)
    state = crc_combine(crc_blocks(t, width), width)
    # host fixup: state_0(M) = Zinv^pad(state_0(M || 0^pad)); conditioning
    # state_init(M) = state_0(M) ^ Z^n(init-state)
    z1 = zero_byte_matrix(width)
    full = (1 << width) - 1
    state = _apply(_matrix_power(_inverse(z1), len(buf) - n), state)
    state ^= _apply(_matrix_power(z1, n), (value ^ full) & full)
    return state ^ full


def crc32_device(data, value: int = 0, *, device="cuda") -> int:
    """CRC32 of ``data`` from ``value``, bit-exact to ``binascii.crc32``.
    ``device="cuda"`` (the default) runs the kernels and raises
    UnsupportedError with no card; ``device="cpu"`` runs the plain
    versions."""
    return _crc(data, value & 0xFFFFFFFF, 32, device)


def crc64_device(data, value: int = 0, *, device="cuda") -> int:
    """CRC64 (xz's check) of ``data`` from ``value``, bit-exact to
    ``native.crc64``; devices as for ``crc32_device``."""
    return _crc(data, value & _M64, 64, device)


def crc32_plain(data, value: int = 0) -> int:
    """``crc32_device`` through the plain versions on the CPU."""
    return crc32_device(data, value, device="cpu")


def crc64_plain(data, value: int = 0) -> int:
    """``crc64_device`` through the plain versions on the CPU."""
    return crc64_device(data, value, device="cpu")
