"""X3: CRC32 and CRC64 of a byte string on the card.

The counterpart of the JAX package's ``ops/checksum.py``, bit-exact to
``binascii.crc32`` (the reference's CRC32, ``7zCrcOpt.c:10-27``) and to the
xz CRC64 (``XzCrc64.c:6-33``, ``native.crc64``).  CRC is linear, and a state
is *unconditioned* (init 0, no final xor):

* leading zeros are free: ``state(0^k || M) = state(M)``;
* joining: ``state(A || B) = Z^|B| state(A) ^ state(B)``, ``Z`` the GF(2)
  matrix of one zero byte.

So the input is cut into tiles of ``TILE`` bytes, the last one short and
staged right-aligned in a zero tile, and every tile's state is computed on
its own (``crc_tiles``); one fold joins them and applies the init value and
the final xor (``crc_fold``).  Nothing is padded at the end, so no inverse
matrix is needed, and a call does matrix-vector products with the cached
powers ``Z^(2^k)`` only, never a squaring.

On the card ``crc32_device``/``crc64_device`` copy the input in pieces of
``PIECE`` bytes through two pinned staging buffers on a copy stream, and
launch each piece's tiles as soon as it lands (CUDA events order them), so
the host's copy, the link and the kernels overlap; the card holds two pieces
and the tile states.  On a CUDA tensor ``crc_tiles`` and ``crc_fold`` launch
the hand-written kernels (``csrc/checksum.cu``, the per-thread pieces in
``csrc/checksum_lane.cuh``) or raise; on a CPU tensor they run the plain
versions, ``tile_states_plain`` (each tile right-aligned in a zero row, the
JAX package's lockstep bit loop over its 64-byte blocks and a tree of their
joins, independent of the kernels' tables) and ``fold_plain`` (a chain of
joins).  ``launches`` counts tile launches, ``fold_launches`` fold launches.
No caller of the package routes its checks here yet: xz and 7z check on the
host.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import warnings

import numpy as np
import torch

from ..utils.checksums import CRC32_POLY, CRC64_POLY

BLOCK = 64            # bytes per block state of the plain version
TILE = 1 << 16        # bytes per tile (csrc/checksum.cu kTile)
PIECE = 16 << 20      # bytes per staged piece of a call on the card
TABLE_WORDS = 16 * 256   # slicing tables T_0..T_15 (csrc/checksum_lane.cuh)
POWERS = 64              # cached Z^(2^k), k = 0..63

launches = 0          # tile launches on the card; set to 0 to count
fold_launches = 0     # fold launches on the card

_M64 = (1 << 64) - 1
_I64_LOW63 = (1 << 63) - 1

# lzt_crc_init(width, consts, stream), lzt_crc_tiles(buf, n, width, consts,
# states, stream) and lzt_crc_fold(states, n, width, init, consts, out,
# stream) in csrc/checksum.cu
_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_ulonglong
_INIT_ARGTYPES = (_I, _P, _P)
_TILES_ARGTYPES = (_P, _L, _I, _P, _P, _P)
_FOLD_ARGTYPES = (_P, _L, _I, _U, _P, _P, _P)

_lock = threading.Lock()
_consts: dict = {}    # (width, device index) -> the tables and powers on the card


# ---------------------------------------------------------------------------
# GF(2) matrices (host side, numpy; built once per width)
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


def _poly(width: int) -> int:
    if width == 32:
        return CRC32_POLY
    if width == 64:
        return CRC64_POLY
    raise ValueError(f"width must be 32 or 64, got {width}")


@functools.lru_cache(maxsize=2)
def _powers(width: int) -> bytes:
    m = _zero_byte_matrix(_poly(width), width)
    out = np.zeros((POWERS, width), np.uint64)
    for k in range(POWERS):
        out[k] = m
        m = _gf2_matmul(m, m)
    return out.tobytes()


def powers(width: int) -> np.ndarray:
    """uint64 [POWERS, width]: row k is Z^(2^k) (column j the image of bit
    j), built once per width."""
    return np.frombuffer(_powers(width), dtype=np.uint64).reshape(POWERS, width)


def _apply(m: np.ndarray, v: int) -> int:
    r = 0
    for j in range(m.shape[0]):
        if (v >> j) & 1:
            r ^= int(m[j])
    return r


def _zpow_apply(width: int, m: int, v: int) -> int:
    """Z^m v through the cached powers: one product per set bit of m."""
    pw = powers(width)
    k = 0
    while m:
        if m & 1:
            v = _apply(pw[k], v)
        m >>= 1
        k += 1
    return v


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def block_states_plain(buf: torch.Tensor, width: int) -> torch.Tensor:
    """The state of each 64-byte block of ``buf`` (int64, CRC64's as two's
    complement) in torch ops: all blocks advance in lockstep, one vectorised
    step per input bit (the JAX package's ``_crc*_blocks``)."""
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


def _level_step(a: torch.Tensor, b: torch.Tensor, cols: np.ndarray,
                width: int) -> torch.Tensor:
    """Z^m a ^ b elementwise, ``cols`` the columns of Z^m: a tree level's
    join of left and right halves of one size."""
    cols = cols.view(np.int64)
    shifted = torch.zeros_like(a)
    for j in range(width):
        sel = ((a >> j) & 1).bool()
        shifted = torch.where(sel, shifted ^ int(cols[j]), shifted)
    return shifted ^ b


def tile_states_plain(buf: torch.Tensor, n: int, width: int,
                      tile: int = TILE) -> torch.Tensor:
    """``crc_tiles`` of the first ``n`` bytes of ``buf`` at ``tile`` bytes
    (a power of two of at least 64) in torch ops: each tile right-aligned
    in a zero row, the lockstep ``block_states_plain`` over its blocks, and
    a tree of their joins per row.  int64 [ceil(n / tile)]."""
    _poly(width)
    if tile < BLOCK or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two >= {BLOCK}, got {tile}")
    nt = -(-n // tile)
    if nt == 0:
        return torch.zeros(0, dtype=torch.int64)
    f, r = nt - 1, n - (nt - 1) * tile
    rows = torch.zeros(nt, tile, dtype=torch.uint8)
    rows[:f] = buf[:f * tile].reshape(f, tile).cpu()
    rows[f, tile - r:] = buf[f * tile:n].cpu()
    st = block_states_plain(rows.reshape(-1), width).reshape(nt, tile // BLOCK)
    pw = powers(width)
    lv = BLOCK.bit_length() - 1
    while st.shape[1] > 1:
        st = _level_step(st[:, 0::2], st[:, 1::2], pw[lv], width)
        lv += 1
    return st[:, 0].contiguous()


def fold_plain(states: torch.Tensor, n: int, width: int, value: int,
               tile: int = TILE) -> int:
    """``crc_fold`` as a chain: from the init state (``value`` ^ all-ones),
    each full tile joined with Z^tile, the last tile of r bytes with Z^r,
    then the final xor."""
    ones = (1 << width) - 1
    if n == 0:
        return value & ones
    st = [x & _M64 for x in states.tolist()]
    if len(st) != -(-n // tile):
        raise ValueError(f"{len(st)} states for {n} bytes at tile {tile}")
    ztile = powers(width)[tile.bit_length() - 1]
    acc = (value ^ ones) & ones
    for s in st[:-1]:
        acc = _apply(ztile, acc) ^ s
    acc = _zpow_apply(width, n - (len(st) - 1) * tile, acc) ^ st[-1]
    return acc ^ ones


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fn(name: str, argtypes: tuple):
    from . import _build
    fn = getattr(_build.library("checksum"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def _device_consts(width: int, device: torch.device) -> torch.Tensor:
    """The tables and powers of ``width`` on ``device``, built by the init
    kernel at first use and kept."""
    key = (width, device.index)
    with _lock:
        c = _consts.get(key)
        if c is None:
            dtype = torch.int64 if width == 64 else torch.int32
            c = torch.empty(TABLE_WORDS + POWERS * width, dtype=dtype,
                            device=device)
            with torch.cuda.device(device):
                rc = _fn("lzt_crc_init", _INIT_ARGTYPES)(
                    width, c.data_ptr(),
                    torch.cuda.current_stream(device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"crc init kernel launch failed: CUDA "
                                   f"error {rc}")
            # ready for a launch on any stream, once per width and device
            torch.cuda.current_stream(device).synchronize()
            _consts[key] = c
        return c


def _check_bytes(buf: torch.Tensor) -> None:
    if not isinstance(buf, torch.Tensor) or buf.dtype != torch.uint8 \
            or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous 1-D uint8 tensor")
    if buf.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {buf.device}")
    if buf.numel() == 0:
        raise ValueError("buf must not be empty")
    if buf.device.type == "cuda" and buf.data_ptr() % 16:
        raise ValueError("buf must be 16-byte aligned (the kernel loads "
                         "16 bytes at a time)")


def crc_tiles(buf: torch.Tensor, width: int, first_tile: int = 0,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """The unconditioned state of each TILE-byte tile of ``buf``, the last
    one short when len(buf) is not a multiple (the state of its own bytes):
    int64 [ceil(len(buf) / TILE)] on buf's device.  With ``out`` (int64 on
    the same device) the states go to ``out[first_tile:first_tile + tiles]``
    and that view is returned.

    On the card this launches the tile kernel on the current stream; on the
    CPU it runs ``tile_states_plain``."""
    _check_bytes(buf)
    _poly(width)
    n = buf.numel()
    tiles = -(-n // TILE)
    if out is None:
        if first_tile:
            raise ValueError("first_tile needs out")
        out = torch.empty(tiles, dtype=torch.int64, device=buf.device)
    if out.dtype != torch.int64 or out.dim() != 1 or not out.is_contiguous() \
            or out.device != buf.device or first_tile < 0 \
            or first_tile + tiles > out.numel():
        raise ValueError("out must be a contiguous 1-D int64 tensor on buf's "
                         "device with room for the tiles")
    view = out[first_tile:first_tile + tiles]
    if buf.device.type == "cpu":
        view.copy_(tile_states_plain(buf, n, width))
        return view
    consts = _device_consts(width, buf.device)
    with torch.cuda.device(buf.device):
        _launch_tiles(buf.data_ptr(), n, width, consts, view.data_ptr(),
                      torch.cuda.current_stream(buf.device))
    return view


def _launch_tiles(ptr: int, n: int, width: int, consts: torch.Tensor,
                  states_ptr: int, stream) -> None:
    """The tile launch itself, on ``stream`` of the current device, for
    arguments already checked."""
    global launches
    rc = _fn("lzt_crc_tiles", _TILES_ARGTYPES)(
        ptr, n, width, consts.data_ptr(), states_ptr, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crc tile kernel launch failed: CUDA error {rc}")
    launches += 1


def fold_launch(states: torch.Tensor, n: int, width: int,
                value: int) -> torch.Tensor:
    """Launches the fold on the current stream without reading it back:
    an int64 [1] on the card that gets the CRC."""
    global fold_launches
    consts = _device_consts(width, states.device)
    out = torch.empty(1, dtype=torch.int64, device=states.device)
    ones = (1 << width) - 1
    with torch.cuda.device(states.device):
        rc = _fn("lzt_crc_fold", _FOLD_ARGTYPES)(
            states.data_ptr(), n, width, (value ^ ones) & ones,
            consts.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(states.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crc fold kernel launch failed: CUDA error {rc}")
    fold_launches += 1
    return out


def crc_fold(states: torch.Tensor, n: int, width: int, value: int) -> int:
    """The CRC of an input of ``n`` bytes (n > 0) from ``value``, given its
    ceil(n / TILE) tile states.

    On the card this launches the fold (one block) and reads back one
    word; on the CPU it runs ``fold_plain``."""
    _poly(width)
    if not isinstance(states, torch.Tensor) or states.dtype != torch.int64 \
            or states.dim() != 1 or not states.is_contiguous():
        raise ValueError("states must be a contiguous 1-D int64 tensor")
    if n <= 0 or states.numel() != -(-n // TILE):
        raise ValueError(f"{states.numel()} states for {n} bytes")
    if states.device.type == "cpu":
        return fold_plain(states, n, width, value)
    if states.device.type != "cuda":
        raise ValueError(f"unsupported device {states.device}")
    return int(fold_launch(states, n, width, value).item()) & _M64


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _host_bytes(data) -> torch.Tensor:
    """``data`` (any C-contiguous buffer) as a uint8 CPU tensor, without a
    copy; it is only read."""
    view = memoryview(data).cast("B")
    if view.nbytes == 0:
        return torch.zeros(0, dtype=torch.uint8)
    with warnings.catch_warnings():      # read-only buffers are only read
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(view, dtype=torch.uint8)


def _crc_cuda(src: torch.Tensor, value: int, width: int,
              device: torch.device) -> int:
    n = src.numel()
    size = min(PIECE, n)
    consts = _device_consts(width, device)
    states = torch.empty(-(-n // TILE), dtype=torch.int64, device=device)
    host = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    dev = [torch.empty(size, dtype=torch.uint8, device=device)
           for _ in range(2)]
    copied = [torch.cuda.Event() for _ in range(2)]   # dev[b] holds its piece
    hashed = [torch.cuda.Event() for _ in range(2)]   # its tiles are launched
    stream = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device)
    with torch.cuda.device(device):
        for k, off in enumerate(range(0, n, PIECE)):
            m, b = min(PIECE, n - off), k & 1
            if k >= 2:
                copied[b].synchronize()      # host[b] is free again
                copy.wait_event(hashed[b])   # and dev[b]
            host[b][:m].copy_(src[off:off + m])
            with torch.cuda.stream(copy):
                dev[b][:m].copy_(host[b][:m], non_blocking=True)
            copied[b].record(copy)
            stream.wait_event(copied[b])
            _launch_tiles(dev[b].data_ptr(), m, width, consts,
                          states.data_ptr() + 8 * (off // TILE), stream)
            hashed[b].record(stream)
    return crc_fold(states, n, width, value)


def _crc(data, value: int, width: int, device) -> int:
    from ..api import check_device
    device = check_device(device)
    src = _host_bytes(data)
    n = src.numel()
    if n == 0:
        return value
    if device.type == "cpu":
        return fold_plain(tile_states_plain(src, n, width), n, width, value)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _crc_cuda(src, value, width, device)


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
