"""X4: batched branch and delta filters on the card.

The counterpart of the JAX package's ``ops/device_filters.py``, row for row
on the same inputs.  Every function takes ``[S, L]`` uint8 lanes with a
per-lane ``valid`` length (int32) and stream offset ``ip`` (uint32 values
in any integer dtype); lanes are independent streams, and bytes from
``valid`` on come back as they went in.

On a CUDA tensor each function launches its hand-written kernel on the
current stream, or raises; on a CPU tensor it runs its plain version, the
same function in torch ops.  ``launches`` counts the kernel submits of
each.

* ``arm`` (``Bra.c:6-31``), ``armt`` (``Bra.c:33-67``), ``ppc``
  (``Bra.c:69-97``), ``sparc`` (``Bra.c:99-133``), ``ia64``
  (``BraIA64.c:14-67``) and ``delta`` (``Delta.c:20-62``) have a fixed
  alignment.  Their kernels (``csrc/branch_filters.cu``, pieces in
  ``csrc/branch_filters_lane.cuh``) give a thread 16 bytes of a lane: four
  words, eight Thumb halfwords (each a gather from its neighbours) or an
  IA64 bundle; delta encode is the same kind of gather, delta decode
  (a per-residue-class prefix sum) three launches over segments of whole
  rows: per-segment class totals, their prefixes along each lane, and the
  segments' scans from those carries (a column walk for distances over
  256).  The plain versions
  (``arm_convert_plain`` ... ``delta_plain``) are a few vectorised torch
  operations over the batch; uint32 arithmetic runs in int64 masked to 32
  bits.  The five converters compare positions with ``valid`` as uint32,
  as the JAX functions do (a negative ``valid`` covers the whole row);
  delta, like x86, compares it signed.
* ``x86`` (``Bra86.c:11-85``) and BCJ2 decode (``Bcj2.c:28-127``) scan from
  one E8/E9 (or Jcc) site to the next.  Their kernels
  (``csrc/device_filters.cu``, pieces in ``csrc/filters_lane.cuh``) run
  x86 as a block per lane, a thread per stretch between sync points, and
  BCJ2 as the sites listed by blocks, one thread's range-decoder walk over
  them, the output placed by blocks; ``bcj2_info`` holds the per-lane
  counts of the last BCJ2 submit.  The plain versions,
  ``x86_convert_plain`` / ``bcj2_decode_plain``, transcribe the JAX
  package's lockstep candidate scan in torch ops.

``convert_batch`` dispatches a named branch filter over numpy arrays.  One
user path launches X4: the 7z device route (``containers/sevenzip.extract(
engine="device")``) decodes a BCJ folder's x86 filter with
``x86_convert_batch`` on the card, on the folder's K1 row where it is one
dict-reset group.  xz and 7z's host engines filter on the host
(``ops/filters.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_M32 = 0xFFFFFFFF

# kernel submits on the card; set to 0 by callers that count a run
launches = {"arm": 0, "armt": 0, "ppc": 0, "sparc": 0, "ia64": 0,
            "delta": 0, "x86": 0, "bcj2": 0}
# int32 [S, 4] on the card from the last BCJ2 submit: per lane the candidate
# sites listed, the conversions, the range decoder's steps and ok
bcj2_info = None

# lzt_x86_batch(in, out, row, valid, ip, n_lanes, encoding, stream) and
# lzt_bcj2_batch(main, main_w, main_len, call, call_w, call_len, jump,
# jump_w, jump_len, rc, rc_w, rc_len, out_size, out, out_cap, ok, cand,
# words, words_w, info, info_w, n_lanes, stream) in csrc/device_filters.cu;
# lzt_armt_batch and lzt_ia64_batch (in, out, row, valid, ip, n_lanes,
# encoding, stream), lzt_word_filter_batch (kind, the same),
# lzt_delta_batch(in, out, row, valid, dist, n_lanes, encoding, scratch,
# stream) and lzt_delta_scratch_bytes(row, dist, n_lanes, encoding) in
# csrc/branch_filters.cu
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_X86_ARGTYPES = [_P, _P, _L, _P, _P, _I, _I, _P]
_BCJ2_ARGTYPES = [_P, _I, _P] * 4 + [_P, _P, _I, _P, _P, _P, _I, _P, _I, _I,
                                     _P]
_DELTA_ARGTYPES = [_P, _P, _L, _P, _L, _I, _I, _P, _P]
_WORD_KIND = {"arm": 0, "ppc": 1, "sparc": 2}   # lzt_word_filter_batch


def _lanes(data, valid, ip):
    """(int64 copy of data, valid and ip as uint32 values in int64 column
    vectors): the converters compare with ``valid`` as uint32, as the JAX
    functions do."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be a 2-D uint8 tensor [S, L]")
    dev = data.device
    v = (torch.as_tensor(valid, device=dev).to(torch.int64) & _M32)[:, None]
    i = (torch.as_tensor(ip, device=dev).to(torch.int64) & _M32)[:, None]
    return data.to(torch.int64), v, i


def _convert(dest, pos, encoding: bool):
    """dest +- pos mod 2^32 (int64 in, int64 out)."""
    return ((dest + pos) if encoding else (dest - pos)) & _M32


def _words_be(b):
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def _unwords_be(w):
    return torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF,
                        w & 0xFF], dim=-1).to(torch.uint8)


def _check_lanes(data, valid, ip):
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8 \
            or data.dim() != 2:
        raise ValueError("data must be a 2-D uint8 tensor [S, L]")
    S = data.shape[0]
    for name, t in (("valid", valid), ("ip", ip)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != (S,) \
                or t.device != data.device:
            raise ValueError(f"{name} must be a tensor of shape ({S},) on "
                             f"{data.device}")


def _int32_bits(t):
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def _launch(name: str, entry: str, data, valid, ip, encoding: bool,
            out_w: int, *lead):
    """One submit of ``csrc/branch_filters.cu``'s ``entry`` (a converter)
    on the current stream: the output [S, out_w], allocated here; ``valid``
    goes as int32 holding the uint32 bits the kernels compare, ``ip`` as
    int64 (no copy where they come so)."""
    from . import _build
    S, L = data.shape
    dev = data.device
    out = torch.empty((S, out_w), dtype=torch.uint8, device=dev)
    if S == 0 or out_w == 0:
        return out
    src = data.contiguous()
    v = valid if valid.dtype == torch.int32 else \
        _int32_bits(valid.to(torch.int64) & _M32)
    i = ip.to(torch.int64)         # the kernels read its low 32 bits
    v, i = v.contiguous(), i.contiguous()
    fn = getattr(_build.library("branch_filters"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] * len(lead) + _X86_ARGTYPES
    with torch.cuda.device(dev):
        rc = fn(*lead, src.data_ptr(), out.data_ptr(), L, v.data_ptr(),
                i.data_ptr(), S, 1 if encoding else 0,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} filter kernel launch failed: CUDA error "
                           f"{rc}")
    launches[name] += 1
    return out


def _word_batch(name: str, data, valid, ip, encoding: bool):
    _check_lanes(data, valid, ip)
    if data.shape[1] % 4:
        raise ValueError(f"{name}: the lanes' length must be a multiple of 4")
    if data.device.type == "cpu":
        return _PLAIN[name](data, valid, ip, encoding=encoding)
    return _launch(name, "lzt_word_filter_batch", data, valid, ip, encoding,
                   data.shape[1], _WORD_KIND[name])


def arm_convert_batch(data, valid, ip, *, encoding: bool):
    """ARM BL over [S, L] lanes (L % 4 == 0): a 4-aligned word whose byte 3
    is 0xEB takes its 24-bit offset x 4 +- (ip + pos + 8).  On a CUDA tensor
    the kernel (a thread per 16 bytes), on a CPU one ``arm_convert_plain``."""
    return _word_batch("arm", data, valid, ip, encoding)


def ppc_convert_batch(data, valid, ip, *, encoding: bool):
    """PPC bl over [S, L] lanes (L % 4 == 0), big-endian words; kernel or
    ``ppc_convert_plain`` as ``arm_convert_batch``."""
    return _word_batch("ppc", data, valid, ip, encoding)


def sparc_convert_batch(data, valid, ip, *, encoding: bool):
    """SPARC call over [S, L] lanes (L % 4 == 0), big-endian words; kernel
    or ``sparc_convert_plain`` as ``arm_convert_batch``."""
    return _word_batch("sparc", data, valid, ip, encoding)


def armt_convert_batch(data, valid, ip, *, encoding: bool):
    """ARM Thumb BL pairs over [S, L] lanes: returns [S, L // 2 * 2].  On a
    CUDA tensor the kernel (a thread per 8 output halfwords, each gathered
    from the pair that starts or ends at it), on a CPU one
    ``armt_convert_plain``."""
    _check_lanes(data, valid, ip)
    if data.device.type == "cpu":
        return armt_convert_plain(data, valid, ip, encoding=encoding)
    return _launch("armt", "lzt_armt_batch", data, valid, ip, encoding,
                   data.shape[1] // 2 * 2)


def ia64_convert_batch(data, valid, ip, *, encoding: bool):
    """IA64 brl rewrite over [S, L] lanes, the tail ``L % 16`` copied.  On a
    CUDA tensor the kernel (a thread per bundle), on a CPU one
    ``ia64_convert_plain``."""
    _check_lanes(data, valid, ip)
    if data.device.type == "cpu":
        return ia64_convert_plain(data, valid, ip, encoding=encoding)
    return _launch("ia64", "lzt_ia64_batch", data, valid, ip, encoding,
                   data.shape[1])


def delta_batch(data, valid, *, dist: int, encoding: bool):
    """Distance-``dist`` byte delta over [S, L] lanes (``dist >= 1``; one of
    ``L`` or more leaves the rows as they are): encode ``out[i] = data[i] -
    data[i - dist]``, decode ``out[i] = data[i] + out[i - dist]``, for i
    below the lane's ``valid`` (compared signed).  On a CUDA tensor the
    kernels (encode a gather; decode per-segment totals, their carries and
    the segments' scans, over a scratch this call allocates on the current
    stream), on a CPU one ``delta_plain``."""
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8 \
            or data.dim() != 2:
        raise ValueError("data must be a 2-D uint8 tensor [S, L]")
    S, L = data.shape
    if not isinstance(valid, torch.Tensor) or tuple(valid.shape) != (S,) \
            or valid.device != data.device:
        raise ValueError(f"valid must be a tensor of shape ({S},) on "
                         f"{data.device}")
    if int(dist) < 1:
        raise ValueError(f"delta distance must be >= 1, not {dist}")
    if data.device.type == "cpu":
        return delta_plain(data, valid, dist=dist, encoding=encoding)
    from . import _build
    dev = data.device
    out = torch.empty((S, L), dtype=torch.uint8, device=dev)
    if S == 0 or L == 0:
        return out
    src = data.contiguous()
    v = valid if valid.dtype == torch.int32 else \
        valid.to(torch.int64).clamp(-1, L).to(torch.int32)
    v = v.contiguous()
    lib = _build.library("branch_filters")
    fn, size = lib.lzt_delta_batch, lib.lzt_delta_scratch_bytes
    fn.restype, fn.argtypes = ctypes.c_int, _DELTA_ARGTYPES
    size.restype, size.argtypes = ctypes.c_longlong, [_L, _L, _I, _I]
    d, enc = min(int(dist), L), 1 if encoding else 0
    with torch.cuda.device(dev):
        scratch = torch.empty(max(size(L, d, S, enc), 1), dtype=torch.uint8,
                              device=dev)
        rc = fn(src.data_ptr(), out.data_ptr(), L, v.data_ptr(), d, S, enc,
                scratch.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"delta kernel launch failed: CUDA error {rc}")
    launches["delta"] += 1
    return out


# ---------------------------------------------------------------------------
# the plain versions of the converters and delta
# ---------------------------------------------------------------------------

def arm_convert_plain(data, valid, ip, *, encoding: bool):
    """``arm_convert_batch`` in torch ops."""
    S, L = data.shape
    d, v, i = _lanes(data, valid, ip)
    w = d.reshape(S, L // 4, 4)
    pos_in = torch.arange(L // 4, device=data.device) << 2
    hit = (w[..., 3] == 0xEB) & (pos_in[None, :] + 4 <= v)
    dest = ((w[..., 2] << 16) | (w[..., 1] << 8) | w[..., 0]) << 2
    conv = _convert(dest, (pos_in[None, :] + i + 8) & _M32, encoding) >> 2
    new = torch.stack([conv & 0xFF, (conv >> 8) & 0xFF, (conv >> 16) & 0xFF,
                       w[..., 3]], dim=-1)
    return torch.where(hit[..., None], new, w).to(torch.uint8).reshape(S, L)


def ppc_convert_plain(data, valid, ip, *, encoding: bool):
    """``ppc_convert_batch`` in torch ops."""
    S, L = data.shape
    d, v, i = _lanes(data, valid, ip)
    b = d.reshape(S, L // 4, 4)
    w = _words_be(b)
    pos_in = torch.arange(L // 4, device=data.device) << 2
    hit = (((b[..., 0] & 0xFC) == 0x48) & ((b[..., 3] & 0x3) == 1)
           & (pos_in[None, :] + 4 <= v))
    conv = _convert(w & 0x03FFFFFC, (pos_in[None, :] + i) & _M32, encoding)
    neww = 0x48000000 | (conv & 0x03FFFFFC) | (w & 0x3)
    return _unwords_be(torch.where(hit, neww, w)).reshape(S, L)


def sparc_convert_plain(data, valid, ip, *, encoding: bool):
    """``sparc_convert_batch`` in torch ops."""
    S, L = data.shape
    d, v, i = _lanes(data, valid, ip)
    b = d.reshape(S, L // 4, 4)
    w = _words_be(b)
    pos_in = torch.arange(L // 4, device=data.device) << 2
    hit = ((((b[..., 0] == 0x40) & ((b[..., 1] & 0xC0) == 0))
            | ((b[..., 0] == 0x7F) & ((b[..., 1] & 0xC0) == 0xC0)))
           & (pos_in[None, :] + 4 <= v))
    conv = _convert((w << 2) & _M32, (pos_in[None, :] + i) & _M32,
                    encoding) >> 2
    # Bra.c:124 sign-replicates bit 22 over bits 22-29; bits 0-21 survive
    conv = ((conv & 0x003FFFFF) | 0x40000000
            | torch.where((conv & 0x400000) != 0, 0x3FC00000, 0))
    return _unwords_be(torch.where(hit, conv, w)).reshape(S, L)


def armt_convert_plain(data, valid, ip, *, encoding: bool):
    """``armt_convert_batch`` in torch ops (Bra.c:33-67): a candidate
    halfword pair needs ``(b[2h+1] & 0xF8) == 0xF0`` and ``(b[2h+3] & 0xF8)
    == 0xF8``, which no byte meets at once, so neighbouring candidates never
    overlap and every one converts on its own.  Returns [S, L // 2 * 2]."""
    S, L = data.shape
    H = L // 2
    d, v, i = _lanes(data[:, :H * 2], valid, ip)
    hw = d.reshape(S, H, 2)
    a0, a1 = hw[:, :, 0].clone(), hw[:, :, 1].clone()
    b0, b1 = a0[:, :-1], a1[:, :-1]          # halfword h
    b2, b3 = a0[:, 1:], a1[:, 1:]            # halfword h + 1
    pos_in = torch.arange(max(H - 1, 0), device=data.device) << 1
    hit = (((b1 & 0xF8) == 0xF0) & ((b3 & 0xF8) == 0xF8)
           & (pos_in[None, :] + 4 <= v))
    src = (((b1 & 0x7) << 19) | (b0 << 11) | ((b3 & 0x7) << 8) | b2) << 1
    dest = _convert(src, (pos_in[None, :] + i + 4) & _M32, encoding) >> 1
    out0, out1 = a0.clone(), a1.clone()
    out0[:, :-1] = torch.where(hit, (dest >> 11) & 0xFF, out0[:, :-1])
    out1[:, :-1] = torch.where(hit, 0xF0 | ((dest >> 19) & 0x7), out1[:, :-1])
    out0[:, 1:] = torch.where(hit, dest & 0xFF, out0[:, 1:])
    out1[:, 1:] = torch.where(hit, 0xF8 | ((dest >> 8) & 0x7), out1[:, 1:])
    return torch.stack([out0, out1], dim=-1).to(torch.uint8).reshape(S, H * 2)


# IA64 brl slot table: template -> 3-bit slot mask (BraIA64.c:5-12)
_IA64_BR_TABLE = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                  4, 4, 6, 6, 0, 0, 7, 7, 4, 4, 0, 0, 4, 4, 0, 0)


def ia64_convert_plain(data, valid, ip, *, encoding: bool):
    """``ia64_convert_batch`` in torch ops (BraIA64.c:14-67).  Bundles are
    stateless and the three 41-bit slots are bitwise disjoint, so bundles
    and slots convert in parallel; each slot's window is read as a low
    32-bit word and a high 16-bit one."""
    S, L = data.shape
    NB = L // 16
    d, v, i = _lanes(data[:, :NB * 16], valid, ip)
    out = d.reshape(S, NB, 16).clone()
    table = torch.tensor(_IA64_BR_TABLE, dtype=torch.int64, device=data.device)
    tmpl_mask = table[out[..., 0] & 0x1F]
    nb = torch.arange(NB, device=data.device)[None, :] * 16
    bundle_ok = nb + 16 <= v
    pos = (nb + i) & _M32
    for slot in range(3):
        bit_pos = 5 + slot * 41
        bp, br = bit_pos >> 3, bit_pos & 7
        lo32 = (out[..., bp] | (out[..., bp + 1] << 8)
                | (out[..., bp + 2] << 16) | (out[..., bp + 3] << 24))
        hi16 = out[..., bp + 4] | (out[..., bp + 5] << 8)
        norm_lo = ((lo32 >> br) | (hi16 << (32 - br))) & _M32
        norm_hi = hi16 >> br
        is_brl = (((norm_hi >> 5) & 0xF) == 0x5) & (((norm_lo >> 9) & 0x7) == 0)
        hit = (((tmpl_mask >> slot) & 1) == 1) & is_brl & bundle_ok
        src = ((((norm_lo >> 13) | (norm_hi << 19)) & 0xFFFFF)
               | (((norm_hi >> 4) & 1) << 20)) << 4
        dest = _convert(src, pos, encoding) >> 4
        nlo = (norm_lo & 0x1FFF) | ((dest & 0x7FFFF) << 13)
        nhi = ((norm_hi & (_M32 ^ 0x11)) | ((dest >> 19) & 1)
               | (((dest >> 20) & 1) << 4))
        new_lo32 = ((lo32 & ((1 << br) - 1)) | (nlo << br)) & _M32
        new_hi16 = ((nlo >> (32 - br)) | (nhi << br)) & 0xFFFF
        for j, val in enumerate((new_lo32 & 0xFF, (new_lo32 >> 8) & 0xFF,
                                 (new_lo32 >> 16) & 0xFF, new_lo32 >> 24,
                                 new_hi16 & 0xFF, new_hi16 >> 8)):
            out[..., bp + j] = torch.where(hit, val, out[..., bp + j])
    out = out.to(torch.uint8).reshape(S, NB * 16)
    if NB * 16 < L:
        out = torch.cat([out, data[:, NB * 16:]], dim=1)
    return out


def delta_plain(data, valid, *, dist: int, encoding: bool):
    """``delta_batch`` in torch ops: decode a prefix sum per residue class
    (the batch reshaped to [S, ceil(L / dist), dist], summed along the
    middle axis mod 256); encode the shifted subtract."""
    S, L = data.shape
    pad = (-L) % dist
    d = torch.nn.functional.pad(data.to(torch.int64), (0, pad))
    cols = d.reshape(S, (L + pad) // dist, dist)
    if encoding:
        prev = torch.nn.functional.pad(cols, (0, 0, 1, 0))[:, :-1, :]
        out = cols - prev
    else:
        out = torch.cumsum(cols, dim=1)
    out = (out & 0xFF).to(torch.uint8).reshape(S, L + pad)[:, :L]
    v = torch.as_tensor(valid, device=data.device).to(torch.int64)[:, None]
    idx = torch.arange(L, device=data.device)[None, :]
    return torch.where(idx < v, out, data)


_PLAIN = {"arm": arm_convert_plain, "ppc": ppc_convert_plain,
          "sparc": sparc_convert_plain}


# ---------------------------------------------------------------------------
# x86 BCJ
# ---------------------------------------------------------------------------

_M2ALLOW = (1, 1, 1, 0, 1, 0, 0, 0)     # Bra86.c:15
_M2BIT = (0, 1, 2, 2, 3, 3, 3, 3)       # Bra86.c:16


def x86_convert_batch(data, valid, ip, *, encoding: bool):
    """x86 BCJ E8/E9 rewrite over [S, L] lanes (``Bra86.c:11-85``), from
    mask state 0, converting sites at p < valid - 4: equal to the host's
    ``ops/filters.x86_convert`` over each lane's ``valid`` bytes.

    As in the JAX function, a lane's scan stops after L steps and reads
    and writes its row's last byte for every index past it, which only a
    ``valid`` above L reaches.

    On a CUDA tensor this launches the kernel on the current stream (a
    block per lane that stages the row through shared memory and runs the
    machine on many threads, each from a sync point to the next; it writes
    every byte of the output); on a CPU tensor it runs
    ``x86_convert_plain``."""
    _check_lanes(data, valid, ip)
    if data.device.type == "cpu":
        return x86_convert_plain(data, valid, ip, encoding=encoding)
    from . import _build
    S, L = data.shape
    src = data.contiguous()
    out = torch.empty_like(src)
    v = valid.to(torch.int32).contiguous()
    i = (ip.to(torch.int64) & _M32).contiguous()
    fn = _build.library("device_filters").lzt_x86_batch
    fn.restype = ctypes.c_int
    fn.argtypes = _X86_ARGTYPES
    with torch.cuda.device(data.device):
        rc = fn(src.data_ptr(), out.data_ptr(), L, v.data_ptr(),
                i.data_ptr(), S, 1 if encoding else 0,
                torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"x86 filter kernel launch failed: CUDA error {rc}")
    launches["x86"] += 1
    return out


def x86_convert_plain(data, valid, ip, *, encoding: bool):
    """``x86_convert_batch`` in torch ops: the JAX package's two-pass
    formulation.  The lanes step in lockstep from one E8/E9 candidate to
    the next over a next-candidate table of the original bytes, so the
    iterations are the most candidates of any lane; conversions patch a
    separate copy (every read lies at or after the candidate, every patch
    before the resumption point).  A step in which no lane converts skips
    the conversion's operations, and the dest retry stops once no lane
    goes on: both leave the rows as the full step would."""
    S, L = data.shape
    dev = data.device
    d8 = data.to(torch.int64)
    rows = torch.arange(S, device=dev)
    limit = valid.to(torch.int64) - 4
    posL = torch.arange(L, device=dev)
    cand = (d8 == 0xE8) | (d8 == 0xE9)
    nxt = torch.where(cand, posL, L).flip(1).cummin(1).values.flip(1)
    allow_t = torch.tensor(_M2ALLOW, device=dev)
    m2b_t = torch.tensor(_M2BIT, device=dev)
    ipu = ip.to(torch.int64) & _M32

    win = torch.arange(5, device=dev)
    shifts = torch.arange(0, 32, 8, device=dev)

    def take1(tbl, idx):
        return tbl[rows, idx.clamp(0, L - 1)]

    def test86(b):
        return (b == 0) | (b == 0xFF)

    out = data.clone()
    ptr = nxt[:, 0].clone()
    prev_pos = torch.full((S,), -1, dtype=torch.int64, device=dev)
    mask = torch.zeros(S, dtype=torch.int64, device=dev)
    for _ in range(L):
        act = ptr < limit
        if not bool(act.any()):
            break
        p = torch.where(act, ptr, 0)
        dist = p - prev_pos
        mask = torch.where(dist > 3, 0, (mask << (dist - 1).clamp(0, 3)) & 7)
        prev_pos = torch.where(act, p, prev_pos)
        allowed = allow_t[mask] != 0
        m2b = m2b_t[mask]
        w = d8.gather(1, (p[:, None] + win).clamp(max=L - 1))   # p .. p+4
        skip1 = (mask != 0) & (~allowed | test86(
            w.gather(1, (4 - m2b)[:, None])[:, 0]))
        convm = act & ~skip1 & test86(w[:, 4])
        mask = torch.where(act & ~convm, ((mask << 1) & 7) | 1, mask)
        step = torch.where(act, take1(nxt, p + 1), ptr)
        if not bool(convm.any()):
            ptr = step
            continue
        src = (w[:, 1:] << shifts).sum(1)
        pos = (ipu + p + 5) & _M32
        going = convm
        dest = torch.zeros_like(src)
        idx8 = m2b << 3
        xm = (1 << (32 - idx8).clamp(0, 31)) - 1
        for _t in range(8):      # Bra86.c:58-67 settles in <= 2 trips
            d_t = _convert(src, pos, encoding)
            dest = torch.where(going, d_t, dest)
            bb = (d_t >> (24 - idx8).clamp(0, 31)) & 0xFF
            going = going & (mask != 0) & test86(bb)
            if not bool(going.any()):
                break
            src = torch.where(going, d_t ^ xm, src)
        dest = dest & 0x01FFFFFF
        dest = torch.where((dest & 0x01000000) != 0, dest | 0xFE000000, dest)
        nb = ((dest[:, None] >> shifts) & 0xFF).to(torch.uint8)
        if int(p.max()) + 4 < L:       # p+1 .. p+4 distinct: one scatter
            cols = p[:, None] + win[1:]
            out.scatter_(1, cols, torch.where(convm[:, None], nb,
                                              out.gather(1, cols)))
        else:                          # clamped columns: the last one wins
            for j in range(4):
                col = (p + 1 + j).clamp(0, L - 1)
                out[rows, col] = torch.where(convm, nb[:, j], out[rows, col])
        ptr = torch.where(convm, take1(nxt, p + 5), step)
    return out


# ---------------------------------------------------------------------------
# BCJ2 decode
# ---------------------------------------------------------------------------

def _check_bcj2(streams, lens, out_size):
    dev = streams[0].device
    S = streams[0].shape[0]
    for name, t in zip(("main", "call", "jump", "rc"), streams):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8 \
                or t.dim() != 2 or t.shape[0] != S or t.shape[1] < 1 \
                or t.device != dev:
            raise ValueError(f"{name} must be a uint8 tensor [{S}, >= 1] "
                             f"on {dev}")
    for name, t in zip(("main_len", "call_len", "jump_len", "rc_len",
                        "out_size"), (*lens, out_size)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != (S,) \
                or t.device != dev:
            raise ValueError(f"{name} must be a tensor of shape ({S},) on "
                             f"{dev}")


def bcj2_decode_batch(main, main_len, call, call_len, jump, jump_len, rc,
                      rc_len, out_size):
    """BCJ2 4-stream decode over lanes (``Bcj2.c:28-127``): a range-coded
    adaptive flag per E8/E9/Jcc site of a lane's main stream selects whether
    the next 4 output bytes come from its BE call (E8) or jump stream.

    Shapes: main/call/jump/rc are uint8 [S, *], their lengths and out_size
    [S].  Returns (out [S, out_cap] uint8, ok [S] bool) with out_cap =
    main.shape[1] + call.shape[1] + jump.shape[1].  ``ok`` is false where a
    call or jump stream runs out or the main bytes the output needs,
    ``out_size - 4 * conversions``, are not within 0..main_len.  Where
    ``ok`` is true, ``out`` holds the output in its first out_size bytes and
    zeros after; where it is false, the lane's row of ``out`` is
    unspecified.

    On a CUDA tensor this submits the kernels on the current stream
    (blocks over each lane's main row list its candidate sites, one thread
    per lane walks them with the range decoder, blocks over each output
    row write it whole; ``bcj2_info`` keeps the per-lane counts); on a CPU
    tensor it runs ``bcj2_decode_plain``."""
    streams = (main, call, jump, rc)
    lens = (main_len, call_len, jump_len, rc_len)
    _check_bcj2(streams, lens, out_size)
    if main.device.type == "cpu":
        return bcj2_decode_plain(main, main_len, call, call_len, jump,
                                 jump_len, rc, rc_len, out_size)
    from . import _build
    S = main.shape[0]
    out_cap = main.shape[1] + call.shape[1] + jump.shape[1]
    streams = [t.contiguous() for t in streams]
    lens = [t.to(torch.int32).contiguous() for t in lens]
    osz = out_size.to(torch.int32).contiguous()
    dev = main.device
    out = torch.empty((S, out_cap), dtype=torch.uint8, device=dev)
    ok = torch.empty(S, dtype=torch.int32, device=dev)
    lib = _build.library("device_filters")
    lib.lzt_bcj2_chunks.restype = lib.lzt_bcj2_words.restype = ctypes.c_int
    lib.lzt_bcj2_chunks.argtypes = [_I]
    lib.lzt_bcj2_words.argtypes = [_I, _I]
    # per lane the 4 counts of bcj2_info, then a count per chunk of main
    info = torch.empty((S, 4 + lib.lzt_bcj2_chunks(main.shape[1])),
                       dtype=torch.int32, device=dev)
    # the lanes' site lists (8-byte entries) and call and jump words
    cand = torch.empty((S, main.shape[1]), dtype=torch.int64, device=dev)
    words = torch.empty((S, lib.lzt_bcj2_words(call.shape[1], jump.shape[1])),
                        dtype=torch.int32, device=dev)
    args = []
    for t, n in zip(streams, lens):
        args += [t.data_ptr(), t.shape[1], n.data_ptr()]
    fn = lib.lzt_bcj2_batch
    fn.restype = ctypes.c_int
    fn.argtypes = _BCJ2_ARGTYPES
    with torch.cuda.device(dev):
        rc_ = fn(*args, osz.data_ptr(), out.data_ptr(), out_cap, ok.data_ptr(),
                 cand.data_ptr(), words.data_ptr(), words.shape[1],
                 info.data_ptr(), info.shape[1], S,
                 torch.cuda.current_stream(dev).cuda_stream)
    if rc_ != 0:
        raise RuntimeError(f"bcj2 kernel launch failed: CUDA error {rc_}")
    global bcj2_info
    bcj2_info = info[:, :4]
    launches["bcj2"] += 1
    return out, ok != 0


def bcj2_decode_plain(main, main_len, call, call_len, jump, jump_len, rc,
                      rc_len, out_size):
    """``bcj2_decode_batch`` in torch ops: the JAX package's lockstep scan
    over a candidate superset (E8/E9/8x bytes of main; the ``prev == 0x0F``
    half of the Jcc test is checked in the loop) with a masked range decoder
    per lane, then the output assembled by two scatters.  A step in which
    no lane meets a site, or no lane converts, skips the operations that
    would leave every lane as it was."""
    S, Lm = main.shape
    dev = main.device
    rows = torch.arange(S, device=dev)
    m8 = main.to(torch.int64)
    posL = torch.arange(Lm, device=dev)
    main_len = main_len.to(torch.int64)
    is_t = ((m8 & 0xFE) == 0xE8) | ((m8 & 0xF0) == 0x80)
    # a Jcc byte is a site only after 0F, or after a site whose rel32 ends
    # in 0F: one after any other byte never is, and leaves the superset
    prev_m = torch.nn.functional.pad(m8[:, :-1], (1, 0))
    prev_t = torch.nn.functional.pad(is_t[:, :-1], (1, 0))
    is_t &= ((m8 & 0xFE) == 0xE8) | (prev_m == 0x0F) | prev_t
    cand = is_t & (posL[None, :] < main_len[:, None])
    nxt = torch.where(cand, posL, Lm).flip(1).cummin(1).values.flip(1)
    # one column past the row, so a site in the row's last byte steps to Lm
    # and ends the scan (the JAX table has no such column: its scan then
    # stays on that byte and never ends)
    nxt = torch.nn.functional.pad(nxt, (0, 1), value=Lm)

    def take1(tbl, idx):
        return tbl[rows, idx.clamp(0, tbl.shape[1] - 1)]

    def be32(src, pos):
        return ((take1(src, pos) << 24) | (take1(src, pos + 1) << 16)
                | (take1(src, pos + 2) << 8) | take1(src, pos + 3))

    rc8, call8, jump8 = (t.to(torch.int64) for t in (rc, call, jump))
    rc_len, call_len, jump_len, out_size = (
        t.to(torch.int64) for t in (rc_len, call_len, jump_len, out_size))
    z = torch.zeros(S, dtype=torch.int64, device=dev)
    ptr, nconv, cpos, jpos = nxt[:, 0].clone(), z.clone(), z.clone(), z.clone()
    lastc, last_top = z - 2, z.clone()
    rngv = torch.full((S,), _M32, dtype=torch.int64, device=dev)
    code = be32(rc8, z + 1)
    rcpos = z + 5
    probs = torch.full((S, 258), 1024, dtype=torch.int64, device=dev)
    marker = torch.zeros((S, Lm), dtype=torch.int64, device=dev)
    rels = torch.zeros((S, Lm), dtype=torch.int64, device=dev)
    err = torch.zeros(S, dtype=torch.bool, device=dev)
    while bool((ptr < Lm).any()):
        act = ptr < Lm
        p = torch.where(act, ptr, 0)
        b = take1(m8, p)
        prevb = torch.where(p > 0, take1(m8, p - 1), 0)
        prev = torch.where(lastc == p - 1, last_top, prevb)
        out_after = p + 4 * nconv + 1
        isE8, isE9 = b == 0xE8, b == 0xE9
        candq = act & (out_after < out_size) & (
            isE8 | isE9 | (((b & 0xF0) == 0x80) & (prev == 0x0F)))
        ptr = torch.where(act, take1(nxt, p + 1), ptr)
        if not bool(candq.any()):
            continue
        pidx = torch.where(isE8, 2 + prev, torch.where(isE9, 0, 1))
        need = candq & (rngv < (1 << 24))
        byt = torch.where(rcpos < rc_len, take1(rc8, rcpos), 0)
        code = torch.where(need, ((code << 8) | byt) & _M32, code)
        rngv = torch.where(need, (rngv << 8) & _M32, rngv)
        rcpos = rcpos + need.to(torch.int64)
        pc = pidx.clamp(0, 257)
        pp = probs[rows, pc]
        bound = ((rngv >> 11) * pp) & _M32
        bit1 = code >= bound
        newp = torch.where(bit1, pp - (pp >> 5), pp + ((2048 - pp) >> 5))
        probs[rows, pc] = torch.where(candq, newp, pp)
        rngv = torch.where(candq, torch.where(bit1, rngv - bound, bound), rngv)
        code = torch.where(candq & bit1, code - bound, code)
        convq = candq & bit1
        if not bool(convq.any()):
            continue
        spos = torch.where(isE8, cpos, jpos)
        dest = torch.where(isE8, be32(call8, spos), be32(jump8, spos))
        err = err | (convq & (spos + 4 > torch.where(isE8, call_len, jump_len)))
        rel = (dest - (out_after + 4)) & _M32
        cpos = cpos + torch.where(convq & isE8, 4, 0)
        jpos = jpos + torch.where(convq & ~isE8, 4, 0)
        marker[rows, p] = torch.where(convq, 1, marker[rows, p])
        rels[rows, p] = torch.where(convq, rel, rels[rows, p])
        lastc = torch.where(convq, p, lastc)
        last_top = torch.where(convq, rel >> 24, last_top)
        nconv = nconv + convq.to(torch.int64)

    out_cap = Lm + call.shape[1] + jump.shape[1]
    excl = torch.cumsum(marker, dim=1) - marker   # conversions before i
    out_idx = posL[None, :] + 4 * excl
    main_used = out_size - 4 * nconv
    keep = posL[None, :] < main_used[:, None]
    out = torch.zeros((S, out_cap + 4), dtype=torch.uint8, device=dev)
    r2 = rows[:, None].expand(S, Lm)
    dump = torch.full_like(out_idx, out_cap)

    def scatter(idx, val, where):
        # indices past the row are dropped, as JAX's scatter drops them
        idx = torch.where(where & (idx < out_cap + 4), idx, dump)
        out[r2, idx] = torch.where(where, val, 0).to(torch.uint8)

    scatter(out_idx, main, keep)
    for j in range(4):
        scatter(out_idx + 1 + j, (rels >> (8 * j)) & 0xFF, marker != 0)
    ok = ~err & (main_used >= 0) & (main_used <= main_len)
    return out[:, :out_cap], ok


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_BATCHED = {"arm": arm_convert_batch, "armt": armt_convert_batch,
            "ppc": ppc_convert_batch, "sparc": sparc_convert_batch,
            "ia64": ia64_convert_batch, "x86": x86_convert_batch}


def convert_batch(name: str, data: np.ndarray, valid: np.ndarray,
                  ip: np.ndarray, *, encoding: bool,
                  device="cuda") -> np.ndarray:
    """A named branch filter over an [S, L] numpy batch (L a multiple of 4)
    on ``device``: ``"cuda"`` (the default) raises UnsupportedError with no
    card, ``"cpu"`` runs the plain versions on the CPU."""
    from ..api import check_device
    fn = _BATCHED[name]
    dev = check_device(device)
    out = fn(torch.from_numpy(np.ascontiguousarray(data, np.uint8)).to(dev),
             torch.from_numpy(np.asarray(valid, np.int32)).to(dev),
             torch.from_numpy(np.asarray(ip).astype(np.int64)).to(dev),
             encoding=encoding)
    return out.cpu().numpy()
