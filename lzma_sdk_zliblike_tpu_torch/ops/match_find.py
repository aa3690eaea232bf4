"""X2, the sorted-bucket match finder: a hand-written CUDA kernel on the
card, torch ops as its plain version.

The counterpart of the JAX package's ``ops/match_find.py`` (``_find`` :48,
``find_matches`` :123), which is plain JAX, not a Pallas kernel.  Per lane
(one chunk of L bytes, L a power of two) and pass (4-byte, then 8-byte
prefixes):

1. hash each position's 4-byte prefix (Fibonacci multiply; the second pass
   mixes in bytes 4-7);
2. sort ``(hash << log2 L) | pos`` once per lane: positions sharing a bucket
   become adjacent in position order, so the K nearest earlier positions of
   a bucket are the K previous sort slots;
3. measure each candidate's 16-byte-capped match length from the lane's
   bytes, and keep the first of the longest;
4. put each slot's results back at its position.

On a CUDA tensor ``find_matches_tensor`` launches the kernel
(``csrc/match_find.cu``, the per-thread pieces in
``csrc/match_find_lane.cuh``): per pass a bitonic sort of tiles of 8,192
keys in shared memory and merge rounds in global memory, the last of which
also records each position's slot (its rank); then one launch in which a
block owns a run of positions of a lane, holds the lane's row in shared
memory, finds each position's candidates of both passes by its ranks, and
writes their rows in position order to the ``[S, L, K]`` layout the host
coder reads (the ranks take the place of the sort back).  The candidates
come back as the ``[S, K, L]`` view of that storage.  ``launches`` counts
its calls on the card (one a call: each call is the two passes'
launches).  There is no fallback: a failed build or launch raises.

On a CPU tensor it runs ``find_matches_plain``, the torch ops that carry
each position's 16 bytes through ``torch.sort`` as 4 payload words (the
JAX design) and sort back by position.

The outputs are bit-identical to the JAX function's, including its int32
key: ``hh << lb`` keeps only the hash bits below ``32 - lb``, so at
L >= 2^16 the invalid-position marker ``1 << hash_bits`` wraps into bucket
0 and at L >= 2^17 hash bits are lost (ROADMAP queue 3).  That costs
candidate quality, never data, because the host parse measures each
candidate again; the port keeps the wrap so that its candidates equal the
JAX package's.  In the plain version unsigned 32-bit products are computed
in int64 from 16-bit halves of the constant (no int64 overflow) and masked
to 32 bits before their logical shift.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

FIB = 2654435761
FIB2 = 2246822519
_M32 = 0xFFFFFFFF

MAX_CAND = 1024      # candidates a pass at most (kMaxCand)

launches = 0         # kernel calls on the card; set to 0 to count

# lzt_match_find(data, valid, S, L, n_cand, n_cand8, hash_bits, keys_a,
# keys_b, best_len, best_dist, cands, stream) in csrc/match_find.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P) + (_I,) * 5 + (_P,) * 6


def _mul32(w: torch.Tensor, c: int) -> torch.Tensor:
    """(w * c) mod 2^32 for int64 ``w`` in [0, 2^32) and a 32-bit ``c``:
    w * c = w * c_lo + (w * c_hi) << 16, and every product stays below
    2^48."""
    hi = (w * (c >> 16)) & 0xFFFF
    return (w * (c & 0xFFFF) + (hi << 16)) & _M32


def _int32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same 32 bits."""
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def _shifted(x: torch.Tensor, n_k: int, fill: int) -> torch.Tensor:
    """[S, n_k, L]: row k - 1 is ``x`` [S, L] shifted k slots later along its
    last dim, its first k slots ``fill`` (JAX's ``pad(x[:, :-k], ((0, 0),
    (k, 0)))``), for k = 1..n_k."""
    S, L = x.shape
    padded = torch.cat([x.new_full((S, n_k), fill), x], dim=1)
    # window j of the unfold is x shifted n_k - j slots
    return torch.flip(padded.unfold(1, L, 1)[:, :n_k], dims=[1])


def sort_key(h, pos, valid, min_pref: int, lb: int,
             hash_bits: int) -> torch.Tensor:
    """A pass's int32 sort key ``(hh << lb) | pos``: ``hh`` is the hash, or
    ``1 << hash_bits`` where fewer than ``min_pref`` bytes remain.  The
    shift wraps in 32 bits as the JAX function's does, so only the hash
    bits below ``32 - lb`` survive in the bucket ``key >> lb``."""
    hh = torch.where(pos + min_pref > valid[:, None], 1 << hash_bits, h)
    return _int32((hh.to(torch.int64) << lb) & _M32) | pos


def _pass(words, pos, valid, h, min_pref: int, n_k: int, lb: int,
          hash_bits: int):
    """One sorted-bucket pass: for each position, the distances of the n_k
    nearest earlier positions in its bucket (0: none) as [S, n_k, L], and
    the best 16-byte-capped length among them with its distance (the
    nearest wins a tie), all in position order.  The n_k candidates are one
    axis of each step, so a step is one operation over [S, n_k, L]."""
    L = pos.shape[1]
    key = sort_key(h, pos, valid, min_pref, lb, hash_bits)
    # keys are unique in a row (their low bits are pos), so the order is the
    # one JAX's sort gives, stable or not
    skey, idx = torch.sort(key, dim=1)
    del key
    s = [torch.gather(w, 1, idx) for w in words]
    del idx
    sp = skey & (L - 1)
    sb = skey >> lb                       # arithmetic, as JAX's int32 shift
    del skey
    ln = torch.zeros((sp.shape[0], n_k, L), dtype=torch.int32,
                     device=sp.device)
    alive = torch.ones_like(ln, dtype=torch.bool)
    for w in s:
        x = w[:, None] ^ _shifted(w, n_k, 0)
        nb = ((x & 0xFF) == 0).int() + ((x & 0xFFFF) == 0).int() \
            + ((x & 0xFFFFFF) == 0).int() + (x == 0).int()
        ln += torch.where(alive, nb, 0)
        alive &= x == 0
        del x, nb
    del s, alive
    same = sb[:, None] == _shifted(sb, n_k, -1)
    dist = torch.where(same, sp[:, None] - _shifted(sp, n_k, 0), 0)
    avail = torch.clamp(valid[:, None] - sp, min=0)
    ln = torch.minimum(torch.where(same, ln, 0), avail[:, None])
    del same, sb, avail
    # the JAX function's strict scan keeps the first of the longest, which
    # is what argmax returns
    best = torch.argmax(ln, dim=1, keepdim=True)
    best_len = torch.gather(ln, 1, best)[:, 0]
    best_dist = torch.gather(dist, 1, best)[:, 0]
    del ln, best
    # back to position order: sp is a permutation of the positions
    order = torch.sort(sp, dim=1)[1]
    del sp
    return (torch.gather(best_len, 1, order), torch.gather(best_dist, 1, order),
            torch.gather(dist, 2, order[:, None].expand(-1, n_k, -1)))


def find_matches_plain(data: torch.Tensor, valid: torch.Tensor, *,
                       n_cand: int, n_cand8: int, hash_bits: int):
    """X2's plain version in torch ops, on the tensors' device: data uint8
    [S, L], valid int32 [S] -> (best_len [S, L], best_dist [S, L],
    candidate distances [S, n_cand + n_cand8, L] contiguous), int32."""
    S, L = data.shape
    lb = (L - 1).bit_length()
    b = data.to(torch.int64)

    def at(off):
        if off == 0:
            return b
        return torch.cat([b[:, off:], b.new_zeros((S, off))], dim=1)

    def word(off):
        return at(off) | (at(off + 1) << 8) | (at(off + 2) << 16) \
            | (at(off + 3) << 24)
    w0, w4 = word(0), word(4)
    words = [_int32(w0), _int32(w4), _int32(word(8)), _int32(word(12))]
    del b
    pos = torch.arange(L, dtype=torch.int32, device=data.device).expand(S, L)
    valid = valid.to(torch.int32)
    h0 = _mul32(w0, FIB)
    h4 = (h0 >> (32 - hash_bits)).to(torch.int32)
    h8 = None
    if n_cand8:
        h8 = ((h0 ^ _mul32(w4, FIB2)) >> (32 - hash_bits)).to(torch.int32)
    del w0, w4, h0
    best_len, best_dist, dists = _pass(words, pos, valid, h4, 4, n_cand, lb,
                                       hash_bits)
    del h4
    if n_cand8:
        bl8, bd8, d8 = _pass(words, pos, valid, h8, 8, n_cand8, lb,
                             hash_bits)
        # the JAX function's strict scan over pass 1's lengths then pass 2's
        # keeps pass 2's best only where it is longer than pass 1's
        better = bl8 > best_len
        best_len = torch.where(better, bl8, best_len)
        best_dist = torch.where(better, bd8, best_dist)
        dists = torch.cat([dists, d8], dim=1)
    return best_len, best_dist, dists


@functools.lru_cache(maxsize=None)
def _fn():
    from . import _build
    fn = _build.library("match_find").lzt_match_find
    fn.restype = ctypes.c_int
    fn.argtypes = list(_ARGTYPES)
    return fn


def find_matches_tensor(data: torch.Tensor, valid: torch.Tensor, *,
                        n_cand: int, n_cand8: int, hash_bits: int):
    """X2 on the tensors' device: data uint8 [S, L] (contiguous), valid
    int32 [S] -> (best_len [S, L], best_dist [S, L], candidate distances
    [S, n_cand + n_cand8, L]), int32.

    On the card this launches the kernel on the current stream, and the
    candidates are the [S, K, L] view of [S, L, K] storage (``permute(0, 2,
    1)`` gives it back without a copy); on the CPU it runs
    ``find_matches_plain``."""
    global launches
    if data.device.type == "cpu":
        return find_matches_plain(data, valid, n_cand=n_cand,
                                  n_cand8=n_cand8, hash_bits=hash_bits)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2 \
            or not data.is_contiguous() or data.data_ptr() % 4:
        raise ValueError("data must be a contiguous, 4-byte aligned uint8 "
                         "[S, L] tensor")
    S, L = data.shape
    if L & (L - 1) or not 0 < L <= 1 << 30 or not 0 < S <= 65535:
        raise ValueError(f"unsupported shape [{S}, {L}]: L a power of two "
                         "up to 2^30, S from 1 to 65535")
    if valid.dtype != torch.int32 or valid.shape != (S,) \
            or not valid.is_contiguous() or valid.device != data.device:
        raise ValueError("valid must be a contiguous int32 [S] tensor on "
                         "data's device")
    if not (1 <= n_cand <= MAX_CAND and 0 <= n_cand8 <= MAX_CAND
            and 1 <= hash_bits <= 31):
        raise ValueError(f"unsupported n_cand={n_cand}, n_cand8={n_cand8}, "
                         f"hash_bits={hash_bits}")
    dev = data.device
    out = torch.empty((2, S, L), dtype=torch.int32, device=dev)
    cands = torch.empty((S, L, n_cand + n_cand8), dtype=torch.int32,
                        device=dev)
    # the two passes' sorted keys, then their ranks and the merge rounds'
    # other buffer
    keys = torch.empty((5, S, L), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _fn()(data.data_ptr(), valid.data_ptr(), S, L, n_cand, n_cand8,
                   hash_bits, keys[0].data_ptr(), keys[2].data_ptr(),
                   out[0].data_ptr(), out[1].data_ptr(), cands.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"match_find kernel launch failed: CUDA error {rc}")
    launches += 1
    return out[0], out[1], cands.permute(0, 2, 1)


def default_hash_bits(L: int) -> int:
    return max(12, min(17, (L - 1).bit_length()))


def find_matches(data, valid, *, n_cand: int = 3, n_cand8: int = 2,
                 hash_bits: int | None = None, device="cuda"):
    """Per-position match candidates for S independent chunks, on
    ``device`` (the JAX package's ``find_matches``).

    data: [S, L] uint8 (L a power of two), valid: [S] int32 lengths; numpy
    arrays or tensors.  Returns numpy arrays (best_len [S, L], best_dist
    [S, L], cand_dists tuple of [S, L]): n_cand nearest 4-byte-bucket
    distances then n_cand8 8-byte-bucket distances (0 = no candidate);
    lengths capped at 16.  ``device="cuda"`` raises when there is no card.
    """
    from ..api import check_device
    device = check_device(device)

    def tensor(x, np_dtype, dtype):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, np_dtype))     # a writable copy
        return x.to(device=device, dtype=dtype).contiguous()
    data = tensor(data, np.uint8, torch.uint8)
    S, L = data.shape
    if L & (L - 1):
        raise ValueError("chunk length must be a power of two")
    if hash_bits is None:
        hash_bits = default_hash_bits(L)
    bl, bd, cds = find_matches_tensor(
        data, tensor(valid, np.int32, torch.int32), n_cand=n_cand,
        n_cand8=n_cand8, hash_bits=hash_bits)
    cds = cds.cpu().numpy()
    return (bl.cpu().numpy(), bd.cpu().numpy(),
            tuple(np.ascontiguousarray(cds[:, k]) for k in range(len(cds[0]))))
