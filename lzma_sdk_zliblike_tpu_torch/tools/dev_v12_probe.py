"""Kernel P1 and its tool: the v12 bit-call microbenchmark on the card.

The counterpart of the JAX package's ``tools/dev_v12_probe.py``: ``iters``
iterations of 28 range-coder-bit-shaped calls on synthetic state (gather
from one of 8 probability tables, bound, probability update, masked store,
range update, renormalisation), in the variants of ``VARIANTS`` plus
``live<N>`` for any N >= 1.  The row variants hold one element per (row s,
lane l) of an [S, 128] array and return the final index (xor the live
carries); the lane variants hold one scalar state per stream s and return
rows 0..7 = rng, code, idx and five zero rows in columns 0..S-1 (the rest
of the output is zero).  Output int32 [S, 128], bit-identical to the TPU
kernel's (rows 0..7 for the lane variants, whose TPU kernel never writes
rows 8..S-1).

On the card ``v12_probe`` launches the hand-written kernel
(``csrc/v12_probe.cu``) or raises; on the CPU it runs the plain version,
``v12_probe_plain``, on int64 tensors that hold the uint32 range and code
masked to 32 bits.  ``launches`` counts kernel launches.

    python -m lzma_sdk_zliblike_tpu_torch.tools.dev_v12_probe [variant ...]

times each variant (default ``broadcast lane-notr lane``) at S = 32 and 128
for ``LZT_ITERS`` iterations (default 20000), by CUDA events, best of 3
after a warm-up launch, and prints ``S=... variant ... us/iter``.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch

from . import best_ms, probe_device

B_CALLS = 28      # bit-call-shaped blocks per iteration
# variant codes of csrc/v12_probe.cu, in order; "live" stands for live<N>
VARIANTS = ("broadcast", "masked", "fused2", "live", "tailalways",
            "tailnever", "tailcond", "while", "whilecond", "lane",
            "lane-notr")
LANE_VARIANTS = ("lane", "lane-notr")

launches = 0      # P1 launches on the card; set to 0 to start a count

_M32 = 0xFFFFFFFF

# int32 operations per call per element, counted from csrc/v12_probe.cu (one
# per arithmetic, compare, select or address step): broadcast = clip 2,
# address 1, bound 2, bit 1, adapt 6, store test 2, range and code update 7,
# index 2; masked adds 2 selects; fused2 a second gather (5) and store test
# (4); live<N> fused2's gathers without its second store, plus one add; the
# lane variants lose the store test or the gather.
_OPS_PER_CALL = {"broadcast": 23, "masked": 25, "fused2": 34, "live": 31,
                 "tailalways": 23, "tailnever": 23, "tailcond": 23,
                 "while": 23, "whilecond": 23, "lane": 23, "lane-notr": 19}
_TAIL_OPS = 26 * 6    # per element per tail run: compare, >>, ^, select, &, +

# lzt_v12_probe(out, votes, S, iters, variant, extra, stream) in
# csrc/v12_probe.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH_ARGTYPES = [_P, _P, _I, _I, _I, _I, _P]


def parse_variant(variant: str) -> tuple[str, int]:
    """``(name, extra)``: the variant's entry of ``VARIANTS`` and the N of
    ``live<N>`` (0 for the others)."""
    if variant.startswith("live") and variant != "live":
        try:
            extra = int(variant[4:])
        except ValueError:
            raise ValueError(f"unknown variant {variant!r}") from None
        if extra < 1:
            raise ValueError(f"{variant}: live<N> needs N >= 1")
        return "live", extra
    if variant not in VARIANTS or variant == "live":
        raise ValueError(f"unknown variant {variant!r} (one of "
                         f"{', '.join(VARIANTS[:3])}, live<N>, "
                         f"{', '.join(VARIANTS[4:])})")
    return variant, 0


def _check(S: int, iters: int, variant: str) -> tuple[str, int]:
    name, extra = parse_variant(variant)
    if S < 1 or iters < 0:
        raise ValueError(f"need S >= 1 and iters >= 0, got {S}, {iters}")
    if name in LANE_VARIANTS and S < 8:
        raise ValueError(f"{variant} writes rows 0..7 of out: needs S >= 8")
    return name, extra


def v12_probe(S: int, iters: int, variant: str, device="cuda") -> torch.Tensor:
    """P1's output, int32 [S, 128], on ``device``.

    ``device="cuda"`` (the default) launches the kernel and waits for it;
    ``device="cpu"`` runs the plain version."""
    name, extra = _check(S, iters, variant)
    device = probe_device(device)
    if device.type == "cpu":
        return v12_probe_plain(S, iters, variant)
    out, votes = _buffers(S, device)
    _launch(out, votes, S, iters, name, extra)
    torch.cuda.synchronize(device)
    return out


def _buffers(S: int, device):
    """The zeroed output (the lane variants' start state) and the grid
    vote slots (int32 [4]) of a launch."""
    return (torch.zeros((S, 128), dtype=torch.int32, device=device),
            torch.zeros(4, dtype=torch.int32, device=device))


def _launch(out, votes, S, iters, name, extra) -> None:
    global launches
    from ..ops import _build
    fn = _build.library("v12_probe").lzt_v12_probe
    fn.restype = ctypes.c_int
    fn.argtypes = _LAUNCH_ARGTYPES
    with torch.cuda.device(out.device):
        rc = fn(out.data_ptr(), votes.data_ptr(), S, iters,
                VARIANTS.index(name), extra,
                torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"v12_probe kernel launch failed: CUDA error {rc}")
    launches += 1


def operations(S: int, iters: int, variant: str, tail_runs: int = 0) -> int:
    """The int32 operations of one launch, counted from the kernel source:
    per call per element times 28 calls times elements (S x 128 for the row
    variants, S streams for the lane variants) times iterations, plus the
    tail loops that ran (every iteration for tailalways, ``tail_runs`` for
    tailcond)."""
    name, _ = _check(S, iters, variant)
    elems = S if name in LANE_VARIANTS else S * 128
    ops = _OPS_PER_CALL[name] * B_CALLS * elems * iters
    runs = iters if name == "tailalways" else tail_runs if name == "tailcond" \
        else 0
    return ops + _TAIL_OPS * elems * runs


def run(S: int, iters: int, variant: str) -> dict:
    """Times one variant on the card (CUDA events, best of 3 after a
    warm-up launch), prints the JAX tool's line and returns the numbers:
    ms per launch, us per iteration, ns per call and per call per stream,
    the tail runs of the last launch (tailcond) and its output."""
    name, extra = _check(S, iters, variant)
    out, votes = _buffers(S, probe_device("cuda"))
    def before(rep):
        out.zero_()
        votes.zero_()
    ms = best_ms(lambda: _launch(out, votes, S, iters, name, extra),
                 before=before)
    us = ms * 1e3 / max(iters, 1)
    print(f"S={S:<4d} {variant:10s} {us:7.2f} us/iter", flush=True)
    return {"S": S, "variant": variant, "iters": iters, "ms": ms,
            "us_per_iter": us, "ns_per_call": us * 1e3 / B_CALLS,
            "ns_per_call_stream": us * 1e3 / B_CALLS / S,
            "tail_runs": int(votes[3]), "out": out}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(os.environ.get("LZT_ITERS", "20000"))
    variants = argv or ["broadcast", "lane-notr", "lane"]
    failed = 0
    for S in (32, 128):
        for variant in variants:
            try:
                run(S, iters, variant)
            except Exception as e:  # noqa: BLE001 - report per-variant failure
                failed += 1
                print(f"S={S:<4d} {variant:10s} FAILED: {type(e).__name__}: "
                      f"{str(e)[:200]}", flush=True)
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# plain version: the same arithmetic on int64 tensors (uint32 masked)
# ---------------------------------------------------------------------------

def _i32(x):
    """int64 values wrapped to int32, as int64."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _adapt(p, bit0):
    return torch.where(bit0, _i32(p + (_i32(2048 - p) >> 5)),
                       _i32(p - (p >> 5)))


def bit_call(rng, code, p, live):
    """One bit call on int64 tensors: rng, code uint32, p int32, live bool.
    Returns ``(rng, code, newp, bit0)``; rng and code take the bit only
    where ``live``, the renormalisation runs everywhere."""
    bound = ((rng >> 11) * (p & _M32)) & _M32
    bit0 = code < bound
    newp = _adapt(p, bit0)
    rng = torch.where(live, torch.where(bit0, bound, (rng - bound) & _M32),
                      rng)
    code = torch.where(live & ~bit0, (code - bound) & _M32, code)
    rng = torch.where(rng < (1 << 24), (rng << 8) & _M32, rng)
    return rng, code, newp, bit0


def tail(r, c):
    """The 26-trip tail loop of the tail* variants (uint32 in int64)."""
    for _ in range(26):
        r = torch.where(c > r, r ^ (c >> 1), r)
        c = (c + (r & 0xFF)) & _M32
    return r, c


def _plain_rows(S, iters, name, extra):
    tbl = torch.full((8, S, 128), 1024, dtype=torch.int64)
    lane = torch.arange(128).expand(S, 128)
    rng = torch.full((S, 128), _M32, dtype=torch.int64)
    code = torch.zeros((S, 128), dtype=torch.int64)
    idx = torch.zeros((S, 128), dtype=torch.int64)
    cs = [torch.full((S, 128), 3 + e, dtype=torch.int64) for e in range(extra)]
    mask = name in ("masked", "fused2", "live")
    fuse = name in ("fused2", "live")
    everywhere = torch.ones((S, 128), dtype=torch.bool)
    it, busy = 0, True
    while it < iters and busy:
        if name == "whilecond" and it & 63 == 0:
            busy = bool((idx < (1 << 30)).any())
        live = idx < 96
        for b in range(B_CALLS):
            t0, t1 = b % 8, (b + 1) % 8
            p = tbl[t0].gather(1, idx.clamp(0, 127))
            if fuse:
                p2 = tbl[t1].gather(1, (idx + 1).clamp(0, 127))
                p = torch.where(live, p, p2)
            rng, code, newp, _ = bit_call(rng, code, p,
                                          live if mask else everywhere)
            tbl[t0] = torch.where(lane == (idx & 127), newp, tbl[t0])
            if name == "fused2":
                tbl[t1] = torch.where((lane == ((idx + 1) & 127)) & ~live,
                                      newp, tbl[t1])
            if extra:
                cs[b % extra] = _i32(cs[b % extra] + idx)
            idx = (idx + p) & 127
        if name == "tailalways" or (name == "tailcond"
                                    and bool((idx > 120).any())):
            rng, code = tail(rng, code)
        it += 1
    for c in cs:
        idx = idx ^ c
    return idx.to(torch.int32)


def _plain_lanes(S, iters, transpose):
    tbl = torch.full((8, S, 128), 1024, dtype=torch.int64)
    rows = torch.arange(S)
    rng = torch.zeros(S, dtype=torch.int64)
    code = torch.zeros(S, dtype=torch.int64)
    idx = torch.zeros(S, dtype=torch.int64)
    everywhere = torch.ones(S, dtype=torch.bool)
    for _ in range(iters):
        for b in range(B_CALLS):
            if transpose:
                p = tbl[b % 8, rows, idx.clamp(0, 127)]
            else:
                p = code & 2047                       # fake probability
            rng, code, newp, _ = bit_call(rng, code, p, everywhere)
            if transpose:
                tbl[b % 8, rows, idx & 127] = newp
            idx = (idx + newp) & 127
    out = torch.zeros((S, 128), dtype=torch.int32)
    out[0, :S] = _i32(rng).to(torch.int32)
    out[1, :S] = _i32(code).to(torch.int32)
    out[2, :S] = idx.to(torch.int32)
    return out


def v12_probe_plain(S: int, iters: int, variant: str) -> torch.Tensor:
    """The plain PyTorch version of P1 on the CPU: int32 [S, 128]."""
    name, extra = _check(S, iters, variant)
    if name in LANE_VARIANTS:
        return _plain_lanes(S, iters, name == "lane")
    return _plain_rows(S, iters, name, extra)


if __name__ == "__main__":
    sys.exit(main())
