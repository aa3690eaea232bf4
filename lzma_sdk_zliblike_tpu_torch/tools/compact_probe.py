"""Kernel P2 and its tool: the compact-layout bit-call microbenchmark.

The counterpart of the JAX package's ``tools/compact_probe.py``: ``iters``
iterations of 28 calls of the shared signed-int32 ALU (``alu``) on
synthetic state seeded by ``seed``, each call reading and updating one
probability-table slot, in the four layouts of ``KERNELS``:

* ``bcast``: 64 rows of broadcast state [64, 128], a 128-slot table per
  row; output int32 [64, 128];
* ``mxu``: 128 streams of compact state, a 128-slot table per stream; the
  slot index and the probabilities cross between the layouts as products
  with a one-hot matrix (f32 in the plain version, f16 on the card's
  tensor cores with an f32 sum: both exact); output int32 [1, 128];
* ``tpose``: the same with transposes (``mxu`` and ``tpose`` give the same
  output: every value is below 2048, so the products are exact);
* ``submask``: 128 streams, 192 slots each; the read is a masked sum over
  the slots, the update a masked select.

On the card ``compact_probe`` launches the hand-written kernel
(``csrc/compact_probe.cu``) or raises; on the CPU it runs the plain
version, ``compact_probe_plain``, on int64 tensors wrapped to int32.
``launches`` counts kernel launches.

    python -m lzma_sdk_zliblike_tpu_torch.tools.compact_probe [kernel|all] [iters]

times each kernel for ``iters`` iterations (default 2000), by CUDA events,
best of 3 after a warm-up launch, each launch with a fresh seed, and
prints us/iter, ns/call, ns/stream-iter and the library's build time.
"""

from __future__ import annotations

import ctypes
import sys
import time

import torch

from . import best_ms, probe_device

NCALLS = 28          # calls per iteration
SUB_T = 192          # submask: table slots per stream
# name -> streams; the order is csrc/compact_probe.cu's kernel codes
KERNELS = {"bcast": 64, "mxu": 128, "tpose": 128, "submask": 128}

launches = 0         # P2 launches on the card; set to 0 to start a count

_M32 = 0xFFFFFFFF

# operations per call per stream (per element for bcast), counted from
# csrc/compact_probe.cu: the ALU 26 (bound 2, bit 1, range and code update 4,
# adapt 6, renormalisation 7, state 6), the slot 3, the gather and store
# addresses 2; mxu adds 6 conversions and 3 x 128 multiply-adds (a row of
# the one-hot matrix per relayout; on the tensor cores); submask's slot
# takes 5 and its masked read and select 192 x (3 + 2).  The same work in
# every layout the kernels have had, so the bounds compare across them.
_INT_OPS_PER_CALL = {"bcast": 31, "mxu": 37, "tpose": 31,
                     "submask": 26 + 5 + SUB_T * 5}
_MADS_PER_CALL = {"bcast": 0, "mxu": 3 * 128, "tpose": 0, "submask": 0}

# lzt_compact_probe(kind, seed, out, iters, stream) in csrc/compact_probe.cu
_I, _P = ctypes.c_int, ctypes.c_void_p
_LAUNCH_ARGTYPES = [_I, _I, _P, _I, _P]


def _check(name: str, iters: int, seed: int) -> None:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r} (one of "
                         f"{', '.join(KERNELS)})")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not -(1 << 31) <= seed < 1 << 31:
        raise ValueError(f"seed must be an int32, got {seed}")


def out_shape(name: str) -> tuple[int, int]:
    return (KERNELS[name], 128) if name == "bcast" else (1, 128)


def compact_probe(name: str, iters: int, seed: int,
                  device="cuda") -> torch.Tensor:
    """P2 kernel ``name``'s output, int32, on ``device``.

    ``device="cuda"`` (the default) launches the kernel and waits for it;
    ``device="cpu"`` runs the plain version."""
    _check(name, iters, seed)
    device = probe_device(device)
    if device.type == "cpu":
        return compact_probe_plain(name, iters, seed)
    out = torch.zeros(out_shape(name), dtype=torch.int32, device=device)
    _launch(name, iters, seed, out)
    torch.cuda.synchronize(device)
    return out


def _launch(name: str, iters: int, seed: int, out: torch.Tensor) -> None:
    global launches
    from ..ops import _build
    fn = _build.library("compact_probe").lzt_compact_probe
    fn.restype = ctypes.c_int
    fn.argtypes = _LAUNCH_ARGTYPES
    with torch.cuda.device(out.device):
        rc = fn(list(KERNELS).index(name), seed, out.data_ptr(), iters,
                torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"compact_probe kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1


def operations(name: str, iters: int) -> tuple[int, int]:
    """``(int32 operations, multiply-adds)`` of one launch, counted from the
    kernel source: per call per stream (per element for bcast) times 28
    calls times streams (64 x 128 elements for bcast) times iterations.
    The multiply-adds are mxu's products with the one-hot matrix."""
    _check(name, iters, 0)
    elems = KERNELS[name] * 128 if name == "bcast" else KERNELS[name]
    n = NCALLS * elems * iters
    return _INT_OPS_PER_CALL[name] * n, _MADS_PER_CALL[name] * n


def run(name: str, iters: int) -> dict:
    """Times kernel ``name`` on the card (CUDA events, best of 3 after a
    warm-up launch, a fresh seed per launch, derived from the clock as the
    JAX tool does), prints the JAX tool's fields and returns them with the
    last output's sum."""
    _check(name, iters, 0)
    streams = KERNELS[name]
    device = probe_device("cuda")
    out = torch.zeros(out_shape(name), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    from ..ops import _build
    _build.library("compact_probe")
    build_s = time.perf_counter() - t0
    base = int(time.time()) % 1000000
    seed = [base]

    def before(rep):
        seed[0] = base + rep + 1
    ms = best_ms(lambda: _launch(name, iters, seed[0], out), before=before)
    us_iter = ms * 1e3 / max(iters, 1)
    us_call = us_iter / NCALLS
    us_stream_iter = us_iter / streams
    print(f"{name:8s} streams={streams:3d} {us_iter:7.3f} us/iter  "
          f"{us_call * 1000:7.1f} ns/call  {us_stream_iter * 1000:7.1f} "
          f"ns/stream-iter  (build {build_s:.1f}s)", flush=True)
    return {"name": name, "streams": streams, "iters": iters, "ms": ms,
            "us_per_iter": us_iter, "ns_per_call": us_call * 1e3,
            "ns_per_call_stream": us_call * 1e3 / streams,
            "ns_per_stream_iter": us_stream_iter * 1e3, "build_s": build_s,
            "checksum": int(out.long().sum())}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    iters = int(argv[1]) if len(argv) > 1 else 2000
    names = list(KERNELS) if which == "all" else [which]
    failed = 0
    for nm in names:
        try:
            run(nm, iters)
        except Exception as e:  # noqa: BLE001 - report per-kernel failure
            failed += 1
            print(f"{nm:8s} FAILED: {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# plain version: the same arithmetic on int64 tensors wrapped to int32
# ---------------------------------------------------------------------------

def _i32(x):
    """int64 values wrapped to int32, as int64."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def alu(rng, code, st, prob):
    """The shared per-call ALU in signed int32 (int64 tensors holding int32
    values): returns ``(rng, code, st, newp)``."""
    bound = _i32((rng >> 11) * prob)
    bit = code < bound
    rng = torch.where(bit, bound, _i32(rng - bound))
    code = torch.where(bit, code, _i32(code - bound))
    newp = torch.where(bit, _i32(prob + (_i32(2048 - prob) >> 5)),
                       _i32(prob - (prob >> 5)))
    need = rng < (1 << 24)
    rng = torch.where(need, _i32((rng & _M32) << 8), rng)
    code = torch.where(need, (((code & _M32) << 8) | 0x5A) & 0x7FFFFFFF, code)
    st = (torch.where(bit, st * 2 + 1, st * 2) ^ (code >> 17)) & 0x3FFF
    return rng, code, st, newp


def slot(st, code, slots: int = 128):
    """The table slot of a call: (st + (code >> 7)) & 127, or its floor
    modulo ``slots`` (submask)."""
    x = _i32(st + (code >> 7))
    return x & 127 if slots == 128 else torch.remainder(x, slots)


def code0(i, seed: int):
    """The initial code of row or stream ``i``: i * 7919 + 13 + seed."""
    return _i32(i * 7919 + 13 + seed)


def _plain_bcast(iters, seed):
    s = KERNELS["bcast"]
    lane = torch.arange(128).expand(s, 128)
    rng = torch.full((s, 128), 0x7FFFFF00, dtype=torch.int64)
    code = code0(torch.arange(s), seed)[:, None].expand(s, 128).clone()
    st = torch.full((s, 128), 3, dtype=torch.int64)
    tbl = torch.full((s, 128), 1024, dtype=torch.int64)
    for _ in range(iters):
        for _ in range(NCALLS):
            idx = slot(st, code)
            prob = tbl.gather(1, idx)
            rng, code, st, newp = alu(rng, code, st, prob)
            tbl = torch.where(lane == idx, newp, tbl)
    return rng + code + st + tbl


def _plain_compact(iters, seed, mxu: bool):
    eye = torch.eye(128, dtype=torch.float32)
    lane = torch.arange(128).expand(128, 128)
    rng = torch.full((1, 128), 0x7FFFFF00, dtype=torch.int64)
    code = code0(torch.arange(128), seed)[None, :]
    st = torch.full((1, 128), 3, dtype=torch.int64)
    tbl = torch.full((128, 128), 1024, dtype=torch.int64)

    def to_rows(c):           # (1, 128) compact -> (128, 1)
        if mxu:
            return (eye @ c.T.to(torch.float32)).to(torch.int64)
        return c.T

    def to_compact(b):        # (128, 1) -> (1, 128) compact
        if mxu:
            return (b.T.to(torch.float32) @ eye).to(torch.int64)
        return b.T
    for _ in range(iters):
        for _ in range(NCALLS):
            idx_b = to_rows(slot(st, code)).expand(128, 128)
            prob = to_compact(tbl.gather(1, idx_b)[:, :1])
            rng, code, st, newp = alu(rng, code, st, prob)
            tbl = torch.where(lane == idx_b, to_rows(newp), tbl)
    return rng + code + st + tbl.sum(0, keepdim=True)


def _plain_submask(iters, seed):
    sub = torch.arange(SUB_T)[:, None].expand(SUB_T, 128)
    rng = torch.full((1, 128), 0x7FFFFF00, dtype=torch.int64)
    code = code0(torch.arange(128), seed)[None, :]
    st = torch.full((1, 128), 3, dtype=torch.int64)
    tbl = torch.full((SUB_T, 128), 1024, dtype=torch.int64)
    for _ in range(iters):
        for _ in range(NCALLS):
            mask = sub == slot(st, code, SUB_T)
            prob = _i32(torch.where(mask, tbl, 0).sum(0, keepdim=True))
            rng, code, st, newp = alu(rng, code, st, prob)
            tbl = torch.where(mask, newp, tbl)
    return rng + code + st + tbl.sum(0, keepdim=True)


def compact_probe_plain(name: str, iters: int, seed: int) -> torch.Tensor:
    """The plain PyTorch version of P2 kernel ``name`` on the CPU."""
    _check(name, iters, seed)
    if name == "bcast":
        out = _plain_bcast(iters, seed)
    elif name == "submask":
        out = _plain_submask(iters, seed)
    else:
        out = _plain_compact(iters, seed, mxu=name == "mxu")
    return _i32(out).to(torch.int32)


if __name__ == "__main__":
    sys.exit(main())
