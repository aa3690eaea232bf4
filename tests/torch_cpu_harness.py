"""Builds the port's CPU harness (``csrc/cpu_harness.cc``) with g++.

The harness compiles the kernels' own per-lane sources (``lzma_lane.cuh``
for K1, ``lzma_enc_lane.cuh`` for K2, ``probe_lane.cuh`` for the probes P1
and P2, ``checksum_lane.cuh`` for X3, ``filters_lane.cuh`` and
``branch_filters_lane.cuh`` for X4,
``match_find_lane.cuh`` for X2) for the host, so the tests can run the
code the GPU runs.  It goes to ``build/torch_kernels_cpu/`` under a hash of
its sources and is shared by the test files that load this module by path
(a foreign package named ``tests`` may shadow this directory).
``x86_batch`` and ``bcj2_batch`` call X4's x86 and BCJ2 entry points on
numpy arrays, at the kernels' block geometry unless told otherwise;
``branch_batch`` and ``delta_batch`` call X4's fixed-alignment
converters and delta; ``match_find_batch`` calls X2's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "lzma_sdk_zliblike_tpu_torch", "csrc")
SOURCES = ("cpu_harness.cc", "lzma_lane.cuh", "lzma_enc_lane.cuh",
           "probe_lane.cuh", "checksum_lane.cuh", "filters_lane.cuh",
           "match_find_lane.cuh", "branch_filters_lane.cuh")


def build(csrc: str = CSRC,
          out_dir: str = os.path.join(REPO, "build", "torch_kernels_cpu")
          ) -> ctypes.CDLL | None:
    """The loaded harness library of the sources in ``csrc`` (the
    package's, or a changed copy of them), built into ``out_dir``, or None
    when g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libcpu_harness_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                        tmp, os.path.join(csrc, "cpu_harness.cc")],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)


# X4's block geometry in csrc/device_filters.cu: x86 spans a tile and tile
# bytes, BCJ2 threads of the listing and placing blocks
X86_SPANS, X86_TILE, BCJ2_THREADS = 512, 32768, 512


def x86_batch(lib, data, valid, ip, encoding, spans=X86_SPANS,
              tile=X86_TILE):
    """``lzt_x86_batch_cpu`` over numpy lanes: the converted [S, L] rows."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.lzt_x86_batch_cpu
    fn.restype, fn.argtypes = ctypes.c_int, [P, P, L, P, P, I, I, I, I]
    inp = np.ascontiguousarray(data, np.uint8)
    out = np.zeros_like(inp)
    v = np.ascontiguousarray(valid, np.int32)
    i = np.ascontiguousarray(ip).astype(np.int64)
    assert fn(inp.ctypes.data, out.ctypes.data, inp.shape[1], v.ctypes.data,
              i.ctypes.data, inp.shape[0], int(encoding), spans, tile) == 0
    return out


def bcj2_batch(lib, streams, lens, out_size, threads=BCJ2_THREADS):
    """``lzt_bcj2_batch_cpu`` over numpy streams: (out [S, out_cap] uint8,
    ok bool, info int32 [S, 4]: candidates, conversions, decoder steps,
    ok).  ``out`` starts as 0x5A bytes, so a byte the placement misses
    shows."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.lzt_bcj2_batch_cpu
    fn.restype = ctypes.c_int
    fn.argtypes = [P, I, P] * 4 + [P, P, I, P, I, P, I]
    S = len(out_size)
    cap = sum(a.shape[1] for a in streams[:3])
    out = np.full((S, cap), 0x5A, np.uint8)
    ok = np.zeros(S, np.int32)
    info = np.zeros((S, 4), np.int32)
    keep, args = [], []
    for a, n in zip(streams, lens):
        a = np.ascontiguousarray(a, np.uint8)
        n = np.ascontiguousarray(n, np.int32)
        keep += [a, n]
        args += [a.ctypes.data, a.shape[1], n.ctypes.data]
    osz = np.ascontiguousarray(out_size, np.int32)
    assert fn(*args, osz.ctypes.data, out.ctypes.data, cap, ok.ctypes.data,
              S, info.ctypes.data, threads) == 0
    return out, ok != 0, info


# X4's delta geometry in csrc/branch_filters.cu: threads of a decode block
# (kDeltaThreads) and bytes a decode thread holds (kDeltaPer)
DELTA_THREADS, DELTA_PER = 256, 64
BRANCH_KIND = {"arm": 0, "ppc": 1, "sparc": 2, "armt": 3, "ia64": 4}


def branch_batch(lib, name, data, valid, ip, encoding):
    """``lzt_branch_batch_cpu`` over numpy lanes: the converted rows ([S, L
    // 2 * 2] for armt).  ``out`` starts as 0x5A bytes, so a byte the
    kernel misses shows."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.lzt_branch_batch_cpu
    fn.restype, fn.argtypes = ctypes.c_int, [I, P, P, L, P, P, I, I]
    d = np.ascontiguousarray(data, np.uint8)
    S, W = d.shape
    out = np.full((S, W // 2 * 2 if name == "armt" else W), 0x5A, np.uint8)
    v = np.ascontiguousarray(valid, np.int32)
    i = np.ascontiguousarray(ip).astype(np.int64)
    assert fn(BRANCH_KIND[name], d.ctypes.data, out.ctypes.data, W,
              v.ctypes.data, i.ctypes.data, S, int(encoding)) == 0
    return out


def delta_batch(lib, data, valid, dist, encoding, threads=DELTA_THREADS,
                per=DELTA_PER, backward=False):
    """``lzt_delta_batch_cpu`` over numpy lanes at decode blocks of
    ``threads`` threads, each holding ``per`` bytes of words or ``per``
    rows of a byte column (segments of up to threads x per bytes), every
    launch's blocks first to last or, with ``backward``, last to first: the
    [S, L] rows, from 0x5A bytes."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.lzt_delta_batch_cpu
    fn.restype, fn.argtypes = ctypes.c_int, [P, P, L, P, L, I, I, I, I, I]
    d = np.ascontiguousarray(data, np.uint8)
    out = np.full_like(d, 0x5A)
    v = np.ascontiguousarray(valid, np.int32)
    assert fn(d.ctypes.data, out.ctypes.data, d.shape[1], v.ctypes.data,
              int(dist), d.shape[0], int(encoding), threads, per,
              int(backward)) == 0
    return out


# X2's geometry in csrc/match_find.cu: keys a sorted tile (kSortTile),
# positions a row block owns (kRun) and threads of a row block
# (kRowThreads)
X2_TILE, X2_RUN, X2_THREADS = 8192, 2048, 512


def match_find_batch(lib, data, valid, n_cand, n_cand8, hash_bits,
                     tile=X2_TILE, run=X2_RUN, threads=X2_THREADS,
                     staged=True):
    """``lzt_match_find_cpu`` over numpy lanes: (best_len [S, L], best_dist
    [S, L], cands [S, L, n_cand + n_cand8]), int32.  ``staged`` reads the
    row from its copy (the kernel's shared-memory row) rather than from
    the row itself (its global-memory row).  The outputs start as
    0x5A5A5A5A, so a word the kernels miss shows."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.lzt_match_find_cpu
    fn.restype, fn.argtypes = ctypes.c_int, [P, P] + [I] * 9 + [P] * 3
    d = np.ascontiguousarray(data, np.uint8)
    v = np.ascontiguousarray(valid, np.int32)
    S, L = d.shape
    poison = 0x5A5A5A5A
    bl = np.full((S, L), poison, np.int32)
    bd = np.full((S, L), poison, np.int32)
    cands = np.full((S, L, n_cand + n_cand8), poison, np.int32)
    rc = fn(d.ctypes.data, v.ctypes.data, S, L, n_cand, n_cand8, hash_bits,
            tile, run, threads, int(staged), bl.ctypes.data, bd.ctypes.data,
            cands.ctypes.data)
    assert rc == 0, rc
    return bl, bd, cands
