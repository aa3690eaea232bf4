"""ctypes bindings to the port's own copy of the native C++ runtime.

The counterpart of the JAX package's ``native.py``, for the two calls the
encode path needs: ``lzt_lzma2_group_ops`` (the fast parse of one dict-reset
group, exporting op records for the range-encode kernel) and
``lzt_lzma2_encode`` (the host LZMA2 encoder).  The source is
``csrc/host/lzt_codec.cc``, one self-contained translation unit.  At first
use it is built with g++ into ``build/torch_host/liblzt_host_<hash>.so``
(the hash covers the source and the flags, so an edited source is rebuilt),
written under a temporary name and renamed, so that concurrent test workers
never load a half-written library.  There is no fallback: a missing g++ or
a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .utils.errors import raise_for_sres

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "host", "lzt_codec.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblzt_host_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host runtime "
                           "(csrc/host/lzt_codec.cc) cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run([gxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} (exit {r.returncode}):\n"
                           f"{r.stderr[-4000:]}")
    os.replace(tmp, path)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.lzt_lzma2_encode.restype = ctypes.c_int
    lib.lzt_lzma2_encode.argtypes = [
        u8p, ctypes.c_size_t,
        u8p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,   # dict, chunk, parallel
        ctypes.c_int, ctypes.c_int, ctypes.c_int,         # lc lp pb
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),       # effort, prop_out
    ]
    lib.lzt_lzma2_group_ops.restype = ctypes.c_int
    lib.lzt_lzma2_group_ops.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int),
        u8p, ctypes.POINTER(ctypes.c_size_t)]


def _as_u8p(b: bytes):
    return ctypes.cast(ctypes.c_char_p(bytes(b)), ctypes.POINTER(ctypes.c_uint8))


def lzma2_encode(data: bytes, dict_size: int, chunk_size: int, lc: int = 3,
                 lp: int = 0, pb: int = 2) -> tuple[bytes, int]:
    """Raw LZMA2 stream of ``data`` in dict-reset groups of ``chunk_size``,
    at effort 9, ending with the end byte; returns (stream, prop)."""
    lib = _load()
    cap = len(data) + len(data) // 2 + 4096 + 8 * (len(data) // 49152 + 2)
    dst = ctypes.create_string_buffer(cap)
    n = ctypes.c_size_t(cap)
    prop = ctypes.c_int(0)
    r = lib.lzt_lzma2_encode(
        _as_u8p(data), len(data),
        ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), ctypes.byref(n),
        dict_size, chunk_size, 1, lc, lp, pb, 9, ctypes.byref(prop))
    raise_for_sres(r)
    return dst.raw[:n.value], prop.value


def lzma2_group_ops(data: bytes, dict_size: int, *, lc: int = 3, lp: int = 0,
                    pb: int = 2, sub_size: int = 48 << 10):
    """Fast-parse one dict-reset group, exporting the op stream.

    Returns ``(ops, chunk_tab, body)``: ops is a uint32 numpy array of
    2-word records (``csrc/lzma_enc_lane.cuh``), chunk_tab an [n_chunks, 3]
    int32 table of cumulative (op words, unpack bytes, body bytes), and body
    the concatenated native chunk bodies."""
    lib = _load()
    ops_cap = ctypes.c_size_t(4 * len(data) + 64)
    ops = np.zeros(ops_cap.value, np.uint32)
    max_chunks = len(data) // 1024 + 2
    tab = np.zeros(max_chunks * 3, np.int32)
    n_chunks = ctypes.c_int(max_chunks)
    body_cap = ctypes.c_size_t(len(data) + len(data) // 2 + 4096)
    body = ctypes.create_string_buffer(body_cap.value)
    r = lib.lzt_lzma2_group_ops(
        _as_u8p(data), len(data), dict_size, lc, lp, pb, sub_size,
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(ops_cap),
        tab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(n_chunks),
        ctypes.cast(body, ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(body_cap))
    raise_for_sres(r)
    return (ops[:ops_cap.value].copy(),
            tab[:n_chunks.value * 3].reshape(-1, 3).copy(),
            body.raw[:body_cap.value])
