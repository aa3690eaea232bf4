"""Builds the port's CPU harness (``csrc/cpu_harness.cc``) with g++.

The harness compiles the kernels' own per-lane sources (``lzma_lane.cuh``
for K1, ``lzma_enc_lane.cuh`` for K2, ``probe_lane.cuh`` for the probes P1
and P2, ``checksum_lane.cuh`` for X3, ``filters_lane.cuh`` for X4) for the
host, so the tests can run the
code the GPU runs.  It goes to ``build/torch_kernels_cpu/`` under a hash of
its sources and is shared by the test files that load this module by path
(a foreign package named ``tests`` may shadow this directory).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "lzma_sdk_zliblike_tpu_torch", "csrc")
SOURCES = ("cpu_harness.cc", "lzma_lane.cuh", "lzma_enc_lane.cuh",
           "probe_lane.cuh", "checksum_lane.cuh", "filters_lane.cuh")


def build() -> ctypes.CDLL | None:
    """The loaded harness library, or None when g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(REPO, "build", "torch_kernels_cpu")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libcpu_harness_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                        tmp, os.path.join(CSRC, "cpu_harness.cc")],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)
