"""The JAX package's native library, loaded for the port's tests.

The JAX package builds ``native/liblzt_native.so`` at its first use
(``lzma_sdk_zliblike_tpu/native.py``: ``make native`` without a lock, a
PGO recipe that starts with ``rm -rf pgo``) and remembers a failed load for
the life of the process.  Test workers that start together run that build
at once and trample each other's files, and a worker that loses keeps no
library: the JAX functions backed by it then fail, and
``utils/checksums`` keeps its numpy CRC64.

``jax_native()`` returns the JAX package's ``native`` module with its
library loaded.  Where this process's load failed, it takes a lock shared
by all processes (``build/jax_native.lock``), forgets the failure, builds
with ``make -C <repo> native`` (again with ``-B`` where a finished file
still does not load), and loads again, retrying while another process
still writes the file.  Where it still cannot load, it fails the test with
``make``'s output; it never skips.  ``jax_native_loaded`` is the same as
an autouse module fixture: a test module that assigns it to a name of its
own has the library loaded before its first test.

Loaded by path (``importlib``), as the other helpers of ``tests/`` are: on
some machines a foreign package named ``tests`` shadows this directory.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "build", "jax_native.lock")
WAIT_S = 600.0        # how long another process may still be building
STILL_S = 1.0         # a file unchanged this long is no longer being written


def _settled(path: str) -> bool:
    """Whether the file exists and nobody wrote it for STILL_S seconds."""
    try:
        a = os.stat(path)
        if time.time() - a.st_mtime < STILL_S:
            return False
        time.sleep(0.2)
        b = os.stat(path)
    except FileNotFoundError:
        return False
    return (a.st_size, a.st_mtime_ns) == (b.st_size, b.st_mtime_ns) \
        and a.st_size > 0


def _load(JN) -> bool:
    """Forget a recorded failure and load again; a file that does not load
    (half written, or stale) leaves the failure forgotten."""
    JN._TRIED, JN._LIB = False, None
    try:
        return JN.available()
    except (OSError, AttributeError):
        JN._TRIED, JN._LIB = False, None
        return False


def _make(*flags: str) -> str:
    r = subprocess.run(["make", "-C", REPO, *flags, "native"],
                       capture_output=True, text=True, timeout=WAIT_S)
    return f"$ make -C {REPO} {' '.join(flags)} native  (exit " \
        f"{r.returncode})\n{r.stdout}{r.stderr}"


def _restore_checksums(JN) -> None:
    """``utils/checksums`` binds the native CRC64 when it is imported; one
    imported while the load was failing keeps its numpy fallback."""
    mod = sys.modules.get("lzma_sdk_zliblike_tpu.utils.checksums")
    if mod is not None and getattr(mod, "_native_crc64", 0) is None:
        mod._native_crc64 = JN.crc64


def jax_native():
    """``lzma_sdk_zliblike_tpu.native`` with its library loaded in this
    process; fails the calling test with ``make``'s output if it cannot
    be."""
    from lzma_sdk_zliblike_tpu import native as JN
    if not JN.available():
        path = os.path.abspath(JN._lib_path())
        os.makedirs(os.path.dirname(LOCK), exist_ok=True)
        log = "make never ran"
        with open(LOCK, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            deadline = time.monotonic() + WAIT_S
            while not (_settled(path) and _load(JN)):
                if time.monotonic() > deadline:
                    pytest.fail("the JAX package's native library "
                                f"{path} does not load:\n{log}")
                # a settled file that does not load is stale or broken
                log = _make(*(("-B",) if _settled(path) else ()))
                if _settled(path) and _load(JN):
                    break
                time.sleep(1.0)
    _restore_checksums(JN)
    return JN


@pytest.fixture(autouse=True, scope="module")
def jax_native_loaded():
    return jax_native()
