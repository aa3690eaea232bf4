"""``tests/torch_jax_native.py``, the helper that gives the port's tests the
JAX package's native library, in the state a test worker that lost the
JAX package's build race is left in.

That worker's ``lzma_sdk_zliblike_tpu.native`` has recorded a failed load
(``_TRIED`` true, ``_LIB`` None), so ``available()`` stays false for the
life of the process, and ``utils/checksums`` bound no native CRC64 when it
was imported.  Each test puts a fresh interpreter in that state and calls
the helper there, so no other test's worker sees it.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "torch_jax_native.py")

LOST_RACE = """
import importlib.util, sys
from lzma_sdk_zliblike_tpu import native as JN
from lzma_sdk_zliblike_tpu.utils import checksums as JC
JN._TRIED, JN._LIB = True, None
JC._native_crc64 = None
assert not JN.available()
spec = importlib.util.spec_from_file_location("lzt_torch_jax_native",
                                              sys.argv[1])
helper = importlib.util.module_from_spec(spec)
spec.loader.exec_module(helper)
"""


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", LOST_RACE + code, HELPER],
                          capture_output=True, text=True, timeout=700,
                          cwd=REPO)


def test_helper_recovers_a_failed_load():
    """The helper forgets the failure and loads the library again: the
    module it returns is the JAX package's, ``available()`` is true, the
    native functions answer (the CRC64 check value of "123456789"), and
    ``utils/checksums`` has its native CRC64 back."""
    r = _run("""
mod = helper.jax_native()
assert mod is JN and JN.available() and JN._LIB is not None
assert JN.crc64(b"123456789") == 0x995DC9BBDF1939FA
assert JC._native_crc64 is not None
assert JC.crc64(b"123456789") == 0x995DC9BBDF1939FA
print("recovered")
""")
    assert r.returncode == 0 and r.stdout.split() == ["recovered"], \
        r.stdout + r.stderr


def test_jax_functions_work_after_the_helper():
    """A JAX function backed by the library, which raised in the failed
    state (the engine named ``native``), encodes after the helper, and its
    stream decodes to the input with Python's ``lzma``."""
    r = _run("""
import lzma
from lzma_sdk_zliblike_tpu.models.lzma2 import framing as JF
data = bytes(range(256)) * 64
try:
    JF.encode(data, dict_size=1 << 16, engine="native")
    raise SystemExit("the failed state did not fail")
except RuntimeError:
    pass
helper.jax_native()
stream, prop = JF.encode(data, dict_size=1 << 16, engine="native")
filt = [{"id": lzma.FILTER_LZMA2, "dict_size": 1 << 16}]
assert lzma.decompress(stream, lzma.FORMAT_RAW, filters=filt) == data
print("encoded")
""")
    assert r.returncode == 0 and r.stdout.split() == ["encoded"], \
        r.stdout + r.stderr
