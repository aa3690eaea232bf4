"""The port's native CRC32 and SHA-256 (``native.crc32``, ``native.sha256``,
``native.Sha256``) against ``binascii``/``hashlib`` and the JAX package's
bindings, the single home of the CRC polynomials, and xz's SHA-256 check
end to end: the port's writer against the JAX package's, read back by
Python's ``lzma`` and by the plain K1 (``device="cpu"``).

Pinned: ``utils/checksums.sha256`` stays on ``hashlib`` (the JAX package
calls its owned native SHA-256); the digests are the same bytes.
"""

from __future__ import annotations

import binascii
import hashlib
import importlib.util
import lzma
import os

import pytest

from lzma_sdk_zliblike_tpu import native as JN
from lzma_sdk_zliblike_tpu.containers import xz as JX
from lzma_sdk_zliblike_tpu.utils import checksums as JC
from lzma_sdk_zliblike_tpu_torch import native as N
from lzma_sdk_zliblike_tpu_torch.containers import xz as X
from lzma_sdk_zliblike_tpu_torch.ops import checksum as XC
from lzma_sdk_zliblike_tpu_torch.utils import checksums as C
from lzma_sdk_zliblike_tpu_torch.utils.errors import CrcError
from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's native library, loaded in this worker before the
# module's first test (tests/torch_jax_native.py: a worker can lose the
# JAX package's own build of it)
_jnl = importlib.util.spec_from_file_location(
    "lzt_torch_jax_native", os.path.join(REPO, "tests", "torch_jax_native.py"))
_JNL = importlib.util.module_from_spec(_jnl)
_jnl.loader.exec_module(_JNL)
jax_native_loaded = _JNL.jax_native_loaded
_spec = importlib.util.spec_from_file_location(
    "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
_corpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_corpus)
random_bytes = _corpus.random_bytes

SIZES = (0, 1, 55, 56, 63, 64, 65, 119, 128, 1000, 1 << 16)


@pytest.mark.parametrize("n", SIZES)
def test_crc32_matches_binascii_and_jax(n):
    data = random_bytes(n, seed=n + 7)
    want = binascii.crc32(data)
    assert N.crc32(data) == want == JN.crc32(data)
    cut = n // 3
    rolled = N.crc32(memoryview(data)[cut:], N.crc32(bytearray(data[:cut])))
    assert rolled == want
    assert N.crc32(data, 0x12345678) == binascii.crc32(data, 0x12345678) \
        == JN.crc32(data, 0x12345678)


@pytest.mark.parametrize("n", SIZES)
def test_sha256_matches_hashlib_and_jax(n):
    data = random_bytes(n, seed=n + 1)
    want = hashlib.sha256(data).digest()
    assert N.sha256(data) == want == JN.sha256(data)
    assert N.sha256(bytearray(data)) == N.sha256(memoryview(data)) == want
    h = N.Sha256()
    h.update(data)
    assert h.digest() == want


def test_sha256_streams_with_digest_mid_stream():
    """Odd-sized updates, a digest after each (finalising a copy), and more
    updates after it, as ``tests/test_checksums.py`` checks the JAX
    binding."""
    data = random_bytes(100_000, seed=3)
    h, j, ref = N.Sha256(), JN.Sha256(), hashlib.sha256()
    for off in (0, 1, 63, 64, 100, 5000, 99_000):
        piece = data[off:off + 977]
        h.update(memoryview(piece))
        j.update(piece)
        ref.update(piece)
        assert h.digest() == ref.digest() == j.digest()
    h.update(b"")
    assert h.digest() == ref.digest()


def test_library_path_follows_the_sha256_source(tmp_path, monkeypatch):
    """The library's name hashes every source, so an edited
    ``lzt_sha256.cc`` gives a new library; the copy is the JAX package's
    ``native/lzt_sha256.cc`` byte for byte."""
    before, sources = N.lib_path(), N.SOURCES
    assert N.SHA256_SOURCE in sources
    copy = tmp_path / "lzt_sha256.cc"
    copy.write_bytes(open(N.SHA256_SOURCE, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(N, "SOURCES", tuple(
        str(copy) if s == N.SHA256_SOURCE else s for s in sources))
    assert N.lib_path() != before
    monkeypatch.setattr(N, "SOURCES", sources)
    assert N.lib_path() == before
    assert N.SHA256_SOURCE == os.path.join(
        REPO, "lzma_sdk_zliblike_tpu_torch", "csrc", "host", "lzt_sha256.cc")
    assert open(N.SHA256_SOURCE, "rb").read() == open(
        os.path.join(REPO, "native", "lzt_sha256.cc"), "rb").read()


def test_checksums_sha256_stays_on_hashlib_and_equals_jax():
    data = random_bytes(70_000, seed=11)
    assert C.sha256(data) == JC.sha256(data) == hashlib.sha256(data).digest()
    s = C.Sha256Stream()
    s.update(data[:333])
    s.update(data[333:])
    assert s.digest() == C.sha256(data)
    assert C.crc32(data) == JC.crc32(data) == N.crc32(data)


def test_crc_polynomials_have_one_home():
    assert C.CRC64_POLY == JC.CRC64_POLY == 0xC96C5795D7870F42
    assert C.CRC32_POLY == 0xEDB88320
    assert XC.CRC64_POLY is C.CRC64_POLY and XC.CRC32_POLY is C.CRC32_POLY
    assert XC.CRC64_POLY == 0xC96C5795D7870F42 and XC.CRC32_POLY == 0xEDB88320


def _small() -> bytes:
    c = _corpus.make_corpus()
    return c["text"][:1500] + c["binary"][:500]


def test_xz_sha256_image_matches_jax_and_reaches_k1():
    """The slice's path on the CPU: the port's writer with a SHA-256 check
    at the chip run's parameters (1 MiB dictionary and chunk, threads)
    writes the JAX package's bytes, Python's ``lzma`` reads them, and
    ``xz.decode`` reads them through the plain K1 with no group on the
    host; a flipped digest byte raises CrcError there."""
    data = _small()
    kw = dict(check="sha256", dict_size=1 << 20, chunk_size=1 << 20,
              threads=2)
    img = X.encode(data, **kw)
    assert img == JX.encode(data, **kw)
    assert lzma.decompress(img) == data
    TRACE.reset()
    assert X.decode(img, engine="device", device="cpu") == data
    snap = TRACE.snapshot()
    assert snap.get("scheduler.host_fallback_groups", 0) == 0
    assert snap["scheduler.pallas_batches"] >= 1
    tiny = data[:300]
    bad = bytearray(X.encode(tiny, **kw))
    bad[bad.index(hashlib.sha256(tiny).digest()) + 31] ^= 0x01
    with pytest.raises(CrcError):
        X.decode(bytes(bad), engine="device", device="cpu")


def test_liblzma_sha256_image_reaches_k1():
    data = _small()
    img = lzma.compress(data, format=lzma.FORMAT_XZ, check=lzma.CHECK_SHA256)
    TRACE.reset()
    assert X.decode(img, engine="device", device="cpu") == data
    snap = TRACE.snapshot()
    assert snap.get("scheduler.host_fallback_groups", 0) == 0
    assert snap["scheduler.pallas_batches"] == 1
