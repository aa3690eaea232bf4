"""The PyTorch/CUDA port's .xz container, filters and CLI against the JAX
package.

``containers/xz.encode`` must write the JAX package's image byte for byte
for every check, block size and filter chain of ``tests/test_containers.py``;
``decode`` must read the JAX package's images, system ``xz``'s and Python's
``lzma``'s, with each block's LZMA2 payload on the plain K1
(``device="cpu"``) and on the host engines; ``read_backward`` and every
copied filter must match the JAX package's.  The CLI runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import lzma
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lzma_sdk_zliblike_tpu.containers import xz as JX
from lzma_sdk_zliblike_tpu.ops import filters as JFL
import lzma_sdk_zliblike_tpu_torch as P
from lzma_sdk_zliblike_tpu_torch.cli import xz_util
from lzma_sdk_zliblike_tpu_torch.containers import xz as X
from lzma_sdk_zliblike_tpu_torch.ops import filters as FL
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
HAVE_XZ = shutil.which("xz") is not None


def _corpus():
    """tests/corpus.py, loaded by path: on some machines a foreign package
    named ``tests`` shadows this directory."""
    spec = importlib.util.spec_from_file_location(
        "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CORPUS = _corpus()


@pytest.fixture(scope="module")
def corpus():
    return _CORPUS.make_corpus()


def _data(corpus):
    """test_containers.py's input."""
    return corpus["text"][:30000] + corpus["binary"][:8000]


def _small(corpus):
    """A few KiB for the plain K1, which decodes a byte per lane step."""
    return corpus["text"][:3000] + corpus["binary"][:1000]


@pytest.mark.parametrize("check", ["none", "crc32", "crc64", "sha256"])
def test_encode_checks_match_jax(corpus, check):
    data = _data(corpus)
    img = X.encode(data, check=check, dict_size=1 << 16)
    assert img == JX.encode(data, check=check, dict_size=1 << 16)
    assert X.decode(img, engine="host") == data == lzma.decompress(img)


@pytest.mark.parametrize("check,block", [("crc32", 16384), ("crc64", 16384),
                                         ("sha256", 16384), ("crc64", 8192)])
def test_encode_blocks_match_jax(corpus, tmp_path, check, block):
    data = _data(corpus)
    img = X.encode(data, check=check, dict_size=1 << 16, block_size=block)
    assert img == JX.encode(data, check=check, dict_size=1 << 16,
                            block_size=block)
    assert X.decode(img, engine="hybrid", device="cpu") == data
    infos = X.read_backward(img)
    assert [dataclasses.astuple(i) for i in infos] == \
        [dataclasses.astuple(i) for i in JX.read_backward(img)]
    assert len(infos[0].blocks) == (len(data) + block - 1) // block
    if HAVE_XZ:
        p = tmp_path / "t.xz"
        p.write_bytes(img)
        r = subprocess.run(["xz", "-dc", str(p)], capture_output=True)
        assert r.returncode == 0 and r.stdout == data


@pytest.mark.parametrize("f", [
    X.XzFilter(X.FILTER_DELTA, bytes([3])),
    X.XzFilter(X.FILTER_X86),
    X.XzFilter(X.FILTER_ARM),
    X.XzFilter(X.FILTER_SPARC),
], ids=["delta", "x86", "arm", "sparc"])
def test_encode_filter_chains_match_jax(corpus, f):
    data = corpus["x86"]
    img = X.encode(data, dict_size=1 << 16, filters=[f])
    assert img == JX.encode(data, dict_size=1 << 16,
                            filters=[JX.XzFilter(f.fid, f.props)])
    assert X.decode(img, engine="host") == data == lzma.decompress(img)
    small = data[:4096]
    img = X.encode(small, dict_size=1 << 16, filters=[f])
    assert X.decode(img, device="cpu") == small


@pytest.mark.parametrize("effort", [5, 9])
def test_threaded_encode_matches_jax(corpus, effort):
    data = _data(corpus)
    for threads in (2, 3):
        img = X.encode(data, check="crc64", dict_size=1 << 16,
                       chunk_size=8192, threads=threads, effort=effort)
        assert img == JX.encode(data, check="crc64", dict_size=1 << 16,
                                chunk_size=8192, threads=threads,
                                effort=effort)
        assert lzma.decompress(img) == data
    small = _small(corpus)
    img = X.encode(small, dict_size=1 << 16, chunk_size=1024, threads=2)
    TRACE.reset()
    assert X.decode(img, device="cpu") == small
    assert TRACE.snapshot()["scheduler.pallas_batches"] == 1


def test_concatenated_streams_and_empty_input(corpus):
    a = corpus["text"][:2000]
    b = corpus["code"][:1500]
    img = X.encode(a, dict_size=1 << 16) + X.encode(b, dict_size=1 << 16)
    assert img == JX.encode(a, dict_size=1 << 16) + \
        JX.encode(b, dict_size=1 << 16)
    assert X.decode(img, device="cpu") == a + b
    assert len(X.read_backward(img)) == 2
    empty = X.encode(b"")
    assert empty == JX.encode(b"")
    assert X.decode(empty, device="cpu") == b"" == lzma.decompress(empty)


@pytest.mark.skipif(not HAVE_XZ, reason="no system xz")
@pytest.mark.parametrize("args", [["-0"], ["-6"], ["--check=crc64"],
                                  ["--check=sha256"],
                                  ["--block-size=1024"],
                                  ["--delta=dist=4", "--lzma2=preset=4"],
                                  ["--x86", "--lzma2=preset=4"]])
def test_decode_system_xz(corpus, tmp_path, args):
    data = _small(corpus)
    p = tmp_path / "in.bin"
    p.write_bytes(data)
    r = subprocess.run(["xz", "-kfc"] + args + [str(p)], capture_output=True)
    assert r.returncode == 0
    TRACE.reset()
    assert X.decode(r.stdout, device="cpu") == data == JX.decode(r.stdout)
    assert TRACE.snapshot().get("scheduler.host_fallback_groups", 0) == 0
    assert X.decode(r.stdout, engine="host") == data


def test_decode_jax_images(corpus):
    data = _small(corpus)
    for kw in ({"check": "sha256", "block_size": 1500},
               {"check": "crc64", "chunk_size": 1024},
               {"filters": [JX.XzFilter(JX.FILTER_DELTA, bytes([1]))]}):
        img = JX.encode(data, dict_size=1 << 16, **kw)
        assert X.decode(img, device="cpu") == data
        assert X.decode(img, engine="hybrid", device="cpu") == data


def test_liblzma_block_reaches_k1(corpus):
    """A block of Python's lzma (one dict-reset group of many chunks) is
    sized by ``shape_for_groups`` and decoded by K1, never on the host."""
    data = _small(corpus)
    img = lzma.compress(data, format=lzma.FORMAT_XZ)
    TRACE.reset()
    assert X.decode(img, device="cpu") == data
    snap = TRACE.snapshot()
    assert snap.get("scheduler.host_fallback_groups", 0) == 0
    assert snap["scheduler.pallas_batches"] == 1


def test_corrupt_images_raise(corpus):
    data = _data(corpus)
    img = bytearray(X.encode(data, check="crc32", dict_size=1 << 16))
    img[40] ^= 0x01
    with pytest.raises(P.LzmaError):
        X.decode(bytes(img), engine="host")
    img = X.encode(_small(corpus), check="crc64", dict_size=1 << 16)
    bad = bytearray(img)
    bad[-13 - 12] ^= 0x01              # a byte of the block's CRC64
    with pytest.raises(P.CrcError):
        X.decode(bytes(bad), device="cpu")
    assert X.decode(bytes(bad), device="cpu", verify=False) == \
        _small(corpus)
    with pytest.raises(P.ArchiveError):
        X.decode(b"\xfd7zXZ\x01" + img[6:], engine="host")


@pytest.mark.parametrize("engine", ["device", "hybrid"])
def test_encode_has_no_device_engine(corpus, engine):
    with pytest.raises(P.UnsupportedError):
        X.encode(_small(corpus), engine=engine)


def _filter_cases():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    # plant branch opcodes so that every converter has work to do
    b = bytearray(data)
    for pos in range(0, 5900, 97):
        b[pos] = (0xE8, 0xEB, 0x48, 0x40)[pos % 4]
    return bytes(b)


@pytest.mark.parametrize("name", ["arm_convert", "armt_convert",
                                  "ppc_convert", "sparc_convert",
                                  "ia64_convert"])
def test_branch_filters_match_jax(name):
    data = _filter_cases()
    for ip in (0, 4096, 0x123456):
        for encoding in (True, False):
            out = getattr(FL, name)(data, ip, encoding)
            assert out == getattr(JFL, name)(data, ip, encoding)
        if ip % 16 == 0:     # xz aligns a filter's start offset
            assert getattr(FL, name)(getattr(FL, name)(data, ip, True), ip,
                                     False) == data


def test_x86_delta_and_bcj2_filters_match_jax():
    data = _filter_cases()
    for ip in (0, 0x1000):
        for encoding in (True, False):
            assert FL.x86_convert(data, ip, encoding) == \
                JFL.x86_convert(data, ip, encoding)
    for dist in (1, 4, 7, 256):
        enc = FL.delta_encode(data, dist)
        assert enc == JFL.delta_encode(data, dist)
        assert FL.delta_decode(enc[0], dist) == JFL.delta_decode(enc[0], dist)
        assert FL.delta_decode(enc[0], dist)[0] == data
    streams = FL.bcj2_encode(data, 0)
    assert streams == JFL.bcj2_encode(data, 0)
    assert FL.bcj2_decode(*streams, len(data)) == data == \
        JFL.bcj2_decode(*streams, len(data))


def test_cli_roundtrip_on_cpu(corpus, tmp_path, capsys):
    data = _small(corpus)
    src, img, out = (tmp_path / n for n in ("in.bin", "in.xz", "out.bin"))
    src.write_bytes(data)
    assert xz_util.main(["c", str(src), str(img), "--check", "crc64",
                         "--dict-size", str(1 << 16), "--block-size",
                         "2048"]) == 0
    assert img.read_bytes() == JX.encode(data, check="crc64",
                                         dict_size=1 << 16, block_size=2048)
    for engine in ("device", "hybrid", "host"):
        out.unlink(missing_ok=True)
        assert xz_util.main(["d", str(img), str(out), "--engine", engine,
                             "--device", "cpu"]) == 0
        assert out.read_bytes() == data
    capsys.readouterr()
    assert xz_util.main(["l", str(img)]) == 0
    listing = capsys.readouterr().out
    assert "stream 0: check=0x4 blocks=2" in listing
    assert xz_util.main(["c", str(src), str(img), "--engine", "device"]) \
        == P.UnsupportedError.sres
    img.write_bytes(b"not an xz image at all")
    assert xz_util.main(["d", str(img), str(out), "--device", "cpu"]) \
        == P.ArchiveError.sres
    r = subprocess.run([sys.executable, "-m",
                        "lzma_sdk_zliblike_tpu_torch.cli.xz_util", "l",
                        str(tmp_path / "missing.xz")], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 8 and "io error" in r.stderr


@pytest.mark.cuda
def test_decode_on_card(corpus):
    import torch
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    data = _data(corpus)
    for img in (lzma.compress(data, format=lzma.FORMAT_XZ),
                X.encode(data, check="crc64", dict_size=1 << 16,
                         block_size=16384)):
        G.launches = 0
        TRACE.reset()
        assert X.decode(img) == data
        assert G.launches > 0
        assert TRACE.snapshot().get("scheduler.host_fallback_groups", 0) == 0
