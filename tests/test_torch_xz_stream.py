"""The port's streaming .xz push decoder (``containers/xz.XzStreamDecoder``)
against the JAX package's.

Fed the same images in the same pieces, both must hand their sinks the same
bytes call for call: for the checks none, crc32, crc64 and sha256, for the
x86, ARM, delta (and the other branch) pre-filters, for multi-block images,
for concatenated streams with stream padding, and for images from the
system ``xz``.  Truncated and corrupt images must raise the same error
class in both.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess

import pytest

from lzma_sdk_zliblike_tpu.containers import xz as JX
from lzma_sdk_zliblike_tpu_torch.containers import xz as TX
from lzma_sdk_zliblike_tpu_torch.utils.errors import UnsupportedError

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
_C = _corpus.make_corpus()
DATA = _C["text"][:40000] + _C["binary"][:10000] + _C["random"][:6000]
X86 = _C["x86"][:40000]


def _push(mod, img: bytes, step: int, verify: bool = True):
    """The sink's calls of ``mod.XzStreamDecoder`` fed ``img`` in ``step``
    pieces, then finished."""
    out: list = []
    dec = mod.XzStreamDecoder(out.append, verify=verify)
    for i in range(0, len(img), step):
        dec.feed(img[i:i + step])
    dec.finish()
    return out


def _both(img: bytes, step: int, want: bytes) -> None:
    got = _push(TX, img, step)
    assert got == _push(JX, img, step)
    assert b"".join(got) == want


@pytest.mark.parametrize("step", [1, 997, 1 << 20])
@pytest.mark.parametrize("check", ["none", "crc32", "crc64", "sha256"])
def test_checks_match_jax(check, step):
    img = TX.encode(DATA, check=check, dict_size=1 << 16, block_size=16384)
    _both(img, step, DATA)


@pytest.mark.parametrize("fid,props", [
    (TX.FILTER_X86, b""), (TX.FILTER_ARM, b""), (TX.FILTER_ARMT, b""),
    (TX.FILTER_PPC, b""), (TX.FILTER_SPARC, b""), (TX.FILTER_IA64, b""),
    (TX.FILTER_DELTA, bytes([3]))])
def test_pre_filters_match_jax(fid, props):
    img = TX.encode(X86, check="crc64", dict_size=1 << 16,
                    filters=[TX.XzFilter(fid, props)])
    assert img == JX.encode(X86, check="crc64", dict_size=1 << 16,
                            filters=[JX.XzFilter(fid, props)])
    for step in (777, 1 << 20):
        _both(img, step, X86)


def test_concatenated_streams_with_padding():
    a, b = _C["text"][:5000], _C["code"][:7000]
    img = (TX.encode(a, dict_size=1 << 16, check="crc32") + bytes(8)
           + TX.encode(b, dict_size=1 << 16, check="sha256") + bytes(4))
    for step in (1, 13, 4096):
        _both(img, step, a + b)


@pytest.mark.skipif(shutil.which("xz") is None, reason="no system xz")
@pytest.mark.parametrize("args", [["--x86", "--lzma2=preset=4,dict=64KiB"],
                                  ["--delta=dist=4", "--lzma2=preset=2"],
                                  ["--check=sha256", "--lzma2=preset=1"]])
def test_system_xz_images(tmp_path, args):
    p = tmp_path / "in.bin"
    p.write_bytes(X86)
    r = subprocess.run(["xz", "-kfc"] + args + [str(p)], capture_output=True,
                       check=True)
    _both(r.stdout, 777, X86)


def _error(mod, img, step, verify=True):
    try:
        _push(mod, img, step, verify)
    except Exception as e:          # the class name is what is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("check", ["crc32", "crc64", "sha256"])
def test_truncated_and_corrupt_raise_the_same_class(check):
    img = TX.encode(DATA, check=check, dict_size=1 << 16, block_size=20000)
    cases = {"half": img[:len(img) // 2], "no_footer": img[:-12],
             "one_short": img[:-1]}
    for pos in (20, 40, len(img) // 2, len(img) - 30, len(img) - 5):
        bad = bytearray(img)
        bad[pos] ^= 0x01
        cases[f"flip{pos}"] = bytes(bad)
    cases["garbage_after"] = img + b"garbage!"
    for name, bad in cases.items():
        for step in (7, 1 << 20):
            got = _error(TX, bad, step)
            assert got is not None and got == _error(JX, bad, step), \
                (name, step)


def test_verify_false_skips_the_block_check():
    """A flipped byte in the block's CRC32 (the block ends at its 4-byte
    rounded unpadded size): CrcError with ``verify``, none without."""
    img = TX.encode(DATA, check="crc32", dict_size=1 << 16)
    unpadded = TX.read_backward(img)[0].blocks[0][0]
    bad = bytearray(img)
    bad[12 + unpadded + (-unpadded) % 4 - 2] ^= 0x01
    assert _error(TX, bytes(bad), 4096) == \
        _error(JX, bytes(bad), 4096) == "CrcError"
    assert b"".join(_push(TX, bytes(bad), 4096, verify=False)) == DATA
    assert _error(JX, bytes(bad), 4096, verify=False) is None


def test_two_pre_filters_refused():
    img = JX.encode(X86, dict_size=1 << 16, filters=[
        JX.XzFilter(JX.FILTER_DELTA, bytes([1])), JX.XzFilter(JX.FILTER_X86)])
    with pytest.raises(UnsupportedError):
        _push(TX, img, 4096)
    assert _error(JX, img, 4096) == "UnsupportedError"
