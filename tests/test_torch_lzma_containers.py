"""The port's ``.lzma`` and ``.lzma86`` containers against the JAX package's.

Images must be byte-identical (native and pure-Python engines, end marker
or size header, every .lzma86 filter mode), each package must read the
other's, and truncated or corrupt images must raise the same error types.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

from lzma_sdk_zliblike_tpu.containers import lzma86 as J86
from lzma_sdk_zliblike_tpu.containers import lzma_file as JLF
from lzma_sdk_zliblike_tpu.models.lzma.spec import LzmaProps as JProps
from lzma_sdk_zliblike_tpu_torch.containers import lzma86 as T86
from lzma_sdk_zliblike_tpu_torch.containers import lzma_file as TLF
from lzma_sdk_zliblike_tpu_torch.models.lzma.spec import LzmaProps
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
DATA = _corpus.big_mixed(120_000, seed=21)
X86 = _corpus.x86_like(120_000, seed=22)


@pytest.mark.parametrize("end_mark", [False, True])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_lzma_file_matches_jax(end_mark, engine):
    data = DATA if engine == "native" else DATA[:8000]
    img = TLF.encode(data, LzmaProps(dict_size=1 << 16),
                     write_end_mark=end_mark, engine=engine)
    assert img == JLF.encode(data, JProps(dict_size=1 << 16),
                             write_end_mark=end_mark, engine=engine)
    assert TLF.decode(img) == data
    assert TLF.decode(img, engine="python" if len(data) <= 8000
                      else "native") == data
    props, size = TLF.parse_header(img)
    assert size == (None if end_mark else len(data))
    assert props == LzmaProps(dict_size=1 << 16)


@pytest.mark.parametrize("mode", [T86.FILTER_NO, T86.FILTER_YES,
                                  T86.FILTER_AUTO])
def test_lzma86_matches_jax(mode):
    img = T86.encode(X86, dict_size=1 << 16, filter_mode=mode)
    assert img == J86.encode(X86, dict_size=1 << 16, filter_mode=mode)
    assert T86.decode(img) == X86 and J86.decode(img) == X86
    assert T86.get_unpack_size(img) == len(X86)
    if mode == T86.FILTER_YES:
        assert img[0] == 1


def _errors(fn, img):
    try:
        fn(img)
    except Exception as e:      # the type is what is compared
        return type(e).__name__
    return None


def _bad_images(img: bytes, header: int):
    mid = bytearray(img)
    mid[len(img) // 2] ^= 0xFF
    hdr = bytearray(img)               # the size field, 1,000 too large
    size = int.from_bytes(img[header - 8:header], "little")
    hdr[header - 8:header] = (size + 1000).to_bytes(8, "little")
    return {"empty": b"", "short header": img[:header - 1],
            "header only": img[:header], "truncated": img[:len(img) // 2],
            "one byte short": img[:-1], "corrupt": bytes(mid),
            "wrong size": bytes(hdr)}


def test_lzma_file_errors_match_jax():
    img = TLF.encode(DATA[:50_000], LzmaProps(dict_size=1 << 16))
    bad = _bad_images(img, TLF.HEADER_SIZE)
    bad["bad props"] = bytes([225]) + img[1:]
    for name, b in bad.items():
        t = _errors(TLF.decode, b)
        assert t is not None and t == _errors(JLF.decode, b), name


def test_lzma86_errors_match_jax():
    img = T86.encode(X86[:50_000], dict_size=1 << 16, filter_mode=1)
    bad = _bad_images(img, T86.HEADER_SIZE)
    bad["bad filter id"] = bytes([2]) + img[1:]
    for name, b in bad.items():
        t = _errors(T86.decode, b)
        assert t is not None and t == _errors(J86.decode, b), name
    assert _errors(T86.get_unpack_size, img[:5]) == \
        _errors(J86.get_unpack_size, img[:5]) == "InputEofError"


def test_device_engine_refused():
    img = TLF.encode(DATA[:1000])
    for call in (lambda: TLF.encode(DATA[:1000], engine="tpu"),
                 lambda: TLF.decode(img, engine="tpu"),
                 lambda: T86.encode(X86[:1000], engine="device"),
                 lambda: T86.decode(T86.encode(X86[:1000]), engine="tpu")):
        with pytest.raises(UnsupportedError):
            call()
