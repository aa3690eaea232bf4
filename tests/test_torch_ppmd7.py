"""The port's PPMd7 codec (``models/ppmd7/codec.py`` and the native
``csrc/host/lzt_ppmd7.cc``) against the JAX package's.

For every (order, memory) pair of ``tests/test_ppmd7.py`` the port's native
encoder must give the JAX package's stream (and the reference's, where the
``oracle`` fixture has ``oracle_driver``), decoding must give the data
back, and the port's ``engine="python"`` must equal its native engine both
ways.  Bad props raise ParamError and a corrupt stream DataError, in both
packages.  The pure-Python model runs at about 50 KB/s, so inputs stay at
24 KB or less.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess

import pytest

from lzma_sdk_zliblike_tpu.models.ppmd7 import codec as JP
from lzma_sdk_zliblike_tpu_torch import native as N
from lzma_sdk_zliblike_tpu_torch.models.ppmd7 import codec as TP
from lzma_sdk_zliblike_tpu_torch.utils.errors import (DataError, ParamError,
                                                      UnsupportedError)

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

# (order, memory, bytes of input): the JAX tests' pairs; the small pools
# (2-16 KiB) take 20 KB so that the model restarts
PAIRS = [(6, 1 << 20, 8000), (2, 1 << 16, 8000), (4, 1 << 18, 8000),
         (10, 1 << 21, 8000), (16, 1 << 22, 8000), (6, 1 << 11, 20000),
         (6, 1 << 12, 20000), (6, 1 << 14, 20000), (12, 1 << 14, 20000)]
IDS = [f"o{o}-m{m}" for o, m, _n in PAIRS]


def _data(n: int) -> bytes:
    return (_C["text"] + _C["x86"])[:n]


@pytest.mark.parametrize("order,mem,n", PAIRS, ids=IDS)
def test_native_encode_matches_jax(order, mem, n):
    data = _data(n)
    stream, props = TP.encode(data, order, mem)
    assert (stream, props) == JP.encode(data, order, mem)
    assert props == bytes([order]) + mem.to_bytes(4, "little")
    assert TP.decode(stream, props, len(data)) == data
    assert JP.decode(stream, props, len(data)) == data


@pytest.mark.parametrize("order,mem,n", PAIRS, ids=IDS)
def test_python_engine_equals_native(order, mem, n):
    data = _data(n)
    stream, props = TP.encode(data, order, mem, engine="native")
    assert TP.encode(data, order, mem, engine="python") == (stream, props)
    assert TP.decode(stream, props, len(data), engine="python") == data


@pytest.mark.parametrize("name", ["text", "code", "binary", "x86", "repeat",
                                  "random", "tiny"])
def test_corpus_round_trip_matches_jax(name):
    data = _C[name][:12000]
    stream, props = TP.encode(data, 6, 1 << 20)
    assert stream == JP.encode(data, 6, 1 << 20)[0]
    assert TP.decode(stream, props, len(data)) == data


def test_oracle_encodes_the_same(oracle, tmp_path):
    for order, mem, n in PAIRS:
        data = _data(n)
        a, b = tmp_path / "in", tmp_path / "enc"
        a.write_bytes(data)
        subprocess.run([oracle["oracle_driver"], "ppmd7e", str(order),
                        str(mem), str(a), str(b)], check=True,
                       capture_output=True)
        assert TP.encode(data, order, mem)[0] == b.read_bytes(), (order, mem)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_bad_props_raise_param_error(engine):
    data = _data(500)
    stream, props = TP.encode(data, 6, 1 << 20)
    for bad in (bytes([1]) + props[1:], bytes([6]) + (100).to_bytes(4,
                                                                     "little"),
                bytes([65]) + props[1:], props[:4]):
        with pytest.raises(ParamError):
            TP.decode(stream, bad, len(data), engine=engine)
        with pytest.raises(JP.ParamError):
            JP.decode(stream, bad, len(data))
    for order, mem in ((1, 1 << 20), (6, 100), (65, 1 << 20)):
        with pytest.raises(ParamError):
            TP.encode(data, order, mem, engine=engine)
    with pytest.raises(ParamError):
        TP.Ppmd7(1, 1 << 20)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_corrupt_stream_raises_data_error(engine):
    data = _data(2000)
    stream, props = TP.encode(data, 6, 1 << 20)
    for bad in (bytes([1]) + stream[1:], stream[:len(stream) // 2],
                stream[:5]):
        with pytest.raises(DataError):
            TP.decode(bad, props, len(data), engine=engine)
        try:
            JP.decode(bad, props, len(data))
            jerr = None
        except Exception as e:      # the JAX class, compared by name
            jerr = type(e).__name__
        assert jerr == "DataError"


def test_device_engine_names_refused():
    """Pinned: the JAX codec runs its Python model for every engine name
    but "auto"; the port refuses device names."""
    data = _data(300)
    stream, props = TP.encode(data)
    assert JP.decode(stream, props, len(data), engine="tpu") == data
    for engine in ("tpu", "device", "cuda"):
        with pytest.raises(UnsupportedError):
            TP.encode(data, engine=engine)
        with pytest.raises(UnsupportedError):
            TP.decode(stream, props, len(data), engine=engine)


def test_library_path_follows_the_ppmd_source(tmp_path, monkeypatch):
    """The library's name hashes both sources, so an edited
    ``lzt_ppmd7.cc`` gives a new library rather than loading one built
    without it."""
    before, sources = N.lib_path(), N.SOURCES
    assert N.PPMD_SOURCE in sources
    copy = tmp_path / "lzt_ppmd7.cc"
    copy.write_bytes(open(N.PPMD_SOURCE, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(N, "SOURCES", tuple(
        str(copy) if s == N.PPMD_SOURCE else s for s in sources))
    assert N.lib_path() != before
    monkeypatch.setattr(N, "SOURCES", sources)
    assert N.lib_path() == before
    assert N.PPMD_SOURCE == os.path.join(
        REPO, "lzma_sdk_zliblike_tpu_torch", "csrc", "host", "lzt_ppmd7.cc")
    assert open(N.PPMD_SOURCE, "rb").read() == open(
        os.path.join(REPO, "native", "lzt_ppmd7.cc"), "rb").read()
