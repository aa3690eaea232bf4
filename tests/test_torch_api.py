"""The port's one-call API against the JAX package's, on the host.

``compress``/``uncompress``, ``lzma2_compress`` (one thread and several),
``lzma2_compress_stream`` and ``lzma2_compress_file`` must give the JAX
package's bytes on the same inputs (data from a seed), with the native
engine and with the pure-Python one on at most 10 KB; ``utils/props`` must
normalise as the JAX package's does.  A device engine name, which the JAX
package quietly runs on the pure-Python codec, raises UnsupportedError.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

import lzma_sdk_zliblike_tpu as J
import lzma_sdk_zliblike_tpu_torch as T
from lzma_sdk_zliblike_tpu import api as JA
from lzma_sdk_zliblike_tpu.utils import props as JP
from lzma_sdk_zliblike_tpu_torch import api as TA
from lzma_sdk_zliblike_tpu_torch import engine as TE
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import decode_lzma2_mt
from lzma_sdk_zliblike_tpu_torch.utils import props as TP
from lzma_sdk_zliblike_tpu_torch.utils.errors import (ProgressAborted,
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
DATA = _corpus.big_mixed(200_000, seed=9)
SMALL = _corpus.big_mixed(9_000, seed=4)
DEVICE_ENGINES = ["tpu", "device", "hybrid"]


@pytest.mark.parametrize("level", [0, 3, 5, 9])
def test_compress_matches_jax(level):
    stream, props = T.compress(DATA, level=level)
    assert (stream, props) == J.compress(DATA, level=level)
    assert T.uncompress(stream, props, len(DATA)) == DATA
    assert T.uncompress(stream, props, len(DATA), engine="native") == DATA


def test_compress_python_engine_matches_jax():
    stream, props = T.compress(SMALL, engine="python", lc=1, lp=2, pb=1)
    assert (stream, props) == J.compress(SMALL, engine="python", lc=1, lp=2,
                                         pb=1)
    assert T.uncompress(stream, props, len(SMALL), engine="python") == SMALL
    assert T.uncompress(stream, props, len(SMALL)) == SMALL


@pytest.mark.parametrize("threads", [None, 1, 3])
def test_lzma2_compress_matches_jax(threads):
    kw = dict(threads=threads, dict_size=1 << 16, chunk_size=1 << 16)
    stream, prop = T.lzma2_compress(DATA, **kw)
    assert (stream, prop) == J.lzma2_compress(DATA, **kw)
    assert decode_lzma2_mt(stream, prop) == DATA


def test_lzma2_compress_python_engine_matches_jax():
    kw = dict(dict_size=1 << 16, chunk_size=4096, engine="python")
    stream, prop = T.lzma2_compress(SMALL, **kw)
    assert (stream, prop) == J.lzma2_compress(SMALL, **kw)
    assert decode_lzma2_mt(stream, prop) == SMALL
    assert len(framing.split_groups(framing.scan(stream)[0])) == 3


def test_lzma2_compress_props_and_progress():
    ep = TP.from_level(1, chunk_size=1 << 16, num_block_threads=2)
    jp = JP.from_level(1, chunk_size=1 << 16, num_block_threads=2)
    assert ep == TP.EncProps(**vars(jp))
    assert T.lzma2_compress(DATA, props=ep) == J.lzma2_compress(DATA,
                                                                props=jp)
    calls = []

    def stop(done, out):
        calls.append(done)
        return False
    with pytest.raises(ProgressAborted):
        T.lzma2_compress(DATA, threads=2, dict_size=1 << 16,
                         chunk_size=1 << 16, progress=stop)
    assert calls == [1 << 16]


@pytest.mark.parametrize("piece", [1 << 20, 4096, 1001])
def test_lzma2_compress_stream_matches_jax(piece):
    je = JA.lzma2_compress_stream(dict_size=1 << 16, level=3)
    want = je.compress(DATA) + je.flush()
    te = TA.lzma2_compress_stream(dict_size=1 << 16, level=3)
    got = b"".join(te.compress(DATA[i:i + piece])
                   for i in range(0, len(DATA), piece)) + te.flush()
    assert got == want and te.dict_prop == je.dict_prop
    assert decode_lzma2_mt(got, te.dict_prop) == DATA
    with pytest.raises(ValueError):
        te.flush()


def test_lzma2_compress_file_matches_jax(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(DATA)
    seen = []
    prop = TA.lzma2_compress_file(str(src), str(tmp_path / "t.lzma2"),
                                  dict_size=1 << 16, read_size=50_000,
                                  progress=lambda d, o: seen.append(d))
    jprop = JA.lzma2_compress_file(str(src), str(tmp_path / "j.lzma2"),
                                   dict_size=1 << 16, read_size=50_000)
    assert prop == jprop
    assert (tmp_path / "t.lzma2").read_bytes() == \
        (tmp_path / "j.lzma2").read_bytes()
    assert seen == [50_000, 100_000, 150_000, 200_000]
    with pytest.raises(ProgressAborted):
        TA.lzma2_compress_file(str(src), str(tmp_path / "x"),
                               dict_size=1 << 16, read_size=50_000,
                               progress=lambda d, o: False)


def test_level_tables_match_jax():
    for level in range(12):
        assert TA.default_dict_size(level) == JA.default_dict_size(level)
        assert TA.default_effort(level) == JA.default_effort(level)
        assert TP.from_level(level) == TP.EncProps(
            **vars(JP.from_level(level)))


@pytest.mark.parametrize("engine", DEVICE_ENGINES)
def test_device_engine_names_are_refused(engine):
    """The JAX package runs these on the pure-Python codec (queue 3 of
    ROADMAP.md); the port refuses them everywhere raw LZMA is coded."""
    stream, props = T.compress(SMALL)
    for call in (lambda: T.compress(SMALL, engine=engine),
                 lambda: T.uncompress(stream, props, len(SMALL),
                                      engine=engine),
                 lambda: T.lzma2_compress(SMALL, engine=engine),
                 lambda: T.lzma2_compress(SMALL, engine=engine, threads=2),
                 lambda: framing.encode(SMALL, engine=engine),
                 lambda: TE.check_engine(engine)):
        with pytest.raises(UnsupportedError):
            call()
