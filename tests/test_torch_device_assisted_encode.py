"""The PyTorch/CUDA port's device-assisted encode against the JAX package's.

``encode_lzma2_device(device="cpu")`` (X2 in torch ops on the CPU, then the
host coder ``native.lzma2_encode_ext`` per group on a thread pool) must give
the JAX package's ``encode_lzma2_device`` stream byte for byte: at the JAX
test's inputs (``tests/test_device_encode.py``), at effort 9 and 10, for the
empty and tiny inputs, and over several batches.  The per-batch join must
equal one ``lzma2_encode_ext`` call over the whole input, and the stream
must decode with Python's ``lzma``.
"""

from __future__ import annotations

import importlib.util
import lzma
import os

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu.parallel.device_encode import \
    encode_lzma2_device as jax_encode_device
import lzma_sdk_zliblike_tpu_torch as P
from lzma_sdk_zliblike_tpu_torch import native
from lzma_sdk_zliblike_tpu_torch.ops import match_find as M
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


def _corpus():
    """tests/corpus.py, loaded by path: on some machines a foreign package
    named ``tests`` shadows this directory."""
    spec = importlib.util.spec_from_file_location(
        "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CORPUS = _corpus()
big_mixed, random_bytes = _CORPUS.big_mixed, _CORPUS.random_bytes


def _raw_decode(stream, dict_size):
    return lzma.decompress(stream, format=lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "dict_size": dict_size}])


@pytest.fixture(scope="module")
def jax_input():
    """The JAX package's test_roundtrip_and_ratio input: 69 groups of 16 KiB,
    9 batches of 8 lanes, the last one of 5."""
    return big_mixed(1 << 20) + b"Z" * 5000 + random_bytes(1 << 16, seed=2)


@pytest.mark.parametrize("effort", [9, 10])
def test_matches_jax_stream(jax_input, effort):
    kw = dict(dict_size=1 << 14, chunk_size=1 << 14, lanes=8, effort=effort)
    TRACE.reset()
    got = P.encode_lzma2_device(jax_input, device="cpu", **kw)
    snap = TRACE.snapshot()
    assert got == jax_encode_device(jax_input, **kw)
    assert snap["device_encode.x2_batches"] == 9
    assert snap["device_encode.match_find"]["count"] == 9
    assert snap["device_encode.encode_ext"]["count"] == 69
    assert _raw_decode(got[0], 1 << 14) == jax_input


@pytest.mark.parametrize("data", [b"", b"a", b"ab" * 3],
                         ids=["empty", "one", "six"])
def test_empty_and_tiny(data):
    kw = dict(dict_size=1 << 12, chunk_size=1 << 12, lanes=4)
    got = P.encode_lzma2_device(data, device="cpu", **kw)
    assert got == jax_encode_device(data, **kw)
    assert _raw_decode(got[0], 1 << 12) == data


def test_batch_join_equals_whole_input_call():
    """The groups encoded batch by batch and joined give the bytes of one
    ``lzma2_encode_ext`` call over the whole input with every group's
    candidates, at a dictionary smaller than the chunk (raised to it)."""
    chunk = 1 << 13
    data = big_mixed(11 * chunk - 700, seed=23)
    n_groups = -(-len(data) // chunk)
    rows = np.zeros((n_groups, chunk), np.uint8)
    rows.reshape(-1)[:len(data)] = np.frombuffer(data, np.uint8)
    valid = np.minimum(len(data) - chunk * np.arange(n_groups), chunk)
    _bl, _bd, cands = M.find_matches(rows, valid, n_cand=24, n_cand8=12,
                                     device="cpu")
    ext = np.stack(cands, axis=-1).reshape(-1, 36)[:len(data)]
    whole = native.lzma2_encode_ext(data, ext, chunk, chunk)
    assert P.encode_lzma2_device(data, dict_size=1 << 12, chunk_size=chunk,
                                 lanes=3, device="cpu") == whole
    assert _raw_decode(whole[0], chunk) == data


def test_short_ext_raises():
    data = big_mixed(5000, seed=24)
    with pytest.raises(P.ParamError, match="ext"):
        native.lzma2_encode_ext(data, np.zeros((4999, 3), np.int32), 1 << 16,
                                1 << 16)
    with pytest.raises(P.ParamError, match="ext"):
        native.lzma2_encode_ext(data, np.zeros(5000, np.int32), 1 << 16,
                                1 << 16)
    stream, prop = native.lzma2_encode_ext(
        data, np.zeros((5000, 3), np.int32), 1 << 16, 1 << 16)
    assert _raw_decode(stream, 1 << 16) == data


def test_chunk_size_must_be_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        P.encode_lzma2_device(b"abc", chunk_size=3000, device="cpu")


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(P.UnsupportedError):
        P.encode_lzma2_device(b"abc" * 100)


@pytest.mark.cuda
def test_device_assisted_on_card(jax_input):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    kw = dict(dict_size=1 << 14, chunk_size=1 << 14, lanes=8)
    assert P.encode_lzma2_device(jax_input, **kw) == \
        P.encode_lzma2_device(jax_input, device="cpu", **kw)
