"""The PyTorch/CUDA port's host MT decode against the JAX package.

``group_span``, ``decode_group_native`` and ``decode_lzma2_mt`` are held
against the JAX package's on the same streams, exactly; the native decode
and CRC64 bindings against the JAX package's native runtime; and
``lzma2_uncompress``'s engine routing (``progress`` with the device engine
goes to the host MT decoder).
"""

from __future__ import annotations

import importlib.util
import lzma
import os

import pytest

from lzma_sdk_zliblike_tpu import native as JN
from lzma_sdk_zliblike_tpu.models.lzma2 import framing as JF
from lzma_sdk_zliblike_tpu.parallel import host_pool as JH
from lzma_sdk_zliblike_tpu.utils import checksums as JC
import lzma_sdk_zliblike_tpu_torch as P
from lzma_sdk_zliblike_tpu_torch import native
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.parallel import host_pool as H
from lzma_sdk_zliblike_tpu_torch.utils import checksums as C
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


def _liblzma_stream(parts, dict_size=1 << 16):
    groups = [lzma.compress(p, format=lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "preset": 6, "dict_size": dict_size}])[:-1]
        for p in parts]
    return b"".join(groups) + b"\x00", F.encode_dict_prop(dict_size)


@pytest.fixture(scope="module")
def streams():
    """Groups of 0.5-4 KiB: the JAX package's encoder (with copy chunks
    for the random bytes), liblzma, and one group alone."""
    data = big_mixed(9000, seed=61) + random_bytes(2500, seed=62) \
        + big_mixed(3000, seed=63)
    js, jp = JF.encode(data, dict_size=4096, chunk_size=2048)
    parts = [big_mixed(n, seed=64 + i)
             for i, n in enumerate((512, 4096, 1500, 3000))]
    ls, lp = _liblzma_stream(parts)
    one = big_mixed(3500, seed=70)
    os_, op = _liblzma_stream([one])
    return {"jax_encoder": (js, jp, data),
            "liblzma": (ls, lp, b"".join(parts)),
            "one_group": (os_, op, one)}


@pytest.mark.parametrize("name", ["jax_encoder", "liblzma", "one_group"])
def test_group_span_and_native_group_decode_match_jax(streams, name):
    stream, prop, data = streams[name]
    groups = F.split_groups(F.scan(stream)[0])
    jgroups = JF.split_groups(JF.scan(stream)[0])
    out = b""
    for g, jg in zip(groups, jgroups):
        assert H.group_span(stream, g) == JH.group_span(stream, jg)
        part = H.decode_group_native(stream, g, prop)
        assert part == JH.decode_group_native(stream, jg, prop)
        out += part
    assert out == data


@pytest.mark.parametrize("threads", [1, 3, None])
@pytest.mark.parametrize("name", ["jax_encoder", "liblzma", "one_group"])
def test_decode_lzma2_mt_matches_jax(streams, name, threads):
    stream, prop, data = streams[name]
    out = P.decode_lzma2_mt(stream, prop, threads=threads)
    assert out == JH.decode_lzma2_mt(stream, prop, threads=threads) == data


def test_decode_lzma2_mt_progress_in_order_and_abort(streams):
    stream, prop, data = streams["jax_encoder"]
    n_groups = len(F.split_groups(F.scan(stream)[0]))
    seen = []
    assert P.decode_lzma2_mt(stream, prop, threads=3, progress=lambda i, o:
                             seen.append((i, o))) == data
    assert len(seen) == n_groups
    assert all(a < b for a, b in zip(seen, seen[1:]))
    assert seen[-1][1] == len(data)
    calls = []
    with pytest.raises(P.ProgressAborted):
        P.decode_lzma2_mt(stream, prop, threads=2,
                          progress=lambda i, o: calls.append(o) or False)
    assert len(calls) == 1


def test_corrupt_group_raises(streams):
    stream, prop, _ = streams["liblzma"]
    groups = F.split_groups(F.scan(stream)[0])
    bad = bytearray(stream)
    c = groups[1][0]
    bad[c.data_off + c.pack_size // 2] ^= 0x5A
    with pytest.raises(P.LzmaError):
        P.decode_lzma2_mt(bytes(bad), prop, threads=2)
    with pytest.raises(P.InputEofError):
        P.decode_lzma2_mt(stream[:-1], prop)


def test_native_decode_grows_a_short_buffer(streams):
    stream, prop, data = streams["jax_encoder"]
    for hint in (None, 0, 1, len(data) // 5, len(data)):
        assert native.lzma2_decode(stream, prop, size_hint=hint) == data \
            == JN.lzma2_decode(stream, prop, size_hint=hint or len(data))
    assert native.lzma2_decode(b"\x00", prop) == b""
    with pytest.raises(P.ParamError):
        native.lzma2_decode(stream, 41)


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("effort", [1, 9, 10])
def test_native_encode_options_match_jax(parallel, effort):
    data = big_mixed(12_000, seed=71)
    own = native.lzma2_encode(data, 1 << 16, 4096, parallel, effort=effort)
    assert own == JN.lzma2_encode(data, 1 << 16, 4096, parallel,
                                  effort=effort)
    assert native.lzma2_decode(own[0], own[1]) == data


def test_crc64_matches_jax():
    data = big_mixed(70_001, seed=72)
    for n in (0, 1, 7, 8, 9, 1000, len(data)):
        assert C.crc64(data[:n]) == JC.crc64(data[:n])
    assert C.crc64(data[5:], C.crc64(data[:5])) == JC.crc64(data)
    assert C.crc64(b"123456789") == 0x995DC9BBDF1939FA   # check value
    for k in (C.crc32, C.sha256):
        assert k(data) == getattr(JC, k.__name__)(data)
    for cls in ("Crc32Stream", "Crc64Stream", "Sha256Stream"):
        own, ref = getattr(C, cls)(), getattr(JC, cls)()
        for a in range(0, len(data), 9999):
            own.update(data[a:a + 9999])
            ref.update(data[a:a + 9999])
        assert (own.digest() if cls == "Sha256Stream" else own.value) == \
            (ref.digest() if cls == "Sha256Stream" else ref.value)


@pytest.mark.parametrize("engine", ["device", "hybrid", "host"])
def test_lzma2_uncompress_engines_match_jax(streams, engine):
    import lzma_sdk_zliblike_tpu as jlzt
    for stream, prop, data in streams.values():
        assert P.lzma2_uncompress(stream, prop, engine=engine,
                                  device="cpu", threads=2) == data == \
            jlzt.lzma2_uncompress(stream, prop)


def test_progress_with_device_engine_goes_to_host_mt(streams, monkeypatch):
    """The device engine has no per-group hook: a progress callback sends
    the call to the host MT decoder, as the JAX package routes it, and the
    callback sees every group and can abort."""
    stream, prop, data = streams["liblzma"]

    def no_launch(*args, **kw):
        raise AssertionError("K1 ran for a call with a progress callback")
    monkeypatch.setattr(G, "submit_groups", no_launch)
    seen = []
    TRACE.reset()
    assert P.lzma2_uncompress(stream, prop, device="cpu",
                              progress=lambda i, o: seen.append(o)) == data
    assert seen[-1] == len(data) and len(seen) == 4
    assert "scheduler.pallas_batches" not in TRACE.snapshot()
    with pytest.raises(P.ProgressAborted):
        P.lzma2_uncompress(stream, prop, device="cpu",
                           progress=lambda i, o: False)
    with pytest.raises(P.UnsupportedError, match="engine"):
        P.lzma2_uncompress(stream, prop, engine="tpu", device="cpu")
