"""The port's streaming surfaces against the JAX package's:
``streams/extract7z.extract_streaming`` (constant-memory 7z extraction,
``FileRouter``, ``StreamingBranchFilter``) and the zlib-like objects of
``streams/zlike.py``.

``extract_streaming`` must write the JAX module's files (bytes, names,
times) on every folder shape, call ``progress`` with the same sequence and
stop with ``ProgressAborted`` at the same call.  ``LzmaDecodeStream``,
``Lzma2DecodeStream`` and ``XzDecodeStream`` fed in pieces of 1, 7 and
4,096 bytes must return the JAX objects' output at every call, with the
same ``eof`` and ``unused_data``; truncated and corrupt input must raise the
same error class; the port's ``engine="py"`` must equal its native engine.
"""

from __future__ import annotations

import importlib.util
import math
import os
import time

import pytest

from lzma_sdk_zliblike_tpu import api as JA
from lzma_sdk_zliblike_tpu.containers import sevenzip as JS
from lzma_sdk_zliblike_tpu.containers import xz as JX
from lzma_sdk_zliblike_tpu.engine import lzma_raw_encode
from lzma_sdk_zliblike_tpu.models.lzma.spec import LzmaProps as JProps
from lzma_sdk_zliblike_tpu.streams import extract7z as JE
from lzma_sdk_zliblike_tpu.streams import zlike as JZ
from lzma_sdk_zliblike_tpu_torch.containers import sevenzip as TS
from lzma_sdk_zliblike_tpu_torch.models.lzma.spec import LzmaProps
from lzma_sdk_zliblike_tpu_torch.streams import extract7z as TE
from lzma_sdk_zliblike_tpu_torch.streams import zlike as TZ
from lzma_sdk_zliblike_tpu_torch.streams.router import FileRouter
from lzma_sdk_zliblike_tpu_torch.utils.errors import (CrcError,
                                                      ProgressAborted,
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

FILES = {
    "docs/readme.txt": _C["text"][:20000],
    "src/main.c": _C["code"][:15000],
    "bin/app.exe": _C["x86"][:12000],
    "rep.bin": _C["repeat"][:9000],
    "empty.txt": b"",
    "deep/er/empty2": b"",
}
TICKS = (11644473600 + 1_600_000_000) * 10**7
MTIMES = {"docs/readme.txt": TICKS, "empty.txt": TICKS}

SHAPES = [
    ("copy", dict(method=TS.M_COPY)),
    ("lzma", dict(method=TS.M_LZMA)),
    ("lzma2", dict(method=TS.M_LZMA2)),
    ("lzma2-nonsolid", dict(method=TS.M_LZMA2, solid=False)),
    ("lzma2-bcj", dict(method=TS.M_LZMA2, pre_filter=TS.M_BCJ)),
    ("lzma-bcj2", dict(method=TS.M_LZMA, pre_filter=TS.M_BCJ2)),
    ("lzma2-bcj2", dict(method=TS.M_LZMA2, pre_filter=TS.M_BCJ2)),
    ("lzma2-enchdr", dict(method=TS.M_LZMA2, encode_header=True)),
    ("lzma2-delta", dict(method=TS.M_LZMA2, pre_filter=TS.M_DELTA)),
]
IDS = [s[0] for s in SHAPES]


def _archive(tmp_path, kw, name="a.7z"):
    p = tmp_path / name
    p.write_bytes(TS.write(FILES, dict_size=1 << 16, mtimes=MTIMES, **kw))
    return str(p)


def _tree(root):
    """{relative path: (bytes, whole seconds of mtime)} under ``root``; the
    mtime only for a file with a stored time (``MTIMES``), None for the
    rest, which keep the second their extraction wrote them in."""
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            rel = os.path.relpath(p, root).replace(os.sep, "/")
            out[rel] = (open(p, "rb").read(),
                        int(os.stat(p).st_mtime) if rel in MTIMES else None)
    return out


def _written_between(root, before: float, after: float) -> bool:
    """Every file under ``root`` without a stored time has an mtime between
    ``before`` (floored) and ``after`` (ceiled), clock reads around the
    extractions."""
    lo, hi = math.floor(before), math.ceil(after)
    return all(lo <= os.stat(os.path.join(d, n)).st_mtime <= hi
               for d, _dirs, names in os.walk(root) for n in names
               if os.path.relpath(os.path.join(d, n), root).replace(
                   os.sep, "/") not in MTIMES)


def _run(fn, *a, **kw):
    try:
        return fn(*a, **kw), None
    except Exception as e:          # the class name is what is compared
        return None, type(e).__name__


# ---------------------------------------------------------------------------
# extract_streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("desc,kw", SHAPES, ids=IDS)
def test_extract_streaming_matches_jax(tmp_path, desc, kw):
    path = _archive(tmp_path, kw)
    before = time.time()
    names = TE.extract_streaming(path, str(tmp_path / "t"))
    assert names == JE.extract_streaming(path, str(tmp_path / "j"))
    after = time.time()
    got = _tree(tmp_path / "t")
    assert got == _tree(tmp_path / "j")
    assert {k: v[0] for k, v in got.items()} == FILES
    assert got["docs/readme.txt"][1] == 1_600_000_000
    assert got["empty.txt"][1] == 1_600_000_000
    for side in "tj":
        assert _written_between(tmp_path / side, before, after)


def test_ppmd_folders_are_refused_by_both(tmp_path):
    """Neither package streams a PPMd folder (its codec is one call)."""
    path = _archive(tmp_path, dict(method=TS.M_PPMD))
    assert _run(TE.extract_streaming, path, str(tmp_path / "t"))[1] == \
        _run(JE.extract_streaming, path, str(tmp_path / "j"))[1] == \
        "UnsupportedError"


@pytest.mark.parametrize("desc,kw", [SHAPES[2], SHAPES[3], SHAPES[5]],
                         ids=["lzma2", "lzma2-nonsolid", "lzma-bcj2"])
def test_progress_sequence_matches_jax(tmp_path, desc, kw):
    path = _archive(tmp_path, kw)
    calls, jcalls = [], []
    TE.extract_streaming(path, str(tmp_path / "t"),
                         progress=lambda i, o: calls.append((i, o)))
    JE.extract_streaming(path, str(tmp_path / "j"),
                         progress=lambda i, o: jcalls.append((i, o)))
    assert calls == jcalls and calls
    assert calls[-1][1] == sum(len(b) for b in FILES.values())


@pytest.mark.parametrize("stop_at", [1, 3])
def test_abort_at_the_same_call(tmp_path, stop_at):
    path = _archive(tmp_path, dict(method=TS.M_LZMA2, solid=False))
    seen = {"t": 0, "j": 0}

    def progress(key):
        def cb(_i, _o):
            seen[key] += 1
            return seen[key] < stop_at
        return cb

    before = time.time()
    with pytest.raises(ProgressAborted):
        TE.extract_streaming(path, str(tmp_path / "t"),
                             progress=progress("t"))
    _res, err = _run(JE.extract_streaming, path, str(tmp_path / "j"),
                     progress=progress("j"))
    after = time.time()
    assert err == "ProgressAborted"
    assert seen["t"] == seen["j"] == stop_at
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    for side in "tj":
        assert _written_between(tmp_path / side, before, after)


@pytest.mark.parametrize("desc,kw", [SHAPES[0], SHAPES[2], SHAPES[4],
                                     SHAPES[5]],
                         ids=["copy", "lzma2", "lzma2-bcj", "lzma-bcj2"])
def test_corrupt_archive_raises_the_same_class(tmp_path, desc, kw):
    img = TS.write(FILES, dict_size=1 << 16, **kw)
    for pos in (40, len(img) // 3):
        bad = bytearray(img)
        bad[pos] ^= 0x55
        p = tmp_path / f"bad{pos}.7z"
        p.write_bytes(bytes(bad))
        got = _run(TE.extract_streaming, str(p), str(tmp_path / f"t{pos}"))
        want = _run(JE.extract_streaming, str(p), str(tmp_path / f"j{pos}"))
        assert got[1] is not None and got[1] == want[1], pos


def test_file_router_checks_crc(tmp_path):
    r = FileRouter([("a", 3, 0x352441C2), ("b", 2, 0)], str(tmp_path))
    with pytest.raises(CrcError):      # "abc" is right, "de" is not 0
        r.write(b"abcde")
    assert (tmp_path / "a").read_bytes() == b"abc"
    r = FileRouter([("c", 2, None)], str(tmp_path))
    r.write(b"x")
    with pytest.raises(ValueError):    # ended before the file's size
        r.close()


@pytest.mark.parametrize("method,props", [
    (TS.M_BCJ, b""), (TS.M_ARM, b""), (TS.M_ARMT, b""), (TS.M_PPC, b""),
    (TS.M_SPARC, b""), (TS.M_IA64, b""), (TS.M_DELTA, b"\x03")])
def test_streaming_branch_filter_matches_jax(method, props):
    data = _C["x86"][:20000] + _C["binary"][:7000]
    outs = []
    for mod in (TE, JE):
        got = []
        f = mod.StreamingBranchFilter(method, props, got.append)
        for i in range(0, len(data), 997):
            f.write(data[i:i + 997])
        f.close()
        outs.append(got)
    assert outs[0] == outs[1] and len(b"".join(outs[0])) == len(data)


# ---------------------------------------------------------------------------
# the zlib-like objects
# ---------------------------------------------------------------------------

DATA = (_C["text"] + _C["x86"] + _C["random"])[:30_000]


def _lzma_case(end_mark: bool):
    """(props bytes, stream, unpack_size) from the JAX encoder."""
    props = JProps(dict_size=1 << 16)
    stream = lzma_raw_encode(DATA, props, write_end_mark=end_mark)
    return props.to_bytes(), stream, None if end_mark else len(DATA)


def _feed(obj, stream, step, trailer=b""):
    """Per-call outputs of ``obj`` fed ``stream + trailer`` in ``step``
    pieces and flushed."""
    src = stream + trailer
    outs = [obj.decompress(src[i:i + step]) for i in range(0, len(src), step)]
    outs.append(obj.flush())
    return outs


def _objects(fmt, engine_t="auto", engine_j="auto"):
    if fmt in ("lzma", "lzma-endmark"):
        props, stream, size = _lzma_case(fmt == "lzma-endmark")
        return (TZ.LzmaDecodeStream(props, size, engine=engine_t),
                JZ.LzmaDecodeStream(props, size, engine=engine_j), stream)
    if fmt == "lzma2":
        # incompressible tail: copy chunks through the parser
        data = DATA + _C["random"][:20000]
        stream, prop = JA.lzma2_compress(data, dict_size=1 << 16,
                                         chunk_size=1 << 14)
        return (TZ.Lzma2DecodeStream(prop, engine=engine_t),
                JZ.Lzma2DecodeStream(prop, engine=engine_j), stream)
    img = JX.encode(DATA, dict_size=1 << 16, check="crc64", block_size=12000)
    return TZ.XzDecodeStream(), JZ.XzDecodeStream(), img


FORMATS = ["lzma", "lzma-endmark", "lzma2", "xz"]


@pytest.mark.parametrize("step", [1, 7, 4096])
@pytest.mark.parametrize("fmt", FORMATS)
def test_stream_objects_match_jax(fmt, step):
    t, j, stream = _objects(fmt)
    # xz: stream padding (bytes past it would start another stream)
    trailer = {"lzma": b"", "xz": bytes(8)}.get(fmt, b"TRAILING")
    outs, jouts = _feed(t, stream, step, trailer), _feed(j, stream, step,
                                                         trailer)
    assert outs == jouts
    assert b"".join(outs) == (DATA + _C["random"][:20000]
                              if fmt == "lzma2" else DATA)
    assert t.eof == j.eof is True
    assert t.unused_data == j.unused_data


@pytest.mark.parametrize("fmt", FORMATS)
def test_bounded_drains_match_jax(fmt):
    t, j, stream = _objects(fmt)
    got = []
    for obj in (t, j):
        outs = [obj.decompress(stream, max_length=777)]
        while outs[-1]:
            outs.append(obj.decompress(b"", max_length=777))
        outs.append(obj.flush())
        got.append(outs)
    assert got[0] == got[1]


@pytest.mark.parametrize("fmt", FORMATS)
def test_truncated_and_corrupt_raise_the_same_class(fmt):
    """Truncations must raise; a flipped byte in the first chunk need not
    (raw LZMA has no check), but both packages must agree."""
    _t, _j, stream = _objects(fmt)
    bad = bytearray(stream)
    bad[100] ^= 0x55
    for k, src in enumerate([stream[:len(stream) // 2], stream[:-3],
                             bytes(bad)]):
        errs = []
        for obj in _objects(fmt)[:2]:
            errs.append(_run(lambda: obj.decompress(src) + obj.flush())[1])
        assert errs[0] == errs[1], (k, errs)
        assert k == 2 or errs[0] is not None, (k, errs)


@pytest.mark.parametrize("step", [7, 4096])
@pytest.mark.parametrize("fmt", ["lzma", "lzma-endmark", "lzma2"])
def test_py_engine_equals_native(fmt, step):
    """The port's pure-Python engine returns what its native engine and
    the JAX package's Python engine return, call for call."""
    t_py, j_py, stream = _objects(fmt, "py", "py")
    t_nat = _objects(fmt)[0]
    trailer = b"" if fmt == "lzma" else b"xx"
    a = b"".join(_feed(t_py, stream, step, trailer))
    assert a == b"".join(_feed(j_py, stream, step, trailer))
    assert a == b"".join(_feed(t_nat, stream, step, trailer))
    assert t_py._nd is None and t_nat._nd is not None
    assert t_py.unused_data == t_nat.unused_data == j_py.unused_data


def test_decompressobj_factory_and_engines():
    props, stream, size = _lzma_case(False)
    d = TZ.decompressobj("lzma", props=props, unpack_size=size)
    assert d.decompress(stream) + d.flush() == DATA
    img = JX.encode(DATA, dict_size=1 << 16)
    d = TZ.decompressobj("xz")
    assert d.decompress(img) + d.flush() == DATA
    s2, prop = JA.lzma2_compress(DATA, dict_size=1 << 16)
    d = TZ.decompressobj("lzma2", dict_prop=prop, engine="native")
    assert d.decompress(s2) + d.flush() == DATA
    with pytest.raises(ValueError):
        TZ.decompressobj("nope")
    # pinned: the JAX objects run the native decoder for any engine name
    # but "py"; the port refuses a device name
    j = JZ.decompressobj("lzma2", dict_prop=prop, engine="tpu")
    assert j.decompress(s2) + j.flush() == DATA
    for engine in ("tpu", "device", "python"):
        with pytest.raises(UnsupportedError):
            TZ.decompressobj("lzma2", dict_prop=prop, engine=engine)
        with pytest.raises(UnsupportedError):
            TZ.LzmaDecodeStream(LzmaProps(dict_size=1 << 16), engine=engine)
