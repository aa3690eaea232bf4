"""The PyTorch/CUDA port's LZMA2 decode path against the JAX package.

Framing (scan, split_groups, dict props), the batch budget and
``lzma2_uncompress(device="cpu")`` are held against the JAX package's copies
on the same streams, exactly.  The port must not import JAX or the JAX
package.
"""

from __future__ import annotations

import ast
import importlib.util
import lzma
import os
import re
import subprocess
import sys

import pytest
import torch

import lzma_sdk_zliblike_tpu as jlzt
from lzma_sdk_zliblike_tpu.models.lzma2 import framing as JF
from lzma_sdk_zliblike_tpu.utils import memory as JM
from lzma_sdk_zliblike_tpu.utils.errors import LzmaError as JLzmaError
import lzma_sdk_zliblike_tpu_torch as P
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.utils import memory as M
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
PORT = os.path.join(REPO, "lzma_sdk_zliblike_tpu_torch")


def _stdlib_stream(parts, dict_size=1 << 16, **opts):
    """One liblzma-compressed dict-reset group per part, as one stream."""
    groups = []
    for p in parts:
        c = lzma.compress(p, format=lzma.FORMAT_RAW, filters=[
            {"id": lzma.FILTER_LZMA2, "preset": 6, "dict_size": dict_size,
             **opts}])
        groups.append(c[:-1])
    return b"".join(groups) + b"\x00", F.encode_dict_prop(dict_size)


@pytest.fixture(scope="module")
def streams():
    data = big_mixed(2500, seed=21) + random_bytes(1200, seed=5) \
        + big_mixed(900, seed=22)
    js, jp = JF.encode(data, dict_size=4096, chunk_size=1024)
    parts = [big_mixed(1500, seed=s) for s in (1, 2, 3)]
    ss, sp = _stdlib_stream(parts)
    ns, np_ = _stdlib_stream([big_mixed(1200, seed=8)], lc=1, lp=2, pb=0)
    return {"jax_encoder": (js, jp, data),
            "liblzma": (ss, sp, b"".join(parts)),
            "lc1_lp2_pb0": (ns, np_, big_mixed(1200, seed=8))}


def _chunk_fields(c):
    props = None if c.props is None else (c.props.lc, c.props.lp,
                                          c.props.pb, c.props.dict_size)
    return (c.is_lzma, c.mode, c.reset_dic, c.unpack_size, c.pack_size,
            props, c.data_off, c.unpack_off)


@pytest.mark.parametrize("name", ["jax_encoder", "liblzma", "lc1_lp2_pb0"])
def test_framing_matches_jax(streams, name):
    stream = streams[name][0]
    chunks, end = F.scan(stream)
    jchunks, jend = JF.scan(stream)
    assert end == jend
    assert [_chunk_fields(c) for c in chunks] == \
        [_chunk_fields(c) for c in jchunks]
    assert [len(g) for g in F.split_groups(chunks)] == \
        [len(g) for g in JF.split_groups(jchunks)]
    for g, jg in zip(F.split_groups(chunks), JF.split_groups(jchunks)):
        assert F.decode_chunks(stream, g) == JF.decode_chunks(stream, jg)
    assert _raised(F.scan, stream[:-1]) == _raised(JF.scan, stream[:-1]) \
        == "InputEofError"


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # the two packages have their own classes
        return type(e).__name__
    return None


def test_dict_props_match_jax():
    for k in range(41):
        assert F.decode_dict_prop(k) == JF.decode_dict_prop(k)
    for size in (1, 4096, 5000, 1 << 20, 3 << 22, 1 << 31, 0xFFFFFFFF):
        assert F.encode_dict_prop(size) == JF.encode_dict_prop(size)
    with pytest.raises(P.ParamError):
        F.decode_dict_prop(41)


@pytest.mark.parametrize("name", ["jax_encoder", "liblzma", "lc1_lp2_pb0"])
def test_lzma2_uncompress_cpu_matches_jax(streams, name):
    stream, prop, data = streams[name]
    TRACE.reset()
    out = P.lzma2_uncompress(stream, prop, device="cpu")
    assert out == jlzt.lzma2_uncompress(stream, prop) == data
    snap = TRACE.snapshot()
    assert snap.get("scheduler.host_fallback_groups", 0) == 0
    assert snap.get("scheduler.lane_retries", 0) == 0
    assert snap.get("scheduler.pallas_batches", 0) == 1


def test_corrupt_group_raises_data_error(streams):
    stream, prop, _ = streams["liblzma"]
    groups = F.split_groups(F.scan(stream)[0])
    c = groups[1][0]
    bad = bytearray(stream)
    bad[c.data_off + c.pack_size // 2] ^= 0x5A
    with pytest.raises(JLzmaError):
        jlzt.lzma2_uncompress(bytes(bad), prop)
    TRACE.reset()
    with pytest.raises(P.DataError, match="group 1"):
        P.lzma2_uncompress(bytes(bad), prop, device="cpu")
    assert TRACE.snapshot().get("scheduler.lane_retries", 0) == 1


def test_mismatched_props_group_decodes_on_host():
    """A group whose lc/lp/pb change mid-group goes to the host decoder (a
    lane holds one model), and the stream still matches the JAX package."""
    a = big_mixed(896, seed=31)[:-1] + b"\n"
    b = big_mixed(700, seed=32)
    s1, prop = _stdlib_stream([a])
    s2, _ = _stdlib_stream([b], lc=1)
    # b's first chunk keeps its props reset but not its dict reset; a is
    # 16-byte sized and ends below 0x80, so b decodes to the same bytes
    assert (s2[0] >> 5) & 3 == F.MODE_STATE_PROPS_DIC
    stream = s1[:-1] + bytes([s2[0] & 0xDF]) + s2[1:]
    assert len(F.split_groups(F.scan(stream)[0])) == 1
    TRACE.reset()
    assert P.lzma2_uncompress(stream, prop, device="cpu") == a + b == \
        jlzt.lzma2_uncompress(stream, prop)
    assert TRACE.snapshot().get("scheduler.host_fallback_groups", 0) == 1


def test_props_above_lc_lp_4_decode_on_host(monkeypatch):
    """LZMA2 forbids lc + lp > 4 and liblzma refuses such props, but the
    JAX package's framing accepts them and decodes such groups on the host.
    So does the port: it never hands them to K1, whose model is sized for
    lc + lp <= 4, and ``submit_groups`` itself raises ParamError for them.
    The stream comes from the port's own native encoder."""
    from lzma_sdk_zliblike_tpu_torch import native
    data = big_mixed(3000, seed=50)
    stream, prop = native.lzma2_encode(data, 1 << 16, 1024, lc=4, lp=1, pb=2)
    groups = F.split_groups(F.scan(stream)[0])
    jgroups = JF.split_groups(JF.scan(stream)[0])
    assert len(groups) == 3
    assert {(c.props.lc, c.props.lp) for g in groups for c in g
            if c.props is not None} == {(4, 1)}
    for g, jg in zip(groups, jgroups):
        assert F.decode_chunks(stream, g) == JF.decode_chunks(stream, jg)

    def no_launch(*args, **kw):
        raise AssertionError("a group with lc + lp > 4 reached K1")
    monkeypatch.setattr(G, "submit_groups", no_launch)
    TRACE.reset()
    assert P.lzma2_uncompress(stream, prop, device="cpu") == data == \
        jlzt.lzma2_uncompress(stream, prop)
    assert TRACE.snapshot().get("scheduler.host_fallback_groups", 0) == 3
    monkeypatch.undo()
    one = torch.ones(1, 1, dtype=torch.int32)
    with pytest.raises(P.ParamError, match="lc \\+ lp <= 4"):
        G.submit_groups(torch.zeros(1, 8, dtype=torch.uint8), one, one, one,
                        torch.ones(1, dtype=torch.int32), dic_cap=8, lc=4,
                        lp=1)


def test_groups_of_other_props_decode_in_their_own_batches():
    """Groups whose lc/lp/pb differ run on the device, one launch per
    props, and the stream still matches the JAX package."""
    parts = [big_mixed(900, seed=s) for s in (33, 34, 35, 36)]
    opts = [{}, {"lc": 1}, {"lc": 0, "lp": 4, "pb": 0}, {}]
    streams = [_stdlib_stream([p], **o) for p, o in zip(parts, opts)]
    stream = b"".join(s[:-1] for s, _ in streams) + b"\x00"
    prop = streams[0][1]
    TRACE.reset()
    assert P.lzma2_uncompress(stream, prop, device="cpu") == \
        b"".join(parts) == jlzt.lzma2_uncompress(stream, prop)
    snap = TRACE.snapshot()
    assert snap.get("scheduler.host_fallback_groups", 0) == 0
    assert snap.get("scheduler.pallas_batches", 0) == 3


def test_no_card_raises(streams, monkeypatch):
    stream, prop, _ = streams["liblzma"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(P.UnsupportedError):
        P.lzma2_uncompress(stream, prop)


def test_progress_routes_to_host_mt(streams, monkeypatch):
    """With the device engine a progress callback sends the call to the
    host MT decoder, as the JAX package routes it: no K1 batch runs, the
    callback sees every group in order, and False aborts."""
    from lzma_sdk_zliblike_tpu_torch.parallel import host_pool
    stream, prop, data = streams["liblzma"]
    calls = []
    real = host_pool.decode_lzma2_mt

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(host_pool, "decode_lzma2_mt", spy)
    seen = []
    TRACE.reset()
    assert P.lzma2_uncompress(stream, prop, device="cpu", threads=2,
                              progress=lambda i, o: seen.append(o)) == data
    assert len(calls) == 1 and calls[0]["threads"] == 2
    assert seen == sorted(seen) and seen[-1] == len(data) and len(seen) == 3
    assert "scheduler.pallas_batches" not in TRACE.snapshot()
    with pytest.raises(P.ProgressAborted):
        P.lzma2_uncompress(stream, prop, device="cpu",
                           progress=lambda i, o: False)


def _launcher_limit(source: str, function: str, arg: str) -> int:
    """The bound ``arg >= (1ll << N)`` that ``function`` in ``source``
    refuses, as 2**N."""
    with open(os.path.join(PORT, "csrc", source)) as f:
        text = f.read()
    body = text[text.index(f"int {function}("):]
    return 1 << int(re.search(rf"{arg} >= \(1ll << (\d+)\)", body).group(1))


def test_launcher_limits_match_the_sources():
    from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
    assert G.CAP_LIMIT == _launcher_limit(
        "group_decode.cu", "lzt_group_decode", "pack_cap") == \
        _launcher_limit("group_decode.cu", "lzt_group_decode", "dic_cap")
    assert R.OP_CAP_LIMIT == _launcher_limit(
        "range_encode.cu", "lzt_range_encode", "op_cap")
    assert R.OUT_CAP_LIMIT == _launcher_limit(
        "range_encode.cu", "lzt_range_encode", "out_cap")


def test_over_limit_group_decodes_on_host(monkeypatch):
    """A group the K1 launcher would refuse (here under a limit lowered to
    8 KiB) decodes on the host with the native decoder and is counted;
    the batch shape is sized from the other groups, and no launch sees a
    row at the limit.  The output equals the JAX package's."""
    from lzma_sdk_zliblike_tpu_torch.parallel import scheduler
    parts = [big_mixed(n, seed=80 + i)
             for i, n in enumerate((3000, 12000, 2500, 4000))]
    stream, prop = _stdlib_stream(parts)
    groups = F.split_groups(F.scan(stream)[0])
    assert M.shape_for_groups(groups, device="cpu").dic_cap == 12288
    monkeypatch.setattr(G, "CAP_LIMIT", 8192)
    assert [M.fits_launcher(g) for g in groups] == [True, False, True, True]
    shape = M.shape_for_groups(groups, device="cpu")
    assert (shape.dic_cap, shape.n_lanes) == (4096, 3)
    assert shape.pack_cap == 4096
    rows, host = [], []
    submit, native_decode = G.submit_groups, scheduler.decode_group_native

    def checking_submit(src, *args, dic_cap, **kw):
        rows.append((src.shape[1], dic_cap))
        return submit(src, *args, dic_cap=dic_cap, **kw)

    def spy(stream_, group, prop_):
        host.append(sum(c.unpack_size for c in group))
        return native_decode(stream_, group, prop_)
    monkeypatch.setattr(G, "submit_groups", checking_submit)
    monkeypatch.setattr(scheduler, "decode_group_native", spy)
    TRACE.reset()
    assert P.lzma2_uncompress(stream, prop, device="cpu") == \
        b"".join(parts) == jlzt.lzma2_uncompress(stream, prop)
    assert TRACE.snapshot()["scheduler.host_fallback_groups"] == 1
    assert host == [12000]
    assert rows and all(max(r) < 8192 for r in rows)
    # a shape that allows several groups a lane keeps each row below it
    dec = scheduler.BatchedLzma2Decoder(
        scheduler.BatchShape(n_lanes=1, pack_cap=4096, dic_cap=4096,
                             groups_per_lane=4), device="cpu")
    assert dec._multi_k(3) == 1


def test_batch_budget(streams, monkeypatch):
    stream = streams["jax_encoder"][0]
    groups = F.split_groups(F.scan(stream)[0])
    n_lzma = sum(1 for g in groups if any(c.is_lzma for c in g))
    shape = M.shape_for_groups(groups, device="cpu")
    jshape = JM.shape_for_groups(groups)
    assert (shape.pack_cap, shape.dic_cap) == (jshape.pack_cap,
                                               jshape.dic_cap)
    assert shape.n_lanes == n_lzma
    per_lane = M.decode_batch_hbm_bytes(1, shape.pack_cap, shape.dic_cap)
    assert per_lane == JM.decode_batch_hbm_bytes(1, shape.pack_cap,
                                                 shape.dic_cap)
    assert M.shape_for_groups(groups, device="cpu",
                              hbm_budget=2 * per_lane).n_lanes == 2
    monkeypatch.setenv("LZT_HBM_BUDGET", str(per_lane))
    assert M.shape_for_groups(groups, device="cpu").n_lanes == 1
    assert M.pick_lanes(4096, 4096, hbm_budget=1) == 1


def test_budget_bounds_batches_on_device(monkeypatch):
    """Under a budget of a few lanes the stream is split into batches, at
    most INFLIGHT of them live at once, each within its share."""
    parts = [big_mixed(1000 + 50 * i, seed=40 + i) for i in range(7)]
    stream, prop = _stdlib_stream(parts)
    groups = F.split_groups(F.scan(stream)[0])
    shape = M.shape_for_groups(groups, device="cpu")
    budget = M.decode_batch_hbm_bytes(2, shape.pack_cap, shape.dic_cap)
    monkeypatch.setenv("LZT_HBM_BUDGET", str(budget))
    live, most, sizes = [0], [0], []
    submit, finalize = G.submit_groups, G.finalize_chunks

    def counting_submit(src, *args, dic_cap, **kw):
        live[0] += 1
        most[0] = max(most[0], live[0])
        sizes.append(src.numel() + src.shape[0] * dic_cap)
        return submit(src, *args, dic_cap=dic_cap, **kw)

    def counting_finalize(handle, **kw):
        live[0] -= 1
        return finalize(handle, **kw)
    monkeypatch.setattr(G, "submit_groups", counting_submit)
    monkeypatch.setattr(G, "finalize_chunks", counting_finalize)
    TRACE.reset()
    assert P.lzma2_uncompress(stream, prop, device="cpu") == b"".join(parts)
    assert len(sizes) == TRACE.snapshot()["scheduler.pallas_batches"] == 4
    assert most[0] == M.INFLIGHT and live[0] == 0
    assert max(sizes) * M.INFLIGHT <= budget


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lzma_sdk_zliblike_tpu"), \
                (path, mod)
    code = (
        "import pkgutil, sys\n"
        "import lzma_sdk_zliblike_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lzma_sdk_zliblike_tpu')]\n"
        "assert not bad, bad\n"
        "print('CLEAN', len([m for m in sys.modules "
        "if m.startswith('lzma_sdk_zliblike_tpu_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CLEAN" in r.stdout


@pytest.mark.cuda
def test_lzma2_uncompress_on_card(streams):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for stream, prop, data in streams.values():
        G.launches = 0
        TRACE.reset()
        assert P.lzma2_uncompress(stream, prop) == data
        assert G.launches > 0
        assert TRACE.snapshot().get("scheduler.lane_retries", 0) == 0
