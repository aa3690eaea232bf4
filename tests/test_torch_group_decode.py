"""Kernel K1 of the PyTorch/CUDA port (``ops/group_decode.py``) against the
JAX package.

The same batches, made from ``tests/corpus.py`` and the JAX package's own
encoders, go through the JAX package's plain reference
(``framing.decode_chunks`` / ``decoder_ref``) and through the port: its plain
version on the CPU, the CPU build of the kernel's own source
(``csrc/cpu_harness.cc``) and, on a card, the CUDA kernel.  All comparisons
are exact: bytes equal, ok equal, consumed equal where ok.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import random

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu.models.lzma.encoder_ref import LzmaEncoder
from lzma_sdk_zliblike_tpu.models.lzma.spec import LzmaProps
from lzma_sdk_zliblike_tpu.models.lzma2 import framing as JF
from lzma_sdk_zliblike_tpu.utils.errors import LzmaError as JLzmaError
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.parallel.scheduler import (
    BatchedLzma2Decoder, BatchShape)
from lzma_sdk_zliblike_tpu_torch.utils.errors import DataError, ParamError
from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
CAP = 384


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _lanes_batch(stream, lane_lists, pack_cap, dic_cap):
    """The port scheduler's assembly of lanes that hold lists of groups."""
    k = max(len(lane) for lane in lane_lists)
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=len(lane_lists),
                                         pack_cap=pack_cap, dic_cap=dic_cap),
                              device="cpu")
    return _t(*dec._assemble(stream, lane_lists, k)), k * dic_cap


def _reference(stream, lane_lists):
    """Per lane: (ok, bytes) from the JAX package's scalar decoder."""
    res = []
    for lane in lane_lists:
        out, good = b"", True
        for g in lane:
            jg = JF.split_groups(JF.scan(stream)[0])[_group_index(stream, g)]
            try:
                out += JF.decode_chunks(stream, jg)
            except JLzmaError:
                good = False
        res.append((good, out))
    return res


def _group_index(stream, group):
    starts = [g[0].data_off for g in F.split_groups(F.scan(stream)[0])]
    return starts.index(group[0].data_off)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_chunk():
    """8 lanes of single-chunk groups (the JAX kernel test's INNER batch)."""
    data = (big_mixed(CAP * 40) + b"A" * 700 + bytes(range(7)) * 300
            + random_bytes(CAP * 4, seed=3))
    stream, _ = JF.encode(data, dict_size=4096, chunk_size=CAP)
    groups = JF.split_groups(JF.scan(stream)[0])
    lz = [g for g in groups if len(g) == 1 and g[0].is_lzma]
    assert len(lz) >= 8
    sel = lz[:8]
    src = np.zeros((8, CAP + 64), np.uint8)
    pack = np.zeros(8, np.int32)
    unpack = np.zeros(8, np.int32)
    for i, g in enumerate(sel):
        c = g[0]
        src[i, :c.pack_size] = np.frombuffer(stream, np.uint8, c.pack_size,
                                             c.data_off)
        pack[i], unpack[i] = c.pack_size, c.unpack_size
    exp = [JF.decode_chunks(stream, g) for g in sel]
    return src, pack, unpack, exp


@pytest.fixture(scope="module")
def multi_chunk():
    """One group of 4 state-carrying chunks with a mid-group state reset,
    built with the JAX package's scalar encoder (as its kernel test does);
    lane 1 is the same group corrupted inside chunk 2."""
    props = LzmaProps(lc=3, lp=0, pb=2, dict_size=4096)
    gdata = big_mixed(1408) + b"B" * 128
    segs = [(0, 384), (384, 768), (768, 1152), (1152, 1536)]
    enc = LzmaEncoder(props)
    mc = bytearray()
    pe, ue, fl, bodies = [], [], [], bytearray()
    for i, (a, b) in enumerate(segs):
        if i == 0:
            mode = JF.MODE_STATE_PROPS_DIC
        elif i == 2:
            enc.reset_state()
            mode = JF.MODE_STATE
        else:
            mode = JF.MODE_NOTHING
        body = enc.encode_segment(gdata, a, b, dic_start=0)
        mc += JF._chunk_header(True, mode, b - a, len(body), props, i == 0)
        mc += body
        bodies += body
        pe.append(len(bodies))
        ue.append(b)
        fl.append(1 | (2 if (i > 0 and mode >= JF.MODE_STATE) else 0))
    mc.append(JF.CTRL_EOS)
    src = np.zeros((8, 2048), np.uint8)
    src[0, :len(bodies)] = np.frombuffer(bytes(bodies), np.uint8)
    src[1, :len(bodies)] = np.frombuffer(bytes(bodies), np.uint8)
    src[1, pe[1] + 3] ^= 0xFF
    tables = [np.zeros((8, 4), np.int32) for _ in range(3)]
    for t, v in zip(tables, (pe, ue, fl)):
        t[:2] = v
    act = np.zeros(8, np.int32)
    act[:2] = 1
    return bytes(mc), gdata, (src, *tables, act), len(bodies)


@pytest.fixture(scope="module")
def many_chunks():
    """One dict-reset group of more than 128 chunks (32-byte sub-chunks,
    LZMA and copy chunks)."""
    data = big_mixed(4800, seed=11)
    stream, prop = JF.encode(data, dict_size=4096, chunk_size=32,
                             parallel_groups=False)
    groups = F.split_groups(F.scan(stream)[0])
    assert len(groups) == 1 and len(groups[0]) > 128
    return stream, prop, data


@pytest.fixture(scope="module")
def fuzz_batches():
    """Random lanes of one or more groups, some bytes flipped (seeded)."""
    rng = random.Random(1234)
    out = []
    for trial in range(3):
        chunk = rng.choice([256, 512])
        data = (big_mixed(rng.randint(1500, 3000), seed=trial)
                + random_bytes(rng.randint(0, 400), seed=trial))
        stream, _ = JF.encode(data, dict_size=4096, chunk_size=chunk)
        groups = F.split_groups(F.scan(stream)[0])
        lanes = [groups[i::4] for i in range(4)]
        bad = bytearray(stream)
        for lane in lanes[:2]:
            c = rng.choice(rng.choice(lane))
            bad[c.data_off + rng.randrange(c.pack_size)] ^= 1 << rng.randrange(8)
        bad = bytes(bad)
        pack_cap = max(sum(c.pack_size for c in g) for g in groups) + 8
        dic_cap = max(sum(c.unpack_size for c in g) for g in groups)
        out.append((bad, lanes, *_lanes_batch(bad, lanes, pack_cap, dic_cap)))
    return out


def _all_batches(single_chunk, multi_chunk, many_chunks, fuzz_batches):
    """(tensors, dic_cap) of every batch above, for the kernel comparisons."""
    src, pack, unpack, _ = single_chunk
    bad = src.copy()
    bad[3, 7] ^= 0xFF
    one = np.ones(8, np.int32)
    yield _t(bad, pack[:, None], unpack[:, None], one[:, None], one), CAP
    yield _t(*multi_chunk[2]), 1536
    stream, _, data = many_chunks
    g = F.split_groups(F.scan(stream)[0])
    yield _lanes_batch(stream, [g, g], 4096, len(data))
    for _stream, _lanes, tensors, dic_cap in fuzz_batches:
        yield tensors, dic_cap


# ---------------------------------------------------------------------------
# the plain version against the JAX package's reference
# ---------------------------------------------------------------------------

def test_single_chunk_lanes_match_reference(single_chunk):
    src, pack, unpack, exp = single_chunk
    out, ok, consumed = G.decode_chunks(*_t(src, pack, unpack,
                                            np.ones(8, np.int32)),
                                        dic_cap=CAP)
    assert ok.all(), ok
    assert (consumed.numpy() == pack).all()
    for i in range(8):
        assert out[i, :unpack[i]].numpy().tobytes() == exp[i], i


def test_corrupt_lane_fails_alone(single_chunk):
    src, pack, unpack, exp = single_chunk
    bad = src.copy()
    bad[3, 7] ^= 0xFF
    out, ok, consumed = G.decode_chunks(*_t(bad, pack, unpack,
                                            np.ones(8, np.int32)),
                                        dic_cap=CAP)
    assert not ok[3]
    for i in range(8):
        if i != 3:
            assert ok[i] and int(consumed[i]) == pack[i]
            assert out[i, :unpack[i]].numpy().tobytes() == exp[i], i


def test_multi_chunk_group_with_state_reset(multi_chunk):
    mstream, gdata, tables, n_body = multi_chunk
    assert JF.decode_chunks(mstream, JF.scan(mstream)[0]) == gdata
    out, ok, consumed = G.finalize_chunks(
        G.submit_groups(*_t(*tables), dic_cap=1536), dic_cap=1536)
    assert bool(ok[0]) and not bool(ok[1]), ok
    assert ok[2:].all()                       # inactive lanes report ok
    assert int(consumed[0]) == n_body
    assert out[0].numpy().tobytes() == gdata
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=8, pack_cap=2048,
                                         dic_cap=2048), device="cpu")
    assert dec.decode(mstream, 0) == gdata


def test_copy_chunks_decode_in_kernel():
    data = (big_mixed(CAP * 3) + random_bytes(CAP * 4, seed=9)
            + big_mixed(CAP * 3, seed=5))
    stream, prop = JF.encode(data, dict_size=16384, chunk_size=CAP,
                             parallel_groups=False)
    groups = F.split_groups(F.scan(stream)[0])
    dec = BatchedLzma2Decoder(
        BatchShape(n_lanes=2, pack_cap=len(stream), dic_cap=len(data)),
        device="cpu")
    mixed = [g for g in groups if any(c.is_lzma for c in g)
             and any(not c.is_lzma for c in g) and dec._eligible(g)]
    assert mixed
    TRACE.reset()
    assert dec.decode(stream, prop) == data == JF.decode(stream, prop)
    assert TRACE.snapshot().get("scheduler.host_fallback_groups", 0) == 0


def test_group_over_128_chunks(many_chunks):
    stream, prop, data = many_chunks
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=2, pack_cap=4096,
                                         dic_cap=len(data)), device="cpu")
    TRACE.reset()
    assert dec.decode(stream, prop) == data
    snap = TRACE.snapshot()
    assert snap.get("scheduler.host_fallback_groups", 0) == 0
    assert snap.get("scheduler.lane_retries", 0) == 0
    assert JF.decode_chunks(stream, JF.scan(stream)[0]) == data


def test_multi_group_lanes():
    """Several dict-reset groups per lane (flags bit3) decode exactly, and a
    corrupt group still fails alone: the host retry raises for it."""
    chunk = 512
    data = (big_mixed(17 * chunk) + random_bytes(chunk, seed=4)
            + big_mixed(2 * chunk, seed=7))
    stream, prop = JF.encode(data, dict_size=chunk, chunk_size=chunk)
    groups = F.split_groups(F.scan(stream)[0])
    assert len(groups) > 8
    dec = BatchedLzma2Decoder(
        BatchShape(n_lanes=8, pack_cap=chunk + 256, dic_cap=chunk),
        device="cpu")
    device_idx = [i for i, g in enumerate(groups)
                  if any(c.is_lzma for c in g)]
    assert dec._multi_k(len(device_idx)) > 1
    TRACE.reset()
    assert dec.decode(stream, prop) == data
    assert TRACE.snapshot().get("scheduler.pallas_multi_batches", 0) > 0
    bad = bytearray(stream)
    g3 = groups[3][0]
    bad[g3.data_off + g3.pack_size // 2] ^= 0x55
    with pytest.raises(DataError, match="group 3"):
        dec.decode(bytes(bad), prop)


def _failing_plain(monkeypatch, lanes_to_fail, calls):
    """group_decode_plain that reports ok=0 on the given lanes of its first
    call only (a device fault on a stream the reference decodes)."""
    plain = G.group_decode_plain

    def fake(*args):
        out, ok, consumed = plain(*args)
        calls.append(args[0].shape[0])
        if len(calls) == 1:
            ok = ok.clone()
            ok[lanes_to_fail] = 0
        return out, ok, consumed
    monkeypatch.setattr(G, "group_decode_plain", fake)


def test_failed_multi_group_lane_relaunches_its_groups(monkeypatch):
    """A failed lane of several groups goes back to the device, one group
    per lane, not to the host decoder."""
    data = big_mixed(6 * 512, seed=13)
    stream, prop = JF.encode(data, dict_size=512, chunk_size=512)
    groups = F.split_groups(F.scan(stream)[0])
    assert len(groups) == 6
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=3, pack_cap=768,
                                         dic_cap=512), device="cpu")
    calls = []
    _failing_plain(monkeypatch, [1], calls)
    TRACE.reset()
    assert dec.decode(stream, prop) == data
    assert calls == [3, 2]          # the failed lane's two groups, again
    snap = TRACE.snapshot()
    assert snap.get("scheduler.lane_retries", 0) == 1
    assert snap.get("scheduler.pallas_multi_batches", 0) == 1
    assert snap.get("scheduler.pallas_batches", 0) == 1
    assert snap.get("scheduler.host_fallback_groups", 0) == 0


def test_device_reference_disagreement_raises(monkeypatch):
    """A one-group lane that the device fails but the host reference
    decodes is a fault of the kernel: it raises, it is not papered over."""
    data = big_mixed(3 * 512, seed=14)
    stream, prop = JF.encode(data, dict_size=512, chunk_size=512)
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=3, pack_cap=768,
                                         dic_cap=512), device="cpu")
    _failing_plain(monkeypatch, [0], [])
    with pytest.raises(RuntimeError, match="disagrees with the reference"):
        dec.decode(stream, prop)


def test_fuzzed_lanes_match_reference(fuzz_batches):
    for stream, lanes, tensors, dic_cap in fuzz_batches:
        out, ok, consumed = G.group_decode_plain(*tensors, dic_cap)
        pe = tensors[1]
        for li, (good, exp) in enumerate(_reference(stream, lanes)):
            assert bool(ok[li]) == good, li
            if good:
                assert out[li, :len(exp)].numpy().tobytes() == exp
                assert int(consumed[li]) == int(pe[li, -1])


def test_from_jax_batch():
    """The JAX package's own kernel batch (``_prep_groups``) carried across
    with ``from_jax_batch`` decodes to the JAX reference's bytes."""
    from lzma_sdk_zliblike_tpu.ops import pallas_decode as P
    from lzma_sdk_zliblike_tpu.parallel.scheduler import (
        BatchedLzma2Decoder as JDecoder, BatchShape as JShape)
    data = big_mixed(2400, seed=3) + random_bytes(300, seed=2)
    stream, _ = JF.encode(data, dict_size=4096, chunk_size=700)
    groups = JF.split_groups(JF.scan(stream)[0])
    jdec = JDecoder(JShape(n_lanes=len(groups) + 1, pack_cap=1024,
                           dic_cap=1024), engine="pallas")
    src, pe, ue, fl, act, _ = jdec._assemble(stream, groups,
                                             len(groups) + 1)
    meta, words, _ = P._prep_groups(src, pe, ue, fl, act, dic_cap=1024)
    tensors = G.from_jax_batch(meta, words)
    assert tensors[1].shape[1] == max(len(g) for g in groups)
    assert (tensors[0][:, :1024].numpy() == src).all()
    out, ok, consumed = G.group_decode_plain(*tensors, 1024)
    assert ok.all() and int(ok[-1]) == 1       # the spare lane is inactive
    for li, g in enumerate(groups):
        exp = JF.decode_chunks(stream, g)
        assert out[li, :len(exp)].numpy().tobytes() == exp
        assert int(consumed[li]) == sum(c.pack_size for c in g)


def test_input_checks(single_chunk):
    src, pack, unpack, _ = single_chunk
    args = _t(src, pack[:, None], unpack[:, None], np.ones((8, 1), np.int32),
              np.ones(8, np.int32))
    with pytest.raises(TypeError):
        G.submit_groups(args[0].int(), *args[1:], dic_cap=CAP)
    with pytest.raises(ValueError):
        G.submit_groups(*args[:4], args[4][:4], dic_cap=CAP)
    with pytest.raises(ValueError):
        G.submit_groups(args[0][:, ::2], *args[1:], dic_cap=CAP)
    with pytest.raises(ParamError):
        G.submit_groups(*args, dic_cap=CAP, lc=4, lp=1)


# ---------------------------------------------------------------------------
# the kernel's own source, built for the CPU, against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_harness():
    """csrc/cpu_harness.cc (the kernel's per-lane code, lzma_lane.cuh) built
    with g++ into build/ (tests/torch_cpu_harness.py)."""
    spec = importlib.util.spec_from_file_location(
        "lzt_torch_cpu_harness", os.path.join(REPO, "tests",
                                              "torch_cpu_harness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.build()
    if lib is None:
        pytest.skip("g++ not available")
    fn = lib.lzt_group_decode_cpu
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4)

    def run(src, pe, ue, fl, act, dic_cap, lc=3, lp=0, pb=2):
        n = src.shape[0]
        out = torch.zeros((n, dic_cap), dtype=torch.uint8)
        status = torch.zeros((3, n), dtype=torch.int32)
        assert fn(src.data_ptr(), src.shape[1], pe.data_ptr(), ue.data_ptr(),
                  fl.data_ptr(), pe.shape[1], act.data_ptr(), out.data_ptr(),
                  dic_cap, status[0].data_ptr(), status[1].data_ptr(),
                  status[2].data_ptr(), n, lc, lp, pb) == 0
        return out, status[0], status[1]
    return run


def test_cpu_harness_matches_plain(cpu_harness, single_chunk, multi_chunk,
                                   many_chunks, fuzz_batches):
    n = 0
    for tensors, dic_cap in _all_batches(single_chunk, multi_chunk,
                                         many_chunks, fuzz_batches):
        plain = G.group_decode_plain(*tensors, dic_cap)
        harness = cpu_harness(*tensors, dic_cap)
        for a, b in zip(plain, harness):
            assert torch.equal(a, b)
        n += 1
    assert n == 6


# ---------------------------------------------------------------------------
# the CUDA kernel (on a card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_matches_plain_on_card(single_chunk, multi_chunk, many_chunks,
                                      fuzz_batches):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    G.launches = 0
    n = 0
    for tensors, dic_cap in _all_batches(single_chunk, multi_chunk,
                                         many_chunks, fuzz_batches):
        plain = G.group_decode_plain(*tensors, dic_cap)
        h = G.submit_groups(*[t.cuda() for t in tensors], dic_cap=dic_cap)
        torch.cuda.synchronize()
        for a, b in zip(plain, (h.out, h.ok, h.consumed)):
            assert torch.equal(a, b.cpu())
        n += 1
    assert G.launches == n == 6


# ---------------------------------------------------------------------------
# the JAX kernel itself (interpret mode: compiles for minutes)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_jax_kernel_interpret_matches_plain(multi_chunk):
    from lzma_sdk_zliblike_tpu.ops import pallas_decode as P
    _, gdata, tables, _ = multi_chunk
    jout, jok, jcons = P.finalize_chunks(
        P.submit_groups(*tables, dic_cap=1536, interpret=True), dic_cap=1536)
    out, ok, consumed = G.group_decode_plain(*_t(*tables), 1536)
    assert (ok.numpy() != 0).tolist() == np.asarray(jok).tolist()
    assert out[0].numpy().tobytes() == np.asarray(jout)[0].tobytes() == gdata
    assert int(consumed[0]) == int(jcons[0])
