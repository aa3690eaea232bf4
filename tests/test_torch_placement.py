"""The device engine's copy out: every group written at its offset in the
call's one result ``bytes`` (``BatchedLzma2Decoder.decode_into``,
``group_decode.finalize_chunks(result=, placements=)``).

Each case decodes through ``lzma2_uncompress(engine="device")`` on the CPU
(the plain version; rows placed straight into the result) and on the card
(the staged copy through the reused pinned pieces), and holds the result to
stdlib ``lzma``'s output, or to the original bytes where liblzma refuses
the stream.  No JAX here, so the card's cases run beside the CPU's.
"""

from __future__ import annotations

import hashlib
import importlib.util
import lzma
import os
import random

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu_torch import api, native
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.parallel import scheduler
from lzma_sdk_zliblike_tpu_torch.utils import memory as M
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

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name: str) -> str:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return name


def _block(data: bytes, dict_size=1 << 16, **opts) -> bytes:
    """``data`` as one liblzma dict-reset group, without the end byte."""
    return lzma.compress(data, format=lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "preset": 6, "dict_size": dict_size,
         **opts}])[:-1]


def _stream(blocks) -> bytes:
    return b"".join(blocks) + b"\x00"


def _stdlib(stream: bytes, prop: int) -> bytes:
    return lzma.decompress(stream, format=lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "dict_size": F.decode_dict_prop(prop)}])


PROP = F.encode_dict_prop(1 << 16)


def _groups(stream: bytes):
    return F.split_groups(F.scan(stream)[0])


def _fail_first_batch_lane(monkeypatch, lane: int) -> None:
    """The first batch waited on reports lane ``lane`` failed (a device
    fault on a stream the reference decodes)."""
    wait, seen = G.wait_batch, []

    def failing_wait(handle):
        wait(handle)
        if not seen:
            seen.append(handle)
            handle.status[0, lane] = 0
            if handle.status.is_cuda:
                torch.cuda.synchronize()
    monkeypatch.setattr(G, "wait_batch", failing_wait)


def _many_groups(monkeypatch):
    parts = [big_mixed(1000 + 50 * i, seed=40 + i) for i in range(7)]
    stream = _stream(_block(p) for p in parts)
    shape = M.shape_for_groups(_groups(stream), device="cpu")
    monkeypatch.setenv("LZT_HBM_BUDGET", str(M.decode_batch_hbm_bytes(
        2, shape.pack_cap, shape.dic_cap)))
    return stream, {"scheduler.pallas_batches": 4}


def _multi_k_shape(monkeypatch):
    """Several groups a lane: ``shape_for_groups`` gives two lanes of up
    to four groups, so six groups go three a lane."""
    shape_for = M.shape_for_groups

    def two_lanes(groups, **kw):
        s = shape_for(groups, **kw)
        return scheduler.BatchShape(n_lanes=2, pack_cap=s.pack_cap,
                                    dic_cap=s.dic_cap, groups_per_lane=4)
    monkeypatch.setattr(M, "shape_for_groups", two_lanes)


def _multi_group_lanes(monkeypatch):
    _multi_k_shape(monkeypatch)
    parts = [big_mixed(900 + 70 * i, seed=60 + i) for i in range(6)]
    return _stream(_block(p) for p in parts), \
        {"scheduler.pallas_multi_batches": 1}


def _failed_multi_group_lane(monkeypatch):
    _multi_k_shape(monkeypatch)
    _fail_first_batch_lane(monkeypatch, 0)
    parts = [big_mixed(900 + 70 * i, seed=70 + i) for i in range(6)]
    return _stream(_block(p) for p in parts), \
        {"scheduler.pallas_multi_batches": 1, "scheduler.pallas_batches": 2,
         "scheduler.lane_retries": 1}


def _copy_only_groups(monkeypatch):
    stream = _stream([_block(big_mixed(3000, seed=90)),
                      _block(random_bytes(5000, seed=91)),
                      _block(big_mixed(2000, seed=92))])
    assert any(all(not c.is_lzma for c in g) for g in _groups(stream))
    return stream, {"scheduler.pallas_batches": 1}


def _lc_lp_above_4(monkeypatch):
    """liblzma refuses lc + lp > 4: the port's encoder writes the stream,
    and the result is held to its input."""
    data = big_mixed(3000, seed=50)
    stream, prop = native.lzma2_encode(data, 1 << 16, 1024, lc=4, lp=1,
                                       pb=2)
    return (stream, prop, data), {"scheduler.host_fallback_groups": 3}


def _over_limit_group(monkeypatch):
    monkeypatch.setattr(G, "CAP_LIMIT", 8192)
    parts = [big_mixed(n, seed=80 + i)
             for i, n in enumerate((3000, 12000, 2500, 4000))]
    return _stream(_block(p) for p in parts), \
        {"scheduler.host_fallback_groups": 1}


def _two_props(monkeypatch):
    parts = [big_mixed(900, seed=s) for s in (33, 34, 35)]
    opts = [{}, {"lc": 1}, {"lc": 0, "lp": 4, "pb": 0}]
    return _stream(_block(p, **o) for p, o in zip(parts, opts)), \
        {"scheduler.pallas_batches": 3}


def _short_last_group(monkeypatch):
    parts = [big_mixed(4096, seed=100), big_mixed(4096, seed=101),
             big_mixed(1000, seed=102)]
    return _stream(_block(p) for p in parts), {"scheduler.pallas_batches": 1}


def _empty(monkeypatch):
    return b"\x00", {}


def _small_pieces(monkeypatch):
    """Pieces of 4 KiB: lanes, groups and the status rows cross piece
    boundaries on the card (the CPU places rows directly)."""
    monkeypatch.setattr(G, "PIECE", 4096)
    parts = [big_mixed(n, seed=110 + i)
             for i, n in enumerate((3000, 9000, 4096, 5000, 700))]
    return _stream(_block(p) for p in parts), {"scheduler.pallas_batches": 1}


CASES = {"several_batches": _many_groups,
         "multi_group_lanes": _multi_group_lanes,
         "failed_multi_group_lane": _failed_multi_group_lane,
         "copy_only_groups": _copy_only_groups,
         "lc_lp_above_4": _lc_lp_above_4,
         "over_limit_group": _over_limit_group,
         "two_props": _two_props,
         "short_last_group": _short_last_group,
         "empty_stream": _empty,
         "small_pieces": _small_pieces}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_result_is_one_bytes_equal_to_stdlib(case, device, monkeypatch):
    device = _device(device)
    made, counts = CASES[case](monkeypatch)
    if isinstance(made, tuple):
        stream, prop, expected = made
    else:
        stream, prop = made, PROP
        expected = _stdlib(stream, prop)
    calls = []
    finalize = G.finalize_chunks

    def spy(*args, **kw):
        calls.append((len(args), sorted(kw)))
        return finalize(*args, **kw)
    monkeypatch.setattr(G, "finalize_chunks", spy)
    TRACE.reset()
    out = api.lzma2_uncompress(stream, prop, engine="device", device=device)
    assert type(out) is bytes
    assert out == expected
    snap = TRACE.snapshot()
    for name, n in counts.items():
        assert snap.get(name, 0) == n, name
    batches = snap.get("scheduler.pallas_batches", 0) + \
        snap.get("scheduler.pallas_multi_batches", 0)
    assert calls == [(1, ["dic_cap", "placements", "result"])] * batches


@pytest.mark.parametrize("device", DEVICES)
def test_a_held_result_is_not_the_reused_pieces(device, monkeypatch):
    """Call 1's result is unchanged after call 2 decodes another stream
    through the same pieces (small ones, so both calls fill them many
    times)."""
    device = _device(device)
    monkeypatch.setattr(G, "PIECE", 4096)
    one = _stream(_block(big_mixed(6000 + 500 * i, seed=120 + i))
                  for i in range(3))
    two = _stream(_block(random_bytes(300, seed=130) + big_mixed(
        7000, seed=131 + i)) for i in range(3))
    first = api.lzma2_uncompress(one, PROP, device=device)
    digest = hashlib.sha256(first).digest()
    second = api.lzma2_uncompress(two, PROP, device=device)
    assert second == _stdlib(two, PROP)
    assert hashlib.sha256(first).digest() == digest
    assert first == _stdlib(one, PROP)


@pytest.mark.parametrize("device", DEVICES)
def test_staged_bytes_are_the_device_groups_bytes(device):
    """``group_decode.d2h_staged_bytes`` counts every byte of the card's
    groups on the card (not the copy-only group's), and nothing on the
    CPU, where no pinned piece is made."""
    device = _device(device)
    stream = _stream([_block(big_mixed(3000, seed=140)),
                      _block(random_bytes(5000, seed=141)),
                      _block(big_mixed(2000, seed=142))])
    groups = _groups(stream)
    on_card = sum(c.unpack_size for g in groups if any(c.is_lzma for c in g)
                  for c in g)
    assert 0 < on_card < sum(c.unpack_size for g in groups for c in g)
    staging = dict(G._STAGING)
    TRACE.reset()
    assert api.lzma2_uncompress(stream, PROP, device=device) == \
        _stdlib(stream, PROP)
    staged = TRACE.snapshot().get("group_decode.d2h_staged_bytes", 0)
    if device == "cpu":
        assert staged == 0 and G._STAGING == staging
    else:
        assert staged == on_card


@pytest.mark.cuda
def test_pinned_memory_held_is_two_pieces():
    """However large the stream, a card's staging holds two pinned pieces
    of ``PIECE`` bytes between calls."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    data = big_mixed(3 * G.PIECE, seed=150)
    stream, prop = native.lzma2_encode(data, 1 << 20, 1 << 20)
    assert api.lzma2_uncompress(stream, prop) == data
    staging = G._STAGING[torch.cuda.current_device()]
    assert [(h.numel(), h.is_pinned()) for h in staging.host] == \
        [(G.PIECE, True)] * 2


def test_piece_plan_places_what_direct_placement_does():
    """The staged copy's plan, played with numpy copies on the CPU: pieces
    filled back to back, segments cut at pieces' ends, runs merged where
    the source or the destination is contiguous, every byte placed once."""
    rng = random.Random(7)
    src = np.frombuffer(rng.randbytes(1 << 16), np.uint8)
    for piece in (1, 7, 4096, 1 << 20):
        segments, at, dst_at = [], 0, []
        for _ in range(40):
            at += rng.choice((0, 0, rng.randrange(300)))
            n = rng.randrange(1, 900)
            segments.append((at, n))
            at += n
        order = list(range(len(segments)))
        rng.shuffle(order)
        total, placed = 0, [None] * len(segments)
        for i in order:
            placed[i] = total
            total += segments[i][1]
        segments = [(s, n, placed[i]) for i, (s, n) in enumerate(segments)]
        want = np.zeros(total, np.uint8)
        for s, n, d in segments:
            want[d:d + n] = src[s:s + n]
        got = np.full(total, 0xAA, np.uint8)
        pieces = G._piece_plan(segments, piece)
        assert sum(p[2] for parts in pieces for p in parts) == total
        for parts in pieces:
            assert sum(p[2] for p in parts) <= piece
            buf = np.zeros(piece, np.uint8)
            for s, off, n in G._runs(parts, 0):
                buf[off:off + n] = src[s:s + n]
            for d, off, n in G._runs(parts, 3):
                got[d:d + n] = buf[off:off + n]
        assert np.array_equal(got, want), piece
        if piece == 1 << 20:
            assert len(pieces) == 1


@pytest.mark.parametrize("device", DEVICES)
def test_per_group_contracts_keep_their_bytes(device):
    """``finalize_batch`` (the hybrid engine's) and ``_outputs`` still give
    each group's own ``bytes``; ``finalize_chunks`` without the keywords
    gives the whole rows, and ``decode_groups`` each group's bytes."""
    device = _device(device)
    parts = [big_mixed(1200 + 300 * i, seed=160 + i) for i in range(4)]
    stream = _stream(_block(p) for p in parts)
    groups = _groups(stream)
    dec = scheduler.BatchedLzma2Decoder(
        M.shape_for_groups(groups, device=device), device=device)
    handle = dec.submit_batch(stream, groups, (3, 0, 2))
    assert dec.finalize_batch(handle, groups) == parts
    handle = dec.submit_batch(stream, groups, (3, 0, 2))
    outs = dec._outputs(handle, [[g] for g in groups], 1)
    assert [type(p) for (p,) in outs] == [bytes] * 4
    assert [p for (p,) in outs] == parts
    handle = dec.submit_batch(stream, groups, (3, 0, 2))
    G.wait_batch(handle)
    out, ok, consumed = G.finalize_chunks(handle, dic_cap=dec.shape.dic_cap)
    assert out.device.type == "cpu" and tuple(out.shape) == \
        (4, dec.shape.dic_cap) and bool(ok.all())
    assert [bytes(out[i, :len(p)].numpy()) for i, p in enumerate(parts)] == \
        parts
    assert consumed.tolist() == [sum(c.pack_size for c in g) for g in groups]
    got = dec.decode_groups(stream, groups)
    assert [type(p) for p in got] == [bytes] * 4 and got == parts


def test_placements_outside_a_row_raise():
    parts = [big_mixed(1000, seed=170), big_mixed(800, seed=171)]
    stream = _stream(_block(p) for p in parts)
    groups = _groups(stream)
    dec = scheduler.BatchedLzma2Decoder(
        M.shape_for_groups(groups, device="cpu"), device="cpu")
    result = np.zeros(1800, np.uint8)
    for bad in ([[(0, 1000, 0)], [(-1, 10, 1000)]],
                [[(0, dec.shape.dic_cap + 1, 0)], []],
                [[], [], [], [(0, 1, 0)]]):
        handle = dec.submit_batch(stream, groups, (3, 0, 2))
        with pytest.raises(ValueError):
            G.finalize_chunks(handle, dic_cap=dec.shape.dic_cap,
                              result=result, placements=bad)
    handle = dec.submit_batch(stream, groups, (3, 0, 2))
    ok, consumed = G.finalize_chunks(
        handle, dic_cap=dec.shape.dic_cap, result=result,
        placements=[[(0, 1000, 800)], [(0, 800, 0)]])
    assert bool(ok.all()) and bytes(result) == parts[1] + parts[0]
    with pytest.raises(ValueError, match="a result of 5 bytes"):
        dec.decode_into(stream, groups, np.zeros(5, np.uint8))


def test_result_bytes_is_a_fresh_writable_bytes():
    out, view = M.result_bytes(5)
    assert type(out) is bytes and len(out) == 5 and view.flags.writeable
    view[:] = np.frombuffer(b"hello", np.uint8)
    assert out == b"hello"
    again, view2 = M.result_bytes(5)
    view2[:] = 0
    assert again is not out and out == b"hello"
    del out
    assert bytes(view) == b"hello"     # the view keeps its bytes alive
    assert M.result_bytes(0)[0] == b""
    with pytest.raises(ValueError):
        M.result_bytes(-1)
