"""The PyTorch/CUDA port's device-coded LZMA2 encode against the JAX package.

``encode_lzma2_device_coded(device="cpu")`` (the range-encode kernel's plain
version) must give the same stream, byte for byte, as the JAX package's
``host_pool.encode_lzma2_mt`` and the port's own, and the stream must decode
with Python's ``lzma`` and with the port's decoder.  The host encoder, the
batch budget, copy-chunk groups and kernel faults are held here too.
"""

from __future__ import annotations

import importlib.util
import lzma
import os

import pytest
import torch

from lzma_sdk_zliblike_tpu import native as JN
from lzma_sdk_zliblike_tpu.parallel.host_pool import \
    encode_lzma2_mt as jax_encode_mt
import lzma_sdk_zliblike_tpu_torch as P
from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
from lzma_sdk_zliblike_tpu_torch.parallel import device_encode as DE
from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import encode_lzma2_mt
from lzma_sdk_zliblike_tpu_torch.utils import memory as M
from lzma_sdk_zliblike_tpu_torch.utils.errors import ProgressAborted
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


def _raw_decode(stream, dict_size):
    return lzma.decompress(stream, format=lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "dict_size": dict_size}])


def _copy_chunk_groups(data, chunk_size, dict_size):
    """Groups the JAX package's native parse frames with copy chunks."""
    n = 0
    for a in range(0, len(data), chunk_size):
        _o, tab, _b = JN.lzma2_group_ops(data[a:a + chunk_size], dict_size,
                                         sub_size=min(48 << 10, chunk_size))
        n += DE.needs_copy_chunks(tab)
    return n


@pytest.fixture(scope="module")
def mixed():
    """The JAX package's device-coded test input (test_pallas_encoder.py),
    encoded once by the port on the CPU."""
    data = big_mixed(60_000, seed=13) + random_bytes(12_000, seed=1) \
        + big_mixed(30_000, seed=14)
    TRACE.reset()
    stream, prop = P.encode_lzma2_device_coded(
        data, dict_size=1 << 16, chunk_size=1 << 13, device="cpu")
    return data, stream, prop, TRACE.snapshot()


def test_device_coded_matches_host_mt(mixed):
    data, stream, prop, snap = mixed
    ref, prop_r = jax_encode_mt(data, dict_size=1 << 16, chunk_size=1 << 13)
    own, prop_o = encode_lzma2_mt(data, dict_size=1 << 16, chunk_size=1 << 13)
    assert stream == ref == own
    assert prop == prop_r == prop_o
    assert snap["device_encode.host_groups"] == _copy_chunk_groups(
        data, 1 << 13, 1 << 16)
    assert snap["device_encode.batches"] == 1


def test_device_coded_stream_decodes(mixed):
    data, stream, prop, _ = mixed
    assert _raw_decode(stream, 1 << 16) == data
    assert P.lzma2_uncompress(stream, prop, device="cpu") == data


def test_random_groups_go_to_the_host():
    """Groups of random bytes need copy chunks, which only the host encoder
    writes: they are counted in ``host_groups`` and the stream is still the
    host encoder's."""
    data = big_mixed(3_000, seed=15) + random_bytes(6_000, seed=16) \
        + big_mixed(2_000, seed=17)
    TRACE.reset()
    stream, prop = P.encode_lzma2_device_coded(
        data, dict_size=1 << 16, chunk_size=1 << 11, device="cpu")
    host = _copy_chunk_groups(data, 1 << 11, 1 << 16)
    assert host >= 2
    snap = TRACE.snapshot()
    assert snap["device_encode.host_groups"] == host
    assert snap["device_encode.batches"] == 1
    assert stream == jax_encode_mt(data, dict_size=1 << 16,
                                   chunk_size=1 << 11)[0]
    assert _raw_decode(stream, 1 << 16) == data


def test_empty_input():
    assert P.encode_lzma2_device_coded(b"", device="cpu") == \
        (b"\x00", jax_encode_mt(b"", dict_size=1 << 20,
                                chunk_size=1 << 20)[1])
    assert encode_lzma2_mt(b"", dict_size=1 << 20, chunk_size=1 << 20)[0] \
        == b"\x00"


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(P.UnsupportedError):
        P.encode_lzma2_device_coded(b"abc" * 100)


def test_failed_lane_raises(monkeypatch):
    """A lane the kernel reports not ok is a kernel fault: the call raises,
    the group is not re-encoded on the host."""
    plain = R.range_encode_plain

    def failing(*args):
        bodies, tab, status = plain(*args)
        status = status.clone()
        status[0, 1] = 0
        status[2, 1] = R.ERR_OVERFLOW
        return bodies, tab, status
    monkeypatch.setattr(R, "range_encode_plain", failing)
    with pytest.raises(RuntimeError, match="group 1 .*err 3"):
        P.encode_lzma2_device_coded(big_mixed(4_000, seed=18),
                                    dict_size=1 << 16, chunk_size=1 << 11,
                                    device="cpu")


def test_bodies_that_differ_from_the_parse_raise(monkeypatch):
    """A lane the kernel reports ok whose bodies differ from the native
    bodies of the parse is a kernel fault too."""
    plain = R.range_encode_plain

    def corrupting(*args):
        bodies, tab, status = plain(*args)
        bodies = bodies.clone()
        bodies[1, 3] ^= 0x40
        return bodies, tab, status
    monkeypatch.setattr(R, "range_encode_plain", corrupting)
    with pytest.raises(RuntimeError, match="group 1 differ"):
        P.encode_lzma2_device_coded(big_mixed(4_000, seed=18),
                                    dict_size=1 << 16, chunk_size=1 << 11,
                                    device="cpu")


def test_trace_counts_the_kernels_work(mixed):
    """The trace of one call holds the steps and the bytes the kernel reads
    and writes, as the native parse of the same groups gives them."""
    data, _, _, snap = mixed
    chunk, dict_size = 1 << 13, 1 << 16
    parsed = [JN.lzma2_group_ops(data[a:a + chunk], dict_size,
                                 sub_size=chunk)
              for a in range(0, len(data), chunk)]
    dev = [p for p in parsed if not DE.needs_copy_chunks(p[1])]
    lanes, n_chunks = len(dev), max(len(p[1]) for p in dev)
    assert snap["device_encode.lanes"] == lanes
    assert lanes + snap["device_encode.host_groups"] == len(parsed)
    assert snap["device_encode.ops_per_lane_max"] == max(
        len(p[0]) for p in dev) // 2
    assert snap["device_encode.kernel_bytes_read"] == 4 * (
        sum(len(p[0]) for p in dev) + lanes * n_chunks + lanes)
    assert snap["range_encode.bytes_written"] == sum(
        len(p[2]) for p in dev) + 4 * (lanes * n_chunks + 3 * lanes)
    for name in ("device_encode.parse", "device_encode.pack_and_host_to_device",
                 "range_encode.device_to_host"):
        assert snap[name]["count"] == 1
    assert snap["device_encode.frame_and_join"]["count"] == 2
    assert "range_encode.kernel_ms" not in snap       # no launch on the CPU
    TRACE.peak("test.peak", 3)
    TRACE.peak("test.peak", 2)
    assert TRACE.snapshot()["test.peak"] == 3


def test_budget_bounds_batches_on_device(monkeypatch):
    """Under a budget of two lanes the groups go in several batches, at most
    INFLIGHT of them live at once, each within its share; progress is
    called after each batch."""
    data = big_mixed(5 * 2048 - 300, seed=19)
    chunk = 2048
    ops_max = max(len(JN.lzma2_group_ops(data[a:a + chunk], 1 << 16)[0])
                  for a in range(0, len(data), chunk))
    budget = M.encode_batch_bytes(2, ops_max, R.out_cap_for(chunk))
    monkeypatch.setenv("LZT_HBM_BUDGET", str(budget))
    live, most, sizes, calls = [0], [0], [], []
    submit, finalize = R.submit_encode_groups, R.finalize_encode

    def counting_submit(ops, op_ends, active, *, out_cap, **kw):
        live[0] += 1
        most[0] = max(most[0], live[0])
        sizes.append(ops.numel() * 4 + ops.shape[0] * out_cap)
        return submit(ops, op_ends, active, out_cap=out_cap, **kw)

    def counting_finalize(handle, nch):
        live[0] -= 1
        return finalize(handle, nch)
    monkeypatch.setattr(R, "submit_encode_groups", counting_submit)
    monkeypatch.setattr(R, "finalize_encode", counting_finalize)
    TRACE.reset()
    stream, _ = P.encode_lzma2_device_coded(
        data, dict_size=1 << 16, chunk_size=chunk, device="cpu",
        progress=lambda i, o: calls.append((i, o)))
    assert stream == encode_lzma2_mt(data, dict_size=1 << 16,
                                     chunk_size=chunk)[0]
    assert len(sizes) == TRACE.snapshot()["device_encode.batches"] == 3
    assert most[0] == M.INFLIGHT and live[0] == 0
    assert max(sizes) * M.INFLIGHT <= budget
    assert [i for i, _ in calls] == [2 * chunk, 4 * chunk, len(data)]
    assert calls[-1][1] == len(stream) - 1


def test_encode_batch_budget():
    assert M.encode_batch_bytes(3, 100, 5000) == 3 * (400 + 5000) * M.INFLIGHT
    per_lane = M.encode_batch_bytes(1, 100, 5000)
    assert M.encode_lanes(8, 100, 5000, hbm_budget=3 * per_lane) == 3
    assert M.encode_lanes(2, 100, 5000, hbm_budget=3 * per_lane) == 2
    assert M.encode_lanes(8, 100, 5000, hbm_budget=1) == 1


@pytest.mark.parametrize("props", [(3, 0, 2), (0, 4, 0), (1, 2, 1)])
def test_host_mt_matches_jax(props):
    lc, lp, pb = props
    data = big_mixed(40_000, seed=20) + random_bytes(3_000, seed=21)
    for threads in (1, 3):
        own = encode_lzma2_mt(data, dict_size=1 << 16, chunk_size=1 << 14,
                              threads=threads, lc=lc, lp=lp, pb=pb)
        assert own == jax_encode_mt(data, dict_size=1 << 16,
                                    chunk_size=1 << 14, threads=threads,
                                    lc=lc, lp=lp, pb=pb)


def test_host_mt_progress_abort():
    data = big_mixed(20_000, seed=22)
    with pytest.raises(ProgressAborted):
        encode_lzma2_mt(data, dict_size=1 << 16, chunk_size=1 << 12,
                        progress=lambda i, o: False)


def test_frame_group_refuses_a_body_that_does_not_compress():
    with pytest.raises(RuntimeError, match="disagrees"):
        DE.frame_group([bytes(100)], 0, 100, 1 << 12, 93)


@pytest.mark.cuda
def test_device_coded_on_card(mixed):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    data, stream, prop, _ = mixed
    R.launches = 0
    assert P.encode_lzma2_device_coded(
        data, dict_size=1 << 16, chunk_size=1 << 13) == (stream, prop)
    assert R.launches == 1
