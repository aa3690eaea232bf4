"""The PyTorch/CUDA port's hybrid decode: host threads and K1 on one queue.

The JAX package's ``tests/test_hybrid.py``, ported: host-only runs
(``device=None``) against the JAX engine's output, the device feeder on the
plain K1 (``device="cpu"``) with host decode slowed so that the device wins
groups, progress and abort.  Then the port's guarantees one by one:
first-result-wins slots, steal-back of batches the card never finishes, a
corrupt group failing alone, a kernel fault raising, and the rate model.
"""

from __future__ import annotations

import importlib.util
import os
import threading
import time

import pytest

from lzma_sdk_zliblike_tpu.parallel.hybrid import \
    decode_lzma2_hybrid as jax_hybrid
import lzma_sdk_zliblike_tpu_torch as P
from lzma_sdk_zliblike_tpu_torch import native
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.parallel import hybrid as HY
from lzma_sdk_zliblike_tpu_torch.parallel.scheduler import (
    BatchedLzma2Decoder, BatchShape)
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


big_mixed = _corpus().big_mixed


def _mk_stream(n_groups=6, group=2048):
    data = big_mixed(n_groups * group)
    stream, prop = native.lzma2_encode(data, group, group)
    return data, stream, prop


def _slow_host(monkeypatch, delay: float = 0.0, log=None, gate=None):
    """Host decode that first waits for ``gate`` (a threading.Event set by
    the device side, so that the device wins groups whatever the machine's
    speed), then sleeps ``delay`` s and logs the group's first data offset."""
    real = HY.decode_group_native

    def slow(stream, group, prop):
        if gate is not None:
            assert gate.wait(60), "the device side never opened the gate"
        time.sleep(delay)
        if log is not None:
            log.append(group[0].data_off)
        return real(stream, group, prop)
    monkeypatch.setattr(HY, "decode_group_native", slow)


def _gate_after(monkeypatch, method: str, gate, wrap=None):
    """Set ``gate`` once BatchedLzma2Decoder.<method> has returned
    (its result passed through ``wrap`` first, if given)."""
    real = getattr(BatchedLzma2Decoder, method)

    def gated(self, *args):
        res = real(self, *args)
        if wrap is not None:
            res = wrap(args, res)
        gate.set()
        return res
    monkeypatch.setattr(BatchedLzma2Decoder, method, gated)


def _group_sizes(stream):
    return [sum(c.unpack_size for c in g)
            for g in F.split_groups(F.scan(stream)[0])]


@pytest.fixture(autouse=True)
def _cold_rates():
    HY._RATE_CACHE.clear()
    yield
    HY._RATE_CACHE.clear()


def test_hybrid_host_only_matches_reference_decode(monkeypatch):
    data, stream, prop = _mk_stream()

    def no_launch(*args, **kw):
        raise AssertionError("K1 ran with device=None")
    monkeypatch.setattr(G, "submit_groups", no_launch)
    out = P.decode_lzma2_hybrid(stream, prop, device=None)
    assert out == data == jax_hybrid(stream, prop, device=False)


def test_hybrid_host_only_single_thread_order():
    data, stream, prop = _mk_stream(n_groups=9)
    out = P.decode_lzma2_hybrid(stream, prop, device=None, threads=1)
    assert out == data == jax_hybrid(stream, prop, device=False, threads=1)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_hybrid_corrupt_group_fails_alone(device):
    data, stream, prop = _mk_stream()
    groups = F.split_groups(F.scan(stream)[0])
    bad = bytearray(stream)
    bad[groups[2][0].data_off + 9] ^= 0xFF
    with pytest.raises(P.DataError, match="group 2"):
        P.decode_lzma2_hybrid(bytes(bad), prop, device=device, threads=1)


def test_hybrid_with_interpret_device(monkeypatch):
    """Device feeder and host workers together: the feeder runs the plain
    K1 and wins groups while the host decode is slowed."""
    data, stream, prop = _mk_stream(n_groups=6, group=512)
    gate = threading.Event()
    _slow_host(monkeypatch, gate=gate)
    _gate_after(monkeypatch, "finalize_batch", gate)
    shape = BatchShape(n_lanes=2, pack_cap=4096, dic_cap=512,
                       groups_per_lane=1)
    TRACE.reset()
    out = P.decode_lzma2_hybrid(stream, prop, shape=shape, threads=1,
                                device="cpu")
    assert out == data == jax_hybrid(stream, prop, device=False)
    snap = TRACE.snapshot()
    assert snap["hybrid.dev_bytes"] > 0 and snap["hybrid.dev_batches"] > 0
    assert snap["hybrid.dev_bytes"] + snap["hybrid.host_bytes"] == len(data)
    assert snap.get("scheduler.lane_retries", 0) == 0


def test_hybrid_progress_reported_in_order():
    data, stream, prop = _mk_stream(n_groups=8)
    seen = []
    out = P.decode_lzma2_hybrid(stream, prop, device=None,
                                progress=lambda i, o: seen.append((i, o)))
    assert out == data
    assert len(seen) == 8
    assert all(a < b for a, b in zip(seen, seen[1:]))
    assert seen[-1][1] == len(data)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_hybrid_abort_poisons_all_engines(device):
    """Returning False from the callback mid-decode unwinds promptly with
    ProgressAborted: host workers stop at their next group boundary, the
    feeder submits nothing more, and no worker thread is left running."""
    data, stream, prop = _mk_stream(n_groups=32, group=4096)
    calls = []

    def cancel_after_3(i, o):
        calls.append((i, o))
        return len(calls) < 3

    t0 = time.monotonic()
    with pytest.raises(P.ProgressAborted):
        P.decode_lzma2_hybrid(stream, prop, device=device, threads=2,
                              progress=cancel_after_3)
    assert time.monotonic() - t0 < 30
    # at most one straggler claim per worker thread after the abort
    assert len(calls) <= 3 + 2
    assert not [t for t in threading.enumerate()
                if "host_worker" in t.name and t.is_alive()]


def test_api_hybrid_progress_routes_to_hybrid_engine(monkeypatch):
    data, stream, prop = _mk_stream(n_groups=4)
    calls = []
    real = HY.decode_lzma2_hybrid

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(HY, "decode_lzma2_hybrid", spy)
    seen = []
    out = P.lzma2_uncompress(stream, prop, engine="hybrid", device="cpu",
                             progress=lambda i, o: seen.append(o))
    assert out == data and seen and seen[-1] == len(data)
    assert len(calls) == 1 and calls[0]["device"] == "cpu"


def test_first_result_wins(monkeypatch):
    """A device batch finishes after the host has taken some of its groups
    back: every group's slot keeps the first result written, whichever
    engine wrote it, and each engine is credited only with what it won.
    The device's results are marked (every byte 0xD7) to tell them apart."""
    data, stream, prop = _mk_stream(n_groups=5, group=1024)
    host_log: list[int] = []
    submitted = threading.Event()
    _slow_host(monkeypatch, 0.05, host_log, gate=submitted)
    batches: dict[int, set] = {}
    _gate_after(monkeypatch, "submit_batch", submitted, wrap=lambda args, h:
                batches.setdefault(id(h), {g[0].data_off for g in args[1]})
                and h)
    # a batch is done once the host has taken one of its groups back
    t0 = time.monotonic()
    monkeypatch.setattr(G, "batch_done", lambda h: bool(
        batches[id(h)] & set(host_log)) or time.monotonic() - t0 > 30)

    def marked(self, handle, groups):
        return [b"\xd7" * sum(c.unpack_size for c in g) for g in groups]
    monkeypatch.setattr(BatchedLzma2Decoder, "finalize_batch", marked)
    TRACE.reset()
    out = P.decode_lzma2_hybrid(stream, prop, threads=1, device="cpu")
    snap = TRACE.snapshot()
    host_won = dev_won = off = 0
    for n in _group_sizes(stream):
        part = out[off:off + n]
        if part == data[off:off + n]:
            host_won += n
        else:
            assert part == b"\xd7" * n
            dev_won += n
        off += n
    assert off == len(out) == len(data)
    assert host_won > 0 and dev_won > 0
    assert (snap["hybrid.host_bytes"], snap["hybrid.dev_bytes"]) == \
        (host_won, dev_won)
    assert snap["hybrid.steals"] > 0 and snap["hybrid.dev_batches"] == 1


def test_steal_back_when_the_card_never_finishes(monkeypatch):
    """Batches whose event never fires: the hosts take every group back,
    newest batch first, the feeder drops its batches without copying them,
    and the call returns the right bytes."""
    data, stream, prop = _mk_stream(n_groups=12, group=1024)
    _slow_host(monkeypatch, 0.05)
    monkeypatch.setattr(G, "batch_done", lambda h: False)

    def no_copy(*args, **kw):
        raise AssertionError("a batch that never finished was copied")
    monkeypatch.setattr(G, "finalize_chunks", no_copy)
    TRACE.reset()
    out = P.decode_lzma2_hybrid(stream, prop, threads=2, device="cpu")
    assert out == data
    snap = TRACE.snapshot()
    assert snap["hybrid.steals"] > 0
    assert snap["hybrid.dev_bytes"] == 0
    assert snap["hybrid.host_bytes"] == len(data)
    assert snap.get("hybrid.dev_batches", 0) == 0
    assert snap.get("hybrid.dev_batches_discarded", 0) + \
        snap.get("hybrid.feeder_abandoned", 0) > 0


def test_failed_lane_that_the_host_decodes_raises(monkeypatch):
    """A lane the card fails on a group the host reference decodes is a
    kernel fault: the call raises instead of keeping the host's bytes."""
    data, stream, prop = _mk_stream(n_groups=6, group=1024)
    gate = threading.Event()
    _slow_host(monkeypatch, gate=gate)
    _gate_after(monkeypatch, "finalize_batch", gate,
                wrap=lambda args, outs: [None] + outs[1:])
    with pytest.raises(RuntimeError, match="kernel disagrees"):
        P.decode_lzma2_hybrid(stream, prop, threads=1, device="cpu")


def test_rate_model(monkeypatch):
    """With a cached fast per-lane rate the first batch is no 4-lane probe,
    and the rate the call measures is cached for the next."""
    data, stream, prop = _mk_stream(n_groups=48, group=512)
    groups = F.split_groups(F.scan(stream)[0])
    from lzma_sdk_zliblike_tpu_torch.utils.memory import shape_for_groups
    shape = shape_for_groups(groups, device="cpu")
    key = ("cpu", shape.dic_cap, shape.pack_cap)
    sizes = []
    gate = threading.Event()
    _slow_host(monkeypatch, gate=gate)
    _gate_after(monkeypatch, "submit_batch", gate,
                wrap=lambda args, h: sizes.append(len(args[1])) or h)
    HY._RATE_CACHE[key] = (1e9, 1.0)
    assert P.decode_lzma2_hybrid(stream, prop, threads=2,
                                 device="cpu") == data
    assert sizes[0] > HY.PROBE_LANES
    proc, lane_s = HY._RATE_CACHE[key]
    assert proc > 0 and lane_s > 0 and proc / lane_s < 1e9


def test_device_batch_size():
    """The card's drain rate is its per-lane rate times the lanes a batch
    holds: a 1 MiB group takes 0.19 s on a lane, 5.5 MB/s, so a batch of
    128 lanes drains 705 MB/s against one host thread's 60 MB/s and takes
    92% of the queue (a 4-lane probe's own rate, 22 MB/s, would give 27%).
    It abstains when a batch cannot end before the hosts drain the rest."""
    mib, per_lane = 1 << 20, (1 << 20) / 0.19
    assert HY.device_batch_size(120, 120 * mib, None, 0.0, 128) == 4
    assert HY.device_batch_size(120, 120 * mib, None, 0.0, 2) == 2
    assert HY.device_batch_size(120, 120 * mib, per_lane, 60e6, 128) == \
        int(120 * per_lane * 128 / (per_lane * 128 + 60e6)) == 110
    # hosts not timed yet: a fifth of the queue
    assert HY.device_batch_size(120, 120 * mib, per_lane, 0.0, 128) == 24
    assert HY.device_batch_size(400, 400 * mib, per_lane, 60e6, 128) == 128
    # eight hosts at 480 MB/s drain 20 MiB in 0.044 s: no batch ends first
    assert HY.device_batch_size(20, 20 * mib, per_lane, 480e6, 128) == 0
    assert HY.device_batch_size(3, 3 * mib, 1e9, 480e6, 128) == 4


@pytest.mark.cuda
def test_hybrid_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    data, stream, prop = _mk_stream(n_groups=12, group=4096)
    G.launches = 0
    TRACE.reset()
    assert P.decode_lzma2_hybrid(stream, prop, threads=1) == data
    snap = TRACE.snapshot()
    assert G.launches > 0 and snap.get("scheduler.lane_retries", 0) == 0
    assert snap["hybrid.dev_bytes"] + snap["hybrid.host_bytes"] == len(data)
