"""The PyTorch/CUDA port's hybrid encode: host cores and K2 on one queue.

``encode_lzma2_hybrid(device="cpu")`` (K2's plain version on the feeder)
must give the stream of ``encode_lzma2_mt``, the JAX package's and the
port's, byte for byte, at every thread and lane count tested, with the
feeder coding at least one batch: host workers wait on an event the feeder
sets once it has taken its first batch, so the card's side wins groups
whatever the machine's load.  Then the port's departures from the JAX
engine: copy-chunk groups go back to the hosts, kernel faults raise, no
thread outlives the call, the batch width is capped by the device budget,
and the feeder runs where the JAX engine's abstains.
"""

from __future__ import annotations

import importlib.util
import os
import threading

import pytest
import torch

from lzma_sdk_zliblike_tpu.ops import pallas_encode as JPE
from lzma_sdk_zliblike_tpu.parallel import device_encode as JDE
from lzma_sdk_zliblike_tpu.parallel.host_pool import \
    encode_lzma2_mt as jax_encode_mt
import lzma_sdk_zliblike_tpu_torch as P
from lzma_sdk_zliblike_tpu_torch import native
from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
from lzma_sdk_zliblike_tpu_torch.parallel import device_encode as DE
from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import encode_lzma2_mt
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
CHUNK, DICT = 2048, 1 << 16


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


@pytest.fixture(scope="module")
def data12():
    """12 groups of 2 KiB."""
    return big_mixed(12 * CHUNK, seed=40)


def _gate_hosts(monkeypatch):
    """Host workers wait until the feeder has taken its first batch (its
    first parse starts), so the feeder wins groups on any machine."""
    gate = threading.Event()
    parse, host = DE.parse_group, DE.host_group

    def gated_parse(*args):
        gate.set()
        return parse(*args)

    def gated_host(*args):
        assert gate.wait(60), "the feeder never took a batch"
        return host(*args)
    monkeypatch.setattr(DE, "parse_group", gated_parse)
    monkeypatch.setattr(DE, "host_group", gated_host)


def _threads_left(before):
    return [t for t in threading.enumerate()
            if t not in before and not t.daemon and t.is_alive()]


def _hybrid(data, **kw):
    TRACE.reset()
    out = P.encode_lzma2_hybrid(data, dict_size=DICT, chunk_size=CHUNK,
                                device="cpu", **kw)
    return out, {k.split(".", 1)[1]: v for k, v in TRACE.snapshot().items()
                 if k.startswith("hybrid_encode.")}


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_matches_host_mt(monkeypatch, data12, threads, lanes):
    _gate_hosts(monkeypatch)
    before = set(threading.enumerate())
    out, snap = _hybrid(data12, threads=threads, lanes=lanes)
    ref = jax_encode_mt(data12, dict_size=DICT, chunk_size=CHUNK)
    assert out == ref == encode_lzma2_mt(data12, dict_size=DICT,
                                         chunk_size=CHUNK)
    assert snap["dev_groups"] > 0 and snap["dev_batches"] > 0
    assert snap["dev_groups"] + snap["host_groups"] == 12
    assert snap["dev_groups"] == lanes * snap["dev_batches"]
    assert snap["dev_abstained"] == 1
    assert not _threads_left(before)


def test_copy_chunk_groups_return_to_the_host(monkeypatch):
    """Groups of random bytes need copy chunks: the feeder gives them back
    to the front of the queue and the hosts encode them whole."""
    data = random_bytes(3 * CHUNK, seed=41) + big_mixed(5 * CHUNK, seed=42) \
        + random_bytes(4 * CHUNK, seed=43)
    _gate_hosts(monkeypatch)
    out, snap = _hybrid(data, threads=1, lanes=4)
    assert out == jax_encode_mt(data, dict_size=DICT, chunk_size=CHUNK)
    assert snap["returned_to_host"] >= 4
    assert snap["host_groups"] + snap.get("dev_groups", 0) == 12


def test_empty_input():
    assert P.encode_lzma2_hybrid(b"", device="cpu") == \
        jax_encode_mt(b"", dict_size=1 << 20, chunk_size=1 << 20)


@pytest.mark.parametrize("fault", ["bodies_differ", "lane_failed"])
def test_kernel_fault_raises(monkeypatch, data12, fault):
    """A lane whose bodies differ from the parse's, or that K2 reports
    failed, raises RuntimeError (the JAX engine re-queues it silently), and
    the call leaves no thread behind."""
    plain = R.range_encode_plain

    def faulty(*args):
        bodies, tab, status = plain(*args)
        if fault == "bodies_differ":
            bodies = bodies.clone()
            bodies[1, 3] ^= 0x40
        else:
            status = status.clone()
            status[0, 1] = 0
            status[2, 1] = R.ERR_OVERFLOW
        return bodies, tab, status
    monkeypatch.setattr(R, "range_encode_plain", faulty)
    _gate_hosts(monkeypatch)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="kernel fault"):
        P.encode_lzma2_hybrid(data12, dict_size=DICT, chunk_size=CHUNK,
                              lanes=4, threads=2, device="cpu")
    assert not _threads_left(before)


def test_host_error_waits_for_the_feeder(monkeypatch, data12):
    """A host worker's error ends the call once the feeder has finished its
    step; the feeder is joined, not left running."""
    fed = threading.Event()
    submit = R.submit_encode_groups

    def feeder_submit(*args, **kw):
        fed.set()
        return submit(*args, **kw)

    def failing_host(*args):
        assert fed.wait(60)
        raise OSError("host encoder failed")
    monkeypatch.setattr(R, "submit_encode_groups", feeder_submit)
    monkeypatch.setattr(DE, "host_group", failing_host)
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="host encoder failed"):
        P.encode_lzma2_hybrid(data12, dict_size=DICT, chunk_size=CHUNK,
                              lanes=4, threads=2, device="cpu")
    assert not _threads_left(before)


def test_batch_width_capped_by_budget(monkeypatch, data12):
    """Under a budget of two lanes of the worst group the feeder's batches
    hold two groups, whatever ``lanes`` asks."""
    sub = min(DE.SUB_CHUNK, CHUNK)
    per_lane = M.encode_batch_bytes(1, native.group_ops_cap(CHUNK),
                                    R.out_cap_for(CHUNK), -(-CHUNK // sub))
    monkeypatch.setenv("LZT_HBM_BUDGET", str(2 * per_lane + 100))
    assert DE.hybrid_lanes(4, CHUNK, "cpu") == 2
    assert DE.hybrid_lanes(1, CHUNK, "cpu") == 1
    monkeypatch.setenv("LZT_HBM_BUDGET", str(3 * per_lane))
    assert DE.hybrid_lanes(8, CHUNK, "cpu") == 3
    monkeypatch.setenv("LZT_HBM_BUDGET", str(2 * per_lane + 100))
    widths = []
    submit = R.submit_encode_groups

    def counting_submit(ops, *args, **kw):
        widths.append(ops.shape[0])
        return submit(ops, *args, **kw)
    monkeypatch.setattr(R, "submit_encode_groups", counting_submit)
    _gate_hosts(monkeypatch)
    out, snap = _hybrid(data12, threads=1, lanes=4)
    assert out == jax_encode_mt(data12, dict_size=DICT, chunk_size=CHUNK)
    assert widths and set(widths) == {2}
    assert snap["dev_groups"] == 2 * len(widths)


def test_jax_feeder_abstains_where_the_port_feeds(monkeypatch, data12):
    """A pin of the JAX engine's abstain rule (``device_encode.py:310``:
    fewer than ``lanes * 8`` eligible groups): at 12 groups and ``lanes=4``
    its feeder submits nothing and the hosts encode every group, while the
    port's feeder, which abstains below ``lanes``, codes at least one batch.
    Both streams are the host MT encoder's."""
    jax_calls = []

    def jax_submit(*args, **kw):
        jax_calls.append(1)
        raise AssertionError("the JAX feeder submitted a batch")
    monkeypatch.setattr(JPE, "submit_encode_groups", jax_submit)
    ref = JDE.encode_lzma2_hybrid(data12, dict_size=DICT, chunk_size=CHUNK,
                                  lanes=4, threads=1)
    assert jax_calls == []
    _gate_hosts(monkeypatch)
    out, snap = _hybrid(data12, threads=1, lanes=4)
    assert out == ref
    assert snap["dev_batches"] >= 1


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(P.UnsupportedError):
        P.encode_lzma2_hybrid(b"abc" * 100)


@pytest.mark.cuda
def test_hybrid_encode_on_card(monkeypatch, data12):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _gate_hosts(monkeypatch)
    R.launches = 0
    TRACE.reset()
    out = P.encode_lzma2_hybrid(data12, dict_size=DICT, chunk_size=CHUNK,
                                lanes=4, threads=1)
    assert out == encode_lzma2_mt(data12, dict_size=DICT, chunk_size=CHUNK)
    assert R.launches > 0
    assert TRACE.snapshot()["hybrid_encode.dev_groups"] > 0
