"""The parameters the port took over from the JAX package's signatures, on
the CPU: ``encode_lzma2_device_coded(lanes=)``,
``framing.decode_chunks(engine=)``, ``run_local_cluster(n_processes=)`` and
the memory helpers' ``max_lanes``/``min_lanes``/``inflight``.  Pinned: the
port's ``pick_lanes`` gives the most lanes that fit, where the JAX
package's gives a power of two.
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

from lzma_sdk_zliblike_tpu.models.lzma2 import framing as JF
from lzma_sdk_zliblike_tpu.utils import memory as JM
import lzma_sdk_zliblike_tpu_torch as P
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.parallel import device_encode as DE
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import encode_lzma2_mt
from lzma_sdk_zliblike_tpu_torch.utils import memory as M
from lzma_sdk_zliblike_tpu_torch.utils.errors import ParamError, \
    UnsupportedError
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
_spec = importlib.util.spec_from_file_location(
    "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
_corpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_corpus)

CHUNK = 512
GROUPS = 5
_DATA = _corpus.big_mixed(GROUPS * CHUNK - 100, seed=19)


@pytest.fixture(scope="module")
def default_stream():
    return P.encode_lzma2_device_coded(_DATA, dict_size=1 << 16,
                                       chunk_size=CHUNK, device="cpu")


@pytest.mark.parametrize("lanes", [1, 2])
def test_device_coded_lanes_caps_each_batch(lanes, default_stream,
                                            monkeypatch):
    """``lanes`` caps each K2 batch below the budget's width: ceil(groups /
    lanes) submits, and the stream equals the default one and the host
    MT encoder's."""
    widths = []
    submit = DE.submit_batch

    def counting_submit(parsed, *args):
        widths.append(len(parsed))
        return submit(parsed, *args)
    monkeypatch.setattr(DE, "submit_batch", counting_submit)
    TRACE.reset()
    stream = P.encode_lzma2_device_coded(_DATA, dict_size=1 << 16,
                                         chunk_size=CHUNK, lanes=lanes,
                                         device="cpu")
    assert TRACE.snapshot().get("device_encode.host_groups", 0) == 0
    assert len(widths) == -(-GROUPS // lanes)
    assert max(widths) == lanes and sum(widths) == GROUPS
    assert stream == default_stream
    assert stream[0] == encode_lzma2_mt(_DATA, dict_size=1 << 16,
                                        chunk_size=CHUNK)[0]


def test_device_coded_lanes_must_be_positive():
    with pytest.raises(ParamError):
        P.encode_lzma2_device_coded(_DATA, lanes=0, device="cpu")


def test_decode_chunks_checks_its_engine():
    data = _DATA[:3000]
    stream, prop = encode_lzma2_mt(data, dict_size=1 << 16, chunk_size=1024)
    chunks = F.scan(stream)[0]
    size = F.decode_dict_prop(prop)
    for engine in ("auto", "native", "python"):
        assert F.decode_chunks(stream, chunks, dict_size=size,
                               engine=engine) == data
    assert F.decode_chunks(stream, chunks) == JF.decode_chunks(
        stream, JF.scan(stream)[0], engine="tpu") == data
    for engine in ("tpu", "device", "hybrid"):
        with pytest.raises(UnsupportedError):
            F.decode_chunks(stream, chunks, engine=engine)


RANK_ENV = """
import json, os
print(json.dumps({k: os.environ[k] for k in (
    "LZT_NUM_PROCESSES", "LZT_PROCESS_ID", "LOCAL_RANK",
    "LOCAL_WORLD_SIZE", "LZT_COORDINATOR_HELD")}))
"""


def test_run_local_cluster_takes_n_processes():
    """Named as in the JAX package, the count starts that many ranks in
    rank order, each told its rank and the world size."""
    runs = D.run_local_cluster(n_processes=3, script=RANK_ENV, timeout=120)
    envs = [json.loads(r.stdout.decode().strip().splitlines()[-1])
            for r in runs]
    assert [r.returncode for r in runs] == [0, 0, 0]
    assert [(e["LZT_PROCESS_ID"], e["LOCAL_RANK"]) for e in envs] == \
        [("0", "0"), ("1", "1"), ("2", "2")]
    assert {(e["LZT_NUM_PROCESSES"], e["LOCAL_WORLD_SIZE"],
             e["LZT_COORDINATOR_HELD"]) for e in envs} == {("3", "3", "1")}


def test_pick_lanes_caps_and_defaults():
    per_lane = M.decode_batch_hbm_bytes(1, 4096, 8192)
    assert per_lane == (4096 + 8192) * M.INFLIGHT
    budget = 10 * per_lane
    assert M.pick_lanes(4096, 8192, hbm_budget=budget) == 10
    assert M.pick_lanes(4096, 8192, hbm_budget=budget, max_lanes=4) == 4
    assert M.pick_lanes(4096, 8192, hbm_budget=budget, max_lanes=64) == 10
    assert M.pick_lanes(4096, 8192, hbm_budget=1) == 1
    assert M.pick_lanes(4096, 8192, hbm_budget=1, min_lanes=3) == 3
    assert M.pick_lanes(4096, 8192, hbm_budget=budget, inflight=1) == 20
    assert M.pick_lanes(4096, 8192, hbm_budget=budget, inflight=5) == 4
    assert M.decode_batch_hbm_bytes(3, 4096, 8192, inflight=5) == \
        JM.decode_batch_hbm_bytes(3, 4096, 8192, inflight=5) == \
        3 * (4096 + 8192) * 5


def test_pick_lanes_is_not_a_power_of_two():
    """The one difference from the JAX package's ``pick_lanes``: the most
    lanes that fit, not the largest power of two."""
    budget = 3 * M.decode_batch_hbm_bytes(1, 4096, 4096)
    assert M.pick_lanes(4096, 4096, hbm_budget=budget) == 3
    assert JM.pick_lanes(4096, 4096, hbm_budget=budget) == 2


def test_shape_for_groups_max_lanes():
    stream, _ = encode_lzma2_mt(_DATA, dict_size=1 << 16, chunk_size=CHUNK)
    groups = F.split_groups(F.scan(stream)[0])
    assert len(groups) == GROUPS
    base = M.shape_for_groups(groups, device="cpu")
    assert base.n_lanes == GROUPS
    assert M.shape_for_groups(groups, device="cpu",
                              max_lanes=None) == base
    capped = M.shape_for_groups(groups, device="cpu", max_lanes=2)
    assert capped.n_lanes == 2
    assert (capped.pack_cap, capped.dic_cap) == (base.pack_cap, base.dic_cap)
    assert M.shape_for_groups(groups, device="cpu", max_lanes=99) == base
