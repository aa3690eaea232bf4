"""``ops/group_decode.submit_groups_sharded``: K1 on one rank's block of a
batch dealt over ranks (the JAX package's ``submit_groups_sharded``).

Every rank of a world of 1, 2 or 4 is run in this process on the CPU, where
the wrapper runs the plain version.  The shards, concatenated in rank order,
must equal the unsharded plain version of the whole batch on out, ok and
consumed (tolerance 0: the decoder is bit-exact), and each good lane must
equal the JAX package's ``framing.decode_chunks`` of its group.  The batch
holds a multi-chunk state-carry group, groups from the JAX package's
parallel-groups encoder and a corrupt lane.
"""

from __future__ import annotations

import importlib.util
import os

import pytest
import torch

from lzma_sdk_zliblike_tpu.models.lzma2 import framing as JF
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.parallel.scheduler import (
    BatchedLzma2Decoder, BatchShape)

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
N_LANES = 8
BAD = 5


@pytest.fixture(scope="module")
def batch():
    """8 one-group lanes: a 4-chunk state-carry group (parallel_groups=False),
    six 1.5 KiB groups, and a copy of lane 1 corrupted mid-body (lane 5's
    group is replaced by it).  Returns the host arrays, dic_cap and the JAX
    package's decode of each lane's group (None for the corrupt lane)."""
    carry, _ = JF.encode(big_mixed(2048, seed=21), dict_size=1 << 12,
                         chunk_size=512, parallel_groups=False,
                         engine="native")
    parts, _ = JF.encode(big_mixed(9000, seed=22), dict_size=1 << 12,
                         chunk_size=1536, engine="native")
    stream = carry[:-1] + parts
    groups = F.split_groups(F.scan(stream)[0])
    jgroups = JF.split_groups(JF.scan(stream)[0])
    assert len(groups) >= 7 and len(groups[0]) == 4
    lanes = [[g] for g in groups[:7]]
    lanes.insert(BAD, [groups[1]])
    want = [JF.decode_chunks(stream, jg) for jg in jgroups[:7]]
    want.insert(BAD, None)
    pack_cap = max(sum(c.pack_size for c in g) for g in groups)
    dic_cap = max(sum(c.unpack_size for c in g) for g in groups)
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=N_LANES, pack_cap=pack_cap,
                                         dic_cap=dic_cap), device="cpu")
    src, pe, ue, fl, act = dec._assemble(stream, lanes, 1)
    src[BAD, int(pe[BAD, -1]) // 2] ^= 0x55
    return (src, pe, ue, fl, act), dic_cap, want


@pytest.fixture(scope="module")
def whole(batch):
    arrays, dic_cap, _ = batch
    return G.group_decode_plain(*G.prep_groups(*arrays, device="cpu"),
                                dic_cap)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shards_equal_unsharded_plain_and_jax(batch, whole, world):
    arrays, dic_cap, want = batch
    shards = [G.finalize_chunks(
        G.submit_groups_sharded(*arrays, dic_cap=dic_cap, world=world,
                                rank=r, device="cpu"), dic_cap=dic_cap)
        for r in range(world)]
    out, ok, consumed = (torch.cat(x) for x in zip(*shards))
    assert all(len(s[0]) == N_LANES // world for s in shards)
    assert torch.equal(out, whole[0])
    assert torch.equal(ok, whole[1] != 0)
    assert torch.equal(consumed, whole[2])
    assert ok.tolist() == [li != BAD for li in range(N_LANES)]
    for li, w in enumerate(want):
        if w is not None:
            assert out[li, :len(w)].numpy().tobytes() == w, li
            assert int(consumed[li]) == int(arrays[1][li, -1])


@pytest.mark.parametrize("world,rank", [(3, 0), (5, 1), (0, 0), (2, 2),
                                        (2, -1)])
def test_bad_world_or_rank_raises(batch, world, rank):
    arrays, dic_cap, _ = batch
    with pytest.raises(ValueError):
        G.submit_groups_sharded(*arrays, dic_cap=dic_cap, world=world,
                                rank=rank, device="cpu")


@pytest.mark.cuda
def test_shards_on_card_equal_plain(batch, whole):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    arrays, dic_cap, _ = batch
    G.launches = 0
    shards = [G.finalize_chunks(
        G.submit_groups_sharded(*arrays, dic_cap=dic_cap, world=2, rank=r,
                                device="cuda"), dic_cap=dic_cap)
        for r in range(2)]
    assert G.launches == 2
    out, ok, consumed = (torch.cat(x) for x in zip(*shards))
    assert torch.equal(out, whole[0]) and torch.equal(ok, whole[1] != 0)
    assert torch.equal(consumed, whole[2])
