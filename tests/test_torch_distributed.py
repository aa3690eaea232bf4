"""Multi-process decode and encode of the port (``parallel/distributed.py``)
on real Gloo clusters of plain-K1 ranks (``device="cpu"``), started with
``run_local_cluster``.

The streams come from the JAX package's encoder (as in
``tests/test_distributed.py``: ``framing.encode(parallel_groups=False)``
gives a 4-chunk state-carry group) and from liblzma.  The ranks read their
inputs from files this process writes.  Decode must return the original
on rank 0 and None elsewhere at 2 and 4 ranks; encode at 2 ranks must be
byte-identical to the JAX package's ``encode_groups_distributed`` and
``encode_lzma2_mt``.  A corrupt group and a dead peer make every rank
raise within its timeout; two clusters started at once both run (no port
is probed and released).  The plain K1's time follows the packets of a
batch's longest lane, so groups are a few KiB.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import lzma
import os
import subprocess
import threading
import time

import pytest

from lzma_sdk_zliblike_tpu.models.lzma2 import framing as JF
from lzma_sdk_zliblike_tpu.parallel import distributed as JD
from lzma_sdk_zliblike_tpu.parallel import host_pool as JH
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import encode_lzma2_mt
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

# Each rank decodes the cases of a JSON file: (stream file, dict prop,
# keyword arguments), and prints one JSON line: its outputs' SHA-256 (None
# where it got None) and its counters.
DECODE = r"""
import hashlib, json, sys
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
D.initialize()
rank = D.world_and_rank()[1]
res = []
for path, prop, kw in json.load(open(sys.argv[1])):
    TRACE.reset()
    out = D.decode_groups_distributed(open(path, "rb").read(),
                                      dict_prop=prop, device="cpu", **kw)
    snap = TRACE.snapshot()
    res.append({"sha": None if out is None else hashlib.sha256(out).hexdigest(),
                "host": snap.get("scheduler.host_fallback_groups", 0),
                "groups": snap.get("distributed.groups", 0),
                "batches": snap.get("scheduler.pallas_batches", 0)})
print("RESULT " + json.dumps({"rank": rank, "cases": res}), flush=True)
D.barrier("done")
"""


def _cluster(n, script, args=(), timeout=240, env=None):
    """run_local_cluster with ``sys.argv[1:] = args`` in every rank."""
    code = f"import sys; sys.argv[1:] = {list(map(str, args))!r}\n" + script
    return D.run_local_cluster(n, code, timeout=timeout, env=env)


def _results(runs):
    out = []
    for r in runs:
        text = r.stdout.decode(errors="replace")
        assert r.returncode == 0, text[-3000:]
        out.append(json.loads([ln for ln in text.splitlines()
                               if ln.startswith("RESULT ")][0][7:]))
    return out


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _liblzma_stream(parts, dict_size=1 << 16):
    groups = [lzma.compress(p, format=lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "preset": 6, "dict_size": dict_size}])[:-1]
        for p in parts]
    return b"".join(groups) + b"\x00", F.encode_dict_prop(dict_size)


@pytest.fixture(scope="module")
def decode_cases(tmp_path_factory):
    """(case file, originals): the JAX test's stream shape
    (one 4-chunk state-carry group), a 6-group stream at the default shape
    and at one lane per rank with 1 KiB caps (several batches per rank),
    and a liblzma stream with a copy-only group and a group over explicit
    1 KiB caps (decoded on rank 0 by the host)."""
    d = tmp_path_factory.mktemp("decode")
    carry_data = big_mixed(1 << 11, seed=31)
    carry, cprop = JF.encode(carry_data, dict_size=1 << 12, chunk_size=512,
                             parallel_groups=False, engine="native")
    six_data = big_mixed(6 * 1024, seed=32)
    six, sprop = JF.encode(six_data, dict_size=1024, chunk_size=1024,
                           engine="native")
    parts = [big_mixed(700, seed=33), random_bytes(600, seed=34),
             big_mixed(3000, seed=35), big_mixed(900, seed=36)]
    mixed, mprop = _liblzma_stream(parts)
    streams = {"carry": carry, "six": six, "mixed": mixed}
    for name, s in streams.items():
        (d / name).write_bytes(s)
    groups = {name: F.split_groups(F.scan(s)[0]) for name, s in streams.items()}
    assert len(groups["carry"]) == 1 and len(groups["carry"][0]) == 4
    assert len(groups["six"]) == 6
    assert [all(not c.is_lzma for c in g) for g in groups["mixed"]] == \
        [False, True, False, False]
    cases = [(str(d / "carry"), cprop, {}), (str(d / "six"), sprop, {}),
             (str(d / "six"), sprop, {"lanes_per_device": 1,
                                      "pack_cap": 1024, "dic_cap": 1024}),
             (str(d / "mixed"), mprop, {"lanes_per_device": 1,
                                        "pack_cap": 1024, "dic_cap": 1024})]
    path = d / "cases.json"
    path.write_text(json.dumps(cases))
    origs = [carry_data, six_data, six_data, b"".join(parts)]
    return path, origs


@pytest.mark.parametrize("world", [2, 4])
def test_decode_equals_original_on_rank_0(decode_cases, world):
    path, origs = decode_cases
    res = sorted(_results(_cluster(world, DECODE, [path])),
                 key=lambda r: r["rank"])
    for case, orig in enumerate(origs):
        got = [r["cases"][case] for r in res]
        assert got[0]["sha"] == _sha(orig), case
        assert all(g["sha"] is None for g in got[1:]), case
        # each group on the card is decoded once, by one rank; the host's
        # (the 3000 B group over 1 KiB caps) on rank 0
        assert sum(g["groups"] for g in got) == [1, 6, 6, 2][case], case
        assert [g["host"] for g in got] == [[0, 1][case == 3]] + \
            [0] * (world - 1), case
    # one lane per rank: 6 groups in batches of `world` lanes
    assert sum(r["cases"][2]["batches"] for r in res) == 6
    assert res[1]["cases"][1]["groups"] > 0


ENCODE = r"""
import hashlib, json, sys
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
D.initialize()
data = open(sys.argv[1], "rb").read()
stream, prop = D.encode_groups_distributed(data, dict_size=1 << 14,
                                           chunk_size=1 << 14)
print("RESULT " + json.dumps({"rank": D.world_and_rank()[1], "prop": prop,
      "sha": hashlib.sha256(stream).hexdigest()}), flush=True)
"""


def test_encode_equals_jax_and_host_mt(tmp_path):
    data = big_mixed(1 << 17, seed=5)
    (tmp_path / "data").write_bytes(data)
    res = _results(_cluster(2, ENCODE, [tmp_path / "data"]))
    jstream, jprop = JD.encode_groups_distributed(data, dict_size=1 << 14,
                                                  chunk_size=1 << 14)
    jmt, jmt_prop = JH.encode_lzma2_mt(data, dict_size=1 << 14,
                                       chunk_size=1 << 14)
    mt, mt_prop = encode_lzma2_mt(data, dict_size=1 << 14, chunk_size=1 << 14)
    assert jstream == jmt == mt and jprop == jmt_prop == mt_prop
    assert JF.decode(jstream, dict_prop=jprop) == data
    assert [(r["sha"], r["prop"]) for r in res] == [(_sha(jstream), jprop)] * 2


def test_encode_in_one_process_equals_host_mt():
    data = big_mixed(50_000, seed=6) + random_bytes(20_000, seed=7)
    got = D.encode_groups_distributed(data, dict_size=1 << 14,
                                      chunk_size=1 << 14, threads=2)
    assert got == encode_lzma2_mt(data, dict_size=1 << 14,
                                  chunk_size=1 << 14)
    assert D.encode_groups_distributed(b"", dict_size=1 << 14) == \
        JD.encode_groups_distributed(b"", dict_size=1 << 14)


FAILING = r"""
import sys, time
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
from lzma_sdk_zliblike_tpu_torch.utils.errors import DataError
D.initialize(timeout_s=float(sys.argv[3]))
rank = D.world_and_rank()[1]
if rank == 1 and sys.argv[4] == "die":
    import os
    os._exit(0)
t = time.monotonic()
try:
    D.decode_groups_distributed(open(sys.argv[1], "rb").read(),
                                dict_prop=int(sys.argv[2]), device="cpu")
except Exception as e:
    print(f"RAISED {type(e).__name__} {time.monotonic() - t:.3f} {e}",
          flush=True)
    sys.exit(3)
print("NO ERROR", flush=True)
"""


def test_corrupt_group_raises_on_every_rank(tmp_path):
    """Four 1.5 KiB groups over 2 ranks: rank 1 decodes groups 2 and 3, and
    group 3 is corrupt.  Rank 1 raises its own DataError (group 3), rank 0
    one that names rank 1."""
    stream, prop = _liblzma_stream([big_mixed(1536, seed=40 + i)
                                    for i in range(4)])
    groups = F.split_groups(F.scan(stream)[0])
    c = groups[3][0]
    bad = bytearray(stream)
    bad[c.data_off + c.pack_size // 2] ^= 0x55
    (tmp_path / "bad").write_bytes(bytes(bad))
    t = time.monotonic()
    runs = _cluster(2, FAILING, [tmp_path / "bad", prop, 60, "decode"])
    assert time.monotonic() - t < 120
    lines = [r.stdout.decode(errors="replace") for r in runs]
    assert [r.returncode for r in runs] == [3, 3], lines
    assert "RAISED DataError" in lines[0] and "rank 1" in lines[0], lines[0]
    assert "RAISED DataError" in lines[1] and "group 3" in lines[1], lines[1]


def test_dead_peer_raises_within_timeout(tmp_path):
    """Rank 1 exits right after ``initialize``: rank 0's first collective
    raises within the group's timeout instead of waiting for ever."""
    stream, prop = _liblzma_stream([big_mixed(1536, seed=50 + i)
                                 for i in range(4)])
    (tmp_path / "s").write_bytes(stream)
    timeout_s = 20
    runs = _cluster(2, FAILING, [tmp_path / "s", prop, timeout_s, "die"],
                    timeout=120)
    text = runs[0].stdout.decode(errors="replace")
    assert runs[1].returncode == 0
    assert runs[0].returncode == 3, text[-3000:]
    line = [ln for ln in text.splitlines() if ln.startswith("RAISED ")][0]
    assert float(line.split()[2]) < timeout_s + 10, line


GATHER = r"""
import torch, torch.distributed as dist
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
D.initialize()
world, rank = D.world_and_rank()
ranks = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
dist.all_gather(ranks, torch.tensor([rank]))
D.barrier("gather")
print("RESULT " + '{"rank": %d, "ranks": %s}' % (rank, [int(r) for r in ranks]))
"""


def test_two_clusters_at_once():
    """Each launcher holds its own store on a port the OS picked, so two
    clusters started together never race for a probed port."""
    out: dict = {}

    def run(key):
        out[key] = _results(_cluster(2, GATHER))

    threads = [threading.Thread(target=run, args=(k,)) for k in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    for key in "ab":
        assert sorted(r["rank"] for r in out[key]) == [0, 1]
        assert all(r["ranks"] == [0, 1] for r in out[key])


def test_cluster_timeout_kills_ranks():
    with pytest.raises(subprocess.TimeoutExpired):
        _cluster(2, "import time; time.sleep(600)", timeout=3)


def _repeated_groups(n_groups, size=1 << 16):
    """Groups of ``size`` bytes, each a 4 KiB piece of the corpus repeated:
    over the JAX defaults' 16 KiB caps, and few packets per lane, so the
    plain K1 stays quick."""
    return b"".join(big_mixed(4096, seed=60 + i) * (size // 4096)
                    for i in range(n_groups))


def test_jax_defaults_send_every_group_to_python_port_keeps_them_on_k1(
        monkeypatch):
    """The JAX function's default 16 KiB caps send every 64 KiB group to
    the pure-Python ``framing.decode_chunks``; the port's defaults size
    the shape from the stream, and no group goes to the host."""
    data = _repeated_groups(3)
    stream, prop = JF.encode(data, dict_size=1 << 16, chunk_size=1 << 16,
                             engine="native")
    calls = []
    python_decode = JF.decode_chunks

    def counting(*args, **kw):
        calls.append(1)
        return python_decode(*args, **kw)

    monkeypatch.setattr(JF, "decode_chunks", counting)
    assert JD.decode_groups_distributed(stream, dict_prop=prop) == data
    assert len(calls) == len(JF.split_groups(JF.scan(stream)[0])) == 3
    TRACE.reset()
    assert D.decode_groups_distributed(stream, dict_prop=prop,
                                       device="cpu") == data
    snap = TRACE.snapshot()
    assert snap.get("scheduler.host_fallback_groups", 0) == 0
    assert snap["distributed.groups"] == 3


TEARDOWN = r"""
import torch, torch.distributed as dist
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
D.initialize()
t = torch.ones(1)
dist.all_reduce(t)
print("RESULT " + '{"rank": %d, "sum": %d}' % (D.world_and_rank()[1], int(t)),
      flush=True)
"""


def test_ranks_exit_cleanly_after_teardown():
    """Eight 2-rank clusters at once, each rank initialising, running one
    all-reduce and returning: the exit handler that ``initialize``
    registers leaves the group, so every rank exits with code 0 (without
    it a rank could abort at exit with Gloo's threads still joinable)."""
    out: dict = {}

    def run(key):
        out[key] = _cluster(2, TEARDOWN, timeout=240)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    for key in range(8):
        assert [r["sum"] for r in _results(out[key])] == [2, 2], key
        for r in out[key]:
            assert b"terminate called" not in r.stdout, r.stdout[-3000:]


SHUTDOWN = r"""
import os, sys, time
import torch, torch.distributed as dist
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
D.initialize(timeout_s=float(sys.argv[1]))
if D.world_and_rank()[1] == 1:
    os._exit(0)
try:
    dist.all_reduce(torch.ones(1))
    print("NO ERROR", flush=True)
except Exception as e:
    t = time.monotonic()
    D.shutdown()
    D.shutdown()
    print(f"SHUTDOWN {time.monotonic() - t:.3f} {dist.is_initialized()}",
          flush=True)
"""


def test_shutdown_after_failed_collective_returns():
    """Rank 1 dies after ``initialize``; rank 0's all-reduce fails, and
    ``shutdown`` (called twice) then returns within the group's timeout,
    leaves no group behind, and the rank exits with code 0."""
    timeout_s = 10
    runs = _cluster(2, SHUTDOWN, [timeout_s], timeout=120)
    text = runs[0].stdout.decode(errors="replace")
    assert [r.returncode for r in runs] == [0, 0], text[-3000:]
    line = [ln for ln in text.splitlines() if ln.startswith("SHUTDOWN ")][0]
    assert float(line.split()[1]) < timeout_s, line
    assert line.split()[2] == "False", line
