"""Driver entry points of the port: one K1 call, and a multi-rank dry run.

The counterpart of the JAX package's ``__graft_entry__.py``: ``entry()``
gives K1's submit and finalize on that module's batch (8 lanes of 2 KiB
single-chunk groups of ``big_mixed(seed=7)``), and ``dryrun_multichip(n)``
starts ``n`` ranks with ``parallel/distributed.run_local_cluster``, each
checking the multi-process path on its share:

* its ``submit_groups_sharded`` lanes against the same rows of the plain
  version of the whole batch, bit for bit, and against the originals;
* ``normalize_axes`` and ``make_mesh_2d`` over its world;
* X2 (``ops/match_find.find_matches``) on its ``lane_shard`` of a
  [lanes, 1 KiB] batch against the same rows of one call on the whole
  batch on the CPU;
* an ``encode_groups_distributed`` round trip through
  ``decode_groups_distributed``, the stream equal to ``encode_lzma2_mt``'s.

The data comes from the repository's ``tests/corpus.py``, loaded by path.

    python -m lzma_sdk_zliblike_tpu_torch.entry [n_ranks] [cuda|cpu]
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np
import torch

from .ops import group_decode as G

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PREFIX = "DRYRUN_RANK "
GROUP = 1 << 11        # bytes per group of the entry batch, as in the JAX one
N_GROUPS = 4


def big_mixed(n: int, seed: int) -> bytes:
    """The repository's test corpus (``tests/corpus.py``), loaded by path:
    another package named ``tests`` may sit on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "lzt_corpus", os.path.join(_REPO, "tests", "corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.big_mixed(n, seed=seed)


def make_batch(n_lanes: int):
    """The JAX entry's batch: ``big_mixed(GROUP * N_GROUPS, seed=7)`` in
    dict-reset groups of ``GROUP`` bytes (the port's host encoder), its
    single-chunk LZMA groups dealt round-robin to ``n_lanes`` lanes of
    ``GROUP`` bytes packed and unpacked.  Returns (src, pack_ends,
    unpack_ends, flags, active) as host arrays, the dic_cap and each lane's
    original bytes."""
    from .models.lzma2 import framing
    from .parallel.host_pool import encode_lzma2_mt
    data = big_mixed(GROUP * N_GROUPS, seed=7)
    stream, _ = encode_lzma2_mt(data, dict_size=GROUP, chunk_size=GROUP)
    groups = framing.split_groups(framing.scan(stream)[0])
    single = [(g[0], data[i * GROUP:(i + 1) * GROUP])
              for i, g in enumerate(groups)
              if len(g) == 1 and g[0].is_lzma and g[0].pack_size <= GROUP]
    if not single:
        raise RuntimeError("the entry batch has no single-chunk LZMA group")
    src = np.zeros((n_lanes, GROUP), np.uint8)
    pe = np.zeros((n_lanes, 1), np.int32)
    ue = np.zeros((n_lanes, 1), np.int32)
    origs = []
    for li in range(n_lanes):
        c, orig = single[li % len(single)]
        src[li, :c.pack_size] = np.frombuffer(stream, np.uint8, c.pack_size,
                                              c.data_off)
        pe[li], ue[li] = c.pack_size, c.unpack_size
        origs.append(orig)
    ones = np.ones(n_lanes, np.int32)
    return (src, pe, ue, ones[:, None].copy(), ones), GROUP, origs


def entry(device="cuda"):
    """(fn, args): K1's submit and finalize on the entry batch (8 lanes),
    the tensors on ``device`` (a card unless the CPU is asked for).
    ``fn(*args)`` returns (out uint8 [8, 2048], ok bool [8], consumed int32
    [8]) on the CPU; lane i's output is its original slice."""
    from .api import check_device
    arrays, dic_cap, _ = make_batch(8)
    args = G.prep_groups(*arrays, device=check_device(device))

    def fn(src, pack_ends, unpack_ends, flags, active):
        return G.finalize_chunks(
            G.submit_groups(src, pack_ends, unpack_ends, flags, active,
                            dic_cap=dic_cap), dic_cap=dic_cap)
    return fn, args


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _rank_checks(world: int, rank: int, device) -> dict:
    """The checks of one rank that need no other rank."""
    from .ops.match_find import find_matches
    from .parallel.mesh import lane_shard, make_mesh_2d, normalize_axes
    n_lanes = world * max(2, -(-8 // world))
    shard = lane_shard(n_lanes, world, rank)
    arrays, dic_cap, origs = make_batch(n_lanes)
    h = G.submit_groups_sharded(*arrays, dic_cap=dic_cap, world=world,
                                rank=rank, device=device)
    out, ok, consumed = G.finalize_chunks(h, dic_cap=dic_cap)
    p_out, p_ok, p_cons, _, _ = G.group_decode_plain(
        *G.prep_groups(*arrays, device="cpu"), dic_cap)
    _check(torch.equal(out, p_out[shard]) and torch.equal(ok, p_ok[shard] != 0)
           and torch.equal(consumed, p_cons[shard]),
           f"rank {rank}: its K1 lanes differ from the plain version's")
    _check(bool(ok.all()) and all(
        out[i, :len(o)].numpy().tobytes() == o
        for i, o in enumerate(origs[shard])),
        f"rank {rank}: a lane differs from its original")
    per2 = 2 if world % 2 == 0 else 1
    axes = normalize_axes(per2, world // per2, None)
    mesh2 = make_mesh_2d(axes[1], axes[0])
    _check(axes == (per2, world // per2, world) and mesh2.size == world
           and mesh2.lane_shard(n_lanes) == shard,
           f"rank {rank}: 2-axis mesh {axes} over a world of {world}")
    L = 1 << 10
    rows = np.frombuffer(big_mixed(n_lanes * L, seed=13),
                         np.uint8).reshape(n_lanes, L)
    valid = np.full(n_lanes, L, np.int32)
    kw = {"n_cand": 3, "n_cand8": 2, "hash_bits": 12}
    mine = find_matches(rows[shard], valid[shard], device=device, **kw)
    whole = find_matches(rows, valid, device="cpu", **kw)
    _check(all(np.array_equal(a, b[shard]) for a, b in
               zip(mine[:2] + mine[2], whole[:2] + whole[2])),
           f"rank {rank}: X2 on its lanes differs from the whole batch's")
    return {"lanes": n_lanes, "shard": [shard.start, shard.stop],
            "mesh_2d": list(mesh2.shape)}


def _dryrun_rank(device: str) -> None:
    """One rank of ``dryrun_multichip`` (run by ``run_local_cluster``)."""
    from .parallel import distributed as D
    from .parallel.host_pool import encode_lzma2_mt
    from .parallel.mesh import local_device, world_and_rank
    D.initialize()
    world, rank = world_and_rank()
    G.launches = 0
    err, res = None, {}
    try:
        dev = local_device(rank, device)
        res = _rank_checks(world, rank, dev)
    except Exception as e:     # agreed below, then raised
        err = e
    D._agree(err, "dryrun_multichip")
    data = big_mixed(1 << 15, seed=17)
    stream, prop = D.encode_groups_distributed(data, dict_size=1 << 12,
                                               chunk_size=1 << 12)
    _check((stream, prop) == encode_lzma2_mt(data, dict_size=1 << 12,
                                             chunk_size=1 << 12),
           f"rank {rank}: the distributed stream differs from "
           "encode_lzma2_mt's")
    back = D.decode_groups_distributed(stream, dict_prop=prop, device=device)
    _check(back == data if rank == 0 else back is None,
           f"rank {rank}: the distributed round trip failed")
    D.barrier("dryrun_multichip")
    res.update(rank=rank, world=world, launches=G.launches,
               device=str(dev))
    print(_PREFIX + json.dumps(res), flush=True)
    if rank == 0:
        print(f"dryrun_multichip({world}): ok on {world} ranks ({device}), "
              f"sharded K1 lanes == plain, 2-axis mesh {res['mesh_2d']}, "
              "sharded X2 == whole batch, distributed encode round trip ok",
              flush=True)
    D.shutdown()


def dryrun_multichip(n_ranks: int, device="cuda", *,
                     timeout: float = 600) -> dict:
    """Run the multi-process path on ``n_ranks`` local ranks (see the module
    docstring) and return {"ranks", "launches" (K1 launches summed over the
    ranks), "per_rank", "summary" (rank 0's line)}.  Raises when any rank
    exits non-zero."""
    from .parallel.distributed import run_local_cluster
    script = ("from lzma_sdk_zliblike_tpu_torch import entry; "
              f"entry._dryrun_rank({str(device)!r})")
    runs = run_local_cluster(n_ranks, script, timeout=timeout)
    bad = [(r, p.returncode, p.stdout.decode(errors="replace")[-3000:])
           for r, p in enumerate(runs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"dryrun_multichip({n_ranks}): ranks exited "
                           "non-zero: " + "\n".join(
                               f"[rank {r}, exit {rc}]\n{tail}"
                               for r, rc, tail in bad))
    per_rank = [json.loads(line[len(_PREFIX):])
                for p in runs for line in p.stdout.decode().splitlines()
                if line.startswith(_PREFIX)]
    summary = [line for line in runs[0].stdout.decode().splitlines()
               if line.startswith("dryrun_multichip(")]
    _check(len(per_rank) == n_ranks and len(summary) == 1,
           "a rank printed no result")
    return {"ranks": n_ranks, "launches": sum(r["launches"] for r in per_rank),
            "per_rank": per_rank, "summary": summary[0]}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    fn, args = entry(dev)
    out, ok, _ = fn(*args)
    print("entry ok:", bool(ok.all()), tuple(out.shape))
    print(dryrun_multichip(n, dev)["summary"])
