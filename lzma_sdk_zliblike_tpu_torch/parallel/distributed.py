"""Multi-process LZMA2 decode and encode over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/distributed.py``: one
process per rank, every rank sees the whole input (the broadcast), and the
work is dealt by group index, so the result never depends on the number of
ranks.

* Decode: every rank scans the stream and buckets the card's groups by
  (lc, lp, pb); within a bucket, batches of ``world x lanes`` groups in
  group order are dealt as ``parallel/mesh.lane_shard`` deals lanes, and
  each rank decodes its block with K1 (``ops/group_decode.
  submit_groups_sharded``) under ``BatchedLzma2Decoder``'s checks.  Rank 0
  copies the copy-only groups and decodes those the card cannot take with
  the native host decoder.  One ordered gather to rank 0 at the end.
* Encode: rank ``r`` encodes blocks ``i % world == r`` with the native
  encoder on its share of the machine's cores; an ordered gather to every
  rank joins them, byte-identical to ``host_pool.encode_lzma2_mt``.
* Failures are agreed before any gather: every rank all-reduces a failure
  flag, and if any rank failed, every rank raises (the failing rank its own
  error, the others a ``DataError`` naming it), so no rank is left waiting
  in a collective.  Collectives carry the process group's timeout, so a
  dead peer raises too.

The gathers move host tensors over Gloo: ``finalize_chunks`` returns CPU
tensors, and ranks may share one card, which NCCL refuses.
``run_local_cluster`` starts N ranks on one machine around a store the
launcher holds, so no port is probed and released before use.
``initialize`` registers ``shutdown`` with ``atexit``, so a rank leaves its
process group before the interpreter exits: a rank that exits with Gloo's
threads still joinable aborts ("terminate called without an active
exception").
"""

from __future__ import annotations

import atexit
import datetime
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from ..models.lzma2 import framing
from ..ops import group_decode as G
from ..utils.errors import DataError, ParamError, UnsupportedError
from ..utils.memory import INFLIGHT, device_budget, fits_launcher, \
    shape_for_groups
from ..utils.trace import TRACE
from .mesh import lane_shard, local_device, world_and_rank

ENV_NUM_PROCESSES = "LZT_NUM_PROCESSES"
ENV_PROCESS_ID = "LZT_PROCESS_ID"
ENV_COORDINATOR = "LZT_COORDINATOR"          # host:port of the store
ENV_STORE_HELD = "LZT_COORDINATOR_HELD"      # "1": a launcher holds it
DEFAULT_TIMEOUT_S = 120

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str = "gloo",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group from the arguments or the
    environment (``LZT_NUM_PROCESSES``, ``LZT_PROCESS_ID``,
    ``LZT_COORDINATOR``); a no-op with one process.

    ``coordinator`` is the ``host:port`` (``tcp://`` optional) of the
    group's key-value store: rank 0 serves it unless ``LZT_COORDINATOR_HELD``
    is 1, which ``run_local_cluster`` sets because it holds the store
    itself.  Where there is a card, the rank's card (``mesh.local_device``)
    becomes the current device before anything is allocated.  Every
    collective of the group raises after ``timeout_s``.  ``shutdown`` runs
    at exit (once registered, whatever the number of calls); a process
    ended by ``os._exit`` runs no exit handler."""
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if num_processes <= 1:
        return
    if backend != "gloo":
        raise UnsupportedError(
            f"backend {backend!r}: the gathers move host tensors over Gloo")
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        raise ParamError(f"{num_processes} processes need a coordinator "
                         f"address (argument or {ENV_COORDINATOR})")
    host, _, port = coordinator.removeprefix("tcp://").rpartition(":")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device(process_id, "cuda"))
    timeout = datetime.timedelta(seconds=timeout_s)
    serve = process_id == 0 and os.environ.get(ENV_STORE_HELD) != "1"
    store = dist.TCPStore(host, int(port), num_processes, is_master=serve,
                          timeout=timeout, wait_for_workers=False)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    atexit.unregister(shutdown)         # registered once, however many calls
    atexit.register(shutdown)


def shutdown() -> None:
    """Leave the default process group, joining Gloo's threads; a no-op
    without one, so it may be called more than once.  Gloo's destroy is
    local (it sends nothing to the peers), so it returns after a failed
    collective or a dead peer too."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier(tag: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Wait for every rank; a no-op in one process.  This is Gloo's
    ``monitored_barrier``, which raises naming the ranks that did not
    arrive within ``timeout_s``.  Errors propagate, with ``tag`` added."""
    world, _ = world_and_rank()
    if world <= 1:
        return
    try:
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r}: {e}") from e


def _agree(err: Exception | None, what: str) -> None:
    """Every rank learns which ranks failed (an all-reduce MAX of one flag
    per rank), then raises if any did: the failing rank its own error, the
    others a DataError naming the failing ranks."""
    world, rank = world_and_rank()
    failed = [0] if err is not None else []
    if world > 1:
        flags = torch.zeros(world, dtype=torch.int64)
        flags[rank] = int(err is not None)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
        failed = flags.nonzero().flatten().tolist()
    if err is not None:
        raise err
    if failed:
        raise DataError(f"{what} failed on rank {', '.join(map(str, failed))}")


def _peers(device: torch.device) -> list[tuple[str, str]]:
    """(host name, device) of every rank, in rank order."""
    world, _ = world_and_rank()
    me = (socket.gethostname(), str(device))
    if world <= 1:
        return [me]
    peers: list = [None] * world
    dist.all_gather_object(peers, me)
    return peers


def _ordered_gather(parts: dict[int, bytes], n: int, *,
                    to_all: bool) -> list | None:
    """Each of the ``n`` items, in index order, from the one rank that holds
    it (``parts``: index -> bytes on that rank): an int64 length per item
    gathered first, then one uint8 tensor per rank, its items back to back,
    padded to the longest rank's.  Returns the items as bytes-like views on
    rank 0 (on every rank with ``to_all``), None elsewhere."""
    world, rank = world_and_rank()
    if world <= 1:
        return [parts[i] for i in range(n)]
    lens = torch.zeros(n, dtype=torch.int64)
    for i, p in parts.items():
        lens[i] = len(p)
    rows = [torch.empty_like(lens) for _ in range(world)]
    dist.all_gather(rows, lens)
    lens = torch.stack(rows).numpy()
    if not ((lens > 0).sum(0) == 1).all():
        raise RuntimeError("ordered gather: an item is held by no rank or "
                           "by more than one")
    cap = int(lens.sum(1).max())
    payload = torch.zeros(cap, dtype=torch.uint8)
    mine = b"".join(parts[i] for i in sorted(parts))
    payload.numpy()[:len(mine)] = np.frombuffer(mine, np.uint8)
    del mine
    if to_all:
        bufs = [torch.empty(cap, dtype=torch.uint8) for _ in range(world)]
        dist.all_gather(bufs, payload)
    else:
        bufs = ([torch.empty(cap, dtype=torch.uint8) for _ in range(world)]
                if rank == 0 else None)
        dist.gather(payload, bufs, dst=0)
        if rank != 0:
            return None
    owner = lens.argmax(0)
    ends = lens.cumsum(1)
    views = [memoryview(b.numpy()) for b in bufs]
    return [views[r][ends[r, i] - lens[r, i]:ends[r, i]]
            for i, r in enumerate(owner)]


def _decode_shape(groups, device, world: int, lanes_per_device, pack_cap,
                  dic_cap):
    """The batch shape every rank decodes with.  Values left at None come
    from ``shape_for_groups`` under each rank's budget: its device's budget
    over the ranks that share that device, the least over the ranks so
    that all deal alike; lanes at most the card's groups over the ranks."""
    from .scheduler import BatchShape
    if None not in (lanes_per_device, pack_cap, dic_cap):
        return BatchShape(n_lanes=lanes_per_device, pack_cap=pack_cap,
                          dic_cap=dic_cap, groups_per_lane=1)
    peers = _peers(device)
    budget = device_budget(device) // peers.count(peers[world_and_rank()[1]])
    if world > 1:
        t = torch.tensor([budget], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        budget = int(t)
    TRACE.peak("distributed.budget", budget)
    base = shape_for_groups(groups, device=device, hbm_budget=budget)
    n_card = sum(1 for g in groups
                 if any(c.is_lzma for c in g) and fits_launcher(g))
    lanes = min(base.n_lanes, max(1, math.ceil(n_card / world)))
    return BatchShape(
        n_lanes=lanes if lanes_per_device is None else lanes_per_device,
        pack_cap=base.pack_cap if pack_cap is None else pack_cap,
        dic_cap=base.dic_cap if dic_cap is None else dic_cap,
        groups_per_lane=1)


def _decode_share(stream: bytes, groups, dec, world: int,
                  rank: int) -> dict[int, bytes]:
    """This rank's groups decoded: its blocks of each props bucket's
    batches on K1 (at most INFLIGHT batches on the card), and on rank 0 the
    copy-only and host groups.  Returns group index -> bytes."""
    results, by_props = dec.route(stream, groups, host=rank == 0)
    parts = {gi: r for gi, r in enumerate(results) if r is not None}
    per_batch = world * dec.shape.n_lanes

    def finish(handle, mine):
        outs = dec._outputs(handle, [[groups[gi]] for gi in mine], 1)
        for gi, out in zip(mine, outs):
            if out is None:
                dec._raise_failed(stream, groups[gi], gi)
            parts[gi] = out[0]

    for (lc, lp, pb), idx in sorted(by_props.items()):
        pending: deque = deque()
        for base in range(0, len(idx), per_batch):
            batch = idx[base:base + per_batch]
            mine = batch[lane_shard(per_batch, world, rank)]
            if not mine:
                continue
            if len(pending) == INFLIGHT:
                finish(*pending.popleft())
            lanes = [[groups[gi]] for gi in batch]
            lanes += [[]] * (per_batch - len(batch))
            TRACE.add("scheduler.pallas_batches")
            handle = G.submit_groups_sharded(
                *dec._assemble(stream, lanes, 1), dic_cap=dec.shape.dic_cap,
                world=world, rank=rank, lc=lc, lp=lp, pb=pb,
                device=dec.device)
            TRACE.add("distributed.groups", len(mine))
            pending.append((handle, mine))
        while pending:
            finish(*pending.popleft())
    return parts


def decode_groups_distributed(stream: bytes, *, dict_prop: int,
                              lanes_per_device: int | None = None,
                              pack_cap: int | None = None,
                              dic_cap: int | None = None,
                              device="cuda") -> bytes | None:
    """Decode a raw LZMA2 stream over the ranks of the default process
    group (one process alone without one); the bytes on rank 0, None on the
    others.

    ``device="cuda"`` (the default) runs K1 on each rank's card
    (``mesh.local_device``) and raises where there is none; ``"cpu"`` runs
    its plain version.  ``lanes_per_device``, ``pack_cap`` and ``dic_cap``
    set the batch shape; each left at None is sized from the stream's groups
    under the rank's share of its device's memory.  Groups over the caps
    decode on rank 0 with the native host decoder
    (``scheduler.host_fallback_groups``).  A corrupt group raises
    ``DataError`` on every rank."""
    from .scheduler import BatchedLzma2Decoder
    world, rank = world_and_rank()
    err = groups = None
    try:
        device = local_device(rank, device)
        framing.decode_dict_prop(dict_prop)  # validate
        groups = framing.split_groups(framing.scan(stream)[0])
    except Exception as e:     # agreed below, then raised
        err = e
    _agree(err, "distributed decode (scan)")
    shape = _decode_shape(groups, device, world, lanes_per_device, pack_cap,
                          dic_cap)
    TRACE.peak("distributed.lanes", shape.n_lanes)
    parts: dict[int, bytes] = {}
    try:
        parts = _decode_share(stream, groups,
                              BatchedLzma2Decoder(shape, device=device),
                              world, rank)
    except Exception as e:     # agreed below, then raised
        err = e
    _agree(err, "distributed decode")
    with TRACE.timer("distributed.gather"):
        out = _ordered_gather(parts, len(groups), to_all=False)
        return None if out is None else b"".join(out)


def encode_groups_distributed(data: bytes, *, dict_size: int,
                              chunk_size: int = 1 << 20,
                              threads: int | None = None, effort: int = 9,
                              lc: int = 3, lp: int = 0,
                              pb: int = 2) -> tuple[bytes, int]:
    """LZMA2 encode with dict-reset blocks dealt over the ranks: rank ``r``
    encodes blocks ``i % world == r`` with the native encoder on ``threads``
    threads (default: this machine's cores over its ranks), and the blocks
    are gathered to every rank in block order with one end byte.  Returns
    ``(stream, dict_prop)`` on every rank, byte-identical to
    ``host_pool.encode_lzma2_mt`` of the same arguments."""
    from .. import native
    from .host_pool import normalize_threads
    prop = framing.encode_dict_prop(dict_size)
    if not data:
        return b"\x00", prop
    world, rank = world_and_rank()
    n = len(data)
    blocks = [(i, min(i + chunk_size, n)) for i in range(0, n, chunk_size)]
    mine = list(range(rank, len(blocks), world))
    if threads is None:
        peers = _peers(torch.device("cpu"))
        threads = max(1, (os.cpu_count() or 1) // peers.count(peers[rank]))
    TRACE.peak("distributed.encode_threads", threads)

    def encode_block(bi):
        start, end = blocks[bi]
        stream, _prop = native.lzma2_encode(
            data[start:end], dict_size, chunk_size, lc=lc, lp=lp, pb=pb,
            effort=effort)
        return stream[:-1]  # strip the per-call end byte

    err, parts = None, {}
    try:
        if mine:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(normalize_threads(threads,
                                                      len(mine))) as pool:
                parts = dict(zip(mine, pool.map(encode_block, mine)))
    except Exception as e:     # agreed below, then raised
        err = e
    _agree(err, "distributed encode")
    out = _ordered_gather(parts, len(blocks), to_all=True)
    return b"".join(out) + b"\x00", prop


def run_local_cluster(n_processes: int, script: str, *,
                      timeout: float = 600, env: dict | None = None
                      ) -> list[subprocess.CompletedProcess]:
    """Run ``script`` (Python source) in ``n_processes`` fresh interpreters
    that form one cluster on this machine, and return each rank's
    CompletedProcess (stdout holds its output and errors), in rank order.

    The launcher serves the group's store on a port the OS picks and holds
    it until the ranks exit; each rank finds its rank, the world size and
    the store in the environment that ``initialize`` reads, with
    ``LOCAL_RANK`` set, so that ranks on one card share it.  ``env`` adds
    to this process's environment.  Ranks still running after ``timeout``
    seconds are killed and ``subprocess.TimeoutExpired`` is raised."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    base = {**os.environ, **(env or {}),
            ENV_NUM_PROCESSES: str(n_processes), ENV_STORE_HELD: "1",
            ENV_COORDINATOR: f"127.0.0.1:{store.port}",
            "LOCAL_WORLD_SIZE": str(n_processes)}
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs: list[subprocess.Popen] = []
    logs = []
    try:
        for rank in range(n_processes):
            logs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script], cwd=_REPO,
                env={**base, ENV_PROCESS_ID: str(rank),
                     "LOCAL_RANK": str(rank)},
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        results = []
        for p, log in zip(procs, logs):
            log.seek(0)
            results.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                       log.read()))
        return results
    finally:
        for p in procs:     # a timeout or an error must not leak ranks
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        del store
