"""Hybrid LZMA2 decode: host cores and kernel K1 drain one group queue.

The counterpart of the JAX package's ``parallel/hybrid.py``.  The
reference's MtCoder spreads blocks over CPU threads only
(``MtCoder.c:185-224``); a GPU host has two kinds of silicon: its cores,
each running the native decoder on one dict-reset group at a time, and the
card, which decodes a batch of groups one group per lane.  Host worker
threads and one device feeder thread take groups from the same queue, with
the five guarantees of the JAX engine:

* **Rate-proportional device batches.**  The feeder sizes each batch to the
  card's measured share of the combined drain rate.  K1 takes as long for a
  batch as its longest lane's serial decode, whatever the number of lanes,
  so the card's drain rate is its measured per-lane rate times the lanes a
  full batch holds (``shape.n_lanes``), not the rate of the batches it has
  run (a 4-lane probe batch would otherwise put the card at a thirtieth of
  what a full batch drains).  The first batch of a call whose geometry has
  no cached rate is a 4-lane probe, and nothing else is submitted until it
  is back.
* **First-result-wins slots.**  Every group's result slot is claimed under
  one lock exactly once; whichever engine finishes a group first owns it.
* **Host steal-back.**  When the queue is empty while device batches are in
  flight, host workers decode those batches' groups themselves, newest
  batch first, back to front, so the run never ends on a device-tail stall.
* **Non-blocking endgame and latency guard.**  The feeder polls its
  oldest batch's CUDA event (``group_decode.batch_done``) every few ms; a
  batch whose slots the hosts have all won is dropped without a copy to the
  host, a finished one is copied and its slots claimed.  Once the hosts are
  done the call waits only for the feeder's current step (a submit or a
  copy, never a kernel: there is no compile to wait out, the CUDA library is
  loaded before the workers start), then the feeder drops what it holds
  (``hybrid.feeder_abandoned``).  The feeder abstains when the per-lane
  rate says a batch cannot finish before the hosts drain what is left.
* **Abort.**  ``progress`` returning False poisons every engine
  (``MtCoder_SetError``, ``MtCoder.c:101-107``): host workers stop at their
  next group boundary, the feeder submits nothing more and drops its
  batches, and the call raises ``ProgressAborted``.

A lane that fails on the card is a fault the call raises: the host
reference decodes the group to name it (``DataError`` if the group is
corrupt, ``RuntimeError`` if the kernel disagrees with the host).

Trace counters (``utils/trace.TRACE``): ``hybrid.steals``,
``.dev_batches``, ``.dev_batches_discarded``, ``.dev_abstained``,
``.feeder_abandoned`` (calls whose feeder still held batches when the
hosts were done), ``.host_bytes`` and ``.dev_bytes`` (output bytes each engine
won).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

import torch

from ..models.lzma2 import framing
from ..ops import group_decode as G
from ..utils.errors import DataError, ProgressAborted
from ..utils.memory import INFLIGHT
from ..utils.trace import TRACE
from .host_pool import decode_group_native
from .scheduler import BatchedLzma2Decoder, BatchShape

PROBE_LANES = 4        # the first batch while the card's rate is unknown
POLL_S = 0.002         # the feeder's poll of its oldest batch

# Measured per-lane device rates survive across calls, keyed by device type
# and batch geometry, so a repeat decode skips the probe batch.  Entries are
# (processed bytes, lane-seconds) rescaled to a fixed window at store time;
# the size is bounded and access locked.
_RATE_CACHE: dict[tuple, tuple[float, float]] = {}
_RATE_LOCK = threading.Lock()
_RATE_CACHE_MAX = 32
_RATE_WINDOW_S = 2.0   # seed weight: about 2 s of lane time


def device_batch_size(remaining: int, rem_bytes: int,
                      per_lane: float | None, host_rate: float,
                      n_lanes: int) -> int:
    """Groups the next device batch takes, or 0 to abstain.

    ``remaining`` groups of ``rem_bytes`` output bytes wait for the card;
    ``per_lane`` is the bytes per second one lane decodes (None before the
    first batch: a probe), ``host_rate`` the hosts' measured bytes per
    second (0 while unknown) and ``n_lanes`` the lanes a full batch holds.
    A batch takes about one group's serial decode on one lane, whatever its
    lane count, so the card drains ``per_lane * n_lanes`` bytes per second
    and takes that share of the queue; it abstains when a batch would not
    finish before the hosts drain everything left."""
    if per_lane is None:
        return min(PROBE_LANES, n_lanes)
    est_batch_s = (rem_bytes / remaining) / per_lane
    if host_rate > 0 and est_batch_s > 0.9 * rem_bytes / host_rate:
        return 0
    dev_rate = per_lane * n_lanes
    if host_rate <= 0:
        host_rate = dev_rate * 4.0   # conservative until the hosts are timed
    share = dev_rate / (dev_rate + host_rate)
    return min(n_lanes, max(PROBE_LANES, int(remaining * share)))


def decode_lzma2_hybrid(stream: bytes, dict_prop: int, *,
                        shape: BatchShape | None = None,
                        threads: int | None = None, device="cuda",
                        progress=None) -> bytes:
    """Decode an LZMA2 stream on host threads and the card concurrently.

    ``device``: ``"cuda"`` (the default) feeds K1 on the card, ``"cpu"``
    feeds its plain PyTorch version, None runs the host workers alone.
    ``shape``: the device batches' shape (default ``shape_for_groups``).
    ``threads``: host workers (None or 0: every core).
    ``progress(in_bytes, out_bytes)`` is called at each group completion
    (``ICompressProgress``, ``Types.h:220-225``); returning False aborts.
    """
    framing.decode_dict_prop(dict_prop)  # validate
    groups = framing.split_groups(framing.scan(stream)[0])
    n_groups = len(groups)
    gsize = [sum(c.unpack_size for c in g) for g in groups]
    gin = [sum(c.pack_size for c in g) for g in groups]
    dec = None
    if device is not None:
        from ..api import check_device
        from ..utils.memory import shape_for_groups
        device = check_device(device)
        if shape is None:
            shape = shape_for_groups(groups, device=device)
        dec = BatchedLzma2Decoder(shape, device=device)

    results: list[bytes | None] = [None] * n_groups
    done = [False] * n_groups
    lock = threading.Lock()
    # eligibility is static per group: split the queue up front; a
    # copy-only group is a host memcpy, never worth a lane
    dev_ok: deque[int] = deque()
    host_first: deque[int] = deque()
    gprops: dict[int, tuple[int, int, int]] = {}
    for gi, g in enumerate(groups):
        props = dec._eligible(g) if dec is not None else None
        if props is not None and any(c.is_lzma for c in g):
            gprops[gi] = props
            dev_ok.append(gi)
        else:
            host_first.append(gi)
    inflight: dict[int, list[int]] = {}   # batch key -> unstolen groups
    key_ctr = [0]
    errors: list[Exception] = []
    rates = {"host_bytes": 0.0, "dev_bytes": 0.0, "dev_proc": 0.0,
             "dev_lane_s": 0.0}
    rate_key = None
    if dec is not None:
        rate_key = (device.type, shape.dic_cap, shape.pack_cap)
        with _RATE_LOCK:
            cached = _RATE_CACHE.get(rate_key)
        if cached is not None:
            rates["dev_proc"], rates["dev_lane_s"] = cached
    prog = {"in": 0, "out": 0}
    prog_lock = threading.Lock()

    def claim(gi: int, data: bytes, who: str) -> None:
        """First-result-wins slot write and rate accounting."""
        with lock:
            if done[gi]:
                return
            done[gi] = True
            results[gi] = data
            rates[who] += gsize[gi]
        if progress is not None:
            # the user callback runs outside the scheduler lock, serialised
            # under its own; False poisons every engine
            with prog_lock:
                prog["in"] += gin[gi]
                prog["out"] += gsize[gi]
                if not errors and progress(prog["in"],
                                           prog["out"]) is False:
                    errors.append(ProgressAborted())

    def pop_host() -> int | None:
        with lock:
            if host_first:
                return host_first.popleft()
            if dev_ok:
                return dev_ok.pop()
            # steal-back: newest in-flight batch, back to front
            for key in sorted(inflight, reverse=True):
                batch = inflight[key]
                while batch:
                    gi = batch.pop()
                    if not done[gi]:
                        TRACE.add("hybrid.steals")
                        return gi
            return None

    def host_worker():
        while not errors:
            gi = pop_host()
            if gi is None:
                return
            try:
                data = decode_group_native(stream, groups[gi], dict_prop)
            except Exception as e:  # noqa: BLE001 - reported by the call
                errors.append(DataError(
                    f"host decode failed for dict-reset group {gi}: {e}"))
                return
            claim(gi, data, "host_bytes")

    def per_lane_rate() -> float | None:
        """Bytes per second one lane decodes, or None before a batch."""
        if rates["dev_lane_s"] <= 0:
            return None
        return max(rates["dev_proc"] / rates["dev_lane_s"], 1.0)

    def take_dev_batch() -> list[int]:
        """The next device batch: groups of one (lc, lp, pb), as many as the
        card's share of the drain, or none when the latency guard says a
        batch cannot finish before the hosts drain what is left."""
        with lock:
            remaining = len(dev_ok)
            rem_bytes = sum(gsize[gi] for gi in dev_ok)
        if remaining == 0:
            return []
        dt = time.monotonic() - t0_all
        k = device_batch_size(
            remaining, rem_bytes, per_lane_rate(),
            rates["host_bytes"] / dt if dt > 0.2 else 0.0, shape.n_lanes)
        if k == 0:
            TRACE.add("hybrid.dev_abstained")
            return []
        out: list[int] = []
        with lock:
            while dev_ok and len(out) < k and (
                    not out or gprops[dev_ok[0]] == gprops[out[0]]):
                out.append(dev_ok.popleft())
            if out:
                # registered under the lock that pops the queue, so host
                # workers never see every queue empty while a batch is
                # neither queued nor stealable
                key_ctr[0] += 1
                inflight[key_ctr[0]] = list(out)
        return out

    def retire(key: int, idxs: list[int], handle, t_start: float,
               poll: bool) -> float | None:
        """Finalize or drop the in-flight batch ``key``.  With ``poll``,
        return None at once while the batch runs and some slot is open.
        Returns the time the batch was retired."""
        while True:
            with lock:
                all_done = all(done[gi] for gi in idxs)
            if all_done or errors:
                # the hosts won every slot (or the call failed): no copy to
                # the host.  The batch's tensors go back to PyTorch's
                # caching allocator, which hands their memory only to later
                # work on the feeder's stream, queued after this kernel, so
                # the kernel never writes into memory reused by another.
                with lock:
                    inflight.pop(key, None)
                now = time.monotonic()
                # a batch that has finished counts as decoded; one still
                # running adds its lane time with nothing decoded, a lower
                # bound that pushes the latency guard toward abstaining
                rates["dev_lane_s"] += (now - t_start) * len(idxs)
                if G.batch_done(handle):
                    rates["dev_proc"] += float(sum(gsize[gi] for gi in idxs))
                TRACE.add("hybrid.dev_batches_discarded")
                return now
            if G.batch_done(handle):
                break
            if poll:
                return None
            time.sleep(POLL_S)
        now = time.monotonic()
        outs = dec.finalize_batch(handle, [groups[gi] for gi in idxs])
        with lock:
            inflight.pop(key, None)
        rates["dev_lane_s"] += (now - t_start) * len(idxs)
        rates["dev_proc"] += float(sum(gsize[gi] for gi in idxs))
        TRACE.add("hybrid.dev_batches")
        for gi, data in zip(idxs, outs):
            if data is None:
                dec._raise_failed(stream, groups[gi], gi)
            claim(gi, data, "dev_bytes")
        return now

    # the feeder's batches in flight: (key, groups, handle, lanes' start)
    pending: deque[tuple[int, list[int], object, float]] = deque()

    def device_feeder():
        last_retired = t0_all
        try:
            with feeder_ctx:
                while not errors:
                    # one probe at a time: a second would queue behind the
                    # first and put off the first sized batch by a batch
                    busy = len(pending) == INFLIGHT or (
                        pending and per_lane_rate() is None)
                    batch = [] if busy else take_dev_batch()
                    if batch:
                        t_sub = time.monotonic()
                        handle = dec.submit_batch(
                            stream, [groups[gi] for gi in batch],
                            gprops[batch[0]])
                        pending.append((key_ctr[0], batch, handle,
                                        max(t_sub, last_retired)))
                    if not pending:
                        return
                    # a batch queued behind another starts when it ends
                    t = retire(*pending[0], poll=bool(batch))
                    if t is not None:
                        pending.popleft()
                        last_retired = t
                        if pending:
                            k, b, h, ts = pending.popleft()
                            pending.appendleft((k, b, h, max(ts, t)))
        except Exception as e:  # noqa: BLE001 - reported by the call
            errors.append(e)

    nt = threads if threads and threads > 0 else (os.cpu_count() or 1)
    workers = [threading.Thread(target=host_worker) for _ in range(nt)]
    feeder = None
    if dec is not None and dev_ok:
        feeder_ctx = contextlib.nullcontext()
        if device.type == "cuda":
            # load the CUDA library before the workers start, so that no
            # build or load lands in a timed batch; the feeder launches on
            # a stream of its own and records each batch's event there
            from ..ops import _build
            _build.library("group_decode")
            feeder_ctx = torch.cuda.stream(torch.cuda.Stream(device))
        feeder = threading.Thread(target=device_feeder)
    t0_all = time.monotonic()
    for w in workers:
        w.start()
    if feeder is not None:
        feeder.start()
    for w in workers:
        w.join()
    if feeder is not None:
        # the hosts have left, so every slot is filled or the call failed:
        # a feeder still running drops what it holds at its next step.  The
        # call waits for that step (a submit or a copy, never a kernel), as
        # a thread abandoned inside a torch call can abort the interpreter
        # at exit.
        if feeder.is_alive() and pending:
            TRACE.add("hybrid.feeder_abandoned")
        feeder.join()
    if rate_key is not None and rates["dev_lane_s"] > 0:
        scale = min(1.0, _RATE_WINDOW_S / rates["dev_lane_s"])
        with _RATE_LOCK:
            if len(_RATE_CACHE) >= _RATE_CACHE_MAX and \
                    rate_key not in _RATE_CACHE:
                _RATE_CACHE.pop(next(iter(_RATE_CACHE)))
            _RATE_CACHE[rate_key] = (rates["dev_proc"] * scale,
                                     rates["dev_lane_s"] * scale)
    TRACE.add("hybrid.host_bytes", rates["host_bytes"])
    TRACE.add("hybrid.dev_bytes", rates["dev_bytes"])
    if errors:
        raise errors[0]
    missing = [i for i, r in enumerate(results) if r is None]
    if missing:
        raise DataError(f"hybrid decode dropped groups {missing[:4]}")
    return b"".join(results)  # type: ignore[arg-type]
