#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's LZMA2 decode and encode paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build: nvcc builds every kernel of the paths (``csrc/*.cu``: K1
   ``group_decode``, K2 ``range_encode``) for sm_90a; the ``-Xptxas -v``
   report (registers, shared memory, spills) is printed.
2. kernel vs plain: K1 on CUDA tensors against ``group_decode_plain`` on CPU
   copies of the same 16-lane batch (single- and multi-chunk groups, mid-group
   state resets, copy chunks, a group of more than 128 chunks, a lane of
   several groups, a corrupt lane), then two 300-lane batches of 1-3 KB
   groups (lc=3/lp=0 and lc=0/lp=4: several lanes per block, the second
   above 48 KB of shared memory per block).  out, ok and consumed must be
   identical (tolerance 0: the decoder is bit-exact), and every good lane
   must equal its original bytes.
3. main: ``lzma2_uncompress(device="cuda")`` on 128 MiB of the repo's
   ``big_mixed`` corpus cut into 1 MiB dict-reset groups; then the same
   stream under a device budget of 32 lanes (``LZT_HBM_BUDGET``), which
   the scheduler must split into four batches.
4. big block: one 64 MiB group with a 16 MiB dictionary (the reference's
   default MT block, 4 x dict), several hundred chunks in one group.
5. encode kernel vs plain: K2 on CUDA tensors against ``range_encode_plain``
   on CPU copies of a batch of 16 lanes of 4-30 KB parsed into 4 KiB chunks,
   a lane of zeros (rep and short-rep chains), a lane of ``x86_like`` data
   (matched literals), a lane whose body does not fit ``out_cap`` (it must
   fail alone) and an inactive lane; then 300 lanes of 1-3 KB at
   lc=0/lp=4/pb=0 (several lanes per block, above 48 KB of shared memory);
   then 6 lanes at the main path's shapes: 20-160 KB prefixes of its first
   groups, parsed with its 1 MiB dictionary into 48 KiB chunks (up to 4 per
   lane), coded into a buffer of its ``out_cap``.  Bodies, tab and status must be identical
   (tolerance 0), and every good lane's bodies must equal the native
   coder's.
6. encode main: ``encode_lzma2_device_coded(device="cuda")`` on the 128 MiB
   of phase 3 in 1 MiB groups with a 1 MiB dictionary.  The stream must
   equal ``encode_lzma2_mt``'s, decode to the original with Python's
   ``lzma`` and with the port's K1 (``lzma2_uncompress``), with K2 launches
   > 0 and every group coded on the card (the entry point raises on a lane
   that fails or whose bodies differ from the native coder's).  Its step
   breakdown, kernel time (CUDA events) and bound are read from that run's
   trace counters.

Decode streams are made with Python's ``lzma`` module (raw LZMA2, preset 6),
one compression per group, so the original bytes are the ground truth.
Phases 3 and 4 require output == original, K1 launches > 0, and no host
fallback or lane retry.  The last line is the device summary; the line
before the nvidia line lists the kernels with their launches, times and
bounds.  Any failure exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import json
import lzma
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
MIB = 1 << 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def corpus_module():
    """The repo's test corpus (tests/corpus.py), loaded by path: another
    package named ``tests`` may sit on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus(n: int) -> bytes:
    return corpus_module().big_mixed(n)


def lzma2_group(data: bytes, dict_size: int, **props) -> bytes:
    """``data`` compressed alone as one raw LZMA2 dict-reset group (no end
    byte): liblzma, preset 6, with lc/lp/pb from ``props`` if given."""
    c = lzma.compress(data, format=lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "preset": 6, "dict_size": dict_size,
         **props}])
    if c[-1:] != b"\x00":
        raise RuntimeError("liblzma stream does not end with the end byte")
    return c[:-1]


def lzma2_stream(groups, dict_size: int) -> tuple[bytes, int]:
    """Compressed groups as one raw LZMA2 stream: (stream, dict_prop)."""
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    return b"".join(groups) + b"\x00", framing.encode_dict_prop(dict_size)


def continue_group(group: bytes) -> bytes:
    """The group's first chunk without its dictionary reset: an LZMA chunk
    keeps its state+props reset (mode 3 -> 2), a copy chunk 0x01 -> 0x02.
    Appended to a group whose decoded length is a multiple of 16 and whose
    last byte is < 0x20, it decodes to the same bytes (positions and the
    lc=3 literal context then match a fresh start)."""
    b = bytearray(group)
    if b[0] == 0x01:
        b[0] = 0x02
    elif b[0] >= 0x80 and (b[0] >> 5) & 3 == 3:
        b[0] = (b[0] & 0x9F) | (2 << 5)
    else:
        raise RuntimeError(f"unexpected first control byte {b[0]:#x}")
    return bytes(b)


def pieces_group(pieces, dict_size: int, pool) -> bytes:
    """One group made of separately compressed pieces joined with state
    resets: many chunks, mid-group state resets, copy chunks for the
    incompressible pieces."""
    for p in pieces:
        if len(p) % 16 or p[-1] >= 0x20:
            raise ValueError("piece must be 16-byte sized and end below 0x20")
    parts = list(pool.map(lambda p: lzma2_group(p, dict_size), pieces))
    return parts[0] + b"".join(continue_group(p) for p in parts[1:])


def phase2_batch(pool):
    """The kernel-vs-plain batch: 16 lanes of a few tens of KB.

    Returns (stream, lane_lists of groups, originals per lane, corrupt lane)."""
    random_bytes = corpus_module().random_bytes
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    text = corpus(1 << 20)
    dsz = 1 << 16
    off = [0]

    def take(n):
        a = off[0]
        off[0] += n
        return text[a:a + n - 1] + b"\n"

    groups, origs = [], []        # groups as bytes, with their originals

    def add(group_bytes, orig):
        groups.append(group_bytes)
        origs.append(orig)

    sizes = [24576, 16384, 12288, 8192, 20480, 4096]
    for n in sizes:                                  # single-chunk groups
        d = take(n)
        add(lzma2_group(d, dsz), d)
    # many chunks (> 128), mid-group state resets, copy chunks
    pcs = []
    for i in range(160):
        pcs.append(random_bytes(95, seed=i) + b"\n" if i % 7 == 3
                   else take(96))
    add(pieces_group(pcs, dsz, pool), b"".join(pcs))
    for k in range(3):                               # multi-chunk groups
        pcs = [take(n) for n in (4096, 2048, 6144, 1024)]
        if k == 1:
            pcs.insert(2, random_bytes(4095, seed=99) + b"\n")
        add(pieces_group(pcs, dsz, pool), b"".join(pcs))
    for n in (6144, 4096, 8192, 2048, 3072, 5120):   # for multi-group lanes
        d = take(n)
        add(lzma2_group(d, dsz), d)
    stream = b"".join(groups) + b"\x00"
    chunk_groups = framing.split_groups(framing.scan(stream)[0])
    assert len(chunk_groups) == len(groups)
    # lanes: one group each, then three lanes of two groups (flags bit3),
    # then a copy of lane 0 that gets corrupted
    lane_lists = [[g] for g in chunk_groups[:10]]
    lane_orig = [[o] for o in origs[:10]]
    for a in range(10, 16, 2):
        lane_lists.append(chunk_groups[a:a + 2])
        lane_orig.append(origs[a:a + 2])
    lane_lists += [[chunk_groups[0]], [chunk_groups[4]], [chunk_groups[6]]]
    lane_orig += [[origs[0]], [origs[4]], [origs[6]]]
    return stream, lane_lists, [b"".join(o) for o in lane_orig], 13


def bound_ms(packed: int, unpacked: int) -> float:
    """Least time for the decode on the card: packed bytes read once and
    output bytes written once at the HBM rate (the work is serial per lane,
    far above this bound)."""
    return (packed + unpacked) / HBM_BYTES_PER_S * 1e3


def time_kernel(G, tensors, dic_cap, reps: int) -> dict:
    """Mean ms of one K1 launch on resident inputs, by CUDA events, and the
    decoded packets per lane (max and total)."""
    import torch
    G.submit_groups(*tensors, dic_cap=dic_cap)          # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        h = G.submit_groups(*tensors, dic_cap=dic_cap)
    t1.record()
    torch.cuda.synchronize()
    return {"kernel_ms": t0.elapsed_time(t1) / reps,
            "iterations_max": int(h.iterations.max()),
            "iterations_total": int(h.iterations.long().sum())}


def compare(G, tensors, dic_cap, device, lc=3, lp=0, pb=2):
    """K1 on CUDA copies of a CPU batch against the plain version on it:
    out, ok and consumed must be identical (tolerance 0: the decoder is
    bit-exact).  Also returns the kernel's out and ok."""
    import torch
    t = time.perf_counter()
    p_out, p_ok, p_cons = G.group_decode_plain(*tensors, dic_cap, lc, lp, pb)
    plain_ms = (time.perf_counter() - t) * 1e3
    h = G.submit_groups(*[x.to(device) for x in tensors], dic_cap=dic_cap,
                        lc=lc, lp=lp, pb=pb)
    k_out, k_ok, k_cons = (x.cpu() for x in (h.out, h.ok, h.consumed))
    return {"lanes": len(k_ok),
            "out_equal": bool(torch.equal(k_out, p_out)),
            "ok_equal": bool(torch.equal(k_ok, p_ok)),
            "consumed_equal": bool(torch.equal(k_cons, p_cons)),
            "max_abs_err": int((k_out.int() - p_out.int()).abs().max()),
            "plain_ms": plain_ms}, k_out, k_ok


def wide_batch(pool, n_lanes: int, text: bytes, **props):
    """``n_lanes`` one-group lanes of 1-3 KB of ``text``, each compressed
    alone with ``props``: as a CPU batch, its dic_cap and the originals."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    from lzma_sdk_zliblike_tpu_torch.parallel.scheduler import (
        BatchedLzma2Decoder, BatchShape)
    ends = [0]
    for i in range(n_lanes):
        ends.append(ends[-1] + 1024 + i * 37 % 2048)
    origs = [text[a:b] for a, b in zip(ends, ends[1:])]
    stream = b"".join(pool.map(
        lambda d: lzma2_group(d, 1 << 16, **props), origs)) + b"\x00"
    groups = framing.split_groups(framing.scan(stream)[0])
    pack_cap = max(c.pack_size for g in groups for c in g)
    dic_cap = max(len(o) for o in origs)
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=n_lanes, pack_cap=pack_cap,
                                         dic_cap=dic_cap), device="cpu")
    tensors = [torch.from_numpy(a) for a in
               dec._assemble(stream, [[g] for g in groups], 1)]
    return tensors, dic_cap, origs


def kernel_vs_plain(pool, device) -> dict:
    import torch
    from lzma_sdk_zliblike_tpu_torch.models.lzma import spec as S
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    from lzma_sdk_zliblike_tpu_torch.parallel.scheduler import (
        BatchedLzma2Decoder, BatchShape)
    stream, lanes, origs, bad = phase2_batch(pool)
    k = max(len(lane) for lane in lanes)
    pack_cap = max(sum(c.pack_size for g in lane for c in g) for lane in lanes)
    dic_cap = max(sum(c.unpack_size for g in lane for c in g) for lane in lanes)
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=len(lanes), pack_cap=pack_cap,
                                         dic_cap=dic_cap), device=device)
    src, pe, ue, fl, act = (torch.from_numpy(a) for a in
                            dec._assemble(stream, lanes, k))
    src[bad, int(pe[bad, -1]) // 2] ^= 0x55
    tensors = (src, pe, ue, fl, act)
    res, k_out, k_ok = compare(G, tensors, k * dic_cap, device)
    res.update({
        "chunks_max": int((fl != 0).sum(1).max()),
        "bit3_lanes": int(((fl & G.FLAG_REBASE) != 0).any(1).sum()),
        "copy_chunks": int(((fl & G.FLAG_COPY) != 0).sum()),
        "reset_chunks": int(((fl & G.FLAG_RESET) != 0).sum()),
        "ok": k_ok.tolist()})
    good = [li for li in range(len(lanes)) if li != bad]
    res["originals_equal"] = all(
        k_out[li, :len(origs[li])].numpy().tobytes() == origs[li]
        for li in good)
    res["corrupt_lane_failed_alone"] = (
        not k_ok[bad] and all(bool(k_ok[li]) for li in good))
    res["pass"] = (res["out_equal"] and res["ok_equal"]
                   and res["consumed_equal"] and res["originals_equal"]
                   and res["corrupt_lane_failed_alone"]
                   and res["chunks_max"] > 128 and res["bit3_lanes"] > 0
                   and res["copy_chunks"] > 0 and res["reset_chunks"] > 0)
    res.update(time_kernel(G, [x.to(device) for x in tensors], k * dic_cap,
                           reps=3))
    res["bound_ms"] = bound_ms(int(pe[:, -1].sum()), int(ue[:, -1].sum()))
    # more than 2 x 132 lanes, so blocks hold several lanes: at lc=3 the
    # block's models fill just under 48 KB; at lc+lp=4 they need the
    # raised dynamic shared-memory limit
    text = corpus_module().big_mixed(2 * MIB, seed=7)
    res["wide"] = []
    for props in ({}, {"lc": 0, "lp": 4, "pb": 0}):
        tensors, cap, worig = wide_batch(pool, 300, text, **props)
        p = {"lc": 3, "lp": 0, "pb": 2, **props}
        w, w_out, w_ok = compare(G, tensors, cap, device, **p)
        w["props"] = p
        # the launcher's geometry: lanes spread over the SMs, one model each
        per_block = -(-w["lanes"] // torch.cuda.get_device_properties(
            device).multi_processor_count)
        w["smem_per_block"] = per_block * 2 * (
            (S.num_probs(p["lc"], p["lp"]) + 7) & ~7)
        w["originals_equal"] = bool(w_ok.all()) and all(
            w_out[li, :len(o)].numpy().tobytes() == o
            for li, o in enumerate(worig))
        w["pass"] = (w["out_equal"] and w["ok_equal"]
                     and w["consumed_equal"] and w["originals_equal"])
        res["wide"].append(w)
        res["max_abs_err"] = max(res["max_abs_err"], w["max_abs_err"])
        res["pass"] = res["pass"] and w["pass"]
        text = text[sum(len(o) for o in worig):]
    return res


def parse_groups(pool, datas, sub_size: int, dict_size: int = 1 << 16,
                 **props):
    """Each of ``datas`` fast-parsed alone as one dict-reset group by the
    port's native runtime: [(ops, chunk table, native bodies)]."""
    from lzma_sdk_zliblike_tpu_torch import native
    return list(pool.map(lambda d: native.lzma2_group_ops(
        d, dict_size, sub_size=sub_size, **props), datas))


def encode_compare(R, batch, out_cap: int, device, **props):
    """K2 on CUDA copies of a CPU batch against the plain version on it:
    bodies, tab and status must be identical (tolerance 0: the coder is
    bit-exact).  Also returns the kernel's outputs on the CPU."""
    import torch
    t = time.perf_counter()
    plain = R.range_encode_plain(*batch, out_cap, **props)
    plain_ms = (time.perf_counter() - t) * 1e3
    h = R.submit_encode_groups(*[x.to(device) for x in batch],
                               out_cap=out_cap, **props)
    kern = [x.cpu() for x in (h.bodies, h.tab, h.status)]
    res = {"lanes": int(batch[0].shape[0]),
           "bodies_equal": bool(torch.equal(kern[0], plain[0])),
           "tab_equal": bool(torch.equal(kern[1], plain[1])),
           "status_equal": bool(torch.equal(kern[2], plain[2])),
           "max_abs_err": int((kern[0].int() - plain[0].int()).abs().max()),
           "plain_ms": plain_ms}
    return res, kern


def native_equal(parsed, kern, lanes) -> bool:
    """The listed lanes are ok, and their bodies and tab equal the native
    coder's."""
    bodies, tab, status = kern
    return all(
        int(status[0, li]) == 1 and int(status[1, li]) == len(p[2])
        and bodies[li, :len(p[2])].numpy().tobytes() == p[2]
        and tab[li, :len(p[1])].tolist() == p[1][:, 2].tolist()
        for li, p in ((li, parsed[li]) for li in lanes))


def time_encode_kernel(R, tensors, out_cap: int, reps: int, **props) -> float:
    """Mean ms of one K2 launch on resident inputs, by CUDA events."""
    import torch
    R.submit_encode_groups(*tensors, out_cap=out_cap, **props)   # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        R.submit_encode_groups(*tensors, out_cap=out_cap, **props)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def encode_kernel_vs_plain(pool, device, data: bytes) -> dict:
    from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
    from lzma_sdk_zliblike_tpu_torch.parallel import device_encode as DE
    cm = corpus_module()
    text = cm.big_mixed(1 << 20, seed=3)
    datas, a = [], 0
    for i in range(16):                     # 4-30 KB of text
        datas.append(text[a:a + 4096 + 1700 * i])
        a += len(datas[-1])
    datas += [bytes(20000), cm.x86_like(3000)]
    good = list(range(len(datas)))
    parsed = parse_groups(pool, datas, 4096)
    # a lane of random bytes whose body does not fit out_cap
    out_cap = max(len(p[2]) for p in parsed) + 512
    over = len(datas)
    parsed += parse_groups(pool, [cm.random_bytes(out_cap + 4096, seed=8)],
                           4096)
    ops, ends, act, _, _ = R.pack_ops_batch(            # + an inactive lane
        [p[0] for p in parsed] + [[]], [p[1] for p in parsed] + [[]])
    res, kern = encode_compare(R, (ops, ends, act), out_cap, device)
    st = kern[2]
    res.update({
        "out_cap": out_cap, "chunks_max": max(len(p[1]) for p in parsed),
        "ops_max": max(len(p[0]) // 2 for p in parsed),
        "native_equal": native_equal(parsed, kern, good),
        "overflow_lane_failed_alone": (
            st[:, over].tolist() == [0, out_cap, R.ERR_OVERFLOW]
            and all(int(st[0, li]) == 1 for li in good)),
        "inactive_lane": st[:, over + 1].tolist(),
        "kernel_ms": time_encode_kernel(
            R, [x.to(device) for x in (ops, ends, act)], out_cap, reps=3)})
    res["pass"] = (res["bodies_equal"] and res["tab_equal"]
                   and res["status_equal"] and res["native_equal"]
                   and res["overflow_lane_failed_alone"]
                   and res["inactive_lane"] == [1, 0, 0]
                   and res["chunks_max"] > 1)
    # more than 2 x 132 lanes at lc+lp=4: blocks of 3 lanes need the raised
    # dynamic shared-memory limit
    props = {"lc": 0, "lp": 4, "pb": 0}
    datas, a = [], 0
    for i in range(300):
        datas.append(text[a:a + 1024 + i * 37 % 2048])
        a += len(datas[-1])
    parsed = parse_groups(pool, datas, 1 << 16, **props)
    ops, ends, act, cap, _ = R.pack_ops_batch([p[0] for p in parsed],
                                              [p[1] for p in parsed])
    w, kern = encode_compare(R, (ops, ends, act), cap, device, **props)
    w["props"] = props
    w["native_equal"] = native_equal(parsed, kern, range(len(parsed)))
    w["pass"] = (w["bodies_equal"] and w["tab_equal"] and w["status_equal"]
                 and w["native_equal"])
    res["wide"] = w
    # the main path's shapes: prefixes of its first groups (``data``), with
    # its dictionary and chunk size, into a buffer of its out_cap.  The plain
    # version takes a few ms per op of the longest lane, so each prefix is
    # cut to about 20,000 ops: group 1 starts with near-random bytes (one
    # literal per byte), group 2 with long repeats (389 ops in 100 KB)
    datas = [data[g * MIB:g * MIB + n] for g, n in enumerate(
        (160_000, 20_000, 100_000, 80_000, 160_000, 160_000))]
    parsed = parse_groups(pool, datas, DE.SUB_CHUNK, dict_size=MIB)
    ops, ends, act, _, _ = R.pack_ops_batch([p[0] for p in parsed],
                                            [p[1] for p in parsed])
    m, kern = encode_compare(R, (ops, ends, act), R.out_cap_for(MIB), device)
    m.update({"out_cap": R.out_cap_for(MIB),
              "chunks_max": max(len(p[1]) for p in parsed),
              "ops_max": max(len(p[0]) // 2 for p in parsed),
              "native_equal": native_equal(parsed, kern, range(len(parsed)))})
    m["pass"] = (m["bodies_equal"] and m["tab_equal"] and m["status_equal"]
                 and m["native_equal"] and m["chunks_max"] >= 3)
    res["main_shape"] = m
    for r in (w, m):
        res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
        res["pass"] = res["pass"] and r["pass"]
    return res


def encode_main(data: bytes, device) -> dict:
    """The encode path once, with the counters set to 0 just before; its
    step breakdown, kernel time and bound come from that run's trace, then
    its checks."""
    import torch
    from lzma_sdk_zliblike_tpu_torch import (encode_lzma2_device_coded,
                                             lzma2_uncompress)
    from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
    from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import encode_lzma2_mt
    from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
    R.launches = 0
    TRACE.reset()
    t = time.perf_counter()
    stream, prop = encode_lzma2_device_coded(data, dict_size=MIB,
                                             chunk_size=MIB, device=device)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    snap = TRACE.snapshot()
    launches = R.launches

    def timer_ms(name):
        return snap.get(name, {}).get("total_s", 0.0) * 1e3
    groups = -(-len(data) // MIB)
    res = {"bytes": len(data), "packed": len(stream), "seconds": sec,
           "mb_per_s": len(data) / sec / 1e6, "launches": launches,
           "batches": snap.get("device_encode.batches", 0),
           "host_groups": snap.get("device_encode.host_groups", 0),
           "device_lanes": snap.get("device_encode.lanes", 0),
           "ops_per_lane_max": snap.get("device_encode.ops_per_lane_max", 0),
           "kernel_ms": snap.get("range_encode.kernel_ms", 0.0),
           "breakdown_ms": {
               "parse": timer_ms("device_encode.parse"),
               "pack_and_host_to_device": timer_ms(
                   "device_encode.pack_and_host_to_device"),
               "wait_for_kernel": timer_ms("range_encode.wait"),
               "device_to_host": timer_ms("range_encode.device_to_host"),
               "frame_and_join": timer_ms("device_encode.frame_and_join")},
           "kernel_bytes": (snap.get("device_encode.kernel_bytes_read", 0)
                            + snap.get("range_encode.bytes_written", 0))}
    res["bound_ms"] = res["kernel_bytes"] / HBM_BYTES_PER_S * 1e3
    res["device_idle_share"] = 1 - res["kernel_ms"] / (sec * 1e3)
    t = time.perf_counter()
    ref, ref_prop = encode_lzma2_mt(data, dict_size=MIB, chunk_size=MIB)
    res["host_mt_seconds"] = time.perf_counter() - t
    res["equal_host_mt"] = stream == ref and prop == ref_prop
    res["lzma_module_roundtrip"] = lzma.decompress(
        stream, format=lzma.FORMAT_RAW,
        filters=[{"id": lzma.FILTER_LZMA2, "dict_size": MIB}]) == data
    res["k1_roundtrip"] = lzma2_uncompress(stream, prop, device=device) == data
    res["pass"] = (res["equal_host_mt"] and res["lzma_module_roundtrip"]
                   and res["k1_roundtrip"] and launches > 0
                   and res["device_lanes"] + res["host_groups"] == groups
                   and res["device_lanes"] > 0 and res["kernel_ms"] > 0)
    return res


def drive(stream: bytes, prop: int, data: bytes, device) -> dict:
    """One run of the main path with the counters set to 0 just before."""
    import torch
    from lzma_sdk_zliblike_tpu_torch import lzma2_uncompress
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
    G.launches = 0
    TRACE.reset()
    t = time.perf_counter()
    out = lzma2_uncompress(stream, prop, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    sec = time.perf_counter() - t
    snap = TRACE.snapshot()
    res = {"bytes": len(data), "packed": len(stream), "seconds": sec,
           "mb_per_s": len(data) / sec / 1e6, "launches": G.launches,
           "host_fallback_groups": snap.get("scheduler.host_fallback_groups", 0),
           "lane_retries": snap.get("scheduler.lane_retries", 0),
           "batches": snap.get("scheduler.pallas_batches", 0)
           + snap.get("scheduler.pallas_multi_batches", 0),
           "output_equal": out == data}
    res["pass"] = (res["output_equal"] and res["launches"] > 0
                   and res["host_fallback_groups"] == 0
                   and res["lane_retries"] == 0)
    return res


def main_breakdown(stream: bytes, device):
    """The main path's steps, run one at a time with a synchronise after
    each, timed on the host clock (ms).  Returns the batch's tensors on the
    card (for timing the kernel alone), its shape and the breakdown."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    from lzma_sdk_zliblike_tpu_torch.parallel.scheduler import (
        BatchedLzma2Decoder)
    from lzma_sdk_zliblike_tpu_torch.utils.memory import shape_for_groups
    ms = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now
    groups = framing.split_groups(framing.scan(stream)[0])
    shape = shape_for_groups(groups, device=device)
    if shape.n_lanes < len(groups):
        raise RuntimeError("the main path needed more than one batch")
    dec = BatchedLzma2Decoder(shape, device=device)
    lap("scan_and_shape")
    arrays = dec._assemble(stream, [[g] for g in groups], 1)
    lap("assemble")
    tensors = G.prep_groups(*arrays, device=device)
    lap("host_to_device")
    h = G.submit_groups(*tensors, dic_cap=shape.dic_cap)
    lap("kernel_wall")
    out, ok, _ = G.finalize_chunks(h, dic_cap=shape.dic_cap)
    lap("device_to_host")
    out = out.numpy()
    b"".join(out[li, :sum(c.unpack_size for c in g)].tobytes()
             for li, g in enumerate(groups))
    lap("join")
    return tensors, shape, ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from lzma_sdk_zliblike_tpu_torch.ops import _build
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    device = torch.device("cuda", 0)
    failed = []

    # -- 1. build ------------------------------------------------------------
    t = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t
    for name, log in _build.ptxas_logs.items():
        for line in log.splitlines():
            print(f"ptxas[{name}]: {line}")
    regs = {n: [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            for n, log in _build.ptxas_logs.items()}
    spills = {n: [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
              for n, log in _build.ptxas_logs.items()}
    emit({"phase": "build", "seconds": build_s, "libraries": libs,
          "registers": regs, "spill_store_bytes": spills, "pass": True})

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        # -- 2. kernel vs plain version ------------------------------------
        p2 = kernel_vs_plain(pool, device)
        emit({"phase": "kernel_vs_plain", **p2})
        if not p2["pass"]:
            failed.append("kernel_vs_plain")

        # -- data for phases 3 and 4 --------------------------------------
        t = time.perf_counter()
        data = corpus(128 * MIB)
        big = pool.submit(lzma2_group, data[:64 * MIB], 16 * MIB)
        stream, prop = lzma2_stream(pool.map(
            lambda a: lzma2_group(data[a:a + MIB], MIB),
            range(0, len(data), MIB)), MIB)
        big_stream, big_prop = lzma2_stream([big.result()], 16 * MIB)
    emit({"phase": "data", "seconds": time.perf_counter() - t,
          "main_packed": len(stream), "bigblock_packed": len(big_stream)})

    # -- 3. main: 128 MiB in 1 MiB groups ------------------------------------
    p3 = drive(stream, prop, data, device)
    tensors, shape, p3["breakdown_ms"] = main_breakdown(stream, device)
    p3["lanes"] = shape.n_lanes
    p3.update(time_kernel(G, tensors, shape.dic_cap, reps=3))
    p3["device_idle_share"] = 1 - p3["kernel_ms"] / (p3["seconds"] * 1e3)
    p3["bound_ms"] = bound_ms(int(tensors[1][:, -1].sum()), len(data))
    del tensors
    emit({"phase": "main", **p3})
    if not p3["pass"]:
        failed.append("main")

    # -- 3b. the same stream under a budget of 32 lanes: four batches --------
    from lzma_sdk_zliblike_tpu_torch.utils import memory
    os.environ["LZT_HBM_BUDGET"] = str(memory.decode_batch_hbm_bytes(
        32, shape.pack_cap, shape.dic_cap))
    p3b = drive(stream, prop, data, device)
    del os.environ["LZT_HBM_BUDGET"]
    p3b["pass"] = p3b["pass"] and p3b["batches"] == 4
    emit({"phase": "main_budget", **p3b})
    if not p3b["pass"]:
        failed.append("main_budget")

    # -- 4. big block: one 64 MiB group ---------------------------------------
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    p4 = drive(big_stream, big_prop, data[:64 * MIB], device)
    ch = framing.split_groups(framing.scan(big_stream)[0])
    p4["groups"] = len(ch)
    p4["chunks"] = sum(len(g) for g in ch)
    p4["bound_ms"] = bound_ms(sum(c.pack_size for g in ch for c in g),
                              64 * MIB)
    emit({"phase": "bigblock", **p4})
    if not p4["pass"]:
        failed.append("bigblock")

    # -- 5. encode kernel vs plain version ------------------------------------
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        p5 = encode_kernel_vs_plain(pool, device, data)
    emit({"phase": "encode_kernel_vs_plain", **p5})
    if not p5["pass"]:
        failed.append("encode_kernel_vs_plain")

    # -- 6. encode main: 128 MiB in 1 MiB groups ------------------------------
    p6 = encode_main(data, device)
    emit({"phase": "encode_main", **p6})
    if not p6["pass"]:
        failed.append("encode_main")

    emit({"kernels": [{
        "name": "group_decode (K1)", "route": "cuda",
        "source": "lzma_sdk_zliblike_tpu_torch/csrc/group_decode.cu",
        "replaces": "lzma_sdk_zliblike_tpu/ops/pallas_decode.py:236",
        "launches": p3["launches"], "matches_plain": p2["pass"],
        "max_abs_err": p2["max_abs_err"], "ms": p3["kernel_ms"],
        "plain_ms": p2["plain_ms"], "plain_batch_kernel_ms": p2["kernel_ms"],
        "bound_ms": p3["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "iterations_max": p3["iterations_max"],
        "bigblock_launches": p4["launches"]}, {
        "name": "range_encode (K2)", "route": "cuda",
        "source": "lzma_sdk_zliblike_tpu_torch/csrc/range_encode.cu",
        "replaces": "lzma_sdk_zliblike_tpu/ops/pallas_encode.py:78",
        "launches": p6["launches"], "matches_plain": p5["pass"],
        "max_abs_err": p5["max_abs_err"], "ms": p6["kernel_ms"],
        "plain_ms": p5["plain_ms"], "plain_batch_kernel_ms": p5["kernel_ms"],
        "bound_ms": p6["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ops_per_lane_max": p6["ops_per_lane_max"],
        "main_shape_plain_ms": p5["main_shape"]["plain_ms"]}]})
    print(smi[0])
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
