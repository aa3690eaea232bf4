#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's LZMA2 decode and encode paths, its host
and hybrid decode and encode engines, its xz container, its match finder,
its bit-call probes, its multi-process decode and encode (two ranks
sharing the card), its device CRC and batched filters, its one-call
raw-LZMA API and its 7z container and streaming decoders (on the GPU
host's CPU) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build: nvcc builds every kernel of the paths (``csrc/*.cu``: K1
   ``group_decode``, K2 ``range_encode``, P1 ``v12_probe``, P2
   ``compact_probe``, X3 ``checksum``, X4 ``device_filters``) for sm_90a;
   the ``-Xptxas -v``
   report (registers, shared memory, spills) is printed.
2. kernel vs plain: K1 on CUDA tensors against ``group_decode_plain`` on CPU
   copies of the same 16-lane batch (single- and multi-chunk groups, mid-group
   state resets, copy chunks, a group of more than 128 chunks, a lane of
   several groups, a corrupt lane), then two 300-lane batches of 1-3 KB
   groups (lc=3/lp=0 and lc=0/lp=4: three lanes per SM), then the
   many-lanes batch: 8 lanes per SM (1,056 on an H100) of 64 KiB groups cut
   from phase 3's data, one corrupted, where the launcher's dictionary
   window shrinks to a few KiB and matches that reach back further take the
   far path through ``out``; 8 rows of that launch, the corrupt lane among
   them, against the plain version on CPU copies of those lanes, every good
   lane against its original, and the whole batch timed.  out, ok and
   consumed must be identical
   (tolerance 0: the decoder is bit-exact), packets and bit calls equal on
   every lane that ends ok, and every good lane must equal its original
   bytes.
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
   lc=0/lp=4/pb=0; then 6 lanes at the main path's shapes: 20-160 KB
   prefixes of its first groups, parsed with its 1 MiB dictionary into
   48 KiB chunks (up to 4 per lane), coded into a buffer of its
   ``out_cap``.  Bodies, tab and status (ok, bytes, err, bit calls) must be
   identical (tolerance 0), and every good lane's bodies must equal the
   native coder's.  Then the many-lanes encode batch: 8 lanes per SM (1,056
   on an H100) of 64 KiB groups cut from phase 3's data with the main
   path's dictionary and chunks, one lane's op record corrupted near op
   1,000: timed, every good lane against the native bodies, the corrupt
   row against the plain version run on that lane alone.
6. encode main: ``encode_lzma2_device_coded(device="cuda")`` on the 128 MiB
   of phase 3 in 1 MiB groups with a 1 MiB dictionary.  The stream must
   equal ``encode_lzma2_mt``'s, decode to the original with Python's
   ``lzma`` and with the port's K1 (``lzma2_uncompress``), with K2 launches
   > 0 and every group coded on the card (the entry point raises on a lane
   that fails or whose bodies differ from the native coder's).  Its step
   breakdown, K2's time and the time of each of its three launches (walk,
   code, gather; CUDA events) and its longest lane's bit calls (status row
   4) are read from that run's trace counters; a fresh host parse of the
   same groups counts the bit calls of the longest lane (which must equal
   the kernel's) and of the longest chunk, for K2's chain bound.
7. probes: the bit-call microbenchmarks P1 (``tools/dev_v12_probe.py`` of
   the port, every variant at S = 32 and 128) and P2
   (``tools/compact_probe.py``, its four kernels on two seeds), each kernel
   on the card against its plain version on the CPU at a small ``iters``
   (tolerance 0: integer programs), then each tool's ``run`` at its own
   defaults (P1 20,000 iterations, P2 2,000; CUDA events, best of 3) with
   the launch counts set to 0 just before.  Their bounds count the int32
   (and, for mxu, f32) operations of each call from the kernel source over
   the SMs' INT32 (FP32) lanes at the card's maximum SM clock.
8. host engines, on phase 3's stream: ``engine="host"`` (host MT decode at
   every core, no K1 launch), ``engine="hybrid"`` at every core and at one
   host thread (``hybrid_1t``: K1's bytes must reach the output,
   ``hybrid.dev_bytes`` > 0), each equal to the original, with its MB/s
   beside phase 3's, its ``hybrid.*`` counters and the card's idle share
   (the K1 launches' CUDA-event times against the call's wall time); then
   ``hybrid_abort``: a ``progress`` callback that returns False at the
   third group must raise ``ProgressAborted`` and leave no non-daemon
   thread behind.
9. xz: the port's ``containers/xz.encode`` of phase 3's data (1 MiB
   dictionary and chunk, one block, crc64, every core), which Python's
   ``lzma`` must read back, and ``xz.decode(engine="device")`` of it and
   of a one-block image of 1 MiB from Python's ``lzma`` (one group over
   256 KiB): equal to the data, K1 launched, no group on the host.  Two
   steps of the first read are also timed alone: its LZMA2 payload through
   ``lzma2_uncompress`` and the CRC64 of the output.
10. hybrid encode: ``encode_lzma2_hybrid(device="cuda")`` of phase 3's data
   at ``encode_main``'s shape (1 MiB dictionary and chunk), at every core
   (``hybrid_encode``) and at one host thread (``hybrid_encode_1t``, where
   the card must code groups).  The stream must equal ``encode_lzma2_mt``'s
   and decode to the original with Python's ``lzma`` and with K1; MB/s
   beside ``encode_main``'s and the host MT encoder's, the
   ``hybrid_encode.*`` counters, K2's busy time and the card's idle share.
11. encode big block: ``encode_lzma2_device_coded`` of the first 64 MiB as
   one group with a 16 MiB dictionary, K2 on one lane, no group on the
   host.  The host encoder refuses groups over 2 MiB, so the stream is held
   against the host parse's native bodies framed as the host encoder frames
   them, and decoded with Python's ``lzma``; K2's time with its walk, code
   and gather split, its ops and bit calls.
12. X2 vs CPU: the match finder (``ops/match_find.py``, torch ops) on the
   card against the same function on the CPU, 4 lanes of 64 KiB (one short)
   and 1 lane of 2^17, at 24 + 12 and 3 + 2 candidates: every output
   identical (tolerance 0); then X2 alone at the encoder's batch (32 lanes
   of 64 KiB), timed by CUDA events, with its bytes bound.
13. device-assisted encode: ``encode_lzma2_device(device="cuda")`` of phase
   3's data at its defaults (64 KiB chunks, batches of 32 lanes): the stream
   must decode to the original with Python's ``lzma`` and with K1, and its
   first 4 MiB must give the same stream through X2 on the CPU; its size is
   set beside ``encode_lzma2_mt``'s at the same dictionary and chunk.
14. distributed decode: two ranks on ``cuda:0`` over Gloo
   (``run_local_cluster``; the inputs in a temporary directory) decode
   phase 3's stream with ``decode_groups_distributed`` at its defaults:
   rank 0's output must be the original, rank 1's None, each rank must
   launch K1 (counted and timed by CUDA events in the rank), with no host
   fallback or lane retry.  Each rank reports its groups, K1 ms, budget,
   gather ms, wall after ``initialize`` and idle share; MB/s beside
   phase 3's and ``host_mt``'s.  Then a copy of the stream with one byte
   corrupted in group 100, which rank 1 decodes (the native decoder must
   refuse the group too): both ranks must raise DataError within 120 s.
15. distributed encode: two ranks encode phase 3's data with
   ``encode_groups_distributed`` (1 MiB dictionary and chunk, each rank on
   half the cores); every rank's stream must equal phase 6's
   ``encode_lzma2_mt`` stream (SHA-256), MB/s beside the host MT
   encoder's.
16. dry run: ``entry.dryrun_multichip(2)`` on ``cuda:0`` (each rank's
   sharded K1 lanes against the plain version, the 2-axis mesh, sharded X2
   against one call on the CPU, a distributed encode round trip) and
   ``entry()``'s K1 call on the card, each lane against its original.
17. checksum_device: X3 (``ops/checksum.py``, ``csrc/checksum.cu``) at
   sizes 0 to 1 MiB and two init values each, equal to ``binascii.crc32``
   and ``native.crc64``, its block states and combine equal to the plain
   versions on CPU copies; then CRC64 and CRC32 of the 128 MiB on the card
   (counted), the kernels timed by CUDA events, the whole call and the
   hosts' CRCs on the host clock; bound: the bytes at 3.35 TB/s.
18. device_filters: X4 (``ops/device_filters.py``, ``csrc/device_filters.cu``
   for x86 and BCJ2): the eight functions on the card against their plain
   versions on CPU copies and the host's ``ops/filters.py`` on the batches
   of tests/torch_filter_batches.py (salted, x86 edge and past-the-row
   lanes, BCJ2 with truncated streams and lengths past the rows), round
   trips; then one lane per SM of 1 MiB of ``x86_like``: x86 encode and
   decode and BCJ2 decode of ``bcj2_encode``'s streams, counted and timed,
   every row equal to the plain version's on CPU copies of its lane (three
   worker processes), to the host's encode and to the input.
19. one_call: ``lzma2_compress`` of the 128 MiB (1 MiB dictionary and
   chunk, every core) and ``lzma2_uncompress`` of it on the card (K1
   launched), ``compress``/``uncompress`` of 8 MiB at level 5 (read back by
   Python's ``lzma``), a ``.lzma86`` round trip of 4 MiB, and
   ``lzma2_compress_stream`` fed in 1 MiB pieces equal to one piece.
20. sevenzip (the host's CPU, no kernel): ``sevenzip.write`` of four
   archives with encoded headers (the writer takes one method and one
   pre-filter an archive): 16 MiB of phase 3's data in 8 files and an
   empty file (solid LZMA2), 8 MiB of ``x86_like`` (LZMA2 + BCJ), 2 MiB
   (LZMA + BCJ2) and 2 MiB of ``english_like`` (PPMd); each extracted with
   ``extract`` and with ``extract_streaming`` (which must refuse the PPMd
   folder, as the JAX package's does), every file equal to its original;
   the growth of peak RSS (``/proc/self/statm`` read every millisecond) of
   ``extract_streaming`` and of ``extract`` over the first three
   archives, each in a fresh interpreter, the first under half the
   second; the solid archive carved out of a 1 MiB host file;
   phase 9's xz image through ``XzStreamDecoder`` in 64 KiB pieces and
   phase 3's stream through ``decompressobj("lzma2")`` in 1 MiB pieces,
   each equal to the data, MB/s beside phase 9's and phase 3's.

Decode streams are made with Python's ``lzma`` module (raw LZMA2, preset 6),
one compression per group, so the original bytes are the ground truth.
Phases 3 and 4 require output == original, K1 launches > 0, and no host
fallback or lane retry.  The last line is the device summary; the line
before the nvidia line lists the kernels with their launches, times and
bounds (K1 has two: the bytes bound and the chain bound, the longest lane's
bit calls at the pure-ALU cost of a dependent call that phase 7 measured,
P1 ``lane-notr``, with the window and blocks per SM that its launcher chose
on phase 3; K2 has the bytes bound, which leaves out the scratch of its own
design, and a chain bound, an estimate: the larger of its longest lane's ops
at P1 ``lane``'s cost of a dependent shared-memory update and its longest
chunk's bit calls at ``lane-notr``'s; X3 and X4's two kernels have their
bytes bounds, measured on phases 17 and 18, which alone launch them).  Any
failure exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import importlib.util
import json
import lzma
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

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
            "iterations_total": int(h.iterations.long().sum()),
            "bit_calls_max": int(h.bit_calls.max()),
            "bit_calls_total": int(h.bit_calls.long().sum())}


def lane_notr_ns(p1_runs) -> float:
    """ns of one dependent range-coder bit call as a pure ALU chain on this
    card: the least of P1's lane-notr runs (us per iteration of 28 calls)."""
    return min(r["ns_per_call"] for r in p1_runs
               if r["variant"] == "lane-notr")


def results(h) -> list:
    """A K1 launch's (out, ok, consumed, packets, bit calls), on the CPU."""
    return [x.cpu() for x in (h.out, h.ok, h.consumed, h.iterations,
                              h.bit_calls)]


def agree(kern, plain, plain_ms: float) -> dict:
    """K1's results against the plain version's on the same lanes: out, ok
    and consumed must be identical (tolerance 0: the decoder is bit-exact),
    packets and bit calls on every lane that ends ok."""
    import torch
    k_out, k_ok, k_cons, k_it, k_bits = kern
    p_out, p_ok, p_cons, p_it, p_bits = plain
    good = p_ok != 0
    return {"lanes": len(k_ok),
            "out_equal": bool(torch.equal(k_out, p_out)),
            "ok_equal": bool(torch.equal(k_ok, p_ok)),
            "consumed_equal": bool(torch.equal(k_cons, p_cons)),
            "counts_equal": bool(torch.equal(k_it[good], p_it[good])
                                 and torch.equal(k_bits[good], p_bits[good])),
            "max_abs_err": int((k_out.int() - p_out.int()).abs().max()),
            "plain_ms": plain_ms}


def timed_plain(G, tensors, dic_cap, lc=3, lp=0, pb=2):
    """The plain version on CPU tensors and its ms on the host clock."""
    t = time.perf_counter()
    plain = G.group_decode_plain(*tensors, dic_cap, lc, lp, pb)
    return plain, (time.perf_counter() - t) * 1e3


def compare(G, tensors, dic_cap, device, lc=3, lp=0, pb=2):
    """K1 on CUDA copies of a CPU batch against the plain version on it
    (``agree``).  Also returns the kernel's out and ok."""
    plain, plain_ms = timed_plain(G, tensors, dic_cap, lc, lp, pb)
    kern = results(G.submit_groups(*[x.to(device) for x in tensors],
                                   dic_cap=dic_cap, lc=lc, lp=lp, pb=pb))
    return agree(kern, plain, plain_ms), kern[0], kern[1]


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


def many_lanes(pool, device, data: bytes) -> dict:
    """8 lanes per SM of 64 KiB groups cut from ``data``, one corrupted:
    every good lane must equal its original with ok set and consumed equal
    to its packed size, the corrupt lane must fail alone, and 8 rows of the
    launch, the corrupt lane among them, must equal the plain version on
    CPU copies of those lanes (lanes are independent; the plain version of
    all of them would take many minutes).  The launcher's window is a few
    KiB here, below the 64 KiB dictionary, so matches that reach back
    further take the far path through ``out`` and the ring wraps."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    from lzma_sdk_zliblike_tpu_torch.parallel.scheduler import (
        BatchedLzma2Decoder, BatchShape)
    n = 8 * torch.cuda.get_device_properties(device).multi_processor_count
    size = 64 << 10
    origs = [data[i * size:(i + 1) * size] for i in range(n)]
    stream, _ = lzma2_stream(pool.map(lambda d: lzma2_group(d, size), origs),
                             size)
    groups = framing.split_groups(framing.scan(stream)[0])
    # rounded to 4 KiB as shape_for_groups rounds it on the decode path
    pack_cap = -(-max(sum(c.pack_size for c in g) for g in groups)
                 // 4096) * 4096
    dec = BatchedLzma2Decoder(BatchShape(n_lanes=n, pack_cap=pack_cap,
                                         dic_cap=size), device="cpu")
    src, pe, ue, fl, act = (torch.from_numpy(a) for a in
                            dec._assemble(stream, [[g] for g in groups], 1))
    bad = n // 2 + 3
    src[bad, int(pe[bad, -1]) // 2] ^= 0x55
    tensors = (src, pe, ue, fl, act)
    resident = [x.to(device) for x in tensors]
    kern = results(G.submit_groups(*resident, dic_cap=size))
    k_out, k_ok, k_cons, k_it, _ = kern
    good = [li for li in range(n) if li != bad]
    res = {"lanes": n, "dic_cap": size, "pack_cap": pack_cap,
           "geometry": G.launch_geometry(n, size, device=device),
           "originals_equal": all(
               bool(k_ok[li]) and int(k_cons[li]) == int(pe[li, -1])
               and k_out[li].numpy().tobytes() == origs[li] for li in good),
           "corrupt_lane_failed_alone": not bool(k_ok[bad])}
    # the plain version's time follows the subset's longest lane, so the 7
    # good lanes are spread over the lower half by packets: text lanes, with
    # the most far matches (a lane of near-random bytes is ~65,000 literals)
    half = sorted(good, key=lambda li: int(k_it[li]))[:len(good) // 2]
    subset = sorted([bad] + half[::len(half) // 7][:7])
    plain, plain_ms = timed_plain(
        G, [x[subset].contiguous() for x in tensors], size)
    sub = agree([x[subset] for x in kern], plain, plain_ms)
    res["subset"] = {"lanes": subset, **sub}
    res.update(time_kernel(G, resident, size, reps=3))
    res["bound_ms"] = bound_ms(int(pe[:, -1].sum()), n * size)
    res["pass"] = (res["originals_equal"] and res["corrupt_lane_failed_alone"]
                   and sub["out_equal"] and sub["ok_equal"]
                   and sub["consumed_equal"] and sub["counts_equal"])
    return res


def kernel_vs_plain(pool, device, data: bytes) -> dict:
    import torch
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
                   and res["consumed_equal"] and res["counts_equal"]
                   and res["originals_equal"]
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
        w["geometry"] = G.launch_geometry(w["lanes"], cap, p["lc"], p["lp"],
                                          device)
        w["originals_equal"] = bool(w_ok.all()) and all(
            w_out[li, :len(o)].numpy().tobytes() == o
            for li, o in enumerate(worig))
        w["pass"] = (w["out_equal"] and w["ok_equal"]
                     and w["consumed_equal"] and w["counts_equal"]
                     and w["originals_equal"])
        res["wide"].append(w)
        res["max_abs_err"] = max(res["max_abs_err"], w["max_abs_err"])
        res["pass"] = res["pass"] and w["pass"]
        text = text[sum(len(o) for o in worig):]
    res["many_lanes"] = m = many_lanes(pool, device, data)
    res["max_abs_err"] = max(res["max_abs_err"], m["subset"]["max_abs_err"])
    res["pass"] = res["pass"] and m["pass"]
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
            st[:3, over].tolist() == [0, out_cap, R.ERR_OVERFLOW]
            and all(int(st[0, li]) == 1 for li in good)),
        "inactive_lane": st[:, over + 1].tolist(),
        "kernel_ms": time_encode_kernel(
            R, [x.to(device) for x in (ops, ends, act)], out_cap, reps=3)})
    res["pass"] = (res["bodies_equal"] and res["tab_equal"]
                   and res["status_equal"] and res["native_equal"]
                   and res["overflow_lane_failed_alone"]
                   and res["inactive_lane"] == [1, 0, 0, 0]
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
    res["many_lanes"] = ml = encode_many_lanes(pool, device, data)
    for r in (w, m, ml):
        res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
        res["pass"] = res["pass"] and r["pass"]
    return res


def encode_many_lanes(pool, device, data: bytes) -> dict:
    """K2 on 8 lanes per SM of 64 KiB groups cut from ``data``, parsed with
    the main path's 1 MiB dictionary and 48 KiB chunks, one lane's op record
    corrupted near op 1,000 of its first chunk: every good lane's bodies must
    equal the native coder's, and the corrupt row of the timed launch must
    equal the plain version run on that lane alone (tolerance 0; the plain
    run stops at the bad op, so it is short).  Blocks of one warp: 8 walks
    share an SM, and each lane's two chunks code in parallel."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
    from lzma_sdk_zliblike_tpu_torch.parallel import device_encode as DE
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n, size = 8 * sms, 64 << 10
    parsed = parse_groups(pool, [data[i * size:(i + 1) * size]
                                 for i in range(n)], DE.SUB_CHUNK,
                          dict_size=MIB)
    ops, ends, act, out_cap, _ = R.pack_ops_batch([p[0] for p in parsed],
                                                  [p[1] for p in parsed])
    bad = n // 2 + 5
    assert int(ends[bad, 0]) > 2002
    ops[bad, 2000] = 1 | (1 << 4)           # op 1,000: a match of length 1
    resident = [x.to(device) for x in (ops, ends, act)]
    R.launches = 0
    kernel_ms = time_encode_kernel(R, resident, out_cap, reps=3)
    h = R.submit_encode_groups(*resident, out_cap=out_cap)
    kern = [x.cpu() for x in (h.bodies, h.tab, h.status)]
    good = [li for li in range(n) if li != bad]
    t = time.perf_counter()
    plain = R.range_encode_plain(ops[bad:bad + 1], ends[bad:bad + 1],
                                 act[bad:bad + 1], out_cap)
    plain_ms = (time.perf_counter() - t) * 1e3
    row = [kern[0][bad:bad + 1], kern[1][bad:bad + 1], kern[2][:, bad:bad + 1]]
    res = {"lanes": n, "lanes_per_sm": n // sms, "group_bytes": size,
           "out_cap": out_cap, "chunks_max": int(ends.shape[1]),
           "ops_max": max(len(p[0]) // 2 for p in parsed),
           "kernel_ms": kernel_ms, "launches": R.launches,
           "native_equal": native_equal(parsed, kern, good),
           "corrupt_lane": bad, "corrupt_status": kern[2][:, bad].tolist(),
           "corrupt_row_equal": all(torch.equal(a, b)
                                    for a, b in zip(row, plain)),
           "max_abs_err": int((row[0].int() - plain[0].int()).abs().max()),
           "plain_ms": plain_ms}
    res["pass"] = (res["native_equal"] and res["corrupt_row_equal"]
                   and res["corrupt_status"][2] == R.ERR_OP
                   and res["launches"] == 5)
    return res


def encode_main(data: bytes, device) -> tuple[dict, bytes]:
    """The encode path once, with the counters set to 0 just before; its
    step breakdown, kernel time and bound come from that run's trace, then
    its checks.  Also returns the host MT encoder's stream of ``data``."""
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
           "launch_ms": {step: snap.get(f"range_encode.{step}_ms", 0.0)
                         for step in R.STEPS},
           "bit_calls_max": snap.get("range_encode.bit_calls_max", 0),
           "breakdown_ms": {
               "parse": timer_ms("device_encode.parse"),
               "pack_and_host_to_device": timer_ms(
                   "device_encode.pack_and_host_to_device"),
               "wait_for_kernel": timer_ms("range_encode.wait"),
               "device_to_host": timer_ms("range_encode.device_to_host"),
               "frame_and_join": timer_ms("device_encode.frame_and_join")},
           "kernel_bytes": (snap.get("device_encode.kernel_bytes_read", 0)
                            + snap.get("range_encode.bytes_written", 0))}
    res["device_idle_share"] = 1 - res["kernel_ms"] / (sec * 1e3)
    res.update(encode_counts(data, stream))
    # the bytes the function must move: op words and chunk ends read, bodies,
    # tab and status written (K2's own scratch traffic is its design's, not
    # the function's)
    res["bound_ms"] = res["kernel_bytes"] / HBM_BYTES_PER_S * 1e3
    t = time.perf_counter()
    ref, ref_prop = encode_lzma2_mt(data, dict_size=MIB, chunk_size=MIB)
    res["host_mt_seconds"] = time.perf_counter() - t
    res["host_mt_mb_per_s"] = len(data) / res["host_mt_seconds"] / 1e6
    res["equal_host_mt"] = stream == ref and prop == ref_prop
    res["lzma_module_roundtrip"] = lzma.decompress(
        stream, format=lzma.FORMAT_RAW,
        filters=[{"id": lzma.FILTER_LZMA2, "dict_size": MIB}]) == data
    res["k1_roundtrip"] = lzma2_uncompress(stream, prop, device=device) == data
    res["pass"] = (res["equal_host_mt"] and res["lzma_module_roundtrip"]
                   and res["k1_roundtrip"] and launches > 0
                   and res["bit_calls_max"] == res["host_bit_calls_max"]
                   and res["device_lanes"] + res["host_groups"] == groups
                   and res["device_lanes"] > 0 and res["kernel_ms"] > 0)
    return res, ref


def encode_counts(data: bytes, stream: bytes) -> dict:
    """What K2 had to do on the encode path, counted on the host from a
    fresh parse of the same groups (the parse is deterministic): ops and
    bit calls of the longest lane, bit calls of the longest chunk."""
    from lzma_sdk_zliblike_tpu_torch import native
    from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
    from lzma_sdk_zliblike_tpu_torch.parallel import device_encode as DE
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        parsed = list(pool.map(lambda a: native.lzma2_group_ops(
            data[a:a + MIB], DE.real_dict_size(DE.encode_dict_prop(MIB)),
            sub_size=DE.SUB_CHUNK), range(0, len(data), MIB)))
        parsed = [p for p in parsed if not DE.needs_copy_chunks(p[1])]

        def lane(p):
            calls = np.concatenate([[0], np.cumsum(R.op_bit_calls(p[0]))])
            per_chunk = np.diff(calls[np.concatenate([[0], p[1][:, 0] // 2])])
            return int(calls[-1]), int(per_chunk.max())
        counts = list(pool.map(lane, parsed))
    return {"host_bit_calls_max": max(c[0] for c in counts),
            "chunk_bit_calls_max": max(c[1] for c in counts),
            "ops_total": sum(len(p[0]) // 2 for p in parsed)}


P1_VARIANTS = ("broadcast", "masked", "fused2", "live3", "tailalways",
               "tailnever", "tailcond", "while", "whilecond", "lane",
               "lane-notr")
SEEDS = (12345, -7000000)
# the kernel-vs-plain size: 65 iterations reach whilecond's busy check at 64
CHECK_ITERS = 65
INT32_LANES, FP32_LANES = 64, 128      # per SM per clock (Hopper)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()
    return float(out[0]) * 1e6


def probes(device) -> tuple[dict, dict, dict]:
    """Phase 7: P1 and P2 against their plain versions, then each tool's
    ``run`` at its defaults with the launch counts set to 0 just before.
    Returns the phase line and the P1 and P2 entries of the kernels line."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.tools import compact_probe as C
    from lzma_sdk_zliblike_tpu_torch.tools import dev_v12_probe as V
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock = max_sm_clock_hz()
    int_rate, fp_rate = sms * INT32_LANES * clock, sms * FP32_LANES * clock

    def check(kernel, plain):
        t = time.perf_counter()
        want = plain()
        ms = (time.perf_counter() - t) * 1e3
        got = kernel().cpu()
        return int((got.long() - want.long()).abs().max()), ms
    res = {"sms": sms, "max_sm_clock_mhz": clock / 1e6,
           "check_iters": CHECK_ITERS, "checks": []}
    entries = {}
    for tag, cases in (
            ("P1", [(S, v) for S in (32, 128) for v in P1_VARIANTS]),
            ("P2", [(n, seed) for n in C.KERNELS for seed in SEEDS])):
        err = plain_ms = 0
        for a, b in cases:
            if tag == "P1":
                e, ms = check(
                    lambda: V.v12_probe(a, CHECK_ITERS, b, device=device),
                    lambda: V.v12_probe_plain(a, CHECK_ITERS, b))
            else:
                e, ms = check(
                    lambda: C.compact_probe(a, CHECK_ITERS, b, device=device),
                    lambda: C.compact_probe_plain(a, CHECK_ITERS, b))
            res["checks"].append([tag, a, b, e])
            err, plain_ms = max(err, e), plain_ms + ms
        entries[tag] = {"max_abs_err": err, "matches_plain": err == 0,
                        "plain_ms": plain_ms, "plain_iters": CHECK_ITERS}
    # the tools' main path: every variant, at the tools' own defaults
    V.launches = 0
    runs = [V.run(S, 20000, v) for S in (32, 128) for v in P1_VARIANTS]
    entries["P1"]["launches"] = V.launches
    for r in runs:
        r.pop("out")
        r["bound_ms"] = V.operations(r["S"], r["iters"], r["variant"],
                                     r["tail_runs"]) / int_rate * 1e3
    res["P1"] = runs
    C.launches = 0
    runs = [C.run(n, 2000) for n in C.KERNELS]
    entries["P2"]["launches"] = C.launches
    for r in runs:
        ops_int, ops_fp = C.operations(r["name"], r["iters"])
        r["bound_ms"] = max(ops_int / int_rate, ops_fp / fp_rate) * 1e3
    res["P2"] = runs
    for tag in ("P1", "P2"):
        e = entries[tag]
        e["ms"] = sum(r["ms"] for r in res[tag])
        e["bound_ms"] = sum(r["bound_ms"] for r in res[tag])
    res["pass"] = all(entries[t]["matches_plain"] and entries[t]["launches"]
                      > 0 for t in entries)
    return res, entries["P1"], entries["P2"]


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


def engine_run(stream: bytes, prop: int, data: bytes, **kw) -> dict:
    """One ``lzma2_uncompress`` call with the K1 count and the trace set to
    0 just before.  Each K1 launch is bracketed by CUDA events on its
    launch stream (the hybrid feeder's own), so the card's busy time is the
    sum of the kernels' times (the copies to and from the card are not in
    it) and the idle share is the rest of the call's wall time."""
    import torch
    from lzma_sdk_zliblike_tpu_torch import lzma2_uncompress
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
    marks, submit = [], G.submit_groups

    def timed_submit(*args, **kwargs):
        m = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        m[0].record()
        h = submit(*args, **kwargs)
        m[1].record()
        marks.append(m)
        return h
    G.submit_groups = timed_submit
    try:
        G.launches = 0
        TRACE.reset()
        t = time.perf_counter()
        out = lzma2_uncompress(stream, prop, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
    finally:
        G.submit_groups = submit
    snap = TRACE.snapshot()
    busy_ms = sum(a.elapsed_time(b) for a, b in marks)
    return {"bytes": len(data), "seconds": sec,
            "mb_per_s": len(data) / sec / 1e6, "launches": G.launches,
            "kernel_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (sec * 1e3),
            "host_fallback_groups": snap.get("scheduler.host_fallback_groups",
                                             0),
            "lane_retries": snap.get("scheduler.lane_retries", 0),
            "hybrid": {k.split(".", 1)[1]: v for k, v in snap.items()
                       if k.startswith("hybrid.")},
            "output_equal": out == data}


def host_engines(stream: bytes, prop: int, data: bytes, main_mb_s: float,
                 device) -> list:
    """The host MT engine, the hybrid engine at every core and at one host
    thread, and an abort of the hybrid engine at its third group, on the
    main stream.  Returns the phases' results, in that order."""
    import threading
    from lzma_sdk_zliblike_tpu_torch import lzma2_uncompress
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import (
        normalize_threads)
    from lzma_sdk_zliblike_tpu_torch.utils.errors import ProgressAborted
    n_groups = len(framing.split_groups(framing.scan(stream)[0]))
    host = engine_run(stream, prop, data, engine="host")
    host.update(cpu_count=os.cpu_count(),
                threads=normalize_threads(None, n_groups))
    host["pass"] = host["output_equal"] and host["launches"] == 0
    hyb = engine_run(stream, prop, data, engine="hybrid", device=device)
    hyb.update(threads=os.cpu_count(), main_mb_per_s=main_mb_s,
               host_mt_mb_per_s=host["mb_per_s"])
    hyb["pass"] = hyb["output_equal"] and hyb["launches"] > 0
    one = engine_run(stream, prop, data, engine="hybrid", device=device,
                     threads=1)
    one.update(threads=1, main_mb_per_s=main_mb_s,
               host_mt_mb_per_s=host["mb_per_s"])
    one["pass"] = (one["output_equal"] and one["launches"] > 0
                   and one["hybrid"].get("dev_bytes", 0) > 0)
    calls = []

    def stop_at_third(_in, _out):
        calls.append(_out)
        return len(calls) < 3
    G.launches = 0
    t = time.perf_counter()
    raised = None
    try:
        lzma2_uncompress(stream, prop, engine="hybrid", device=device,
                         progress=stop_at_third)
    except ProgressAborted as e:
        raised = type(e).__name__
    sec = time.perf_counter() - t
    left = [th.name for th in threading.enumerate()
            if th is not threading.main_thread() and not th.daemon]
    abort = {"seconds_to_raise": sec, "raised": raised,
             "launches": G.launches, "callbacks": len(calls),
             "non_daemon_threads_left": left,
             "pass": raised == "ProgressAborted" and not left}
    return [host, hyb, one, abort]


def xz_phase(data: bytes, device) -> tuple[dict, bytes]:
    """The port's xz writer on the main data (1 MiB dictionary and chunk,
    one block, crc64, every core), read back by Python's ``lzma`` and by
    the port's reader on the card; then a one-block image from Python's
    ``lzma`` (one group of 1 MiB) read on the card.  Returns the result and
    the image (phase 20 streams it)."""
    from lzma_sdk_zliblike_tpu_torch.containers import xz
    t = time.perf_counter()
    img = xz.encode(data, check="crc64", dict_size=MIB, chunk_size=MIB,
                    threads=os.cpu_count())
    enc_s = time.perf_counter() - t
    blocks = sum(len(i.blocks) for i in xz.read_backward(img))
    lzma_equal = lzma.decompress(img) == data
    run = xz_run(img, data, device)
    run["steps_ms"] = xz_steps(img, data, device)
    small = corpus(MIB)
    simg = lzma.compress(small, format=lzma.FORMAT_XZ)
    srun = xz_run(simg, small, device)
    res = {"packed": len(img), "blocks": blocks, "encode_seconds": enc_s,
           "encode_mb_per_s": len(data) / enc_s / 1e6,
           "python_lzma_equal": lzma_equal, **run, "liblzma_block": srun}
    res["pass"] = (lzma_equal and blocks == 1 and run["pass"]
                   and srun["pass"])
    return res, img


def xz_steps(img: bytes, data: bytes, device) -> dict:
    """Two steps of the reader, each alone on the host clock (ms): the
    block's LZMA2 payload through ``lzma2_uncompress`` on the card, and the
    CRC64 of the output; the rest of ``xz.decode`` is the container."""
    import torch
    from lzma_sdk_zliblike_tpu_torch import lzma2_uncompress
    from lzma_sdk_zliblike_tpu_torch.containers import xz
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    from lzma_sdk_zliblike_tpu_torch.utils.checksums import crc64
    blk = xz._parse_block_header(img, 12)
    payload = img[blk.data_off:framing.scan(img, blk.data_off)[1]]
    t = time.perf_counter()
    out = lzma2_uncompress(payload, blk.filters[-1].props[0], device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    crc64(out)
    t2 = time.perf_counter()
    if out != data:
        raise RuntimeError("the xz block's payload decoded wrong")
    return {"lzma2_uncompress": (t1 - t) * 1e3, "crc64": (t2 - t1) * 1e3}


def xz_run(img: bytes, data: bytes, device) -> dict:
    """``xz.decode(engine="device")`` of one image with the counts set to 0
    just before: equal to ``data``, K1 launched, no group on the host."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.containers import xz
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
    G.launches = 0
    TRACE.reset()
    t = time.perf_counter()
    out = xz.decode(img, engine="device", device=device)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    fallback = TRACE.snapshot().get("scheduler.host_fallback_groups", 0)
    res = {"seconds": sec, "mb_per_s": len(data) / sec / 1e6,
           "launches": G.launches, "host_fallback_groups": fallback,
           "output_equal": out == data}
    res["pass"] = out == data and G.launches > 0 and fallback == 0
    return res


def encode_run(fn, data: bytes, **kw) -> tuple[dict, bytes, int, dict]:
    """One encode call with the K2 count and the trace set to 0 just before:
    its wall time (host clock, with a synchronise), K2's launches and busy
    time (the CUDA events ``finalize_encode`` adds up) and the card's idle
    share (the rest of the wall time).  Returns (result, stream, prop,
    trace)."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
    from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
    R.launches = 0
    TRACE.reset()
    t = time.perf_counter()
    stream, prop = fn(data, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    snap = TRACE.snapshot()
    busy = snap.get("range_encode.kernel_ms", 0.0)
    return ({"bytes": len(data), "packed": len(stream), "seconds": sec,
             "mb_per_s": len(data) / sec / 1e6, "launches": R.launches,
             "kernel_busy_ms": busy,
             "device_idle_share": 1 - busy / (sec * 1e3)},
            stream, prop, snap)


def roundtrips(stream: bytes, prop: int, data: bytes, dict_size: int,
               device, k1: bool = True) -> dict:
    """Python's ``lzma`` (and, with ``k1``, the port's K1) decode ``stream``
    back to ``data``."""
    from lzma_sdk_zliblike_tpu_torch import lzma2_uncompress
    res = {"lzma_module_roundtrip": lzma.decompress(
        stream, format=lzma.FORMAT_RAW,
        filters=[{"id": lzma.FILTER_LZMA2, "dict_size": dict_size}]) == data}
    if k1:
        res["k1_roundtrip"] = lzma2_uncompress(stream, prop,
                                               device=device) == data
    return res


def hybrid_encode(data: bytes, ref: bytes, device, encode_mb_s: float,
                  host_mt_mb_s: float) -> list:
    """Phase 10: ``encode_lzma2_hybrid`` of the main data at
    ``encode_main``'s shape, at every core and at one host thread.  The
    stream must equal the host MT encoder's (``ref``) and decode to the
    original; at one thread the card must code groups."""
    from lzma_sdk_zliblike_tpu_torch import encode_lzma2_hybrid
    out = []
    for threads in (None, 1):
        res, stream, prop, snap = encode_run(
            encode_lzma2_hybrid, data, dict_size=MIB, chunk_size=MIB,
            threads=threads, device=device)
        res.update(threads=threads or os.cpu_count(),
                   encode_main_mb_per_s=encode_mb_s,
                   host_mt_mb_per_s=host_mt_mb_s,
                   hybrid_encode={k.split(".", 1)[1]: v
                                  for k, v in snap.items()
                                  if k.startswith("hybrid_encode.")},
                   equal_host_mt=stream == ref,
                   **roundtrips(stream, prop, data, MIB, device))
        res["pass"] = (res["equal_host_mt"] and res["lzma_module_roundtrip"]
                       and res["k1_roundtrip"])
        if threads == 1:
            res["pass"] = (res["pass"] and res["launches"] > 0
                           and res["hybrid_encode"].get("dev_groups", 0) > 0)
        out.append(res)
    return out


def encode_bigblock(data: bytes, device) -> dict:
    """Phase 11: ``encode_lzma2_device_coded`` of 64 MiB as one group with
    a 16 MiB dictionary, the encode twin of ``bigblock``.  The host encoder
    refuses groups over 2 MiB (``lzma2_encode_impl``), so the reference
    stream is the host parse's native bodies of the group, framed as the
    host encoder frames them; no group may go to the host."""
    from lzma_sdk_zliblike_tpu_torch import encode_lzma2_device_coded, native
    from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
    from lzma_sdk_zliblike_tpu_torch.parallel import device_encode as DE
    from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import encode_lzma2_mt
    from lzma_sdk_zliblike_tpu_torch.utils.errors import ParamError
    big, dsz = data[:64 * MIB], 16 * MIB
    res, stream, prop, snap = encode_run(
        encode_lzma2_device_coded, big, dict_size=dsz, chunk_size=len(big),
        device=device)
    res.update({
        "host_groups": snap.get("device_encode.host_groups", 0),
        "device_lanes": snap.get("device_encode.lanes", 0),
        "kernel_ms": snap.get("range_encode.kernel_ms", 0.0),
        "launch_ms": {step: snap.get(f"range_encode.{step}_ms", 0.0)
                      for step in R.STEPS},
        "ops": snap.get("device_encode.ops_per_lane_max", 0),
        "bit_calls": snap.get("range_encode.bit_calls_max", 0),
        "parse_ms": snap.get("device_encode.parse", {}).get("total_s", 0)
        * 1e3,
        "kernel_bytes": (snap.get("device_encode.kernel_bytes_read", 0)
                         + snap.get("range_encode.bytes_written", 0))})
    res["bound_ms"] = res["kernel_bytes"] / HBM_BYTES_PER_S * 1e3
    t = time.perf_counter()
    ops, tab, body = native.lzma2_group_ops(
        big, DE.real_dict_size(DE.encode_dict_prop(dsz)),
        sub_size=DE.SUB_CHUNK)
    ends = [0] + tab[:, 2].tolist()
    props_byte = (2 * 5 + 0) * 9 + 3        # (pb * 5 + lp) * 9 + lc
    ref = DE.frame_group([body[a:b] for a, b in zip(ends, ends[1:])], 0,
                         len(big), DE.SUB_CHUNK, props_byte) + b"\x00"
    res["reference_seconds"] = time.perf_counter() - t
    calls = np.concatenate([[0], np.cumsum(R.op_bit_calls(ops))])
    res.update(chunks=len(tab), host_bit_calls=int(calls[-1]),
               chunk_bit_calls_max=int(np.diff(
                   calls[np.concatenate([[0], tab[:, 0] // 2])]).max()),
               needs_copy_chunks=DE.needs_copy_chunks(tab),
               equal_native_framing=stream == ref,
               **roundtrips(stream, prop, big, dsz, device, k1=False))
    try:
        encode_lzma2_mt(big, dict_size=dsz, chunk_size=len(big))
        res["host_mt_refuses"] = None
    except ParamError as e:
        res["host_mt_refuses"] = f"ParamError: {e}"
    res["pass"] = (res["equal_native_framing"]
                   and res["lzma_module_roundtrip"] and res["launches"] > 0
                   and res["host_groups"] == 0 and res["device_lanes"] == 1
                   and res["bit_calls"] == res["host_bit_calls"])
    return res


def x2_bytes(lanes: int, L: int, n_cand: int, n_cand8: int) -> int:
    """Bytes X2's sorts must move for ``lanes`` x ``L`` positions: in each
    pass the key and the 4 payload words are read and written by the sort,
    then the position, best length, best distance and the pass's candidate
    distances by the sort back (int32 each)."""
    return lanes * L * 4 * 2 * ((5 + 3 + n_cand) + (5 + 3 + n_cand8))


def match_find_vs_cpu(data: bytes, device) -> dict:
    """Phase 12: X2 on the card against the same function on the CPU, for 4
    lanes of 64 KiB cut from the data (one with valid < L) and 1 lane of
    2^17, at the encoder's 24 + 12 candidates and the default 3 + 2: every
    output array identical (tolerance 0).  Then X2 alone on the card at the
    encoder's batch (32 lanes of 64 KiB), timed by CUDA events."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.ops import match_find as X2
    L = 64 << 10
    quad = np.stack([np.frombuffer(data[a:a + L], np.uint8)
                     for a in (0, 5 * MIB, 37 * MIB + 123, 90 * MIB)])
    one = np.frombuffer(data[70 * MIB:70 * MIB + (1 << 17)], np.uint8)[None]
    cases = []
    for name, rows, valid in (
            ("4x64KiB", quad, np.array([L, L, L - 12345, L], np.int32)),
            ("1x128KiB", one, np.array([1 << 17], np.int32))):
        for n_cand, n_cand8 in ((24, 12), (3, 2)):
            t = time.perf_counter()
            card = X2.find_matches(rows, valid, n_cand=n_cand,
                                   n_cand8=n_cand8, device=device)
            card_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            cpu = X2.find_matches(rows, valid, n_cand=n_cand,
                                  n_cand8=n_cand8, device="cpu")
            cpu_ms = (time.perf_counter() - t) * 1e3
            arrays = list(zip(card[:2] + card[2], cpu[:2] + cpu[2]))
            cases.append({
                "case": name, "candidates": [n_cand, n_cand8],
                "identical": all(np.array_equal(a, b) for a, b in arrays),
                "max_abs_err": max(int(np.abs(a.astype(np.int64) - b).max())
                                   for a, b in arrays),
                "card_ms_with_copies": card_ms, "cpu_ms": cpu_ms})
    lanes = 32
    rows = torch.from_numpy(np.frombuffer(data[:lanes * L], np.uint8)
                            .reshape(lanes, L).copy()).to(device)
    valid = torch.full((lanes,), L, dtype=torch.int32, device=device)

    def batch():
        return X2.find_matches_tensor(
            rows, valid, n_cand=24, n_cand8=12,
            hash_bits=X2.default_hash_bits(L))[2].permute(0, 2, 1).contiguous()
    batch()
    torch.cuda.synchronize()
    reps = 5
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.reset_peak_memory_stats(device)
    t0.record()
    for _ in range(reps):
        batch()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    res = {"cases": cases, "batch_lanes": lanes, "batch_L": L,
           "batch_ms": ms, "ms_per_mib": ms / (lanes * L / MIB),
           "batch_peak_bytes": torch.cuda.max_memory_allocated(device),
           "bound_ms": x2_bytes(lanes, L, 24, 12) / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": max(c["max_abs_err"] for c in cases)}
    res["pass"] = all(c["identical"] for c in cases)
    return res


def encode_device(data: bytes, device) -> dict:
    """Phase 13: ``encode_lzma2_device`` of the main data at its defaults
    (64 KiB chunks and dictionary, batches of 32 lanes): the stream must
    decode to the original with Python's ``lzma`` and with K1, and its
    first 4 MiB must give the same stream through X2 on the CPU.  Its size
    is set beside the host MT encoder's at the same dictionary and chunk."""
    from lzma_sdk_zliblike_tpu_torch import encode_lzma2_device
    from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import encode_lzma2_mt
    res, stream, prop, snap = encode_run(encode_lzma2_device, data,
                                         device=device)

    def total_ms(name):
        return snap.get(name, {}).get("total_s", 0.0) * 1e3
    res.update({
        "x2_batches": snap.get("device_encode.x2_batches", 0),
        "match_find_ms": total_ms("device_encode.match_find"),
        "x2_device_to_host_ms": total_ms("device_encode.x2_device_to_host"),
        "wait_for_host_coder_ms": total_ms(
            "device_encode.wait_for_host_coder"),
        "encode_ext_thread_ms": total_ms("device_encode.encode_ext"),
        "encode_ext_groups": snap.get("device_encode.encode_ext",
                                      {}).get("count", 0),
        "host_threads": os.cpu_count(),
        **roundtrips(stream, prop, data, 1 << 16, device)})
    res["device_idle_share"] = 1 - res["match_find_ms"] / (
        res["seconds"] * 1e3)
    head = data[:4 * MIB]
    t = time.perf_counter()
    res["first_4mib_cpu_equal"] = (
        encode_lzma2_device(head, device="cpu")
        == encode_lzma2_device(head, device=device))
    res["first_4mib_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    host, _ = encode_lzma2_mt(data, dict_size=1 << 16, chunk_size=1 << 16)
    res["host_mt_64k_seconds"] = time.perf_counter() - t
    res["host_mt_64k_packed"] = len(host)
    res["size_vs_host_mt"] = len(stream) / len(host)
    res["pass"] = (res["lzma_module_roundtrip"] and res["k1_roundtrip"]
                   and res["first_4mib_cpu_equal"] and res["x2_batches"] > 0)
    return res


# Phases 14-16 run their ranks with ``run_local_cluster``: fresh
# interpreters, rank r reading LOCAL_RANK = r, so that both share cuda:0.
# Each rank prints one line "RANK {json}".
RANK_HEADER = r"""
import hashlib, json, sys, time
import torch
from lzma_sdk_zliblike_tpu_torch.parallel import distributed as D
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
args = json.loads(sys.argv[1])
D.initialize()
world, rank = D.world_and_rank()
"""

DIST_DECODE = RANK_HEADER + r"""
stream = open(args["stream"], "rb").read()
marks, submit = [], G.submit_groups

def timed_submit(*a, **kw):
    m = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    m[0].record()
    h = submit(*a, **kw)
    m[1].record()
    marks.append(m)
    return h

G.submit_groups = timed_submit
G.launches = 0
TRACE.reset()
t = time.perf_counter()
out = D.decode_groups_distributed(stream, dict_prop=args["prop"],
                                  device="cuda")
torch.cuda.synchronize()
wall = time.perf_counter() - t
snap = TRACE.snapshot()
k1_ms = sum(a.elapsed_time(b) for a, b in marks)
print("RANK " + json.dumps({
    "rank": rank, "device": str(torch.cuda.current_device()),
    "groups": snap.get("distributed.groups", 0), "launches": G.launches,
    "k1_ms": k1_ms, "budget": snap.get("distributed.budget", 0),
    "lanes": snap.get("distributed.lanes", 0),
    "gather_ms": snap.get("distributed.gather", {}).get("total_s", 0) * 1e3,
    "wall_s": wall, "device_idle_share": 1 - k1_ms / (wall * 1e3),
    "host_fallback_groups": snap.get("scheduler.host_fallback_groups", 0),
    "lane_retries": snap.get("scheduler.lane_retries", 0),
    "output_sha256": None if out is None
    else hashlib.sha256(out).hexdigest()}), flush=True)
"""

DIST_CORRUPT = RANK_HEADER + r"""
from lzma_sdk_zliblike_tpu_torch.utils.errors import DataError
stream = open(args["stream"], "rb").read()
t = time.perf_counter()
try:
    D.decode_groups_distributed(stream, dict_prop=args["prop"], device="cuda")
except DataError as e:
    print("RANK " + json.dumps({"rank": rank, "raised": "DataError",
                                "seconds": time.perf_counter() - t,
                                "message": str(e)[:300]}), flush=True)
    sys.exit(3)
print("RANK " + json.dumps({"rank": rank, "raised": None}), flush=True)
"""

DIST_ENCODE = RANK_HEADER + r"""
data = open(args["data"], "rb").read()
t = time.perf_counter()
stream, prop = D.encode_groups_distributed(data, dict_size=args["mib"],
                                           chunk_size=args["mib"])
print("RANK " + json.dumps({
    "rank": rank, "seconds": time.perf_counter() - t, "prop": prop,
    "packed": len(stream), "stream_sha256": hashlib.sha256(stream).hexdigest(),
    "threads": TRACE.snapshot().get("distributed.encode_threads", 0)}),
    flush=True)
"""


def cluster(script: str, n: int, args: dict, timeout: float) -> tuple:
    """``script`` on ``n`` local ranks (``run_local_cluster``) with ``args``
    as JSON in ``sys.argv[1]``: (exit codes, each rank's RANK line or None,
    the tails of their outputs, the launcher's wall seconds)."""
    from lzma_sdk_zliblike_tpu_torch.parallel.distributed import (
        run_local_cluster)
    code = f"import sys; sys.argv[1:] = [{json.dumps(json.dumps(args))}]\n"
    t = time.perf_counter()
    runs = run_local_cluster(n, code + script, timeout=timeout)
    wall = time.perf_counter() - t
    lines = []
    for r in runs:
        found = [ln[5:] for ln in r.stdout.decode(errors="replace")
                 .splitlines() if ln.startswith("RANK ")]
        lines.append(json.loads(found[-1]) if found else None)
    tails = [r.stdout.decode(errors="replace")[-1500:] for r in runs]
    return [r.returncode for r in runs], lines, tails, wall


def distributed_decode(tmp: str, stream: bytes, prop: int, data: bytes,
                       main_mb_s: float, host_mt_mb_s: float) -> dict:
    """Phase 14: two ranks on cuda:0 decode phase 3's stream with
    ``decode_groups_distributed`` at its defaults: rank 0's output must be
    the original, each rank must launch K1, with no host fallback or lane
    retry.  Then a copy of the stream with one byte corrupted in group 100,
    which rank 1 decodes: both ranks must raise DataError within 120 s."""
    import hashlib
    from lzma_sdk_zliblike_tpu_torch import native
    from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
    from lzma_sdk_zliblike_tpu_torch.parallel.host_pool import group_span
    from lzma_sdk_zliblike_tpu_torch.utils.errors import DataError
    path = os.path.join(tmp, "stream")
    with open(path, "wb") as f:
        f.write(stream)
    rcs, ranks, tails, wall = cluster(
        DIST_DECODE, 2, {"stream": path, "prop": prop}, timeout=300)
    res = {"ranks": ranks, "exit_codes": rcs, "launcher_seconds": wall}
    good = all(r is not None for r in ranks)
    if good:
        dec_s = max(r["wall_s"] for r in ranks)
        res.update(bytes=len(data), seconds=dec_s,
                   mb_per_s=len(data) / dec_s / 1e6, main_mb_per_s=main_mb_s,
                   host_mt_mb_per_s=host_mt_mb_s,
                   launches=sum(r["launches"] for r in ranks),
                   output_equal=ranks[0]["output_sha256"]
                   == hashlib.sha256(data).hexdigest())
    else:
        res["tails"] = tails
    res["pass"] = (good and rcs == [0, 0] and res["output_equal"]
                   and ranks[1]["output_sha256"] is None
                   and all(r["launches"] > 0 and r["host_fallback_groups"] == 0
                           and r["lane_retries"] == 0 for r in ranks))
    # the corrupt copy: group 100 falls in rank 1's block of its batch
    lanes = ranks[1]["lanes"] if good else 0
    groups = framing.split_groups(framing.scan(stream)[0])
    c = groups[100][0]
    bad = bytearray(stream)
    bad[c.data_off + c.pack_size // 2] ^= 0x55
    bad = bytes(bad)
    try:
        start, end, size = group_span(bad, groups[100])
        native.lzma2_decode(bad[start:end] + b"\x00", prop, size_hint=size)
        detectable = False
    except DataError:
        detectable = True
    path = os.path.join(tmp, "corrupt")
    with open(path, "wb") as f:
        f.write(bad)
    del bad
    t = time.perf_counter()
    rcs, ranks, tails, _ = cluster(DIST_CORRUPT, 2,
                                   {"stream": path, "prop": prop},
                                   timeout=300)
    sec = time.perf_counter() - t
    c_ok = all(r is not None and r["raised"] == "DataError" for r in ranks)
    res["corrupt"] = {"group": 100, "lanes": lanes,
                      "dealt_to_rank": 100 % (2 * lanes) // lanes
                      if lanes else None,
                      "native_decoder_refuses": detectable,
                      "ranks": ranks, "exit_codes": rcs,
                      "launcher_seconds": sec,
                      "pass": detectable and c_ok and rcs == [3, 3]
                      and lanes > 0 and 100 % (2 * lanes) // lanes == 1
                      and all(r["seconds"] < 120 for r in ranks)
                      and "rank 1" in ranks[0]["message"]}
    if not res["corrupt"]["pass"]:
        res["corrupt"]["tails"] = tails
    res["pass"] = res["pass"] and res["corrupt"]["pass"]
    return res


def distributed_encode(tmp: str, data: bytes, ref_sha: str, ref_prop: int,
                       host_mt_mb_s: float) -> dict:
    """Phase 15: two ranks encode phase 3's data with
    ``encode_groups_distributed`` at a 1 MiB dictionary and chunk: every
    rank's stream must equal phase 6's ``encode_lzma2_mt`` stream (by
    SHA-256)."""
    path = os.path.join(tmp, "data")
    with open(path, "wb") as f:
        f.write(data)
    rcs, ranks, tails, wall = cluster(DIST_ENCODE, 2,
                                      {"data": path, "mib": MIB}, timeout=300)
    res = {"ranks": ranks, "exit_codes": rcs, "launcher_seconds": wall}
    good = all(r is not None for r in ranks)
    if good:
        sec = max(r["seconds"] for r in ranks)
        res.update(bytes=len(data), seconds=sec,
                   mb_per_s=len(data) / sec / 1e6,
                   host_mt_mb_per_s=host_mt_mb_s,
                   equal_host_mt=all(r["stream_sha256"] == ref_sha
                                     and r["prop"] == ref_prop
                                     for r in ranks))
    else:
        res["tails"] = tails
    res["pass"] = good and rcs == [0, 0] and res["equal_host_mt"]
    return res


def dryrun_phase(device) -> dict:
    """Phase 16: ``entry.dryrun_multichip(2)`` (two ranks on cuda:0: sharded
    K1 lanes against the plain version, the 2-axis mesh, sharded X2, a
    distributed encode round trip) and ``entry()`` on the card, each lane
    against its original."""
    from lzma_sdk_zliblike_tpu_torch import entry
    t = time.perf_counter()
    dry = entry.dryrun_multichip(2, device="cuda", timeout=600)
    res = {"seconds": time.perf_counter() - t, **dry}
    G = entry.G
    G.launches = 0
    fn, args = entry.entry(device=device)
    out, ok, _ = fn(*args)
    _, _, origs = entry.make_batch(8)
    res["entry"] = {"launches": G.launches, "lanes": len(origs),
                    "originals_equal": bool(ok.all()) and all(
                        out[i, :len(o)].numpy().tobytes() == o
                        for i, o in enumerate(origs))}
    res["pass"] = (res["launches"] > 0 and res["entry"]["originals_equal"]
                   and res["entry"]["launches"] == 1)
    return res


# -- phases 17-19: X3, X4 and the one-call raw-LZMA API ----------------------

CRC_SIZES = (0, 1, 63, 64, 65, 4097, MIB)
CRC_INITS = {32: 0xABCDEF, 64: 0x123456789A}
M64 = (1 << 64) - 1


def checksum_device(data: bytes, device) -> tuple[dict, dict]:
    """Phase 17: X3 (``ops/checksum.py``).  At every size of CRC_SIZES
    (data from a seed) and init values 0 and CRC_INITS, ``crc32_device`` /
    ``crc64_device`` on the card must equal ``binascii.crc32`` and the
    port's ``native.crc64``; the block states of the kernel must equal
    ``block_states_plain`` on CPU copies and the kernel's combine
    ``combine_plain`` (tolerance 0: integer programs).  Then 128 MiB of the
    corpus: both calls with the launch counts set to 0 just before (equal
    to the hosts'), the kernels alone by CUDA events (block states and
    combine, best of 3 after a warm-up), the whole call on the host clock
    (the pad, the copy to the card and the host fixup included) and the
    hosts' ``native.crc64`` / ``binascii.crc32`` on the same bytes.
    Returns the phase line and the X3 entry of the kernels line."""
    import binascii
    import torch
    from lzma_sdk_zliblike_tpu_torch import native
    from lzma_sdk_zliblike_tpu_torch.ops import checksum as C
    from lzma_sdk_zliblike_tpu_torch.tools import best_ms
    rng = np.random.default_rng(17)
    host = {32: binascii.crc32, 64: native.crc64}
    dev_fn = {32: C.crc32_device, 64: C.crc64_device}
    res = {"sizes": list(CRC_SIZES), "mismatches": [], "checks": 0}
    err = plain_ms = 0
    for n in CRC_SIZES:
        d = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        buf = torch.from_numpy(C.prep(d)[0])
        for width in (32, 64):
            for value in (0, CRC_INITS[width]):
                res["checks"] += 1
                if dev_fn[width](d, value, device=device) != \
                        host[width](d, value):
                    res["mismatches"].append([n, width, value])
            t = time.perf_counter()
            plain = C.block_states_plain(buf, width)
            plain_c = C.combine_plain(plain, width)
            if n == MIB:
                plain_ms += (time.perf_counter() - t) * 1e3
            kern = C.crc_blocks(buf.to(device), width)
            kern_c = C.crc_combine(kern, width)
            kern = kern.cpu()
            bad = kern != plain
            err = max([err, abs(kern_c - plain_c)] + [
                abs((a & M64) - (b & M64)) for a, b in
                zip(kern[bad].tolist(), plain[bad].tolist())])
    res["plain_ms_1mib"] = plain_ms
    # the main path: 128 MiB, each width once, counts from 0
    C.launches = C.combine_launches = 0
    walls = {}
    for width in (64, 32):
        t = time.perf_counter()
        got = dev_fn[width](data, device=device)
        walls[width] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        want = host[width](data)
        res[f"host_crc{width}_ms"] = (time.perf_counter() - t) * 1e3
        res[f"crc{width}_equal"] = got == want
    launches, combine_launches = C.launches, C.combine_launches
    buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    for width in (64, 32):
        res[f"crc{width}_call_ms"] = walls[width]
        res[f"crc{width}_kernel_ms"] = best_ms(
            lambda: C.crc_combine(C.crc_blocks(buf, width), width))
        res[f"crc{width}_blocks_ms"] = best_ms(
            lambda: C.crc_blocks(buf, width))
    res["bound_ms"] = len(data) / HBM_BYTES_PER_S * 1e3
    res["launches"], res["combine_launches"] = launches, combine_launches
    res["pass"] = (not res["mismatches"] and err == 0 and res["crc64_equal"]
                   and res["crc32_equal"] and launches == 2
                   and combine_launches > 0)
    entry = {"name": "checksum (X3)", "route": "cuda",
             "source": "lzma_sdk_zliblike_tpu_torch/csrc/checksum.cu",
             "replaces": "lzma_sdk_zliblike_tpu/ops/checksum.py:146",
             "launches": launches, "combine_launches": combine_launches,
             "matches_plain": err == 0 and not res["mismatches"],
             "max_abs_err": err, "ms": res["crc64_kernel_ms"],
             "crc32_ms": res["crc32_kernel_ms"],
             "plain_ms": plain_ms, "plain_bytes": MIB,
             "bound_ms": res["bound_ms"], "bound_by": "bytes",
             "library_ms": None, "host_crc64_ms": res["host_crc64_ms"],
             "call_ms": res["crc64_call_ms"]}
    return res, entry


def filter_batches():
    """tests/torch_filter_batches.py, the batches of the X4 tests, loaded by
    path like the corpus."""
    spec = importlib.util.spec_from_file_location(
        "lzt_filter_batches",
        os.path.join(REPO, "tests", "torch_filter_batches.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plain_job(name: str, args: list, kw: dict) -> tuple:
    """``ops/device_filters.<name>`` on CPU tensors of the numpy ``args``,
    run in a worker process of one thread: (its result as numpy, ms)."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.ops import device_filters as DF
    torch.set_num_threads(1)
    args = [torch.from_numpy(a) for a in args]
    t = time.perf_counter()
    out = getattr(DF, name)(*args, **kw)
    ms = (time.perf_counter() - t) * 1e3
    if isinstance(out, tuple):
        return [o.numpy() for o in out], ms
    return out.numpy(), ms


def max_err(a, b) -> int:
    """Largest absolute difference of two equal-shaped integer arrays."""
    if a.size == 0:
        return 0
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def device_filters(device) -> tuple[dict, list]:
    """Phase 18: X4 (``ops/device_filters.py``).  Each of the eight
    functions on the card against its plain version on CPU copies
    (tolerance 0) and the host's ``ops/filters.py`` per lane, on the salted
    batch of tests/torch_filter_batches.py at both directions, with encode
    then decode round-tripping; delta at distances 1, 4 and 255; x86 also
    on the batch's edge and past-the-row lanes.  BCJ2 on the corpus lanes
    and the six edge lanes (truncated rc, call, jump and main streams, a
    short out_size), on the past-the-row lanes and on main streams that end
    on a site in their rows' last byte: ``ok`` flag for flag and ``out`` on
    every ok lane equal to the plain version's, the corpus lanes
    equal to their originals.  Then the wide batches, one lane per SM of 1
    MiB of ``x86_like`` (8 distinct lanes, repeated): x86 encode and decode
    and BCJ2 decode of ``bcj2_encode``'s streams, with the launch counts set
    to 0 just before; every row equal to the plain version's on CPU copies
    of its distinct lane (run in three worker processes while the rest of
    the phase runs; the decode's input is the host's encode, which must
    equal the kernel's), to the host's ``x86_convert`` and to the input;
    each kernel timed by CUDA events on them (best of 3 after a warm-up),
    bound by its bytes.  Returns the phase line and the two X4 entries of
    the kernels line."""
    import multiprocessing
    import torch
    from lzma_sdk_zliblike_tpu_torch.ops import device_filters as DF
    from lzma_sdk_zliblike_tpu_torch.ops import filters as F
    from lzma_sdk_zliblike_tpu_torch.tools import best_ms
    cm, FB = corpus_module(), filter_batches()
    res = {"checks": [], "mismatches": []}
    err = {"x86": 0, "bcj2": 0}
    # the wide batches' inputs, and their plain versions started at once
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    distinct = [cm.x86_like(MIB, seed=60 + i) for i in range(8)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        refs = list(pool.map(lambda d: F.x86_convert(d, 0, True)[0],
                             distinct))
        streams, lens, out_size, _ = FB.bcj2_lanes(
            distinct, F.bcj2_encode, edge=False, map_fn=pool.map)
    rows8 = np.stack([np.frombuffer(d, np.uint8) for d in distinct])
    refs8 = np.stack([np.frombuffer(d, np.uint8) for d in refs])
    valid8 = np.full(8, MIB, np.int32)
    ip8 = np.zeros(8, np.int64)
    bcj2_8 = [x for a, n in zip(streams, lens) for x in (a, n)] + [out_size]
    procs = concurrent.futures.ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"))
    with procs:
        jobs = {
            "x86_enc": procs.submit(plain_job, "x86_convert_plain",
                                    [rows8, valid8, ip8], {"encoding": True}),
            "x86_dec": procs.submit(plain_job, "x86_convert_plain",
                                    [refs8, valid8, ip8], {"encoding": False}),
            "bcj2": procs.submit(plain_job, "bcj2_decode_plain", bcj2_8, {})}
        small = device_filters_small(device, FB, res, err)
        # the wide batches on the card: the main path of X4
        rows = np.stack([rows8[i % 8] for i in range(sms)])
        wide = torch.from_numpy(rows).to(device)
        valid = torch.full((sms,), MIB, dtype=torch.int32, device=device)
        ip = torch.zeros(sms, dtype=torch.int64, device=device)
        lane_of = torch.arange(sms, device=device) % 8
        bargs = [torch.from_numpy(a).to(device)[lane_of].contiguous()
                 for a in bcj2_8]
        DF.launches["x86"] = DF.launches["bcj2"] = 0
        enc = DF.x86_convert_batch(wide, valid, ip, encoding=True)
        dec = DF.x86_convert_batch(enc, valid, ip, encoding=False)
        b_out, b_ok = DF.bcj2_decode_batch(*bargs)
        launches = dict(DF.launches)
        enc_rows, dec_rows = enc.cpu().numpy(), dec.cpu().numpy()
        b_out, b_ok = b_out.cpu().numpy(), b_ok.cpu().numpy()
        x86_ms = best_ms(lambda: DF.x86_convert_batch(wide, valid, ip,
                                                      encoding=True))
        bcj2_ms = best_ms(lambda: DF.bcj2_decode_batch(*bargs))
        t = time.perf_counter()
        plain = {k: f.result() for k, f in jobs.items()}
        res["plain_wait_s"] = time.perf_counter() - t
    (p_enc, enc_ms), (p_dec, dec_ms) = plain["x86_enc"], plain["x86_dec"]
    (p_out, p_ok), bcj2_plain_ms = plain["bcj2"]
    lanes = np.arange(sms) % 8
    err["x86"] = max(err["x86"], max_err(enc_rows, p_enc[lanes]),
                     max_err(dec_rows, p_dec[lanes]))
    err["bcj2"] = max(err["bcj2"], max_err(b_out, p_out[lanes]))
    res["x86_wide"] = {
        "lanes": sms, "lane_bytes": MIB,
        "equal_plain": bool(np.array_equal(enc_rows, p_enc[lanes])
                            and np.array_equal(dec_rows, p_dec[lanes])),
        "equal_host": bool(np.array_equal(enc_rows, refs8[lanes])),
        "roundtrip": bool(np.array_equal(dec_rows, rows)),
        "plain_enc_ms": enc_ms, "plain_dec_ms": dec_ms}
    res["bcj2_wide"] = {
        "lanes": sms, "all_ok": bool(b_ok.all()),
        "equal_plain": bool(np.array_equal(b_ok, p_ok[lanes])
                            and np.array_equal(b_out, p_out[lanes])),
        "equal_input": bool(np.array_equal(b_out[:, :MIB], rows)),
        "plain_ms": bcj2_plain_ms}
    x86_bytes = 2 * rows.size
    bcj2_bytes = sum(int(bargs[k].sum()) for k in (1, 3, 5, 7)) + \
        int(bargs[8].sum())
    res["x86_wide"].update(ms=x86_ms, bound_ms=x86_bytes / HBM_BYTES_PER_S
                           * 1e3)
    res["bcj2_wide"].update(ms=bcj2_ms, bound_ms=bcj2_bytes / HBM_BYTES_PER_S
                            * 1e3, bytes=bcj2_bytes)
    res["launches"] = launches
    same = {"x86": (small["x86"] and res["x86_wide"]["equal_plain"]),
            "bcj2": (small["bcj2"] and res["bcj2_wide"]["equal_plain"])}
    res["pass"] = (not res["mismatches"] and same["x86"] and same["bcj2"]
                   and res["x86_wide"]["equal_host"]
                   and res["x86_wide"]["roundtrip"]
                   and res["bcj2_wide"]["all_ok"]
                   and res["bcj2_wide"]["equal_input"]
                   and launches["x86"] > 0 and launches["bcj2"] > 0)
    common = {"route": "cuda", "bound_by": "bytes", "library_ms": None,
              "source": "lzma_sdk_zliblike_tpu_torch/csrc/device_filters.cu"}
    batch = f"the {sms} x 1 MiB lanes' 8 distinct ones"
    entries = [{
        "name": "device_filters x86 (X4)", **common,
        "replaces": "lzma_sdk_zliblike_tpu/ops/device_filters.py:223",
        "launches": launches["x86"], "matches_plain": same["x86"],
        "max_abs_err": err["x86"], "ms": x86_ms, "plain_ms": enc_ms,
        "plain_batch": f"{batch}, encode",
        "bound_ms": res["x86_wide"]["bound_ms"]}, {
        "name": "device_filters bcj2 (X4)", **common,
        "replaces": "lzma_sdk_zliblike_tpu/ops/device_filters.py:340",
        "launches": launches["bcj2"], "matches_plain": same["bcj2"],
        "max_abs_err": err["bcj2"], "ms": bcj2_ms,
        "plain_ms": bcj2_plain_ms, "plain_batch": batch,
        "bound_ms": res["bcj2_wide"]["bound_ms"]}]
    return res, entries


def device_filters_small(device, FB, res, err) -> dict:
    """Phase 18's small batches (see ``device_filters``): appends to
    ``res``'s checks and mismatches, raises ``err`` to the largest
    kernel-to-plain difference and returns whether x86 and BCJ2 each equal
    their plain versions on every batch."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.ops import device_filters as DF
    from lzma_sdk_zliblike_tpu_torch.ops import filters as F
    host = {"x86": lambda b, i, encoding: F.x86_convert(b, i, encoding)[0]}
    same = {"x86": True, "bcj2": True}
    for k, name in enumerate(("arm", "armt", "ppc", "sparc", "ia64", "x86")):
        data, valid, ip = FB.salted_batch(k * 101 + 3)
        fn = host.get(name, getattr(F, f"{name}_convert"))
        for encoding in (True, False):
            plain = DF.convert_batch(name, data, valid, ip, encoding=encoding,
                                     device="cpu")
            kern = DF.convert_batch(name, data, valid, ip, encoding=encoding,
                                    device=device)
            ok = np.array_equal(kern, plain) and all(
                kern[s, :n].tobytes() == fn(data[s, :n].tobytes(), int(ip[s]),
                                             encoding=encoding)
                for s, n in enumerate(valid.tolist()))
            if name == "x86":
                err["x86"] = max(err["x86"], max_err(kern, plain))
                same["x86"] = same["x86"] and np.array_equal(kern, plain)
            if encoding:      # round trip at 16-aligned offsets (ia64's)
                ip16 = ip & ~np.uint32(15)
                enc = DF.convert_batch(name, data, valid, ip16, encoding=True,
                                       device=device)
                back = DF.convert_batch(name, enc, valid, ip16,
                                        encoding=False, device=device)
                ok = ok and np.array_equal(back, data[:, :back.shape[1]])
            res["checks"].append([name, encoding, bool(ok)])
            if not ok:
                res["mismatches"].append([name, encoding])
    for tag, make in (("x86_edge", FB.x86_edge_batch),
                      ("x86_past_row", FB.x86_past_row_batch)):
        for encoding in (True, False):
            plain = DF.convert_batch("x86", *make(), encoding=encoding,
                                     device="cpu")
            kern = DF.convert_batch("x86", *make(), encoding=encoding,
                                    device=device)
            ok = np.array_equal(kern, plain)
            err["x86"] = max(err["x86"], max_err(kern, plain))
            same["x86"] = same["x86"] and ok
            res["checks"].append([tag, encoding, bool(ok)])
            if not ok:
                res["mismatches"].append([tag, encoding])
    data, valid, _ = FB.salted_batch(7)
    for dist in (1, 4, 255):
        t_d, t_v = torch.from_numpy(data), torch.from_numpy(valid)
        enc = DF.delta_batch(t_d.to(device), t_v.to(device), dist=dist,
                             encoding=True)
        dec = DF.delta_batch(enc, t_v.to(device), dist=dist, encoding=False)
        ok = (torch.equal(enc.cpu(), DF.delta_batch(t_d, t_v, dist=dist,
                                                    encoding=True))
              and torch.equal(dec.cpu(), t_d))
        res["checks"].append(["delta", dist, bool(ok)])
        if not ok:
            res["mismatches"].append(["delta", dist])
    # BCJ2: the corpus and edge lanes, the past-the-row lanes and main
    # streams that fill their rows and end on a site
    datas = FB.bcj2_corpus()
    streams, lens, out_size, want_ok = FB.bcj2_lanes(datas, F.bcj2_encode,
                                                     edge=True)
    res["bcj2_check"] = {}
    for tag, (streams, lens, out_size) in (
            ("edge", (streams, lens, out_size)),
            ("past_row", FB.bcj2_past_row_batch(F.bcj2_encode)),
            ("site_at_end", FB.bcj2_site_at_end(F.bcj2_encode)[:3])):
        args = [torch.from_numpy(x) for a, n in zip(streams, lens)
                for x in (a, n)] + [torch.from_numpy(out_size)]
        p_out, p_ok = DF.bcj2_decode_batch(*args)
        k_out, k_ok = DF.bcj2_decode_batch(*[a.to(device) for a in args])
        k_out, k_ok = k_out.cpu(), k_ok.cpu()
        good = p_ok.numpy()
        err["bcj2"] = max(err["bcj2"], max_err(k_out.numpy()[good],
                                               p_out.numpy()[good]))
        ok = (k_ok.tolist() == p_ok.tolist()
              and torch.equal(k_out[p_ok], p_out[p_ok]))
        same["bcj2"] = same["bcj2"] and ok
        if tag == "edge":
            ok = ok and p_ok.tolist() == want_ok and all(
                k_out[s, :len(d)].numpy().tobytes() == d
                for s, d in enumerate(datas))
        res["bcj2_check"][tag] = {"ok": k_ok.tolist(), "equal": bool(ok)}
        if not ok:
            res["mismatches"].append(["bcj2", tag])
    return same


def one_call(data: bytes, device) -> dict:
    """Phase 19: the one-call API on the host.  ``lzma2_compress`` of the
    128 MiB (1 MiB dictionary and chunk, every core), then
    ``lzma2_uncompress(device="cuda")`` of it (equal to the data, K1
    launched); ``compress``/``uncompress`` of 8 MiB at level 5 (the stream
    also read by Python's ``lzma`` as .lzma); a ``.lzma86`` round trip of
    4 MiB of ``x86_like`` (the filter it chose reported);
    ``lzma2_compress_stream``
    of 8 MiB fed in 1 MiB pieces equal to the same fed in one piece, read
    Python's ``lzma``.
"""
    import lzma_sdk_zliblike_tpu_torch as T
    from lzma_sdk_zliblike_tpu_torch import api
    from lzma_sdk_zliblike_tpu_torch.containers import lzma86
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    res = {}
    t = time.perf_counter()
    stream, prop = T.lzma2_compress(data, dict_size=MIB, chunk_size=MIB,
                                    threads=os.cpu_count())
    res["lzma2_compress_s"] = time.perf_counter() - t
    G.launches = 0
    t = time.perf_counter()
    back = T.lzma2_uncompress(stream, prop, device=device)
    res["lzma2_uncompress_s"] = time.perf_counter() - t
    res["lzma2_launches"] = G.launches
    res["lzma2_equal"] = back == data
    del back
    part = data[:8 * MIB]
    t = time.perf_counter()
    s, props = T.compress(part, level=5)
    res["compress_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["uncompress_equal"] = T.uncompress(s, props, len(part)) == part
    res["uncompress_s"] = time.perf_counter() - t
    res["compress_ratio"] = len(s) / len(part)
    res["liblzma_reads_it"] = lzma.decompress(
        props + len(part).to_bytes(8, "little") + s,
        format=lzma.FORMAT_ALONE) == part
    x86 = corpus_module().x86_like(4 * MIB, seed=70)
    t = time.perf_counter()
    img = lzma86.encode(x86, dict_size=MIB)
    res["lzma86_s"] = time.perf_counter() - t
    res["lzma86_filter"] = img[0]
    res["lzma86_equal"] = lzma86.decode(img) == x86
    pieces = api.lzma2_compress_stream(dict_size=MIB)
    fed = b"".join(pieces.compress(part[a:a + MIB])
                   for a in range(0, len(part), MIB)) + pieces.flush()
    whole = api.lzma2_compress_stream(dict_size=MIB)
    one = whole.compress(part) + whole.flush()
    res["stream_equal"] = fed == one
    res["stream_liblzma_reads_it"] = lzma.decompress(
        fed, format=lzma.FORMAT_RAW, filters=[
            {"id": lzma.FILTER_LZMA2, "dict_size": MIB}]) == part
    try:
        T.compress(part[:1000], engine="tpu")
        res["device_engine_refused"] = False
    except T.UnsupportedError:
        res["device_engine_refused"] = True
    res["pass"] = (res["lzma2_equal"] and res["lzma2_launches"] > 0
                   and res["uncompress_equal"] and res["liblzma_reads_it"]
                   and res["lzma86_equal"]
                   and res["stream_equal"] and res["stream_liblzma_reads_it"]
                   and res["device_engine_refused"])
    return res


RSS_SCRIPT = r"""
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[1])
from lzma_sdk_zliblike_tpu_torch import native
from lzma_sdk_zliblike_tpu_torch.containers import sevenzip as SZ
from lzma_sdk_zliblike_tpu_torch.streams import extract7z
native._load()
mode, out_dir, paths = sys.argv[2], sys.argv[3], sys.argv[4:]
page = os.sysconf("SC_PAGE_SIZE")


def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * page


before = rss()
peak, done = [before], threading.Event()


def sample():
    while not done.is_set():
        peak[0] = max(peak[0], rss())
        time.sleep(0.001)


th = threading.Thread(target=sample)
th.start()
n = 0
try:
    for i, path in enumerate(paths):
        if mode == "streaming":
            extract7z.extract_streaming(path, os.path.join(out_dir, str(i)))
        else:
            files = SZ.extract(open(path, "rb").read())
            n += sum(map(len, files.values()))
            del files
finally:
    done.set()
    th.join()
print("RSS " + json.dumps({"before": before, "peak": max(peak[0], rss()),
                           "bytes": n}), flush=True)
"""


def rss_growth(mode: str, paths: list, out_dir: str) -> dict:
    """Growth of peak RSS over the RSS before, in a fresh interpreter that
    has imported the port and loaded its native runtime, while ``mode``
    ("streaming" or "extract") extracts the archives at ``paths`` one
    after another; RSS is read from ``/proc/self/statm`` every
    millisecond."""
    r = subprocess.run([sys.executable, "-c", RSS_SCRIPT, REPO, mode,
                        out_dir, *paths], capture_output=True, text=True,
                       timeout=600, cwd=REPO)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RSS ")]
    if r.returncode != 0 or not line:
        raise RuntimeError(f"rss {mode}: exit {r.returncode}: "
                           f"{r.stderr[-3000:]}")
    res = json.loads(line[0][4:])
    res["growth_mib"] = (res["peak"] - res["before"]) / MIB
    return res


def sevenzip_phase(tmp: str, data: bytes, xz_img: bytes, stream: bytes,
                   prop: int, xz_mb_s: float, main_mb_s: float) -> dict:
    """Phase 20: the 7z container, the streaming extractor and the
    streaming decoders, on the host.  ``sevenzip.write`` takes one method
    and one pre-filter an archive (in both packages), so four archives
    (``encode_header=True``, the writer's 1 MiB dictionary): 16 MiB of
    ``big_mixed`` in 8 files and an empty file (solid LZMA2), 8 MiB of
    ``x86_like`` (LZMA2 + BCJ), 2 MiB (LZMA + BCJ2) and 2 MiB of
    ``english_like`` (PPMd).  Each is extracted with ``extract`` and with
    ``extract_streaming`` (the PPMd one must be refused there, as the JAX
    package refuses it) and every file compared; the growth of peak RSS
    of each way over the first three, each in a fresh interpreter; the
    solid archive carved out of a 1 MiB host file; phase 9's xz image
    through ``XzStreamDecoder`` in 64 KiB pieces and phase 3's LZMA2
    stream through ``decompressobj("lzma2")`` in 1 MiB pieces."""
    from lzma_sdk_zliblike_tpu_torch.containers import sevenzip as SZ
    from lzma_sdk_zliblike_tpu_torch.containers.xz import XzStreamDecoder
    from lzma_sdk_zliblike_tpu_torch.streams import extract7z, zlike
    from lzma_sdk_zliblike_tpu_torch.utils.errors import UnsupportedError
    cm = corpus_module()
    solid = {f"solid/part{i}.bin": data[i * 2 * MIB:(i + 1) * 2 * MIB]
             for i in range(8)}
    solid["empty.txt"] = b""
    x86 = cm.x86_like(10 * MIB, seed=71)
    archives = [
        ("lzma2_solid", solid, dict(method=SZ.M_LZMA2)),
        ("lzma2_bcj", {"x86/app.exe": x86[:8 * MIB]},
         dict(method=SZ.M_LZMA2, pre_filter=SZ.M_BCJ)),
        ("lzma_bcj2", {"x86/tool.exe": x86[8 * MIB:]},
         dict(method=SZ.M_LZMA, pre_filter=SZ.M_BCJ2)),
        ("ppmd", {"text/book.txt": cm.english_like(2 * MIB, seed=72)},
         dict(method=SZ.M_PPMD)),
    ]
    res, ok, paths = {"archives": {}}, True, []
    for name, files, kw in archives:
        size = sum(map(len, files.values()))
        t = time.perf_counter()
        img = SZ.write(files, encode_header=True, **kw)
        w = time.perf_counter() - t
        path = os.path.join(tmp, name + ".7z")
        with open(path, "wb") as f:
            f.write(img)
        t = time.perf_counter()
        got = SZ.extract(img)
        e = time.perf_counter() - t
        r = {"bytes": size, "packed": len(img), "write_s": w,
             "write_mb_per_s": size / w / 1e6, "extract_s": e,
             "extract_mb_per_s": size / e / 1e6,
             "extract_equal": got == files}
        del got
        out = os.path.join(tmp, "out_" + name)
        t = time.perf_counter()
        try:
            names = extract7z.extract_streaming(path, out)
        except UnsupportedError:
            names = None
        s = time.perf_counter() - t
        if name == "ppmd":
            r["streaming_refused"] = names is None
            ok &= names is None
        else:
            paths.append(path)
            back = {}
            for n in files:
                with open(os.path.join(out, n), "rb") as f:
                    back[n] = f.read()
            r.update(streaming_s=s, streaming_mb_per_s=size / s / 1e6,
                     streaming_equal=(back == files
                                      and sorted(names) == sorted(files)))
            ok &= r["streaming_equal"]
        ok &= r["extract_equal"]
        res["archives"][name] = r
        if name == "lzma2_solid":
            host = cm.random_bytes(MIB, seed=73)
            host = host[:MIB // 2] + img + host[MIB // 2:]
            carved = SZ.carve(host)
            res["carve_equal"] = (carved == img
                                  and SZ.find_signature(host) == MIB // 2)
            ok &= res["carve_equal"]
    res["rss_streaming"] = rss_growth("streaming", paths,
                                      os.path.join(tmp, "rss_out"))
    res["rss_extract"] = rss_growth("extract", paths,
                                    os.path.join(tmp, "rss_out"))
    res["rss_ratio"] = (res["rss_streaming"]["growth_mib"]
                        / res["rss_extract"]["growth_mib"])
    ok &= res["rss_ratio"] < 0.5
    pieces: list = []
    dec = XzStreamDecoder(pieces.append)
    t = time.perf_counter()
    for a in range(0, len(xz_img), 64 << 10):
        dec.feed(xz_img[a:a + (64 << 10)])
    dec.finish()
    s = time.perf_counter() - t
    res["xz_stream"] = {"seconds": s, "mb_per_s": len(data) / s / 1e6,
                        "xz_phase_mb_per_s": xz_mb_s,
                        "equal": b"".join(pieces) == data}
    del pieces
    d = zlike.decompressobj("lzma2", dict_prop=prop)
    t = time.perf_counter()
    parts = [d.decompress(stream[a:a + MIB])
             for a in range(0, len(stream), MIB)]
    parts.append(d.flush())
    s = time.perf_counter() - t
    res["lzma2_stream"] = {"seconds": s, "mb_per_s": len(data) / s / 1e6,
                           "main_mb_per_s": main_mb_s,
                           "equal": b"".join(parts) == data and d.eof}
    del parts
    ok &= res["xz_stream"]["equal"] and res["lzma2_stream"]["equal"]
    res["pass"] = bool(ok)
    return res


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
        data = corpus(128 * MIB)
        # -- 2. kernel vs plain version ------------------------------------
        p2 = kernel_vs_plain(pool, device, data)
        emit({"phase": "kernel_vs_plain", **p2})
        if not p2["pass"]:
            failed.append("kernel_vs_plain")

        # -- data for phases 3 and 4 --------------------------------------
        t = time.perf_counter()
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
    p3["geometry"] = G.launch_geometry(shape.n_lanes, shape.dic_cap,
                                       device=device)
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
    p6, ref_mt = encode_main(data, device)
    ref_mt_sha = hashlib.sha256(ref_mt).hexdigest()
    emit({"phase": "encode_main", **p6})
    if not p6["pass"]:
        failed.append("encode_main")

    # -- 7. probes: P1 and P2 -------------------------------------------------
    p7, k_p1, k_p2 = probes(device)
    emit({"phase": "probes", **p7})
    if not p7["pass"]:
        failed.append("probes")

    # -- 8. host MT and hybrid decode of the main stream ---------------------
    ph = host_engines(stream, prop, data, p3["mb_per_s"], device)
    for name, res in zip(("host_mt", "hybrid", "hybrid_1t", "hybrid_abort"),
                         ph):
        emit({"phase": name, **res})
        if not res["pass"]:
            failed.append(name)

    # -- 9. xz: the port's writer, its reader on the card ---------------------
    p9, xz_img = xz_phase(data, device)
    emit({"phase": "xz", **p9})
    if not p9["pass"]:
        failed.append("xz")

    # -- 10. hybrid encode: host cores and K2 on one group queue ------------
    ph10 = hybrid_encode(data, ref_mt, device, p6["mb_per_s"],
                         p6["host_mt_mb_per_s"])
    for name, res in zip(("hybrid_encode", "hybrid_encode_1t"), ph10):
        emit({"phase": name, **res})
        if not res["pass"]:
            failed.append(name)
    del ref_mt

    # -- 11. encode big block: one 64 MiB group through K2 --------------------
    p11 = encode_bigblock(data, device)
    emit({"phase": "encode_bigblock", **p11})
    if not p11["pass"]:
        failed.append("encode_bigblock")

    # -- 12. X2 on the card against the CPU ------------------------------------
    p12 = match_find_vs_cpu(data, device)
    emit({"phase": "match_find_vs_cpu", **p12})
    if not p12["pass"]:
        failed.append("match_find_vs_cpu")

    # -- 13. device-assisted encode: X2 on the card, the host coder ----------
    p13 = encode_device(data, device)
    emit({"phase": "encode_device", **p13})
    if not p13["pass"]:
        failed.append("encode_device")

    # -- 14-16. two ranks on cuda:0 over Gloo ---------------------------------
    torch.cuda.empty_cache()       # the ranks size their batches to free memory
    with tempfile.TemporaryDirectory() as tmp:
        p14 = distributed_decode(tmp, stream, prop, data, p3["mb_per_s"],
                                 ph[0]["mb_per_s"])
        emit({"phase": "distributed_decode", **p14})
        p15 = distributed_encode(tmp, data, ref_mt_sha,
                                 framing.encode_dict_prop(MIB),
                                 p6["host_mt_mb_per_s"])
        emit({"phase": "distributed_encode", **p15})
    p16 = dryrun_phase(device)
    emit({"phase": "dryrun_multichip", **p16})
    for name, res in (("distributed_decode", p14),
                      ("distributed_encode", p15), ("dryrun_multichip", p16)):
        if not res["pass"]:
            failed.append(name)

    # -- 17-19. X3, X4 and the one-call raw-LZMA API ----------------------
    p17, k_x3 = checksum_device(data, device)
    emit({"phase": "checksum_device", **p17})
    p18, k_x4 = device_filters(device)
    emit({"phase": "device_filters", **p18})
    p19 = one_call(data, device)
    emit({"phase": "one_call", **p19})
    for name, res in (("checksum_device", p17), ("device_filters", p18),
                      ("one_call", p19)):
        if not res["pass"]:
            failed.append(name)

    # -- 20. 7z, the streaming extractor and the streaming decoders -------
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        p20 = sevenzip_phase(tmp, data, xz_img, stream, prop,
                             p9["mb_per_s"], p3["mb_per_s"])
    p20["seconds"] = time.perf_counter() - t
    emit({"phase": "sevenzip", **p20})
    if not p20["pass"]:
        failed.append("sevenzip")
    del xz_img

    # K1's chain bound: the longest lane's bit calls on main at the cost of
    # one dependent pure-ALU bit call that phase 7 measured
    ns_per_bit_call = lane_notr_ns(p7["P1"])
    # K2's chain bound (an estimate): its walk makes one dependent
    # shared-memory update per op, P1 ``lane``'s cost of a call; its longest
    # chunk's coder one pure-ALU bit call per call, ``lane-notr``'s
    ns_per_lane_call = min(r["ns_per_call"] for r in p7["P1"]
                           if r["variant"] == "lane")
    emit({"kernels": [{
        "name": "group_decode (K1)", "route": "cuda",
        "source": "lzma_sdk_zliblike_tpu_torch/csrc/group_decode.cu",
        "replaces": "lzma_sdk_zliblike_tpu/ops/pallas_decode.py:236",
        "launches": p3["launches"], "matches_plain": p2["pass"],
        "max_abs_err": p2["max_abs_err"], "ms": p3["kernel_ms"],
        "plain_ms": p2["plain_ms"], "plain_batch_kernel_ms": p2["kernel_ms"],
        "bound_ms": p3["bound_ms"], "bound_by": "bytes",
        "chain_bound_ms": p3["bit_calls_max"] * ns_per_bit_call * 1e-6,
        "chain_ns_per_bit_call": ns_per_bit_call,
        "library_ms": None, "iterations_max": p3["iterations_max"],
        "bit_calls_max": p3["bit_calls_max"],
        "window": p3["geometry"]["window"],
        "blocks_per_sm": p3["geometry"]["blocks_per_sm"],
        "many_lanes_ms": p2["many_lanes"]["kernel_ms"],
        "many_lanes_window": p2["many_lanes"]["geometry"]["window"],
        "bigblock_launches": p4["launches"],
        "bigblock_seconds": p4["seconds"],
        "hybrid_launches": ph[1]["launches"],
        "hybrid_1t_launches": ph[2]["launches"],
        "hybrid_abort_launches": ph[3]["launches"],
        "xz_launches": p9["launches"],
        "xz_liblzma_block_launches": p9["liblzma_block"]["launches"],
        "distributed_launches": p14.get("launches", 0),
        "dryrun_launches": p16["launches"]}, {
        "name": "range_encode (K2)", "route": "cuda",
        "source": "lzma_sdk_zliblike_tpu_torch/csrc/range_encode.cu",
        "replaces": "lzma_sdk_zliblike_tpu/ops/pallas_encode.py:78",
        "launches": p6["launches"], "matches_plain": p5["pass"],
        "max_abs_err": p5["max_abs_err"], "ms": p6["kernel_ms"],
        "plain_ms": p5["plain_ms"], "plain_batch_kernel_ms": p5["kernel_ms"],
        "bound_ms": p6["bound_ms"], "bound_by": "bytes",
        "chain_bound_ms_estimate": max(
            p6["ops_per_lane_max"] * ns_per_lane_call,
            p6["chunk_bit_calls_max"] * ns_per_bit_call) * 1e-6,
        "chain_ns_per_op": ns_per_lane_call,
        "chain_ns_per_bit_call": ns_per_bit_call,
        "library_ms": None, "ops_per_lane_max": p6["ops_per_lane_max"],
        "bit_calls_max": p6["bit_calls_max"],
        "chunk_bit_calls_max": p6["chunk_bit_calls_max"],
        "launch_ms": p6["launch_ms"],
        "many_lanes_ms": p5["many_lanes"]["kernel_ms"],
        "many_lanes_per_sm": p5["many_lanes"]["lanes_per_sm"],
        "main_shape_plain_ms": p5["main_shape"]["plain_ms"],
        "hybrid_encode_launches": ph10[0]["launches"],
        "hybrid_encode_1t_launches": ph10[1]["launches"],
        "encode_bigblock_launches": p11["launches"],
        "encode_bigblock_ms": p11["kernel_ms"],
        "encode_bigblock_bound_ms": p11["bound_ms"]}, {
        "name": "v12_probe (P1)", "route": "cuda",
        "source": "lzma_sdk_zliblike_tpu_torch/csrc/v12_probe.cu",
        "replaces": "tools/dev_v12_probe.py:41", **k_p1,
        "bound_by": "operations", "library_ms": None}, {
        "name": "compact_probe (P2)", "route": "cuda",
        "source": "lzma_sdk_zliblike_tpu_torch/csrc/compact_probe.cu",
        "replaces": "tools/compact_probe.py:69", **k_p2,
        "bound_by": "operations", "library_ms": None}, k_x3, *k_x4]})
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
