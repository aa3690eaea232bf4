"""The port's entry points (``port_bench/entries``): the raw stream the
bulk cells send, unchanged from the harness's first version, and the whole
``.xz`` file of ``xz_T0_preset0.xzfile``."""

import lzma
import shutil
import subprocess
import time

import pytest

from port_bench import bench, lzma2_chunks, reference, spec, spans, traffic
from port_bench import pool as P

from port_bench_helpers import tiny_cell

SEED = 2**31 + 91
BULK = ["xz_T0_preset6.bulk", "xz_T0_preset0.bulk"]
XZFILE = "xz_T0_preset0.xzfile"


def parent_files(cell, seed, cache_dir):
    """The harness's files before entry points: ``bench._files`` and the
    work ``run_cell`` counted, as they were."""
    files = traffic.files(cell.traffic, seed, cell.config["block_size"])
    pool = P.Pool(cell.config, cache_dir)
    used = sorted({b for f in files for b in f})
    pool.ensure(used, 1)
    payloads = {b: pool.payload(b) for b in used}
    streams = [P.join(payloads[b] for b in f) for f in files]
    warm = P.join(lzma2_chunks.first_chunk(payloads[b]) for b in files[0])
    work = [lzma2_chunks.work_bytes(s) for s in streams]
    return files, streams, warm, work


@pytest.mark.parametrize("name", BULK)
def test_the_stream_entry_builds_what_the_parent_did(tmp_path, name,
                                                     monkeypatch):
    """Same files, streams, warm-up, work and set-up steps, byte for byte,
    and the same call of the port with the same arguments."""
    cell = tiny_cell(name)
    assert cell.entry == "lzma2_stream"
    phases: dict = {}
    files, streams, warm, _pool = bench._files(cell, SEED, str(tmp_path), 1,
                                               phases)
    entry = spec.entry(cell.entry)
    p_files, p_streams, p_warm, p_work = parent_files(cell, SEED,
                                                      str(tmp_path))
    assert files == p_files and streams == p_streams and warm == p_warm
    assert [entry.work(s) for s in streams] == p_work
    assert list(phases) == ["pool_built_blocks", "pool_build_s",
                            "pool_read_s", "join_s"]
    from lzma_sdk_zliblike_tpu_torch import api
    seen = []
    monkeypatch.setattr(api, "lzma2_uncompress",
                        lambda *a, **kw: seen.append((a, kw)) or b"")
    entry.Port(cell.config, "cuda")(streams[0])
    assert seen == [((streams[0], P.dict_prop(cell.config["dict_size"])),
                     {"engine": "device", "device": "cuda"})]


def xz_file(tmp_path, **kw):
    """A tiny ``xz_T0_preset0.xzfile``: its first file's image, blocks and
    originals."""
    cell = tiny_cell(XZFILE, **kw)
    files, images, warm, pool = bench._files(cell, SEED, str(tmp_path), 1,
                                             {})
    raw = reference.expected(pool, files[0], {})
    return cell, files[0], images[0], warm, raw, pool


def crc64_bitwise(data: bytes) -> int:
    """CRC64 (ECMA-182, reflected, as xz uses it), a bit at a time."""
    crc = 0xFFFFFFFFFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0xC96C5795D7870F42 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFFFFFFFFFF


def test_an_xz_image_is_what_liblzma_reads(tmp_path):
    """Three blocks and a short one: liblzma decodes the image to the
    originals, verifying every CRC64 as it goes; each block's stored check
    is the CRC64 of its original."""
    cell, blocks, img, warm, raw, pool = xz_file(tmp_path)
    assert [b[1] for b in blocks] == [1024] * 3 + [100]
    assert lzma.decompress(img, lzma.FORMAT_XZ) == raw
    assert img[6:8] == b"\x00\x04" and img[-2:] == b"YZ"
    E = spec.entry("xz_file")
    spans_ = E.blocks_of(img)
    assert len(spans_) == 4
    for (a, b), block in zip(spans_, blocks):
        assert img[a:b] == pool.payload(block) + b"\x00"
        assert img[13] == 0xC0       # both sizes in the first header
        check = img[b + (-(b - a) % 4):][:8]
        original = reference.block_original(pool, block)
        assert int.from_bytes(check, "little") == crc64_bitwise(original)
    assert E.work(img) == lzma2_chunks.work_bytes(
        P.join(pool.payload(b) for b in blocks))
    # the warm-up: one block of each size the file holds
    assert lzma.decompress(warm, lzma.FORMAT_XZ) == \
        reference.expected(pool, [blocks[0], blocks[-1]], {})


@pytest.mark.parametrize("block_size,tail", [(1024, 100), (1 << 20, 145408)])
def test_the_image_is_what_xz_writes(tmp_path, block_size, tail):
    """Byte for byte what ``xz -0`` writes threaded (``-T2``, the mode
    ``-T0`` takes on a host of several cores) with the cell's block size,
    from the same originals."""
    if shutil.which("xz") is None:
        pytest.skip("needs the xz command")
    cell, blocks, img, _warm, raw, _pool = xz_file(
        tmp_path, block_size=block_size, per_call=2, pool=2, tail=tail)
    out = subprocess.run(["xz", "-0", "-T2", f"--block-size={block_size}",
                          "-c"], input=raw, capture_output=True, check=True,
                         timeout=120).stdout
    assert img == out


def test_the_checks_are_kept_by_key(tmp_path):
    cell, blocks, img, _warm, _raw, pool = xz_file(tmp_path)
    E = spec.entry("xz_file")
    used = sorted(set(blocks))
    assert E.prepare(pool, used, 1) == []
    path = pool.stem(used[0]) + ".check.json"
    with open(path, "w") as f:
        f.write("{}")
    assert E.prepare(pool, used, 1) == [used[0]]
    # a checks record of another original is stale too
    other = P.Pool(dict(pool.config, generator_seed_base=7), pool.folder[
        :-len(pool.config["name"]) - 1])
    other.ensure(used, 1)
    assert E.prepare(other, used, 1) == used


def test_the_port_decodes_the_image(tmp_path):
    from lzma_sdk_zliblike_tpu_torch.containers import xz
    cell, _blocks, img, _warm, raw, _pool = xz_file(tmp_path)
    assert xz.decode(img, device="cpu") == raw
    assert spec.entry("xz_file").Port(cell.config, "cpu")(img) == raw


def flip_check(img: bytes) -> bytes:
    """``img`` with one byte of its first block's CRC64 flipped."""
    a, b = spec.entry("xz_file").blocks_of(img)[0]
    at = b + (-(b - a) % 4) + 3
    return img[:at] + bytes([img[at] ^ 0x01]) + img[at + 1:]


def test_a_flipped_check_raises_and_fails_the_call(tmp_path):
    from lzma_sdk_zliblike_tpu_torch.containers import xz
    from lzma_sdk_zliblike_tpu_torch.utils.errors import CrcError
    cell, _blocks, img, _warm, _raw, _pool = xz_file(tmp_path)
    with pytest.raises(CrcError):
        xz.decode(flip_check(img), device="cpu")
    port = spec.entry("xz_file").Port(cell.config, "cpu")
    calls = []

    def flipped(image):
        calls.append(image)
        return port(flip_check(image) if len(calls) > 1 else image)
    r = bench.run_cell(cell, SEED, 0.01, False, t0=time.perf_counter(),
                       device="cpu", decoder=flipped,
                       cache_dir=str(tmp_path), workers=1)
    assert not r["correct"]
    assert r["failed"] == r["attempted"] >= 1
    assert r["checks"]["failed_calls"]["value"] == r["attempted"]


def test_the_container_metrics_read_what_they_say(tmp_path, monkeypatch):
    """On the CPU, with each block check and each block header's parse made
    20 ms and 10 ms slower: ``check_ms`` holds the checks' time,
    ``container_ms`` the parse's and not the blocks' decode, and
    ``k1_launches_per_call`` one launch a block."""
    from lzma_sdk_zliblike_tpu_torch.containers import xz
    cell, blocks, img, _warm, raw, _pool = xz_file(tmp_path)
    E = spec.entry("xz_file")
    check, parse = xz._check_compute, xz._parse_block_header

    def slow_check(*a):
        time.sleep(0.02)
        return check(*a)

    def slow_parse(*a):
        time.sleep(0.01)
        return parse(*a)
    monkeypatch.setattr(xz, "_check_compute", slow_check)
    monkeypatch.setattr(xz, "_parse_block_header", slow_parse)
    port = E.Port(cell.config, "cpu")
    port(img)
    with spans.Spans(E.TIMED) as sp:
        sp.begin_call()
        t = time.perf_counter()
        out = port(img)
        end = time.perf_counter()
        sp.end_call(end)
    assert out == raw
    run = bench.Run(0.0, end - t, [bench.Call(
        0, len(out), *E.work(img), end - t)], sp.calls)
    n = len(blocks)
    call_ms = (end - t) * 1e3
    check_ms = spec.reader("check_ms")(run)
    container_ms = spec.reader("container_ms")(run)
    inner_ms = sp.calls[0].timed["inner"] * 1e3
    assert 20 * n <= check_ms < 20 * n + 50
    assert 10 * n <= container_ms < 10 * n + 50
    assert container_ms + check_ms + inner_ms == pytest.approx(call_ms)
    assert spec.reader("k1_launches_per_call")(run) == n
    # a raw stream's call holds no block, so no container metric
    bulk = bench.Run(0.0, 1.0, run.calls, [spans.CallSpans(launches=1)])
    assert spec.reader("check_ms")(bulk) is None
    assert spec.reader("container_ms")(bulk) is None
