"""The entry point ``sevenz_archive`` of ``7z_mx5.archive``: whole ``.7z``
archives as 7-Zip writes them at ``-mx5``, through the port's
``containers.sevenzip.extract(engine="device")``."""

import filecmp
import lzma
import os
import time

import pytest

from port_bench import bench, lzma2_chunks, reference, sevenz_plain, spec
from port_bench import pool as P

from port_bench_helpers import tiny_cell

SEED = 2**31 + 97
CELL = "7z_mx5.archive"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def sevenz(tmp_path, **kw):
    """A tiny ``7z_mx5.archive`` (files of a few hundred bytes): the cell,
    its files, images, warm-up image and pool."""
    cell = tiny_cell(CELL, **kw)
    cell.config.update(file_size_min=150, file_size_max=700)
    files, images, warm, pool = bench._files(cell, SEED, str(tmp_path), 1,
                                             {})
    return cell, files, images, warm, pool


def test_the_plain_reference_is_the_tests_copy():
    assert filecmp.cmp(os.path.join(ROOT, "port_bench", "sevenz_plain.py"),
                       os.path.join(ROOT, "tests", "sevenz_plain.py"),
                       shallow=False)


def test_every_image_reads_back_to_the_originals(tmp_path):
    """Under the plain reference and under liblzma folder by folder: two
    folders, the first block behind x86 BCJ in one dict-reset group, the
    others and the short block in the second; files in archive order, each
    with its CRC32; the header LZMA-coded."""
    cell, files, images, warm, pool = sevenz(tmp_path)
    E = spec.entry("sevenz_archive")
    for blocks, img in zip(files, images):
        raw = reference.expected(pool, blocks, {})
        got = sevenz_plain.extract(img)
        assert b"".join(got.values()) == raw
        ar = sevenz_plain.read(img)
        assert [len(f.coders) for f in ar.folders] == [2, 1]
        assert [f.coders[-1].method for f in ar.folders] == \
            [sevenz_plain.BCJ, sevenz_plain.LZMA2]
        assert all(e.crc is not None for e in ar.entries)
        assert all(e.name.endswith((".exe", ".dll")) == (e.folder == 0)
                   for e in ar.entries)
        (a0, n0), (a1, n1) = E.lzma2_streams(img)
        x86 = E.x86_filters(cell.config)
        assert lzma.decompress(img[a0:a0 + n0], lzma.FORMAT_RAW,
                               filters=x86) == \
            reference.block_original(pool, blocks[0])
        assert lzma.decompress(img[a1:a1 + n1], lzma.FORMAT_RAW,
                               filters=P.lzma2_filters(cell.config)) == \
            reference.expected(pool, blocks[1:], {})
        assert img[32 + int.from_bytes(img[12:20], "little")] == \
            sevenz_plain.K_ENCODED_HEADER
        assert E.work(img) == tuple(map(sum, zip(*(
            lzma2_chunks.work_bytes(img[a:a + n])
            for a, n in E.lzma2_streams(img)))))
    assert [len(f.coders) for f in sevenz_plain.read(warm).folders] == [2, 1]
    assert sevenz_plain.extract(warm)


def test_the_x86_payloads_are_kept_by_key(tmp_path):
    cell, files, _images, _warm, pool = sevenz(tmp_path)
    E = spec.entry("sevenz_archive")
    used = sorted({b for f in files for b in f})
    assert E.prepare(pool, used, 1) == []
    full = [b for b in used if b[1] == cell.config["block_size"]]
    with open(pool.stem(full[0]) + ".x86.lz2", "ab") as f:
        f.write(b"\x00")
    assert E.prepare(pool, used, 1) == [full[0]]


def test_the_port_reads_every_image(tmp_path):
    cell, files, images, warm, pool = sevenz(tmp_path)
    port = spec.entry("sevenz_archive").Port(cell.config, "cpu")
    out = port(images[0])
    assert len(out) == len(reference.expected(pool, files[0], {}))
    assert out == reference.expected(pool, files[0], {})
    assert reference.wrong_bytes(out, reference.expected(
        pool, files[0], {})) == 0
    assert port(warm) == b"".join(sevenz_plain.extract(warm).values())


def run(tmp_path, cell, decoder):
    return bench.run_cell(cell, SEED, 0.01, False, t0=time.perf_counter(),
                          device="cpu", decoder=decoder,
                          cache_dir=str(tmp_path), workers=1)


def test_the_control_reads_wrong_bytes(tmp_path):
    cell, *_ = sevenz(tmp_path)
    r = run(tmp_path, cell, spec.entry("sevenz_archive").Control(cell.config))
    assert not r["correct"]
    assert r["checks"]["wrong_bytes"]["value"] > 0
    assert r["checks"]["wrong_calls"]["value"] == \
        min(r["attempted"], cell.traffic["check_calls"])


def test_one_altered_byte_of_the_bcj_folder_fails(tmp_path):
    """The port's output with one byte of the executables' folder altered
    after its checks: the comparison finds it."""
    cell, *_ = sevenz(tmp_path)
    port = spec.entry("sevenz_archive").Port(cell.config, "cpu")

    def altered(img):
        out = port(img).joined()
        return out[:5] + bytes([out[5] ^ 0x20]) + out[6:]
    r = run(tmp_path, cell, altered)
    assert not r["correct"]
    assert r["checks"]["wrong_bytes"]["value"] == \
        r["checks"]["wrong_calls"]["value"] >= 1


def test_the_filter_left_out_fails(tmp_path, monkeypatch):
    """X4 x86 made to return its input: every call raises CrcError, a
    failed call.  The blocks here are half x86-like bytes (a tiny block of
    ``big_mixed`` is text alone, which the filter leaves as it is)."""
    from lzma_sdk_zliblike_tpu_torch.ops import device_filters as DF
    from port_bench import corpus
    monkeypatch.setattr(corpus, "big_mixed", lambda n, seed: (
        corpus.english_like(n // 2, seed)
        + corpus.x86_like(n - n // 2, seed)))
    cell, *_ = sevenz(tmp_path)
    port = spec.entry("sevenz_archive").Port(cell.config, "cpu")
    calls = []

    def unfiltered(img):
        calls.append(img)
        if len(calls) == 1:             # the warm-up
            return port(img)
        with monkeypatch.context() as m:
            m.setattr(DF, "x86_convert_batch",
                      lambda data, valid, ip, *, encoding: data.clone())
            return port(img)
    r = run(tmp_path, cell, unfiltered)
    assert not r["correct"]
    assert r["failed"] == r["attempted"] >= 1
    assert r["checks"]["failed_calls"]["value"] == r["attempted"]


def test_a_traced_run_reads_every_metric(tmp_path):
    """On the CPU (no device operation, so no idle share): the cell's
    per-layer metrics, the new ones among them, each read a number."""
    cell, *_ = sevenz(tmp_path)
    r = bench.run_cell(cell, SEED, 0.01, True, t0=time.perf_counter(),
                       device="cpu", cache_dir=str(tmp_path), workers=1)
    assert r["correct"]
    names = {m["name"] for m in cell.per_layer} - {"device_idle_pct"}
    assert names <= set(r["metrics"])
    for name in ("x86_ms", "sevenzip_check_ms", "sevenzip_container_ms"):
        assert r["metrics"][name]["value"] > 0
    assert 0 < r["metrics"]["x86_roofline"]["value"] < 100


def test_a_port_without_the_route_stops_at_once(monkeypatch):
    """The parent's ``extract`` takes no ``device``: the entry module
    refuses to load, before any pool is built."""
    from lzma_sdk_zliblike_tpu_torch.containers import sevenzip
    E = spec.entry("sevenz_archive")
    monkeypatch.setattr(sevenzip, "extract",
                        lambda data, *, verify=True, engine="auto": {})
    with pytest.raises(RuntimeError, match="no device route"):
        E._port_route()
