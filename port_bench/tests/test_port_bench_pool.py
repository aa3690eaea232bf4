"""The block pool, its cache and the streams made from it."""

import lzma
import os

import pytest

from port_bench import corpus, lzma2_chunks, reference
from port_bench import pool as P

from port_bench_helpers import tiny_cell


BLOCKS = [(0, 3000), (1, 3000), (2, 3000)]


@pytest.fixture
def config():
    return dict(tiny_cell().config, block_size=3000)


def test_cache_is_keyed_and_rebuilt_when_stale(tmp_path, config):
    pool = P.Pool(config, str(tmp_path))
    assert pool.ensure(BLOCKS, workers=1) == BLOCKS
    assert pool.ensure(BLOCKS, workers=1) == []
    payload = pool.payload(BLOCKS[1])
    # another encoder setting is another key: every block is built again
    other = P.Pool(dict(config, preset=1), str(tmp_path))
    assert other.ensure(BLOCKS, workers=1) == BLOCKS
    assert pool.ensure(BLOCKS, workers=1) == BLOCKS
    # so is another size under the same index
    assert pool.ensure([(1, 2000)], workers=1) == [(1, 2000)]
    assert pool.ensure([BLOCKS[1]], workers=1) == [BLOCKS[1]]
    # a payload of the right size but other bytes fails its hash
    path = os.path.join(pool.folder, "00001.lz2")
    with open(path, "r+b") as f:
        f.seek(len(payload) // 2)
        f.write(bytes([payload[len(payload) // 2] ^ 0xFF]))
    assert pool.payload(BLOCKS[1]) == payload
    # a truncated file is stale by its size
    with open(path, "r+b") as f:
        f.truncate(10)
    assert pool.ensure([BLOCKS[1]], workers=1) == [BLOCKS[1]]
    assert pool.payload(BLOCKS[1]) == payload


def test_workers_build_the_same_blocks(tmp_path, config):
    a = P.Pool(config, str(tmp_path / "a"))
    b = P.Pool(config, str(tmp_path / "b"))
    assert a.ensure(BLOCKS, workers=2) == BLOCKS
    b.ensure(BLOCKS, workers=1)
    assert [a.payload(k) for k in BLOCKS] == [b.payload(k) for k in BLOCKS]


def test_liblzma_decodes_a_joined_stream_to_the_originals(tmp_path, config):
    pool = P.Pool(config, str(tmp_path))
    blocks = [BLOCKS[2], BLOCKS[0], (3, 700)]     # a short block last
    pool.ensure(blocks, workers=1)
    stream = P.join(pool.payload(k) for k in blocks)
    out = lzma.decompress(stream, lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "dict_size": config["dict_size"]}])
    assert out == b"".join(P.original(config, k) for k in blocks)
    assert reference.expected(pool, blocks, {}) == out
    chunks = lzma2_chunks.chunks(stream)
    assert sum(c.dict_reset for c in chunks) == 3
    assert lzma2_chunks.work_bytes(stream)[1] == 2 * 3000 + 700


def test_originals_come_from_the_frozen_generator(tmp_path, config):
    pool = P.Pool(config, str(tmp_path))
    pool.ensure([BLOCKS[0]], workers=1)
    seed = config["generator_seed_base"]
    assert reference.block_original(pool, BLOCKS[0]) == corpus.big_mixed(
        3000, seed)
    with open(os.path.join(pool.folder, "00000.raw"), "r+b") as f:
        f.write(b"\xff\xfe")
    # a changed cache file is not the reference: it is made again
    assert reference.block_original(pool, BLOCKS[0]) == corpus.big_mixed(
        3000, seed)


def test_first_chunk_is_a_short_block(tmp_path):
    config = tiny_cell().config
    pool = P.Pool(config, str(tmp_path))
    block = (0, 300_000)
    pool.ensure([block], workers=1)
    payload = pool.payload(block)
    head = lzma2_chunks.first_chunk(payload)
    assert 0 < len(head) < len(payload)
    out = lzma.decompress(head + b"\x00", lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_LZMA2, "dict_size": config["dict_size"]}])
    assert P.original(config, block).startswith(out) and out


@pytest.mark.parametrize("size,prop", [(1 << 18, 12), (1 << 23, 22),
                                       (3 << 20, 19), (1 << 20, 16)])
def test_dict_prop(size, prop):
    assert P.dict_prop(size) == prop


def test_wrong_bytes_counts_differences_and_length():
    assert reference.wrong_bytes(b"abcd", b"abcd") == 0
    assert reference.wrong_bytes(b"abXd", b"abcd") == 1
    assert reference.wrong_bytes(b"ab", b"abcd") == 2
    assert reference.wrong_bytes(b"xbcdef", b"abcd") == 3
