"""The traffic generator: what a seed sends."""

import collections

import pytest

from port_bench import spec, traffic


def cells():
    bench = spec.load()
    return [spec.cell(bench, w["name"]) for w in bench["workloads"]]


def ids(cell):
    return cell.name


@pytest.mark.parametrize("cell", cells(), ids=ids)
def test_a_seed_selects_the_same_files(cell):
    mix, size = cell.traffic, cell.config["block_size"]
    full, tail, _ = traffic.shape(mix, size)
    for seed in (0, 7, 2**31 + 12345, 3 * 2**32 + 1, -5):
        a, b = traffic.files(mix, seed, size), traffic.files(mix, seed, size)
        assert a == b
        for f in a:
            assert sum(n for _, n in f) == mix["file_bytes"]
            assert [n for _, n in f] == [size] * full + [tail] * (tail > 0)
            assert len(set(f)) == len(f)
    assert traffic.files(mix, 1, size) != traffic.files(mix, 2, size)


@pytest.mark.parametrize("cell", cells(), ids=ids)
def test_every_seed_sends_every_block_equally_often(cell):
    mix, size = cell.traffic, cell.config["block_size"]
    full, tail, pool = traffic.shape(mix, size)
    for seed in (3, 2**31 + 99):
        files = traffic.files(mix, seed, size)
        use = collections.Counter(b for f in files for b in f)
        full_use = {b: n for b, n in use.items() if b[1] == size}
        assert set(full_use) == {(i, size) for i in range(pool)}
        assert len(set(full_use.values())) == 1
        assert {b for b in use if b[1] != size} == {
            (pool + j, tail) for j in range(len(files))}


@pytest.mark.parametrize("cell", cells(), ids=ids)
def test_a_file_is_cut_as_xz_cuts_it(cell):
    """xz -T0 cuts silesia.tar into blocks of the configuration's size,
    the last one short."""
    mix = cell.traffic
    full, tail, pool = traffic.shape(mix, cell.config["block_size"])
    assert mix["file_bytes"] == 211_957_760
    assert full * cell.config["block_size"] + tail == mix["file_bytes"]
    assert {"xz_T0_preset6.bulk": (8, 10_631_168, 12),
            "xz_T0_preset0.bulk": (202, 145_408, 303),
            "xz_T0_preset0.xzfile": (202, 145_408, 303)}[cell.name] == (
                full, tail, pool)


def test_a_file_under_a_block_is_one_short_block():
    mix = {"kind": "closed_loop_files", "callers": 1, "file_bytes": 500,
           "pool_per_file": 1.5, "check_calls": 1}
    assert traffic.files(mix, 9, 1024) == [[(0, 500)]]
    files = traffic.files(dict(mix, file_bytes=2048), 9, 1024)
    assert len(files) == 3          # a pool of 3 full blocks, 2 a file
    for f in files:
        assert len(f) == 2 and {n for _, n in f} == {1024}
        assert {i for i, _ in f} < {0, 1, 2}


def test_sample_is_drawn_from_the_seed():
    def draw(seed, n=50):
        s = traffic.Sample(4, seed)
        for i in range(n):
            s.offer(i)
        return sorted(s.items)
    assert draw(5) == draw(5)
    assert draw(5) != draw(6)
    assert draw(5, 3) == [0, 1, 2]


def test_a_mix_the_generator_cannot_read_is_refused():
    mix = dict(cells()[0].traffic)
    with pytest.raises(ValueError):
        traffic.files(dict(mix, kind="open_loop"), 1, 1024)
    with pytest.raises(ValueError):
        traffic.files(dict(mix, pool_per_file=0.5), 1, 1024)
    with pytest.raises(ValueError):
        traffic.files(dict(mix, file_bytes=0), 1, 1024)
