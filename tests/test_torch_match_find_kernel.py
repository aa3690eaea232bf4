"""X2's kernel schedule, through its own pieces built for the CPU, against
the JAX package's ``find_matches``.

``csrc/match_find.cu`` sorts each pass's keys (a bitonic sort of tiles in
shared memory, merge rounds in global memory; the launch that places the
keys last records each position's rank), then one row launch writes every
position's row of both passes: a block owns a run of positions, reads the
row from its copy in shared memory (or, for a lane too long for it, from
global memory), stages a chunk's rows and stores them in position order.
The harness (``csrc/cpu_harness.cc``) calls the same pieces of
``match_find_lane.cuh`` in the kernels' order, at a given tile, run and
block (the kernel's, and two others: many merge rounds and runs of 32
positions, and one tile with a block of more threads than a chunk), with
the row staged or read in place, playing each stage's threads last to
first.  Every array must equal the JAX function's, int32 for int32
(tolerance 0): best length, best distance and every candidate distance, at
3 + 2 and 24 + 12 candidates.

Cases: the lanes of ``tests/test_torch_match_find.py`` (2^12, 2^16 with a
short lane, 2^17 where the int32 key loses hash bits); a lane of 2^16 with
one word whose hash lands in bucket -1, the bucket of the padded slots
before slot 0; an all-zero lane of 2^16 (one bucket holds the lane); lanes
with valid 0, 3, 7 and L - 12345 (the invalid marker wraps into bucket 0 at
2^16); lanes of 2^16 whose valid lengths end a block's run (8,192, 32,768,
L - 8,192 and L: run ends in every geometry); and a lane of 2^10 with more
candidates than any bucket has positions.  Each JAX reference is computed
once per module.  Each named mutant of the new pieces (a wrong rank, pass
2 reading pass 1's keys, pass 2 winning a tie, a row staged at its
neighbour's offset), built from a changed copy of the sources, must fail.
"""

from __future__ import annotations

import concurrent.futures
import functools
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu.ops import match_find as JM
from lzma_sdk_zliblike_tpu_torch.ops import match_find as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, file):
    """A helper module of tests/, loaded by path: on some machines a foreign
    package named ``tests`` shadows this directory."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


C = _load("lzt_corpus", "corpus.py")
H = _load("lzt_torch_cpu_harness", "torch_cpu_harness.py")

L64 = 1 << 16
BUCKET_M1_POS = 1000


def _rows(*raws):
    return np.stack([np.frombuffer(r, np.uint8) for r in raws])


def _bucket_m1_word() -> bytes:
    """The 4 bytes whose pass-1 hash is 0xFFFF at 16 hash bits: key
    0xFFFF0000 | pos at L = 2^16, bucket -1."""
    w0 = 0xFFFF1234 * pow(M.FIB, -1, 1 << 32) % (1 << 32)
    return w0.to_bytes(4, "little")


def _edge_lanes():
    """6 lanes of 2^16: the bucket -1 word in a zero lane, a zero lane, and
    big_mixed lanes with valid 0, 3, 7 and L - 12345."""
    m1 = bytearray(L64)
    m1[BUCKET_M1_POS:BUCKET_M1_POS + 4] = _bucket_m1_word()
    mixed = [C.big_mixed(L64, seed=s) for s in (31, 32, 33, 34)]
    return (_rows(bytes(m1), bytes(L64), *mixed),
            np.array([L64, L64, 0, 3, 7, L64 - 12345], np.int32))


CASES = {
    "jax_test_4k": lambda: (
        _rows(C.big_mixed(1 << 12), (b"abcdefgh" * 600)[:1 << 12],
              C.random_bytes(1 << 12, seed=7)),
        np.array([1 << 12, 1 << 12, (1 << 12) - 100], np.int32)),
    "short_lane_64k": lambda: (
        _rows(C.big_mixed(L64, seed=5), C.big_mixed(L64, seed=6)),
        np.array([L64, L64 - 3000], np.int32)),
    "key_wrap_128k": lambda: (_rows(C.big_mixed(1 << 17, seed=9)),
                              np.array([1 << 17], np.int32)),
    "edge_64k": _edge_lanes,
    "run_edges_64k": lambda: (
        _rows(*[C.big_mixed(L64, seed=s) for s in (51, 52, 53, 54)]),
        np.array([8192, 32768, L64 - 8192, L64], np.int32)),
}
ALL_CASES = {**CASES, "random_1k": lambda: (
    _rows(C.random_bytes(1 << 10, seed=41)), np.array([1 << 10], np.int32))}
CANDS = [(3, 2), (24, 12)]
# (tile keys, run, row block threads): the kernel's; small tiles, so 2^16
# takes 10 merge rounds, and runs of 32 positions (8 a chunk); one tile of
# the lane (2^12) or several, runs of 8,192 positions (cut to the lane) and
# more threads than a chunk's groups
GEOMS = [(H.X2_TILE, H.X2_RUN, H.X2_THREADS), (64, 32, 32), (4096, 8192, 2048)]


@pytest.fixture(scope="module")
def harness():
    lib = H.build()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


@functools.lru_cache(maxsize=None)
def _case(name):
    return ALL_CASES[name]()


@functools.lru_cache(maxsize=None)
def _jax(name, n_cand, n_cand8):
    data, valid = _case(name)
    bl, bd, cds = JM.find_matches(data, valid, n_cand=n_cand, n_cand8=n_cand8)
    return bl, bd, np.stack(cds, axis=-1)         # cands as [S, L, K]


def _harness(lib, name, n_cand, n_cand8, geom, staged=True):
    data, valid = _case(name)
    return H.match_find_batch(lib, data, valid, n_cand, n_cand8,
                              M.default_hash_bits(data.shape[1]), *geom,
                              staged=staged)


def _assert_identical(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _geom_id(g):
    return "x".join(map(str, g))


@pytest.mark.parametrize("row", ["staged", "global"])
@pytest.mark.parametrize("geom", GEOMS, ids=_geom_id)
@pytest.mark.parametrize("cands", CANDS, ids=lambda c: f"{c[0]}+{c[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_schedule_bit_identical_to_jax(harness, case, cands, geom, row):
    _assert_identical(_harness(harness, case, *cands, geom, row == "staged"),
                      _jax(case, *cands))


def _pass1_buckets(row: np.ndarray, valid: int) -> np.ndarray:
    """Pass 1's bucket of every position of a lane, from the port's
    ``sort_key`` (pinned to the JAX formula by
    ``tests/test_torch_match_find.py::test_sort_key_wraps_as_jax``)."""
    L = len(row)
    lb, hb = L.bit_length() - 1, M.default_hash_bits(L)
    w = np.zeros(L, np.uint64)
    for i in range(4):
        w[:L - i] |= row[i:].astype(np.uint64) << np.uint64(8 * i)
    h = (w * np.uint64(M.FIB) & np.uint64(0xFFFFFFFF)) >> np.uint64(32 - hb)
    key = M.sort_key(torch.from_numpy(h.astype(np.int32))[None],
                     torch.arange(L, dtype=torch.int32)[None],
                     torch.tensor([valid], dtype=torch.int32), 4, lb, hb)
    return (key[0] >> lb).numpy()


@pytest.mark.parametrize("geom", GEOMS, ids=_geom_id)
def test_more_candidates_than_any_bucket(harness, geom):
    """2^10 random bytes at 40 + 24 candidates: no bucket of pass 1 holds
    24 positions (pass 2's 8-byte buckets are finer), so most of each
    slot's candidates are other buckets' or the padded slots', and read 0
    as the JAX ones do."""
    _assert_identical(_harness(harness, "random_1k", 40, 24, geom),
                      _jax("random_1k", 40, 24))
    data, valid = _case("random_1k")
    _, counts = np.unique(_pass1_buckets(data[0], int(valid[0])),
                          return_counts=True)
    assert counts.max() < 24


def test_bucket_m1_gets_the_padded_slots(harness):
    """At L = 2^16 the word's key is 0xFFFF0000 | 1000, bucket -1.  The
    other positions whose bytes overlap it, 999 and 1003, land in lower
    negative buckets and fill slots 0 and 1 (the rest have buckets of 0 or
    more), so candidates 1 and 2 of position 1000 are of other buckets (0)
    and 3 and 4 are the padded slots of bucket -1 and position 0:
    distance 1000, measured against zero bytes."""
    b = _pass1_buckets(_case("edge_64k")[0][0], L64)
    assert b[BUCKET_M1_POS] == -1
    assert b[999] < -1 and b[1003] < -1
    assert min(b[p] for p in (997, 998, 1001, 1002)) >= 0
    for cands in CANDS:
        got = _harness(harness, "edge_64k", *cands, GEOMS[0])
        _assert_identical(got, _jax("edge_64k", *cands))
    assert list(got[2][0, BUCKET_M1_POS, :6]) == [0, 0] + [1000] * 4


def test_zero_lane_is_one_bucket(harness):
    """Every position of a zero lane hashes to 0, and the wrapped invalid
    marker lands in bucket 0 too: slot p is position p, candidate k of
    either pass is p - k for k <= p (0 past the lane's start: the padded
    slots are bucket -1), and every length is min(16, L - p)."""
    got = _harness(harness, "edge_64k", 24, 12, GEOMS[1])
    _assert_identical(got, _jax("edge_64k", 24, 12))
    bl, bd, cands = (a[1] for a in got)
    p = np.arange(L64)[:, None]
    for k0, n in ((0, 24), (24, 12)):
        k = np.arange(1, n + 1)[None]
        np.testing.assert_array_equal(cands[:, k0:k0 + n],
                                      np.where(k <= p, k, 0))
    np.testing.assert_array_equal(bl[1:], np.minimum(16, L64 - p[1:, 0]))
    np.testing.assert_array_equal(bd[1:], 1)
    assert bl[0] == bd[0] == 0


def test_short_valid_lanes(harness):
    """valid 0, 3 and 7: every position is past its prefix in pass 1 (at 3,
    also pass 2's 7), so all lie in the wrapped marker's bucket 0 and every
    length is min(lcp, max(valid - p, 0)); at L - 12345 the positions under
    the marker still get candidates."""
    got = _harness(harness, "edge_64k", 24, 12, GEOMS[2])
    _assert_identical(got, _jax("edge_64k", 24, 12))
    bl, _bd, cands = got
    assert (bl[2] == 0).all()
    assert bl[3].max() <= 3 and bl[4].max() <= 7
    v = L64 - 12345
    assert (cands[5, v:, 0] > 0).all()
    assert (bl[5, v:] == 0).all()


def test_plain_version_on_cpu_tensors():
    """``find_matches_tensor`` on CPU tensors is ``find_matches_plain``:
    candidates as a contiguous [S, K, L] tensor, and no kernel launch."""
    data, valid = _case("jax_test_4k")
    before = M.launches
    a = M.find_matches_tensor(torch.from_numpy(data), torch.from_numpy(valid),
                              n_cand=3, n_cand8=2, hash_bits=12)
    b = M.find_matches_plain(torch.from_numpy(data), torch.from_numpy(valid),
                             n_cand=3, n_cand8=2, hash_bits=12)
    assert M.launches == before
    assert a[2].shape == (3, 5, 1 << 12) and a[2].is_contiguous()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ref = _jax("jax_test_4k", 3, 2)
    _assert_identical((a[0].numpy(), a[1].numpy(),
                       a[2].permute(0, 2, 1).numpy()), ref)


# (file, text, mutant text): each changes one new piece of the kernels
MUTANTS = {
    "wrong_rank": ("match_find_lane.cuh", "rank[key & (L - 1)] = s;",
                   "rank[key & (L - 1)] = s ^ 1;"),
    "pass_2_reads_pass_1": ("match_find_lane.cuh",
                            "PassKeys{sorted + pass * SL + at,",
                            "PassKeys{sorted + at,"),
    "pass_2_wins_a_tie": ("match_find_lane.cuh", "b2.len > b1.len",
                          "b2.len >= b1.len"),
    "row_staged_at_wrong_offset": ("match_find_lane.cuh",
                                   "stage + i * (K1 + K2)",
                                   "stage + (i ^ 1) * (K1 + K2)"),
}


@pytest.fixture(scope="module")
def mutants(harness, tmp_path_factory):
    """{name: the harness built from a copy of the sources with that one
    change}, built in parallel (the directories made first: making them
    is not thread-safe)."""
    dirs = {name: tmp_path_factory.mktemp(name) for name in MUTANTS}

    def one(name):
        file, old, new = MUTANTS[name]
        d = dirs[name]
        for f in H.SOURCES:
            shutil.copy(os.path.join(H.CSRC, f), d / f)
        text = (d / file).read_text()
        assert text.count(old) == 1, (name, old)
        (d / file).write_text(text.replace(old, new))
        return H.build(str(d), str(d))
    with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
        return dict(zip(MUTANTS, pool.map(one, MUTANTS)))


@pytest.mark.parametrize("name", list(MUTANTS))
def test_mutant_fails(mutants, name):
    """The check that holds the schedule to the JAX function catches each
    mutant, with the row staged, on the 4 KiB lanes at 24 + 12."""
    with pytest.raises(AssertionError):
        _assert_identical(_harness(mutants[name], "jax_test_4k", 24, 12,
                                   GEOMS[0]),
                          _jax("jax_test_4k", 24, 12))
