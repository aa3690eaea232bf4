"""The PyTorch/CUDA port's match finder X2 against the JAX package's.

``ops/match_find.find_matches(device="cpu")`` must give the JAX package's
``find_matches`` outputs bit for bit (best length, best distance and every
candidate distance): on the JAX test's data, on a short lane at 2^16, and at
2^17 where the int32 sort key drops hash bits, at the default 3 + 2
candidates and at the device-assisted encoder's 24 + 12.  Then the JAX
package's three tests of the finder, run on the port, and a pin of the key's
wrap.
"""

from __future__ import annotations

import importlib.util
import os
from collections import defaultdict

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu.ops import match_find as JM
from lzma_sdk_zliblike_tpu_torch.ops import match_find as M
from lzma_sdk_zliblike_tpu_torch.utils.errors import UnsupportedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus():
    """tests/corpus.py, loaded by path: on some machines a foreign package
    named ``tests`` shadows this directory."""
    spec = importlib.util.spec_from_file_location(
        "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CORPUS = _corpus()
big_mixed, random_bytes = _CORPUS.big_mixed, _CORPUS.random_bytes


def _rows(*raws):
    return np.stack([np.frombuffer(r, np.uint8) for r in raws])


def _jax_test_lanes():
    """The lanes of the JAX package's test_candidates_are_real_matches."""
    L = 1 << 12
    data = _rows(big_mixed(L), (b"abcdefgh" * 600)[:L],
                 random_bytes(L, seed=7))
    return data, np.array([L, L, L - 100], np.int32)


def _short_lane():
    L = 1 << 16
    return (_rows(big_mixed(L, seed=5), big_mixed(L, seed=6)),
            np.array([L, L - 3000], np.int32))


def _wrap_lane():
    L = 1 << 17
    return _rows(big_mixed(L, seed=9)), np.array([L], np.int32)


CASES = {"jax_test_4k": _jax_test_lanes, "short_lane_64k": _short_lane,
         "key_wrap_128k": _wrap_lane}


@pytest.mark.parametrize("cands", [(3, 2), (24, 12)], ids=["3+2", "24+12"])
@pytest.mark.parametrize("case", list(CASES))
def test_bit_identical_to_jax(case, cands):
    data, valid = CASES[case]()
    n_cand, n_cand8 = cands
    ref = JM.find_matches(data, valid, n_cand=n_cand, n_cand8=n_cand8)
    got = M.find_matches(data, valid, n_cand=n_cand, n_cand8=n_cand8,
                         device="cpu")
    assert len(got[2]) == len(ref[2]) == n_cand + n_cand8
    for a, b in zip(got[:2] + got[2], ref[:2] + ref[2]):
        assert a.dtype == np.int32 and a.shape == data.shape
        np.testing.assert_array_equal(a, b)
    assert (got[1] > 0).any()


def test_tensors_in_numpy_out():
    data, valid = _jax_test_lanes()
    a = M.find_matches(torch.from_numpy(data), torch.from_numpy(valid),
                       device="cpu")
    b = M.find_matches(data, valid.tolist(), device="cpu")
    for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
        assert isinstance(x, np.ndarray)
        np.testing.assert_array_equal(x, y)


def test_chunk_length_must_be_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        M.find_matches(np.zeros((1, 100), np.uint8), [100], device="cpu")


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, valid = _jax_test_lanes()
    with pytest.raises(UnsupportedError):
        M.find_matches(data, valid)


# -- the JAX package's tests (tests/test_match_find.py), on the port ---------

def test_candidates_are_real_matches():
    data, valid = _jax_test_lanes()
    bl, bd, cands = M.find_matches(data, valid, device="cpu")
    for s in range(3):
        v = int(valid[s])
        for p in range(v):
            d = int(bd[s, p])
            ln = int(bl[s, p])
            if d == 0:
                continue
            assert 0 < d <= p, (s, p, d)
            assert 0 <= ln <= 16
            lim = min(ln, v - p)
            assert (data[s, p - d:p - d + lim] == data[s, p:p + lim]).all(), \
                (s, p, d, ln)
        for c in cands:
            dd = int(c[s, min(v - 5, 97)])
            assert 0 <= dd <= min(v - 5, 97)


def test_finds_obvious_repeats():
    L = 1 << 10
    pat = b"the quick brown fox jumps over the lazy dog. "
    data = _rows((pat * 40)[:L])
    bl, bd, _ = M.find_matches(data, np.array([L], np.int32), device="cpu")
    hits = sum(1 for p in range(len(pat) + 4, L - 20)
               if int(bl[0, p]) >= 16 and int(bd[0, p]) % len(pat) == 0)
    assert hits > (L - len(pat) - 24) * 0.9, hits


def test_quality_close_to_host_chain():
    """>= 4-byte matches found for most positions where a brute host search
    for the nearest earlier equal 4-byte prefix finds one."""
    L = 1 << 12
    raw = big_mixed(L, seed=11)
    bl, bd, cands = M.find_matches(_rows(raw), np.array([L], np.int32),
                                   device="cpu")
    last = defaultdict(list)
    found = dev_found = 0
    for p in range(L - 4):
        key = raw[p:p + 4]
        if last[key]:
            found += 1
            if int(bd[0, p]) > 0 and int(bl[0, p]) >= 4:
                dev_found += 1
            elif any(int(c[0, p]) > 0
                     and raw[p - int(c[0, p]):p - int(c[0, p]) + 4] == key
                     for c in cands):
                dev_found += 1
        last[key].append(p)
    assert dev_found >= found * 0.95, (dev_found, found)


def test_sort_key_wraps_as_jax():
    """A pin of the JAX package's int32 key (``(hh << lb) | pos``,
    ``ops/match_find.py:68``): at L = 2^17 and 17 hash bits the shift keeps
    15 of them, so a lane of random bytes, which has more than 2^15 distinct
    hashes, lands in at most 2^15 buckets; and the invalid-position marker
    ``1 << 17`` lands in bucket 0.  The port keeps the wrap, so that its
    candidates equal the JAX package's."""
    L, hash_bits = 1 << 17, 17
    lb = (L - 1).bit_length()
    raw = np.frombuffer(random_bytes(L, seed=21), np.uint8).astype(np.uint64)
    w0 = raw.copy()
    for i in range(1, 4):
        w0[:-i] |= raw[i:] << np.uint64(8 * i)
    h = ((w0 * M.FIB) & 0xFFFFFFFF) >> (32 - hash_bits)
    valid = L - 1000
    pos = torch.arange(L, dtype=torch.int32)[None]
    key = M.sort_key(torch.from_numpy(h.astype(np.int32))[None], pos,
                     torch.tensor([valid], dtype=torch.int32), 4, lb,
                     hash_bits)
    assert key.dtype == torch.int32
    buckets = (key >> lb)[0]
    assert len(np.unique(h[:valid - 3])) > 1 << 15
    assert len(torch.unique(buckets)) <= 1 << 15
    assert int(buckets.min()) >= -(1 << 14) and int(buckets.max()) < 1 << 14
    assert (buckets[valid - 3:] == 0).all()       # the wrapped marker
    # the same bits as the JAX formula in numpy's wrapping int32
    ref = ((h.astype(np.int64) << lb) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)
    ref = np.where(np.arange(L) + 4 > valid, np.int32(0), ref) \
        | np.arange(L, dtype=np.int32)
    np.testing.assert_array_equal(key[0].numpy(), ref)


@pytest.mark.cuda
def test_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for make in CASES.values():
        data, valid = make()
        for n_cand, n_cand8 in ((3, 2), (24, 12)):
            a = M.find_matches(data, valid, n_cand=n_cand, n_cand8=n_cand8)
            b = M.find_matches(data, valid, n_cand=n_cand, n_cand8=n_cand8,
                               device="cpu")
            for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
                np.testing.assert_array_equal(x, y)
