"""X4's segmented x86 and BCJ2 kernels, through their own pieces built for
the CPU, against the plain versions and the JAX package's functions.

``csrc/device_filters.cu`` runs x86 as a block per lane whose threads each
run the machine from one sync point to the next over tiles of the row, and
BCJ2 as a listing of candidate sites, one thread's range-decoder walk over
them and a placement of every output byte.  The harness
(``csrc/cpu_harness.cc``) calls the same pieces of ``filters_lane.cuh`` in
the kernels' order, at a given number of spans and tile bytes (x86) or
block threads (BCJ2), running each tile's threads last to first.  Every
batch must come out equal to ``x86_convert_plain`` / ``bcj2_decode_plain``
with tolerance 0 (integer programs): the whole row for x86, and for BCJ2
``ok`` flag for flag and ``out`` on every ok lane.  The adversarial batches
(``tests/torch_filter_batches.py``) are also held to the JAX functions.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu.ops import device_filters as JDF
from lzma_sdk_zliblike_tpu_torch.ops import device_filters as DF
from lzma_sdk_zliblike_tpu_torch.ops import filters as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, file):
    """A helper module of tests/, loaded by path: on some machines a foreign
    package named ``tests`` shadows this directory."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FB = _load("lzt_filter_batches", "torch_filter_batches.py")
H = _load("lzt_torch_cpu_harness", "torch_cpu_harness.py")


@pytest.fixture(scope="module")
def harness():
    lib = H.build()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


# ---------------------------------------------------------------------------
# x86
# ---------------------------------------------------------------------------

# (spans, tile bytes): the kernel's, one span a tile, a prime number of
# spans over a prime tile, spans of 1, 2 and 3 bytes, spans of 8 and 10,
# and tiles down to the 4-byte least
X86_GEOMS = [(H.X86_SPANS, H.X86_TILE), (1, H.X86_TILE), (13, 37), (64, 64),
             (32, 64), (32, 96), (8, 64), (7, 70), (3, 4), (2, 5)]
X86_BATCHES = {"salted": lambda: FB.salted_batch(5),
               "edge": FB.x86_edge_batch, "past_row": FB.x86_past_row_batch,
               "every3": FB.x86_every3_batch, "tail": FB.x86_tail_batch}

_plain_cache = {}


def _x86_plain(key, make, encoding):
    if (key, encoding) not in _plain_cache:
        _plain_cache[key, encoding] = DF.convert_batch(
            "x86", *make(), encoding=encoding, device="cpu")
    return _plain_cache[key, encoding]


@pytest.mark.parametrize("geom", X86_GEOMS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("batch", list(X86_BATCHES))
@pytest.mark.parametrize("encoding", [True, False])
def test_harness_x86_segmented_matches_plain(harness, batch, geom,
                                             encoding):
    data, valid, ip = X86_BATCHES[batch]()
    plain = _x86_plain(batch, X86_BATCHES[batch], encoding)
    got = H.x86_batch(harness, data, valid, ip, encoding, *geom)
    assert np.array_equal(got, plain)


# spans of w bytes over tiles that are a multiple of w, so that the span
# starts are the multiples of w that x86_span_edge_batch(w) is built on
SPAN_EDGE_GEOMS = [(H.X86_SPANS, H.X86_TILE), (8, 64), (16, 96), (7, 70),
                   (4, 28)]


@pytest.mark.parametrize("geom", SPAN_EDGE_GEOMS,
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("encoding", [True, False])
def test_harness_x86_span_edges_match_plain(harness, geom, encoding):
    w = geom[1] // geom[0]
    data, valid, ip = FB.x86_span_edge_batch(w)
    plain = _x86_plain(f"span_edge{w}", lambda: FB.x86_span_edge_batch(w),
                       encoding)
    assert np.array_equal(
        H.x86_batch(harness, data, valid, ip, encoding, *geom), plain)
    # the batch converts at the starts it was built on
    assert (plain != data).any(axis=1).all()


def _no_sync_point_past_0(data):
    cand = (data & 0xFE) == 0xE8
    for s in range(1, data.shape[1]):
        if not cand[:, max(0, s - 4):s].any(axis=1).all():
            return False
    return True


X86_ADVERSARIAL = {"every3": FB.x86_every3_batch,
                   "span_edge": lambda: FB.x86_span_edge_batch(8),
                   "tail": FB.x86_tail_batch}


@pytest.mark.parametrize("batch", list(X86_ADVERSARIAL))
@pytest.mark.parametrize("encoding", [True, False])
def test_x86_adversarial_matches_jax(batch, encoding):
    data, valid, ip = X86_ADVERSARIAL[batch]()
    ref = JDF.convert_batch("x86", data, valid, ip, encoding=encoding)
    out = _x86_plain(f"adv_{batch}", X86_ADVERSARIAL[batch], encoding)
    assert np.array_equal(out, ref)
    if batch == "every3":
        assert _no_sync_point_past_0(data)
        host = [F.x86_convert(data[s].tobytes(), int(ip[s]), encoding)[0]
                for s in range(len(valid))]
        assert [r.tobytes() for r in out] == host
    if batch == "tail":      # the clamped steps past row + 3 convert
        short = DF.convert_batch("x86", data, np.minimum(valid, 64), ip,
                                 encoding=encoding, device="cpu")
        assert not np.array_equal(out, short)


def test_x86_every3_roundtrip():
    data, valid, ip = FB.x86_every3_batch()
    enc = DF.convert_batch("x86", data, valid, ip, encoding=True,
                           device="cpu")
    assert (enc != data).any(axis=1).all()
    dec = DF.convert_batch("x86", enc, valid, ip, encoding=False,
                           device="cpu")
    assert np.array_equal(dec, data)


# ---------------------------------------------------------------------------
# BCJ2
# ---------------------------------------------------------------------------

def _bcj2_args(streams, lens, out_size):
    args = []
    for a, n in zip(streams, lens):
        args += [torch.from_numpy(np.ascontiguousarray(a)),
                 torch.from_numpy(n)]
    return args + [torch.from_numpy(out_size)]


def _corpus_edge():
    return FB.bcj2_lanes(FB.bcj2_corpus(), F.bcj2_encode, edge=True)[:3]


BCJ2_BATCHES = {"corpus_edge": _corpus_edge,
                "past_row": lambda: FB.bcj2_past_row_batch(F.bcj2_encode),
                "site_at_end": lambda: FB.bcj2_site_at_end(
                    F.bcj2_encode)[:3],
                "mixed": lambda: FB.bcj2_mixed_batch()[:3]}
BCJ2_THREADS = [H.BCJ2_THREADS, 1, 2, 3, 7, 64]


@pytest.fixture(scope="module")
def bcj2_plain():
    res = {}
    for name, make in BCJ2_BATCHES.items():
        batch = make()
        out, ok = DF.bcj2_decode_batch(*_bcj2_args(*batch))
        res[name] = batch, out.numpy(), ok.numpy()
    return res


@pytest.mark.parametrize("threads", BCJ2_THREADS)
@pytest.mark.parametrize("batch", list(BCJ2_BATCHES))
def test_harness_bcj2_segmented_matches_plain(harness, bcj2_plain, batch,
                                              threads):
    (streams, lens, out_size), out, ok = bcj2_plain[batch]
    h_out, h_ok, info = H.bcj2_batch(harness, streams, lens, out_size,
                                     threads)
    assert h_ok.tolist() == ok.tolist()
    for s in np.flatnonzero(ok):
        assert np.array_equal(h_out[s], out[s]), s
    # candidates >= decoder steps >= conversions; ok as returned
    assert (info[:, 0] >= info[:, 2]).all()
    assert (info[:, 2] >= info[:, 1]).all()
    assert info[:, 3].tolist() == h_ok.astype(np.int32).tolist()


def test_bcj2_mixed_matches_jax_and_host(bcj2_plain):
    """The mixed batch (sites after a converted 0F top, cut outputs and
    streams) against the JAX function on every lane but the last (whose
    site in the row's last byte the JAX scan never leaves), and the ok
    lanes against the host decoder and the originals."""
    import jax.numpy as jnp
    (streams, lens, out_size), out, ok = bcj2_plain["mixed"]
    datas = FB.bcj2_mixed_batch()[3]
    args = []
    for a, n in zip(streams, lens):
        args += [jnp.asarray(a[:-1]), jnp.asarray(n[:-1])]
    ref_out, ref_ok = JDF.bcj2_decode_batch(*args, jnp.asarray(out_size[:-1]))
    ref_out, ref_ok = np.asarray(ref_out), np.asarray(ref_ok)
    assert ok[:-1].tolist() == ref_ok.tolist()
    for s in np.flatnonzero(ref_ok):
        assert np.array_equal(out[s], ref_out[s]), s
    # lanes 0-2 whole, 3-7 cut outputs, 8-11 call or jump run out
    assert ok[:8].all() and not ok[8:12].any() and ok[-1]
    for s, d in enumerate(datas):
        assert out[s, :len(d)].tobytes() == d
    for s in (3, 4, 5, len(ok) - 1):
        n = int(out_size[s])
        args = [streams[k][s, :lens[k][s]].tobytes() for k in range(4)]
        assert out[s, :n].tobytes() == F.bcj2_decode(*args, n), s
    # out_size 35 and 37 cut the rel32 of the site at 33, whose bytes land
    # past out_size; main_used = out_size - 4 * conversions then falls short
    # of the main bytes before the site, which the JAX function leaves 0
    # (the host decoder stops inside the rel32 instead)
    for s in (6, 7):
        n = int(out_size[s])
        assert out[s, n:n + 8].tobytes() != bytes(8), s


def test_bcj2_mixed_takes_prev_from_a_top_of_0f(harness, bcj2_plain):
    """The mixed batch has sites right after a converted site whose rel32
    ends in 0F, and the harness steps there: its decoder steps on lane 0
    pass the E8/E9 bytes of the main stream plus its Jcc bytes after a 0F
    byte of the main stream, so Jcc bytes after a converted site with a 0F
    top were decoded as sites (and the lane still decodes to its
    original)."""
    (streams, lens, out_size), out, _ok = bcj2_plain["mixed"]
    d = np.frombuffer(FB.bcj2_mixed_batch()[3][0], np.uint8)
    pos = [p for p in range(len(d) - 5)
           if d[p] in (0xE8, 0xE9) and d[p + 4] == 0x0F
           and (d[p + 5] in (0xE8, 0xE9) or (d[p + 5] & 0xF0) == 0x80)]
    assert len(pos) > 50
    h_out, h_ok, info = H.bcj2_batch(harness, streams, lens, out_size)
    assert h_ok[0] and np.array_equal(h_out[0], out[0])
    m = streams[0][0, :lens[0][0]].astype(np.int64)
    e8e9 = int(((m & 0xFE) == 0xE8).sum())
    jcc_main = int((((m[1:] & 0xF0) == 0x80) & (m[:-1] == 0x0F)).sum())
    assert info[0, 2] > e8e9 + jcc_main + 1
