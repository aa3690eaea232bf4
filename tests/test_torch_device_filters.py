"""The port's batched filters X4 against the JAX package's.

Every function of ``ops/device_filters.py`` on the CPU (torch ops, and the
plain versions of the x86 and BCJ2 kernels) must give the JAX package's
rows byte for byte on the same inputs: the whole ``[S, L]`` row for the
converters and delta, padding past ``valid`` included; for BCJ2 ``ok`` flag
for flag on every lane (truncated rc, call, jump and main streams among
them) and ``out`` over the whole row on every lane where ``ok`` is true.
The x86 and BCJ2 kernels' pieces in ``csrc/filters_lane.cuh``, built for
the CPU by the harness and run at the kernels' block geometry, must equal
the plain versions (``test_torch_filters_segmented.py`` runs them at other
geometries); on a card, so must the kernels.
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
from lzma_sdk_zliblike_tpu_torch.utils.errors import UnsupportedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["arm", "armt", "ppc", "sparc", "ia64", "x86"]


def _load(name, file):
    """A helper module of tests/, loaded by path: on some machines a foreign
    package named ``tests`` shadows this directory."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FB = _load("lzt_filter_batches", "torch_filter_batches.py")
random_bytes = FB.random_bytes
_mk_batch = FB.salted_batch


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("encoding", [True, False])
def test_branch_batch_matches_jax(name, encoding):
    data, valid, ip = _mk_batch(seed=NAMES.index(name) * 101 + 3)
    ref = JDF.convert_batch(name, data, valid, ip, encoding=encoding)
    out = DF.convert_batch(name, data, valid, ip, encoding=encoding,
                           device="cpu")
    assert out.shape == ref.shape and np.array_equal(out, ref), name
    assert int((out != data[:, :out.shape[1]]).sum()) > 0
    host = {"x86": lambda b, i, encoding: F.x86_convert(b, i, encoding)[0]}
    fn = host.get(name, getattr(F, f"{name}_convert"))
    for s in range(len(valid)):
        n = int(valid[s])
        assert out[s, :n].tobytes() == fn(data[s, :n].tobytes(), int(ip[s]),
                                          encoding=encoding), (name, s)


@pytest.mark.parametrize("name", ["arm", "armt", "ppc", "sparc", "ia64"])
@pytest.mark.parametrize("encoding", [True, False])
def test_negative_valid_matches_jax(name, encoding):
    """The five converters compare positions with ``valid`` as uint32, as
    the JAX functions do: lanes of valid -1 and -4096 convert their whole
    rows, a lane of 2^31 - 1 its whole row too."""
    data, valid, ip = FB.negative_valid_batch()
    ref = JDF.convert_batch(name, data, valid, ip, encoding=encoding)
    out = DF.convert_batch(name, data, valid, ip, encoding=encoding,
                           device="cpu")
    assert out.shape == ref.shape and np.array_equal(out, ref), name
    for s in range(3):
        assert not np.array_equal(out[s], data[s, :out.shape[1]]), s


@pytest.mark.parametrize("encoding", [True, False])
def test_x86_edge_lanes_match_jax(encoding):
    data, valid, ip = FB.x86_edge_batch()
    ref = JDF.convert_batch("x86", data, valid, ip, encoding=encoding)
    out = DF.convert_batch("x86", data, valid, ip, encoding=encoding,
                           device="cpu")
    assert np.array_equal(out, ref)
    assert np.array_equal(out[:3], data[:3])        # valid < 5: untouched
    for s in range(3, 9):                           # 5 bytes convert
        assert not np.array_equal(out[s], data[s]), s


@pytest.mark.parametrize("encoding", [True, False])
def test_x86_valid_past_row_matches_jax(encoding):
    data, valid, ip = FB.x86_past_row_batch()
    ref = JDF.convert_batch("x86", data, valid, ip, encoding=encoding)
    out = DF.convert_batch("x86", data, valid, ip, encoding=encoding,
                           device="cpu")
    assert np.array_equal(out, ref)
    short = DF.convert_batch("x86", data, np.minimum(valid, 64), ip,
                             encoding=encoding, device="cpu")
    assert not np.array_equal(out, short)     # the clamped steps convert


@pytest.mark.parametrize("name", NAMES)
def test_branch_batch_roundtrip(name):
    data, valid, ip = _mk_batch(seed=NAMES.index(name) * 97 + 7)
    ip = ip & ~np.uint32(15)
    enc = DF.convert_batch(name, data, valid, ip, encoding=True, device="cpu")
    dec = DF.convert_batch(name, enc, valid, ip, encoding=False, device="cpu")
    assert np.array_equal(dec, data[:, :dec.shape[1]]), name


@pytest.mark.parametrize("dist", [1, 2, 3, 4, 16, 255])
def test_delta_batch_matches_jax(dist):
    S, L = 4, 3000
    data = np.frombuffer(random_bytes(S * L, seed=dist), np.uint8).reshape(
        S, L).copy()
    valid = np.array([L, L - 7, 13, 0], np.int32)
    for encoding in (True, False):
        ref = np.asarray(JDF.delta_batch(data, valid, dist=dist,
                                         encoding=encoding))
        out = DF.delta_batch(torch.from_numpy(data), torch.from_numpy(valid),
                             dist=dist, encoding=encoding).numpy()
        assert np.array_equal(out, ref), (dist, encoding)
    enc = DF.delta_batch(torch.from_numpy(data), torch.from_numpy(valid),
                         dist=dist, encoding=True)
    dec = DF.delta_batch(enc, torch.from_numpy(valid), dist=dist,
                         encoding=False).numpy()
    assert np.array_equal(dec, data)


# ---------------------------------------------------------------------------
# BCJ2
# ---------------------------------------------------------------------------

def bcj2_batch():
    """(streams, lens, out_size, originals): the corpus's four lanes, then
    lanes 4-9 of ``bcj2_lanes``' edge cases."""
    datas = FB.bcj2_corpus()
    streams, lens, out_size, _ = FB.bcj2_lanes(datas, F.bcj2_encode,
                                                edge=True)
    return streams, lens, out_size, datas


def _bcj2_args(streams, lens, out_size, device="cpu"):
    args = []
    for a, n in zip(streams, lens):
        args += [torch.from_numpy(a).to(device),
                 torch.from_numpy(n).to(device)]
    return args + [torch.from_numpy(out_size).to(device)]


@pytest.fixture(scope="module")
def bcj2_plain():
    streams, lens, out_size, datas = bcj2_batch()
    out, ok = DF.bcj2_decode_batch(*_bcj2_args(streams, lens, out_size))
    return (streams, lens, out_size, datas), out.numpy(), ok.numpy()


def test_bcj2_decode_batch_matches_jax(bcj2_plain):
    (streams, lens, out_size, datas), out, ok = bcj2_plain
    ref_out, ref_ok = _jax_bcj2(streams, lens, out_size)
    assert ok.tolist() == ref_ok.tolist()
    assert ok.tolist() == [True] * 4 + [False] * 4 + [True, False]
    assert out.shape == ref_out.shape
    for s in np.flatnonzero(ok):
        assert np.array_equal(out[s], ref_out[s]), s
    for s, d in enumerate(datas):
        assert out[s, :len(d)].tobytes() == d, s
    assert out[8, :out_size[8]].tobytes() == datas[0][:-1]
    assert sum(int(n) for n in lens[1][:4]) > 0, "no call conversions"


def _jax_bcj2(streams, lens, out_size):
    import jax.numpy as jnp
    args = []
    for a, n in zip(streams, lens):
        args += [jnp.asarray(a), jnp.asarray(n)]
    ref_out, ref_ok = JDF.bcj2_decode_batch(*args, jnp.asarray(out_size))
    return np.asarray(ref_out), np.asarray(ref_ok)


def test_bcj2_lengths_past_rows_match_jax():
    streams, lens, out_size = FB.bcj2_past_row_batch(F.bcj2_encode)
    ref_out, ref_ok = _jax_bcj2(streams, lens, out_size)
    out, ok = DF.bcj2_decode_batch(*_bcj2_args(streams, lens, out_size))
    assert ok.tolist() == ref_ok.tolist() == [True] * 3 + [False]
    for s in np.flatnonzero(ref_ok):
        assert np.array_equal(out[s].numpy(), ref_out[s]), s


def test_bcj2_main_ending_on_a_site():
    """A site in a row's last byte ends the plain scan (the JAX function's
    never ends there, so the host decoder is the reference)."""
    streams, lens, out_size, datas = FB.bcj2_site_at_end(F.bcj2_encode)
    assert streams[0].shape[1] == 256 and (lens[0] == 256).all()
    out, ok = DF.bcj2_decode_batch(*_bcj2_args(streams, lens, out_size))
    assert ok.all()
    for s, d in enumerate(datas):
        args = [streams[k][s, :lens[k][s]].tobytes() for k in range(4)]
        assert F.bcj2_decode(*args, len(d)) == d
        assert out[s, :len(d)].numpy().tobytes() == d


def test_bcj2_plain_matches_host_decoder(bcj2_plain):
    (streams, lens, out_size, datas), out, _ = bcj2_plain
    for s in range(4):
        args = [streams[k][s, :lens[k][s]].tobytes() for k in range(4)]
        assert F.bcj2_decode(*args, int(out_size[s])) == datas[s]
        assert out[s, :out_size[s]].tobytes() == datas[s]


# ---------------------------------------------------------------------------
# the kernels' own lane source, built for the CPU, against the plain versions
# ---------------------------------------------------------------------------

H = _load("lzt_torch_cpu_harness", "torch_cpu_harness.py")


@pytest.fixture(scope="module")
def harness():
    lib = H.build()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


X86_BATCHES = {"salted": lambda: _mk_batch(seed=5),
               "edge": FB.x86_edge_batch, "past_row": FB.x86_past_row_batch}


@pytest.mark.parametrize("batch", list(X86_BATCHES))
@pytest.mark.parametrize("encoding", [True, False])
def test_harness_x86_matches_plain(harness, batch, encoding):
    data, valid, ip = X86_BATCHES[batch]()
    plain = DF.convert_batch("x86", data, valid, ip, encoding=encoding,
                             device="cpu")
    assert np.array_equal(H.x86_batch(harness, data, valid, ip, encoding),
                          plain)


def _check_harness_bcj2(lib, streams, lens, out_size, out, ok):
    h_out, h_ok, _ = H.bcj2_batch(lib, streams, lens, out_size)
    assert h_ok.tolist() == ok.tolist()
    for s in np.flatnonzero(ok):
        assert np.array_equal(h_out[s], out[s]), s


def test_harness_bcj2_matches_plain(harness, bcj2_plain):
    (streams, lens, out_size, _), out, ok = bcj2_plain
    _check_harness_bcj2(harness, streams, lens, out_size, out, ok)


@pytest.mark.parametrize("batch", ["past_row", "site_at_end"])
def test_harness_bcj2_edge_rows_match_plain(harness, batch):
    batch = (FB.bcj2_past_row_batch(F.bcj2_encode) if batch == "past_row"
             else FB.bcj2_site_at_end(F.bcj2_encode)[:3])
    out, ok = DF.bcj2_decode_batch(*_bcj2_args(*batch))
    _check_harness_bcj2(harness, *batch, out.numpy(), ok.numpy())


def test_device_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data, valid, ip = _mk_batch(seed=1)
    with pytest.raises(UnsupportedError):
        DF.convert_batch("x86", data, valid, ip, encoding=True)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(bcj2_plain):
    """The kernels on every batch of the CPU tests, the adversarial ones of
    the segmented design among them (E8 every 3 bytes, sites around the
    kernel's span starts, sites in a row's last bytes at every valid, BCJ2
    sites after a converted 0F top and cut or exhausted streams)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x86 = dict(X86_BATCHES, every3=FB.x86_every3_batch,
               span_edge=lambda: FB.x86_span_edge_batch(H.X86_TILE
                                                        // H.X86_SPANS),
               tail=FB.x86_tail_batch)
    for make in x86.values():
        for encoding in (True, False):
            plain = DF.convert_batch("x86", *make(), encoding=encoding,
                                     device="cpu")
            kern = DF.convert_batch("x86", *make(), encoding=encoding)
            assert np.array_equal(kern, plain)
    (streams, lens, out_size, _), _out, _ok = bcj2_plain
    for batch in ((streams, lens, out_size),
                  FB.bcj2_past_row_batch(F.bcj2_encode),
                  FB.bcj2_site_at_end(F.bcj2_encode)[:3],
                  FB.bcj2_mixed_batch()[:3]):
        out, ok = DF.bcj2_decode_batch(*_bcj2_args(*batch))
        k_out, k_ok = DF.bcj2_decode_batch(*_bcj2_args(*batch, "cuda"))
        torch.cuda.synchronize()
        assert k_ok.cpu().tolist() == ok.tolist()
        for s in np.flatnonzero(ok.numpy()):
            assert torch.equal(k_out[s].cpu(), out[s]), s
