"""X4's fixed-alignment kernels, through their own pieces built for the CPU,
against the plain versions and the JAX package's functions.

``csrc/branch_filters.cu`` gives a thread 16 bytes of a lane (four ARM, PPC
or SPARC words, eight Thumb halfwords gathered from their neighbours, an
IA64 bundle, or delta encode's gather of the bytes ``dist`` before them)
and runs delta decode as three launches over segments of whole rows:
per-segment class totals, their carries along each lane, and each
segment's scan from its carry (a column walk for distances over 256, or
whose row has more columns than a block has threads).  The harness (``csrc/cpu_harness.cc``) calls the same
pieces of ``branch_filters_lane.cuh`` in the kernels' order, each lane's
units and each block's threads last to first, delta's launches with their
blocks first to last and last to first, at the kernels' geometry and, for
delta, at small ones too (16 threads of a word each: segments of at most
64 bytes, so rows cross hundreds of them).  Every row must equal the plain
version's and the JAX function's, byte for byte over the whole row
(tolerance 0).

Cases: the salted batch, both directions; the negative-valid batch (valid
-1, -4096, 2^31 - 1, 8, 0); lanes whose every unit holds a site, at valid
-1, 0, 3, 4, 5, L and above L and at ip 0, 2^32 - 4 and 2^32 - 16, with
rows that are not a multiple of 16 (the byte path), odd Thumb rows and IA64
rows of L % 16 in {0, 1, 15}; delta at distances 1, 2, 3, 4, 7, 8, 12, 16,
32, 255, 256, 257, 4096, L - 1, L and L + 5 on rows of three segments and
more, and at small segments on rows that are no multiple of them. Each
named mutant of the kernels' pieces (a word's valid test off by one,
Thumb's second half taken from the pair after it, a bundle's valid test off
by one, SPARC's sign bits; delta's carries summing only the segment before,
the chunk scan's first addend dropped, dist 2's odd class summed from the
even class's carry, the warps' scan leaving out the first warp, the staged
byte columns' scan dropping its first addend, a segment's carry taken from
the class before, encode's shifted window a byte off, the column walk's sum
not carried), built with g++ from a changed copy of the sources, must fail.
On a card, each kernel must equal its plain version on every batch here;
that test needs no JAX (the module imports the JAX package only in the
``jdf`` fixture), so it runs where JAX is missing.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu_torch.ops import device_filters as DF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVERTERS = ["arm", "armt", "ppc", "sparc", "ia64"]


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

EDGE_CASES = [(n, L) for n in CONVERTERS for L in FB.BRANCH_EDGE_LENGTHS[n]]
DELTA_LENGTHS = [40001, 49152]      # three segments of 16 KiB and a bit; three
# (threads, bytes of words a thread) of delta decode: the kernel's;
# segments of at most 64 bytes (16 threads); two warps' shuffle scan; the
# 16-byte loads of 4-word chunks; a block narrower than the byte columns of
# dist 7 (which walks) but not of dist 3 (one chunk a column)
DELTA_GEOMETRIES = [(H.DELTA_THREADS, H.DELTA_PER), (16, 4), (64, 8), (8, 16),
                    (4, 8)]
# (L, dist) at the small geometries: rows no multiple of a segment, dists
# that do not divide 16 KiB
DELTA_SMALL = [(1000, 3), (1003, 5), (4099, 1), (4099, 2), (4099, 6),
               (4099, 12), (4103, 31), (4103, 32)]


def _dists(L):
    return [1, 2, 3, 4, 7, 16, 255, 256, 257, L - 1, L, L + 5, 8, 12, 32,
            4096]


def _delta_harness(lib, data, valid, dist, encoding, ref):
    """Asserts the harness's rows equal ``ref`` at every geometry of
    ``DELTA_GEOMETRIES``, each launch's blocks in both orders."""
    for threads, per in DELTA_GEOMETRIES:
        for backward in (False, True):
            got = H.delta_batch(lib, data, valid, dist, encoding, threads,
                                per, backward)
            assert np.array_equal(got, ref), (encoding, threads, per,
                                              backward)


@pytest.fixture(scope="module")
def jdf():
    """The JAX package's ``ops/device_filters``, the reference."""
    return importlib.import_module("lzma_sdk_zliblike_tpu.ops.device_filters")


@pytest.fixture(scope="module")
def harness():
    lib = H.build()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


def _batch(kind):
    """(data, valid, ip) of a named converter batch: ``salted:<seed>``,
    ``negative`` or ``edge:<name>:<L>``."""
    if kind == "negative":
        return FB.negative_valid_batch()
    tag, *rest = kind.split(":")
    if tag == "salted":
        return FB.salted_batch(int(rest[0]))
    return FB.branch_edge_batch(rest[0], int(rest[1]))


def _three_way(lib, jdf, name, kind, encoding):
    """The harness's, the plain version's and the JAX function's rows."""
    data, valid, ip = _batch(kind)
    got = H.branch_batch(lib, name, data, valid, ip, encoding)
    plain = DF.convert_batch(name, data, valid, ip, encoding=encoding,
                             device="cpu")
    ref = jdf.convert_batch(name, data, valid, ip, encoding=encoding)
    return got, plain, ref


@pytest.mark.parametrize("name", CONVERTERS)
@pytest.mark.parametrize("encoding", [True, False])
def test_salted_batch(harness, jdf, name, encoding):
    kind = f"salted:{CONVERTERS.index(name) * 101 + 3}"
    got, plain, ref = _three_way(harness, jdf, name, kind, encoding)
    assert np.array_equal(plain, ref)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("name", CONVERTERS)
@pytest.mark.parametrize("encoding", [True, False])
def test_negative_valid_batch(harness, jdf, name, encoding):
    got, plain, ref = _three_way(harness, jdf, name, "negative", encoding)
    assert np.array_equal(plain, ref)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("name,L", EDGE_CASES)
@pytest.mark.parametrize("encoding", [True, False])
def test_edge_batch(harness, jdf, name, L, encoding):
    """Every unit a site: each valid boundary and wrapping ip shows."""
    got, plain, ref = _three_way(harness, jdf, name, f"edge:{name}:{L}",
                                 encoding)
    assert np.array_equal(plain, ref)
    assert np.array_equal(got, ref)
    data = FB.branch_edge_batch(name, L)[0][:, :got.shape[1]]
    assert np.array_equal(got[1:3], data[1:3])       # valid 0 and 3: no site
    for s in (0, 5, 7, 8):                           # the whole row converts
        assert not np.array_equal(got[s], data[s]), s


def test_ia64_every_template_converts(harness, jdf):
    """The kernel's packed slot-mask table against the JAX table: the edge
    rows hold each of the 32 templates with a brl in every slot, so at ip 16
    (no bundle at position 0) a bundle changes exactly where its template's
    mask is not 0, and each slot where the mask has its bit."""
    data, valid, _ = FB.branch_edge_batch("ia64", 512)
    ip = np.full(len(valid), 16, np.uint32)
    got = H.branch_batch(harness, "ia64", data, valid, ip, True)
    assert np.array_equal(got, jdf.convert_batch("ia64", data, valid, ip,
                                                 encoding=True))
    table = np.asarray(jdf._IA64_BR_TABLE)
    for k in range(32):
        mask = table[(k + 23) % 32]
        old, new = (int.from_bytes(a[5, 16 * k:16 * k + 16].tobytes(),
                                   "little") for a in (data, got))
        for slot in range(3):
            field = ((old ^ new) >> (5 + 41 * slot)) & ((1 << 41) - 1)
            assert (field != 0) == bool(mask >> slot & 1), (k, slot)


@pytest.mark.parametrize("L", DELTA_LENGTHS)
@pytest.mark.parametrize("dist", range(16))
def test_delta(harness, jdf, L, dist):
    """Both directions at the kernel's geometry and the small ones, blocks
    in both orders, against the plain version and the JAX function; decode
    inverts encode."""
    dist = _dists(L)[dist]
    data, valid = FB.delta_rows(L, seed=dist)
    for encoding in (True, False):
        ref = np.asarray(jdf.delta_batch(data, valid, dist=dist,
                                         encoding=encoding))
        plain = DF.delta_batch(torch.from_numpy(data),
                               torch.from_numpy(valid), dist=dist,
                               encoding=encoding).numpy()
        assert np.array_equal(plain, ref), encoding
        _delta_harness(harness, data, valid, dist, encoding, ref)
    enc = H.delta_batch(harness, data, valid, dist, True)
    assert np.array_equal(H.delta_batch(harness, enc, valid, dist, False),
                          data)


@pytest.mark.parametrize("L,dist", DELTA_SMALL)
def test_delta_small_segments(harness, jdf, L, dist):
    """Rows of many small segments whose length is no multiple of one, at
    dists that do not divide 16 KiB, against the JAX function and the plain
    version; decode inverts encode at every geometry."""
    data, valid = FB.delta_rows(L, seed=L + dist)
    for encoding in (True, False):
        ref = np.asarray(jdf.delta_batch(data, valid, dist=dist,
                                         encoding=encoding))
        plain = DF.delta_plain(torch.from_numpy(data),
                               torch.from_numpy(valid), dist=dist,
                               encoding=encoding).numpy()
        assert np.array_equal(plain, ref), encoding
        _delta_harness(harness, data, valid, dist, encoding, ref)
    for threads, per in DELTA_GEOMETRIES:
        enc = H.delta_batch(harness, data, valid, dist, True, threads, per)
        back = H.delta_batch(harness, enc, valid, dist, False, threads, per,
                             True)
        assert np.array_equal(back, data), (threads, per)


def test_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors the wrappers launch nothing; they refuse what the
    JAX functions cannot run."""
    data, valid, ip = (torch.from_numpy(a) for a in FB.salted_batch(5))
    before = dict(DF.launches)
    for name in CONVERTERS:
        out = getattr(DF, f"{name}_convert_batch")(data, valid, ip,
                                                   encoding=True)
        plain = getattr(DF, f"{name}_convert_plain")(data, valid, ip,
                                                     encoding=True)
        assert torch.equal(out, plain), name
    assert torch.equal(DF.delta_batch(data, valid, dist=3, encoding=False),
                       DF.delta_plain(data, valid, dist=3, encoding=False))
    assert DF.launches == before
    for name in ("arm", "ppc", "sparc"):
        with pytest.raises(ValueError):
            getattr(DF, f"{name}_convert_batch")(data[:, :4094], valid, ip,
                                                 encoding=True)
    with pytest.raises(ValueError):
        DF.delta_batch(data, valid, dist=0, encoding=True)
    with pytest.raises(ValueError):
        DF.arm_convert_batch(data, valid.numpy(), ip, encoding=True)


# (file, text, mutant text): each changes one piece of the kernels
MUTANTS = {
    "word_valid_off_by_one": ("if (!(pos_in + 4 <= valid))",
                              "if (!(pos_in + 4 < valid))"),
    "armt_second_half_from_next": (
        "if (has_prev && armt_hit(p >> 8, c >> 8, pos - 2, valid))",
        "if (has_next && armt_hit(c >> 8, n >> 8, pos, valid))"),
    "ia64_bundle_valid_off_by_one": ("(uint32_t)at + 16 <= valid",
                                     "(uint32_t)at + 16 < valid"),
    "sparc_sign_bits": ("0x3FC00000u : 0u", "0x3F800000u : 0u"),
    "delta_carry_only_the_segment_before": (
        "        run = vadd4(run, v[j]);", "        run = v[j];"),
    "delta_scan_first_addend_dropped": ("return t >= off ? tot[t - off] : 0;",
                                        "return t > off ? tot[t - off] : 0;"),
    "delta_dist2_odd_class_from_the_even_sum": (
        "p1 = dot4(x[i], 0x100u, c1);", "p1 = dot4(x[i], 0x100u, c0);"),
    "delta_warp_prefix_skips_the_first_warp": (
        "for (int w = 0; w < warp; ++w)", "for (int w = 1; w < warp; ++w)"),
    "delta_staged_scan_first_addend_dropped": (
        "return k >= off ? tot[t - off] : 0;",
        "return k > off ? tot[t - off] : 0;"),
    "delta_carry_from_the_class_before": (
        "  if (KIND == kDByte) return entry[cu];",
        "  if (KIND == kDByte) return entry[cu ? cu - 1 : 0];"),
    "delta_encode_window_a_byte_off": ("const int64_t from = at - dist;",
                                       "const int64_t from = at - dist + 1;"),
    "delta_walk_sum_not_carried": ("      run = vadd4(run, x[j]);",
                                   "      run = x[j];"),
}
# what each mutant is run on: a converter and its batch, or delta
MUTANT_CASES = {"word_valid_off_by_one": ("arm", "edge:arm:512"),
                "armt_second_half_from_next": ("armt", "salted:104"),
                "ia64_bundle_valid_off_by_one": ("ia64", "edge:ia64:512"),
                "sparc_sign_bits": ("sparc", "edge:sparc:512"),
                # delta: (dist, encoding, L)
                "delta_carry_only_the_segment_before": ("delta", (1, False,
                                                                  40001)),
                "delta_scan_first_addend_dropped": ("delta", (12, False,
                                                              40001)),
                "delta_dist2_odd_class_from_the_even_sum": ("delta", (
                    2, False, 40001)),
                "delta_warp_prefix_skips_the_first_warp": ("delta", (
                    1, False, 40001)),
                "delta_staged_scan_first_addend_dropped": ("delta", (
                    7, False, 49152)),
                "delta_carry_from_the_class_before": ("delta", (3, False,
                                                                40001)),
                "delta_encode_window_a_byte_off": ("delta", (3, True,
                                                             49152)),
                "delta_walk_sum_not_carried": ("delta", (4096, False,
                                                         40001))}


@pytest.fixture(scope="module")
def mutants(harness, tmp_path_factory):
    """{name: the harness built from a copy of the sources with that one
    change}, built in parallel (the directories made first: making them
    is not thread-safe)."""
    dirs = {name: tmp_path_factory.mktemp(name) for name in MUTANTS}

    def one(name):
        old, new = MUTANTS[name]
        d = dirs[name]
        for f in H.SOURCES:
            shutil.copy(os.path.join(H.CSRC, f), d / f)
        f = d / "branch_filters_lane.cuh"
        text = f.read_text()
        assert text.count(old) == 1, (name, old)
        f.write_text(text.replace(old, new))
        return H.build(str(d), str(d))
    with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
        return dict(zip(MUTANTS, pool.map(one, MUTANTS)))


@pytest.mark.parametrize("name", list(MUTANTS))
def test_mutant_fails(harness, mutants, name):
    """The comparison that holds the pieces to the plain version catches
    each mutant (and passes with the true sources)."""
    what, case = MUTANT_CASES[name]
    for lib, same in ((harness, True), (mutants[name], False)):
        if what == "delta":
            dist, encoding, L = case
            data, valid = FB.delta_rows(L, seed=dist)
            plain = DF.delta_plain(torch.from_numpy(data),
                                   torch.from_numpy(valid), dist=dist,
                                   encoding=encoding).numpy()
            got = H.delta_batch(lib, data, valid, dist, encoding)
        else:
            data, valid, ip = _batch(case)
            plain = DF.convert_batch(what, data, valid, ip, encoding=True,
                                     device="cpu")
            got = H.branch_batch(lib, what, data, valid, ip, True)
        assert np.array_equal(got, plain) == same, name


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each kernel on the card against its plain version on CPU copies, on
    every batch of this file, with its launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kinds = ["negative"] + [f"salted:{k * 101 + 3}" for k in range(5)]
    for name in CONVERTERS:
        edges = [f"edge:{name}:{L}" for L in FB.BRANCH_EDGE_LENGTHS[name]]
        for kind in kinds + edges:
            data, valid, ip = _batch(kind)
            for encoding in (True, False):
                before = DF.launches[name]
                kern = DF.convert_batch(name, data, valid, ip,
                                        encoding=encoding)
                plain = DF.convert_batch(name, data, valid, ip,
                                         encoding=encoding, device="cpu")
                assert DF.launches[name] == before + 1
                assert np.array_equal(kern, plain), (name, kind, encoding)
    for L in DELTA_LENGTHS:
        for dist in _dists(L):
            data, valid = (torch.from_numpy(a)
                           for a in FB.delta_rows(L, seed=dist))
            for encoding in (True, False):
                kern = DF.delta_batch(data.cuda(), valid.cuda(), dist=dist,
                                      encoding=encoding)
                plain = DF.delta_batch(data, valid, dist=dist,
                                       encoding=encoding)
                torch.cuda.synchronize()
                assert torch.equal(kern.cpu(), plain), (L, dist, encoding)
