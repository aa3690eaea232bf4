"""Kernel K2 of the PyTorch/CUDA port (``ops/range_encode.py``) against the
JAX package.

The same groups, made from ``tests/corpus.py``, are parsed by the port's own
native runtime and by the JAX package's, and their op records are replayed
by the JAX package's scalar spec (``op_replay.replay_group``), by the port's
plain version on the CPU, by the CPU build of the kernel's own source
(``csrc/cpu_harness.cc``) and, on a card, by the CUDA kernel.  All
comparisons are exact: bytes, chunk tables and status equal.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu import native as JN
from lzma_sdk_zliblike_tpu.models.lzma import op_replay as JR
from lzma_sdk_zliblike_tpu.models.lzma.encoder_ref import \
    RangeEncoder as JRangeEncoder
from lzma_sdk_zliblike_tpu.models.lzma.spec import LzmaProps as JProps
from lzma_sdk_zliblike_tpu_torch import native as N
from lzma_sdk_zliblike_tpu_torch.ops import range_encode as R
from lzma_sdk_zliblike_tpu_torch.utils.errors import ParamError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, file):
    """A helper module of tests/, loaded by path: on some machines a foreign
    package named ``tests`` shadows this directory."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CORPUS = _load("lzt_corpus", "corpus.py")
big_mixed, x86_like, random_bytes = (_CORPUS.big_mixed, _CORPUS.x86_like,
                                     _CORPUS.random_bytes)
DICT = 1 << 16
SUB = 4 << 10      # small sub-chunks: several chunk boundaries per lane

# the corpora of the JAX package's encoder tests (test_pallas_encoder.py)
CORPORA = {
    "big_mixed": lambda: big_mixed(20_000, seed=5),
    "x86_like": lambda: x86_like(3_000),
    "random_bytes": lambda: random_bytes(3_500, seed=2),
    "zeros": lambda: bytes(12_000),
    "abcdef": lambda: (b"abcdef" * 2000)[:12_000],
}
PROPS = {"lc3_lp0_pb2": (3, 0, 2), "lc0_lp4_pb0": (0, 4, 0)}


def _parse(datas, lc=3, lp=0, pb=2):
    return [N.lzma2_group_ops(d, DICT, lc=lc, lp=lp, pb=pb, sub_size=SUB)
            for d in datas]


def _batch(parsed, inactive=0):
    """The lanes of ``parsed`` as one batch, then ``inactive`` lanes with
    no ops."""
    ops, ends, act, out_cap, _ = R.pack_ops_batch(
        [p[0] for p in parsed] + [[]] * inactive,
        [p[1] for p in parsed] + [[]] * inactive)
    return (ops, ends, act), out_cap


def _assert_native(parsed, bodies, tab, status, lanes):
    """The listed lanes are ok and their bodies and tab are the native
    coder's."""
    for li in lanes:
        _ops, ntab, nbody = parsed[li]
        assert status[:, li].tolist() == [1, len(nbody), 0], li
        assert bodies[li, :len(nbody)].numpy().tobytes() == nbody, li
        assert tab[li, :len(ntab)].tolist() == ntab[:, 2].tolist(), li


# ---------------------------------------------------------------------------
# the port's native runtime against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CORPORA))
def test_group_ops_match_jax(name):
    data = CORPORA[name]()
    ops, tab, body = N.lzma2_group_ops(data, DICT, sub_size=SUB)
    jops, jtab, jbody = JN.lzma2_group_ops(data, DICT, sub_size=SUB)
    assert ops.dtype == jops.dtype == np.uint32
    assert np.array_equal(ops, jops)
    assert np.array_equal(tab, jtab)
    assert body == jbody
    assert len(tab) == -(-len(data) // SUB)


def test_native_is_built_from_the_ports_source():
    assert N.SOURCE == os.path.join(REPO, "lzma_sdk_zliblike_tpu_torch",
                                    "csrc", "host", "lzt_codec.cc")
    N.lzma2_group_ops(b"abc", DICT)
    assert os.path.exists(N.lib_path())
    assert os.path.dirname(N.lib_path()) == os.path.join(REPO, "build",
                                                         "torch_host")


# ---------------------------------------------------------------------------
# the plain version against the native coder and the JAX replay
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(PROPS))
def plain_batch(request):
    """Multi-chunk lanes (4 KiB chunks) and two inactive pad lanes, encoded
    by the plain version at the given lc/lp/pb."""
    lc, lp, pb = PROPS[request.param]
    datas = [big_mixed(9_000, seed=1), big_mixed(12_500, seed=2),
             bytes(9_000), x86_like(1_500), (b"abcdef" * 900)]
    parsed = _parse(datas, lc, lp, pb)
    batch, out_cap = _batch(parsed, inactive=2)
    plain = R.range_encode_plain(*batch, out_cap, lc, lp, pb)
    return datas, parsed, batch, out_cap, (lc, lp, pb), plain


def test_plain_matches_native_and_jax_replay(plain_batch):
    datas, parsed, _, _, (lc, lp, pb), (bodies, tab, status) = plain_batch
    _assert_native(parsed, bodies, tab, status, range(len(datas)))
    assert max(len(p[1]) for p in parsed) >= 3
    for li, d in enumerate(datas):
        ops, ntab, nbody = parsed[li]
        replay = JR.replay_group(d, ops, ntab, JProps(lc=lc, lp=lp, pb=pb,
                                                      dict_size=DICT))
        assert b"".join(replay) == nbody, li
        ends = np.cumsum([len(b) for b in replay]).tolist()
        assert tab[li, :len(ntab)].tolist() == ends, li
    for li in range(len(datas), len(datas) + 2):     # inactive pad lanes
        assert status[:, li].tolist() == [1, 0, 0]
        assert not tab[li].any() and not bodies[li].any()


@pytest.fixture(scope="module")
def faulty_batch():
    """Good lanes beside lanes that fail: a body past out_cap, a chunk table
    out of order, an impossible op record; and an inactive lane."""
    datas = [big_mixed(6_000, seed=3), bytes(5_000),
             random_bytes(2_500, seed=4), big_mixed(3_000, seed=6),
             big_mixed(3_000, seed=7)]
    parsed = _parse(datas)
    (ops, ends, act), _ = _batch(parsed, inactive=1)
    out_cap = max(len(parsed[li][2]) for li in (0, 1, 3, 4)) + 64
    assert len(parsed[2][2]) > out_cap      # lane 2 overflows
    ends[3, 0] += 1                         # lane 3: odd op-word end
    ops[4, 6] = 1 | (1 << 4)                # lane 4: a match of length 1
    plain = R.range_encode_plain(ops, ends, act, out_cap)
    return parsed, (ops, ends, act), out_cap, plain


def test_failing_lanes_fail_alone(faulty_batch):
    parsed, _, out_cap, (bodies, tab, status) = faulty_batch
    _assert_native(parsed, bodies, tab, status, (0, 1))
    assert status[:, 2].tolist() == [0, out_cap, R.ERR_OVERFLOW]
    assert bodies[2].numpy().tobytes() == parsed[2][2][:out_cap]
    assert status[:, 3].tolist() == [0, 0, R.ERR_TABLE]
    assert status[0, 4] == 0 and status[2, 4] == R.ERR_OP
    assert status[:, 5].tolist() == [1, 0, 0]


# ---------------------------------------------------------------------------
# the kernel's own source, built for the CPU, against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def harness():
    lib = _load("lzt_torch_cpu_harness", "torch_cpu_harness.py").build()
    if lib is None:
        pytest.skip("g++ not available")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    enc = lib.lzt_range_encode_cpu
    enc.restype = ctypes.c_int
    enc.argtypes = [P, L, P, I, P, P, L, P, P, P, P, I, I, I, I]
    shift = lib.lzt_shift_low_cpu
    shift.restype = ctypes.c_int
    shift.argtypes = [P, P, P, P, P, P, L, I, I]

    def run(ops, ends, act, out_cap, lc=3, lp=0, pb=2):
        n, n_chunks = ends.shape
        bodies = torch.zeros((n, out_cap), dtype=torch.uint8)
        tab = torch.zeros((n, n_chunks), dtype=torch.int32)
        status = torch.zeros((3, n), dtype=torch.int32)
        assert enc(ops.data_ptr(), ops.shape[1], ends.data_ptr(), n_chunks,
                   act.data_ptr(), bodies.data_ptr(), out_cap, tab.data_ptr(),
                   status[0].data_ptr(), status[1].data_ptr(),
                   status[2].data_ptr(), n, lc, lp, pb) == 0
        return bodies, tab, status

    def shift_low(low, cache, cache_size, out_cap, n):
        state = [torch.tensor(v, dtype=torch.int64)
                 for v in (low, cache, cache_size, [0] * len(low),
                           [0] * len(low))]
        out = torch.zeros((len(low), out_cap), dtype=torch.uint8)
        assert shift(*[t.data_ptr() for t in state], out.data_ptr(), out_cap,
                     n, len(low)) == 0
        return out, state
    return run, shift_low


def test_cpu_harness_matches_plain(harness, plain_batch, faulty_batch):
    run, _ = harness
    _, _, batch, out_cap, props, plain = plain_batch
    for a, b in zip(plain, run(*batch, out_cap, *props)):
        assert torch.equal(a, b)
    _, batch, out_cap, plain = faulty_batch
    for a, b in zip(plain, run(*batch, out_cap)):
        assert torch.equal(a, b)


# coder states (low, cache, cache_size) with long pending 0xFF runs: the
# case the TPU kernel handed to the host
SHIFT_STATES = [
    ((1 << 32) | 0x00123456, 0x7F, 7),    # carry into 6 pending 0xFF bytes
    (0x00ABCDEF, 0x41, 9),                 # 8 pending 0xFF, no carry
    (0xFF123456, 0x10, 6),                 # the run grows, then is released
    ((1 << 32) | 0xFFFFFF, 0xFF, 12),      # carry through cache 0xFF
]


def test_shift_low_long_runs_match_encoder_ref(harness):
    _, shift_low = harness
    low, cache, size = (list(v) for v in zip(*SHIFT_STATES))
    n = len(low)
    out = torch.zeros((n, 64), dtype=torch.uint8)
    coders = R._Coders(out, None)
    coders.low, coders.cache, coders.cache_size = (
        torch.tensor(v, dtype=torch.int64) for v in (low, cache, size))
    for _ in range(5):                      # a chunk's flush
        coders.shift_low(torch.ones(n, dtype=torch.bool))
    h_out, (h_low, h_cache, h_size, h_opos, h_err) = shift_low(
        low, cache, size, 64, 5)
    assert torch.equal(out, h_out)
    assert torch.equal(coders.opos, h_opos) and not h_err.any()
    assert torch.equal(coders.low, h_low)
    assert torch.equal(coders.cache_size, h_size)
    for li, (lo, ca, cs) in enumerate(SHIFT_STATES):
        ref = JRangeEncoder()
        ref.low, ref.cache, ref.cache_size = lo, ca, cs
        want = ref.flush()
        assert len(want) >= 6
        assert out[li, :int(coders.opos[li])].numpy().tobytes() == want, li
    # the same runs into a 4-byte buffer: the write past it sets err 3
    out = torch.zeros((n, 4), dtype=torch.uint8)
    coders = R._Coders(out, None)
    coders.low, coders.cache, coders.cache_size = (
        torch.tensor(v, dtype=torch.int64) for v in (low, cache, size))
    for _ in range(5):
        coders.shift_low(torch.ones(n, dtype=torch.bool))
    h_out, (_, _, _, h_opos, h_err) = shift_low(low, cache, size, 4, 5)
    assert torch.equal(out, h_out) and torch.equal(coders.opos, h_opos)
    assert torch.equal(coders.err, h_err)
    assert (h_err == R.ERR_OVERFLOW).all()


# ---------------------------------------------------------------------------
# the JAX package's own batch, carried across
# ---------------------------------------------------------------------------

def test_from_jax_batch():
    from lzma_sdk_zliblike_tpu.ops import pallas_encode as PE
    datas = [big_mixed(7_000, seed=8), x86_like(1_200), bytes(6_000)]
    jparsed = [JN.lzma2_group_ops(d, DICT, sub_size=SUB) for d in datas]
    ops_words, meta, out_pages, nch = PE.pack_ops_batch(
        [p[0] for p in jparsed], [p[1] for p in jparsed])
    ops, ends, act = R.from_jax_batch(ops_words, meta)
    assert ops.shape[0] == 8 and act.tolist() == [1, 1, 1] + [0] * 5
    assert ends.shape[1] == max(nch)
    bodies, tab, status = R.range_encode_plain(ops, ends, act,
                                               out_pages * 128)
    _assert_native(jparsed, bodies, tab, status, range(len(datas)))
    assert status[0].all()


def test_pack_ops_batch_layout():
    parsed = _parse([big_mixed(9_000, seed=9), bytes(3_000)])
    (ops, ends, act), out_cap = _batch(parsed, inactive=1)
    assert ops.dtype == ends.dtype == act.dtype == torch.int32
    assert ops.shape == (3, max(len(p[0]) for p in parsed))
    assert act.tolist() == [1, 1, 0]
    assert out_cap == 9_000 + 9_000 // 8 + 4096
    n0 = len(parsed[0][1])
    assert ends[0].tolist() == parsed[0][1][:, 0].tolist()
    assert ends[1].tolist() == [parsed[1][1][0, 0]] * n0   # padding repeats
    assert (ops[1, :len(parsed[1][0])].numpy().view(np.uint32)
            == parsed[1][0]).all()


def test_input_checks():
    (ops, ends, act), out_cap = _batch(_parse([big_mixed(2_000, seed=10)]))
    with pytest.raises(TypeError):
        R.submit_encode_groups(ops.long(), ends, act, out_cap=out_cap)
    with pytest.raises(ValueError):
        R.submit_encode_groups(ops, ends, act[:0], out_cap=out_cap)
    with pytest.raises(ValueError):
        R.submit_encode_groups(ops[:, ::2], ends, act, out_cap=out_cap)
    with pytest.raises(ValueError):
        R.submit_encode_groups(ops, ends, act, out_cap=0)
    with pytest.raises(ParamError):
        R.submit_encode_groups(ops, ends, act, out_cap=out_cap, lc=4, lp=1)


# ---------------------------------------------------------------------------
# the CUDA kernel (on a card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_matches_plain_on_card(plain_batch, faulty_batch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    R.launches = 0
    _, _, batch, out_cap, (lc, lp, pb), plain = plain_batch
    _, fbatch, fcap, fplain = faulty_batch
    for b, cap, props, want in ((batch, out_cap, (lc, lp, pb), plain),
                                (fbatch, fcap, (3, 0, 2), fplain)):
        h = R.submit_encode_groups(*[t.cuda() for t in b], out_cap=cap,
                                   lc=props[0], lp=props[1], pb=props[2])
        torch.cuda.synchronize()
        for a, k in zip(want, (h.bodies, h.tab, h.status)):
            assert torch.equal(a, k.cpu())
    assert R.launches == 2


# ---------------------------------------------------------------------------
# the JAX kernel itself (interpret mode: compiles for minutes)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_jax_kernel_interpret_matches_plain():
    from lzma_sdk_zliblike_tpu.ops import pallas_encode as PE
    datas = [big_mixed(6_000 + 1_000 * s, seed=s + 1) for s in range(8)]
    jparsed = [JN.lzma2_group_ops(d, DICT, sub_size=SUB) for d in datas]
    ops_words, meta, out_pages, nch = PE.pack_ops_batch(
        [p[0] for p in jparsed], [p[1] for p in jparsed], op_pages_min=64,
        out_pages4_min=32)
    jbodies, jok = PE.finalize_encode(PE.submit_encode_groups(
        ops_words, meta, out_pages=out_pages, interpret=True), nch)
    bodies, tab, status = R.range_encode_plain(
        *R.from_jax_batch(ops_words, meta), out_pages * 128)
    assert np.asarray(jok).all() and status[0].all()
    for li, jb in enumerate(jbodies):
        assert bodies[li, :int(status[1, li])].numpy().tobytes() == \
            b"".join(jb) == jparsed[li][2]
