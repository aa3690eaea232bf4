"""The barrier schedules and warp splits of the probes P1 and P2 (the
port's ``csrc/v12_probe.cu`` and ``csrc/compact_probe.cu``) on the CPU.

``csrc/cpu_harness.cc`` plays each kernel's threads on the host with the
kernels' own per-thread pieces (``csrc/probe_lane.cuh``): the phases of a
P1 row call and its one barrier a call (two for ``fused2``), bcast's two
table copies, mxu's relayouts as m16n8k16 products built from the fragment
maps in f16 and f32 with two alternating vector buffers, submask's slots
across the threads of a warp with the read as a reduction.  Each phase
between two barriers runs one thread after another, first to last and last
to first; every order must give the plain version's output
(``v12_probe_plain``, ``compact_probe_plain``), exactly.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu_torch.tools import compact_probe as C
from lzma_sdk_zliblike_tpu_torch.tools import dev_v12_probe as V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P1_VARIANTS = ["broadcast", "masked", "fused2", "live1", "live3", "live9",
               "tailalways", "tailnever", "tailcond", "while", "whilecond",
               "lane", "lane-notr"]
ORDERS = {"forward": 0, "reverse": 1}
SEEDS = [12345, -7000000]
# iterations per P2 kernel: mxu's harness plays each product as 16 tile
# products per warp, so it runs fewest
P2_ITERS = {"bcast": 6, "mxu": 3, "tpose": 6, "submask": 6}


@pytest.fixture(scope="module")
def harness():
    spec = importlib.util.spec_from_file_location(
        "lzt_torch_cpu_harness", os.path.join(REPO, "tests",
                                              "torch_cpu_harness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.build()
    if lib is None:
        pytest.skip("g++ not available")
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.lzt_v12_probe_cpu, [P, I, I, I, I, I]),
                     (lib.lzt_compact_probe_cpu, [I, I, P, I, I, I]),
                     (lib.lzt_mma_16816_cpu, [P, P, P])):
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib


def v12_harness(lib, S, iters, variant, rev):
    name, extra = V.parse_variant(variant)
    out = np.zeros((S, 128), np.int32)      # the lane variants' start state
    assert lib.lzt_v12_probe_cpu(out.ctypes.data, S, iters,
                                 V.VARIANTS.index(name), extra, rev) == 0
    return out


def compact_harness(lib, name, iters, seed, rev, threads=32):
    out = np.zeros(C.out_shape(name), np.int32)
    assert lib.lzt_compact_probe_cpu(list(C.KERNELS).index(name), seed,
                                     out.ctypes.data, iters, rev,
                                     threads) == 0
    return out


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("variant", P1_VARIANTS)
def test_p1_schedule_matches_plain(harness, variant, order):
    """Every P1 variant; 65 iterations reach whilecond's busy check at 64
    (and give tailcond's vote both answers)."""
    S, iters = (4, 65) if variant in ("whilecond", "tailcond") else (8, 12)
    got = v12_harness(harness, S, iters, variant, ORDERS[order])
    want = V.v12_probe_plain(S, iters, variant).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(C.KERNELS))
def test_p2_schedule_matches_plain(harness, name, seed, order):
    iters = P2_ITERS[name]
    got = compact_harness(harness, name, iters, seed, ORDERS[order])
    assert np.array_equal(got, C.compact_probe_plain(name, iters,
                                                     seed).numpy())


@pytest.mark.parametrize("threads", [16, 32, 64, 192])
def test_submask_split_over_any_lane_count(harness, threads):
    """submask's read and select over T threads of a stream (slots j,
    j + T, ...): the stream's lanes agree on its state at every T, and the
    result is the plain version's (the kernel's T is 32)."""
    for rev in ORDERS.values():
        got = compact_harness(harness, "submask", 4, SEEDS[1], rev, threads)
        assert np.array_equal(got, C.compact_probe_plain("submask", 4,
                                                         SEEDS[1]).numpy())


def _mma(lib, A, B, D):
    A, B = (np.ascontiguousarray(x, np.float32) for x in (A, B))
    D = np.array(D, np.float32)
    assert lib.lzt_mma_16816_cpu(A.ctypes.data, B.ctypes.data,
                                 D.ctypes.data) == 0
    return D


def test_mma_fragment_maps_give_the_product(harness):
    """The fragment maps place every entry of A, B and C once (the call
    fails otherwise), and the product built from them is A @ B + C."""
    r = np.random.default_rng(3)
    A = r.integers(-8, 9, (16, 16)).astype(np.float32)
    B = r.integers(-64, 65, (16, 8)).astype(np.float32)
    D0 = r.integers(-100, 101, (16, 8)).astype(np.float32)
    assert np.array_equal(_mma(harness, A, B, D0), A @ B + D0)


def test_mma_one_hot_relayout_is_exact(harness):
    """mxu's relayout: a one-hot tile times a vector of integers below
    2048, in every column, gives the vector back exactly; so does the
    one-hot tile that picks the other half of the K-step (a permutation),
    and the zero tile of another K-step adds an exact 0."""
    v = np.arange(2047, 2047 - 16, -1, dtype=np.float32)
    B = np.repeat(v[:, None], 8, axis=1)
    eye = np.eye(16, dtype=np.float32)
    assert np.array_equal(_mma(harness, eye, B, np.zeros((16, 8))), B)
    perm = np.roll(eye, 8, axis=1)
    assert np.array_equal(_mma(harness, perm, B, np.zeros((16, 8))),
                          np.roll(B, -8, axis=0))
    assert np.array_equal(_mma(harness, np.zeros((16, 16)), B, B), B)


def test_f16_holds_every_value_a_relayout_carries():
    """Every integer below 2048 survives the f16 round trip (the kernel's
    __int2half_rn and its f32 result), 2049 does not; and the values a
    relayout carries stay below 2048: slot indices below 128, and every
    probability that adapt reaches from 1024 lies in [31, 2017]."""
    v = np.arange(2050)
    back = v.astype(np.float16).astype(np.float32).astype(np.int64)
    assert np.array_equal(back[:2048], v[:2048]) and back[2049] != 2049
    seen, todo = set(), {1024}
    while todo:
        p = todo.pop()
        seen.add(p)
        t = torch.tensor([p, p], dtype=torch.int64)
        _, _, _, newp = C.alu(torch.tensor([0x7FFFFF00] * 2), torch.tensor(
            [0, 0x7FFFFFFF]), torch.tensor([3, 3]), t)
        todo |= set(newp.tolist()) - seen
    assert min(seen) == 31 and max(seen) == 2017
