"""Kernel P2 of the PyTorch/CUDA port (``tools/compact_probe.py`` of the
port: the compact-layout bit-call microbenchmark) against the JAX tool.

The JAX package's four Pallas probe bodies (``tools/compact_probe.py``)
run as plain JAX under ``jax.disable_jit()`` (their interpret mode takes
minutes): each reads ``seed_ref[0, 0]`` and assigns ``out_ref[...]`` once,
so a stand-in output object keeps the value.  They are held against the
port's plain version, exactly, on a positive and a negative seed (negative
codes, so the submask slot's floor modulo sees negative left sides).  The
CPU build of the kernel's own per-element source (``csrc/probe_lane.cuh``
in ``csrc/cpu_harness.cc``) is held against the plain ALU on edge states,
and, on a card, the CUDA kernels against the plain version.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu_torch.tools import compact_probe as C
from lzma_sdk_zliblike_tpu_torch.utils.errors import UnsupportedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [12345, -7000000]


def _load(name, relpath):
    """A module of the repo loaded by path (a foreign package named
    ``tests`` or ``tools`` may shadow the repo's directories)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    pytest.importorskip("jax")
    return _load("lzt_jax_compact_probe", os.path.join("tools",
                                                       "compact_probe.py"))


class _Out:
    """Stands in for the Pallas output ref: keeps what is assigned."""

    def __setitem__(self, key, value):
        self.value = np.asarray(value)


def _jax_body(tool, name, iters, seed):
    import jax
    import jax.numpy as jnp
    fn, _streams = tool.KERNELS[name]
    out = _Out()
    with jax.disable_jit():
        fn(jnp.full((1, 128), seed, jnp.int32), out, iters=iters)
    return out.value


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(C.KERNELS))
def test_plain_matches_jax_body(jax_tool, name, seed):
    want = _jax_body(jax_tool, name, 2, seed)
    got = C.compact_probe(name, 2, seed, device="cpu")
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == C.out_shape(name)
    assert np.array_equal(got.numpy(), want)


def test_kernel_table_matches_jax(jax_tool):
    assert {k: v[1] for k, v in jax_tool.KERNELS.items()} == C.KERNELS
    assert (C.NCALLS, C.SUB_T) == (jax_tool.NCALLS, jax_tool.SUB_T)


@pytest.mark.parametrize("seed", SEEDS)
def test_mxu_equals_tpose(seed):
    """The one-hot products are exact (every value is below 2048)."""
    assert torch.equal(C.compact_probe_plain("mxu", 12, seed),
                       C.compact_probe_plain("tpose", 12, seed))


def test_bad_arguments_raise(monkeypatch):
    with pytest.raises(ValueError, match="unknown kernel"):
        C.compact_probe("mmx", 1, 0, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        C.compact_probe("bcast", 1, 1 << 31, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnsupportedError):
        C.compact_probe("tpose", 1, 0)
    with pytest.raises(UnsupportedError):
        C.run("tpose", 1)
    assert C.main(["tpose", "1"]) == 1


def test_operations():
    assert C.operations("tpose", 10) == (31 * 28 * 128 * 10, 0)
    assert C.operations("bcast", 10) == (31 * 28 * 64 * 128 * 10, 0)
    assert C.operations("mxu", 10)[1] == 3 * 128 * 28 * 128 * 10


# ---------------------------------------------------------------------------
# the kernel's own per-element source, built for the CPU, against the plain
# version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def harness():
    lib = _load("lzt_torch_cpu_harness",
                os.path.join("tests", "torch_cpu_harness.py")).build()
    if lib is None:
        pytest.skip("g++ not available")
    lib.lzt_compact_call_cpu.restype = ctypes.c_int
    lib.lzt_compact_call_cpu.argtypes = ([ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 2)
    lib.lzt_compact_code0_cpu.restype = ctypes.c_int
    lib.lzt_compact_code0_cpu.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 2
    return lib


def _edge_states(n=4096, seed=0):
    """int32 rng, code and st across the whole range (negative rng and
    code, products and differences that overflow), probabilities across
    [0, 2048] plus a few outside it."""
    r = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)
    rng = r.integers(i32.min, i32.max, n, endpoint=True).astype(np.int32)
    code = r.integers(i32.min, i32.max, n, endpoint=True).astype(np.int32)
    st = r.integers(0, 1 << 14, n).astype(np.int32)
    st[-64:] = r.integers(i32.min, i32.max, 64)
    rng[:6] = [i32.max, i32.min, -1, 0, (1 << 24) - 1, 1 << 24]
    code[:6] = [i32.min, i32.max, -1, -129, 0, -(1 << 24)]
    prob = r.integers(0, 2049, n).astype(np.int32)
    prob[:4] = [0, 2048, -5, i32.max]
    return rng, code, st, prob


@pytest.mark.parametrize("slots", [128, C.SUB_T])
def test_cpu_harness_call_matches_plain(harness, slots):
    rng, code, st, prob = _edge_states(seed=slots)
    n = len(rng)
    h = [a.copy() for a in (rng, code, st)]
    h_slot = np.zeros(n, np.int32)
    h_newp = np.zeros(n, np.int32)
    assert harness.lzt_compact_call_cpu(
        h[0].ctypes.data, h[1].ctypes.data, h[2].ctypes.data,
        prob.ctypes.data, h_slot.ctypes.data, h_newp.ctypes.data, slots,
        n) == 0
    t = [torch.from_numpy(a.astype(np.int64)) for a in (rng, code, st, prob)]
    p_slot = C.slot(t[2], t[1], slots)
    assert ((t[2] + (t[1] >> 7)) < 0).any()     # negative left sides
    p = C.alu(*t)
    for a, b in zip(p, (*h, h_newp)):
        assert np.array_equal(a.numpy(), b.astype(np.int64))
    assert np.array_equal(p_slot.numpy(), h_slot.astype(np.int64))
    assert (h[0] < 0).any() and (h[1] < 0).any()
    assert h_slot.min() >= 0 and h_slot.max() < slots


def test_cpu_harness_code0_matches_plain(harness):
    i = np.arange(128, dtype=np.int32)
    for seed in SEEDS + [np.iinfo(np.int32).max, np.iinfo(np.int32).min]:
        out = np.zeros(128, np.int32)
        assert harness.lzt_compact_code0_cpu(i.ctypes.data, out.ctypes.data,
                                             seed, 128) == 0
        assert np.array_equal(C.code0(torch.arange(128), seed).numpy(),
                              out.astype(np.int64))


# ---------------------------------------------------------------------------
# the CUDA kernels (on a card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    C.launches = 0
    for name in C.KERNELS:
        for seed in SEEDS:
            got = C.compact_probe(name, 64, seed)
            assert torch.equal(got.cpu(), C.compact_probe_plain(name, 64,
                                                                seed)), name
    assert C.launches == 2 * len(C.KERNELS)
