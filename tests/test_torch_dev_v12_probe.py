"""Kernel P1 of the PyTorch/CUDA port (``tools/dev_v12_probe.py`` of the
port: the v12 bit-call microbenchmark) against the JAX tool.

Every variant of the JAX package's Pallas probe (``tools/dev_v12_probe.py``)
runs in interpret mode at S = 8, iters = 3 and is held against the port's
plain version, exactly.  The interpret runs go to one child process at
XLA's default optimisation level: under the suite's level 0
(``tests/conftest.py``) ``lane-notr`` does not finish in minutes.  The CPU
build of the kernel's own per-element source (``csrc/probe_lane.cuh`` in
``csrc/cpu_harness.cc``) is held against the plain version's bit call and
tail on edge states, and, on a card, the CUDA kernel against the plain
version.

    python tests/test_torch_dev_v12_probe.py OUT.npz

writes the JAX probe's outputs of every variant of ``ALL`` to OUT.npz.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lzma_sdk_zliblike_tpu_torch.tools import dev_v12_probe as V  # noqa: E402
from lzma_sdk_zliblike_tpu_torch.utils.errors import (  # noqa: E402
    UnsupportedError)

ALL = ["broadcast", "masked", "fused2", "live1", "live3", "tailalways",
       "tailnever", "tailcond", "while", "whilecond", "lane", "lane-notr"]
SAME_AS_BROADCAST = ["while", "tailnever", "whilecond"]
S_JAX, ITERS_JAX = 8, 3


def _load(name, relpath):
    """A module of the repo loaded by path (a foreign package named
    ``tests`` or ``tools`` may shadow the repo's directories)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_outputs(path):
    """Every variant of the JAX package's Pallas probe in interpret mode,
    with the shapes of its ``run``, saved to ``path``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    tool = _load("lzt_jax_dev_v12_probe", os.path.join("tools",
                                                       "dev_v12_probe.py"))
    S, out = S_JAX, {}
    for variant in ALL:
        f = pl.pallas_call(
            tool.make_kernel(S, ITERS_JAX, variant),
            out_shape=jax.ShapeDtypeStruct((S, 128), jnp.int32),
            scratch_shapes=[pltpu.VMEM((8, S, 128), jnp.int32),
                            pltpu.VMEM((8, S), jnp.int32)],
            interpret=True)
        out[variant] = np.asarray(f())
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("v12") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_backend_optimization_level"))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("variant", ALL)
def test_plain_matches_jax_interpret(jax_outputs, variant):
    want = jax_outputs[variant]
    got = V.v12_probe(S_JAX, ITERS_JAX, variant, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (S_JAX, 128)
    # the lane variants' TPU kernel writes rows 0..7 only
    assert np.array_equal(got.numpy()[:8], want[:8])
    if variant == "lane-notr":
        # zero state with a fake probability code & 2047 = 0 stays zero
        assert not want[:8].any()
    elif variant == "lane":
        assert want[2, :S_JAX].any()      # the index row moved


@pytest.mark.parametrize("S", [8, 16])
def test_variants_equal_to_broadcast(S):
    """while, tailnever and whilecond compute broadcast's output; 130
    iterations cover whilecond's busy checks at 0, 64 and 128."""
    want = V.v12_probe_plain(S, 130, "broadcast")
    for variant in SAME_AS_BROADCAST:
        assert torch.equal(V.v12_probe_plain(S, 130, variant), want), variant


def test_bad_variants_raise():
    with pytest.raises(ValueError, match="N >= 1"):
        V.v12_probe_plain(8, 1, "live0")
    for bad in ("live", "livex", "lanes", ""):
        with pytest.raises(ValueError, match="unknown variant"):
            V.v12_probe(8, 1, bad, device="cpu")
    with pytest.raises(ValueError, match="S >= 8"):
        V.v12_probe(4, 1, "lane", device="cpu")
    assert V.parse_variant("live12") == ("live", 12)


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnsupportedError):
        V.v12_probe(8, 1, "broadcast")
    with pytest.raises(UnsupportedError):
        V.run(8, 1, "broadcast")
    assert V.main(["broadcast"]) == 1


def test_operations_count_the_tail():
    base = V.operations(32, 100, "broadcast")
    assert base == 23 * 28 * 32 * 128 * 100
    assert V.operations(32, 100, "tailnever") == base
    assert V.operations(32, 100, "tailalways") == \
        base + 26 * 6 * 32 * 128 * 100
    assert V.operations(32, 100, "tailcond", tail_runs=7) == \
        base + 26 * 6 * 32 * 128 * 7
    assert V.operations(32, 100, "lane") == 23 * 28 * 32 * 100


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
    lib.lzt_v12_call_cpu.restype = ctypes.c_int
    lib.lzt_v12_call_cpu.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    lib.lzt_v12_tail_cpu.restype = ctypes.c_int
    lib.lzt_v12_tail_cpu.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return lib


def _edge_states(n=4096, seed=0):
    """uint32 rng and code across the whole range (rng >= 2^31, code >= 2^31
    and code >= bound included), probabilities across [0, 2048] and both
    values of the live mask."""
    r = np.random.default_rng(seed)
    rng = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    code = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    rng[:8] = [0xFFFFFFFF, 0x80000000, 0x00FFFFFF, 0x01000000, 0, 2047,
               0xFFFFF800, 0x7FFFFFFF]
    code[:8] = [0xFFFFFFFF, 0, 0x80000000, 5, 0, 0, 0xFFFFFFFF, 0x80000001]
    p = r.integers(0, 2049, n).astype(np.int32)
    p[:4] = [0, 2048, 1, 2047]
    live = r.integers(0, 2, n).astype(np.int32)
    return rng, code, p, live


def test_cpu_harness_bit_call_matches_plain(harness):
    rng, code, p, live = _edge_states()
    assert (rng >= 1 << 31).any() and (code >= 1 << 31).any()
    n = len(rng)
    h_rng, h_code = rng.copy(), code.copy()
    h_newp = np.zeros(n, np.int32)
    h_bit = np.zeros(n, np.int32)
    assert harness.lzt_v12_call_cpu(
        h_rng.ctypes.data, h_code.ctypes.data, p.ctypes.data,
        live.ctypes.data, h_newp.ctypes.data, h_bit.ctypes.data, n) == 0
    t = (torch.from_numpy(rng.astype(np.int64)),
         torch.from_numpy(code.astype(np.int64)),
         torch.from_numpy(p.astype(np.int64)),
         torch.from_numpy(live != 0))
    p_rng, p_code, p_newp, p_bit = V.bit_call(*t)
    assert np.array_equal(p_rng.numpy(), h_rng.astype(np.int64))
    assert np.array_equal(p_code.numpy(), h_code.astype(np.int64))
    assert np.array_equal(p_newp.numpy(), h_newp)
    assert np.array_equal(p_bit.numpy(), h_bit != 0)
    assert 0 < h_bit.sum() < n          # both bit values occur


def test_cpu_harness_tail_matches_plain(harness):
    rng, code, _, _ = _edge_states(seed=1)
    h_r, h_c = rng.copy(), code.copy()
    assert harness.lzt_v12_tail_cpu(h_r.ctypes.data, h_c.ctypes.data,
                                    len(rng)) == 0
    p_r, p_c = V.tail(torch.from_numpy(rng.astype(np.int64)),
                      torch.from_numpy(code.astype(np.int64)))
    assert np.array_equal(p_r.numpy(), h_r.astype(np.int64))
    assert np.array_equal(p_c.numpy(), h_c.astype(np.int64))


# ---------------------------------------------------------------------------
# the CUDA kernel (on a card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 32])
def test_kernel_matches_plain_on_card(S):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    V.launches = 0
    variants = ALL + ["live9"]            # live<N> with N > 8: shared memory
    for variant in variants:
        got = V.v12_probe(S, 70, variant)
        want = V.v12_probe_plain(S, 70, variant)
        assert torch.equal(got.cpu(), want), variant
    assert V.launches == len(variants)


if __name__ == "__main__":
    _jax_outputs(sys.argv[1])
