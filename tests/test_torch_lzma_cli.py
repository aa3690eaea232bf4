"""The port's ``lzma e|d`` CLI against the JAX package's.

Round trips, the ``.lzma`` file byte-identical to the JAX CLI's, the exit
codes of the JAX CLI's error paths (tests/test_cli.py), and ``--engine
tpu``, which the JAX CLI runs on the pure-Python codec, refused with
UnsupportedError's code.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import pytest

from lzma_sdk_zliblike_tpu.cli import lzma_util as JCLI
from lzma_sdk_zliblike_tpu_torch.cli import lzma_util as TCLI
from lzma_sdk_zliblike_tpu_torch.utils.errors import UnsupportedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's native library, loaded in this worker before the
# module's first test (tests/torch_jax_native.py: a worker can lose the
# JAX package's own build of it)
_jnl = importlib.util.spec_from_file_location(
    "lzt_torch_jax_native", os.path.join(REPO, "tests", "torch_jax_native.py"))
_JNL = importlib.util.module_from_spec(_jnl)
_jnl.loader.exec_module(_JNL)
jax_native_loaded = _JNL.jax_native_loaded
_spec = importlib.util.spec_from_file_location(
    "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
_corpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_corpus)


@pytest.fixture()
def sample(tmp_path):
    p = tmp_path / "in.bin"
    p.write_bytes(_corpus.big_mixed(30_000, seed=8)
                  + _corpus.x86_like(10_000, seed=8))
    return p


@pytest.mark.parametrize("args", [[], ["--end-mark"], ["-l", "1"],
                                  ["--effort", "10", "--lc", "0", "--lp",
                                   "2", "--pb", "0"]])
def test_roundtrip_matches_jax(sample, tmp_path, args):
    opts = ["--dict-size", "65536", *args]
    t, j, back = tmp_path / "t.lzma", tmp_path / "j.lzma", tmp_path / "t.out"
    assert TCLI.main(["e", str(sample), str(t), *opts]) == 0
    assert JCLI.main(["e", str(sample), str(j), *opts]) == 0
    assert t.read_bytes() == j.read_bytes()
    assert TCLI.main(["d", str(t), str(back)]) == 0
    assert back.read_bytes() == sample.read_bytes()


def test_python_engine_matches_jax(tmp_path):
    src = tmp_path / "small.bin"
    src.write_bytes(_corpus.big_mixed(6_000, seed=3))
    t, j, back = tmp_path / "t.lzma", tmp_path / "j.lzma", tmp_path / "o"
    for cli, out in ((TCLI, t), (JCLI, j)):
        assert cli.main(["e", str(src), str(out), "--engine", "python",
                         "--dict-size", "65536"]) == 0
    assert t.read_bytes() == j.read_bytes()
    assert TCLI.main(["d", str(t), str(back), "--engine", "python"]) == 0
    assert back.read_bytes() == src.read_bytes()


def test_error_exit_codes_match_jax(sample, tmp_path):
    lzma = tmp_path / "a.lzma"
    assert TCLI.main(["e", str(sample), str(lzma)]) == 0
    trunc = tmp_path / "trunc.lzma"
    trunc.write_bytes(lzma.read_bytes()[:200])
    cases = [["d", str(sample), str(tmp_path / "x")],          # not .lzma
             ["e", str(tmp_path / "missing"), str(tmp_path / "x")],
             ["d", str(trunc), str(tmp_path / "x")],
             ["d", str(tmp_path / "missing"), str(tmp_path / "x")]]
    for argv in cases:
        got = TCLI.main(argv)
        assert got != 0 and got == JCLI.main(argv), argv
    assert TCLI.main(cases[1]) == 8            # SZ_ERROR_READ for io errors


@pytest.mark.parametrize("command", ["e", "d"])
def test_device_engine_refused(sample, tmp_path, command):
    src = sample
    if command == "d":
        src = tmp_path / "a.lzma"
        assert TCLI.main(["e", str(sample), str(src)]) == 0
    out = tmp_path / "x"
    assert TCLI.main([command, str(src), str(out), "--engine", "tpu"]) == \
        UnsupportedError.sres
    assert not out.exists()


def test_module_entry_point(sample, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    enc = tmp_path / "m.lzma"
    r = subprocess.run([sys.executable, "-m",
                        "lzma_sdk_zliblike_tpu_torch.cli.lzma_util", "e",
                        str(sample), str(enc), "--engine", "device"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == UnsupportedError.sres and "error" in r.stderr
    r = subprocess.run([sys.executable, "-m",
                        "lzma_sdk_zliblike_tpu_torch.cli.lzma_util", "e",
                        str(sample), str(enc)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert TCLI.main(["d", str(enc), str(tmp_path / "m.out")]) == 0
    assert (tmp_path / "m.out").read_bytes() == sample.read_bytes()
