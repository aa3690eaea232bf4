"""The port's ``7z`` CLI (``cli/sevenz.py``) against the JAX package's.

The cycle ``a l t e x xs carve`` must give the same archives, the same
printed lines and the same extracted files in both packages, for every
writer option; errors must exit with the same codes (an error's SRes code,
8 for an I/O error).
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import pytest

from lzma_sdk_zliblike_tpu.cli import sevenz as JCLI
from lzma_sdk_zliblike_tpu_torch.cli import sevenz as TCLI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
_corpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_corpus)


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """A directory of inputs, entered: ``a`` names files under a directory
    by their path relative to the working directory."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "text.txt").write_bytes(_corpus.english_like(20_000, seed=3))
    (src / "sub" / "app.exe").write_bytes(_corpus.x86_like(12_000, seed=4))
    (src / "sub" / "empty").write_bytes(b"")
    (tmp_path / "one.bin").write_bytes(_corpus.big_mixed(9_000, seed=5))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _call(cli, argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _files(root):
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


OPTIONS = [[], ["--bcj"], ["--bcj2"], ["--method", "lzma"],
           ["--method", "copy"], ["--method", "ppmd"], ["--non-solid"],
           ["--encode-header"], ["--effort", "10"]]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "-".join(o) or "default")
def test_cycle_matches_jax(tree, capsys, opts):
    opts = ["--dict-size", "65536", *opts]
    got = {}
    for key, cli in (("t", TCLI), ("j", JCLI)):
        arc = f"{key}.7z"
        res = [_call(cli, ["a", arc, "src", "one.bin", *opts], capsys)]
        res[0] = (res[0][0], res[0][1].replace(arc, "ARC"), res[0][2])
        for cmd in ("l", "t", "e", "x", "xs"):
            res.append(_call(cli, [cmd, arc, "-o", f"{key}_{cmd}"], capsys))
        host = tree / f"{key}_host.bin"
        host.write_bytes(b"junk" * 99 + (tree / arc).read_bytes() + b"tail")
        res.append(_call(cli, ["carve", str(host), "-o", f"{key}_c.7z"],
                         capsys))
        files = {cmd: _files(tree / f"{key}_{cmd}") for cmd in
                 ("e", "x", "xs")}
        got[key] = (res, (tree / arc).read_bytes(), files,
                    (tree / f"{key}_c.7z").read_bytes())
    assert got["t"][1] == got["j"][1]
    assert got["t"][3] == got["t"][1]
    # printed lines: the carved file's name differs, the rest is the same
    assert [r[:2] for r in got["t"][0][:-1]] == \
        [r[:2] for r in got["j"][0][:-1]]
    assert got["t"][0][-1][0] == got["j"][0][-1][0] == 0
    assert got["t"][2] == got["j"][2]
    want = {"src/text.txt", "src/sub/app.exe", "src/sub/empty", "one.bin"}
    assert set(got["t"][2]["x"]) == want
    assert got["t"][0][2][1].endswith("Everything is Ok\n")
    if "ppmd" in opts:      # neither package streams a PPMd folder
        assert got["t"][0][5][0] == 4
    else:
        assert got["t"][0][5][0] == 0 and got["t"][2]["xs"] == \
            got["t"][2]["x"]


def test_error_exit_codes_match_jax(tree, capsys):
    assert _call(TCLI, ["a", "a.7z", "src"], capsys)[0] == 0
    img = (tree / "a.7z").read_bytes()
    bad = bytearray(img)
    bad[40] ^= 0xFF
    (tree / "bad.7z").write_bytes(bytes(bad))
    (tree / "trunc.7z").write_bytes(img[:len(img) // 2])
    (tree / "junk.bin").write_bytes(b"no archive here" * 50)
    cases = [["t", "missing.7z"], ["l", "junk.bin"], ["t", "bad.7z"],
             ["x", "bad.7z", "-o", "o1"], ["xs", "bad.7z", "-o", "o2"],
             ["t", "trunc.7z"], ["carve", "junk.bin"],
             ["carve", "trunc.7z", "-o", "c.7z"],
             ["a", "b.7z", "missing_file"]]
    codes = []
    for argv in cases:
        rc, _out, err = _call(TCLI, argv, capsys)
        jrc, _jout, jerr = _call(JCLI, argv, capsys)
        assert rc != 0 and rc == jrc, (argv, err, jerr)
        assert err.split(":")[0] == jerr.split(":")[0], argv
        codes.append(rc)
    assert codes[0] == 8 and codes[6] == 17


def test_module_entry_point(tree):
    env = {**os.environ, "PYTHONPATH": REPO}
    assert TCLI.main(["a", "a.7z", "one.bin"]) == 0
    r = subprocess.run([sys.executable, "-m",
                        "lzma_sdk_zliblike_tpu_torch.cli.sevenz", "l",
                        "a.7z"], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [".", "9000", "one.bin"]
