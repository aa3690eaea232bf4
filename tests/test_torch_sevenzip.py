"""The port's 7z reader, writer and carver (``containers/sevenzip.py``)
against the JAX package's.

Archives written by both packages from the same files and ``mtimes`` must
be byte-identical on every folder shape of ``tests/test_sevenzip.py``
(plus PPMd and delta), each package must extract the other's archives, a
corrupt byte must raise the same error class in both, and ``carve`` /
``find_signature`` must agree.  The reference's ``7z`` reads the port's
archives where the ``oracle`` fixture has it.  Pinned: a device engine
name other than ``"device"``, which the JAX package runs in pure Python,
raises UnsupportedError in the port; ``"device"`` is the port's device
route (``tests/test_torch_sevenzip_device.py``), equal to the JAX
package's host extraction.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import os
import subprocess
import sys
import types

import pytest

from lzma_sdk_zliblike_tpu.containers import sevenzip as JS
from lzma_sdk_zliblike_tpu_torch.containers import sevenzip as TS
from lzma_sdk_zliblike_tpu_torch.utils import errors as TE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's native library, loaded in this worker before the
# module's first test (tests/torch_jax_native.py: a worker can lose the
# JAX package's own build of it)
_jnl = importlib.util.spec_from_file_location(
    "lzt_torch_jax_native", os.path.join(REPO, "tests", "torch_jax_native.py"))
_JNL = importlib.util.module_from_spec(_jnl)
_jnl.loader.exec_module(_JNL)
jax_native_loaded = _JNL.jax_native_loaded
_arch = importlib.util.spec_from_file_location(
    "lzt_torch_sevenz_archives_jax",
    os.path.join(REPO, "tests", "torch_sevenz_archives.py"))
_ARCHIVES = importlib.util.module_from_spec(_arch)
sys.modules[_arch.name] = _ARCHIVES
_arch.loader.exec_module(_ARCHIVES)
_spec = importlib.util.spec_from_file_location(
    "lzt_corpus", os.path.join(REPO, "tests", "corpus.py"))
_corpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_corpus)
_C = _corpus.make_corpus()

FILES = {
    "docs/readme.txt": _C["text"][:20000],
    "src/main.c": _C["code"][:15000],
    "bin/app.exe": _C["x86"][:12000],
    "rep.bin": _C["repeat"][:9000],
    "empty.txt": b"",
}
TICKS = (11644473600 + 1_600_000_000) * 10**7    # 2020-09-13 UTC
MTIMES = {"docs/readme.txt": TICKS, "rep.bin": TICKS + 10**7}

SHAPES = [
    ("copy", dict(method=TS.M_COPY)),
    ("lzma", dict(method=TS.M_LZMA)),
    ("lzma2", dict(method=TS.M_LZMA2)),
    ("lzma2-nonsolid", dict(method=TS.M_LZMA2, solid=False)),
    ("lzma2-bcj", dict(method=TS.M_LZMA2, pre_filter=TS.M_BCJ)),
    ("lzma-bcj2", dict(method=TS.M_LZMA, pre_filter=TS.M_BCJ2)),
    ("lzma2-enchdr", dict(method=TS.M_LZMA2, encode_header=True)),
    ("ppmd", dict(method=TS.M_PPMD)),
    ("lzma2-delta", dict(method=TS.M_LZMA2, pre_filter=TS.M_DELTA)),
]
IDS = [s[0] for s in SHAPES]


def _img(kw, mtimes=None) -> bytes:
    return TS.write(FILES, dict_size=1 << 16, mtimes=mtimes, **kw)


@pytest.mark.parametrize("desc,kw", SHAPES, ids=IDS)
def test_write_matches_jax(desc, kw):
    for mtimes in (None, MTIMES):
        assert _img(kw, mtimes) == JS.write(FILES, dict_size=1 << 16,
                                            mtimes=mtimes, **kw), mtimes


@pytest.mark.parametrize("desc,kw", SHAPES, ids=IDS)
def test_each_extracts_the_other(desc, kw):
    img = _img(kw, MTIMES)
    jimg = JS.write(FILES, dict_size=1 << 16, mtimes=MTIMES, **kw)
    assert TS.extract(jimg) == JS.extract(img) == FILES
    assert TS.test(jimg) == JS.test(img)
    ents, jents = TS.list_files(img), JS.list_files(img)
    assert [dataclasses.asdict(e) for e in ents] == \
        [dataclasses.asdict(e) for e in jents]
    assert {e.name: e.mtime for e in ents}["rep.bin"] == TICKS + 10**7
    ar, jar = TS.parse(img), JS.parse(img)
    assert len(ar.folders) == len(jar.folders)
    for fi in range(len(ar.folders)):
        assert TS.decode_folder(img, ar, fi) == \
            JS.decode_folder(img, jar, fi)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("desc,kw", [SHAPES[1], SHAPES[2], SHAPES[5]],
                         ids=["lzma", "lzma2", "lzma-bcj2"])
def test_host_engines_match_jax(desc, kw, engine):
    """``engine`` reaches the LZMA/LZMA2 coders: the port's pure-Python
    engine writes and reads what the JAX package's does."""
    files = {k: v[:3000] for k, v in FILES.items()}
    img = TS.write(files, dict_size=1 << 16, engine=engine, **kw)
    assert img == JS.write(files, dict_size=1 << 16, engine=engine, **kw)
    assert TS.extract(img, engine=engine) == files


def test_oracle_reads_port_archives(oracle, tmp_path):
    for desc, kw in SHAPES:
        img = _img(kw)
        d = tmp_path / desc
        d.mkdir()
        (d / "t.7z").write_bytes(img)
        for cmd in ("t", "x"):
            r = subprocess.run([oracle["oracle_7z"], cmd, "t.7z"],
                               capture_output=True, cwd=d)
            assert r.returncode == 0, (desc, cmd, r.stderr[-2000:])
        for nm, b in FILES.items():
            assert (d / nm).read_bytes() == b, (desc, nm)


def _error(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception as e:          # the class is what is compared
        return type(e).__name__
    return None


def test_corrupt_payload_raises_crc_error_in_both():
    """A flipped byte in a stored (copy) folder: the folder CRC catches it
    in both packages, with CrcError."""
    img = bytearray(_img(dict(method=TS.M_COPY)))
    img[40] ^= 0xFF
    assert _error(TS.extract, bytes(img)) == "CrcError"
    assert _error(JS.extract, bytes(img)) == "CrcError"
    with pytest.raises(TE.CrcError):
        TS.test(bytes(img))


@pytest.mark.parametrize("desc,kw", SHAPES, ids=IDS)
def test_corruption_raises_the_same_class(desc, kw):
    img = _img(kw)
    for pos in (40, len(img) // 2, len(img) - 10):
        bad = bytearray(img)
        bad[pos] ^= 0x55
        got = _error(TS.extract, bytes(bad))
        assert got is not None and got == _error(JS.extract, bytes(bad)), pos


def test_carve_and_find_signature_match_jax():
    img = _img(dict(method=TS.M_LZMA2, pre_filter=TS.M_BCJ))
    host = b"garbage" * 777 + img + b"trailer"
    assert TS.find_signature(host) == JS.find_signature(host) == 7 * 777
    assert TS.find_signature(host, 7 * 777 + 1) == \
        JS.find_signature(host, 7 * 777 + 1) == -1
    assert TS.carve(host) == JS.carve(host) == img
    assert TS.extract(TS.carve(host)) == FILES
    for bad in (b"not an archive at all", host[:7 * 777 + 20],
                host[:7 * 777 + len(img) - 5]):
        assert _error(TS.carve, bad) == _error(JS.carve, bad) is not None
    with pytest.raises(TE.NoArchiveError):
        TS.carve(b"not an archive at all")


def test_mtime_helpers_match_jax(tmp_path):
    assert TS.filetime_to_unix(TICKS) == JS.filetime_to_unix(TICKS)
    p = tmp_path / "f"
    p.write_bytes(b"x")
    TS.apply_mtime(str(p), TICKS)
    assert abs(os.stat(p).st_mtime - 1_600_000_000) < 2
    TS.apply_mtime(str(p), None)        # no time: left as it is
    assert abs(os.stat(p).st_mtime - 1_600_000_000) < 2


def test_device_engine_refused_where_jax_runs_python():
    """Pinned: the JAX package decodes with ``engine="tpu"`` in pure Python
    (``framing.decode`` sends every name but auto/native to
    ``decode_chunks``); the port refuses ``"tpu"``, ``"hybrid"`` and
    ``"cuda"`` before any work, and ``write`` refuses ``"device"`` too.
    ``extract(engine="device")`` is the port's device route: its output
    equals the JAX package's host extraction."""
    img = _img(dict(method=TS.M_LZMA2))
    assert JS.extract(img, engine="tpu") == FILES
    for engine in ("tpu", "hybrid", "cuda"):
        with pytest.raises(TE.UnsupportedError):
            TS.extract(img, engine=engine)
        with pytest.raises(TE.UnsupportedError):
            TS.write(FILES, engine=engine)
    with pytest.raises(TE.UnsupportedError):
        TS.write(FILES, engine="device")
    assert TS.extract(img, engine="device", device="cpu") == \
        JS.extract(img) == FILES
    with pytest.raises(TE.UnsupportedError):
        TS.test(img, engine="tpu")


@pytest.mark.parametrize("exe,data", [(1, 2), (2, 1)],
                         ids=["bcj_one_group", "bcj_of_several_groups"])
def test_device_route_equals_jax_on_7zip_archives(exe, data):
    """Archives laid out as 7-Zip writes them (an x86 BCJ folder and an
    LZMA2 folder of several dict-reset groups, the header LZMA-coded): the
    port's device route, on the kernels' plain versions, gives the JAX
    package's extraction and the plain reference's, byte for byte."""
    img = _ARCHIVES.archive(2**31 + exe, exe=exe, data=data)
    got = TS.extract(img, engine="device", device="cpu")
    assert got == JS.extract(img) == _ARCHIVES.originals(img)
    assert list(got) == list(JS.extract(img))


def test_ppmd_folder_needs_no_size_gate(monkeypatch):
    """The JAX package's LZT_PPMD_MAX_BYTES gate guards only its Python
    fallback; the port's PPMd folders always decode natively."""
    monkeypatch.setenv("LZT_PPMD_MAX_BYTES", "16")
    img = _img(dict(method=TS.M_PPMD))
    assert TS.extract(img) == FILES


# ---------------------------------------------------------------------------
# public names: the port has a counterpart for every name of this slice
# ---------------------------------------------------------------------------

SLICE_MODULES = ["containers.sevenzip", "streams.extract7z", "streams.router",
                 "streams.zlike", "models.ppmd7.codec", "cli.sevenz",
                 "containers.xz", "models.lzma2.framing", "utils.errors"]


def _public(mod) -> set[str]:
    """The public names a module defines (imported modules, classes and
    functions left out)."""
    out = set()
    for n, v in vars(mod).items():
        if n.startswith("_") or n == "annotations" or \
                isinstance(v, types.ModuleType):
            continue
        if isinstance(v, (type, types.FunctionType)) and \
                v.__module__ != mod.__name__:
            continue
        out.add(n)
    return out


@pytest.mark.parametrize("name", SLICE_MODULES)
def test_public_names_cover_jax(name):
    jax_mod = importlib.import_module("lzma_sdk_zliblike_tpu." + name)
    port = importlib.import_module("lzma_sdk_zliblike_tpu_torch." + name)
    assert _public(jax_mod) - _public(port) == set()


def test_package_exports_cover_jax():
    import lzma_sdk_zliblike_tpu as J
    import lzma_sdk_zliblike_tpu_torch as T
    names = {n for n, v in vars(J).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert {n for n in names if not hasattr(T, n)} == set()
    assert T.MemError.sres == J.MemError.sres == 2
    for cls in ("MemError", "NoArchiveError", "ReadError", "ThreadError",
                "WriteError"):
        assert getattr(TE, cls).sres == getattr(
            importlib.import_module("lzma_sdk_zliblike_tpu.utils.errors"),
            cls).sres
        with pytest.raises(getattr(TE, cls)):
            TE.raise_for_sres(getattr(TE, cls).sres)
