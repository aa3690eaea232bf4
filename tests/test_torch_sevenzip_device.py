"""The port's 7z device route, ``containers/sevenzip.extract(
engine="device")``, held against the plain reference
(``tests/sevenz_plain.py``: the standard library's ``lzma`` and ``zlib``)
and the port's own host engine, on seeded small archives laid out as 7-Zip
writes them (``torch_sevenz_archives``): an x86 BCJ folder of one
dict-reset group or of several, LZMA2 folders of several groups, an LZMA
folder, an LZMA-coded header.

On the CPU the route runs the kernels' plain versions (``device="cpu"``);
the ``cuda``-marked twins run K1 and X4 on the card.  This file imports no
JAX: the comparison with the JAX package's ``extract`` is in
``test_torch_sevenzip.py``.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import pytest

from lzma_sdk_zliblike_tpu_torch.containers import sevenzip as TS
from lzma_sdk_zliblike_tpu_torch.ops import device_filters as DF
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.parallel import scheduler
from lzma_sdk_zliblike_tpu_torch.utils.errors import (CrcError,
                                                      UnsupportedError)
from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "lzt_torch_sevenz_archives",
    os.path.join(HERE, "torch_sevenz_archives.py"))
A = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = A
_spec.loader.exec_module(A)

SEED = 2**31 + 24
# (exe groups behind BCJ, LZMA2 data groups, LZMA parts)
SHAPES = {"bcj_one_group": (1, 2, 0), "bcj_of_several_groups": (3, 1, 0),
          "lzma2_alone": (0, 3, 0), "with_an_lzma_folder": (1, 1, 2)}
SPANS = {"sevenzip.extract", "sevenzip.header", "sevenzip.decode",
         "sevenzip.filter", "sevenzip.check", "sevenzip.files"}


def _image(name: str, **kw) -> bytes:
    exe, data, lzma1 = SHAPES[name]
    return A.archive(SEED + len(name), exe=exe, data=data, lzma1=lzma1, **kw)


class _Seen:
    """What ``decode_into`` was handed and gave back, and each x86
    launch's length."""

    def __init__(self, monkeypatch):
        self.batches, self.x86 = [], []
        into, x86 = scheduler.BatchedLzma2Decoder.decode_into, \
            DF.x86_convert_batch

        def decode_into(dec, stream, groups, result, *, convert=None):
            done = into(dec, stream, groups, result, convert=convert)
            self.batches.append((len(groups), sorted(convert or {}), done))
            return done

        def convert_batch(data, valid, ip, *, encoding):
            self.x86.append(data.shape[1])
            return x86(data, valid, ip, encoding=encoding)
        monkeypatch.setattr(scheduler.BatchedLzma2Decoder, "decode_into",
                            decode_into)
        monkeypatch.setattr(DF, "x86_convert_batch", convert_batch)


@pytest.mark.parametrize("name", list(SHAPES))
def test_device_route_equals_the_plain_reference_and_native(name,
                                                            monkeypatch):
    """Byte for byte and name for name, in archive order; every LZMA2
    group of every folder in one K1 batch; X4 x86 over each BCJ folder,
    in its K1 row where the folder is one group; the LZMA folder on the
    host, counted; the route's spans, one set a call."""
    img = _image(name)
    want = A.originals(img)
    assert TS.extract(img, engine="native") == want
    seen = _Seen(monkeypatch)
    TRACE.reset()
    with TRACE.capture() as cap:
        got = TS.extract(img, engine="device", device="cpu")
    assert got == want and list(got) == list(want)
    exe, data, lzma1 = SHAPES[name]
    snap = TRACE.snapshot()
    assert snap["scheduler.pallas_batches"] == 1
    assert snap["group_decode.lanes"] == exe + data
    assert snap.get("sevenzip.host_folders", 0) == (lzma1 > 0)
    [(n_groups, convert, done)] = seen.batches
    assert n_groups == exe + data
    bcj_size = sum(len(v) for k, v in want.items() if k.startswith("bin/"))
    if exe == 1:        # the folder's one group, converted in its row
        assert convert == [0] and done == {0}
    else:               # converted once placed: one launch over it all
        assert convert == [] and done == set()
    assert seen.x86 == ([bcj_size] if exe else [])
    assert snap.get("device_filters.x86_bytes", 0) == bcj_size
    spans = cap.take()
    assert {s.name for s in spans} >= SPANS - (set() if exe else
                                               {"sevenzip.filter"})
    roots = [s for s in spans if s.name == "sevenzip.extract"]
    assert len(roots) == 1 and all(s.call == roots[0].call for s in spans)


def test_test_command_and_names():
    img = _image("bcj_one_group")
    assert TS.test(img, engine="device", device="cpu") == \
        list(A.originals(img))


@pytest.mark.parametrize("fault", [0, 4])
def test_a_wrong_file_crc_raises_as_on_the_host(fault):
    """A stored CRC32 that its file does not have: CrcError on the device
    route, as on the host engine (and in the plain reference)."""
    img = _image("bcj_one_group", crc_fault=fault)
    with pytest.raises(CrcError, match="CRC mismatch"):
        TS.extract(img, engine="native")
    with pytest.raises(CrcError, match="CRC mismatch"):
        TS.extract(img, engine="device", device="cpu")
    with pytest.raises(A.plain.CrcMismatch):
        A.originals(img)
    assert TS.extract(img, engine="device", device="cpu",
                      verify=False).keys() == \
        TS.extract(_image("bcj_one_group"), engine="native").keys()


def test_the_filter_left_out_fails_the_crc(monkeypatch):
    """X4 x86 made to return its input: the executables' files no longer
    match their CRC32s, and the route says so."""
    img = _image("bcj_one_group")
    monkeypatch.setattr(DF, "x86_convert_batch",
                        lambda data, valid, ip, *, encoding: data.clone())
    with pytest.raises(CrcError, match="file bin/app"):
        TS.extract(img, engine="device", device="cpu")


@pytest.mark.parametrize("kw,host", [
    (dict(method=TS.M_LZMA), 1),
    (dict(method=TS.M_LZMA, pre_filter=TS.M_BCJ2), 1),
    (dict(method=TS.M_PPMD), 1),
    (dict(method=TS.M_COPY), 1),
    (dict(method=TS.M_LZMA2, pre_filter=TS.M_DELTA), 1),
    (dict(method=TS.M_LZMA2, solid=False), 0),
    (dict(method=TS.M_LZMA2, pre_filter=TS.M_BCJ, encode_header=True), 0),
], ids=["lzma", "lzma-bcj2", "ppmd", "copy", "lzma2-delta",
        "lzma2-nonsolid", "lzma2-bcj-enchdr"])
def test_other_folders_decode_on_the_host(kw, host):
    """Under ``engine="device"`` a folder the card does not take (LZMA,
    BCJ2, PPMd, Copy, another filter) decodes on the host and is counted;
    the port writer's LZMA2 folders, with or without BCJ, go to the card.
    An empty file comes back empty."""
    c = A.corpus.make_corpus()
    files = {"a.txt": c["text"][:1500], "b.exe": c["x86"][:1200],
             "empty.txt": b""}
    img = TS.write(files, dict_size=1 << 16, **kw)
    TRACE.reset()
    assert TS.extract(img, engine="device", device="cpu") == files
    folders = len(TS.parse(img).folders)
    assert TRACE.snapshot().get("sevenzip.host_folders", 0) == host * folders


def test_engines_the_route_refuses():
    img = _image("lzma2_alone")
    for engine in ("tpu", "hybrid", "cuda"):
        with pytest.raises(UnsupportedError):
            TS.extract(img, engine=engine, device="cpu")
    ar = TS.parse(img)
    with pytest.raises(UnsupportedError):
        TS.decode_folder(img, ar, 0, engine="device")
    with pytest.raises(UnsupportedError):
        TS.write({"a": b"x"}, engine="device")


def test_no_card_is_refused():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(UnsupportedError):
        TS.extract(_image("lzma2_alone"), engine="device", device="cuda")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_device_route_on_the_card(name, card):
    """On the card: the plain reference's bytes, one K1 launch a call, X4
    x86 launched for a BCJ folder."""
    img = _image(name)
    want = A.originals(img)
    G.launches = 0
    DF.launches["x86"] = 0
    assert TS.extract(img, engine="device", device=card) == want
    assert G.launches == 1
    assert DF.launches["x86"] == (SHAPES[name][0] > 0)
