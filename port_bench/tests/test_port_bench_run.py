"""A run of a cell end to end at a tiny size: the port's plain K1 on the
CPU (the card's kernel in the ``cuda`` tests), the control, the faults a
cell can have, the import rule and the refusal without a card; each on
both entry points, a raw stream (``xz_T0_preset0.bulk``) and a whole
``.xz`` file (``xz_T0_preset0.xzfile``)."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from port_bench import bench, spec

from port_bench_helpers import tiny_cell

SEED = 2**31 + 77
BULK, XZFILE = "xz_T0_preset0.bulk", "xz_T0_preset0.xzfile"
CELLS = [BULK, XZFILE]


def run(tmp_path, device="cpu", trace=False, decoder=None, seed=SEED,
        cell=None):
    cell = cell or tiny_cell()
    return bench.run_cell(cell, seed, 0.01, trace, t0=time.perf_counter(),
                          device=device, decoder=decoder,
                          cache_dir=str(tmp_path), workers=1)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tmp_path, name):
    r = run(tmp_path, cell=tiny_cell(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r["checks"]) == ["wrong_bytes", "wrong_calls",
                                 "wrong_length_calls", "failed_calls"]
    assert set(r["metrics"]) == {"decode_mb_s.host_paced", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_every_layer_metric(tmp_path, name):
    """On the CPU the trace holds no device operation, so the idle share
    is left out; every other layer metric is there (all of them in the
    ``cuda`` test)."""
    cell = tiny_cell(name)
    r = run(tmp_path, trace=True, cell=cell)
    assert r["correct"]
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer
                                 if not m["name"].startswith(
                                     "device_idle_pct")}
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tmp_path, name):
    """The reference decoder with the ordered join left out (lane order,
    largest packed group first) reads wrong bytes on every seed."""
    cell = tiny_cell(name, per_call=4, pool=6)
    control = spec.entry(cell.entry).Control(cell.config)
    for seed in (1, 2, SEED):
        r = run(tmp_path, decoder=control, seed=seed, cell=cell)
        assert not r["correct"]
        assert r["checks"]["wrong_bytes"]["value"] > 0


def fault(monkeypatch, kind):
    """Breaks the port's timed path underneath ``lzma2_uncompress``: K1's
    output, or the bytes ``finalize_chunks`` places in the call's result
    (``result=``, ``placements=``: a list per lane of (row offset, length,
    result offset)) or returns as rows."""
    import torch
    from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
    submit, finalize = G.submit_groups, G.finalize_chunks
    if kind == "state_unchanged":      # K1 leaves its output as allocated
        def broken(*a, **kw):
            h = submit(*a, **kw)
            h.out = torch.zeros_like(h.out)
            return h
        monkeypatch.setattr(G, "submit_groups", broken)
        return

    def broken(handle, **kw):
        if kw.get("result") is None:
            out, ok, consumed = finalize(handle, **kw)
            out = out.clone()
            if kind == "half_batch_left_out":
                out[out.shape[0] // 2:] = 0
            else:                       # one byte altered where made
                out[0, 5] ^= 0x40
            return out, ok, consumed
        ok, consumed = finalize(handle, **kw)
        result = kw["result"]
        lanes = [lane for lane in kw["placements"] if lane]
        if kind == "half_batch_left_out":
            for lane in lanes[len(lanes) // 2:]:
                for _, n, at in lane:
                    result[at:at + n] = 0
        else:                           # one byte altered where placed
            _, n, at = lanes[0][0]
            result[at + min(5, n - 1)] ^= 0x40
        return ok, consumed
    monkeypatch.setattr(G, "finalize_chunks", broken)


FAULTS = ["state_unchanged", "half_batch_left_out", "answer_altered"]


class Armed:
    """The entry point's port, with ``arm()`` called after its first call
    (the warm-up, which an ``.xz`` file's block check would fail before
    the window opens)."""

    def __init__(self, cell, device, arm):
        self.port = spec.entry(cell.entry).Port(cell.config, device)
        self.arm, self.calls = arm, 0

    def __call__(self, image):
        if self.calls == 1:
            self.arm()
        self.calls += 1
        return self.port(image)


def broken_run(tmp_path, monkeypatch, kind, cell, device="cpu"):
    return run(tmp_path, device=device, cell=cell, decoder=Armed(
        cell, device, lambda: fault(monkeypatch, kind)))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", FAULTS)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, kind,
                                            name):
    """A raw stream's fault reads wrong bytes; an ``.xz`` file's is caught
    by the port's block check first, so the call raises and fails."""
    r = broken_run(tmp_path, monkeypatch, kind, tiny_cell(name))
    assert not r["correct"]
    if name == BULK:
        assert r["checks"]["wrong_bytes"]["value"] > 0
    else:
        assert r["checks"]["failed_calls"]["value"] == r["attempted"]


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["lzma_sdk_zliblike_tpu_torch", "lzma_sdk_zliblike_tpu_torch.api",
             "lzma_sdk_zliblike_tpu", "lzma_sdk_zliblike_tpu.ops.x", "jax",
             "jaxlib.xla", "jax_cool", "flax", "flaxen", "numpy"]
    assert bench.forbidden_modules(names) == [
        "flax", "jax", "jaxlib.xla", "lzma_sdk_zliblike_tpu",
        "lzma_sdk_zliblike_tpu.ops.x"]


IMPORTS = r"""
import sys, time
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
from port_bench import bench, control, profiling, spans
from port_bench_helpers import tiny_cell
for name, trace in (("xz_T0_preset0.bulk", True),
                    ("xz_T0_preset0.xzfile", False)):
    r = bench.run_cell(tiny_cell(name), 5, 0.01, trace,
                       t0=time.perf_counter(), device="cpu",
                       cache_dir=sys.argv[3], workers=1)
    assert r["correct"], r
print(bench.forbidden_modules(sys.modules))
"""


def test_a_run_imports_neither_jax_nor_the_jax_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", IMPORTS, spec.ROOT, os.path.dirname(__file__),
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def run_py(root, env=None):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "xz_T0_preset0.bulk", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_py(spec.ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_checkout_without_the_port_gives_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / spec.SUBDIR,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = run_py(str(tmp_path))
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_sound_and_broken(card, tmp_path, monkeypatch, name):
    cell = tiny_cell(name)
    r = run(tmp_path, device=card, trace=True, cell=cell)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}
    for kind in FAULTS:
        with monkeypatch.context() as m:
            assert not broken_run(tmp_path, m, kind, cell,
                                  device=card)["correct"], kind


def test_the_result_line_keeps_the_contract(tmp_path, capsys):
    r = run(tmp_path)
    capsys.readouterr()
    bench.emit(r)
    captured = capsys.readouterr()
    last = json.loads(captured.out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert captured.err.strip().splitlines()[-1].startswith(
        "check failed_calls 0 limit 0")
