"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

Set-up reads (or, in a new checkout, builds) the configuration's block
pool, makes the images of the files the seed sends, imports the port and
decodes a warm-up image, which builds and loads the kernels.  What an
image is, the warm-up and the port's call are the configuration's entry
point's (``entries/<entry>.py``; ``lzma2_stream``: the blocks' payloads
joined as one stream, the first chunk of each block of the first file,
``lzma2_uncompress(stream, dict_prop, engine="device", device="cuda")``).
The window then sends the images in turn, one call at a time, until
``--seconds`` have passed; it ends when that call returns, so every call
in it is whole.  With ``--trace 1`` the wrappers of ``spans.py`` and a
profiler session cover the window.  Once it has closed, the outputs of a
sample of its calls, drawn from the seed, are compared with the reference
(``reference.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

from . import reference, spec, traffic
from . import pool as P

FORBIDDEN = ("jax", "jaxlib", "flax", "lzma_sdk_zliblike_tpu")


def forbidden_modules(names) -> list[str]:
    """The module names whose top-level name (before the first dot) is
    exactly one of ``FORBIDDEN``: ``lzma_sdk_zliblike_tpu_torch`` is not
    ``lzma_sdk_zliblike_tpu``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class Call:
    """One call of the window."""

    file: int            # index into the run's files
    out_bytes: int       # 0 where the call raised
    packed: int          # the image's chunk bodies (from their headers)
    unpacked: int
    seconds: float
    error: str | None = None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    calls: list
    spans: list | None = None      # spans.CallSpans per call (traced run)
    profile: dict | None = None    # profiling.reduce (traced run)


def _files(cell, seed: int, cache_dir: str, workers, phases: dict):
    """(files, images, warm-up image, pool) of a run; the seconds of each
    step go into ``phases``."""
    entry = spec.entry(cell.entry)
    t = time.perf_counter()
    files = traffic.files(cell.traffic, seed, cell.config["block_size"])
    pool = P.Pool(cell.config, cache_dir)
    used = sorted({b for f in files for b in f})
    phases["pool_built_blocks"] = len(pool.ensure(used, workers))
    phases["pool_build_s"], t = _lap(t)
    payloads = {b: pool.payload(b) for b in used}
    phases["pool_read_s"], t = _lap(t)
    if hasattr(entry, "prepare"):
        phases["entry_built_blocks"] = len(entry.prepare(pool, used, workers))
        phases["entry_build_s"], t = _lap(t)
    images, warm = entry.images(pool, files, payloads)
    phases["join_s"], t = _lap(t)
    return files, images, warm, pool


def _lap(t: float) -> tuple[float, float]:
    now = time.perf_counter()
    return now - t, now


def run_cell(cell, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", decoder=None, cache_dir: str = P.CACHE_DIR,
             workers: int | None = None) -> dict:
    """Runs ``cell`` and returns its result (the keys of the result line,
    ``checks`` last); prints the port's counters and the calls' times on
    earlier lines.  ``decoder``, called with an image, stands in for the
    entry point's ``Port`` (the control, the tests' faults)."""
    import torch
    on_card = device == "cuda"
    entry = spec.entry(cell.entry)
    phases = {"start_s": time.perf_counter() - t0}
    files, images, warm, pool = _files(cell, seed, cache_dir, workers,
                                        phases)
    t = time.perf_counter()
    work = [entry.work(s) for s in images]
    expect_len = [sum(size for _, size in f) for f in files]
    decoder = decoder or entry.Port(cell.config, device)
    phases["port_import_s"], t = _lap(t)
    with contextlib.ExitStack() as stack:
        spans = None
        if trace:
            from . import profiling
            from . import spans as S
            spans = stack.enter_context(S.Spans(entry.TIMED))
        decoder(warm)
        if on_card:
            torch.cuda.synchronize()
        if spans:
            spans.reset()
        if hasattr(decoder, "reset_counters"):
            decoder.reset_counters()
        phases["warm_up_s"], t = _lap(t)
        setup_s = t - t0
        print("setup " + json.dumps(phases), file=sys.stderr, flush=True)
        sample = traffic.Sample(cell.traffic["check_calls"], seed)
        with (profiling.session(torch) if trace
              else contextlib.nullcontext()) as prof:
            calls, window_s = _window_calls(decoder, images, work,
                                            seconds, sample, spans, torch,
                                            f"call.{entry.CALL}")
        if on_card:
            torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    counters = decoder.counters() if hasattr(decoder, "counters") else {}
    del images
    if on_card:
        torch.cuda.empty_cache()
    run = Run(setup_s, window_s, calls, spans.calls if spans else None)
    if trace:
        t_trace = time.perf_counter()
        run.profile = profiling.reduce(
            profiling.trace_events(prof),
            sum(s.launches for s in spans.calls) if on_card else 0,
            sum(s.k1_s for s in spans.calls) if on_card else 0.0)
        print(f"trace read in {time.perf_counter() - t_trace:.3f} s",
              file=sys.stderr)
    t_check = time.perf_counter()
    checks, compared = _compare(pool, files, calls, sample, expect_len)
    print(f"compared {compared} of {len(calls)} calls with the reference in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = _device(torch, on_card, cell.chips, peak)
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": len(calls),
              "failed": sum(c.error is not None for c in calls)
              + checks["wrong_calls"]["value"],
              "metrics": metrics, "device": dev}
    if trace and run.profile:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = run.profile["breakdown"]
    elif trace:
        dev["busy_s"] = sum(s.k1_s for s in run.spans)
        dev["window_s"] = window_s
    result["checks"] = checks
    if counters:
        print("counters " + json.dumps(counters), flush=True)
    secs = sorted(c.seconds for c in calls)
    print(f"calls {len(secs)}: s min {secs[0]:.4f}, median "
          f"{secs[len(secs) // 2]:.4f}, max {secs[-1]:.4f}", file=sys.stderr)
    return result


def _window_calls(decoder, images, work, seconds, sample, spans, torch,
                  label):
    """The measured window: calls in turn until ``seconds`` have passed,
    each in a profiler range ``label``."""
    record_function = (torch.profiler.record_function if spans
                       else lambda name: contextlib.nullcontext())
    calls = []
    with record_function("window"):
        start = time.perf_counter()
        i = 0
        while True:
            f = i % len(images)
            if spans:
                spans.begin_call()
            t = time.perf_counter()
            error = out = None
            try:
                with record_function(label):
                    out = decoder(images[f])
            except Exception as e:  # a call that raises is a failed call
                error = f"{type(e).__name__}: {e}"
            end = time.perf_counter()
            if spans:
                spans.end_call(end)
            calls.append(Call(f, len(out) if out is not None else 0,
                              *work[f], end - t, error))
            if out is not None:
                sample.offer((f, out))
            out = None
            i += 1
            if end - start >= seconds:
                return calls, end - start


def _compare(pool, files, calls, sample, expect_len) -> tuple[dict, int]:
    """The numbers compared, each with its limit, and how many outputs were
    compared byte for byte."""
    originals: dict = {}
    wrong = wrong_calls = 0
    for f, out in sample.items:
        n = reference.wrong_bytes(out, reference.expected(pool, files[f],
                                                          originals))
        wrong += n
        wrong_calls += n > 0
    compared = len(sample.items)
    sample.items.clear()
    failed = sum(c.error is not None for c in calls)
    short = sum(c.error is None and c.out_bytes != expect_len[c.file]
                for c in calls)
    return ({"wrong_bytes": {"value": wrong, "limit": 0},
             "wrong_calls": {"value": wrong_calls, "limit": 0},
             "wrong_length_calls": {"value": short, "limit": 0},
             "failed_calls": {"value": failed, "limit": 0}},
            compared)


def _device(torch, on_card: bool, chips: int, peak: int) -> dict:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="port_bench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> None:
    """The check lines (last on standard error) and the result line (last
    on standard output)."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    t = time.perf_counter()
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"start: interpreter and BENCHMARK.json {t - t0:.3f} s, torch's "
          f"import {t_torch - t:.3f} s, the card's check "
          f"{time.perf_counter() - t_torch:.3f} s", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"port_bench: the run loaded {found}, which the port may not "
              "import", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    emit(result)
    return 0
