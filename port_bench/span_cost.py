"""What the port's spans cost when on, per call:

    python3 port_bench/span_cost.py --workload <cell> --seed <n> [--pairs 10]

run from the root of a checkout on the card.  Builds the cell's files from
the seed as a run does and makes a warm-up call; then ``pairs`` pairs of
calls, both calls of a pair on the same file, spans off then on
(``TRACE.capture()``, no profiler session) or on then off, in turns.
Prints one JSON line: each side's call seconds (median and quartiles,
``statistics.quantiles``), the pairs' differences on - off, and each
span's mean ms a call on each side (the trace's aggregates, which both
sides keep), so that a cost can be named by span.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def _quartiles(values) -> dict:
    q = statistics.quantiles(values, n=4) if len(values) > 1 \
        else [values[0]] * 3
    return {"median": statistics.median(values), "q1": q[0], "q3": q[2],
            "values": values}


def measure(cell, seed: int, pairs: int, *, device: str = "cuda",
            cache_dir: str | None = None, workers=None) -> dict:
    from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
    from . import bench, spec
    from . import pool as P
    files, streams, warm, _pool = bench._files(
        cell, seed, cache_dir or P.CACHE_DIR, workers, {})
    entry = spec.entry(cell.entry)
    expect = [entry.work(s)[1] for s in streams]
    decoder = entry.Port(cell.config, device)
    decoder(warm)
    secs = {"off": [], "on": []}
    span_s: dict = {"off": {}, "on": {}}
    for i in range(pairs):
        f = i % len(streams)
        for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
            TRACE.reset()
            t = time.perf_counter()
            if side == "on":
                with TRACE.capture():
                    out = decoder(streams[f])
            else:
                out = decoder(streams[f])
            secs[side].append(time.perf_counter() - t)
            if len(out) != expect[f]:
                raise RuntimeError(f"call {i} ({side}) returned "
                                   f"{len(out)} bytes")
            out = None
            for name, v in TRACE.snapshot().items():
                if isinstance(v, dict):
                    span_s[side][name] = span_s[side].get(name, 0.0) \
                        + v["total_s"]
    diffs = [b - a for a, b in zip(secs["off"], secs["on"])]
    return {"workload": cell.name, "seed": seed, "pairs": pairs,
            "off_s": _quartiles(secs["off"]), "on_s": _quartiles(secs["on"]),
            "on_minus_off_s": _quartiles(diffs),
            "span_ms_per_call": {
                name: {side: span_s[side].get(name, 0.0) * 1e3 / pairs
                       for side in ("off", "on")}
                for name in sorted(set(span_s["off"]) | set(span_s["on"]))}}


def main(argv=None) -> int:
    from . import bench, spec
    ap = argparse.ArgumentParser(prog="port_bench/span_cost.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("port_bench/span_cost.py: no CUDA device", file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.pairs)
    result["card"] = bench.card_line()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from port_bench import span_cost
    sys.exit(span_cost.main())
