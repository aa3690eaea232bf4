"""``BENCHMARK.json``: its rules, and a cell resolved to its files by name.

A cell (an entry of ``workloads``) names a configuration, whose ``file``
holds its parameters, and a traffic mix, found as
``port_bench/traffic/<traffic>.json``.  The configuration's ``entry``
names the port's entry point, ``port_bench/entries/<entry>.py``: what a
call hands the port and how the port is called (``lzma2_stream`` where the
file names none).  Each metric is read by
``port_bench/metrics/<name>.py``; a name split by the kind of cell that
reports it (``decode_mb_s.host_paced``) without a file of its own is read
by the file of the name before its last dot.  A later cell, configuration,
mix, metric or entry point is added by adding files and entries: nothing
here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SUBDIR = os.path.basename(BENCH_DIR)

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}\Z")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
DEFAULT_ENTRY = "lzma2_stream"
ENTRY = re.compile(r"[A-Za-z0-9_]{1,64}\Z")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text, what: str, errs: list) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 \
            or "\n" in text or "\r" in text or "\t" in text:
        errs.append(f"{what}: 1 to 200 characters on one line, no tab")


def _name(text, what: str, errs: list) -> None:
    if not isinstance(text, str) or not NAME.match(text):
        errs.append(f"{what} {text!r}: not a name")


def _count(items, lo: int, hi: int, what: str, errs: list) -> list:
    if not isinstance(items, list) or not lo <= len(items) <= hi:
        errs.append(f"{what}: {lo} to {hi} entries")
        return []
    return items


def _keys(entry, need: set, what: str, errs: list, extra=()) -> bool:
    if not isinstance(entry, dict):
        errs.append(f"{what}: not an object")
        return False
    keys = set(entry)
    if not need <= keys or keys - need - set(extra):
        errs.append(f"{what}: keys {sorted(keys)}, want {sorted(need)}"
                    + (f" (+ {sorted(extra)})" if extra else ""))
        return False
    return True


def problems(bench: dict) -> list[str]:
    """What in ``bench`` breaks the benchmark's rules (empty: none)."""
    errs: list[str] = []
    if not isinstance(bench, dict) or set(bench) != TOP_KEYS:
        return [f"top-level keys must be exactly {sorted(TOP_KEYS)}"]
    cmd = bench["command"]
    if not isinstance(cmd, list) or not 1 <= len(cmd) <= 32:
        errs.append("command: 1 to 32 strings")
    else:
        for w in cmd:
            _line(w, "command word", errs)
    for p in _count(bench["paths"], 1, 16, "paths", errs):
        if not isinstance(p, str) or not PATH.match(p) or p.startswith("/") \
                or ".." in p.split("/"):
            errs.append(f"path {p!r}: a relative path inside the repo")
    rs = bench["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        errs.append("run_seconds: a whole number from 1 to 51")
    configs = _count(bench["configs"], 1, 24, "configs", errs)
    cells = _count(bench["workloads"], 1, 24, "workloads", errs)
    e2e = _count(bench["end_to_end"], 1, 16, "end_to_end", errs)
    layer = _count(bench["per_layer"], 1, 128, "per_layer", errs)
    for c in configs:
        if not _keys(c, CONFIG_KEYS, f"config {c.get('name')}", errs):
            continue
        _name(c["name"], "config name", errs)
        _line(c["source"], f"{c['name']} source", errs)
        _line(c["why"], f"{c['name']} why", errs)
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            errs.append(f"{c['name']} reduced: at most 16 keys")
        else:
            for k in c["reduced"]:
                _name(k, f"{c['name']} reduced key", errs)
    config_names = {c.get("name") for c in configs if isinstance(c, dict)}
    pairs = set()
    for w in cells:
        if not _keys(w, CELL_KEYS, f"workload {w.get('name')}", errs):
            continue
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}", errs)
        _line(w["why"], f"{w['name']} why", errs)
        if w["config"] not in config_names:
            errs.append(f"{w['name']}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4) or isinstance(w["chips"], bool):
            errs.append(f"{w['name']}: chips is 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            errs.append(f"{w['name']}: config and traffic pair repeated")
        pairs.add((w["config"], w["traffic"]))
    cell_names = {w.get("name") for w in cells if isinstance(w, dict)}
    for m in e2e:
        if not _keys(m, E2E_KEYS, f"metric {m.get('name')}", errs,
                     ("workloads",)):
            continue
        b = m["bound"]
        if not isinstance(b, (int, float)) or isinstance(b, bool) \
                or not 0.01 <= b <= 0.25:
            errs.append(f"{m['name']}: bound from 0.01 to 0.25")
        if m["source"] not in ("host_clock", "device_trace"):
            errs.append(f"{m['name']}: an end-to-end source is host_clock "
                        "or device_trace")
    e2e_names = {m.get("name") for m in e2e if isinstance(m, dict)}
    if "setup_s" not in e2e_names:
        errs.append("end_to_end lacks setup_s")
    for m in layer:
        if not _keys(m, LAYER_KEYS, f"metric {m.get('name')}", errs,
                     ("workloads",)):
            continue
        _line(m["layer"], f"{m['name']} layer", errs)
        if m["moves"] not in e2e_names:
            errs.append(f"{m['name']}: moves names no end-to-end metric")
        if m["source"] not in ("device_trace", "program_span",
                               "program_counter", "host_clock"):
            errs.append(f"{m['name']}: unknown source {m['source']!r}")
    for m in e2e + layer:
        if not isinstance(m, dict):
            continue
        _name(m.get("name"), "metric name", errs)
        if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
            errs.append(f"{m.get('name')}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            errs.append(f"{m.get('name')}: better is lower or higher")
        for cell in m.get("workloads", []):
            if cell not in cell_names:
                errs.append(f"{m.get('name')}: unknown workload {cell!r}")
    for what, entries in (("config", configs), ("workload", cells),
                          ("metric", e2e + layer)):
        names = [e.get("name") for e in entries if isinstance(e, dict)]
        if len(names) != len(set(names)):
            errs.append(f"two {what}s share a name")
    if len(json.dumps(bench).encode()) > 64 << 10:
        errs.append("BENCHMARK.json is over 64 KiB")
    return errs


def load(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` of ``root``, checked against the rules."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) > 64 << 10:
        raise ValueError("BENCHMARK.json is over 64 KiB")
    bench = json.loads(raw)
    errs = problems(bench)
    if errs:
        raise ValueError("BENCHMARK.json: " + "; ".join(errs))
    return bench


@dataclasses.dataclass
class Cell:
    """One workload with its configuration, traffic and metrics."""

    name: str
    chips: int
    config: dict          # the configuration's file, with its name
    traffic: dict         # the mix's file, with its name
    end_to_end: list      # the metric entries this cell reports
    per_layer: list
    entry: str = DEFAULT_ENTRY    # port_bench/entries/<entry>.py


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The workload ``name`` of ``bench`` with its files read."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"one of {sorted(by_name)}")
    w = by_name[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(_read_json(os.path.join(root, entry["file"])),
                  name=w["config"])
    traffic = dict(_read_json(os.path.join(
        root, SUBDIR, "traffic", w["traffic"] + ".json")), name=w["traffic"])
    entry_name = config.get("entry", DEFAULT_ENTRY)
    _entry_path(entry_name, root)
    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                entry_name)


def _entry_path(name, root: str) -> str:
    path = os.path.join(root, SUBDIR, "entries", f"{name}.py")
    if not isinstance(name, str) or not ENTRY.match(name) \
            or not os.path.exists(path):
        raise KeyError(f"entry {name!r}: no module "
                       f"{SUBDIR}/entries/<entry>.py of that name")
    return path


def entry(name: str, root: str = ROOT):
    """The module ``port_bench/entries/<name>.py`` of ``root``, imported
    once a process as ``port_bench.entries.<name>``."""
    path = _entry_path(name, root)
    mod_name = f"{SUBDIR}.entries.{name}"
    mod = sys.modules.get(mod_name)
    if mod is not None and os.path.samefile(mod.__file__, path):
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The ``read(run)`` function of ``port_bench/metrics/<metric>.py``, or,
    where there is none, that of the name before the metric's last dot."""
    folder = os.path.join(root, SUBDIR, "metrics")
    name = metric
    while not os.path.exists(os.path.join(folder, name + ".py")) \
            and "." in name:
        name = name.rsplit(".", 1)[0]
    path = os.path.join(folder, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(os.path.join(folder, metric + ".py"))
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
