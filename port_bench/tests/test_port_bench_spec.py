"""BENCHMARK.json's rules, and cells found by name from files alone."""

import copy
import json
import shutil

import pytest

from port_bench import spec


def bench():
    return spec.load()


def test_the_benchmark_keeps_its_rules():
    b = bench()
    assert spec.problems(b) == []
    p6, p0 = "xz_T0_preset6.bulk", "xz_T0_preset0.bulk"
    xzfile = "xz_T0_preset0.xzfile"
    assert {w["name"] for w in b["workloads"]} == {p6, p0, xzfile}
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert len(b["configs"]) == 3
    moves = {p6: "decode_mb_s", p0: "decode_mb_s.host_paced",
             xzfile: "decode_mb_s.host_paced"}
    bulk = ["plan_ms", "pack_h2d_ms", "k1_ms", "k1_roofline",
            "after_k1_ms", "device_idle_pct", "d2h_ms", "join_ms",
            "k1_ns_per_bit_call"]
    layers = {p6: bulk, p0: [m + ".host_paced" for m in bulk],
              xzfile: ["plan_ms.host_paced", "k1_ms.host_paced",
                       "k1_roofline.host_paced",
                       "device_idle_pct.host_paced",
                       "k1_ns_per_bit_call.host_paced", "check_ms",
                       "container_ms", "k1_launches_per_call"]}
    entries = {p6: "lzma2_stream", p0: "lzma2_stream", xzfile: "xz_file"}
    for name, rate in moves.items():
        cell = spec.cell(b, name)
        assert cell.entry == entries[name]
        assert [m["name"] for m in cell.end_to_end] == [rate, "setup_s"]
        assert [m["name"] for m in cell.per_layer] == layers[name]
        assert all(m["moves"] == rate for m in cell.per_layer)
    for m in b["per_layer"]:
        if m["name"] in ("check_ms", "container_ms", "k1_launches_per_call"):
            assert m["workloads"] == [xzfile]


def test_every_name_has_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = spec.cell(b, w["name"])
        assert cell.config["block_size"] > 0 and cell.traffic["kind"]
        for c in b["configs"]:
            if c["name"] == w["config"]:
                assert set(c["reduced"]) <= set(cell.config)
                assert c["source"] == cell.config["source"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("path,value", [
    (("workloads", 0, "name"), "has space"),
    (("workloads", 0, "name"), "a/b"),
    (("workloads", 0, "name"), "x" * 65),
    (("workloads", 0, "traffic"), "-lead"),
    (("configs", 0, "reduced"), ["ok", "not,ok"]),
    (("end_to_end", 0, "unit"), "MB per s"),
    (("end_to_end", 0, "unit"), "µs"),
    (("end_to_end", 0, "unit"), "x" * 17),
    (("end_to_end", 0, "better"), "more"),
    (("end_to_end", 0, "bound"), 0.3),
    (("end_to_end", 0, "bound"), 0.005),
    (("end_to_end", 0, "source"), "program_span"),
    (("per_layer", 0, "layer"), "two\nlines"),
    (("per_layer", 0, "moves"), "nothing"),
    (("workloads", 0, "why"), "x" * 201),
    (("workloads", 0, "chips"), 2),
    (("run_seconds",), 52),
    (("paths", 0), "../out"),
    (("paths", 0), "/abs"),
])
def test_a_broken_rule_is_found(path, value):
    b = copy.deepcopy(bench())
    node = b
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    assert spec.problems(b)


def test_extra_keys_and_repeats_are_found():
    b = copy.deepcopy(bench())
    b["per_layer"][0]["why"] = "no such key"
    assert spec.problems(b)
    b = copy.deepcopy(bench())
    b["workloads"].append(dict(b["workloads"][0], name="again"))
    assert spec.problems(b)
    b = copy.deepcopy(bench())
    b["end_to_end"] = [m for m in b["end_to_end"] if m["name"] != "setup_s"]
    assert spec.problems(b)


def test_an_unknown_entry_point_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / spec.SUBDIR,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = bench()
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    path = root / "port_bench" / "configs" / "xz_T0_preset0_file.json"
    for name in ("no_such_entry", "../bench", "xz.file", 3):
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        entry=name)))
        with pytest.raises(KeyError):
            spec.cell(b, "xz_T0_preset0.xzfile", str(root))
    with pytest.raises(KeyError):
        spec.entry("no_such_entry")


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later cell, configuration, mix, metric and entry point: new files
    and new entries, no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / spec.SUBDIR,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = copy.deepcopy(bench())
    sub = root / spec.SUBDIR
    cfg = json.loads((sub / "configs" / "xz_T0_preset0.json").read_text())
    (sub / "configs" / "xz_T0_preset3.json").write_text(json.dumps(
        dict(cfg, preset=3, dict_size=4 << 20, block_size=12 << 20,
             entry="later_entry")))
    (sub / "entries" / "later_entry.py").write_text(
        "CALL = 'later'\n")
    mix = json.loads((sub / "traffic" / "silesia_tar.json").read_text())
    (sub / "traffic" / "enwik8.json").write_text(json.dumps(
        dict(mix, file_bytes=100_000_000)))
    (sub / "metrics" / "calls_n.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    b["configs"].append({"name": "xz_T0_preset3", "source": cfg["source"],
                         "file": "port_bench/configs/xz_T0_preset3.json",
                         "reduced": cfg["reduced"], "why": "a later one"})
    b["workloads"].append({"name": "xz_T0_preset3.bulk",
                           "config": "xz_T0_preset3",
                           "traffic": "enwik8", "chips": 1,
                           "why": "a later one"})
    b["per_layer"].append({"name": "calls_n", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "harness", "moves": "decode_mb_s",
                           "workloads": ["xz_T0_preset3.bulk"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    loaded = spec.load(str(root))
    cell = spec.cell(loaded, "xz_T0_preset3.bulk", str(root))
    assert cell.config["preset"] == 3 and cell.config["name"] == \
        "xz_T0_preset3"
    assert cell.entry == "later_entry"
    assert spec.entry(cell.entry, str(root)).CALL == "later"
    assert cell.traffic["file_bytes"] == 100_000_000
    assert [m["name"] for m in cell.per_layer][-1] == "calls_n"
    assert "calls_n" not in [m["name"] for m in spec.cell(
        loaded, "xz_T0_preset0.bulk", str(root)).per_layer]

    class R:
        calls = [1, 2, 3]
    assert spec.reader("calls_n", str(root))(R) == 3.0
    # a split name without a file of its own is read by its base's file;
    # one with a file of its own by that file
    assert spec.reader("calls_n.host_paced", str(root))(R) == 3.0
    (sub / "metrics" / "calls_n.host_paced.py").write_text(
        "def read(run):\n    return -1.0\n")
    assert spec.reader("calls_n.host_paced", str(root))(R) == -1.0
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.host_paced", str(root))
