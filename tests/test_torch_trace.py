"""Spans and counters of the port's trace (``utils/trace.py``), the decode
path's spans and counters, and the benchmark readers that use them.

No JAX here: the card's test holds the CUDA path to the same tree."""

from __future__ import annotations

import contextlib
import json
import lzma
import threading

import pytest
import torch

from lzma_sdk_zliblike_tpu_torch import api
from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing as F
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
from lzma_sdk_zliblike_tpu_torch.parallel.scheduler import BatchedLzma2Decoder
from lzma_sdk_zliblike_tpu_torch.utils import memory as M
from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE, Span, Tracer

# A device call's children of the root, in order (one batch).
DECODE_STEPS = ["framing.scan", "framing.split_groups",
                "memory.shape_for_groups", "scheduler.route",
                "scheduler.assemble", "group_decode.h2d",
                "group_decode.launch", "group_decode.wait",
                "group_decode.d2h", "scheduler.outputs", "api.join"]


def _stream(n_groups=2, size=1500):
    """Raw LZMA2 of ``n_groups`` liblzma blocks, each its own dict-reset
    group, and the original bytes."""
    f = [{"id": lzma.FILTER_LZMA2, "preset": 0, "dict_size": 1 << 16}]
    parts = [(b"span %d " % i) * (size // 8) + bytes(range(i, 200))
             for i in range(n_groups)]
    blocks = [lzma.compress(p, format=lzma.FORMAT_RAW, filters=f)[:-1]
              for p in parts]
    return b"".join(blocks) + b"\x00", b"".join(parts)


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.start_ns)


# -- the tracer ---------------------------------------------------------------

def test_spans_nest_with_parents_and_call_ids():
    t = Tracer()
    with t.capture() as cap:
        with t.span("a", call=True):
            with t.span("a.b"):
                with t.span("a.b.c"):
                    pass
            with t.span("a.d"):
                pass
        with t.span("free"):
            pass
        with t.span("e", call=True):
            with t.span("e.f"):
                pass
    spans = {s.name: s for s in cap.take()}
    assert cap.take() == [] and cap.dropped == 0
    a, e = spans["a"], spans["e"]
    assert a.parent is None and e.parent is None and a.call != e.call
    assert spans["a.b"].parent == a.id and spans["a.d"].parent == a.id
    assert spans["a.b.c"].parent == spans["a.b"].id
    assert {spans[n].call for n in ("a.b", "a.b.c", "a.d")} == {a.call}
    assert spans["e.f"].call == e.call and spans["e.f"].parent == e.id
    assert spans["free"].parent is None and spans["free"].call is None
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    for child, parent in (("a.b", "a"), ("a.b.c", "a.b"), ("a.d", "a")):
        assert spans[parent].start_ns <= spans[child].start_ns
        assert spans[child].end_ns <= spans[parent].end_ns
    assert spans["a.b"].end_ns <= spans["a.d"].start_ns


def test_spans_of_two_threads_keep_their_own_parents_and_calls():
    t = Tracer()
    both = threading.Barrier(2, timeout=10)
    roots = {}

    def work(tag):
        with t.span(f"{tag}.root", call=True):
            both.wait()
            for i in range(50):
                with t.span(f"{tag}.step"):
                    with t.span(f"{tag}.inner"):
                        pass
            both.wait()
    with t.capture() as cap:
        threads = [threading.Thread(target=work, args=(tag,))
                   for tag in ("x", "y")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    spans = cap.take()
    assert len(spans) == 2 + 2 * 100
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.endswith(".root"):
            roots[s.name[0]] = s
    assert roots["x"].call != roots["y"].call
    for s in spans:
        tag = s.name[0]
        assert s.call == roots[tag].call
        if s.name.endswith(".step"):
            assert s.parent == roots[tag].id
        elif s.name.endswith(".inner"):
            assert by_id[s.parent].name == f"{tag}.step"


def test_spans_off_keep_nothing_and_enter_no_profiler_range(monkeypatch):
    entered = []

    @contextlib.contextmanager
    def counting(name):
        entered.append(name)
        yield
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    t = Tracer()
    assert not t.on
    with t.span("off", call=True):
        with t.span("off.child"):
            pass
    assert entered == []
    assert t.snapshot()["off"]["count"] == 1
    with t.capture() as cap:
        assert t.on
        with t.span("on", call=True):
            with t.span("on.child"):
                pass
    assert not t.on
    assert entered == ["on", "on.child"]
    assert [s.name for s in cap.take()] == ["on.child", "on"]
    with t.span("off"):       # the capture is over: nothing more is kept
        pass
    assert cap.take() == [] and entered == ["on", "on.child"]


def test_the_aggregate_is_the_timers_of_old():
    """``timer`` is ``span``; count, total and largest seconds as before,
    kept whether spans are on or off, and ``record`` adds an interval
    measured elsewhere."""
    t = Tracer()
    assert Tracer.timer is Tracer.span
    with t.timer("op"):
        pass
    with t.capture():
        with t.span("op"):
            sum(range(20000))
    t.record("op", 2.5)
    t.add("n", 2)
    t.peak("top", 3)
    t.peak("top", 1)
    snap = t.snapshot()
    assert snap["n"] == 2 and snap["top"] == 3
    op = snap["op"]
    assert set(op) == {"count", "total_s", "max_s"}
    assert op["count"] == 3 and op["max_s"] == 2.5
    assert 2.5 < op["total_s"] < 3.0
    t.reset()
    assert t.snapshot() == {}


def test_a_span_that_raises_is_kept_and_the_stack_unwinds():
    t = Tracer()
    with t.capture() as cap:
        with pytest.raises(ValueError):
            with t.span("root", call=True):
                with t.span("bad"):
                    raise ValueError("x")
        with t.span("after"):
            pass
    spans = {s.name: s for s in cap.take()}
    assert spans["bad"].parent == spans["root"].id
    assert spans["after"].parent is None and spans["after"].call is None
    assert t.snapshot()["bad"]["count"] == 1


def test_a_capture_is_bounded_and_alone():
    t = Tracer()
    with t.capture(limit=3) as cap:
        for _ in range(5):
            with t.span("s"):
                pass
        with pytest.raises(RuntimeError):
            with t.capture():
                pass
        assert len(cap.take()) == 3 and cap.dropped == 2
        with t.span("s"):       # room again once taken
            pass
    assert len(cap.take()) == 1
    assert t.snapshot()["s"]["count"] == 6


def test_spans_are_profiler_ranges_nested_the_same_way(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    t = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.capture() as cap:
            with t.span("p.root", call=True):
                with t.span("p.child"):
                    with t.span("p.grandchild"):
                        sum(range(1000))
                with t.span("p.second"):
                    pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") == "user_annotation"}
    spans = {s.name: s for s in cap.take()}
    assert set(spans) <= set(ranges)
    for s in spans.values():
        if s.parent is None:
            continue
        parent = next(p for p in spans.values() if p.id == s.parent)
        (a, b), (pa, pb) = ranges[s.name], ranges[parent.name]
        assert pa <= a and b <= pb, (s.name, parent.name)
    assert ranges["p.child"][1] <= ranges["p.second"][0]


def test_spans_are_on_while_a_profiler_session_is(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    t = Tracer()
    assert not t.on and t.profiled is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert t.on
        with t.span("s.root", call=True):
            with t.span("s.child"):
                sum(range(1000))
        with t.capture() as cap:        # a capture inside takes its spans
            with t.span("s.captured"):
                pass
    assert not t.on
    with t.span("s.after"):             # the session is over
        pass
    assert [s.name for s in cap.take()] == ["s.captured"]
    kept = t.profiled.take()
    assert [s.name for s in kept] == ["s.child", "s.root"]
    child, root = kept
    assert child.parent == root.id and child.call == root.call is not None
    assert t.profiled.take() == []
    names = {e.name for e in prof.events()}
    assert {"s.root", "s.child", "s.captured"} <= names
    assert "s.after" not in names
    assert t.snapshot()["s.after"]["count"] == 1


# -- the decode path ----------------------------------------------------------

def _traced_call(stream, **kw):
    TRACE.reset()
    with TRACE.capture() as cap:
        out = api.lzma2_uncompress(stream, 16, **kw)
    return out, cap.take(), TRACE.snapshot()


def _check_tree(spans):
    """The device engine's tree: one root, the steps in order inside it,
    all of one call; the root's self time is what its children leave."""
    roots = [s for s in spans if s.name == "api.lzma2_uncompress"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.call is not None
    kids = _children(spans, root)
    assert [s.name for s in kids] == DECODE_STEPS
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert root.start_ns <= kids[0].start_ns
    assert kids[-1].end_ns <= root.end_ns
    shape = next(s for s in kids if s.name == "memory.shape_for_groups")
    assert [s.name for s in _children(spans, shape)] == \
        ["memory.device_budget"]
    assert {s.call for s in spans} == {root.call}
    own = (root.end_ns - root.start_ns) - sum(s.end_ns - s.start_ns
                                             for s in kids)
    assert 0 <= own < root.end_ns - root.start_ns
    return root


def test_a_traced_device_call_has_the_decode_tree():
    stream, data = _stream()
    out, spans, snap = _traced_call(stream, device="cpu")
    assert out == data
    _check_tree(spans)
    assert snap["group_decode.lanes"] == 2
    assert snap["group_decode.chain_bit_calls"] > 0
    assert snap["group_decode.kernel_ms"] > 0
    assert snap["api.lzma2_uncompress"]["count"] == 1


def test_host_engine_calls_open_the_root_alone():
    stream, data = _stream()
    out, spans, _ = _traced_call(stream, engine="host", threads=1)
    assert out == data
    assert [s.name for s in spans] == ["api.lzma2_uncompress"]


def test_untraced_calls_keep_the_aggregates_and_no_kernel_time():
    stream, data = _stream()
    TRACE.reset()
    assert api.lzma2_uncompress(stream, 16, device="cpu") == data
    snap = TRACE.snapshot()
    assert {n for n in DECODE_STEPS} <= set(snap)
    assert "group_decode.kernel_ms" not in snap
    assert snap["group_decode.lanes"] == 2


def test_counters_read_the_batch_status():
    """``finalize_chunks`` gives the plain version's out, ok and consumed,
    counts the active lanes, and adds the longest lane's bit calls."""
    stream, _ = _stream(n_groups=3)
    groups = F.split_groups(F.scan(stream)[0])
    dec = BatchedLzma2Decoder(M.shape_for_groups(groups, device="cpu"),
                              device="cpu")
    arrays = dec._assemble(stream, [[g] for g in groups] + [[]], 1)
    tensors = G.prep_groups(*arrays, device="cpu")
    dic_cap = dec.shape.dic_cap
    out, ok, consumed, _iters, bits = G.group_decode_plain(*tensors, dic_cap)
    TRACE.reset()
    h = G.submit_groups(*tensors, dic_cap=dic_cap)
    G.wait_batch(h)
    h_out, h_ok, h_consumed = G.finalize_chunks(h, dic_cap=dic_cap)
    assert torch.equal(h_out, out) and torch.equal(h_consumed, consumed)
    assert torch.equal(h_ok, ok != 0) and bool(h_ok.all())
    snap = TRACE.snapshot()
    assert snap["group_decode.lanes"] == 3
    assert snap["group_decode.chain_bit_calls"] == int(bits.max()) > 0
    assert "group_decode.kernel_ms" not in snap


# -- the benchmark's readers ---------------------------------------------------

def _run(program=None):
    """A run whose program window is ``program`` (None: an untraced run)."""
    from port_bench.bench import Run
    run = Run(setup_s=1.0, window_s=1.0, calls=[])
    run.program = program
    return run


def _window(spans=(), counters=None):
    from port_bench.program_spans import Window
    return Window(list(spans), dict(counters or {}), 0)


def _span(sid, name, start, end, parent, call):
    return Span(sid, name, start * 10**6, end * 10**6, parent, call)


def test_readers_of_the_program_spans():
    from port_bench import program_spans, spec
    spans = [_span(1, "api.lzma2_uncompress", 0, 20, None, 1),
             _span(2, "group_decode.d2h", 1, 3, 1, 1),
             _span(3, "scheduler.outputs", 3, 6, 1, 1),
             _span(4, "api.join", 6, 7, 1, 1),
             _span(5, "api.lzma2_uncompress", 30, 50, None, 2),
             _span(6, "group_decode.d2h", 31, 35, 5, 2),
             _span(7, "group_decode.d2h", 60, 99, None, None)]   # no call
    counters = {"group_decode.kernel_ms": 10.0,
                "group_decode.chain_bit_calls": 1000}
    run = _run(_window(spans, counters))
    for name in ("d2h_ms", "d2h_ms.host_paced"):
        assert spec.reader(name)(run) == pytest.approx(3.0)
    assert spec.reader("join_ms")(run) == pytest.approx(2.0)
    assert spec.reader("k1_ns_per_bit_call")(run) == pytest.approx(1e4)
    table = program_spans.table(spans)
    assert table["api.lzma2_uncompress"]["self_ms"] == pytest.approx(30.0)
    assert table["group_decode.d2h"]["count"] == 3
    line = program_spans.summary_line(_window(spans, counters))
    tree = json.loads(line.split(" ", 2)[2])["slowest_call"]
    assert tree[0] == "api.lzma2_uncompress" and len(tree[3]) == 3


def test_each_cell_reports_the_program_metrics():
    """The three metrics and their ``.host_paced`` twins: one cell each,
    moving that cell's rate, each with a reader, after every metric the
    benchmark had."""
    from port_bench import spec
    bench = spec.load()
    assert spec.problems(bench) == []
    sources = {"d2h_ms": "program_span", "join_ms": "program_span",
               "k1_ns_per_bit_call": "program_counter"}
    for cell, rate in (("xz_T0_preset6.bulk", "decode_mb_s"),
                       ("xz_T0_preset0.bulk", "decode_mb_s.host_paced")):
        suffix = rate[len("decode_mb_s"):]
        layer = spec.cell(bench, cell).per_layer
        assert [m["name"] for m in layer[-3:]] == \
            [name + suffix for name in sources]
        for m, (name, source) in zip(layer[-3:], sources.items()):
            assert (m["source"], m["moves"], m["better"]) == \
                (source, rate, "lower")
            assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", ["d2h_ms", "join_ms", "k1_ns_per_bit_call"])
def test_readers_find_nothing_to_read(name):
    from port_bench import spec
    read = spec.reader(name)
    assert read(_run()) is None                      # an untraced run
    assert read(_run(_window())) is None             # no call in the window
    only_root = [_span(1, "api.lzma2_uncompress", 0, 5, None, 1)]
    assert read(_run(_window(only_root))) is None    # no such span
    zero = {"group_decode.kernel_ms": 0.0,
            "group_decode.chain_bit_calls": 0}
    assert read(_run(_window(only_root, zero))) is None


def test_readers_take_the_window_from_a_profiled_call(capsys):
    """A traced run as the benchmark makes one: the port's calls under a
    profiler session, read by the new readers from the port alone."""
    from torch.profiler import ProfilerActivity, profile
    from port_bench import spec
    from port_bench.bench import Run
    stream, data = _stream()
    if TRACE.profiled is not None:
        TRACE.profiled.take()
    TRACE.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert api.lzma2_uncompress(stream, 16, device="cpu") == data
    run = Run(setup_s=1.0, window_s=1.0, calls=[])
    d2h = spec.reader("d2h_ms")(run)
    _check_tree(run.program.spans)
    root = next(s for s in run.program.spans
                if s.name == "api.lzma2_uncompress")
    assert 0 < d2h < (root.end_ns - root.start_ns) * 1e-6
    assert spec.reader("join_ms.host_paced")(run) > 0
    assert spec.reader("k1_ns_per_bit_call")(run) > 0
    assert run.program.counters["group_decode.lanes"] == 2
    assert TRACE.profiled.take() == []              # taken once, kept on run
    assert spec.reader("d2h_ms")(run) == d2h
    err = capsys.readouterr().err.splitlines()
    line = [e for e in err if e.startswith("program spans ")]
    assert len(line) == 1 and json.loads(line[0][14:])["calls"] == 1


def test_readers_of_a_port_without_spans_read_nothing(monkeypatch):
    """The parent port's tracer has no ``profiled``: the readers give None
    and raise nothing."""
    from lzma_sdk_zliblike_tpu_torch.utils import trace
    from port_bench import spec
    from port_bench.bench import Run

    class Older:
        def snapshot(self):
            return {"group_decode.kernel_ms": 1.0}
    monkeypatch.setattr(trace, "TRACE", Older())
    run = Run(setup_s=1.0, window_s=1.0, calls=[])
    for name in ("d2h_ms", "join_ms", "k1_ns_per_bit_call"):
        assert spec.reader(name)(run) is None
    assert run.program is None


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_a_traced_call_on_the_card_has_the_tree_and_k1_time():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    stream, data = _stream(n_groups=3)
    out, spans, snap = _traced_call(stream, device="cuda")
    assert out == data
    _check_tree(spans)
    assert snap["group_decode.lanes"] == 3
    assert snap["group_decode.kernel_ms"] > 0
    cpu_bits = _traced_call(stream, device="cpu")[2]
    assert snap["group_decode.chain_bit_calls"] == \
        cpu_bits["group_decode.chain_bit_calls"]
    TRACE.reset()
    assert api.lzma2_uncompress(stream, 16, device="cuda") == data
    assert "group_decode.kernel_ms" not in TRACE.snapshot()
