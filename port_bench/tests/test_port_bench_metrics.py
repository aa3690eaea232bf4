"""The metric arithmetic: readers over a run, and the device trace."""

import pytest

from port_bench import bench, hw, profiling, spans, spec


class Marks:
    """Stands in for a pair of CUDA events ``ms`` apart."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return self.ms


def call_spans(plan, pack, k1_ms, after):
    s = spans.CallSpans(plan_s=plan, plan_end=10.0, first_launch=10.0 + pack,
                        launches=1, k1_end=20.0, returned=20.0 + after)
    s.k1_marks.append((Marks(k1_ms), None))
    return s


def make_run(traced=True):
    calls = [bench.Call(0, 100_000_000, 30_000_000, 100_000_000, 0.5),
             bench.Call(1, 100_000_000, 30_000_000, 100_000_000, 0.5),
             bench.Call(0, 0, 30_000_000, 100_000_000, 0.1, "DataError")]
    sp = [call_spans(0.001, 0.02, 300.0, 0.1),
          call_spans(0.003, 0.04, 100.0, 0.3),
          call_spans(0.002, 0.03, 200.0, 0.2)] if traced else None
    return bench.Run(setup_s=7.5, window_s=2.0, calls=calls, spans=sp)


def read(name, run):
    return spec.reader(name)(run)


def test_rate_is_every_completed_byte_over_the_whole_window():
    run = make_run(False)
    assert read("decode_mb_s", run) == pytest.approx(200e6 / 2.0 / 1e6)
    assert read("setup_s", run) == 7.5


def test_layer_times_are_means_per_call():
    run = make_run()
    assert read("plan_ms", run) == pytest.approx(2.0)
    assert read("pack_h2d_ms", run) == pytest.approx(30.0)
    assert read("k1_ms", run) == pytest.approx(200.0)
    assert read("after_k1_ms", run) == pytest.approx(200.0)


def test_roofline_is_the_bytes_bound_over_k1_time():
    run = make_run()
    bound = 2 * (30e6 + 100e6) / hw.HBM_BYTES_PER_S
    assert read("k1_roofline", run) == pytest.approx(100 * bound / 0.6)
    assert hw.decode_bytes_bound_s(3_350_000, 0) == pytest.approx(1e-6)


def test_idle_is_the_trace_window_where_no_operation_ran():
    run = make_run()
    assert read("device_idle_pct", run) is None       # no trace read
    run.profile = {"busy_s": 0.5, "window_s": 2.0}
    assert read("device_idle_pct", run) == pytest.approx(75.0)


def test_untraced_runs_have_no_layer_metrics():
    run = make_run(False)
    for m in ("plan_ms", "pack_h2d_ms", "k1_ms", "k1_roofline",
              "after_k1_ms", "device_idle_pct", "check_ms", "container_ms",
              "k1_launches_per_call"):
        assert read(m, run) is None


def test_an_xz_call_is_split_into_blocks_checks_and_container():
    """Per call: the blocks' ``lzma2_uncompress`` (``inner``), the checks,
    and the rest of the call's time; launches summed over its blocks."""
    run = make_run()
    for s, inner, check, launches in zip(run.spans, (0.3, 0.4, 0.05),
                                         (0.1, 0.05, 0.0), (203, 203, 2)):
        s.timed.update(inner=inner, check=check)
        s.launches = launches
    assert read("check_ms", run) == pytest.approx(50.0)
    # calls of 0.5, 0.5 and 0.1 s
    assert read("container_ms", run) == pytest.approx(
        (0.1 + 0.05 + 0.05) / 3 * 1e3)
    assert read("k1_launches_per_call", run) == pytest.approx(136.0)


@pytest.mark.parametrize("name", [
    "decode_mb_s", "plan_ms", "pack_h2d_ms", "k1_ms", "k1_roofline",
    "after_k1_ms", "device_idle_pct"])
def test_host_paced_metrics_read_the_same(name):
    run = make_run()
    assert read(name + ".host_paced", run) == read(name, run)


def test_no_k1_time_gives_no_roofline():
    run = make_run()
    for s in run.spans:
        s.k1_marks.clear()
    assert read("k1_roofline", run) is None


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        ev("user_annotation", "window", 100.0, 1000.0),
        ev("kernel", "spin_kernel", 10.0, 5.0),              # before
        ev("user_annotation", "call.lzma2_uncompress", 100.0, 900.0),
        ev("user_annotation", "plan.scan", 100.0, 80.0),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200.0, 50.0),
        ev("kernel", "void lzt::group_decode_kernel<3>(int*)", 240.0,
           400.0),
        ev("user_annotation", "after_k1.finalize_chunks", 640.0, 200.0),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 650.0, 100.0),
    ]
    r = profiling.reduce(events, k1_launches=1)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((640 - 200 + 100) * 1e-6)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["group_decode_kernel"] == pytest.approx(400e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # idle: 100-200 (scan to 180), 640-650, 750-1100 (finalize to 840,
    # the call to 1000, then the harness)
    assert gaps == pytest.approx({"plan.scan": 80e-6,
                                  "call.lzma2_uncompress": 180e-6,
                                  "after_k1.finalize_chunks": 100e-6,
                                  "harness": 100e-6})


def test_a_k1_launch_without_an_event_is_named_and_counted_busy():
    events = [ev("user_annotation", "window", 0.0, 100.0),
              ev("kernel", "group_decode_kernel", 10.0, 20.0),
              ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 40.0,
                 10.0)]
    r = profiling.reduce(events, k1_launches=3, k1_event_s=60e-6)
    ops = dict(r["breakdown"]["device_ops"])
    assert "group_decode_kernel (2 of 3 launches without a profiler " \
           "event)" in ops
    # the events' 60 us of K1 hold 40 us the profiler lost
    assert r["busy_s"] == pytest.approx((20 + 10 + 40) * 1e-6)
    # with every launch found, the events add nothing
    r = profiling.reduce(events, k1_launches=1, k1_event_s=60e-6)
    assert r["busy_s"] == pytest.approx(30e-6)
