"""The device-trace reductions and count_roofline's work, worked by hand."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench.trace import DeviceTrace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
HW = {"hbm_bytes_per_s": 1000.0, "lop3_per_s": 60.0}


def _reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (k, candidates, support_pruned, bound_pruned, intersections, emitted, skipped, stored, level_bytes)
STATS = [
    (1, 0, 0, 0, 0, 2, 0, 5, 0),
    (2, 10, 0, 0, 10, 1, 2, 7, 0),
    (3, 9, 3, 2, 4, 1, 0, 0, 0),
]
WORDS = 3


def test_count_roofline_work_by_hand():
    cr = _reader("count_roofline")
    # level 2: parents 5 rows x 3 words + their 5 supports, 10 pairs x 16 B,
    # 7 children x 3 words: 4*(15+5) + 160 + 84 = 324 B -> 0.324 s; logic
    # 3*10*3 = 90 -> 1.5 s; the larger is 1.5 s.
    # level 3: parents 7 x 3 + 7 supports: 4*(21+7) = 112, 4 pairs 64 B, no
    # children: 176 B -> 0.176 s; logic 3*4*3 = 36 -> 0.6 s.
    assert cr.least_seconds(STATS, WORDS, HW) == pytest.approx(1.5 + 0.6)


def test_count_roofline_reads_matched_kernels_only():
    cr = _reader("count_roofline")
    dev = DeviceTrace(0, 10_000_000_000, [
        ("void intersect_indexed_kernel<false, true>(unsigned int const*)", 0, 2_000_000_000),
        ("void intersect_indexed_kernel<true, true>(unsigned int const*)", 3_000_000_000, 4_000_000_000),
        ("void at::native::elementwise_kernel<128, 2>", 5_000_000_000, 9_000_000_000),
    ])
    run = SimpleNamespace(device=dev, hw=HW, requests=[{"stats": STATS, "words": WORDS}] * 2)
    assert cr.read(run) == pytest.approx(100 * 2 * 2.1 / 3.0)
    assert cr.read(SimpleNamespace(device=None, hw=HW, requests=[])) is None
    none_matched = DeviceTrace(0, 10, [("fill", 0, 5)])
    assert cr.read(SimpleNamespace(device=none_matched, hw=HW, requests=[])) is None


def test_device_trace_busy_gaps_and_idle_share():
    dev = DeviceTrace(100, 1100, [("a", 100, 300), ("b", 250, 400), ("c", 600, 700), ("a", 900, 1000)])
    assert dev.busy_intervals() == [(100, 400), (600, 700), (900, 1000)]
    assert dev.busy_s == pytest.approx(500e-9)
    assert dev.idle_gaps() == [(400, 600), (700, 900), (1000, 1100)]
    assert dev.time_by_name() == pytest.approx({"a": 300e-9, "b": 150e-9, "c": 100e-9})
    idle = _reader("device_idle.mine")
    assert idle.read(SimpleNamespace(device=dev)) == pytest.approx(50.0)
    assert idle.read(SimpleNamespace(device=None)) is None
    assert idle.read(SimpleNamespace(device=DeviceTrace(0, 10, []))) is None


def test_host_clock_readers():
    reqs = [{"wall_s": w} for w in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0)]
    run = SimpleNamespace(requests=reqs, window_s=66.0, peak_bytes=2_500_000_000, setup_s=3.5)
    assert _reader("mine_s").read(run) == pytest.approx(6.0)
    assert _reader("mine_p90_s").read(run) == pytest.approx(10.0)
    assert _reader("mine_p90_s").read(SimpleNamespace(requests=reqs[:9])) is None
    assert _reader("peak_gb").read(run) == pytest.approx(2.5)
    assert _reader("setup_s").read(run) == 3.5


def test_idle_time_by_innermost_host_span(harness):
    from bench.trace import innermost_segments

    S = SimpleNamespace
    spans = [S(t0=0.0, t1=10.0, name="request"), S(t0=1.0, t1=6.0, name="mine"),
             S(t0=2.0, t1=3.0, name="a"), S(t0=3.0, t1=5.0, name="b"), S(t0=7.0, t1=8.0, name="c")]
    assert innermost_segments(spans) == [(0.0, 1.0, "request"), (1.0, 2.0, "mine"), (2.0, 3.0, "a"),
                                         (3.0, 5.0, "b"), (5.0, 6.0, "mine"), (6.0, 7.0, "request"),
                                         (7.0, 8.0, "c"), (8.0, 10.0, "request")]
    # host clock 100.0 is the window's start, device clock 0 ns; busy 2.5-4 s and 7-12 s
    dev = DeviceTrace(0, 13_000_000_000, [("k", 2_500_000_000, 4_000_000_000),
                                          ("k", 7_000_000_000, 12_000_000_000)])
    trace = S(spans=[S(t0=s.t0 + 100.0, t1=s.t1 + 100.0, name=s.name) for s in spans])
    run = S(device=dev, requests=[{"trace": trace, "t0": 100.0, "t1": 110.0}])
    out = harness._breakdown(run, 100.0)
    assert out["device_ops"] == [["k", pytest.approx(6.5)]]
    idle = dict(out["idle_gaps"])
    assert idle == pytest.approx({"request": 1.0 + 1.0, "mine": 1.0 + 1.0, "a": 0.5, "b": 1.0,
                                  "between requests": 1.0})
