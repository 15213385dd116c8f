"""The readers of the program's spans and dispatch attributes, on a
synthetic run worked by hand, and on a run whose program records none of
them (they then read nothing)."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace as S

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NEW = ("itemize_s", "preprocess_s", "fetch_s", "bounds_s", "dispatch_device_s", "pair_fill")


def _reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, duration, **attrs):
    return S(name=name, duration=duration, attrs=attrs)


# (k, candidates, support_pruned, bound_pruned, intersections, emitted, skipped, stored, level_bytes)
STATS = [(1, 0, 0, 0, 0, 2, 0, 5, 0), (2, 10, 0, 0, 10, 1, 2, 7, 0), (3, 900, 100, 500, 300, 1, 0, 0, 0)]


def _mine(scale):
    """One mine's spans: level 2 one padded batch of 10 pairs, level 3 two
    batches of 150 counted pairs behind the bound pruning."""
    return S(spans=[
        _span("request", 10.0 * scale), _span("itemize", 2.0 * scale), _span("preprocess", 1.0 * scale),
        _span("mine", 6.0 * scale), _span("level.index", 0.1 * scale), _span("level.index", 0.2 * scale),
        _span("intersect.dispatch", 0.01 * scale, pairs=10, launched=256, device_s=0.001 * scale),
        _span("frontier.candidates", 3.0 * scale, phase="bounds"),
        _span("frontier.fetch", 0.5 * scale, pairs=450), _span("frontier.bounds", 2.0 * scale, candidates=400, pruned=250),
        _span("intersect.dispatch", 0.02 * scale, pairs=150, launched=256, device_s=0.004 * scale),
        _span("frontier.candidates", 2.5 * scale, phase="bounds"),
        _span("frontier.fetch", 0.4 * scale, pairs=450), _span("frontier.bounds", 1.6 * scale, candidates=400, pruned=250),
        _span("intersect.dispatch", 0.02 * scale, pairs=150, launched=256, device_s=0.005 * scale),
    ])


def _run(traces):
    return S(requests=[{"stats": STATS, "trace": t} for t in traces] + [{"stats": STATS, "trace": None}])


def test_span_readers_by_hand():
    run = _run([_mine(1.0), _mine(2.0)])  # the untraced request is read by none
    got = {name: _reader(name).read(run) for name in NEW}
    assert got["itemize_s"] == pytest.approx((2.0 + 4.0) / 2)
    assert got["preprocess_s"] == pytest.approx((1.0 + 2.0) / 2)
    assert got["fetch_s"] == pytest.approx((0.9 + 1.8) / 2)
    assert got["bounds_s"] == pytest.approx((3.9 + 7.8) / 2)
    assert got["dispatch_device_s"] == pytest.approx((0.010 + 0.020) / 2)
    # two mines counted 10 + 300 pairs each, launched over 3 x 256
    assert got["pair_fill"] == pytest.approx(100.0 * (2 * 310) / (2 * 768))


def test_span_readers_read_nothing_where_the_program_records_nothing():
    """A program from before these spans (or an untraced run) leaves every
    new metric out of the line instead of reading 0."""
    older = S(spans=[_span("request", 10.0), _span("mine", 6.0), _span("frontier.candidates", 3.0),
                     _span("intersect.dispatch", 0.02, pairs=150)])
    for run in (_run([older]), _run([])):
        assert {name: _reader(name).read(run) for name in NEW} == dict.fromkeys(NEW)


def test_span_readers_on_a_traced_mine_of_the_program():
    """On the program's own spans (a CPU mine): the entry's two spans make up
    the request outside ``mine``, the fetch and bounds sit inside the
    candidates, and no dispatch carries device time off the card."""
    import numpy as np

    from repro_torch.core import KyivConfig, mine
    from repro_torch.obs.trace import TRACER

    table = np.random.default_rng(2).integers(0, 2, size=(100, 8))
    with TRACER.start("request"):
        res = mine(table, KyivConfig(tau=1, kmax=3, engine="torch", device="cpu"))
    trace = TRACER.last(1)[0]
    stats = [(s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections) for s in res.stats]
    run = S(requests=[{"stats": stats, "trace": trace, "wall_s": trace.root.duration}])
    got = {name: _reader(name).read(run) for name in NEW}
    outside = trace.root.duration - trace.find("mine")[0].duration
    assert got["itemize_s"] + got["preprocess_s"] <= outside
    cands = sum(s.duration for s in trace.find("frontier.candidates"))
    assert got["fetch_s"] + sum(s.duration for s in trace.find("frontier.bounds")) <= cands
    assert got["dispatch_device_s"] is None
    assert 0 < got["pair_fill"] <= 100
