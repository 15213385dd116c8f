"""What the traced run reads: the program's spans and the device's trace.

Spans: each request runs inside a ``repro_torch.obs.trace`` trace the
harness opens (root span ``request``); the program's own spans (``mine``,
``mine.level``, ``frontier.candidates``, ``intersect.dispatch``,
``intersect.sync``, ``level.classify``, ...) nest under it. Times are
``time.perf_counter`` seconds.

Device: ``torch.profiler`` with CUDA activity only, read from its Kineto
events (no Chrome trace is written). Kineto stamps events in nanoseconds of
the wall clock (``time.time_ns``); :class:`DeviceTrace` keeps the device
operations (kernels, copies, memsets) that overlap the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["DeviceTrace", "Profiler", "innermost_segments", "span_total"]


def span_total(trace, name: str) -> float:
    """Seconds of all spans called ``name`` in one request's trace."""
    return sum(s.duration for s in trace.spans if s.name == name)


def innermost_segments(spans) -> list[tuple[float, float, str]]:
    """A request's timeline cut where its innermost open span changes:
    ``(t0, t1, name)`` pieces, in order. Spans nest (a tree of intervals)."""
    out: list[tuple[float, float, str]] = []
    stack: list = []
    at = 0.0
    for s in sorted(spans, key=lambda s: (s.t0, -s.t1)):
        while stack and stack[-1].t1 <= s.t0:
            top = stack.pop()
            out.append((at, top.t1, top.name))
            at = top.t1
        if stack:
            out.append((at, s.t0, stack[-1].name))
        stack.append(s)
        at = s.t0
    while stack:
        top = stack.pop()
        out.append((at, top.t1, top.name))
        at = top.t1
    return [seg for seg in out if seg[1] > seg[0]]


@dataclass
class DeviceTrace:
    """Device operations of the window: ``(name, start_ns, end_ns)``,
    clipped to ``[t0_ns, t1_ns]`` on the wall clock."""

    t0_ns: int
    t1_ns: int
    ops: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the operations' intervals, in order."""
        merged: list[list[int]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        gaps, at = [], self.t0_ns
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1_ns > at:
            gaps.append((at, self.t1_ns))
        return gaps

    def time_by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out


class Profiler:
    """``torch.profiler`` over the window: CUDA activity only on a card (the
    CPU's activity elsewhere, where it yields no device operation)."""

    def __init__(self, on_card: bool = True):
        import torch

        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[act.CUDA if on_card else act.CPU])
        self._prof.__enter__()
        self.t0_ns = self.t1_ns = 0

    def open_window(self) -> None:
        self.t0_ns = time.time_ns()

    def close_window(self) -> None:
        self.t1_ns = time.time_ns()

    def stop(self) -> DeviceTrace:
        from torch.autograd import DeviceType

        self._prof.__exit__(None, None, None)
        trace = DeviceTrace(self.t0_ns, self.t1_ns)
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a, b = e.start_ns(), e.end_ns()
            if b > self.t0_ns and a < self.t1_ns:
                trace.ops.append((e.name(), max(a, self.t0_ns), min(b, self.t1_ns)))
        return trace
