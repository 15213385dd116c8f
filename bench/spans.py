"""Reductions of the traced run's program spans for the metric readers.

Each gives ``None`` where no traced request holds the span or attribute it
reads (a program from before they were recorded), so the reader's metric is
left out of the result line rather than read as 0.
"""

from __future__ import annotations


def traces(run) -> list:
    """The span trees of the run's traced requests."""
    return [r["trace"] for r in run.requests if r.get("trace")]


def mean_seconds(run, *names: str) -> float | None:
    """Per traced mine, the seconds of the spans called one of ``names``,
    averaged over the window."""
    ts = traces(run)
    spans = [s for t in ts for s in t.spans if s.name in names]
    return sum(s.duration for s in spans) / len(ts) if spans else None


def attr_values(run, name: str, attr: str) -> list:
    """Attribute ``attr`` of every span called ``name`` that carries it."""
    return [s.attrs[attr] for t in traces(run) for s in t.spans if s.name == name and attr in s.attrs]
