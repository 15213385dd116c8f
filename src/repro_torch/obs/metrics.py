"""Process-wide metrics registry (stdlib only — this module is a leaf).

One :class:`MetricsRegistry` per process holds every metric family the
miner, the service layer and the HTTP endpoint record into: counters
(monotonic), gauges (set/add), and histograms over **fixed log-scale
buckets** (so per-stage level timings spanning microseconds to minutes land
in meaningful buckets without per-family tuning). The registry renders the
Prometheus text exposition format 0.0.4 for ``GET /metrics`` and a
JSON-friendly snapshot for the ``/stats`` fold-in.

Consistency: every mutation *and* every read (render / snapshot) takes the
one registry lock, and registered collectors — callbacks that mirror
component-local counters (result cache, scheduler, executable cache, …)
into registry values at scrape time — run under that same lock. A scrape
therefore never observes torn counters (a histogram whose bucket counts
disagree with its ``_count``, a cache hit without its request), no matter
how many mines/appends are in flight.

Import discipline: stdlib only, imported by ``repro_torch.core``, the
kernels packages and the service layer alike — it must never import
anything else of ``repro_torch`` (the reverse edges all exist).
"""

from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left
from typing import Callable, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "register_collector",
    "unregister_collector",
    "render",
    "snapshot",
    "lint_exposition",
    "TIME_BUCKETS",
    "COUNT_BUCKETS",
    "BYTE_BUCKETS",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Fixed log-scale bucket ladders. Timings: half-decade steps from 100 µs to
# 1000 s (mining levels run anywhere in that range depending on dataset and
# placement). Counts/bytes: decade steps.
TIME_BUCKETS: tuple[float, ...] = tuple(
    round(10.0 ** (e / 2.0), 10) for e in range(-8, 7)
)  # 1e-4 .. ~3.16e2, 15 buckets
COUNT_BUCKETS: tuple[float, ...] = tuple(float(10**e) for e in range(0, 9))
BYTE_BUCKETS: tuple[float, ...] = tuple(float(4**e) for e in range(5, 19))


def _fmt(v: float) -> str:
    """Prometheus sample value / ``le`` formatting (no trailing .0 noise)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Family:
    """Base: one metric family (name + type + help + label names)."""

    mtype = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: tuple[str, ...]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._values: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _label_str(self, key: tuple) -> str:
        if not self.labelnames:
            return ""
        pairs = ",".join(
            f'{ln}="{_escape_label(lv)}"' for ln, lv in zip(self.labelnames, key)
        )
        return "{" + pairs + "}"

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    # -- rendering -----------------------------------------------------------

    def _render_locked(self, out: list[str]) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.mtype}")
        for key in sorted(self._values):
            out.append(
                f"{self.name}{self._label_str(key)} {_fmt(self._values[key])}"
            )

    def _snapshot_locked(self) -> dict:
        return {
            "type": self.mtype,
            "values": {
                ",".join(k) if k else "": v for k, v in self._values.items()
            },
        }


class Counter(_Family):
    """Monotonic counter. ``inc`` for native event sites; ``set_total`` is
    reserved for registered collectors that mirror a component-local counter
    (the mirrored source is itself monotonic per component instance)."""

    mtype = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment must be >= 0")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class Gauge(_Family):
    mtype = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(_Family):
    """Histogram over fixed (log-scale by default) buckets.

    Per label set we keep ``[bucket_counts..., sum, count]``; all three
    update under the one registry lock, so a scrape's ``_bucket`` /
    ``_sum`` / ``_count`` samples are always mutually consistent.
    """

    mtype = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Iterable[float] | None = None):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(sorted(float(b) for b in (buckets or TIME_BUCKETS)))
        if not bs:
            raise ValueError(f"{self.name}: histogram needs at least one bucket")
        self.buckets = bs
        self._series: dict[tuple, list] = {}
        # per-(labelset, bucket) exemplar: (value, labels, unix_ts) — the
        # most recent observation that carried one (OpenMetrics keeps one
        # exemplar per bucket; newest-wins is the standard behaviour)
        self._exemplars: dict[tuple, dict[int, tuple]] = {}

    def observe(self, value: float, exemplar: dict | None = None, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = [0] * (len(self.buckets) + 1) + [0.0, 0]
            idx = bisect_left(self.buckets, value)
            series[idx] += 1
            series[-2] += float(value)
            series[-1] += 1
            if exemplar:
                self._exemplars.setdefault(key, {})[idx] = (
                    float(value),
                    {str(k): str(v) for k, v in exemplar.items()},
                    time.time(),
                )

    def series(self, **labels) -> dict:
        """JSON view: {"buckets": [(le, cumulative_count)...], "sum", "count"}."""
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return {"buckets": [], "sum": 0.0, "count": 0}
            acc, out = 0, []
            for le, c in zip(self.buckets + (math.inf,), series[:-2]):
                acc += c
                out.append((le, acc))
            return {"buckets": out, "sum": series[-2], "count": series[-1]}

    def _render_locked(self, out: list[str]) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.mtype}")
        for key in sorted(self._series):
            series = self._series[key]
            exemplars = self._exemplars.get(key, {})
            acc = 0
            for idx, (le, c) in enumerate(zip(self.buckets + (math.inf,), series[:-2])):
                acc += c
                lkey = key + (_fmt(le),)
                pairs = ",".join(
                    f'{ln}="{_escape_label(lv)}"'
                    for ln, lv in zip(self.labelnames + ("le",), lkey)
                )
                line = f"{self.name}_bucket{{{pairs}}} {acc}"
                ex = exemplars.get(idx)
                if ex is not None:
                    ev, elabels, ets = ex
                    epairs = ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in sorted(elabels.items())
                    )
                    line += f" # {{{epairs}}} {_fmt(ev)} {ets:.3f}"
                out.append(line)
            ls = self._label_str(key)
            out.append(f"{self.name}_sum{ls} {_fmt(series[-2])}")
            out.append(f"{self.name}_count{ls} {series[-1]}")

    def _snapshot_locked(self) -> dict:
        return {
            "type": self.mtype,
            "values": {
                ",".join(k) if k else "": {"sum": s[-2], "count": s[-1]}
                for k, s in self._series.items()
            },
        }


class MetricsRegistry:
    """All metric families + named collectors behind one lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}
        self._collectors: dict[str, Callable[[], None]] = {}
        self.collector_errors = 0

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with different "
                        f"type/labels"
                    )
                return fam
            fam = cls(self, name, help, tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str, labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str, labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str, labelnames: tuple[str, ...] = (),
        buckets: Iterable[float] | None = None,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def register_collector(self, name: str, fn: Callable[[], None]) -> None:
        """Run ``fn`` at every scrape, under the registry lock. Named so a
        replacement component (a new ``MiningService``) takes over its slot
        instead of stacking stale closures."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str, fn: Callable[[], None] | None = None) -> None:
        """Remove the named collector; with ``fn`` given, only when it is
        still the registered one (so a closed component can't evict its
        replacement's collector)."""
        with self._lock:
            if fn is None or self._collectors.get(name) is fn:
                self._collectors.pop(name, None)

    def _run_collectors_locked(self) -> None:
        for fn in list(self._collectors.values()):
            try:
                fn()
            except Exception:
                # a broken collector must never fail the scrape
                self.collector_errors += 1

    def render(self) -> str:
        """Prometheus text exposition 0.0.4 — one consistent pass."""
        with self._lock:
            self._run_collectors_locked()
            out: list[str] = []
            for name in sorted(self._families):
                self._families[name]._render_locked(out)
            out.append("")
            return "\n".join(out)

    def snapshot(self) -> dict:
        """JSON-friendly registry view (the ``/stats`` fold-in), taken under
        the same lock as ``render`` — never torn."""
        with self._lock:
            self._run_collectors_locked()
            return {
                name: fam._snapshot_locked()
                for name, fam in sorted(self._families.items())
            }

    def reset(self) -> None:
        """Drop every family and collector (test isolation only)."""
        with self._lock:
            self._families.clear()
            self._collectors.clear()
            self.collector_errors = 0


REGISTRY = MetricsRegistry()


def counter(name: str, help: str, labelnames: tuple[str, ...] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str, labelnames: tuple[str, ...] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(
    name: str, help: str, labelnames: tuple[str, ...] = (),
    buckets: Iterable[float] | None = None,
) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)


def register_collector(name: str, fn: Callable[[], None]) -> None:
    REGISTRY.register_collector(name, fn)


def unregister_collector(name: str, fn: Callable[[], None] | None = None) -> None:
    REGISTRY.unregister_collector(name, fn)


def render() -> str:
    return REGISTRY.render()


def snapshot() -> dict:
    return REGISTRY.snapshot()


# -- exposition linting (CI obs-smoke) ---------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?P<labels>\{[^}]*\})?\s+(?P<value>\S+?)"
    r"(\s+\d+)?"
    r"(?P<exemplar>\s+#\s+\{(?P<exlabels>[^}]*)\}\s+(?P<exvalue>\S+)(\s+\S+)?)?$"
)


def lint_exposition(text: str) -> list[str]:
    """Validate a Prometheus text exposition: metric/label naming, TYPE
    before samples, no duplicate families, counter ``_total`` suffix,
    histogram ``le`` ordering and ``_count`` agreement. Returns a list of
    problems (empty == clean)."""
    problems: list[str] = []
    typed: dict[str, str] = {}
    seen_order: list[str] = []
    hist_buckets: dict[tuple, list[float]] = {}
    hist_last: dict[tuple, float] = {}
    sample_counts: dict[str, int] = {}

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                problems.append(f"line {lineno}: malformed comment {line!r}")
                continue
            name = parts[2]
            if not _NAME_RE.match(name):
                problems.append(f"line {lineno}: bad metric name {name!r}")
            if line.startswith("# TYPE "):
                if name in typed:
                    problems.append(f"line {lineno}: duplicate family {name!r}")
                typed[name] = parts[3] if len(parts) > 3 else "untyped"
                seen_order.append(name)
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {lineno}: unparsable sample {line!r}")
            continue
        sname = m.group("name")
        base = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) and sname[: -len(suffix)] in typed:
                base = sname[: -len(suffix)]
                break
        if base not in typed:
            problems.append(f"line {lineno}: sample {sname!r} precedes its TYPE")
            continue
        if seen_order and seen_order[-1] != base and base in seen_order[:-1]:
            problems.append(
                f"line {lineno}: family {base!r} samples are not contiguous"
            )
        sample_counts[base] = sample_counts.get(base, 0) + 1
        mtype = typed[base]
        if mtype == "counter" and not base.endswith("_total"):
            problems.append(f"counter {base!r} does not end in _total")
        if m.group("exemplar"):
            # OpenMetrics: exemplars are only valid on histogram buckets
            if mtype != "histogram" or not sname.endswith("_bucket"):
                problems.append(
                    f"line {lineno}: exemplar on non-histogram-bucket sample "
                    f"{sname!r}"
                )
            for pair in filter(None, (m.group("exlabels") or "").split(",")):
                if "=" not in pair:
                    problems.append(f"line {lineno}: malformed exemplar label {pair!r}")
                    continue
                ename, evalue = pair.split("=", 1)
                if not _LABEL_RE.match(ename):
                    problems.append(f"line {lineno}: bad exemplar label name {ename!r}")
                if not (evalue.startswith('"') and evalue.endswith('"')):
                    problems.append(
                        f"line {lineno}: exemplar label value not quoted {evalue!r}"
                    )
            try:
                float(m.group("exvalue"))
            except (TypeError, ValueError):
                problems.append(
                    f"line {lineno}: non-numeric exemplar value "
                    f"{m.group('exvalue')!r}"
                )
        try:
            value = float(m.group("value"))
        except ValueError:
            problems.append(f"line {lineno}: non-numeric value {m.group('value')!r}")
            continue
        if mtype == "histogram" and sname.endswith("_bucket"):
            labels = m.group("labels") or "{}"
            le_m = re.search(r'le="([^"]*)"', labels)
            if not le_m:
                problems.append(f"line {lineno}: histogram bucket without le")
                continue
            le = math.inf if le_m.group(1) == "+Inf" else float(le_m.group(1))
            series = (base, re.sub(r'le="[^"]*",?', "", labels))
            prev = hist_last.get(series)
            if prev is not None and value < prev:
                problems.append(
                    f"line {lineno}: histogram {base!r} cumulative count "
                    f"decreases at le={le_m.group(1)}"
                )
            hist_last[series] = value
            hist_buckets.setdefault(series, []).append(le)
    for (base, _), les in hist_buckets.items():
        if les and les[-1] != math.inf:
            problems.append(f"histogram {base!r} series missing +Inf bucket")
        if les != sorted(les):
            problems.append(f"histogram {base!r} buckets out of order")
    for name in typed:
        if sample_counts.get(name, 0) == 0 and typed[name] != "untyped":
            # empty families are allowed (declared, nothing observed yet)
            pass
    return problems
