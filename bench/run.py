#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, the traffic mix ``bench/traffic/<traffic>.json`` with its
driver ``bench/traffic/<driver>.py``, and one reader per metric,
``bench/metrics/<metric>.py`` (``read(run) -> float | None``). Set-up (the
imports, the kernels' build into ``build/kernels/``, the tables, the warm-up
requests) is timed as ``setup_s``; then requests run back to back for
``--seconds``. With ``--trace 1`` the device is profiled over the window and
the cell's per-layer metrics are reported instead of its end-to-end ones.
After the window the driver holds every answer against the plain reference.
The last line of standard output is the result as one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import load_module  # noqa: E402

# top-level module names that may not be loaded by the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = ROOT / "build" / "bench-cache"


@dataclass
class Spec:
    cell: dict
    cfg: dict
    mix: dict
    end_to_end: list
    per_layer: list


@dataclass
class Run:
    """What a metric reader reads."""

    hw: dict
    setup_s: float
    window_s: float = 0.0
    peak_bytes: int = 0
    requests: list = field(default_factory=list)  # driver records + wall_s, t0, t1, trace
    device: object = None  # trace.DeviceTrace in a traced run


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` is read in those cells; an end-to-end one
    without, in every cell; a per-layer one without, in every cell that
    reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_spec(cell_name: str, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / config["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell_name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, cell_name, names)]
    return Spec(cell=cell, cfg=cfg, mix=mix, end_to_end=e2e, per_layer=per_layer)


def _read_metrics(metrics: list, run: Run) -> dict:
    out = {}
    for m in metrics:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _breakdown(run: Run, pc0: float) -> dict:
    """The device's ten costliest operations, and its idle time by the
    innermost span the host was in (``request`` alone: itemize and
    preprocess, outside the program's ``mine``)."""
    from bench.trace import innermost_segments

    dev = run.device
    ops = sorted(dev.time_by_name().items(), key=lambda kv: -kv[1])[:10]
    segs = [seg for r in run.requests if r.get("trace") for seg in innermost_segments(r["trace"].spans)]
    idle: dict[str, float] = {}
    j = 0
    for a_ns, b_ns in dev.idle_gaps():
        a, b = (pc0 + (t - dev.t0_ns) / 1e9 for t in (a_ns, b_ns))
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < b:
            part = min(b, segs[k][1]) - max(a, segs[k][0])
            if part > 0:
                idle[segs[k][2]] = idle.get(segs[k][2], 0.0) + part
                covered += part
            k += 1
        if b - a > covered:
            idle["between requests"] = idle.get("between requests", 0.0) + (b - a - covered)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def run(spec: Spec, seed: int, seconds: float, trace: bool, *, engine=None,
        device: str = "cuda", t_start: float = T_START) -> dict:
    """One run of a cell: the result line's object, the numbers compared
    last under ``checks``. ``engine``/``device`` override the
    configuration's program settings (CPU tests only)."""
    import torch

    from repro_torch.obs.trace import TRACER

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    driver = load_module(BENCH / "traffic" / f"{spec.mix['driver']}.py")
    traffic = driver.make(spec.cfg, spec.mix, seed, engine=engine, device=device)
    traffic.warm_up()
    sync()
    prof = None
    if trace:
        from bench.trace import Profiler

        prof = Profiler(on_card)
    hw = json.loads((BENCH / "hw.json").read_text())
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    result = Run(hw=hw, setup_s=time.perf_counter() - t_start)

    failed = 0
    if prof is not None:
        prof.open_window()
    t0 = pc0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        try:
            with TRACER.start("request") as root:
                rec = traffic.request(i)
                sync()
        except Exception as exc:  # a failed request is counted, and the run goes on
            print(f"request {i} failed: {type(exc).__name__}: {exc}", file=sys.stderr)
            failed += 1
            rec = None
        b = time.perf_counter()
        if rec is not None:
            found = TRACER.last(1)
            rec.update(wall_s=b - a, t0=a, t1=b,
                       trace=found[0] if trace and found and found[0].root is root else None)
            result.requests.append(rec)
        i += 1
    t1 = time.perf_counter()
    if prof is not None:
        prof.close_window()
    result.window_s = t1 - t0
    if on_card:
        result.peak_bytes = int(torch.cuda.max_memory_allocated())
    if prof is not None:
        s0 = time.perf_counter()
        result.device = prof.stop()
        print(f"profiler stopped and read in {time.perf_counter() - s0:.3f} s: "
              f"{len(result.device.ops)} device operations", file=sys.stderr)

    metrics = _read_metrics(spec.per_layer if trace else spec.end_to_end, result)
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name() if on_card else "cpu",
                "count": 1, "memory_peak_bytes": result.peak_bytes}
    line = {"correct": False, "attempted": i, "failed": failed, "metrics": metrics}
    if trace:
        dev_info.update(busy_s=result.device.busy_s, window_s=result.device.window_s)
        s0 = time.perf_counter()
        line["breakdown"] = _breakdown(result, pc0)
        print(f"breakdown in {time.perf_counter() - s0:.3f} s", file=sys.stderr)
    line["device"] = dev_info

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    checks = traffic.check(result.requests, device)
    print(f"setup {result.setup_s:.3f} s, window {result.window_s:.3f} s, {len(result.requests)} requests, "
          f"check {time.perf_counter() - c0:.3f} s", file=sys.stderr)
    line["correct"] = failed == 0 and all(v <= lim for v, lim in checks.values())
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("--seed must be a whole number >= 0", file=sys.stderr)
        return 2

    # every cache of the program inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

    spec = load_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {spec.cell['chips']} CUDA card(s), found {n}: no measurement without the card",
              file=sys.stderr)
        return 3

    line = run(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print("modules of JAX or of the JAX package were loaded: " + ", ".join(bad), file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"{name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
