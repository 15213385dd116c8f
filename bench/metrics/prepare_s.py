"""prepare_s: per cold mine, the request's wall time minus the program's
``mine`` span (itemize and preprocess, host), averaged over the window."""

from bench.trace import span_total


def read(run):
    vals = [r["wall_s"] - span_total(r["trace"], "mine") for r in run.requests if r.get("trace")]
    return sum(vals) / len(vals) if vals else None
