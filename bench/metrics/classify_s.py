"""classify_s: per cold mine, the seconds of the program's ``level.classify``
spans (the emit/store partition and its fetches), averaged over the window."""

from bench.trace import span_total


def read(run):
    vals = [span_total(r["trace"], "level.classify") for r in run.requests if r.get("trace")]
    return sum(vals) / len(vals) if vals else None
