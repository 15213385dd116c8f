"""candidates_s: per cold mine, the seconds of the program's
``frontier.candidates`` spans (candidate generation, support test, masking,
and the host bound pruning at k = kmax), averaged over the window."""

from bench.trace import span_total


def read(run):
    vals = [span_total(r["trace"], "frontier.candidates") for r in run.requests if r.get("trace")]
    return sum(vals) / len(vals) if vals else None
