"""intersect_s: per cold mine, the seconds of the program's
``intersect.dispatch`` and ``intersect.sync`` spans (launching the batches
and the host's wait for them), averaged over the window."""

from bench.trace import span_total


def read(run):
    vals = [span_total(r["trace"], "intersect.dispatch") + span_total(r["trace"], "intersect.sync")
            for r in run.requests if r.get("trace")]
    return sum(vals) / len(vals) if vals else None
