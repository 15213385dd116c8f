"""pair_fill: the share of the pairs the intersection kernels were launched
over that were counted, in %: the traced mines' pairs intersected at levels
k >= 2 (their level counts) over the ``launched`` attribute of their
``intersect.dispatch`` spans (each batch padded to its power-of-two bucket;
on the device frontier the bucket is sized by the batch's candidates, before
the support test)."""

from bench.spans import attr_values


def read(run):
    launched = sum(attr_values(run, "intersect.dispatch", "launched"))
    if not launched:
        return None
    # level tuples (k, candidates, support_pruned, bound_pruned, intersections, ...)
    counted = sum(level[4] for r in run.requests if r.get("trace") for level in r["stats"] if level[0] >= 2)
    return 100.0 * counted / launched
