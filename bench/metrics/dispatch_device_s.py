"""dispatch_device_s: per cold mine, the device seconds of the program's
intersection dispatches: the ``device_s`` attribute of its
``intersect.dispatch`` spans (CUDA events recorded on the dispatch's stream
before and after it: the pairs' upload where the host sends them, and every
kernel the dispatch launches, whatever its name), averaged over the window."""

from bench.spans import attr_values, traces


def read(run):
    vals = attr_values(run, "intersect.dispatch", "device_s")
    return sum(vals) / len(traces(run)) if vals else None
