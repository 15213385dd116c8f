"""preprocess_s: per cold mine, the seconds of the program's ``preprocess``
span (paper §4.1 on the host: uniform and infrequent items, mirror groups,
the item order), averaged over the window."""

from bench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "preprocess")
