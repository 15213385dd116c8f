"""fetch_s: per cold mine, the seconds of the program's ``frontier.fetch``
spans (at the bound-pruning level, each batch's support flags and pairs
copied to the host: the wait for the batch's frontier kernels, and for the
count before them, ends there), averaged over the window."""

from bench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "frontier.fetch")
