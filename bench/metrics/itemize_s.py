"""itemize_s: per cold mine, the seconds of the program's ``itemize`` span
(the item table's build on the host: a ``np.unique`` and a bitset scatter
per column), averaged over the window."""

from bench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "itemize")
