"""checkpoint_s: per durable cold mine, the seconds of the program's
``mine.checkpoint`` spans (one a level boundary: the level's host copy, the
service's pickle of the state and its write to disk), averaged over the
window."""

from bench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "mine.checkpoint")
