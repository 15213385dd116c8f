"""bounds_s: per cold mine, the seconds of the program's ``frontier.bounds``
spans (Lemma 4.6 and Corollary 4.7 in numpy over each batch's survivors)
and ``level.index`` spans (the host ``ItemsetIndex`` those lookups read),
averaged over the window: the host compute of the bound pruning."""

from bench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "frontier.bounds", "level.index")
