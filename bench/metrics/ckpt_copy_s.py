"""ckpt_copy_s: per durable cold mine, the seconds of the program's
``checkpoint.copy`` spans (inside ``mine.checkpoint``: the stored level's
bitsets copied from the card to the host), averaged over the window."""

from bench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "checkpoint.copy")
