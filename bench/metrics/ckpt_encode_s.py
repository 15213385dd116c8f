"""ckpt_encode_s: per durable cold mine, the seconds of the program's
``checkpoint.encode`` spans (inside ``mine.checkpoint``: the service's
pickle of the level's mining state into one blob), averaged over the
window."""

from bench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "checkpoint.encode")
