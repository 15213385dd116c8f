"""ckpt_write_s: per durable cold mine, the seconds of the program's
``checkpoint.write`` spans (inside ``mine.checkpoint``: the checkpoint
manager's save, from the arrays' CRC32 and ``.npz`` write through the
atomic rename and the prune), averaged over the window."""

from bench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "checkpoint.write")
