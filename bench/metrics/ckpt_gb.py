"""ckpt_gb: per durable cold mine, the bytes its job checkpoints wrote (the
``bytes`` attribute of the program's ``checkpoint.write`` spans: the
arrays' bytes), in GB of 1e9 bytes, averaged over the window."""

from bench.spans import attr_values, traces


def read(run):
    written = attr_values(run, "checkpoint.write", "bytes")
    return sum(written) / len(traces(run)) / 1e9 if written else None
