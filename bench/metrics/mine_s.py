"""mine_s: the wait for a cold mine, as the window's wall time over the cold
mines completed in it (host clock; each request ends in a device sync)."""


def read(run):
    return run.window_s / len(run.requests) if run.requests else None
