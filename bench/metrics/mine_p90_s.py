"""mine_p90_s: the 90th percentile of the window's cold mines (host clock)."""

import statistics


def read(run):
    walls = [r["wall_s"] for r in run.requests]
    if len(walls) < 10:  # a percentile needs samples beyond it
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[-1]
