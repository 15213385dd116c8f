"""setup_s: seconds from the process's start to the window's (imports, the
kernels' build or load, the tables, the warm-up requests); host clock."""


def read(run):
    return run.setup_s
