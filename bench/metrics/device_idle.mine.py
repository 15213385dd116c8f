"""device_idle.mine: the share of the traced window's cold mines in which no
operation ran on the device (torch.profiler, CUDA activity only), in %."""


def read(run):
    dev = run.device
    if dev is None or not dev.ops or dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
