"""GPipe-style pipeline parallelism over a ``stage`` axis of a mesh.

The layers are divided into S stages; stage ``s`` holds slice ``s`` of the
stacked stage parameters on its entry. M micro-batches flow through the
stages in the classic GPipe schedule of S + M - 1 ticks: at each tick every
stage computes its resident micro-batch, then the buffers move to the next
entry's device (stage 0 takes in micro-batch t while t < M; the last stage
emits micro-batch t - (S - 1)). A stage with no resident micro-batch (the
fill and drain of the pipe) computes nothing: the bubble fraction is
(S - 1) / (S + M - 1). The last stage's outputs are the result, on the
mesh's first entry.
"""

from __future__ import annotations

import torch

__all__ = ["pipeline_forward", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages + n_micro - 1)


def pipeline_forward(mesh, stage_fn, *, stage_axis: str = "stage", n_micro: int):
    """``fn(stage_params, x) -> y``. ``stage_params``: ``{name: tensor}`` with
    a leading dim of ``n_stages`` (stage ``s``'s slice is copied to entry
    ``s``); ``x``: (n_micro * micro_b, ...), split into micro-batches;
    ``stage_fn(params_slice, xb) -> yb`` keeps the shape."""
    if mesh.axis_names != (stage_axis,):
        raise ValueError(f"a pipeline mesh has the one axis {stage_axis!r}, "
                         f"got {mesh.axis_names}")
    devices = list(mesh.devices.flat)
    n_stages = len(devices)

    def fn(stage_params: dict, x: torch.Tensor) -> torch.Tensor:
        here = [{k: v[s].to(dev) for k, v in stage_params.items()}
                for s, dev in enumerate(devices)]
        micro = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
        buf: list = [None] * n_stages  # stage s's resident micro-batch
        outputs: list = [None] * n_micro
        for t in range(n_stages + n_micro - 1):
            if t < n_micro:
                buf[0] = micro[t].to(devices[0])
            ys = [None if b is None else stage_fn(here[s], b) for s, b in enumerate(buf)]
            if t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = ys[-1].to(devices[0])
            # shift to the next stage; the last stage's output leaves the pipe
            buf = [None] + [None if y is None else y.to(devices[s + 1])
                            for s, y in enumerate(ys[:-1])]
        return torch.cat(outputs).reshape(x.shape)

    return fn
