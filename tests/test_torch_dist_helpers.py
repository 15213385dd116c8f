"""Shared pieces of the distributed port's tests (``tests/test_torch_dist_*.py``;
this module holds no test): the reference run in a subprocess on forced
host devices, spec normalisation, and the one-step comparison of a placed
step against a reference step (the rule of ``test_torch_train_rule``).

The reference's mesh is built with ``Auto`` axes: on jax 0.9.0
``jax.make_mesh`` gives ``Explicit`` axes, under which the reference's
``with_sharding_constraint`` is an assert (its own plan and elastic tests
fail for that reason; ``ROADMAP.md`` queue 3).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.distributed.elastic import gather
from test_torch_train_rule import assert_moments_close, assert_params_close

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TESTS = ROOT / "tests"

_PRELUDE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{src!r}, {tests!r}]
import pickle
import numpy as np
import jax
from jax.sharding import AxisType, Mesh as JaxMesh


def auto_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names,
                   axis_types=(AxisType.Auto,) * len(shape))


with open({inp!r}, "rb") as f:
    IN = pickle.load(f)
OUT = {{}}
"""

_EPILOGUE = r"""
with open({out!r}, "wb") as f:
    pickle.dump(OUT, f)
"""


def run_reference(body: str, out_dir: Path, n_devices: int = 8, timeout: int = 240,
                  inputs=None) -> dict:
    """Run ``body`` in a fresh interpreter on ``n_devices`` forced host
    devices; it reads ``IN`` (``inputs``, pickled) and fills the dict ``OUT``
    (numpy and plain values), which comes back here. ``auto_mesh(shape,
    names)`` builds an ``Auto`` mesh."""
    out, inp = Path(out_dir) / "ref.pkl", Path(out_dir) / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    script = (_PRELUDE.format(n=n_devices, src=str(SRC), tests=str(TESTS), inp=str(inp)) + body
              + _EPILOGUE.format(out=str(out)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def norm_spec(spec) -> tuple:
    """A spec as a tuple whose one-name tuples are the name itself (the form
    both ``PartitionSpec`` and the port's plan may use for the data axes)."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def assert_step_matches(params: dict, opt: dict, met: dict, want: dict, lr: float,
                        step: int = 1, norm_tol: float = 1e-5) -> None:
    """A placed step's result (``params``, ``opt``: trees of ``Sharded``)
    against the reference's (``want``: ``params``, ``m``, ``v`` by port name,
    ``loss``, ``grad_norm``) under the rule: the loss within 1e-5, the
    gradient norm within ``norm_tol`` (1e-5) relative, the moments and parameters by
    ``test_torch_train_rule``."""
    assert abs(float(met["loss"]) - want["loss"]) <= 1e-5, (float(met["loss"]), want["loss"])
    gn = float(met["grad_norm"])
    assert abs(gn - want["grad_norm"]) <= norm_tol * want["grad_norm"], (gn, want["grad_norm"])
    got = {"params": gather(params), "m": gather(opt["m"]), "v": gather(opt["v"])}
    w = {k: {n: torch.as_tensor(np.asarray(a, np.float32)) for n, a in want[k].items()}
         for k in ("params", "m", "v")}
    assert sorted(got["params"]) == sorted(w["params"])
    assert_moments_close(got["m"], w["m"], "m", ulps=1)
    assert_moments_close(got["v"], w["v"], "v", ulps=2)
    assert_params_close(got["params"], w["params"], {"m": got["m"], "v": got["v"]},
                        {"m": w["m"], "v": w["v"]}, lr, step)


def assert_replicas_identical(tree: dict) -> int:
    """Every entry that holds the same slice of a leaf holds the same bits.
    Returns the number of replicated slices checked."""
    n = 0
    for name, s in tree.items():
        first: dict = {}
        for c in s.coords():
            key = tuple((sl.start, sl.stop) for sl in s.slices(c))
            t = s.shards[c].cpu()
            if key in first:
                assert torch.equal(first[key], t), f"{name}: entry {c} differs"
                n += 1
            else:
                first[key] = t
    return n


def cpu_mesh(spec: str):
    from repro_torch.launch.mesh import mesh_from_spec

    d, m = (int(p) for p in spec.split("x"))
    return mesh_from_spec(spec, devices=["cpu"] * (d * m))


def row_steps(model, net, batch: dict, n_rows: int) -> dict:
    """The shared int8 step of each leaf in a compressed reduce over
    ``n_rows`` data rows: the largest |gradient| of any row's slice of
    ``batch`` (float32, no sharding context, as each row of
    ``make_compressed_dp_step`` computes it), over 127."""
    b = next(iter(batch.values())).shape[0]
    top: dict = {}
    for r in range(n_rows):
        net.zero_grad(set_to_none=True)
        mb = {k: v.reshape(n_rows, b // n_rows, *v.shape[1:])[r] for k, v in batch.items()}
        model.train_loss(net, mb).backward()
        for n, p in net.named_parameters():
            g = 0.0 if p.grad is None else float(p.grad.abs().max())
            top[n] = max(top.get(n, 0.0), g)
    net.zero_grad(set_to_none=True)
    return {n: t / 127.0 for n, t in top.items()}


def reduce_error(got_m: dict, got_norm: float, want_m: dict, want_norm: float, steps: dict,
                 opt_cfg) -> float:
    """How far a compressed step's reduced gradient lies from the exact
    step's, as a share of its bound: at most 1 passes. Both gradients are
    read back from the first moments after one AdamW step from zero, m =
    (1 - b1) clip g with clip = min(1, clip_norm / grad_norm) from each
    step's own norm. Each data entry quantizes at its leaf's shared step s
    (``row_steps``) and errs by less than s, so their mean errs by less than
    s: every element is held within s (1 + 1e-3) + 1e-5 of the leaf's
    largest exact value, and the two norms within the norm of those
    bounds."""
    def grads(m, norm):
        clip = min(1.0, opt_cfg.clip_norm / max(norm, 1e-9))
        return {n: t.double() / ((1 - opt_cfg.b1) * clip) for n, t in m.items()}

    got, want = grads(got_m, got_norm), grads(want_m, want_norm)
    worst = bound_sq = 0.0
    for n, w in want.items():
        tol = steps[n] * (1 + 1e-3) + 1e-5 * float(w.abs().max())
        worst = max(worst, float((got[n].to(w.device) - w).abs().max()) / max(tol, 1e-30))
        bound_sq += w.numel() * tol ** 2
    return max(worst, abs(got_norm - want_norm) / max(bound_sq ** 0.5, 1e-30))


def biased_psum(mesh, dp_axes):
    """The reference's compressed reduce, a control the compressed-step
    checks must fail (``src/repro/training/compression.py:54-59``): each
    entry quantizes at its own scale, and the int32 sum is dequantized at
    the max of the scales."""
    from repro_torch.training.compression import _quantize, _scale

    def fn(grads, generator):
        out = [{} for _ in grads]
        for name, g0 in grads[0].items():
            rnd = torch.rand(g0.shape, generator=generator, device=generator.device)
            scales = [_scale(g[name]) for g in grads]
            q32 = sum(_quantize(g[name], s, rnd.to(g[name].device)).to(torch.int32).to(g0.device)
                      for g, s in zip(grads, scales))
            top = torch.stack([s.to(g0.device) for s in scales]).max()
            mean = q32.float() * top / len(grads)
            for o, g in zip(out, grads):
                o[name] = mean.to(g[name].device)
        return out

    return fn


def unscaled_psum(mesh, dp_axes):
    """The port's compressed reduce without the division by the number of
    entries (the sum, not the mean): a control the checks must fail."""
    from repro_torch.training.compression import compressed_psum

    reduce = compressed_psum(mesh, dp_axes)

    def fn(grads, generator):
        return [{n: t * len(grads) for n, t in o.items()} for o in reduce(grads, generator)]

    return fn


CONTROLS = {"port": None, "biased": biased_psum, "unscaled": unscaled_psum}
