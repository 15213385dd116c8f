"""Training driver: config -> synthetic data -> train loop with checkpoints.

  python -m repro_torch.launch.train --arch granite-moe-1b-a400m --steps 8 \
      --batch 8 --seq 2048 --out train.json
  python -m repro_torch.launch.train --arch glm4-9b --reduced --device cpu \
      --steps 100 --batch 8 --seq 64 --ckpt-dir ck --ckpt-every 20

Runs on the card by default (``--device cuda``) and exits with an error when
there is none; ``--device cpu`` runs on the CPU. The weights are float32
masters from ``--seed`` (a generator on the device); the batches are the
reference's synthetic token stream from the same seed, and a frontend stub's
frames or patches are drawn from a generator on the device.

``--mesh host`` trains over the sharding plan (``distributed.sharding``,
the ZeRO-3 step of ``training.train``) on the reference's host mesh shape,
4x2 (data, model): with a bare ``--device cuda`` its entries are the
visible cards and the shape shrinks to them, as the reference's does (1x1
on one card); with an indexed device (``cuda:0``) or ``cpu`` all 8 entries
repeat it, as the reference's forced host devices do on the CPU.
``production`` (16x16) and ``multipod`` (2x16x16) build
``launch.mesh.make_production_mesh`` over ``--device`` the same way: a bare
``cuda`` takes the visible cards and stops with the mesh's error when there
are fewer (as the reference stops off a pod; a one-card machine runs them
only as ``launch.dryrun`` counts them), an indexed device or ``cpu``
repeats in every entry.
``train(mesh=...)`` takes any ``launch.mesh.Mesh`` with a ``model`` axis.

``--ckpt-dir`` saves ``{"params", "opt"}`` under the port's parameter names
every ``--ckpt-every`` steps (written in the background); ``--resume`` takes
up the newest one, and also one written by the reference's trainer (its
stacked parameter tree is unstacked by ``convert.lm_params_from_numpy``),
and skips the batches the run has already consumed, so a resumed run equals
the uninterrupted one. On a mesh the checkpoints hold the gathered logical
arrays, and ``--resume`` places them on the run's mesh, whatever mesh wrote
them. ``--out`` writes JSON: the losses, each step's time, tokens/s, the
peak of ``torch.cuda.max_memory_allocated`` (null on the CPU) and the
mesh's fingerprint (null without one).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_arch, reduced as reduce_cfg
from ..configs.base import act_dtype
from ..convert import lm_params_from_numpy
from ..distributed.checkpoint import CheckpointManager
from ..distributed.elastic import gather, mesh_fingerprint, redistribute
from ..distributed.sharding import make_plan
from ..models.zoo import build
from ..training.optimizer import OptConfig
from ..training.train import init_train_state, make_train_step
from .mesh import make_host_mesh, make_production_mesh

__all__ = ["synthetic_lm_batches", "frontend_inputs", "host_mesh", "production_mesh", "train",
           "main"]


def synthetic_lm_batches(vocab: int, batch: int, seq: int, seed: int = 0):
    """The reference's deterministic, learnable token stream, bit for bit:
    token j of a row is ``(start * 31 + j * 131) % (vocab - 1) + 1`` with a
    random start per row; labels are the tokens shifted by one. Yields CPU
    int64 ``{"tokens", "labels"}`` (B, seq)."""
    rng = np.random.default_rng(seed)
    while True:
        start = rng.integers(1, vocab, size=(batch, 1))
        idx = np.arange(seq + 1)[None, :]
        toks = torch.from_numpy((start * 31 + idx * 131) % max(vocab - 1, 1) + 1)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def frontend_inputs(cfg, batch: int, seq: int, generator: torch.Generator, device) -> dict:
    """A frontend stub's input for one batch, standard normal in the
    activation dtype: ``frames`` (B, seq, D) or ``patches`` (B, n_patches, D)."""
    shape = {"audio_stub": (batch, seq, cfg.d_model),
             "vision_stub": (batch, cfg.n_patches, cfg.d_model)}.get(cfg.frontend)
    if shape is None:
        return {}
    key = "frames" if cfg.frontend == "audio_stub" else "patches"
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return {key: x.to(act_dtype(cfg))}


def _dotted(tree, prefix: str = "") -> dict:
    """Dotted names of the leaves of nested dicts (a restored checkpoint)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _named(tree: dict, cfg, names) -> dict:
    """Port-named numpy leaves of a checkpointed parameter tree: the port's
    own (dotted names) or the reference's stacked pytree."""
    flat = _dotted(tree)
    if set(flat) == set(names):
        return flat
    # the reference's checkpoint drops an empty list (no prefix or suffix layers)
    tree = {"prefix": [], "suffix": [], **tree}
    return lm_params_from_numpy(tree, cfg)


def _restore(cm: CheckpointManager, net, opt_state, cfg) -> int:
    """Load the newest checkpoint into ``net`` and ``opt_state``; its step."""
    tree, meta = cm.restore()
    params = dict(net.named_parameters())
    loaded = {"params": _named(tree["params"], cfg, params),
              "m": _named(tree["opt"]["m"], cfg, params),
              "v": _named(tree["opt"]["v"], cfg, params)}
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.as_tensor(np.asarray(loaded["params"][name])))
            opt_state["m"][name].copy_(torch.as_tensor(np.asarray(loaded["m"][name])))
            opt_state["v"][name].copy_(torch.as_tensor(np.asarray(loaded["v"][name])))
        opt_state["step"].fill_(int(np.asarray(tree["opt"]["step"])))
    return int(meta["step"])


def host_mesh(device):
    """``--mesh host``: the reference's 4x2 host mesh over ``device`` (see
    the module note)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return make_host_mesh()
    return make_host_mesh(devices=[device] * 8)


def production_mesh(device, multi_pod: bool = False):
    """``--mesh production`` / ``multipod`` over ``device`` (see the module
    note)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return make_production_mesh(multi_pod=multi_pod)
    return make_production_mesh(multi_pod=multi_pod, devices=[device] * (512 if multi_pod else 256))


def train(arch: str, *, reduced: bool = False, steps: int = 100, batch: int = 8, seq: int = 64,
          lr: float = 3e-3, grad_accum: int = 1, ckpt_dir: str | None = None,
          ckpt_every: int = 50, resume: bool = False, seed: int = 0, log_every: int = 10,
          device: str = "cuda", mesh=None) -> dict:
    """Run the loop; returns the ``--out`` record. With ``mesh`` the run
    trains over the sharding plan, from its first entry's device."""
    dev = torch.device(device) if mesh is None else mesh.devices.flat[0]
    cfg = get_arch(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    model = build(cfg)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 20, 1), total_steps=steps)
    net, opt_state = init_train_state(model, torch.Generator(dev).manual_seed(seed), opt_cfg,
                                      dev)
    start_step = 0
    cm = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if cm and resume and cm.latest_step() is not None:
        start_step = _restore(cm, net, opt_state, cfg)
        print(f"resumed from step {start_step}", flush=True)

    if mesh is None:
        step_fn = make_train_step(model, opt_cfg, grad_accum=grad_accum)
        state = lambda: {"params": dict(net.named_parameters()), "opt": opt_state}
    else:
        plan = make_plan(mesh)
        params = redistribute(net, plan)
        opt_state = redistribute(opt_state, plan, "opt")
        net = None  # the run's state is the placed trees
        plan_step, _ = make_train_step(model, opt_cfg, plan, grad_accum=grad_accum)

        def step_fn(_net, opt, b):
            _, opt, metrics = plan_step(params, opt, b)
            return opt, metrics

        state = lambda: {"params": gather(params), "opt": gather(opt_state)}
    batches = synthetic_lm_batches(cfg.vocab, batch, seq, seed)
    frontend = torch.Generator(dev).manual_seed(seed)
    for _ in range(start_step):  # the batches the checkpointed run consumed
        next(batches)
        frontend_inputs(cfg, batch, seq, frontend, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses, step_s = [], []
    for step in range(start_step, steps):
        ts = time.perf_counter()
        b = {k: v.to(dev) for k, v in next(batches).items()}
        b.update(frontend_inputs(cfg, batch, seq, frontend, dev))
        opt_state, metrics = step_fn(net, opt_state, b)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - ts)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
        if cm and (step + 1) % ckpt_every == 0:
            cm.save(step + 1, state(), {"arch": cfg.name}, blocking=False)
    if cm:
        cm.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})", flush=True)
    tokens = batch * seq * len(losses)
    return {
        "arch": cfg.name, "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": cfg.dtype, "batch": batch, "seq": seq, "grad_accum": grad_accum,
        "start_step": start_step, "steps": steps, "losses": losses, "step_s": step_s,
        "tokens_per_s": tokens / sum(step_s) if step_s else None,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "mesh": None if mesh is None else mesh_fingerprint(mesh),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "production", "multipod"],
                    help="none: one device; host: the 4x2 host mesh over --device; "
                         "production / multipod: 16x16 / 2x16x16 over --device")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--out", default=None, help="write the run's JSON record here")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh in ("production", "multipod"):
        try:
            mesh = production_mesh(args.device, multi_pod=args.mesh == "multipod")
        except RuntimeError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: torch sees no CUDA card (pass --device cpu)")
    if args.batch % args.grad_accum:
        ap.error(f"--batch {args.batch} is not a multiple of --grad-accum {args.grad_accum}")
    if args.mesh == "host":
        mesh = host_mesh(args.device)

    rec = train(args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
                seq=args.seq, lr=args.lr, grad_accum=args.grad_accum, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume, seed=args.seed,
                log_every=args.log_every, device=args.device, mesh=mesh)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)


if __name__ == "__main__":
    main()
