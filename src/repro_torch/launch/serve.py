"""Serving driver: batched prefill + decode over a model-zoo architecture.

  python -m repro_torch.launch.serve --arch gemma3-4b --batch 8 --prompt-len 2048 \
      --max-new 64 --out gen.json
  python -m repro_torch.launch.serve --arch glm4-9b --reduced --device cpu

Runs on the card by default (``--device cuda``) and exits with an error when
there is none; ``--device cpu`` runs on the CPU. The weights are random, from
``--seed`` (a generator on the device), float32 masters stored in the
activation dtype (``--dtype``, by default the config's own); the prompts are
numpy draws from the same seed. ``--out`` writes JSON: the tokens, the
prefill time (to the first token), each decode step's time, tokens/s and
the peak of ``torch.cuda.max_memory_allocated`` (null on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import numpy as np
import torch

from ..configs import get_arch, reduced as reduce_cfg
from ..configs.base import act_dtype
from ..models.zoo import build
from ..serving.engine import generate

__all__ = ["ENC_FRAMES", "make_batch", "prepare", "serve", "main"]

ENC_FRAMES = 32  # encoder frames of the audio stub's input, as the reference's CLI


def make_batch(cfg, rng: np.random.Generator, batch: int, seq_len: int) -> dict:
    """Seeded inputs on the CPU: tokens (B, S) int64 drawn from ``rng``, then
    the frontend's input (``ENC_FRAMES`` audio frames, or the vision stub's
    patches) drawn in float64 and cast to float32: the reference CLI's draws."""
    out = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq_len)))}
    shape = {"audio_stub": (batch, ENC_FRAMES, cfg.d_model),
             "vision_stub": (batch, cfg.n_patches, cfg.d_model)}.get(cfg.frontend)
    if shape is not None:
        key = "frames" if cfg.frontend == "audio_stub" else "patches"
        out[key] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return out


def prepare(arch: str, *, reduced: bool = False, batch: int = 4, prompt_len: int = 16,
            seed: int = 0, device: str = "cuda", dtype: str | None = None):
    """(model, net, prompts (B, S) int64 on the CPU, extra inputs) of a run:
    random weights from ``seed`` on ``device``, stored in the activation
    dtype, and numpy prompts (and frontend inputs) from the same seed."""
    dev = torch.device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build(cfg)
    net = model.init(torch.Generator(dev).manual_seed(seed), dev, dtype=act_dtype(cfg))
    inputs = make_batch(cfg, np.random.default_rng(seed), batch, prompt_len)
    prompts = inputs.pop("tokens")
    return model, net, prompts, {k: v.to(dev) for k, v in inputs.items()}


def serve(arch: str, *, reduced: bool = False, batch: int = 4, prompt_len: int = 16,
          max_new: int = 16, temperature: float = 0.0, seed: int = 0, device: str = "cuda",
          dtype: str | None = None) -> dict:
    """Build ``arch`` with random weights from ``seed`` on ``device`` and
    generate; returns the ``--out`` record."""
    dev = torch.device(device)
    model, net, prompts, extra = prepare(arch, reduced=reduced, batch=batch,
                                         prompt_len=prompt_len, seed=seed, device=device,
                                         dtype=dtype)
    cfg = model.cfg
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sampler = torch.Generator(dev).manual_seed(seed) if temperature > 0 else None
    gen = generate(model, net, prompts, max_new=max_new, temperature=temperature,
                   generator=sampler, extra=extra)
    wall = gen.prefill_s + gen.decode_s
    return {
        "arch": cfg.name, "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": cfg.dtype, "batch": batch, "prompt_len": prompt_len, "max_new": max_new,
        "temperature": temperature, "seed": seed,
        "tokens": gen.tokens.tolist(),
        "prefill_s": gen.prefill_s,
        "decode_step_s": gen.step_s,
        "decode_step_median_s": statistics.median(gen.step_s) if gen.step_s else None,
        "tokens_per_s": batch * max_new / wall,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="activation and weight dtype (default: the config's)")
    ap.add_argument("--out", default=None, help="write the run's JSON record here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: torch sees no CUDA card (pass --device cpu)")

    rec = serve(args.arch, reduced=args.reduced, batch=args.batch, prompt_len=args.prompt_len,
                max_new=args.max_new, temperature=args.temperature, seed=args.seed,
                device=args.device, dtype=args.dtype)
    print(f"arch={rec['arch']} device={rec['device_name']} dtype={rec['dtype']} "
          f"batch={args.batch} prompt={args.prompt_len} new={args.max_new}")
    step = rec["decode_step_median_s"]
    print(f"prefill {rec['prefill_s']:.4f}s, decode step median "
          f"{'n/a' if step is None else f'{step * 1e3:.3f}ms'}, "
          f"{rec['tokens_per_s']:.1f} tok/s, peak {rec['peak_bytes']}")
    print("first row:", rec["tokens"][0])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)


if __name__ == "__main__":
    main()
