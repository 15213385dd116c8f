"""Serving steps: prefill and batched decode over the model zoo.

``Model.prefill`` and ``Model.decode`` are the steps (under
``torch.inference_mode``); ``generate`` runs the batched greedy or
temperature-sampling loop over them and times it: the prefill up to the
first token, then each decode step.

Decode caches grow by their known sequence axis (axis 1 of each attention
leaf, ``models.lm.SEQ_LEAVES``); a local layer's ring and the encoder's
cross-attention K/V keep their size. (The reference finds the axis to pad
by matching sizes, which pads the wrong axis when a batch or a group count
equals the prompt length.) Decoding starts at the position after the
whole prompt, the vision stub's patches included.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.nn.functional as F
from torch import nn

from ..models.lm import SEQ_LEAVES
from ..models.zoo import Model

__all__ = ["Generation", "grow_cache", "prefill_then_decode", "generate"]


def _grow_layer(state: dict, cur_len: int, new_len: int) -> dict:
    out = {}
    for name, leaf in state.items():
        # axis 1 of a sequence leaf is the sequence; a ring of window < cur_len
        # slots keeps its size
        if name in SEQ_LEAVES and leaf.shape[1] == cur_len:
            pad = [0, 0] * (leaf.dim() - 2) + [0, new_len - cur_len]
            leaf = F.pad(leaf, pad)
        out[name] = leaf
    return out


def grow_cache(cache, cur_len: int, new_len: int):
    """Pad the sequence axis of the attention caches from cur_len to new_len."""
    if new_len <= cur_len:
        return cache
    if isinstance(cache, dict):  # encoder-decoder: grow the self-attention caches
        return {"self": [_grow_layer(s, cur_len, new_len) for s in cache["self"]],
                "cross": cache["cross"]}
    return [_grow_layer(s, cur_len, new_len) for s in cache]


@torch.inference_mode()
def prefill_then_decode(model: Model, net: nn.Module, batch: dict, s: int, steps: int):
    """Teacher-forced decode: prefill the first ``s`` tokens of batch["tokens"]
    (B, s + steps), then feed the next ``steps`` tokens one decode step each,
    on the device of ``net``. Returns the logits (B, steps + 1, V), the
    prefill's last position first, and the cache after the last step; they
    equal the full forward's logits at positions s - 1 .. s + steps - 1."""
    device = next(net.parameters()).device
    batch = {k: v.to(device) for k, v in batch.items()}
    tokens = batch["tokens"]
    prompt = dict(batch, tokens=tokens[:, :s])
    ctx = model.context_len(prompt)
    logits, cache = model.prefill(net, prompt)
    out = [logits[:, -1]]
    cache = grow_cache(cache, ctx, ctx + steps)
    for i in range(steps):
        dec = {"tokens": tokens[:, s + i:s + i + 1],
               "positions": torch.full((tokens.shape[0],), ctx + i, device=device)}
        logits, cache = model.decode(net, dec, cache)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1), cache


@dataclasses.dataclass
class Generation:
    """tokens (B, max_new) int64 on the CPU; prefill_s is the time to the first
    token (prefill, first token, cache growth, synchronised); step_s the time
    of each later decode step."""

    tokens: torch.Tensor
    prefill_s: float
    step_s: list[float]

    @property
    def decode_s(self) -> float:
        return sum(self.step_s)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pick(last: torch.Tensor, temperature: float, generator: torch.Generator | None):
    if temperature > 0:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return last.argmax(dim=-1)


@torch.inference_mode()
def generate(
    model: Model,
    net: nn.Module,
    prompt_tokens: torch.Tensor,
    max_new: int = 16,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    extra: dict | None = None,
) -> Generation:
    """Greedy (``temperature=0``) or sampled generation of ``max_new`` tokens
    after prompt_tokens (B, S), on the device of ``net``. Sampling draws
    from ``generator`` (on that device), so one seed repeats one run.

    One prefill gives the first token, and each of the max_new - 1 decode
    steps one more. On a card each step is timed by CUDA events, so the
    host does not wait on the device between steps.
    """
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    device = next(net.parameters()).device
    b = prompt_tokens.shape[0]
    batch = {"tokens": prompt_tokens.to(device)}
    batch.update(extra or {})
    s = model.context_len(batch)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(net, batch)
    tok = _pick(logits[:, -1], temperature, generator)
    cache = grow_cache(cache, s, s + max_new)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    cuda = device.type == "cuda"
    marks = [torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter()]
    if cuda:
        marks[0].record()
    for i in range(max_new - 1):
        dec = {"tokens": tok[:, None], "positions": torch.full((b,), s + i, device=device)}
        logits, cache = model.decode(net, dec, cache)
        tok = _pick(logits[:, 0], temperature, generator)
        out.append(tok)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
    _sync(device)
    if cuda:
        step_s = [a.elapsed_time(b_) / 1e3 for a, b_ in zip(marks, marks[1:])]
    else:
        step_s = [b_ - a for a, b_ in zip(marks, marks[1:])]
    return Generation(torch.stack(out, dim=1).cpu(), prefill_s, step_s)
