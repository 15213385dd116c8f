"""Serving with the LM port on the CPU: greedy ``generate`` gives the
reference's tokens (six families), the port's prefill + decode gives its own
full forward's logits (all ten, and at B = 3, S = 2, where the reference's
cache growth pads the wrong axis), temperature sampling repeats under one
generator seed, and ``python -m repro_torch.launch.serve`` runs."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.serving.engine import _grow_cache as ref_grow_cache
from repro.serving.engine import generate as ref_generate
from repro_torch.configs import ARCHS as PORT_ARCHS, reduced as port_reduced
from repro_torch.launch.serve import serve
from repro_torch.models.zoo import build as port_build
from repro_torch.serving.engine import generate, grow_cache, prefill_then_decode
from test_torch_lm_helpers import NAMES, assert_grow_agrees, batches, pair

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4  # float32 logits of two packages (or of two modes), as in test_torch_lm_models
# one representative per family mechanism, as tests/test_serving.py
FAMILIES = ["glm4-9b", "gemma3-4b", "deepseek-v2-lite-16b", "mamba2-370m",
            "recurrentgemma-9b", "whisper-medium"]


def _extra(batch):
    return {k: v for k, v in batch.items() if k != "tokens"}


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_generate_matches_reference(name):
    """B = 2, S = 20 (over the reduced window of 16), 6 new tokens: no cache
    axis but the sequence has 20 entries, so the reference grows its caches
    right (checked). Each step's top-2 logit margin exceeds 10 * TOL, so a
    difference within TOL cannot flip an argmax."""
    b, s, new = 2, 20, 6
    rm, params, tm, net = pair(name)
    rb, tb = batches(rm.cfg, np.random.default_rng(11), b, s)
    want = ref_generate(rm, params, np.asarray(rb["tokens"]), max_new=new, extra=_extra(rb))
    gen = generate(tm, net, tb["tokens"], max_new=new, extra=_extra(tb))
    _, cache = tm.prefill(net, tb)
    assert_grow_agrees(rm, params, rb, grow_cache(cache, s, s + new), s, s + new)
    got = gen.tokens.numpy()
    np.testing.assert_array_equal(got, want)
    assert len(gen.step_s) == new - 1 and gen.prefill_s > 0

    full = dict(tb, tokens=torch.cat([tb["tokens"], gen.tokens[:, :-1]], dim=1))
    with torch.inference_mode():
        logits = tm.forward(net, full, positions=slice(s - 1, None)).numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (logits.argmax(-1) == got).all()
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * TOL


def _decode_vs_forward(tm, net, tb, s, steps):
    """Logits of prefill(s tokens) and ``steps`` decode steps against the
    forward's over s + steps; decoding starts after the whole prompt (the
    vision stub's patches come first)."""
    with torch.inference_mode():
        want = tm.forward(net, tb, positions=slice(s - 1, None)).numpy()
    got, cache = prefill_then_decode(tm, net, tb, s, steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    return cache


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_matches_own_forward(name):
    """The port's own random init: prefill(S = 20) then 4 decode steps give
    the logits of one full forward over S + 4 tokens."""
    cfg = port_reduced(PORT_ARCHS[name])
    tm = port_build(cfg)
    net = tm.init(torch.Generator().manual_seed(4))
    _, tb = batches(cfg, np.random.default_rng(5), 2, 24)
    _decode_vs_forward(tm, net, tb, 20, 4)


def test_short_prompt_where_reference_growth_fails():
    """Reduced glm4-9b has 2 layers in 2 scanned groups. At B = 3, S = 2 the
    reference's ``_grow_cache`` pads the first axis of size 2 of its stacked
    caches, the group axis, and leaves the sequence at 2 slots; the port
    grows axis 1 of each layer's cache and decodes to its full forward."""
    b, s, steps = 3, 2, 4
    rm, params, tm, net = pair("glm4-9b")
    rb, tb = batches(rm.cfg, np.random.default_rng(6), b, s + steps)
    _, r_cache = jax.jit(lambda p, x: rm.prefill(p, None, x))(
        params, dict(rb, tokens=rb["tokens"][:, :s]))
    r_k = ref_grow_cache(r_cache, s, s + steps)["groups"][0]["k"]
    assert r_k.shape == (s + steps, b, s, 2, 16)  # groups padded 2 -> 6, sequence still 2
    cache = _decode_vs_forward(tm, net, tb, s, steps)
    assert [tuple(c["k"].shape) for c in cache] == [(b, s + steps, 2, 16)] * 2


def test_temperature_sampling_repeats_under_one_seed():
    cfg = port_reduced(PORT_ARCHS["glm4-9b"])
    tm = port_build(cfg)
    net = tm.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(1, cfg.vocab, (2, 6)))

    def sample(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(tm, net, prompts, max_new=8, temperature=5.0, generator=g).tokens

    a, b, c = sample(7), sample(7), sample(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (2, 8) and int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    with pytest.raises(ValueError):
        generate(tm, net, prompts, max_new=2, temperature=1.0)


def _run_cli(*args, tmp_path=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, env=env, timeout=300, cwd=str(ROOT))


def test_serve_cli_on_cpu(tmp_path):
    out = tmp_path / "gen.json"
    args = dict(batch=2, prompt_len=6, max_new=5, seed=3)
    proc = _run_cli("--arch", "glm4-9b", "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "6", "--max-new", "5", "--seed", "3", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["dtype"] == "float32" and rec["peak_bytes"] is None
    assert np.shape(rec["tokens"]) == (2, 5) and len(rec["decode_step_s"]) == 4
    assert rec["prefill_s"] > 0 and rec["tokens_per_s"] > 0
    # the same seed and arguments in this process give the same tokens
    assert serve("glm4-9b", reduced=True, device="cpu", **args)["tokens"] == rec["tokens"]


@pytest.mark.parametrize("name", ["whisper-medium", "internvl2-26b"])
def test_serve_frontends_and_sampling(name):
    """The audio and vision stubs' inputs, and sampling, through ``serve``."""
    kw = dict(reduced=True, device="cpu", batch=2, prompt_len=5, max_new=4, temperature=0.8,
              seed=2, dtype="bfloat16")
    a, b = serve(name, **kw), serve(name, **kw)
    assert a["tokens"] == b["tokens"] and np.shape(a["tokens"]) == (2, 4)
    assert a["dtype"] == "bfloat16"


def test_serve_cli_defaults_to_the_card():
    """With no --device the CLI runs on the card; without one it stops with
    an error (no CPU fallback)."""
    proc = _run_cli("--arch", "glm4-9b", "--reduced", "--max-new", "2")
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr[-3000:]
    else:
        assert proc.returncode != 0
        assert "no CUDA card" in proc.stderr
