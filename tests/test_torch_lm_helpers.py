"""Shared pieces of the LM port's parity tests (``tests/test_torch_lm_*.py``;
this module holds no test): the reference model's full forward, its caches
in the port's per-layer form, and seeded batches for both packages."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, reduced
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro.models.layers.common import rms_norm as ref_rms_norm
from repro.models.layers.embeddings import logits_head as ref_logits_head
from repro.models.zoo import build as ref_build
from repro_torch.configs import ARCHS as PORT_ARCHS, reduced as port_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import make_batch
from repro_torch.models.zoo import build as port_build

NAMES = sorted(ARCHS)


def pair(name: str, seed: int = 0, bf16: bool = False):
    """(ref model, ref params, port model, port net) of the reduced config on
    the same weights; ``bf16``: bfloat16 activations, and the port's weights
    stored in bfloat16 (the reference keeps float32 masters and casts)."""
    rcfg, tcfg = reduced(ARCHS[name]), port_reduced(PORT_ARCHS[name])
    if bf16:
        rcfg = dataclasses.replace(rcfg, dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    rm, tm = ref_build(rcfg), port_build(tcfg)
    params = rm.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    net = tm.load(lm_params_from_numpy(tree, tcfg, dtype=torch.bfloat16 if bf16 else None))
    return rm, params, tm, net


def batches(cfg, rng: np.random.Generator, b: int, s: int):
    """Seeded (ref batch, port batch): tokens (B, S) and the frontend's input,
    drawn by the port's ``launch.serve.make_batch``."""
    port = make_batch(cfg, rng, b, s)
    ref = {k: jnp.asarray(v.numpy(), jnp.int32 if k == "tokens" else jnp.float32)
           for k, v in port.items()}
    return ref, port


def ref_forward(model, params, batch):
    """The reference's train-mode logits at every text position (B, S, V)."""
    cfg = model.cfg
    if cfg.family == "audio":
        memory = ref_encdec.encdec_encode(params, cfg, None, batch["frames"])
        dt = memory.dtype
        x = ref_encdec.embed_tokens(params["embed"], batch["tokens"], dt) * jnp.asarray(
            cfg.d_model ** 0.5, dt)
        x, _, _ = ref_encdec._run_decoder(params, cfg, None, x, memory, "train", None, None)
        return ref_logits_head(params["embed"], ref_rms_norm(x, params["final_norm"]), None)
    ex = batch.get("patches")
    x = ref_lm._embed_inputs(params, cfg, batch["tokens"], ex, None)
    h, _ = ref_lm.lm_forward(params, cfg, None, x, mode="train")
    if ex is not None:
        h = h[:, ex.shape[1]:]
    return ref_logits_head(params["embed"], h, None)


def ref_cache_layers(cfg, cache):
    """The reference's cache in the port's form: a list of per-layer dicts of
    numpy arrays (the encoder-decoder: {"self": [...], "cross": [...]})."""
    cache = jax.tree.map(np.asarray, cache)
    if cfg.family == "audio":
        return {part: [{k: v[i] for k, v in cache[part].items()} for i in range(cfg.n_layers)]
                for part in ("self", "cross")}
    prefix, n_groups, _ = ref_lm.layout(cfg)
    glen = len(cfg.pattern)
    layers = list(cache["prefix"])
    for gi in range(n_groups):
        for pos in range(glen):
            layers.append({k: v[gi] for k, v in cache["groups"][pos].items()})
    return layers + list(cache["suffix"])


def port_cache_layers(cache):
    """The port's cache with numpy leaves."""
    if isinstance(cache, dict):
        return {part: port_cache_layers(cache[part]) for part in ("self", "cross")}
    return [{k: v.float().cpu().numpy() for k, v in st.items()} for st in cache]


def assert_caches_close(cfg, ref_cache, port_cache, rtol, atol, msg=""):
    ref, port = ref_cache_layers(cfg, ref_cache), port_cache_layers(port_cache)
    if isinstance(ref, dict):
        for part in ref:
            assert_layers_close(ref[part], port[part], rtol, atol, f"{msg} {part}")
    else:
        assert_layers_close(ref, port, rtol, atol, msg)


def assert_layers_close(ref, port, rtol, atol, msg=""):
    assert len(ref) == len(port), msg
    for i, (r, p) in enumerate(zip(ref, port)):
        assert sorted(r) == sorted(p), f"{msg} layer {i}: {sorted(r)} != {sorted(p)}"
        for k in r:
            assert r[k].shape == p[k].shape, f"{msg} layer {i} {k}: {r[k].shape} != {p[k].shape}"
            np.testing.assert_allclose(p[k], np.asarray(r[k], np.float32), rtol=rtol, atol=atol,
                                       err_msg=f"{msg} layer {i} {k}")


def assert_grow_agrees(ref_model, params, ref_batch, port_cache, s: int, new_len: int):
    """The reference's ``_grow_cache`` (which pads the first axis of size s)
    gives the shapes of the port's grown ``port_cache`` (which pads the known
    sequence axis): the shapes of this test are free of the reference's fault."""
    from repro.serving.engine import _grow_cache

    _, cache = jax.eval_shape(lambda p, b: ref_model.prefill(p, None, b), params, ref_batch)
    grown = jax.eval_shape(lambda c: _grow_cache(c, s, new_len), cache)
    ref = ref_cache_layers(ref_model.cfg, jax.tree.map(lambda a: np.zeros(a.shape, np.int8), grown))
    port = port_cache_layers(port_cache)
    if isinstance(ref, dict):
        ref, port = ref["self"] + ref["cross"], port["self"] + port["cross"]
    assert [{k: v.shape for k, v in r.items()} for r in ref] == \
        [{k: v.shape for k, v in p.items()} for p in port]
