"""The LM port's ten architectures against the reference, reduced and in
float32, on the reference's own init carried across by
``lm_params_from_numpy``: the forward logits, the prefill logits, every cache
leaf, and four decode steps' logits and caches, at rtol = atol = 1e-4 (float32
sums in another order over a few layers). Also the parameter count and
every leaf's shape, ``param_count`` of the ten full configs, and one bfloat16
case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models.zoo import build as ref_build
from repro.serving.engine import _grow_cache as ref_grow_cache
from repro_torch.configs import ARCHS as PORT_ARCHS, reduced as port_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.zoo import build as port_build
from repro_torch.serving.engine import grow_cache
from test_torch_lm_helpers import NAMES, assert_caches_close, batches, pair, ref_forward

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 20, 4  # S > the reduced window (16): local layers keep rings


@pytest.mark.parametrize("name", NAMES)
def test_param_count_full_config(name):
    ref, port = ARCHS[name], PORT_ARCHS[name]
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("name", NAMES)
def test_param_names_and_shapes(name):
    """Every reference leaf, unstacked, is one port parameter of its shape,
    and the two count the same parameters."""
    rcfg = reduced(ARCHS[name])
    tm = port_build(port_reduced(PORT_ARCHS[name]))
    shapes = jax.eval_shape(lambda: ref_build(rcfg).init(jax.random.PRNGKey(0)))
    ref_n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    state = lm_params_from_numpy(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes),
                                 tm.cfg)
    abstract = dict(tm.abstract_params().named_parameters())
    assert sorted(state) == sorted(abstract)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in abstract.items()}
    assert all(p.device.type == "meta" for p in abstract.values())
    assert sum(p.numel() for p in tm.load(state).parameters()) == ref_n


def _decode_batch(tokens, pos, b):
    return ({"tokens": jnp.asarray(tokens, jnp.int32), "positions": jnp.full((b,), pos, jnp.int32)},
            {"tokens": torch.from_numpy(np.array(tokens)), "positions": torch.full((b,), pos)})


def _run_both(name, bf16, tol):
    rm, params, tm, net = pair(name, bf16=bf16)
    cfg = rm.cfg
    rng = np.random.default_rng(3)
    rb, tb = batches(cfg, rng, B, S + STEPS)
    toks = np.asarray(rb["tokens"])

    want = np.asarray(jax.jit(lambda p, b: ref_forward(rm, p, b))(params, rb), np.float32)
    with torch.inference_mode():
        got = tm.forward(net, tb).float().numpy()
    np.testing.assert_allclose(got, want, **tol, err_msg="forward")

    rb["tokens"], tb["tokens"] = rb["tokens"][:, :S], tb["tokens"][:, :S]
    r_logits, r_cache = jax.jit(lambda p, b: rm.prefill(p, None, b))(params, rb)
    t_logits, t_cache = tm.prefill(net, tb)
    np.testing.assert_allclose(t_logits.float().numpy(), np.asarray(r_logits, np.float32), **tol,
                               err_msg="prefill")
    assert_caches_close(cfg, r_cache, t_cache, msg="prefill", **tol)

    r_cache = ref_grow_cache(r_cache, S, S + STEPS)
    t_cache = grow_cache(t_cache, S, S + STEPS)
    r_decode = jax.jit(lambda p, b, c: rm.decode(p, None, b, c))
    for step in range(STEPS):
        rd, td = _decode_batch(toks[:, S + step:S + step + 1], S + step, B)
        r_logits, r_cache = r_decode(params, rd, r_cache)
        t_logits, t_cache = tm.decode(net, td, t_cache)
        np.testing.assert_allclose(t_logits.float().numpy(), np.asarray(r_logits, np.float32),
                                   **tol, err_msg=f"decode step {step}")
        assert_caches_close(cfg, r_cache, t_cache, msg=f"decode step {step}", **tol)


@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_decode_match_reference(name):
    _run_both(name, bf16=False, tol=TOL)


def test_bf16_glm4_matches_reference():
    """Reduced glm4-9b in bfloat16: both packages round each activation to
    bfloat16 (8 significant bits) between ops but sum in other orders, so
    a value may differ by an ulp, 2**-7 of it, and so may the logits: the
    largest difference here is 2**-5, one ulp of a logit in [4, 8).
    rtol = atol = 3e-2 allows about two ulps."""
    _run_both("glm4-9b", bf16=True, tol=dict(rtol=3e-2, atol=3e-2))
