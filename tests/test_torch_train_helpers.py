"""Shared pieces of the training port's parity tests
(``tests/test_torch_train_*.py``; this module holds no test): seeded train
batches for both packages, the reference's train step compiled with its own
bfloat16 roundings, and the one-step comparison against it (the rule is in
``test_torch_train_rule``).

The reference's step with ``cast_bf16=True`` rounds every rank >= 2 leaf to
bfloat16 before the forward, so each such leaf's gradient is rounded to
bfloat16 on its way back to the float32 master. XLA may skip a rounding
where casts fuse (``xla_allow_excess_precision``, on by default): on the CPU
it sums a tied embedding's two bfloat16 gradients in float32 and does not
round the sum. :func:`ref_step` compiles the step with that option off, so
the reference rounds where its program says it does, as the port does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.training.optimizer import OptConfig as RefOptConfig, adamw_init as ref_adamw_init
from repro.training.train import make_train_step as ref_make_train_step
from repro_torch.convert import lm_params_from_numpy
from repro_torch.training import OptConfig, adamw_init, make_train_step
from test_torch_lm_helpers import batches, pair
from test_torch_train_rule import assert_moments_close, assert_params_close

B, S = 2, 20  # the batch of the one-step tests


def train_batches(cfg, seed: int, b: int, s: int, ignore: bool = True):
    """(ref batch, port batch): ``batches``' tokens and frontend input, and
    labels drawn from the same generator; with ``ignore`` a few are -1."""
    rng = np.random.default_rng(seed)
    rb, tb = batches(cfg, rng, b, s)
    labels = rng.integers(0, cfg.vocab, (b, s))
    if ignore:
        labels[0, :3] = -1
    rb["labels"] = jnp.asarray(labels, jnp.int32)
    tb["labels"] = torch.from_numpy(labels)
    return rb, tb


def to_port(tree, cfg) -> dict:
    """A reference pytree (parameters, gradients, moments) under the port's names."""
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), cfg)


def ref_step(model, params, batch, opt_cfg: RefOptConfig, grad_accum: int = 1,
             opt_state=None, cast_bf16: bool = True):
    """One reference train step, compiled without excess precision: (new
    params, new opt state, metrics)."""
    step = ref_make_train_step(model, opt_cfg, grad_accum=grad_accum, cast_bf16=cast_bf16)
    opt_state = ref_adamw_init(params) if opt_state is None else opt_state
    compiled = step.lower(params, opt_state, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(params, opt_state, batch)


def port_step(tm, net, tb, grad_accum=1, cast_bf16=True):
    step = make_train_step(tm, OptConfig(warmup_steps=1), grad_accum=grad_accum,
                           cast_bf16=cast_bf16)
    opt = adamw_init(dict(net.named_parameters()))
    return step(net, opt, tb)


def assert_matches_reference(name, grad_accum, batch, cast_bf16=True):
    rm, params, tm, net = pair(name)
    rb, tb = train_batches(rm.cfg, 5, batch, S)
    r_params, r_opt, r_met = ref_step(rm, params, rb, RefOptConfig(warmup_steps=1),
                                      grad_accum=grad_accum, cast_bf16=cast_bf16)
    opt, met = port_step(tm, net, tb, grad_accum=grad_accum, cast_bf16=cast_bf16)
    assert abs(float(met["loss"]) - float(r_met["loss"])) <= 1e-5
    gn, r_gn = float(met["grad_norm"]), float(r_met["grad_norm"])
    assert abs(gn - r_gn) <= 1e-5 * r_gn, (gn, r_gn)
    assert float(met["lr"]) == float(r_met["lr"])
    assert int(opt["step"]) == int(r_opt["step"]) == 1
    r_m, r_v = to_port(r_opt["m"], tm.cfg), to_port(r_opt["v"], tm.cfg)
    flips = assert_moments_close(opt["m"], r_m, "m", ulps=1 if cast_bf16 else 0)
    flips += assert_moments_close(opt["v"], r_v, "v", ulps=2 if cast_bf16 else 0)
    moved = assert_params_close(dict(net.named_parameters()), to_port(r_params, tm.cfg), opt,
                                {"m": r_m, "v": r_v}, float(r_met["lr"]), 1)
    print(f"{name}: {flips} moment entries at one bf16 ulp, {moved} parameter entries "
          f"apart by more than 1e-6 (as their moments' update gives)")
    for name_, t in met.items():
        assert t.device == net.embed.embedding.device, name_


def port_grads(tm, net, tb, remat=True) -> tuple[float, dict]:
    """The port's loss and its gradients by parameter name."""
    for p in net.parameters():
        p.grad = None
    loss = tm.train_loss(net, tb, remat=remat)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    for p in net.parameters():
        p.grad = None
    return float(loss.detach()), grads


def assert_loss_and_grads_match(name):
    """``Model.train_loss`` within 1e-5 of the reference's and every gradient
    within 1e-4 of its leaf's largest |g| (``test_torch_train_models``)."""
    rm, params, tm, net = pair(name)
    rb, tb = train_batches(rm.cfg, 5, B, S)
    r_loss, r_grads = jax.jit(jax.value_and_grad(lambda p, b: rm.train_loss(p, None, b)))(
        params, rb)
    loss, grads = port_grads(tm, net, tb)
    assert abs(loss - float(r_loss)) <= 1e-5, (loss, float(r_loss))
    want = to_port(r_grads, tm.cfg)
    assert sorted(want) == sorted(grads)
    for n, w in want.items():
        scale = float(w.abs().max())
        err = float((grads[n] - w).abs().max())
        assert err <= 1e-4 * scale, f"{n}: {err:.3g} > 1e-4 * {scale:.3g}"
