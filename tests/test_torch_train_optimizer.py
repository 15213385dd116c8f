"""The port's AdamW against the reference's on the same numpy inputs
(float32, rtol 1e-6 and an absolute floor of 1e-7 for entries near zero):
four steps of parameters, moments and metrics, clipping, the schedule over
every step of a run, and the global norm. The counterparts of
``tests/test_optimizer.py``, held to the reference instead of numpy.
Weight decay follows the names it is given, not the port's tensor rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.optimizer import (OptConfig as RefOptConfig, adamw_init as ref_adamw_init,
                                      adamw_update as ref_adamw_update,
                                      global_norm as ref_global_norm, lr_at as ref_lr_at)
from repro_torch.training import OptConfig, adamw_init, adamw_update, global_norm, lr_at

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"w": (4, 5), "b": (5,), "stack": (3, 6)}


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                                          else got, np.float32),
                               np.asarray(want, np.float32), err_msg=msg, **TOL)


@pytest.mark.parametrize("clip_norm", [10.0, 0.5])
def test_adamw_matches_reference(clip_norm):
    """Four steps; with clip_norm 0.5 every step clips. The reference decays
    its rank >= 2 leaves; the port is told the same names."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100, clip_norm=clip_norm)
    rcfg, cfg = RefOptConfig(**kw), OptConfig(**kw)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    rparams = jax.tree.map(jnp.asarray, params)
    ropt = ref_adamw_init(rparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = adamw_init(tparams)
    decay = {k for k, s in SHAPES.items() if len(s) >= 2}
    for step in range(1, 5):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        rparams, ropt, rmet = ref_adamw_update(jax.tree.map(jnp.asarray, grads), ropt, rparams,
                                               rcfg)
        topt, tmet = adamw_update({k: torch.from_numpy(v) for k, v in grads.items()}, topt,
                                  tparams, cfg, decay)
        assert int(topt["step"]) == int(ropt["step"]) == step
        _close(tmet["grad_norm"], rmet["grad_norm"], "grad_norm")
        _close(tmet["lr"], rmet["lr"], "lr")
        for k in params:
            _close(tparams[k], rparams[k], f"param {k} step {step}")
            _close(topt["m"][k], ropt["m"][k], f"m {k} step {step}")
            _close(topt["v"][k], ropt["v"][k], f"v {k} step {step}")


def test_clipping_engages():
    cfg = OptConfig(lr=1e-3, clip_norm=0.5, warmup_steps=0, total_steps=10)
    p1 = {"w": torch.ones(3, 3)}
    _, m1 = adamw_update({"w": torch.full((3, 3), 100.0)}, adamw_init(p1), p1, cfg, {"w"})
    p2 = {"w": torch.ones(3, 3)}
    small = {"w": torch.full((3, 3), 100.0) * 0.5 / float(m1["grad_norm"])}
    adamw_update(small, adamw_init(p2), p2, cfg, {"w"})
    torch.testing.assert_close(p1["w"], p2["w"], rtol=1e-5, atol=0)
    rp = {"w": jnp.ones((3, 3))}
    rp1, _, _ = ref_adamw_update({"w": jnp.full((3, 3), 100.0)}, ref_adamw_init(rp), rp,
                                 RefOptConfig(lr=1e-3, clip_norm=0.5, warmup_steps=0,
                                              total_steps=10))
    _close(p1["w"], rp1["w"])


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 6), (0, 10), (100, 10_000)])
def test_lr_schedule_matches_reference(warmup, total):
    kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=total, min_lr_frac=0.1)
    rcfg, cfg = RefOptConfig(**kw), OptConfig(**kw)
    steps = sorted(set(range(0, min(total, 200) + 2)) | {total, total + 5})
    got = lr_at(cfg, torch.tensor(steps, dtype=torch.int32))
    want = ref_lr_at(rcfg, jnp.asarray(steps, jnp.int32))
    _close(got, want)
    assert float(lr_at(cfg, torch.tensor(0))) == 0.0 or warmup == 0
    assert abs(float(lr_at(cfg, torch.tensor(total))) - 0.1 * 3e-3) < 1e-9


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    _close(global_norm({k: torch.from_numpy(v) for k, v in tree.items()}),
           ref_global_norm(jax.tree.map(jnp.asarray, tree)))


def test_decay_follows_names_not_rank():
    """A 1-D leaf named in ``decay`` decays (a grouped layer's norm scale in
    the reference's stacked layout); a 2-D leaf not named does not."""
    cfg = OptConfig(lr=1e-2, weight_decay=0.5, warmup_steps=0, total_steps=10)
    params = {"norm": torch.full((4,), 2.0), "mat": torch.full((2, 2), 2.0)}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    adamw_update(zeros, adamw_init(params), params, cfg, {"norm"})
    lr = float(lr_at(cfg, torch.tensor(1)))
    torch.testing.assert_close(params["norm"], torch.full((4,), 2.0 - lr * 0.5 * 2.0))
    torch.testing.assert_close(params["mat"], torch.full((2, 2), 2.0))


def test_moments_float32_for_bf16_params():
    params = {"w": torch.ones(3, 3, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt["m"]["w"].dtype == opt["v"]["w"].dtype == torch.float32
    assert opt["step"].dtype == torch.int32
    adamw_update({"w": torch.ones(3, 3, dtype=torch.bfloat16)}, opt, params, OptConfig(), {"w"})
    assert params["w"].dtype == torch.bfloat16
