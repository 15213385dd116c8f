"""Gradient accumulation and the step's effect on the network: the port's
``grad_accum=2`` against the reference's ``grad_accum=2`` without the
bfloat16 cast (a sum of two rounded micro-batch gradients may cancel, so
one ulp of the sum does not bound it): the same rule with no ulp allowance.
And against the port's ``grad_accum=1`` on the same batch (float32 without
the cast, every label valid so that the two halves' means average to the
whole batch's): the loss, gradient norm, moments and parameters within 1e-5
of each leaf's largest.

Also: the step updates the float32 masters in place and leaves no gradient."""

import numpy as np
import pytest
import torch

from test_torch_lm_helpers import pair
from test_torch_train_helpers import B, S, assert_matches_reference, port_step, train_batches


@pytest.mark.parametrize("name", ["glm4-9b", "granite-moe-1b-a400m", "whisper-medium"])
def test_grad_accum_matches_reference(name):
    assert_matches_reference(name, 2, 2 * B, cast_bf16=False)


@pytest.mark.parametrize("name", ["glm4-9b", "granite-moe-1b-a400m", "whisper-medium"])
def test_grad_accum_equals_one_big_batch(name):
    _, _, tm, net_a = pair(name)
    _, _, _, net_b = pair(name)
    _, tb = train_batches(tm.cfg, 7, 2 * B, S, ignore=False)
    opt_a, met_a = port_step(tm, net_a, tb, grad_accum=2, cast_bf16=False)
    opt_b, met_b = port_step(tm, net_b, tb, grad_accum=1, cast_bf16=False)
    for key in ("loss", "grad_norm"):
        assert abs(float(met_a[key]) - float(met_b[key])) <= 1e-5 * abs(float(met_b[key]))
    pa, pb = dict(net_a.named_parameters()), dict(net_b.named_parameters())
    for what, a, b in (("m", opt_a["m"], opt_b["m"]), ("v", opt_a["v"], opt_b["v"]),
                       ("param", pa, pb)):
        for n in b:
            err = float((a[n] - b[n]).detach().abs().max())
            assert err <= 1e-5 * float(b[n].detach().abs().max()), f"{what} {n}: {err:.3g}"


def test_step_updates_masters_in_place_and_keeps_float32():
    _, _, tm, net = pair("gemma3-4b")
    _, tb = train_batches(tm.cfg, 8, B, S)
    before = {n: (p.data_ptr(), p.detach().clone()) for n, p in net.named_parameters()}
    opt, met = port_step(tm, net, tb)
    for n, p in net.named_parameters():
        assert p.dtype == torch.float32 and p.grad is None, n
        assert p.data_ptr() == before[n][0], n
        assert opt["m"][n].dtype == opt["v"][n].dtype == torch.float32
    moved = sum(int((p.detach() != before[n][1]).any()) for n, p in net.named_parameters())
    assert moved == len(before)
    assert np.isfinite(float(met["loss"]))
