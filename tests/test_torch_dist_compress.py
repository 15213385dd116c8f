"""int8 gradient compression (``repro_torch.training.compression``) and the
compressed data-parallel step (``make_compressed_dp_step``) on the CPU.

* ``quantize_int8``: the reference's two tests, on the port: over 256 seeded
  draws the mean of the dequantized values is within 0.35 of a step of the
  input (stochastic rounding is unbiased), and one draw's error is at most
  ``scale * 1.0001``.
* Unequal shard scales: two data entries hold N(0, 1) and 0.01 N(0, 1)
  gradients (512 each). Over 256 draws the port's ``compressed_psum`` mean
  is within 0.35 of the shared step of the true mean. The reference's reduce
  (``src/repro/training/compression.py:54-59``: each shard quantizes at its
  own scale, the int32 sum is dequantized at the max) on the same gradients
  in a subprocess on 2 forced host devices misses the true mean by more
  than 20 shared steps, and its error follows the small shard's gradient
  (correlation above 0.99): the fault the port keeps out.
* The compressed step on 8x1 CPU entries against the exact single-device
  step (reduced glm4-9b, B = 8, S = 16, ``OptConfig(lr=1e-3,
  warmup_steps=1, total_steps=10)``: the reference test's weights, batch
  and configuration), the reference test's bounds: the loss
  within 1e-4, the parameters within 5e-3, and at least one parameter moved
  by more than 1e-6. Those bounds cannot fail: Adam's first step moves
  every parameter by about lr whatever the gradient, and the loss is taken
  before the update.
* So the reduce itself is held: on the same mesh, weights and batch, the
  compressed step's reduced gradient, read back from its first moments and
  its gradient norm, against the exact plan step's without the bf16 cast
  (the same eight rows, summed in float32). Each element lies within its
  leaf's shared int8 step (1 + 1e-3), plus 1e-5 of the leaf's largest,
  and the norms within the norm of those bounds
  (``test_torch_dist_helpers.reduce_error``). Two controls must fail the
  same check: the reference's biased reduce, and the sum without the
  division by the number of entries.
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed.elastic import gather, place, redistribute
from repro_torch.distributed.sharding import make_plan
from repro_torch.launch.mesh import mesh_from_spec
from repro_torch.training import OptConfig, adamw_init, make_train_step
from repro_torch.training import train as train_mod
from repro_torch.training.compression import compressed_psum, dequantize_int8, quantize_int8
from repro_torch.training.train import make_compressed_dp_step, sharded_adamw_init
from test_torch_dist_helpers import CONTROLS, reduce_error, row_steps, run_reference
from test_torch_lm_helpers import pair

DRAWS = 256


def test_quantization_unbiased():
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(512).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    mean = torch.stack([dequantize_int8(*quantize_int8(g, gen)) for _ in range(DRAWS)]).mean(0)
    scale = float(g.abs().max() / 127.0)
    np.testing.assert_allclose(mean.numpy(), g.numpy(), atol=scale * 0.35)


def test_quantization_error_bounded():
    g = torch.as_tensor(np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32) * 5)
    q, scale = quantize_int8(g, torch.Generator().manual_seed(1))
    assert q.dtype == torch.int8
    assert float((dequantize_int8(q, scale) - g).abs().max()) <= float(scale) * 1.0001


def _unequal():
    rng = np.random.default_rng(7)
    return (rng.standard_normal(512).astype(np.float32),
            0.01 * rng.standard_normal(512).astype(np.float32))


_REF = r"""
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
import jax.numpy as jnp
from repro.training.compression import quantize_int8

mesh = auto_mesh((2,), ("data",))
g = jnp.asarray(np.stack(IN))  # (2, 512): shard i holds row i


def local(g, key):
    # the reference's reduce, as compression.py:54-59 writes it
    q, scale = quantize_int8(g[0], key)
    scale = jax.lax.pmax(scale, ("data",))
    q32 = jax.lax.psum(q.astype(jnp.int32), ("data",))
    return (q32.astype(jnp.float32) * scale / 2)[None]


fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"), P()), out_specs=P("data"),
                       check_rep=False))
outs = [np.asarray(fn(g, k))[0] for k in jax.random.split(jax.random.PRNGKey(0), DRAWS)]
OUT["mean"] = np.mean(np.stack(outs), axis=0)
"""


def test_unequal_shard_scales_port_unbiased_reference_biased(tmp_path):
    g0, g1 = _unequal()
    true = (g0 + g1) / 2
    step = float(np.abs(g0).max() / 127.0)  # the shared scale
    mesh = mesh_from_spec("2x1", devices=["cpu"] * 2)
    reduce = compressed_psum(mesh, ("data",))
    gen = torch.Generator().manual_seed(0)
    grads = [{"g": torch.as_tensor(g0)}, {"g": torch.as_tensor(g1)}]
    runs = [reduce(grads, gen) for _ in range(DRAWS)]
    assert all(torch.equal(r[0]["g"], r[1]["g"]) for r in runs)
    port = torch.stack([r[0]["g"] for r in runs]).mean(0).numpy()
    np.testing.assert_allclose(port, true, atol=step * 0.35)

    ref = run_reference(f"DRAWS = {DRAWS}\n" + _REF, tmp_path, n_devices=2,
                        inputs=[g0, g1])["mean"]
    err = ref - true
    assert np.abs(err).max() > 20 * step, np.abs(err).max()
    assert np.corrcoef(err, g1)[0, 1] > 0.99
    print(f"reference mean error {np.abs(err).max():.3f} (max), port "
          f"{np.abs(port - true).max():.4f}, shared step {step:.4f}")


OCFG = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def _step_batch(cfg):
    rng = np.random.default_rng(0)  # the reference test's weights and batch
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (8, 16))) for k in ("tokens", "labels")}


def _compressed_step(tm, start: dict, tb: dict, mesh):
    params = {n: place(t, mesh, ()) for n, t in start.items()}
    opt = {"m": {n: place(torch.zeros_like(t), mesh, ()) for n, t in start.items()},
           "v": {n: place(torch.zeros_like(t), mesh, ()) for n, t in start.items()},
           "step": place(torch.zeros((), dtype=torch.int32), mesh, ())}
    step = make_compressed_dp_step(tm, OCFG, mesh, ("data",))
    return step(params, opt, tb, torch.Generator().manual_seed(42))


def test_compressed_step_against_exact_step():
    _, _, tm, net = pair("glm4-9b")
    tb = _step_batch(tm.cfg)
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    mesh = mesh_from_spec("8x1", devices=["cpu"] * 8)
    params, opt, m2 = _compressed_step(tm, start, tb, mesh)
    _, m1 = make_train_step(tm, OCFG)(net, adamw_init(dict(net.named_parameters())), tb)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    got = gather(params)
    diffs = [float((got[n] - p.detach()).abs().max()) for n, p in net.named_parameters()]
    assert max(diffs) < 5e-3, max(diffs)
    assert max(float((got[n] - start[n]).abs().max()) for n in start) > 1e-6
    # every replica took the same update
    for n, s in params.items():
        assert all(torch.equal(s.shards[c], s.shards[0, 0]) for c in s.coords()), n
    assert int(opt["step"].shards[7, 0]) == 1


@pytest.mark.parametrize("reduce", sorted(CONTROLS))
def test_compressed_step_reduces_to_the_exact_mean(monkeypatch, reduce):
    _, _, tm, net = pair("glm4-9b")
    tb = _step_batch(tm.cfg)
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    mesh = mesh_from_spec("8x1", devices=["cpu"] * 8)
    plan = make_plan(mesh)
    params = redistribute(net, plan)
    exact, _ = make_train_step(tm, OCFG, plan, cast_bf16=False)
    _, e_opt, e_met = exact(params, sharded_adamw_init(params, plan), tb)
    if CONTROLS[reduce] is not None:
        monkeypatch.setattr(train_mod, "compressed_psum", CONTROLS[reduce])
    _, c_opt, c_met = _compressed_step(tm, start, tb, mesh)
    err = reduce_error({n: s.shards[0, 0] for n, s in c_opt["m"].items()},
                       float(c_met["grad_norm"]), gather(e_opt["m"]),
                       float(e_met["grad_norm"]), row_steps(tm, net, tb, 8), OCFG)
    if reduce == "port":
        assert err <= 1.0, err
    else:  # the control is caught
        assert err > 1.0, err
    print(f"{reduce}: reduce error {err:.3g} of its bound")
