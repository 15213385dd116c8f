"""The sharding plan's ZeRO-3 train step (``make_train_step(model, opt_cfg,
plan)``) on meshes of CPU entries.

* On a 4x2 mesh, one step of reduced glm4-9b, granite-moe-1b-a400m,
  deepseek-v2-lite-16b and mamba2-370m (B = 4, S = 10: one sequence per
  data row, 40 tokens as in the single-device tests: at 128 tokens over the
  reduced 128-word vocabulary the single-device steps already part by
  1.4e-5 in the gradient norm, through the tied table's per-token rounding
  that the single-device step keeps on purpose),
  ``OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)``, ``cast_bf16``)
  against the reference's sharded step on an ``Auto`` 4x2 mesh of 8 forced
  host devices (one subprocess, compiled without excess precision), from
  the same weights and batch. The MoE routes one group per data entry on
  both sides (the reference's single-device step routes one group in all,
  so it is not the target). Tolerances, ``test_torch_train_rule``'s: the
  loss within 1e-5, the gradient norm within 1e-5 relative, the moments
  within 1e-4 of each leaf's largest but for at most 0.1% of entries within
  one (m) or two (v) bf16 ulps of the leaf's largest, the parameters within
  1e-6 of what each side's own moments give.
* B = 6 on dp = 4: the data axis does not divide the batch, so both sides
  replicate it and route granite-moe-1b-a400m's tokens in 4 groups of 24;
  the plan's fallbacks gain the two batch leaves, as the reference's do.
  The port computes the batch once on the first row, the reference over
  its devices: the tied table's gradient then differs at one bf16 ulp in 59
  of its 8,192 entries (inside the moments' allowance), which moves the
  gradient norm by 1.7e-5 relative. So the norm is held within 5e-5 here
  (the port's and the reference's single-device steps on this batch agree
  to 3.2e-6).
* ``grad_accum=2`` with a plan (reduced glm4-9b on 2x2) against the
  single-device step with ``grad_accum=2``, under the same rule.
* granite-moe-1b-a400m at full width (d_model 1,024, 32 experts of 512,
  top 8, the 49,155-word tied table that falls back to replication on the
  `model` axis), cut to 1 layer with float32 activations, B = 2, S = 16:
  the port's plan step on 2x2 CPU entries against the reference's sharded
  step on an ``Auto`` 2x2 mesh of 4 forced host devices, under the same
  rule. The card runs this model at full width and depth on 2x2 and 2x1,
  which share their data rows and so their arithmetic; this holds the
  two-row path at full width against code that is not the port's. Both
  steps run in one subprocess, so only the comparison's numbers come back.
* A 1x1 mesh equals the single-device step bit for bit, for the ten
  reduced architectures; 2x1, 2x2 and 2x4 (the same data rows) give the
  same bits; after a 4x2 step every replicated slice of the parameters and
  moments is bit-identical across its entries.
"""

import pytest
import torch

from repro_torch.distributed.elastic import gather, redistribute
from repro_torch.distributed.sharding import make_plan
from repro_torch.training import OptConfig, adamw_init, make_train_step
from repro_torch.training.train import sharded_adamw_init
from test_torch_dist_helpers import (assert_replicas_identical, assert_step_matches, cpu_mesh,
                                     run_reference)
from test_torch_lm_helpers import NAMES, pair
from test_torch_train_helpers import train_batches

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
CASES = [("glm4-9b", 4, 10), ("granite-moe-1b-a400m", 4, 10), ("deepseek-v2-lite-16b", 4, 10),
         ("mamba2-370m", 4, 10), ("granite-moe-1b-a400m", 6, 16)]

_REF = r"""
from repro.distributed.sharding import make_plan
from repro.training.optimizer import OptConfig, adamw_init
from repro.training.train import make_train_step
from test_torch_lm_helpers import pair
from test_torch_train_helpers import train_batches, to_port

mesh = auto_mesh((4, 2), ("data", "model"))
for name, b, s in CASES:
    rm, params, tm, _ = pair(name)
    rb, _ = train_batches(rm.cfg, 5, b, s)
    plan = make_plan(mesh)
    step_fn, shardings_for = make_train_step(rm, OptConfig(**OPT), plan)
    pspec, ospec = shardings_for(jax.eval_shape(lambda: rm.init(jax.random.PRNGKey(0))))
    bspec = plan.batch_shardings(rb)
    with jax.set_mesh(mesh):
        args = jax.device_put((params, adamw_init(params), rb), (pspec, ospec, bspec))
        step = jax.jit(step_fn, in_shardings=(pspec, ospec, bspec),
                       out_shardings=(pspec, ospec, None)).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        p, o, met = step(*args)
    OUT[(name, b, s)] = {"params": to_port(p, tm.cfg), "m": to_port(o["m"], tm.cfg),
                      "v": to_port(o["v"], tm.cfg), "loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]), "lr": float(met["lr"]),
                      "fallbacks": sorted(plan.fallbacks)}
"""


FULL = dict(name="granite-moe-1b-a400m", layers=1, b=2, s=16, mesh=(2, 2))

_FULL = r"""
import dataclasses
import torch
from repro.configs import ARCHS as REF_ARCHS
from repro.distributed.sharding import make_plan as ref_make_plan
from repro.models.zoo import build as ref_build
from repro.training.optimizer import OptConfig as RefOpt, adamw_init
from repro.training.train import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.elastic import redistribute
from repro_torch.distributed.sharding import make_plan
from repro_torch.models.zoo import build
from repro_torch.training import OptConfig, make_train_step
from repro_torch.training.train import sharded_adamw_init
from test_torch_dist_helpers import assert_step_matches, cpu_mesh
from test_torch_train_helpers import train_batches, to_port

cut = dict(n_layers=FULL["layers"], dtype="float32")
rcfg = dataclasses.replace(REF_ARCHS[FULL["name"]], **cut)
tcfg = dataclasses.replace(ARCHS[FULL["name"]], **cut)
rm, tm = ref_build(rcfg), build(tcfg)
params = rm.init(jax.random.PRNGKey(0))
net = tm.load(lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
rb, tb = train_batches(rcfg, 5, FULL["b"], FULL["s"])

mesh = auto_mesh(FULL["mesh"], ("data", "model"))
plan = ref_make_plan(mesh)
step_fn, shardings_for = ref_make_train_step(rm, RefOpt(**OPT), plan)
pspec, ospec = shardings_for(jax.eval_shape(lambda: rm.init(jax.random.PRNGKey(0))))
bspec = plan.batch_shardings(rb)
with jax.set_mesh(mesh):
    args = jax.device_put((params, adamw_init(params), rb), (pspec, ospec, bspec))
    step = jax.jit(step_fn, in_shardings=(pspec, ospec, bspec),
                   out_shardings=(pspec, ospec, None)).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    p, o, met = step(*args)
want = {"params": to_port(p, tcfg), "m": to_port(o["m"], tcfg), "v": to_port(o["v"], tcfg),
        "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
del p, o, args, params

tplan = make_plan(cpu_mesh("x".join(map(str, FULL["mesh"]))))
tparams = redistribute(net, tplan)
del net
tstep, _ = make_train_step(tm, OptConfig(**OPT), tplan)
tparams, topt, tmet = tstep(tparams, sharded_adamw_init(tparams, tplan), tb)
assert_step_matches(tparams, topt, tmet, want, float(met["lr"]))
OUT.update(loss=float(tmet["loss"]), ref_loss=want["loss"], grad_norm=float(tmet["grad_norm"]),
           ref_grad_norm=want["grad_norm"], fallbacks=sorted(plan.fallbacks),
           port_fallbacks=sorted(tplan.fallbacks), n_params=sum(t.numel() for t in want["params"].values()))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"CASES = {CASES!r}\nOPT = {OPT!r}\n" + _REF
    return run_reference(body, tmp_path_factory.mktemp("ref_step"))


def _placed_step(name, b, s, spec, **kw):
    """(params, opt, metrics, plan) of one plan step of the port on a mesh
    of CPU entries, from the reference's initial weights."""
    _, _, tm, net = pair(name)
    _, tb = train_batches(tm.cfg, 5, b, s)
    plan = make_plan(cpu_mesh(spec))
    params = redistribute(net, plan)
    opt = sharded_adamw_init(params, plan)
    step, _ = make_train_step(tm, OptConfig(**OPT), plan, **kw)
    params, opt, met = step(params, opt, tb)
    return params, opt, met, plan


@pytest.mark.parametrize("name", ["glm4-9b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
                                  "mamba2-370m"])
def test_sharded_step_matches_reference(reference, name):
    params, opt, met, plan = _placed_step(name, 4, 10, "4x2")
    want = reference[(name, 4, 10)]
    assert plan.fallbacks == [] == want["fallbacks"]
    assert float(met["lr"]) == want["lr"]
    assert_step_matches(params, opt, met, want, want["lr"])


def test_replicated_batch_routes_in_dp_groups(reference):
    name = "granite-moe-1b-a400m"
    params, opt, met, plan = _placed_step(name, 6, 16, "4x2")
    want = reference[(name, 6, 16)]
    _, tb = train_batches(pair(name)[2].cfg, 5, 6, 16)
    plan.batch_shardings(tb)  # the batch leaves fall back, as in the reference
    assert sorted(plan.fallbacks) == want["fallbacks"] == [
        "labels[dim0]=6 !% ('data',)", "tokens[dim0]=6 !% ('data',)"]
    assert_step_matches(params, opt, met, want, want["lr"], norm_tol=5e-5)
    # one group (the single-device step) routes differently: the loss moves
    _, _, tm, net = pair(name)
    _, one = make_train_step(tm, OptConfig(**OPT))(net, adamw_init(dict(net.named_parameters())),
                                                   tb)
    assert abs(float(one["loss"]) - float(met["loss"])) > 1e-4


def test_full_width_step_matches_reference(tmp_path):
    body = f"FULL = {FULL!r}\nOPT = {OPT!r}\n" + _FULL
    out = run_reference(body, tmp_path, n_devices=4)  # the rule is asserted in the subprocess
    assert out["port_fallbacks"] == out["fallbacks"] == ["embedding[dim0]=49155 !% model"]
    assert out["n_params"] > 100_000_000
    print(out)


def test_grad_accum_with_a_plan():
    name = "glm4-9b"
    params, opt, met, _ = _placed_step(name, 4, 10, "2x2", grad_accum=2)
    _, _, tm, net = pair(name)
    _, tb = train_batches(tm.cfg, 5, 4, 10)
    o, m = make_train_step(tm, OptConfig(**OPT), grad_accum=2)(
        net, adamw_init(dict(net.named_parameters())), tb)
    want = {"params": {n: p.detach() for n, p in net.named_parameters()}, "m": o["m"],
            "v": o["v"], "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    assert int(opt["step"].shards[0, 0]) == 1
    assert_step_matches(params, opt, met, want, float(m["lr"]))


@pytest.mark.parametrize("name", NAMES)
def test_one_by_one_mesh_is_the_single_device_step(name):
    params, opt, met, _ = _placed_step(name, 2, 10, "1x1")
    _, _, tm, net = pair(name)
    _, tb = train_batches(tm.cfg, 5, 2, 10)
    o, m = make_train_step(tm, OptConfig(**OPT))(net, adamw_init(dict(net.named_parameters())),
                                                 tb)
    for key in ("loss", "grad_norm", "lr"):
        assert torch.equal(met[key], m[key]), key
    got = gather(params)
    for n, p in net.named_parameters():
        assert torch.equal(got[n], p.detach()), n
        assert torch.equal(gather(opt["m"][n]), o["m"][n]), n
        assert torch.equal(gather(opt["v"][n]), o["v"][n]), n


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"])
def test_model_axis_changes_no_bit(name):
    """Two meshes with the same data rows (2x1, 2x2, 2x4) give the same bits:
    the `model` axis splits storage, and the clip norm is the summed
    gradient's whatever the split."""
    runs = [_placed_step(name, 4, 10, spec) for spec in ("2x1", "2x2", "2x4")]
    want = {k: gather(t) for k, t in (("p", runs[0][0]), ("m", runs[0][1]["m"]),
                                      ("v", runs[0][1]["v"]))}
    for params, opt, met, _ in runs[1:]:
        assert torch.equal(met["grad_norm"], runs[0][2]["grad_norm"])
        assert torch.equal(met["loss"], runs[0][2]["loss"])
        for k, t in (("p", params), ("m", opt["m"]), ("v", opt["v"])):
            got = gather(t)
            assert all(torch.equal(got[n], want[k][n]) for n in want[k]), k


@pytest.mark.parametrize("name", ["glm4-9b", "granite-moe-1b-a400m"])
def test_replicated_slices_stay_identical(name):
    params, opt, _, plan = _placed_step(name, 4, 10, "4x2")
    n = sum(assert_replicas_identical(t) for t in (params, opt["m"], opt["v"]))
    assert n > 0
    assert assert_replicas_identical({"step": opt["step"]}) == 7
    # every leaf's slices cover it once: the gathered tree has the logical shapes
    _, _, tm, net = pair(name)
    assert {k: v.shape for k, v in gather(params).items()} == \
        {k: v.shape for k, v in net.named_parameters()}
    pspec, ospec = make_train_step(tm, OptConfig(**OPT), plan)[1](tm.abstract_params())
    assert ospec == {"m": pspec, "v": pspec, "step": ()}
    assert {n: s.spec for n, s in params.items()} == pspec
