"""The LM scaffold over a mesh on a card, at reduced size (the checks of
``chip_smoke.py``'s phase dist, small): the plan step of each of the ten
reduced architectures on a 2x2 mesh of ``cuda:0`` entries against the same
step on a 2x2 mesh of CPU entries (``test_torch_train_rule``: the loss
within 1e-5, the gradient norm within 1e-5 relative, the moments within
1e-4 of each leaf's largest but for at most 0.1% of entries within one (m)
or two (v) bf16 ulps, the parameters within 1e-6 of what each side's own
moments give); a 1x1 card mesh equal to the single-device step bit for
bit; the compressed step within the reference test's bounds of the exact
step without the bf16 cast (loss 1e-4, parameters 5e-3, a parameter moved
by more than 1e-6), and its reduced gradient, read back from its moments,
within each leaf's int8 step of the exact step's, where the reference's
biased reduce and the sum without the division must fail
(``test_torch_dist_helpers.reduce_error``); sequence-
sharded decode attention within 2e-5 of ``decode_attention``; the pipeline
within 1e-5 of the sequential stack; and ``--mesh host --device cuda:0``
resumed. TF32 stays off. Marked ``gpu``; every test skips where torch sees
no CUDA card (run them there with ``python -m pytest -m gpu
tests/test_torch_gpu_dist.py``)."""

import json
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.elastic import gather, place, redistribute
from repro_torch.distributed.pipeline import pipeline_forward
from repro_torch.distributed.sharding import make_plan
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import mesh_from_shape, mesh_from_spec
from repro_torch.launch.serve import make_batch
from repro_torch.models.layers.attention import decode_attention
from repro_torch.models.zoo import build
from repro_torch.serving.decode_attn import seq_sharded_decode_attention
from repro_torch.training import OptConfig, adamw_init, make_train_step
from repro_torch.training import train as train_mod
from repro_torch.training.train import make_compressed_dp_step, sharded_adamw_init
from test_torch_dist_helpers import (CONTROLS, assert_replicas_identical, assert_step_matches,
                                     reduce_error, row_steps)

pytestmark = pytest.mark.gpu

B, S = 4, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _batch(cfg, seed=3):
    batch = make_batch(cfg, np.random.default_rng(seed), B, S)
    labels = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (B, S))
    labels[0, :3] = -1
    batch["labels"] = torch.from_numpy(labels)
    return batch


def _mesh(spec, dev):
    d, m = (int(p) for p in spec.split("x"))
    return mesh_from_spec(spec, devices=[dev] * (d * m))


def _plan_step(model, net, batch, spec, dev):
    plan = make_plan(_mesh(spec, dev))
    params = redistribute(net, plan)
    opt = sharded_adamw_init(params, plan)
    step, _ = make_train_step(model, OptConfig(warmup_steps=1), plan)
    return step(params, opt, batch)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_plan_step_card_equals_cpu(cuda, name):
    cfg = reduced(ARCHS[name])
    model = build(cfg)
    net = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    params, opt, met = _plan_step(model, net, batch, "2x2", cuda)
    assert params["final_norm"].shards[0, 0].device.type == "cuda"
    assert assert_replicas_identical(params) > 0
    p_cpu, o_cpu, m_cpu = _plan_step(model, net, batch, "2x2", torch.device("cpu"))
    want = {"params": gather(p_cpu), "m": gather(o_cpu["m"]), "v": gather(o_cpu["v"]),
            "loss": float(m_cpu["loss"]), "grad_norm": float(m_cpu["grad_norm"])}
    assert_step_matches(params, opt, met, want, float(m_cpu["lr"]))


@pytest.mark.parametrize("name", ["glm4-9b", "granite-moe-1b-a400m", "mamba2-370m"])
def test_one_by_one_card_mesh_is_the_single_device_step(cuda, name):
    cfg = reduced(ARCHS[name])
    model = build(cfg)
    net = model.init(torch.Generator(cuda).manual_seed(0), cuda)
    batch = {k: v.to(cuda) for k, v in _batch(cfg).items()}
    params, opt, met = _plan_step(model, net, batch, "1x1", cuda)
    o, m = make_train_step(model, OptConfig(warmup_steps=1))(
        net, adamw_init(dict(net.named_parameters())), batch)
    assert all(torch.equal(met[k], m[k]) for k in ("loss", "grad_norm", "lr"))
    got = gather(params, cuda)
    for n, p in net.named_parameters():
        assert torch.equal(got[n], p.detach()), n


def _compressed_card_step(cuda):
    """(model, net, batch, mesh, compressed step's (params, opt, metrics),
    its starting weights): reduced glm4-9b, the reference test's batch
    shape and configuration, on 8x1 card entries."""
    cfg = reduced(ARCHS["glm4-9b"])
    model = build(cfg)
    net = model.init(torch.Generator(cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (8, 16)), device=cuda)
             for k in ("tokens", "labels")}
    mesh = _mesh("8x1", cuda)
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    params = {n: place(t, mesh, ()) for n, t in start.items()}
    opt = {"m": {n: s.map(torch.zeros_like) for n, s in params.items()},
           "v": {n: s.map(torch.zeros_like) for n, s in params.items()},
           "step": place(torch.zeros((), dtype=torch.int32), mesh, ())}
    out = make_compressed_dp_step(model, COMPRESSED_OPT, mesh, ("data",))(
        params, opt, batch, torch.Generator(cuda).manual_seed(42))
    return model, net, batch, mesh, out, start


COMPRESSED_OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def test_compressed_step_on_the_card(cuda):
    model, net, batch, _, (params, _, m2), start = _compressed_card_step(cuda)
    # the exact step without the bf16 cast, as the compressed step reads
    # the weights: on the card the cast alone moves this loss by 1.6e-4
    _, m1 = make_train_step(model, COMPRESSED_OPT, cast_bf16=False)(
        net, adamw_init(dict(net.named_parameters())), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    diffs = [float((params[n].shards[0, 0] - p.detach()).abs().max())
             for n, p in net.named_parameters()]
    assert max(diffs) < 5e-3
    assert max(float((params[n].shards[0, 0] - start[n]).abs().max()) for n in start) > 1e-6


@pytest.mark.parametrize("reduce", sorted(CONTROLS))
def test_compressed_reduce_on_the_card(cuda, monkeypatch, reduce):
    if CONTROLS[reduce] is not None:
        monkeypatch.setattr(train_mod, "compressed_psum", CONTROLS[reduce])
    model, net, batch, mesh, (_, c_opt, c_met), _ = _compressed_card_step(cuda)
    plan = make_plan(mesh)
    params = redistribute(net, plan)
    exact, _ = make_train_step(model, COMPRESSED_OPT, plan, cast_bf16=False)
    _, e_opt, e_met = exact(params, sharded_adamw_init(params, plan), batch)
    err = reduce_error({n: s.shards[0, 0] for n, s in c_opt["m"].items()},
                       float(c_met["grad_norm"]), gather(e_opt["m"], cuda),
                       float(e_met["grad_norm"]), row_steps(model, net, batch, 8),
                       COMPRESSED_OPT)
    assert err <= 1.0 if reduce == "port" else err > 1.0, err


@pytest.mark.parametrize("window", [0, 24])
def test_seq_sharded_decode_attention_on_the_card(cuda, window):
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((2, 1, 8, 64), generator=g, device=cuda)
    k = torch.randn((2, 1024, 4, 64), generator=g, device=cuda)
    v = torch.randn((2, 1024, 4, 64), generator=g, device=cuda)
    lengths = torch.tensor([700, 1024], device=cuda)
    mesh = mesh_from_shape((8,), ("data",), [cuda] * 8)
    out = seq_sharded_decode_attention(mesh, window=window)(q, k, v, lengths)
    want = decode_attention(q, k, v, lengths, window=window)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


def test_pipeline_on_the_card(cuda):
    g = torch.Generator(cuda).manual_seed(0)
    w = torch.randn((4, 64, 64), generator=g, device=cuda) * 0.1
    x = torch.randn((32, 64), generator=g, device=cuda)
    stage = lambda p, xb: torch.tanh(xb @ p["w"])
    y = pipeline_forward(mesh_from_shape((4,), ("stage",), [cuda] * 4), stage, n_micro=8)(
        {"w": w}, x)
    ref = x
    for s in range(4):
        ref = torch.tanh(ref @ w[s])
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)


def test_cli_host_mesh_on_the_card(cuda, tmp_path):
    base = ["--arch", "glm4-9b", "--reduced", "--mesh", "host", "--device", "cuda:0",
            "--steps", "4", "--ckpt-every", "2", "--batch", "8", "--seq", "16"]
    train_cli.main([*base, "--ckpt-dir", str(tmp_path / "a"), "--out", str(tmp_path / "a.json")])
    full = json.loads((tmp_path / "a.json").read_text())
    assert full["mesh"] == {"shape": {"data": 4, "model": 2}, "n_devices": 8}
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "ckpt_0000000004")
    train_cli.main([*base, "--ckpt-dir", str(tmp_path / "b"), "--resume", "--out",
                    str(tmp_path / "b.json")])
    resumed = json.loads((tmp_path / "b.json").read_text())
    assert resumed["start_step"] == 2 and resumed["losses"] == full["losses"][2:]
