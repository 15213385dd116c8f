"""Training on a card: one float32 step (``cast_bf16``) of each of the ten
reduced architectures on the card against the same step on the CPU, from
the same weights (``test_torch_train_rule``: the loss within 1e-5, the
gradient norm within 1e-5 relative, the moments within 1e-4 of each leaf's
largest but for at most 0.1% of entries within one bf16 ulp of the leaf's
largest, the parameters within 1e-6 of what each side's own moments give),
a bfloat16 step of
reduced granite-moe-1b-a400m that lowers the loss, and the train CLI on the
card (checkpointed, stopped and resumed: the same losses). TF32 stays off.
Marked ``gpu``; every test skips where torch sees no CUDA card (run them
there with ``python -m pytest -m gpu tests/test_torch_gpu_train.py``)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import make_batch
from repro_torch.models.zoo import build
from repro_torch.training import OptConfig, adamw_init, make_train_step
from test_torch_train_rule import assert_moments_close, assert_params_close

pytestmark = pytest.mark.gpu

B, S = 2, 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    batch = make_batch(cfg, rng, B, S)
    labels = rng.integers(0, cfg.vocab, (B, S))
    labels[0, :3] = -1
    batch["labels"] = torch.from_numpy(labels)
    return batch


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reduced_step_on_card_equals_cpu(cuda, name):
    model = build(reduced(ARCHS[name]))
    cpu_net = model.init(torch.Generator().manual_seed(0))
    card_net = model.load({k: v.to(cuda, copy=True) for k, v in cpu_net.state_dict().items()})
    batch = _batch(model.cfg)
    step = make_train_step(model, OptConfig(warmup_steps=1))
    res = {}
    for label, net, dev in (("cpu", cpu_net, torch.device("cpu")), ("card", card_net, cuda)):
        opt, met = step(net, adamw_init(dict(net.named_parameters())),
                        {k: v.to(dev) for k, v in batch.items()})
        assert all(t.device.type == dev.type for t in met.values())
        res[label] = (net, opt, {k: float(v) for k, v in met.items()})
    (cn, co, cm), (gn, go, gm) = res["cpu"], res["card"]
    assert abs(gm["loss"] - cm["loss"]) <= 1e-5
    assert abs(gm["grad_norm"] - cm["grad_norm"]) <= 1e-5 * cm["grad_norm"]
    assert gm["lr"] == cm["lr"]
    assert_moments_close(go["m"], co["m"], "m", ulps=1)
    assert_moments_close(go["v"], co["v"], "v", ulps=2)
    assert_params_close(dict(gn.named_parameters()), dict(cn.named_parameters()), go, co,
                        cm["lr"], 1)


def test_bf16_moe_step_lowers_loss(cuda):
    cfg = dataclasses.replace(reduced(ARCHS["granite-moe-1b-a400m"]), dtype="bfloat16")
    model = build(cfg)
    net = model.init(torch.Generator(cuda).manual_seed(0), cuda)
    batch = {k: v.to(cuda) for k, v in _batch(cfg).items()}
    step = make_train_step(model, OptConfig(lr=1e-2, warmup_steps=1, total_steps=10))
    opt = adamw_init(dict(net.named_parameters()))
    opt, met = step(net, opt, batch)
    with torch.no_grad():
        after = float(model.train_loss(net, batch))
    assert np.isfinite(float(met["loss"])) and after < float(met["loss"])
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_train_cli_resume_on_card(cuda, tmp_path):
    args = ["--arch", "glm4-9b", "--reduced", "--steps", "6", "--ckpt-every", "3",
            "--batch", "2", "--seq", "16"]
    train_cli.main([*args, "--ckpt-dir", str(tmp_path / "a"), "--out", str(tmp_path / "a.json")])
    train_cli.main([*args, "--ckpt-dir", str(tmp_path / "b")])
    for p in (tmp_path / "b" / "ckpt_0000000006").iterdir():
        p.unlink()
    (tmp_path / "b" / "ckpt_0000000006").rmdir()
    train_cli.main([*args, "--ckpt-dir", str(tmp_path / "b"), "--resume",
                    "--out", str(tmp_path / "b.json")])
    full, resumed = (json.loads((tmp_path / f).read_text()) for f in ("a.json", "b.json"))
    assert full["device"].startswith("cuda") and full["peak_bytes"] > 0
    assert resumed["start_step"] == 3
    assert resumed["losses"] == full["losses"][3:]
