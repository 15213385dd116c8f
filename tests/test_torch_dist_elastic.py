"""Elastic placement (``repro_torch.distributed.elastic``) and the train
CLI on a mesh (``launch/train.py --mesh host``), on CPU entries.

* ``redistribute`` then ``gather`` returns the input bit for bit, for
  parameters, batches (one that the data axis divides and one that falls
  back) and caches, on four mesh shapes; each entry holds its own tensor.
* The reference's elastic test on the port: reduced glm4-9b's weights go
  through a checkpoint and are placed on 4x2 and on 2x2; the plan step's
  loss (``cast_bf16=False``, as the reference test reads ``train_loss`` in
  float32) equals the reference's single-device loss within 2e-3 (the
  reference test's bound) and the port's within 1e-5.
* ``--mesh host --device cpu`` (4x2 of CPU entries, B = 4, S = 16) for 3
  steps with a checkpoint each step: stopped after step 2 and resumed on
  the same mesh, it equals the uninterrupted run bit for bit (losses,
  parameters and moments); ``train(mesh=2x2)`` resumed from the same
  checkpoint takes step 3 within ``test_torch_train_rule``'s rule of the
  4x2 run's (the moments' fresh terms, as for a later step).
* A checkpoint of the reference's ``launch/train.py`` is taken up by
  ``--mesh host --resume``, and the port's next step is the reference's
  from that state within the same rule; the loss within 1e-5.
"""

import json
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.distributed.checkpoint import CheckpointManager as RefCheckpointManager
from repro.launch import train as ref_train
from repro.models.zoo import build as ref_build
from repro.training.optimizer import OptConfig as RefOptConfig
from repro_torch.configs import ARCHS as PORT_ARCHS, reduced as port_reduced
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.elastic import Sharded, gather, mesh_fingerprint, redistribute
from repro_torch.distributed.sharding import make_plan
from repro_torch.launch import train as port_train
from repro_torch.models.zoo import build
from repro_torch.training import OptConfig, lr_at, make_train_step
from repro_torch.training.train import sharded_adamw_init
from test_torch_dist_helpers import cpu_mesh
from test_torch_lm_helpers import pair
from test_torch_train_cli import _ckpt
from test_torch_train_helpers import ref_step, to_port
from test_torch_train_rule import assert_moments_close, assert_params_close

SPECS = ("1x1", "2x2", "4x2", "1x8")
ARGS = ["--arch", "glm4-9b", "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
        "--mesh", "host"]
PORT_CFG = port_reduced(PORT_ARCHS["glm4-9b"])


def _own_storage(tree) -> None:
    ptrs = [t.data_ptr() for s in tree.values() for t in s.shards.flat if t.numel()]
    assert len(ptrs) == len(set(ptrs))


@pytest.mark.parametrize("spec", SPECS)
def test_redistribute_then_gather_is_exact(spec):
    plan = make_plan(cpu_mesh(spec))
    rng = np.random.default_rng(3)
    for name in ("glm4-9b", "deepseek-v2-lite-16b", "whisper-medium"):
        cfg = port_reduced(PORT_ARCHS[name])
        net = build(cfg).init(torch.Generator().manual_seed(1))
        placed = redistribute(net, plan)
        assert all(isinstance(s, Sharded) for s in placed.values())
        _own_storage(placed)
        back = gather(placed)
        for n, p in net.named_parameters():
            assert torch.equal(back[n], p.detach()), n
        for b in (8, 6):
            batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, 16))),
                     "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (b, 16)))}
            back = gather(redistribute(batch, plan, "batch"))
            assert all(torch.equal(back[k], v) for k, v in batch.items())
        cache = build(cfg).init_cache(8, 32)
        parts = cache.values() if isinstance(cache, dict) else [cache]
        for layers in parts:
            for layer in layers:
                for v in layer.values():
                    v.copy_(torch.as_tensor(rng.standard_normal(v.shape)))
        back = gather(redistribute(cache, plan, "cache"))
        for p, q in zip(parts, back.values() if isinstance(back, dict) else [back]):
            for a, b_ in zip(p, q):
                assert all(torch.equal(a[k], b_[k]) for k in a)
    assert mesh_fingerprint(plan.mesh) == {"shape": plan.mesh.shape,
                                           "n_devices": int(plan.mesh.devices.size)}


def test_restore_on_two_meshes(tmp_path):
    rm, params, tm, net = pair("glm4-9b")
    rng = np.random.default_rng(0)  # the reference test's batch
    tokens, labels = (rng.integers(0, tm.cfg.vocab, (8, 16)) for _ in range(2))
    batch = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)}
    ref = float(jax.jit(lambda p, b: rm.train_loss(p, None, b))(
        params, {"tokens": jax.numpy.asarray(tokens, jax.numpy.int32),
                 "labels": jax.numpy.asarray(labels, jax.numpy.int32)}))
    port = float(tm.train_loss(net, batch).detach())
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"params": dict(net.named_parameters())}, {"arch": "glm4-9b"})
    tree, _ = cm.restore()
    for spec in ("4x2", "2x2"):
        plan = make_plan(cpu_mesh(spec))
        placed = redistribute(port_train._dotted(tree["params"]), plan)
        step, _ = make_train_step(tm, OptConfig(), plan, cast_bf16=False)
        _, _, met = step(placed, sharded_adamw_init(placed, plan), batch)
        assert abs(float(met["loss"]) - ref) < 2e-3, (spec, float(met["loss"]), ref)
        assert abs(float(met["loss"]) - port) < 1e-5, (spec, float(met["loss"]), port)


def _run(tmp, name, *extra):
    out = tmp / f"{name}.json"
    port_train.main([*ARGS, "--steps", "3", "--ckpt-every", "1", "--ckpt-dir", str(tmp / name),
                     *extra, "--out", str(out)])
    return json.loads(out.read_text())


def _t(d) -> dict:
    return {n: torch.as_tensor(np.asarray(v, np.float32)) for n, v in d.items()}


def _later_step_close(got: dict, want: dict, old: dict, lr: float, step: int) -> None:
    """Step ``step`` of two runs from the same state ``old`` (``params``,
    ``m``, ``v`` by name) under the rule, with each moment's fresh term
    (``(1 - b) g``) as the base of its ulp allowance."""
    want_m, want_v = _t(want["m"]), _t(want["v"])
    fresh_m = {n: want_m[n] - 0.9 * _t(old["m"])[n] for n in want_m}
    fresh_v = {n: want_v[n] - 0.95 * _t(old["v"])[n] for n in want_v}
    got_m, got_v = _t(got["m"]), _t(got["v"])
    assert_moments_close(got_m, want_m, "m", ulps=1, fresh=fresh_m)
    assert_moments_close(got_v, want_v, "v", ulps=2, fresh=fresh_v)
    assert_params_close(_t(got["params"]), _t(want["params"]), {"m": got_m, "v": got_v},
                        {"m": want_m, "v": want_v}, lr, step)


def test_cli_host_mesh_resumes(tmp_path):
    full = _run(tmp_path, "full")
    assert full["mesh"] == {"shape": {"data": 4, "model": 2}, "n_devices": 8}
    assert len(full["losses"]) == 3 and full["start_step"] == 0
    names = build(PORT_CFG).abstract_params().state_dict().keys()
    for part in ("part", "other"):
        shutil.copytree(tmp_path / "full", tmp_path / part)
        shutil.rmtree(tmp_path / part / "ckpt_0000000003")
    resumed = _run(tmp_path, "part", "--resume")
    assert resumed["start_step"] == 2 and resumed["losses"] == full["losses"][2:]
    a, step_a = _ckpt(tmp_path / "full", 3, names)
    b, step_b = _ckpt(tmp_path / "part", 3, names)
    assert step_a == step_b == 3
    for key in ("params", "m", "v"):
        for n in names:
            np.testing.assert_array_equal(a[key][n], b[key][n], err_msg=f"{key} {n}")

    # the same checkpoint resumed on another mesh
    rec = port_train.train("glm4-9b", reduced=True, steps=3, batch=4, seq=16,
                           ckpt_dir=str(tmp_path / "other"), ckpt_every=1, resume=True,
                           log_every=1, mesh=cpu_mesh("2x2"))
    assert rec["start_step"] == 2 and rec["mesh"]["shape"] == {"data": 2, "model": 2}
    assert abs(rec["losses"][0] - full["losses"][2]) <= 1e-5
    lr = float(lr_at(OptConfig(lr=3e-3, warmup_steps=1, total_steps=3), torch.tensor(3)))
    _later_step_close(_ckpt(tmp_path / "other", 3, names)[0], a,
                      _ckpt(tmp_path / "full", 2, names)[0], lr, 3)


def test_reference_checkpoint_taken_up_on_a_mesh(tmp_path, monkeypatch, capsys):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "glm4-9b", "--reduced", "--batch", "4",
                                      "--seq", "16", "--steps", "4", "--ckpt-every", "3",
                                      "--ckpt-dir", str(ref_dir), "--log-every", "1"])
    ref_train.main()
    capsys.readouterr()
    shutil.copytree(ref_dir, port_dir)

    # the reference's step from its checkpoint on the fourth batch
    cfg = reduced(ARCHS["glm4-9b"])
    tree, _ = RefCheckpointManager(str(ref_dir)).restore(3)
    for t in (tree["params"], tree["opt"]["m"], tree["opt"]["v"]):
        t.setdefault("prefix", [])
        t.setdefault("suffix", [])
    params = jax.tree.map(jax.numpy.asarray, tree["params"])
    opt = jax.tree.map(jax.numpy.asarray, tree["opt"])
    stream = ref_train.synthetic_lm_batches(cfg.vocab, 4, 16, 0)
    for _ in range(4):
        batch = next(stream)
    r_params, r_opt, r_met = ref_step(ref_build(cfg), params, batch,
                                      RefOptConfig(lr=3e-3, warmup_steps=1, total_steps=4),
                                      opt_state=opt)

    out = tmp_path / "port.json"
    port_train.main([*ARGS, "--steps", "4", "--ckpt-every", "1", "--ckpt-dir", str(port_dir),
                     "--resume", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["start_step"] == 3 and len(rec["losses"]) == 1 and rec["mesh"]["n_devices"] == 8
    assert abs(rec["losses"][0] - float(r_met["loss"])) <= 1e-5
    got, step = _ckpt(port_dir, 4, to_port(r_params, PORT_CFG).keys())
    assert step == int(r_opt["step"]) == 4
    want = {"params": to_port(r_params, PORT_CFG), "m": to_port(r_opt["m"], PORT_CFG),
            "v": to_port(r_opt["v"], PORT_CFG)}
    old = {k: to_port(opt[k], PORT_CFG) for k in ("m", "v")}
    _later_step_close(got, want, old, float(r_met["lr"]), 4)
