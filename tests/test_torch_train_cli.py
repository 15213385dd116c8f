"""The port's training driver, ``repro_torch.launch.train``, on the CPU.

* ``synthetic_lm_batches`` yields the reference's stream bit for bit.
* ``--reduced --device cpu --steps 6 --ckpt-every 3`` stopped after step 3
  (step 6's checkpoint removed) and resumed equals the uninterrupted run:
  the losses of steps 3-5 and every parameter and moment of the last
  checkpoint, bit for bit (the same ops on the same CPU). The resumed run
  skips the batches the first one consumed; the reference's restarts its
  stream (a fault of the reference).
* A checkpoint written by the reference's ``launch/train.py`` (its stacked
  tree) is taken up by ``--resume``, and the port's next step equals the
  reference's step from that state on the same batch: the loss within 1e-5
  and the parameters and moments under ``test_torch_train_helpers``' rule
  for a later step (the reference compiled without excess precision).
* The frontend stubs' inputs; ``--mesh production`` and ``multipod`` on a
  bare ``--device cuda`` with fewer cards than their 256 and 512 entries
  (the production mesh's error), and ``--mesh production --device cpu``
  (256 CPU entries: one step whose loss is the single-device step's within
  1e-5; ``host`` is in ``test_torch_dist_elastic``); and the default
  ``--device cuda`` without a card (an error, no CPU run)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

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
from repro_torch.launch import train as port_train
from repro_torch.models.zoo import build as port_build
from test_torch_train_helpers import (assert_moments_close, assert_params_close, ref_step,
                                      to_port)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "glm4-9b", "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16"]
PORT_CFG = port_reduced(PORT_ARCHS["glm4-9b"])


@pytest.mark.parametrize("vocab,batch,seq,seed", [(128, 2, 16, 0), (49_155, 8, 64, 3),
                                                  (2, 3, 5, 1)])
def test_synthetic_batches_equal_reference(vocab, batch, seq, seed):
    ref = ref_train.synthetic_lm_batches(vocab, batch, seq, seed)
    port = port_train.synthetic_lm_batches(vocab, batch, seq, seed)
    for _ in range(5):
        r, p = next(ref), next(port)
        for key in ("tokens", "labels"):
            assert p[key].dtype == torch.int64
            np.testing.assert_array_equal(p[key].numpy(), np.asarray(r[key]))


def _ckpt(directory, step, names):
    tree, meta = CheckpointManager(str(directory)).restore(step)
    assert meta["step"] == step
    flat = {k: port_train._dotted(v) for k, v in
            (("params", tree["params"]), ("m", tree["opt"]["m"]), ("v", tree["opt"]["v"]))}
    assert set(flat["params"]) == set(names)
    return flat, int(tree["opt"]["step"])


def test_cli_resume_equals_uninterrupted(tmp_path):
    """The uninterrupted run is the CLI in a fresh interpreter."""
    full, part = tmp_path / "full", tmp_path / "part"
    out = tmp_path / "full.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *ARGS,
                           "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(full),
                           "--out", str(out)], capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final loss" in proc.stdout
    want = json.loads(out.read_text())
    assert want["device"] == "cpu" and len(want["losses"]) == 6 and want["start_step"] == 0

    port_train.main([*ARGS, "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(part)])
    shutil.rmtree(part / "ckpt_0000000006")  # stopped after step 3
    out2 = tmp_path / "part.json"
    port_train.main([*ARGS, "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(part),
                     "--resume", "--out", str(out2)])
    got = json.loads(out2.read_text())
    assert got["start_step"] == 3
    assert got["losses"] == want["losses"][3:]
    names = port_build(PORT_CFG).abstract_params().state_dict().keys()
    a, step_a = _ckpt(full, 6, names)
    b, step_b = _ckpt(part, 6, names)
    assert step_a == step_b == 6
    for part_ in ("params", "m", "v"):
        for n in names:
            np.testing.assert_array_equal(a[part_][n], b[part_][n], err_msg=f"{part_} {n}")


def test_reference_checkpoint_taken_up(tmp_path, monkeypatch, capsys):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "glm4-9b", "--reduced", "--batch", "2",
                                      "--seq", "16", "--steps", "4", "--ckpt-every", "3",
                                      "--ckpt-dir", str(ref_dir), "--log-every", "1"])
    ref_train.main()
    capsys.readouterr()
    shutil.copytree(ref_dir, port_dir)

    # the reference's step from its checkpoint on the fourth batch
    cfg = reduced(ARCHS["glm4-9b"])
    tree, _ = RefCheckpointManager(str(ref_dir)).restore(3)
    tree["params"].setdefault("prefix", [])
    tree["params"].setdefault("suffix", [])
    for key in ("m", "v"):
        tree["opt"][key].setdefault("prefix", [])
        tree["opt"][key].setdefault("suffix", [])
    params = jax.tree.map(jax.numpy.asarray, tree["params"])
    opt = jax.tree.map(jax.numpy.asarray, tree["opt"])
    stream = ref_train.synthetic_lm_batches(cfg.vocab, 2, 16, 0)
    for _ in range(4):
        batch = next(stream)
    r_params, r_opt, r_met = ref_step(ref_build(cfg), params, batch,
                                      RefOptConfig(lr=3e-3, warmup_steps=1, total_steps=4),
                                      opt_state=opt)

    out = tmp_path / "port.json"
    port_train.main([*ARGS, "--steps", "4", "--ckpt-every", "1", "--ckpt-dir", str(port_dir),
                     "--resume", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["start_step"] == 3 and len(rec["losses"]) == 1
    assert abs(rec["losses"][0] - float(r_met["loss"])) <= 1e-5
    got, step = _ckpt(port_dir, 4, to_port(r_params, PORT_CFG).keys())
    assert step == int(r_opt["step"]) == 4
    old = {k: to_port(opt[k], PORT_CFG) for k in ("m", "v")}
    r_m, r_v = to_port(r_opt["m"], PORT_CFG), to_port(r_opt["v"], PORT_CFG)
    to_t = lambda d: {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}
    fresh_m = {n: r_m[n] - 0.9 * old["m"][n] for n in r_m}
    fresh_v = {n: r_v[n] - 0.95 * old["v"][n] for n in r_v}
    assert_moments_close(to_t(got["m"]), r_m, "m", ulps=1, fresh=fresh_m)
    assert_moments_close(to_t(got["v"]), r_v, "v", ulps=2, fresh=fresh_v)
    assert_params_close(to_t(got["params"]), to_port(r_params, PORT_CFG),
                        {"m": to_t(got["m"]), "v": to_t(got["v"])}, {"m": r_m, "v": r_v},
                        float(r_met["lr"]), 4)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_frontend_archs_train(arch, tmp_path):
    out = tmp_path / "o.json"
    port_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "8",
                     "--steps", "2", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert len(rec["losses"]) == 2 and all(np.isfinite(rec["losses"]))


def test_mesh_other_than_none_is_refused(capsys):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for mesh, n in (("production", 256), ("multipod", 512)):
        if cards >= n:
            continue
        with pytest.raises(SystemExit) as e:
            port_train.main([*ARGS, "--device", "cuda", "--mesh", mesh])
        assert e.value.code == 2
        assert f"a mesh of {n} entries needs {n} cards and torch sees {cards}" in \
            capsys.readouterr().err


def test_production_mesh_over_cpu_entries(tmp_path):
    args = ["--arch", "glm4-9b", "--reduced", "--device", "cpu", "--batch", "16", "--seq", "8",
            "--steps", "1"]
    recs = {}
    for mesh in ("none", "production"):
        out = tmp_path / f"{mesh}.json"
        port_train.main([*args, "--mesh", mesh, "--out", str(out)])
        recs[mesh] = json.loads(out.read_text())
    assert recs["production"]["mesh"] == {"shape": {"data": 16, "model": 16}, "n_devices": 256}
    assert recs["production"]["device"] == "cpu"
    got, want = recs["production"]["losses"][0], recs["none"]["losses"][0]
    assert abs(got - want) <= 1e-5, (got, want)


def test_default_device_without_card_is_an_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the error without a card")
    with pytest.raises(SystemExit) as e:
        port_train.main(["--arch", "glm4-9b", "--reduced", "--steps", "1"])
    assert e.value.code == 2
    assert "no CUDA card" in capsys.readouterr().err
