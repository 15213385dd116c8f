"""The port imports neither JAX nor anything of the reference package
``repro``: checked in a fresh interpreter that mines on the CPU, builds the
resident service there and generates from a reduced LM, and by a scan of
every import statement in the port's sources and in chip_smoke.py. The
interpreter also takes two training steps of a reduced LM, imports the
distributed modules and takes one sharded step on a 2x2 mesh of CPU
entries, then imports the roofline modules and the dry run and counts one
cell on the production mesh."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = r"""
import sys
import numpy as np
import repro_torch
import repro_torch.launch.mine, repro_torch.convert
import repro_torch.service, repro_torch.sampling, repro_torch.launch.serve_miner
from repro_torch import KyivConfig, mine
from repro_torch.service import MiningService
D = np.random.default_rng(0).integers(0, 4, size=(120, 5))
res = mine(D, KyivConfig(tau=1, kmax=3, engine="torch", device="cpu"))
assert res.itemsets
svc = MiningService.from_dataset(D, engine="torch", device="cpu")
assert svc.mine(tau=1, kmax=3).result.itemsets
svc.close()
import torch
import repro_torch.configs, repro_torch.models, repro_torch.serving, repro_torch.launch.serve
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import build
from repro_torch.serving import generate
for arch in ("gemma3-4b", "whisper-medium"):
    model = build(reduced(ARCHS[arch]))
    net = model.init(torch.Generator().manual_seed(0))
    extra = {"frames": torch.zeros(2, 8, 64)} if arch == "whisper-medium" else None
    gen = generate(model, net, torch.ones(2, 5, dtype=torch.long), max_new=3, extra=extra)
    assert tuple(gen.tokens.shape) == (2, 3)
import repro_torch.training, repro_torch.launch.train
from repro_torch.launch.train import train
rec = train("glm4-9b", reduced=True, steps=2, batch=2, seq=8, device="cpu")
assert len(rec["losses"]) == 2
import repro_torch.distributed.sharding, repro_torch.distributed.elastic
import repro_torch.distributed.pipeline, repro_torch.training.compression
import repro_torch.serving.decode_attn
from repro_torch.launch.mesh import mesh_from_spec
rec = train("glm4-9b", reduced=True, steps=1, batch=4, seq=8,
            mesh=mesh_from_spec("2x2", devices=["cpu"] * 4))
assert len(rec["losses"]) == 1 and rec["mesh"]["n_devices"] == 4
import repro_torch.roofline.hw, repro_torch.roofline.analytic, repro_torch.roofline.analysis
import repro_torch.launch.dryrun
from repro_torch.launch.dryrun import lower_cell
rec = lower_cell("mamba2-370m", "decode_32k")
assert rec["status"] == "ok" and rec["memory"]["fits"] and rec["compute_entries"] == 16
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_import_and_mine_load_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                          env=env, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


def test_sources_import_no_jax_or_reference():
    assert len(SOURCES) > 20
    offenders = []
    for path in SOURCES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders
