"""The port imports neither JAX nor anything of the reference package
``repro``: checked in a fresh interpreter that mines on the CPU and builds
the resident service there, and by a scan of every import statement in the
port's sources and in chip_smoke.py."""

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
