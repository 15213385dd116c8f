"""The benchmark of ``repro_torch``: see ``bench/README.md``."""

import hashlib
import importlib.util
import sys
from pathlib import Path


def load_module(path: Path):
    """Import the Python file ``path`` under a name of its own: how the
    harness finds a traffic driver, a metric's reader or a table generator
    by name."""
    tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:10]
    name = f"bench_file_{path.stem.replace('.', '_').replace('-', '_')}_{tag}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
