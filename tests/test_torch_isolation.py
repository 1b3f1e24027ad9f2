"""radar_depth_tpu_torch imports neither JAX nor anything of the JAX package
radar_depth_tpu, at import time or in its sources."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import radar_depth_tpu_torch

PKG_DIR = Path(radar_depth_tpu_torch.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], prefix="radar_depth_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "radar_depth_tpu_torch.ops.kernels" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'flax')) or m == 'radar_depth_tpu' "
        "or m.startswith('radar_depth_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(PKG_DIR.parent))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)\b"
        r"|.*\bradar_depth_tpu\.(?!_torch)|.*\bradar_depth_tpu\s+import\b)")
    hits = []
    files = sorted(PKG_DIR.rglob("*.py"))
    assert len(files) >= 15
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.match(line) and not line.lstrip().startswith("#"):
                hits.append(f"{path.relative_to(PKG_DIR)}:{n}: {line.strip()}")
    assert not hits, hits
