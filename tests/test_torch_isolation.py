"""radar_depth_tpu_torch and chip_smoke.py import neither JAX nor anything of
the JAX package radar_depth_tpu, at import time or in their sources."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import radar_depth_tpu_torch

PKG_DIR = Path(radar_depth_tpu_torch.__file__).parent
CHIP_SMOKE = PKG_DIR.parent / "chip_smoke.py"
PATTERN = re.compile(
    r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)\b"
    r"|.*\bradar_depth_tpu\.(?!_torch)|.*\bradar_depth_tpu\s+import\b)")
JAX_MODULES = ("bad = sorted(m for m in sys.modules if m == 'jax' or "
               "m.startswith(('jax.', 'jaxlib', 'flax')) or "
               "m == 'radar_depth_tpu' or m.startswith('radar_depth_tpu.'))\n")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], prefix="radar_depth_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert {"radar_depth_tpu_torch.ops.kernels",
            "radar_depth_tpu_torch.ops.raster",
            "radar_depth_tpu_torch.serve",
            "radar_depth_tpu_torch.utils.profiling",
            "radar_depth_tpu_torch.eval_two_stage",
            "radar_depth_tpu_torch.model_summary"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        + JAX_MODULES +
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(PKG_DIR.parent))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _hits(path, name):
    return [f"{name}:{n}: {line.strip()}"
            for n, line in enumerate(path.read_text().splitlines(), 1)
            if PATTERN.match(line) and not line.lstrip().startswith("#")]


def test_sources_name_no_jax_import():
    hits = []
    files = sorted(PKG_DIR.rglob("*.py"))
    assert len(files) >= 15
    for path in files:
        hits += _hits(path, path.relative_to(PKG_DIR))
    assert not hits, hits


def test_chip_smoke_imports_no_jax():
    """The card's smoke script, by its source and by what importing it and
    the modules it imports load."""
    assert not _hits(CHIP_SMOKE, CHIP_SMOKE.name)
    src = CHIP_SMOKE.read_text()
    mods = sorted(set(re.findall(r"from (radar_depth_tpu_torch[\w.]*) import",
                                 src)))
    assert "radar_depth_tpu_torch.inference" in mods
    code = (
        "import importlib, sys\n"
        "import chip_smoke\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        + JAX_MODULES +
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(PKG_DIR.parent))
    assert proc.returncode == 0, proc.stdout + proc.stderr
