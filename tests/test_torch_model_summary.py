"""radar_depth_tpu_torch.model_summary against the JAX package's
scripts/model_summary.py: parameter and BN-statistic counts equal the
flax ``params`` and ``batch_stats`` counts (``jax.eval_shape``, no
compile) for every registry arch and every decoder; the flagship's
conv+matmul FLOPs (FlopCounterMode) against XLA's cost_analysis() FLOPs,
which also count elementwise work, inside the band measured at 64x96."""

import importlib.util
import os

import pytest

from radar_depth_tpu.models import ARCH_REGISTRY as JAX_ARCH_REGISTRY
from radar_depth_tpu_torch.model_summary import main, summarize
from radar_depth_tpu_torch.models import ARCH_REGISTRY

H, W = 64, 96
# FlopCounterMode's count over XLA's for resnet18_multistage / upproj at
# 64x96: 1.2045 measured on the CPU (0.9935 at 450x800); the two count
# different things (radar_depth_tpu_torch/model_summary.py)
FLOPS_RATIO_BAND = (1.18, 1.23)


def _jax_script():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_model_summary", os.path.join(repo, "scripts", "model_summary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _jax_script()


def test_registry_matches_jax():
    assert sorted(ARCH_REGISTRY) == sorted(JAX_ARCH_REGISTRY)


@pytest.mark.parametrize(
    "arch,decoder",
    [(a, "upproj") for a in sorted(JAX_ARCH_REGISTRY)]
    + [("resnet18_latefusion", d) for d in ("deconv2", "deconv3", "upconv")])
def test_counts_equal_jax(arch, decoder):
    want = SCRIPT.summarize_params_only(arch, H, W, decoder)
    n_params, n_stats, flops = summarize(arch, H, W, decoder, flops=False)
    assert flops is None
    assert (n_params, n_stats) == want


def test_flops_against_xla(capsys):
    _, _, xla = SCRIPT.summarize("resnet18_multistage", H, W)
    n_params, n_stats, flops = summarize("resnet18_multistage", H, W)
    lo, hi = FLOPS_RATIO_BAND
    assert lo <= flops / xla <= hi, flops / xla

    assert main(["--arch", "resnet18_multistage", "--height", str(H),
                 "--width", str(W)]) == 0
    row = capsys.readouterr().out.splitlines()[-1].split()
    assert row[0] == "resnet18_multistage"
    assert row[1:3] == [f"{n_params:,d}", f"{n_stats:,d}"]
    assert float(row[3]) == round(flops / 1e9, 1)
