"""Every arch of the registry through the port's entry points on the CPU:
one epoch of train.main (1 train step of B=2 at 32x64, validation, a
checkpoint), then Predictor.from_run on the run against an --evaluate
Trainer, with each decoder kind, modality, --remat and --stage2-coarse on
some arch. The JAX package plays no part: its counterparts are held against
the port in tests/test_torch_zoo.py and tests/test_torch_zoo_train.py."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from radar_depth_tpu_torch import config
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.inference import Predictor
from radar_depth_tpu_torch.models import ARCH_REGISTRY
from radar_depth_tpu_torch.train.loop import Trainer
from radar_depth_tpu_torch.train.main import run
from radar_depth_tpu_torch.train.step import make_predict_fn

H, W = 32, 64


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# (arch, extra flags): every registry arch, each decoder kind and modality
# on some arch
EVERY_ARCH = [
    ("resnet18", ["--modality", "rgb", "--decoder", "deconv3"]),
    ("resnet34", ["--modality", "d", "--decoder", "upconv"]),
    ("resnet50", ["--modality", "rgbd", "--decoder", "deconv2"]),
    ("resnet18_latefusion", ["--decoder", "upconv"]),
    ("resnet34_latefusion", []),
    ("resnet50_latefusion", ["--decoder", "deconv2"]),
    ("resnet18_multistage", ["--remat", "--stage2-coarse"]),
    ("resnet34_multistage", ["--decoder", "deconv3"]),
    ("resnet50_multistage", ["--decoder", "deconv2"]),
    ("resnet18_multistage_uncertainty", ["--remat"]),
    ("resnet34_multistage_uncertainty", ["--stage2-coarse"]),
]


def test_every_arch_is_listed():
    assert sorted(a for a, _ in EVERY_ARCH) == sorted(ARCH_REGISTRY)


@pytest.mark.parametrize("arch,extra", EVERY_ARCH,
                         ids=[a for a, _ in EVERY_ARCH])
def test_every_arch_trains_and_serves(tmp_path, arch, extra):
    """One epoch of train.main (1 step of B=2 at 32x64, validation, a
    checkpoint), then Predictor.from_run on the run: its prediction equals
    that of an --evaluate Trainer on the same run."""
    out = str(tmp_path / "run")
    try:
        r = run(["--arch", arch, "--height", str(H), "--width", str(W),
                 "--num-sweeps", "2", "--num-train", "2", "--num-val", "2",
                 "-b", "2", "--epochs", "1", "--platform", "cpu",
                 "--print-freq", "100", "--output-dir", out] + extra)
        (h,) = r["history"]
        assert h["train"]["steps"] == 1 and np.isfinite(h["train"]["loss"])
        assert np.isfinite(h["val"]["rmse"]) and h["checkpoint"]
        p = Predictor.from_run(out, device="cpu")
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(
            config.serve_config(r["cfg"]))
        batch = SyntheticNuScenes(2, spec=SampleSpec(height=H, width=W,
                                                     num_sweeps=2,
                                                     lidar_points=2048),
                                  seed=9).batch(range(2))
        got = p.predict(batch)
        del p
        tr = Trainer(config.parse_command(["--evaluate", out, "--platform",
                                           "cpu", "--output-dir",
                                           out + "-eval"]))
        try:
            tr.load_for_evaluate()
            own = make_predict_fn(tr.model, tr.arch_spec, tr.cfg)(batch)[
                "pred"]
        finally:
            tr.close()
        assert got.shape == (2, H, W) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, own[..., 0].numpy())
    finally:
        # the checkpoints of the larger archs are gigabytes: free the disk
        for d in (out, out + "-eval"):
            shutil.rmtree(d, ignore_errors=True)
