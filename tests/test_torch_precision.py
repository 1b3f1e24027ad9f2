"""The port's float32 precision setting (device.py::use_ieee_float32) on the
CPU: with TF32 switched on first, building each entry point of the port
(create_model, make_mesh, the Trainer through train.main --evaluate, the
Predictor and Predictor.from_run, load_serving's callable, the HTTP
daemon's DepthServer, eval_two_stage and model_summary) leaves the process
with IEEE float32 for cuDNN convolutions and CUDA matmuls, read through
both of torch's APIs (the flags do nothing on the CPU, but they read back);
importing the port changes nothing. 64x96, 2 sweeps, a resnet18_multistage
run with seeded random weights and a resnet18 (d, deconv2) artifact at
B=1."""

import os
import subprocess
import sys

import pytest
import torch

from radar_depth_tpu_torch import config, eval_two_stage, model_summary
from radar_depth_tpu_torch.config import ServeConfig
from radar_depth_tpu_torch.device import use_deterministic_convs
from radar_depth_tpu_torch.inference import Predictor, load_serving
from radar_depth_tpu_torch.models import create_model, init_random
from radar_depth_tpu_torch.parallel.mesh import make_mesh
from radar_depth_tpu_torch.serve import DepthServer
from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
from radar_depth_tpu_torch.train.main import run
from radar_depth_tpu_torch.train.state import create_train_state
from tests.test_torch_harness import (  # noqa: F401  (fixture)
    SPEC,
    base_argv,
    few_threads,
    write_split,
)

H, W = SPEC.height, SPEC.width
ART = ServeConfig(arch="resnet18", modality="d", decoder="deconv2",
                  height=H, width=W, num_sweeps=SPEC.num_sweeps)


def tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    assert read_precision() == {"conv": "tf32", "matmul": "tf32"}


def read_precision():
    """Both APIs must agree (reading one after the other API has set the
    flags differently raises)."""
    b = torch.backends
    conv = "tf32" if b.cudnn.allow_tf32 else "ieee"
    matmul = "tf32" if b.cuda.matmul.allow_tf32 else "ieee"
    assert (b.cudnn.conv.fp32_precision == "tf32") == (conv == "tf32")
    assert b.cuda.matmul.fp32_precision == matmul
    assert torch.get_float32_matmul_precision() == (
        "high" if matmul == "tf32" else "highest")
    return {"conv": conv, "matmul": matmul}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A port run (config.json and one checkpoint of seeded weights, no
    training) on packed shards, and a B=1 serving artifact."""
    root = tmp_path_factory.mktemp("precision")
    data = write_split(root / "data")
    run_dir = str(root / "run")
    os.makedirs(run_dir)
    cfg = config.parse_command(base_argv(data) + ["--output-dir", run_dir])
    config.save_config(cfg, os.path.join(run_dir, "config.json"))
    model, _ = create_model(cfg.model.arch, device="cpu", output_size=(H, W),
                            param_dtype=torch.float32)
    init_random(model, 3)
    ckpt_lib.CheckpointManager(run_dir).save(
        0, create_train_state(model, cfg.optim, 2), {"rmse": 3.0}, wait=True)
    sd = init_random(create_model(ART.arch, device="cpu", output_size=(H, W),
                                  modality=ART.modality,
                                  decoder=ART.decoder)[0], 0).state_dict()
    artifact = str(root / "serve.pt2")
    Predictor(ART, sd, device="cpu").export_serving(artifact, 1)
    yield {"root": root, "data": data, "run": run_dir, "artifact": artifact,
           "art_sd": sd}
    torch.backends.cudnn.allow_tf32 = True  # torch's default


def _trainer(r):
    run(["--evaluate", r["run"], "--platform", "cpu", "--print-freq", "100",
         "--output-dir", str(r["root"] / "evaluate")])


def _depth_server(r):
    srv = DepthServer(Predictor.from_run(r["run"], device="cpu"), max_tile=2)
    srv.close()


def _eval_two_stage(r):
    assert eval_two_stage.main(["--run", r["run"], "--data-root", r["data"],
                                "--batch", "8", "--platform", "cpu"]) == 0


ENTRY_POINTS = {
    "create_model": lambda r: create_model("resnet18", device="cpu",
                                           output_size=(H, W)),
    "make_mesh": lambda r: make_mesh("cpu"),
    "trainer_evaluate": _trainer,
    "predictor": lambda r: Predictor(ART, r["art_sd"], device="cpu"),
    "predictor_from_run": lambda r: Predictor.from_run(r["run"],
                                                       device="cpu"),
    "load_serving": lambda r: load_serving(r["artifact"], device="cpu"),
    "depth_server": _depth_server,
    "eval_two_stage": _eval_two_stage,
    "model_summary": lambda r: model_summary.main([
        "--arch", "resnet18", "--height", str(H), "--width", str(W),
        "--no-flops"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_sets_ieee_float32(runs, entry, capsys):
    tf32_on()
    ENTRY_POINTS[entry](runs)
    assert read_precision() == {"conv": "ieee", "matmul": "ieee"}


def test_per_call_ops_leave_the_setting():
    """The ops every forward or step runs set nothing, so a caller's own
    TF32 choice around a forward holds."""
    from radar_depth_tpu_torch.data import SyntheticNuScenes
    from radar_depth_tpu_torch.ops.preprocess import (
        PreprocessConfig,
        prepare_eval_batch,
    )

    batch = SyntheticNuScenes(1, spec=SPEC, seed=2).batch(range(1))
    tf32_on()
    try:
        prepare_eval_batch(batch, PreprocessConfig(spec=SPEC), "cpu")
        assert read_precision() == {"conv": "tf32", "matmul": "tf32"}
    finally:
        torch.set_float32_matmul_precision("highest")


def test_import_changes_nothing():
    code = (
        "import torch\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "torch.set_float32_matmul_precision('high')\n"
        "import radar_depth_tpu_torch.config, radar_depth_tpu_torch.device\n"
        "import radar_depth_tpu_torch.inference, radar_depth_tpu_torch.serve\n"
        "import radar_depth_tpu_torch.train.main\n"
        "import radar_depth_tpu_torch.eval_two_stage\n"
        "import radar_depth_tpu_torch.model_summary\n"
        "print(torch.backends.cudnn.allow_tf32,"
        " torch.get_float32_matmul_precision())\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split() == ["True", "high"]


def test_deterministic_convs_on_the_card_only():
    saved = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        use_deterministic_convs(torch.device("cpu"))
        assert torch.backends.cudnn.deterministic is False
        use_deterministic_convs(torch.device("cuda"))
        assert torch.backends.cudnn.deterministic is True
    finally:
        torch.backends.cudnn.deterministic = saved
