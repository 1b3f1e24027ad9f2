"""The port's training harness with image height sharded over ranks, through
its real command line: ``torchrun --standalone --nproc-per-node 4`` of
``train.main --spatial 2 --platform cpu`` (gloo; a (data 2, space 2) mesh),
the flagship at 128x96, 2 sweeps, global batch 4, 8 synthetic train and 5
val samples (a ragged last val batch), one epoch, beside the same run in
one process without a process group. The same launch then serves the run
with ``Predictor.from_run`` over the spatial mesh the run's config.json
asks for.

- test.csv's row equals the single process's within rtol 1e-3 (the runs
  differ in the order of their float32 reductions, and the slabs' halos
  move the summation order of every conv), and the replicas end bit-equal
  (the Trainer checks it and says so);
- ``Predictor.from_run`` of the run over the four ranks predicts what the
  run's checkpoint served in one process (``spatial=1``) predicts, within
  rtol = atol = 1e-5;
- in one process, the JAX Trainer's checks of --spatial with its messages:
  an H/32 bottleneck under 3 rows (H=64), and a height the space axis does
  not divide.
"""

import csv
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from radar_depth_tpu_torch import config
from radar_depth_tpu_torch.train.loop import Trainer
from radar_depth_tpu_torch.train.main import run

METRICS = ("mse", "rmse", "absrel", "lg10", "mae", "delta1", "delta2",
           "delta3")
ROW_RTOL = 1e-3
PRED_TOL = dict(rtol=1e-5, atol=1e-5)
H, W = 128, 96
TIMEOUT_S = 900
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# train.main's run(), then Predictor.from_run of the run over the ranks,
# both on one default process group that the script makes (a group made
# again after one is destroyed does not connect under one torchrun store);
# rank 0 writes the prediction
SCRIPT = textwrap.dedent("""\
    import os, sys
    import numpy as np
    import torch.distributed as dist
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.train.main import run
    out, argv = sys.argv[1], sys.argv[2:]
    dist.init_process_group("gloo")
    r = run(argv)
    p = Predictor.from_run(r["cfg"].output_dir, device="cpu")
    pred = p.predict(dict(np.load(out + ".npz")))
    if os.environ["RANK"] == "0":
        np.save(out, pred)
        print("PREDICTED", pred.shape, flush=True)
    dist.destroy_process_group()
    """)


def _argv(out_dir):
    return ["--arch", "resnet18_multistage", "--decoder", "upproj",
            "-b", "4", "--height", str(H), "--width", str(W),
            "--num-sweeps", "2", "--num-train", "8", "--num-val", "5",
            "--platform", "cpu", "--print-freq", "100", "--epochs", "1",
            "--output-dir", out_dir]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes

    root = tmp_path_factory.mktemp("spatial_trainer")
    dirs = {k: str(root / k) for k in ("spatial", "single")}
    pred_in = str(root / "pred")
    np.savez(pred_in + ".npz", **SyntheticNuScenes(
        3, spec=SampleSpec(height=H, width=W, num_sweeps=2),
        seed=4).batch(range(3)))
    script = root / "train_then_serve.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(script), pred_in,
         *_argv(dirs["spatial"]), "--spatial", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        run(_argv(dirs["single"]))
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"{out}\n{err[-6000:]}"
    from radar_depth_tpu_torch.inference import Predictor

    # the spatial run's checkpoint, served in this process
    single_pred = Predictor.from_run(dirs["spatial"], device="cpu",
                                     spatial=1).predict(
        dict(np.load(pred_in + ".npz")))
    yield {"dirs": dirs, "stdout": out, "pred": np.load(pred_in + ".npy"),
           "single_pred": single_pred}
    shutil.rmtree(root, ignore_errors=True)


def test_spatial_run_prints_its_mesh_and_writes_once(runs):
    out = runs["stdout"]
    assert out.count("4 ranks (gloo), data 2 x space 2") == 1
    assert out.count("epoch 0: val rmse=") == 1
    assert out.count("PREDICTED (3, 128, 96)") == 1
    with open(os.path.join(runs["dirs"]["spatial"], "config.json")) as f:
        assert json.load(f)["spatial"] == 2
    for name in ("train.csv", "test.csv"):
        rows = _rows(os.path.join(runs["dirs"]["spatial"], name))
        assert [r["epoch"] for r in rows] == ["0"]


def test_spatial_run_matches_one_process(runs):
    got = _rows(os.path.join(runs["dirs"]["spatial"], "test.csv"))[0]
    want = _rows(os.path.join(runs["dirs"]["single"], "test.csv"))[0]
    for k in METRICS:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=ROW_RTOL,
                                              abs=5e-7), k


def test_spatial_replicas_end_bit_equal(runs):
    assert "replicas bit-equal on 4 ranks after 2 steps" in runs["stdout"]


def test_spatial_from_run_matches_one_process(runs):
    np.testing.assert_allclose(runs["pred"], runs["single_pred"], **PRED_TOL)


@pytest.mark.parametrize("height,message", [
    (64, "--spatial requires height >= 96"),
    (97, "height=97 is not divisible by --spatial 2")])
def test_spatial_checks_of_the_jax_trainer(tmp_path, height, message):
    """Raised before any process group or output directory is made."""
    out = tmp_path / "out"
    argv = _argv(str(out))
    argv[argv.index("--height") + 1] = str(height)
    with pytest.raises(ValueError, match=message):
        Trainer(config.parse_command(argv + ["--spatial", "2"]))
    assert not out.exists()
