"""The port's training harness (radar_depth_tpu_torch/{config.py, train/
loop.py, train/checkpoint.py, train/main.py, utils/*, inference.py::
Predictor.from_run}) on the CPU, at 64x96, 2 sweeps, resnet18_multistage /
upproj, B=8, on packed shards through the native loader with host
augmentation.

Held against the JAX package: the CLI and config.json (parse_command gives
equal trees for the same argv, --evaluate/--resume adoption included;
either package's config.json loads in the other), the CSV fieldnames and
best.txt line, the comparison panel. Port-only, mirroring tests/test_train.py,
test_inference.py and test_watchdog.py: resume exactness (bitwise on the
CPU), checkpoint retention and restore paths, the stale-save sweep, the run
lock, --ckpt-every, --init-from and --stage1-path, per-split validation,
the watchdog's heartbeat, Predictor.from_run, a stage2_coarse Predictor,
and --spatial in one process, asking for torchrun ranks."""

import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import unittest.mock as mock

import numpy as np
import pytest
import torch

from radar_depth_tpu import config as jconfig
from radar_depth_tpu.utils import csvlog as jcsvlog
from radar_depth_tpu.utils import viz as jviz
from radar_depth_tpu_torch import config
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.data.packed import PackedDataset, write_shards
from radar_depth_tpu_torch.inference import Predictor
from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
from radar_depth_tpu_torch.train.loop import Trainer, should_checkpoint
from radar_depth_tpu_torch.train.main import run
from radar_depth_tpu_torch.train.state import create_train_state
from radar_depth_tpu_torch.utils import csvlog, viz
from radar_depth_tpu_torch.utils.watchdog import StallWatchdog

SPEC = SampleSpec(height=64, width=96, num_sweeps=2, lidar_points=2048)
METRIC_COLS = ("mse", "rmse", "absrel", "lg10", "mae", "delta1", "delta2",
               "delta3")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads per test process: the suite runs in several
    processes at once, and the CPU convolutions of all of them share the
    machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def write_split(root, num_train=16, num_val=8):
    """Packed train/val shards of SyntheticNuScenes at SPEC, val tagged
    day/night."""
    for split, n, seed in (("train", num_train, 0), ("val", num_val, 1)):
        ds = SyntheticNuScenes(n, spec=SPEC, seed=seed)
        write_shards(os.path.join(root, split), (ds[i] for i in range(n)),
                     tags=[ds.sample_tag(i) for i in range(n)])
    return str(root)


def base_argv(data_root, arch="resnet18_multistage"):
    return ["--arch", arch, "--decoder", "upproj", "-b", "8",
            "--dataset", "packed", "--data-root", data_root,
            "--height", "64", "--width", "96", "--num-sweeps", "2",
            "--platform", "cpu", "--print-freq", "100"]


def rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A straight 2-epoch run, and 1 epoch + --resume + 1 epoch."""
    root = tmp_path_factory.mktemp("harness")
    data = write_split(root / "data")
    straight, interrupted = str(root / "straight"), str(root / "interrupted")
    out = {"data": data, "root": root, "straight": straight,
           "interrupted": interrupted}
    out["straight_run"] = run(base_argv(data) + ["--epochs", "2",
                                                 "--output-dir", straight])
    run(base_argv(data) + ["--epochs", "1", "--output-dir", interrupted])
    out["resumed_run"] = run(["--resume", interrupted, "--epochs", "2",
                              "--output-dir", interrupted, "--platform",
                              "cpu", "--print-freq", "100"])
    yield out
    shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ (a) config


CLI_CASES = [
    [],
    ["--arch", "resnet18_multistage", "--dtype", "bfloat16", "-b", "4",
     "--filter-mode", "rel", "--rel-threshold", "0.2", "--blend-tau", "0.3"],
    ["--arch", "resnet34_multistage", "--multistage-uncertainty",
     "--decoder", "deconv3", "--stage2-coarse", "--remat", "--pretrained",
     "w.pth", "--stage1-path", "s1", "--stage-weights", "0.5", "2"],
    ["--dataset", "packed", "--data-root", "d", "--no-augment",
     "--sparsifier", "uar", "--num-samples", "50", "--raster-backend",
     "scatter", "--gt-augment", "rerasterize", "--height-extension", "2",
     "--grad-accum", "3", "-c", "l2", "--lr", "0.1", "--momentum", "0.5",
     "--weight-decay", "0", "--lr-decay-epochs", "2", "--lr-decay-factor",
     "0.5", "--metric-avg", "sample", "--eval-splits", "--tensorboard",
     "--workers", "2", "--eval-batch-size", "16", "--stall-timeout", "0",
     "--ckpt-every", "3", "--spatial", "2", "--seed", "7", "--platform",
     "cpu", "--init-from", "r0", "--print-freq", "5", "--modality", "d",
     "--arch", "resnet50", "--max-depth", "60", "--num-train", "3",
     "--num-val", "2", "--epochs", "4", "--output-dir", "o"],
]


@pytest.mark.parametrize("argv", CLI_CASES,
                         ids=["defaults", "flagship", "unported", "data"])
def test_parse_command_matches_jax(argv):
    assert (dataclasses.asdict(config.parse_command(argv))
            == dataclasses.asdict(jconfig.parse_command(argv)))


def test_config_json_interchange(tmp_path):
    """A config.json written by either package loads in the other as the
    same tree, and equal trees are written byte for byte alike."""
    argv = CLI_CASES[3]
    mine, theirs = config.parse_command(argv), jconfig.parse_command(argv)
    config.save_config(mine, str(tmp_path / "port.json"))
    jconfig.save_config(theirs, str(tmp_path / "jax.json"))
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    assert jconfig.load_config(str(tmp_path / "port.json")) == theirs
    assert config.load_config(str(tmp_path / "jax.json")) == mine


def test_load_config_version_tolerant(tmp_path):
    cfg = config.parse_command(CLI_CASES[1])
    path = str(tmp_path / "config.json")
    config.save_config(cfg, path)
    with open(path) as f:
        d = json.load(f)
    d["model"]["future_knob"] = 42
    d["frobnicate"] = True
    del d["optim"]["grad_accum"]
    with open(path, "w") as f:
        json.dump(d, f)
    assert config.load_config(path) == cfg  # grad_accum 1 is the default


def test_run_config_adoption_matches_jax(tmp_path):
    """--evaluate / --resume fill default-valued flags from the run's
    config.json (by run dir, checkpoints/ or step dir); explicit flags win;
    a dir without config.json adopts nothing."""
    run_dir = tmp_path / "run"
    (run_dir / "checkpoints" / "3").mkdir(parents=True)
    saved = config.parse_command(CLI_CASES[3][:-2] + ["--output-dir",
                                                      str(run_dir)])
    config.save_config(saved, str(run_dir / "config.json"))
    bare = tmp_path / "bare"
    bare.mkdir()
    cases = [["--evaluate", str(run_dir)],
             ["--evaluate", str(run_dir / "checkpoints")],
             ["--evaluate", str(run_dir / "checkpoints" / "3")],
             ["--resume", str(run_dir)],
             ["--evaluate", str(run_dir), "--decoder", "upconv", "-b", "4",
              "--metric-avg", "batch"],
             ["--evaluate", str(bare)]]
    for argv in cases:
        mine = config.parse_command(argv)
        assert dataclasses.asdict(mine) == dataclasses.asdict(
            jconfig.parse_command(argv)), argv
    adopted = config.parse_command(cases[0])
    assert adopted.model.arch == "resnet50" and adopted.data.height == 450
    assert adopted.data.num_val == 2 and adopted.metric_avg == "sample"
    assert adopted.platform == "default"  # a host knob, never adopted
    assert config.parse_command(cases[3]).augment.enabled is False


# ------------------------------------------------------ (e) the harness


def test_resume_bitwise_equals_uninterrupted(runs):
    """2 epochs straight == 1 epoch + checkpoint + --resume + 1 epoch, bit
    for bit in the last train.csv and test.csv rows: parameters, momentum,
    BN statistics, step count, shuffle order and augmentation all carry
    across."""
    for name in ("test.csv", "train.csv"):
        a = rows(os.path.join(runs["straight"], name))
        b = rows(os.path.join(runs["interrupted"], name))
        assert [r["epoch"] for r in a] == [r["epoch"] for r in b] == ["0",
                                                                       "1"]
        for k in METRIC_COLS:
            assert a[-1][k] == b[-1][k], (name, k, a[-1][k], b[-1][k])
    assert runs["resumed_run"]["cfg"].model.arch == "resnet18_multistage"
    assert [h["epoch"] for h in runs["resumed_run"]["history"]] == [1]


def test_run_directory_artifacts(runs):
    """The files of a JAX run directory, in the JAX package's formats, and
    the native reader with host augmentation on the main path."""
    d = runs["straight"]
    r = runs["straight_run"]
    assert r["reader"] == "native" and r["host_augment"] is True
    assert sorted(os.listdir(d)) == sorted([
        ".trainer.lock", "best.txt", "checkpoints", "comparison_epoch0.png",
        "comparison_epoch1.png", "config.json", "test.csv", "train.csv"])
    assert jconfig.load_config(os.path.join(d, "config.json")) == \
        jconfig.parse_command(base_argv(runs["data"])
                              + ["--epochs", "2", "--output-dir", d])
    for name in ("train.csv", "test.csv"):
        with open(os.path.join(d, name)) as f:
            assert f.readline().strip() == ",".join(jcsvlog.FIELDNAMES)
    test = rows(os.path.join(d, "test.csv"))
    best = min(test, key=lambda r: float(r["rmse"]))
    with open(os.path.join(d, "best.txt")) as f:
        line = f.read()
    assert line.startswith(f"epoch={best['epoch']}, rmse=")
    assert f"rmse={float(best['rmse']):.4f}" in line
    for h in r["history"]:
        assert set(h["walls"]) == {"train", "val", "ckpt"}
        assert h["train"]["steps"] == 2 and h["checkpoint"]
    assert [s["epoch"] for s in r["saves"]] == [0, 1]
    assert all(s["bytes"] > 1e8 for s in r["saves"])
    from PIL import Image

    with Image.open(os.path.join(d, "comparison_epoch1.png")) as im:
        assert im.size == (4 * 96, 64) and im.mode == "RGB"


def test_checkpoint_payload_and_best_step(runs):
    d = runs["straight"]
    mgr = ckpt_lib.CheckpointManager(d, sweep_stale=False)
    assert mgr.all_steps() == [0, 1]
    rmses = [float(r["rmse"]) for r in rows(os.path.join(d, "test.csv"))]
    assert mgr.best_step() == int(np.argmin(rmses))
    payload = ckpt_lib.load_payload(os.path.join(mgr.dir, "1"))
    assert set(payload) == {"model", "optimizer", "step", "epoch", "rmse"}
    assert payload["step"] == 4 and payload["epoch"] == 1
    assert f"{payload['rmse']:.6f}" == rows(os.path.join(d, "test.csv"))[1][
        "rmse"]
    bufs = payload["optimizer"]["state"]
    assert len(bufs) == len(payload["optimizer"]["param_groups"][0]["params"])
    assert all(v["momentum_buffer"].abs().sum() > 0 for v in bufs.values())


def _tiny_state(seed=0):
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    torch.manual_seed(seed)
    return create_train_state(model, config.OptimConfig(), 1)


def test_retention_keeps_latest_and_best(tmp_path):
    """Latest step + best 3 by RMSE; restore takes the latest and reports
    the best RMSE of latest and best."""
    mgr = ckpt_lib.CheckpointManager(str(tmp_path))
    state = _tiny_state()
    rmses = [5.0, 1.0, 2.0, 3.0, 4.0, 6.0]
    for epoch, rmse in enumerate(rmses):
        with torch.no_grad():
            state.model[0].weight.fill_(float(epoch))
        state.step = epoch
        mgr.save(epoch, state, {"rmse": rmse})
    assert mgr.all_steps() == [1, 2, 3, 5]
    assert sorted(os.listdir(mgr.dir)) == ["1", "2", "3", "5"]
    assert mgr.best_step() == 1
    fresh = _tiny_state(1)
    _, epoch, best = mgr.restore(fresh)
    assert (epoch, best, fresh.step) == (5, 1.0, 5)
    assert torch.equal(fresh.model[0].weight, torch.full((2, 3), 5.0))
    mgr.close()
    # a new manager sees the same steps
    assert ckpt_lib.CheckpointManager(str(tmp_path)).best_step() == 1


def test_restore_for_evaluate_paths(runs):
    """--evaluate takes a run dir or its checkpoints/ (best step) or a step
    dir (that step), and loads model, optimizer and step."""
    from radar_depth_tpu_torch.models import create_model

    d = runs["straight"]
    best = ckpt_lib.CheckpointManager(d, sweep_stale=False).best_step()
    want = {s: ckpt_lib.load_payload(os.path.join(d, "checkpoints", str(s)))
            for s in (0, 1)}
    model, _ = create_model("resnet18_multistage", device="cpu",
                            output_size=(64, 96))
    for path, step in ((d, best), (os.path.join(d, "checkpoints"), best),
                       (os.path.join(d, "checkpoints", "0"), 0),
                       (os.path.join(d, "checkpoints", "1"), 1)):
        state = create_train_state(model, config.OptimConfig(), 1)
        ckpt_lib.restore_for_evaluate(path, state)
        assert state.step == want[step]["step"]
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[step]["model"][k]), (path, k)
    with pytest.raises(FileNotFoundError):
        ckpt_lib.resolve_checkpoint(str(runs["root"]))


def test_evaluate_reproduces_best_row_without_sweeping(runs, tmp_path):
    """--evaluate RUN --eval-splits reproduces the best epoch's stored
    test.csv row, writes test_<tag>.csv rows whose counts add up, and leaves
    a tmp dir in the run's checkpoints/ alone; a writer sweeps it."""
    d = runs["straight"]
    stale = os.path.join(d, "checkpoints", "7.tmp-4194303")
    os.makedirs(stale)
    with open(os.path.join(stale, "checkpoint.pt"), "wb") as f:
        f.write(b"garbage from a killed save")
    keep = os.path.join(d, "checkpoints", "8.tmp-notapid")
    os.makedirs(keep)
    out = str(tmp_path / "eval")
    r = run(["--evaluate", d, "--eval-splits", "--platform", "cpu",
             "--output-dir", out])
    assert os.path.isdir(stale)
    test = rows(os.path.join(d, "test.csv"))
    best = min(test, key=lambda row: float(row["rmse"]))
    for k in METRIC_COLS:
        np.testing.assert_allclose(r["validation"][k], float(best[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert set(r["splits"]) == {"day", "night"}
    assert sum(m["count"] for m in r["splits"].values()) == \
        r["validation"]["count"] == 8
    for tag, m in r["splits"].items():
        row = rows(os.path.join(out, f"test_{tag}.csv"))[0]
        assert row["rmse"] == f"{m['rmse']:.6f}"
    assert not os.path.exists(os.path.join(out, ".trainer.lock"))
    ckpt_lib.CheckpointManager(d)  # a writer
    assert not os.path.exists(stale) and os.path.isdir(keep)
    os.rmdir(keep)


def test_from_run_without_cfg(runs):
    """Predictor.from_run reads config.json and the best checkpoint; its
    metrics on the val set are the best epoch's test.csv row."""
    d = runs["straight"]
    p = Predictor.from_run(d, device="cpu")
    assert p.cfg.arch == "resnet18_multistage" and p.cfg.height == 64
    batch = PackedDataset(os.path.join(runs["data"], "val")).batch(range(8))
    depth = p.predict(batch)
    assert depth.shape == (8, 64, 96) and np.isfinite(depth).all()
    best = min(rows(os.path.join(d, "test.csv")),
               key=lambda row: float(row["rmse"]))
    m = p.evaluate(batch)
    for k in METRIC_COLS:
        np.testing.assert_allclose(m[k], float(best[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_stage2_coarse_raises(tmp_path, runs):
    """A stage2_coarse model's stage 2 takes [filtered radar, coarse]: the
    Predictor builds it with a 2-channel stage-2 radar conv1 and serves, and
    from_run raises on a run trained without it (1-channel conv1)."""
    from radar_depth_tpu_torch.models import create_model, init_random

    scfg = config.ServeConfig(arch="resnet18_multistage", stage2_coarse=True,
                              height=64, width=96, num_sweeps=2)
    model, _ = create_model(scfg.arch, device="cpu", output_size=(64, 96),
                            **scfg.arch_kwargs())
    p = Predictor(scfg, init_random(model, 0).state_dict(), device="cpu")
    assert p.model.stage2.radar_encoder.conv1.weight.shape[1] == 2
    assert p.model.stage1.radar_encoder.conv1.weight.shape[1] == 1
    batch = PackedDataset(os.path.join(runs["data"], "val")).batch(range(2))
    assert np.isfinite(p.predict(batch)).all()
    cfg = config.load_config(os.path.join(runs["straight"], "config.json"))
    with pytest.raises(RuntimeError, match="stage2.radar_encoder.conv1"):
        Predictor.from_run(runs["straight"], device="cpu",
                           cfg=dataclasses.replace(
                               cfg, model=dataclasses.replace(
                                   cfg.model, stage2_coarse=True)))


@pytest.fixture(scope="module")
def latefusion(runs):
    """A 1-epoch resnet18_latefusion run, counting the watchdog's beats."""
    beats = []
    orig = StallWatchdog.beat

    def counting_beat(self):
        beats.append(1)
        return orig(self)

    out = str(runs["root"] / "late")
    with mock.patch.object(StallWatchdog, "beat", counting_beat):
        run(base_argv(runs["data"], "resnet18_latefusion")
            + ["--epochs", "1", "--output-dir", out])
    return out, beats


def test_watchdog_heartbeat_wiring(latefusion):
    """fit runs under the watchdog and beats once per batch: 2 train + 1
    val."""
    assert len(latefusion[1]) == 3


def test_init_from_and_stage1_path(runs, latefusion, tmp_path):
    """--stage1-path grafts a late-fusion run into both stages; --init-from
    loads a same-arch run's best weights with a fresh optimizer and epoch,
    and rejects another arch."""
    late = latefusion[0]
    src = ckpt_lib.load_payload(ckpt_lib.resolve_checkpoint(late))["model"]
    argv = base_argv(runs["data"]) + ["--epochs", "1"]
    tr = Trainer(config.parse_command(argv + ["--stage1-path", late,
                                              "--output-dir",
                                              str(tmp_path / "s2")]))
    try:
        tr.maybe_init_from_stage1()
        sd = tr.model.state_dict()
        for stage in ("stage1", "stage2"):
            for k, v in src.items():
                assert torch.equal(sd[f"{stage}.{k}"], v), (stage, k)
    finally:
        tr.close()

    d = runs["straight"]
    want = ckpt_lib.load_payload(ckpt_lib.resolve_checkpoint(d))["model"]
    tr = Trainer(config.parse_command(argv + ["--init-from", d,
                                              "--output-dir",
                                              str(tmp_path / "warm")]))
    try:
        tr.maybe_warm_start()
        for k, v in tr.model.state_dict().items():
            assert torch.equal(v, want[k]), k
        assert tr.start_epoch == 0 and tr.state.step == 0
        assert not tr.state.optimizer.state_dict()["state"]
    finally:
        tr.close()
    tr = Trainer(config.parse_command(
        base_argv(runs["data"], "resnet18_latefusion")
        + ["--init-from", d, "--output-dir", str(tmp_path / "bad")]))
    try:
        with pytest.raises(ValueError, match="does not match"):
            tr.maybe_warm_start()
    finally:
        tr.close()


def test_validate_splits(runs, tmp_path):
    """Per-split validation: day and night, counts adding up to the whole
    set, and under --metric-avg sample the metrics do not depend on the val
    batch size."""
    cfg = config.parse_command(base_argv(runs["data"]) + [
        "--metric-avg", "sample", "--output-dir", str(tmp_path)])
    tr = Trainer(cfg)
    try:
        splits = tr.validate_splits(0)
        assert set(splits) == {"day", "night"}
        overall = tr.validate(0, viz=False)
        assert sum(m["count"] for m in splits.values()) == \
            overall["count"] == 8
        tr.cfg = dataclasses.replace(cfg, eval_batch_size=3)
        again = tr.validate(0, viz=False)
        for k in METRIC_COLS:
            np.testing.assert_allclose(again[k], overall[k], rtol=1e-5,
                                       err_msg=k)
        tr.write_split_csvs(splits)
        for tag, m in splits.items():
            row = rows(str(tmp_path / f"test_{tag}.csv"))[0]
            assert row["rmse"] == f"{m['rmse']:.6f}"
    finally:
        tr.close()


def test_run_lock(tmp_path):
    """A live foreign holder refuses, a dead one's file does not block, the
    same process re-acquires (refcounted), release frees it."""
    from radar_depth_tpu_torch.utils.runlock import (
        acquire_run_lock,
        release_run_lock,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = ("from radar_depth_tpu_torch.utils.runlock import "
             f"acquire_run_lock; acquire_run_lock({str(tmp_path)!r})")

    def foreign():
        return subprocess.run([sys.executable, "-c", probe], cwd=repo,
                              capture_output=True, text=True, timeout=60)

    (tmp_path / ".trainer.lock").write_text("4194303\n")
    path = acquire_run_lock(str(tmp_path))
    assert (tmp_path / ".trainer.lock").read_text().strip() == str(os.getpid())
    assert acquire_run_lock(str(tmp_path)) == path
    rc = foreign()
    assert rc.returncode != 0 and "live trainer" in rc.stderr
    release_run_lock(path)
    rc = foreign()
    assert rc.returncode != 0 and "live trainer" in rc.stderr
    release_run_lock(path)
    assert foreign().returncode == 0
    release_run_lock(path)


def test_ckpt_every_cadence():
    assert all(should_checkpoint(e, False, 1, 10) for e in range(10))
    assert [e for e in range(10) if should_checkpoint(e, False, 4, 10)] == \
        [1, 5, 9]
    assert should_checkpoint(2, True, 4, 10)
    assert should_checkpoint(9, False, 100, 10)
    assert not should_checkpoint(8, False, 100, 10)


def test_watchdog_fires_beats_and_exit_code(monkeypatch):
    fired = []
    wd = StallWatchdog(timeout=0.15, on_stall=fired.append, poll=0.02).start()
    deadline = time.monotonic() + 5.0
    while not fired and time.monotonic() < deadline:
        time.sleep(0.02)
    wd.stop()
    assert fired and fired[0] > 0.15
    alive = []
    wd = StallWatchdog(timeout=0.2, on_stall=alive.append, poll=0.02).start()
    for _ in range(15):
        wd.beat()
        time.sleep(0.03)
    wd.stop()
    assert not alive
    off = StallWatchdog(timeout=0.0, on_stall=alive.append).start()
    assert off._thread is None
    calls = []
    monkeypatch.setattr(os, "_exit", calls.append)
    StallWatchdog(timeout=5.0)._default_on_stall(7.0)
    assert calls == [86]


def test_csv_schema_and_best_txt_match_jax(tmp_path):
    metrics = {"mse": 2.25, "rmse": 1.5, "absrel": 0.125, "lg10": 0.0625,
               "mae": 1.0, "delta1": 0.5, "delta2": 0.75, "delta3": 0.875,
               "data_time": 0.01, "gpu_time": 0.02, "irmse": 3.0}
    assert csvlog.FIELDNAMES == jcsvlog.FIELDNAMES
    for mod, name in ((csvlog, "port"), (jcsvlog, "jax")):
        log = mod.EpochCSVLogger(str(tmp_path / name / "test.csv"))
        log.append(0, metrics)
        log.append(1, metrics)
        mod.write_best_txt(str(tmp_path / name / "best.txt"), 1, metrics)
    for f in ("test.csv", "best.txt"):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes())


def test_png_panel_matches_jax(tmp_path):
    """The comparison panel equals the JAX package's array, and the PNG the
    port writes without PIL reads back (through PIL) equal to it."""
    from PIL import Image

    rng = np.random.default_rng(0)
    prepared = {
        "rgb": rng.uniform(size=(2, 24, 40, 3)).astype(np.float32),
        "radar": ((rng.uniform(size=(2, 24, 40, 1)) > 0.95)
                  * rng.uniform(1, 80, size=(2, 24, 40, 1))).astype(
                      np.float32),
        "target": rng.uniform(-1, 90, size=(2, 24, 40, 1)).astype(np.float32),
        "pred": rng.uniform(0, 90, size=(2, 24, 40, 1)).astype(np.float32)}
    panel = viz.comparison_panel(prepared, max_rows=2)
    want = jviz.comparison_panel(prepared, max_rows=2)
    np.testing.assert_array_equal(panel, want)
    viz.save_image(panel, str(tmp_path / "p.png"))
    with Image.open(tmp_path / "p.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), want)


UNPORTED = [(["--decoder", "deconv2"], "item 9"),
            (["--arch", "resnet34_multistage"], "item 9"),
            (["--arch", "resnet18"], "item 9"),
            (["--multistage-uncertainty"], "item 9"),
            (["--sparsifier", "uar"], "item 9"),
            (["--remat"], "item 9"),
            (["--stage2-coarse"], "item 9"),
            (["--pretrained", "w.pth"], "item 9"),
            (["--spatial", "2"], "torchrun")]


@pytest.mark.parametrize("extra,item", UNPORTED,
                         ids=[" ".join(a) for a, _ in UNPORTED])
def test_unported_settings_raise(tmp_path, extra, item):
    """--spatial 2 parses, and building the Trainer with it in one process
    raises ValueError asking for a multiple of 2 torchrun ranks, before the
    output dir is made (tests/test_torch_spatial_trainer.py runs it under
    torchrun). The settings that item 9 ported (archs, decoders, --sparsifier,
    --remat, --stage2-coarse, --pretrained with a torchvision state_dict on
    disk) are no longer reported and build a Trainer."""
    out = tmp_path / "out"
    if "w.pth" in extra:
        from tests.test_pretrained import _fake_torchvision_sd

        torch.save(_fake_torchvision_sd()[1], tmp_path / "w.pth")
        extra = [str(tmp_path / a) if a == "w.pth" else a for a in extra]
    argv = ["--arch", "resnet18_multistage", "--platform", "cpu",
            "--output-dir", str(out)] + extra
    if item == "torchrun":
        with pytest.raises(ValueError, match="multiple of 2 ranks"):
            Trainer(config.parse_command(argv))
        assert not out.exists()
        return
    cfg = config.parse_command(argv + ["--height", "64", "--width", "96",
                                       "--num-train", "4", "--num-val", "2",
                                       "-b", "2"])
    assert config.unported(cfg) == []
    tr = Trainer(cfg)
    try:
        assert tr.arch_spec.name == cfg.model.arch
        if cfg.model.pretrained:
            assert [r[1] for r in tr.pretrained_report] == [100, 99, 100, 99]
    finally:
        tr.close()


def test_default_platform_needs_a_card(tmp_path):
    """Without --platform cpu the harness runs on the CUDA card, and without
    one it raises before touching the output dir."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        run(["--arch", "resnet18_multistage", "--epochs", "1",
             "--output-dir", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")
