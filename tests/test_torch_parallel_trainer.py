"""The port's training harness data-parallel through its real command line:
``torchrun --standalone --nproc-per-node N -m radar_depth_tpu_torch.train.main
--platform cpu`` (gloo), on packed SyntheticNuScenes shards through the
native loader with host augmentation, the flagship at 64x96, 2 sweeps,
global batch 4, 8 train and 5 val samples (a ragged last val batch), one
epoch, beside the same run in one process without a process group.

- 2 ranks: rank 0 alone writes the run directory and prints; test.csv's row
  equals the single process's within rtol 1e-4 (the two runs differ in the
  order of their float32 reductions); the replicas end bit-equal (the
  Trainer checks it and says so); ``--evaluate`` of the run under 2 ranks
  reproduces the stored row.
- 1 rank under torchrun (a gloo group of one, every collective issued):
  train.csv and test.csv equal the run without a group digit for digit.
"""

import csv
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from radar_depth_tpu_torch.train.main import run
from tests.test_torch_harness import write_split

METRICS = ("mse", "rmse", "absrel", "lg10", "mae", "delta1", "delta2",
           "delta3")
ROW_RTOL = 1e-4
EVAL_RTOL = 1e-5  # beside the stored row's 6-decimal rounding
TIMEOUT_S = 600
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# train.main's run() under torchrun, rank 0 printing the metrics unrounded
EVAL_SCRIPT = textwrap.dedent("""\
    import json, os, sys
    from radar_depth_tpu_torch.train.main import run
    r = run(sys.argv[1:])
    if os.environ["RANK"] == "0":
        print("VALIDATION " + json.dumps(r["validation"]), flush=True)
    """)


def _argv(data):
    return ["--arch", "resnet18_multistage", "--decoder", "upproj",
            "-b", "4", "--dataset", "packed", "--data-root", data,
            "--height", "64", "--width", "96", "--num-sweeps", "2",
            "--platform", "cpu", "--print-freq", "100", "--epochs", "1"]


def _torchrun(nproc, target, args):
    """torchrun on the CPU, started now; ``target`` is ``-m module`` or a
    script path."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), *target, *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"{out}\n{err[-6000:]}"
    return out


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    data = write_split(root / "data", num_train=8, num_val=5)
    dirs = {k: str(root / k) for k in ("dp2", "dp1", "single")}
    m = ["-m", "radar_depth_tpu_torch.train.main"]
    procs = {n: _torchrun(n, m, _argv(data) + ["--output-dir", dirs[f"dp{n}"]])
             for n in (2, 1)}
    out = {"dirs": dirs, "single": run(_argv(data) + ["--output-dir",
                                                       dirs["single"]])}
    out["stdout"] = {n: _finish(p) for n, p in procs.items()}
    script = root / "evaluate.py"
    script.write_text(EVAL_SCRIPT)
    proc = _torchrun(2, [str(script)], ["--evaluate", dirs["dp2"],
                                        "--platform", "cpu", "--output-dir",
                                        str(root / "eval")])
    out["evaluate"] = _finish(proc)
    yield out
    shutil.rmtree(root, ignore_errors=True)


def test_rank0_alone_writes_and_prints(runs):
    """One row per epoch in each CSV, one checkpoint, the run's files and
    one copy of each printed line."""
    d = runs["dirs"]["dp2"]
    names = set(os.listdir(d))
    assert {".trainer.lock", "config.json", "train.csv", "test.csv",
            "best.txt", "checkpoints", "comparison_epoch0.png"} <= names
    for name in ("train.csv", "test.csv"):
        assert [r["epoch"] for r in _rows(os.path.join(d, name))] == ["0"]
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == ["0"]
    out = runs["stdout"][2]
    assert out.count("epoch 0: val rmse=") == 1
    assert out.count("train data: native reader") == 1
    assert "2 ranks (gloo)" in out


def test_two_ranks_match_one_process(runs):
    """test.csv's row of the 2-rank run equals the single process's."""
    got = _rows(os.path.join(runs["dirs"]["dp2"], "test.csv"))[0]
    want = _rows(os.path.join(runs["dirs"]["single"], "test.csv"))[0]
    for k in METRICS:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=ROW_RTOL,
                                              abs=5e-7), k


def test_replicas_end_bit_equal(runs):
    assert "replicas bit-equal on 2 ranks after 2 steps" in runs["stdout"][2]


def test_evaluate_under_two_ranks_reproduces_the_row(runs):
    line = next(x for x in runs["evaluate"].splitlines()
                if x.startswith("VALIDATION "))
    got = json.loads(line[len("VALIDATION "):])
    best = _rows(os.path.join(runs["dirs"]["dp2"], "test.csv"))[0]
    for k in METRICS:
        stored = float(best[k])
        assert abs(got[k] - stored) <= 5e-7 + EVAL_RTOL * abs(stored), k


def test_one_rank_group_is_bit_equal_to_no_group(runs):
    """A 1-rank group issues every collective, each returning its input:
    the CSVs equal the run without a group digit for digit."""
    assert "1 ranks (gloo)" in runs["stdout"][1]
    for name in ("train.csv", "test.csv"):
        got = _rows(os.path.join(runs["dirs"]["dp1"], name))
        want = _rows(os.path.join(runs["dirs"]["single"], name))
        assert [{k: r[k] for k in METRICS} for r in got] == \
            [{k: r[k] for k in METRICS} for r in want], name
