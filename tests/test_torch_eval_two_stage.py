"""radar_depth_tpu_torch.eval_two_stage against the JAX package's
scripts/eval_two_stage.py on the CPU: a JAX run (seeded random weights,
no training) and its port twin (the same config.json, the weights
carried across with convert.state_dict_from_jax_variables), each script
run on a tagged packed val split at 64x96, 2 sweeps, B=8, over
``--split all,night`` with an abs-filter run (``--abs-threshold 15`` given
on the command line, so the random weights' coarse maps keep some radar)
and over the whole set with a rel-filter run (the mode adopted from
config.json). Their JSON lines
match: metrics within rtol 1e-4 plus the 5e-6 of the 5-decimal rounding;
the efficacy counts equal, except where a GT-checkable radar pixel's
|radar - coarse| lies within 1e-3 of the filter's threshold (the two
packages' coarse maps differ in the last bits), and the count differs by
no more than those pixels. An unknown tag exits 1 in both."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from radar_depth_tpu import config as jconfig
from radar_depth_tpu.models import create_model as jax_create_model
from radar_depth_tpu.train import checkpoint as jckpt
from radar_depth_tpu.train.state import create_train_state as jax_train_state
from radar_depth_tpu.train.state import make_optimizer
from radar_depth_tpu_torch import config
from radar_depth_tpu_torch import eval_two_stage
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data import SyntheticNuScenes
from radar_depth_tpu_torch.data.packed import write_shards
from radar_depth_tpu_torch.models import create_model
from radar_depth_tpu_torch.parallel.mesh import pad_batch_to
from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
from radar_depth_tpu_torch.train.state import create_train_state
from tests.test_torch_harness import (  # noqa: F401  (fixture)
    SPEC,
    base_argv,
    few_threads,
)
from tests.test_torch_models import random_jax_variables
from tests.test_torch_train import native_float32_convs  # noqa: F401

H, W = SPEC.height, SPEC.width
NUM_VAL = 8
TIE = 1e-3  # |radar - coarse| this close to a threshold may flip the filter


def _jax_script():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_eval_two_stage",
        os.path.join(repo, "scripts", "eval_two_stage.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tagged val split and, per filter mode, a JAX run and its port
    twin with the same config.json and weights."""
    root = tmp_path_factory.mktemp("two_stage")
    data = str(root / "data")
    ds = SyntheticNuScenes(NUM_VAL, spec=SPEC, seed=1)
    tags = [ds.sample_tag(i) for i in range(NUM_VAL)]
    assert {"day", "night"} <= set(tags)
    write_shards(os.path.join(data, "val"), (ds[i] for i in range(NUM_VAL)),
                 tags=tags)

    jmodel, _ = jax_create_model("resnet18_multistage", output_size=(H, W))
    rgb = np.zeros((1, H, W, 3), np.float32)
    variables = random_jax_variables(jmodel, (rgb, rgb[..., :1]), seed=17)
    out = {"data": data, "tags": tags}
    for mode in ("abs", "rel"):
        jrun, prun = str(root / f"jax_{mode}"), str(root / f"port_{mode}")
        os.makedirs(jrun)
        os.makedirs(prun)
        jcfg = jconfig.parse_command(base_argv(data) + [
            "--output-dir", jrun, "--filter-mode", mode])
        jconfig.save_config(jcfg, os.path.join(jrun, "config.json"))
        mgr = jckpt.CheckpointManager(jrun)
        mgr.save(0, jax.tree_util.tree_map(np.asarray, jax_train_state(
            variables, make_optimizer(jcfg.optim, 2))), {"rmse": 3.0},
            wait=True)
        mgr.close()

        cfg = config.load_config(os.path.join(jrun, "config.json"))
        config.save_config(cfg, os.path.join(prun, "config.json"))
        model, _ = create_model("resnet18_multistage", device="cpu",
                                output_size=(H, W), param_dtype=torch.float32)
        model.load_state_dict(state_dict_from_jax_variables(
            variables, like=model.state_dict()))
        ckpt_lib.CheckpointManager(prun).save(
            0, create_train_state(model, cfg.optim, 2), {"rmse": 3.0},
            wait=True)
        out[mode] = (jrun, prun)
    return out


def _argv(run, data, split):
    return ["--run", run, "--data-root", data, "--batch", "8",
            "--platform", "cpu"] + (["--split", split] if split else [])


def _jax_main(capsys, argv):
    mod = _jax_script()
    old = sys.argv
    sys.argv = ["eval_two_stage.py"] + argv
    try:
        rc = mod.main()
    finally:
        sys.argv = old
    return rc, capsys.readouterr().out


def _port_main(capsys, argv):
    rc = eval_two_stage.main(argv)
    return rc, capsys.readouterr().out


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _ties(argv, split):
    """Per split tag: the GT-checkable radar pixels whose |radar - coarse|
    lies within TIE of the run's filter threshold, from the port's coarse
    map (the efficacy counts may differ by at most these)."""
    args = eval_two_stage.parse_args(argv)
    ev = eval_two_stage.TwoStageEval(args)
    try:
        out = {}
        for split in split.split(","):
            idx = [i for i in range(len(ev.ds))
                   if split == "all" or ev.ds.sample_tag(i) == split]
            batch, _ = pad_batch_to(ev.ds.batch(idx), args.batch)
            coarse, _, target, radar, _ = ev.infer_both(batch)
            err = (radar - coarse).abs()
            limit = (args.abs_threshold if args.filter_mode == "abs"
                     else args.rel_threshold * coarse.clamp_min(1e-3))
            near = (radar > 0) & (target > 0) & ((err - limit).abs() < TIE)
            out[split] = int(near.sum())
        return out
    finally:
        ev.ds.close()


def _assert_match(mine, theirs, ties):
    assert list(mine) == list(theirs)
    for out in ("coarse", "refined", "coarse_radar_local",
                "refined_radar_local"):
        assert list(mine[out]) == list(theirs[out])
        np.testing.assert_allclose(
            [mine[out][k] for k in theirs[out]],
            [theirs[out][k] for k in theirs[out]], rtol=1e-4, atol=5e-6,
            err_msg=out)
    got, want = mine["filter_efficacy"], theirs["filter_efficacy"]
    assert list(got) == list(want)
    for k in ("radar_px", "gt_px", "corrupt_px", "clean_px"):
        assert got[k] == want[k], k
    assert want["gt_px"] > 0
    for k in ("corrupt_kept", "clean_kept"):
        assert abs(got[k] - want[k]) <= ties, (k, got[k], want[k], ties)


@pytest.mark.parametrize("mode,split,extra", [
    ("abs", "all,night", ["--abs-threshold", "15"]), ("rel", "", [])])
def test_matches_jax_script(runs, capsys, mode, split, extra):
    jrun, prun = runs[mode]
    rc_j, out_j = _jax_main(capsys, _argv(jrun, runs["data"], split) + extra)
    rc_p, out_p = _port_main(capsys, _argv(prun, runs["data"], split) + extra)
    assert rc_j == rc_p == 0
    assert f"filter={mode}" in out_p.splitlines()[0]  # from config.json
    mine, theirs = _json_lines(out_p), _json_lines(out_j)
    splits = split.split(",") if split else ["all"]
    assert len(mine) == len(theirs) == len(splits)
    ties = _ties(_argv(prun, runs["data"], "") + extra, ",".join(splits))
    for s, m, t in zip(splits, mine, theirs):
        _assert_match(m, t, ties[s])
    if split:  # the text lines name each split and its sample count
        n = runs["tags"].count("night")
        assert f"val n={n} split=night" in out_p


def test_unknown_split_exits_1(runs, capsys):
    jrun, prun = runs["abs"]
    rc_j, out_j = _jax_main(capsys, _argv(jrun, runs["data"], "dusk"))
    rc_p, out_p = _port_main(capsys, _argv(prun, runs["data"], "dusk"))
    assert rc_j == rc_p == 1
    assert out_p == out_j == "no samples tagged 'dusk'\n"
