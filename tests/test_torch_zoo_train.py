"""Training features of the rest of the zoo against the JAX package, on the
CPU at 64x96, B=2, 3 sweeps: one float32 train step of a single-branch arch
(resnet18 rgbd / deconv2, and d / upconv under --sparsifier uar) and of
resnet18_multistage_uncertainty with stage2_coarse, against the jitted JAX
step (setup and tolerances of tests/test_torch_train.py, whose helpers this
file uses); --remat against the plain step (float64 gradients within 1e-6,
BN statistics bit-equal); the sparsifiers bit-exact under JAX's own uniform
draws; --pretrained against the JAX graft; --stage1-path into a
--stage2-coarse stage 2; and config.unported.

jax.random streams cannot be reproduced in torch, so the sparsifiers take
their draws as an argument and the tests pass JAX's, as the augmentation
parameters are passed (ops/augment.py::sample_affine_params)."""

import contextlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.config import DataConfig as JaxDataConfig
from radar_depth_tpu.config import ModelConfig as JaxModelConfig
from radar_depth_tpu.config import TrainConfig as JaxTrainConfig
from radar_depth_tpu.data import SampleSpec as JaxSampleSpec
from radar_depth_tpu.models import create_model as jax_create_model
from radar_depth_tpu.ops.preprocess import PreprocessConfig as JaxPreprocess
from radar_depth_tpu.ops.preprocess import (
    prepare_eval_batch as jax_prepare_eval,
)
from radar_depth_tpu.ops.sparsify import SPARSIFIERS as JAX_SPARSIFIERS
from radar_depth_tpu.train import step as jstep
from radar_depth_tpu.train.state import create_train_state as jax_train_state
from radar_depth_tpu.train.state import make_optimizer
from radar_depth_tpu.utils.torch_convert import (
    graft_pretrained_encoders as jax_graft,
)
from radar_depth_tpu_torch import config
from radar_depth_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from radar_depth_tpu_torch.convert import (
    graft_pretrained_encoders,
    state_dict_from_jax_variables,
)
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.models import ARCH_REGISTRY, create_model, fusion
from radar_depth_tpu_torch.models.layers import BatchNorm
from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.augment import AugmentConfig, sample_affine_params
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    prepare_eval_batch,
    prepare_train_batch,
)
from radar_depth_tpu_torch.ops.sparsify import SPARSIFIERS
from radar_depth_tpu_torch.train.loop import Trainer, widen_to_template
from radar_depth_tpu_torch.train.state import create_train_state
from radar_depth_tpu_torch.train.step import make_micro_grad_fn, make_train_step
from tests.test_pretrained import _fake_torchvision_sd
from tests.test_torch_models import random_jax_variables
from tests.test_torch_train import (  # noqa: F401  (fixture)
    B,
    F64_TOL,
    H,
    STEPS_PER_EPOCH,
    SWEEPS,
    UPDATE_TOL,
    W,
    _assert_close,
    _assert_stats,
    _assert_sums,
    _aug_params,
    _torch_tree,
    _train_variables,
    native_float32_convs,
)

SPEC = dict(height=H, width=W, num_sweeps=SWEEPS)

# (arch, model flags, data flags) of the train steps held against JAX
STEP_CASES = [
    ("resnet18", dict(modality="rgbd", decoder="deconv2"), {}),
    ("resnet18", dict(modality="d", decoder="upconv"),
     dict(sparsifier="uar", num_samples=300)),
    ("resnet18_multistage_uncertainty",
     dict(decoder="upproj", stage2_coarse=True, abs_threshold=20.0), {}),
]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(n=B, seed=5):
    return SyntheticNuScenes(n, spec=SampleSpec(**SPEC, lidar_points=2048),
                             seed=seed).batch(range(n))


def _variables_for_training(jmodel, inputs, seed):
    """random_jax_variables made ready for a train step as
    test_torch_train._train_variables does; the uncertainty archs'
    top-level ``stage_log_var`` stays random (so both of its loss terms
    are live)."""
    v = random_jax_variables(jmodel, inputs, seed)
    params = dict(v["params"])
    log_var = params.pop("stage_log_var", None)
    out = _train_variables({"params": params,
                            "batch_stats": v["batch_stats"]})
    if log_var is not None:
        out["params"]["stage_log_var"] = log_var
    return out


@pytest.mark.parametrize("arch,model_kw,data_kw", STEP_CASES,
                         ids=["resnet18-rgbd-deconv2", "resnet18-d-upconv-uar",
                              "multistage_uncertainty-stage2_coarse"])
def test_train_step_matches_jax(arch, model_kw, data_kw, monkeypatch):
    """One float32 SGD step of the jitted JAX step and of the port: the
    metric and loss sums, every parameter update (``stage_log_var``
    included) and the BN running statistics. Under the sparsifier both draw
    the same uniforms: JAX from the step's key, the port handed them; the
    z-buffer is never reached."""
    jcfg = JaxTrainConfig(data=JaxDataConfig(**SPEC, **data_kw),
                          model=JaxModelConfig(arch=arch, **model_kw),
                          batch_size=B)
    cfg = TrainConfig(data=DataConfig(**SPEC, **data_kw),
                      model=ModelConfig(arch=arch, **model_kw), batch_size=B)
    jmodel, jspec = jax_create_model(arch, output_size=(H, W), **model_kw)
    inputs = jstep.pack_model_inputs(
        {"rgb": jnp.zeros((1, H, W, 3)), "radar": jnp.zeros((1, H, W, 1))},
        jspec.input_kind, jcfg.model.modality)
    variables = _variables_for_training(jmodel, inputs, seed=12)
    batch = _batch()
    tx = make_optimizer(jcfg.optim, STEPS_PER_EPOCH)
    jstate = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                             tx)
    key = jax.random.PRNGKey(7)
    jstate, jsums = jax.jit(jstep.make_train_step(jmodel, jspec, jcfg, tx))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    model, spec = create_model(arch, device="cpu", output_size=(H, W),
                               **model_kw)
    model.load_state_dict(state_dict_from_jax_variables(
        variables, like=model.state_dict()))
    state = create_train_state(model, cfg.optim, STEPS_PER_EPOCH)
    step_key = jax.random.fold_in(key, 0)
    if data_kw:
        reached = []
        for name in ("zbuffer_min_depth_sorted", "zbuffer_min_depth"):
            monkeypatch.setattr(kernels, name, lambda *a, **k: reached.append(a))
        u = np.asarray(jax.random.uniform(step_key, (B, H, W)))
        sums = make_train_step(model, spec, cfg)(state, batch,
                                                 sparse_u=torch.from_numpy(u))
        assert not reached
    else:
        sums = make_train_step(model, spec, cfg)(
            state, batch, aug_params=_aug_params(step_key))
    _assert_sums(sums, jsums)
    before = _torch_tree(variables["params"], "params")
    jp = _torch_tree(jstate.params, "params")
    _assert_close({k: v.detach().double().numpy() - before[k]
                   for k, v in model.named_parameters()},
                  {k: v - before[k] for k, v in jp.items()}, UPDATE_TOL,
                  "update")
    _assert_stats(model, _torch_tree(jstate.batch_stats, "batch_stats"))
    if "uncertainty" in arch:
        assert not np.array_equal(jp["stage_log_var"],
                                  before["stage_log_var"])


def _remat_pair(dtype=torch.float64):
    cfg = TrainConfig(data=DataConfig(**SPEC),
                      model=ModelConfig(arch="resnet18_multistage",
                                        abs_threshold=20.0), batch_size=B)
    models = {}
    for remat in (False, True):
        m, spec = create_model("resnet18_multistage", device="cpu",
                               output_size=(H, W), dtype=dtype,
                               param_dtype=dtype, abs_threshold=20.0,
                               remat=remat)
        models[remat] = m
    from radar_depth_tpu_torch.train.loop import init_model

    init_model(models[False], 4)
    with torch.no_grad():
        for name, p in models[False].named_parameters():
            if name.endswith("conv3.weight"):
                p.abs_().mul_(50.0)  # positive depth-sized heads
    models[True].load_state_dict(models[False].state_dict())
    return cfg, spec, models


def test_remat_matches_plain_step(monkeypatch):
    """--remat recomputes each stage in the backward (every train-mode BN
    runs twice) and gives the plain step's gradients within 1e-6 in float64
    and its BN running statistics bit for bit: the recompute leaves them
    alone, as flax's nn.remat does. Without that guard the statistics would
    move twice, and this test sees it."""
    cfg, spec, models = _remat_pair()
    batch = _batch()
    aug = sample_affine_params(torch.Generator().manual_seed(3),
                               AugmentConfig(), B)
    calls = []
    orig = BatchNorm._train_forward

    def counting(self, *args):
        calls.append(self)
        return orig(self, *args)

    monkeypatch.setattr(BatchNorm, "_train_forward", counting)
    out = {}
    for remat, model in models.items():
        calls.clear()
        grads, sums = make_micro_grad_fn(model, spec, cfg)(batch,
                                                           aug_params=aug)
        n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
        assert len(calls) == n_bn * (2 if remat else 1)
        out[remat] = (grads, sums, {k: v.clone() for k, v in
                                    model.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))})
    (g0, s0, st0), (g1, s1, st1) = out[False], out[True]
    assert float(s0["loss"]) == pytest.approx(float(s1["loss"]), rel=1e-12)
    _assert_close({k: v.numpy() for k, v in g1.items()},
                  {k: v.numpy() for k, v in g0.items()}, F64_TOL, "gradient")
    for k, v in st0.items():
        assert torch.equal(st1[k], v), k

    # the hazard: a recompute that updates the statistics moves them twice
    cfg, spec, models = _remat_pair()
    monkeypatch.setattr(fusion, "frozen_running_stats",
                        lambda stage: contextlib.nullcontext())
    make_micro_grad_fn(models[True], spec, cfg)(batch, aug_params=aug)
    moved = models[True].state_dict()
    assert not all(torch.equal(moved[k], v) for k, v in st0.items())


def _depth_maps():
    """(3, 48, 64) LiDAR-like depth: dense (more valid pixels than
    num_samples), sparse (fewer), and empty; depths beyond both ends of
    [1, 80] m so the stereo bands clamp."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.3, 110.0, size=(3, 48, 64)).astype(np.float32)
    depth *= rng.uniform(size=depth.shape) < np.array([0.6, 0.03, 0.0])[
        :, None, None]
    return depth


@pytest.mark.parametrize("name", ["uar", "sim_stereo"])
def test_sparsifier_matches_jax_with_injected_draws(name):
    depth = _depth_maps()
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, depth.shape))
    want = np.asarray(JAX_SPARSIFIERS[name](jnp.asarray(depth), key, 200))
    got = SPARSIFIERS[name](torch.from_numpy(depth), 200,
                            u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    kept = (want > 0).sum(axis=(1, 2))
    assert 0 < kept[0] < (depth[0] > 0).sum() and kept[2] == 0
    if name == "uar":  # p = 1 below num_samples
        assert kept[1] == (depth[1] > 0).sum()
    # drawn from a generator: the same draws for the same seed, about
    # num_samples kept where there are more candidates
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    a = SPARSIFIERS[name](torch.from_numpy(depth), 200, generator=gen())
    b = SPARSIFIERS[name](torch.from_numpy(depth), 200, generator=gen())
    assert torch.equal(a, b)
    assert abs(int((a[0] > 0).sum()) - 200) < 5 * np.sqrt(200)


@pytest.mark.parametrize("name", ["uar", "sim_stereo"])
def test_sparsifier_batches_match_jax(name, monkeypatch):
    """prepare_eval_batch with a sparsifier: the sparse channel sampled from
    the LiDAR target with JAX's draws, bit-exact, and no z-buffer; the train
    path takes the same batch, unaugmented, and needs draws or a
    generator."""
    batch = _batch(seed=3)
    key = jax.random.PRNGKey(5)
    want = jax_prepare_eval(
        {k: jnp.asarray(v) for k, v in batch.items()},
        JaxPreprocess(spec=JaxSampleSpec(**SPEC), sparsifier=name,
                      num_samples=150), key)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (B, H, W))))
    reached = []
    for fn in ("zbuffer_min_depth_sorted", "zbuffer_min_depth"):
        monkeypatch.setattr(kernels, fn, lambda *a, **k: reached.append(a))
    cfg = PreprocessConfig(spec=SampleSpec(**SPEC), sparsifier=name,
                           num_samples=150)
    got = prepare_eval_batch(batch, cfg, "cpu", sparse_u=u)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert 0 < int((got["radar"] > 0).sum()) < int((got["target"] > 0).sum())
    train = prepare_train_batch(batch, cfg, device="cpu", sparse_u=u)
    for k in want:
        assert torch.equal(train[k], got[k]), k
    assert not reached
    with pytest.raises(ValueError, match="sparse_u or a generator"):
        prepare_train_batch(batch, cfg, device="cpu")
    with pytest.raises(ValueError, match="sparsifier"):
        PreprocessConfig(sparsifier="lidar")


@pytest.mark.parametrize("arch,depth", [("resnet18_multistage", 18),
                                        ("resnet50", 50)])
def test_pretrained_graft_matches_jax(arch, depth):
    """A synthetic torchvision ResNet state_dict grafted into every encoder:
    the port's graft on the model's state_dict equals the JAX package's on
    its variable trees, converted; the reports agree (the 1-channel radar
    and 4-channel early-fusion conv1 keep their weights, 'shape')."""
    kw = dict(modality="rgbd") if arch == "resnet50" else {}
    jmodel, jspec = jax_create_model(arch, output_size=(H, W))
    inputs = jstep.pack_model_inputs(
        {"rgb": jnp.zeros((1, H, W, 3)), "radar": jnp.zeros((1, H, W, 1))},
        jspec.input_kind, "rgbd")
    variables = random_jax_variables(jmodel, inputs, seed=2)
    _, tv = _fake_torchvision_sd(depth)
    jp, js, jreport = jax_graft(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]),
        {k: v.numpy() for k, v in tv.items()})
    want = state_dict_from_jax_variables({"params": jp, "batch_stats": js})

    model, _ = create_model(arch, device="cpu", output_size=(H, W), **kw)
    sd = state_dict_from_jax_variables(variables, like=model.state_dict())
    got, report = graft_pretrained_encoders(sd, tv)
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    changed = [k for k in sd if not torch.equal(sd[k], got[k])]
    assert changed and all("encoder." in k for k in changed)
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}

    def torch_name(skip):
        path, why = skip.split(" ")
        *mods, last = path.split("/")
        return f"{'.'.join(mods + [leaf[last]])} {why}"

    assert [(n, c, [torch_name(s) for s in sk]) for n, c, sk in jreport] == \
        [(n, c, sk) for n, c, sk in report]
    assert all(sk == ["conv1.weight (shape)"] for n, _, sk in report
               if "radar" in n or arch == "resnet50")


def _late_run(tmp_path):
    """A 1-epoch resnet18_latefusion run (upproj, 64x96) on synthetic
    data."""
    from radar_depth_tpu_torch.train.main import run

    out = str(tmp_path / "late")
    run(["--arch", "resnet18_latefusion", "--height", str(H), "--width",
         str(W), "--num-sweeps", str(SWEEPS), "--num-train", "2",
         "--num-val", "2", "-b", "2", "--epochs", "1", "--platform", "cpu",
         "--print-freq", "100", "--output-dir", out])
    return out


def test_stage1_graft_widens_stage2_coarse(tmp_path):
    """--stage1-path into a --stage2-coarse multistage model: stage 2's
    radar conv1 gets the late-fusion kernel with zeros on the coarse
    channel, so the model computes what the 1-channel graft computes."""
    late = _late_run(tmp_path)
    trainers = {}
    for coarse in (False, True):
        argv = ["--arch", "resnet18_multistage", "--height", str(H),
                "--width", str(W), "--num-sweeps", str(SWEEPS),
                "--num-train", "2", "--num-val", "2", "-b", "2",
                "--platform", "cpu", "--abs-threshold", "20",
                "--stage1-path", late,
                "--output-dir", str(tmp_path / f"ms{int(coarse)}")]
        tr = Trainer(config.parse_command(
            argv + (["--stage2-coarse"] if coarse else [])))
        tr.maybe_init_from_stage1()
        trainers[coarse] = tr
    try:
        w = trainers[True].model.stage2.radar_encoder.conv1.weight
        w1 = trainers[False].model.stage2.radar_encoder.conv1.weight
        assert w.shape[1] == 2 and torch.equal(w[:, :1], w1)
        assert not w[:, 1:].any()
        rng = np.random.default_rng(0)
        rgb = torch.from_numpy(rng.uniform(size=(2, H, W, 3)).astype(
            np.float32))
        radar = torch.from_numpy(((rng.uniform(size=(2, H, W, 1)) > 0.9)
                                  * rng.uniform(3, 60, (2, H, W, 1))).astype(
                                      np.float32))
        with torch.inference_mode():
            want = trainers[False].model.eval()(rgb, radar)
            got = trainers[True].model.eval()(rgb, radar)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    finally:
        for tr in trainers.values():
            tr.close()
        shutil.rmtree(late, ignore_errors=True)
    with pytest.raises(ValueError, match="input-channel widening"):
        widen_to_template(torch.zeros(8, 2, 3, 3), torch.zeros(4, 1, 3, 3))


def test_unported_names_only_spatial():
    """Every item-9 setting is ported; --spatial alone is reported."""
    argv = ["--arch", "resnet34_multistage", "--multistage-uncertainty",
            "--decoder", "deconv3", "--stage2-coarse", "--remat",
            "--pretrained", "w.pth", "--sparsifier", "sim_stereo",
            "--modality", "d"]
    assert config.unported(config.parse_command(argv)) == []
    assert config.unported(config.parse_command(argv + ["--spatial", "2"])) \
        == ["--spatial 2 (ROADMAP Queue A item 10)"]
    for arch in config.ARCH_NAMES:
        assert arch in ARCH_REGISTRY
        assert config.unported(config.parse_command(["--arch", arch])) == []
