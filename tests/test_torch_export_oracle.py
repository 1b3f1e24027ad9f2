"""The port's export to the oracle's names (``convert.
oracle_state_dict_from_port``, ``port_state_dict_from_oracle`` and
``python -m radar_depth_tpu_torch.export_oracle``) against the JAX
package's ``variables_to_torch_state_dict`` and the oracle's torch modules
(``radar_depth_tpu/oracle/torch_model.py``) on the CPU.

Per arch and decoder, from random JAX variables (tests/test_torch_models.py's
draw) carried into the port by ``state_dict_from_jax_variables``: the port's
export has the JAX export's keys and every tensor bit-equal (the transposed
convs of deconv2/deconv3 included); it loads into the oracle with
``strict=True``, and the oracle's eval forward matches the port's within the
parity tolerance of tests/test_parity_torch.py (atol 2e-4, rtol 1e-3: two
libraries' conv sums in different orders); and port -> oracle -> port is
the identity. 64x96, B=2, float32, oneDNN convolutions off."""

import contextlib
import functools
import importlib.util
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.models import create_model as jax_create_model
from radar_depth_tpu.oracle.torch_model import (
    TorchDepthNet,
    TorchLateFusionNet,
    TorchMultiStageNet,
)
from radar_depth_tpu.ops.preprocess import pack_model_inputs as jax_pack
from radar_depth_tpu.utils.torch_convert import variables_to_torch_state_dict
from radar_depth_tpu_torch import export_oracle
from radar_depth_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
    save_config,
)
from radar_depth_tpu_torch.convert import (
    oracle_state_dict_from_port,
    port_state_dict_from_oracle,
    state_dict_from_jax_variables,
)
from radar_depth_tpu_torch.models import (
    ARCH_REGISTRY,
    MODALITY_CHANNELS,
    create_model,
    init_random,
)
from radar_depth_tpu_torch.ops.preprocess import pack_model_inputs
from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
from radar_depth_tpu_torch.train.state import create_train_state
from tests.test_torch_models import OUT, TOL, _inputs, random_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (arch, decoder, modality); deconv2/deconv3 carry `convt`
CASES = [
    ("resnet18", "upproj", "rgb"),
    ("resnet18", "deconv2", "rgbd"),
    ("resnet18_latefusion", "upproj", "rgbd"),
    ("resnet18_latefusion", "deconv3", "rgbd"),
    ("resnet18_latefusion", "upconv", "rgbd"),
    ("resnet18_multistage", "upproj", "rgbd"),
]
IDS = ["-".join(c) for c in CASES]
ABS_THRESHOLD = 8.0  # the filter keeps some radar with random weights


@pytest.fixture(autouse=True)
def native_float32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _oracle(arch, decoder, modality):
    if arch == "resnet18":
        return TorchDepthNet(18, MODALITY_CHANNELS[modality], decoder, OUT)
    if arch == "resnet18_latefusion":
        return TorchLateFusionNet(18, decoder, OUT)
    return TorchMultiStageNet(18, decoder, OUT, abs_threshold=ABS_THRESHOLD)


def _kw(arch, modality):
    if "multistage" in arch:
        return dict(abs_threshold=ABS_THRESHOLD)
    return dict(modality=modality)


@functools.lru_cache(maxsize=None)
def _jax_variables(arch, decoder, modality):
    rgb, radar = _inputs(seed=7)
    jin = jax_pack({"rgb": jnp.asarray(rgb), "radar": jnp.asarray(radar)},
                   ARCH_REGISTRY[arch].input_kind, modality)
    jmodel, _ = jax_create_model(arch, decoder=decoder, output_size=OUT,
                                 **_kw(arch, modality))
    return random_jax_variables(jmodel, jin, seed=8)


def _case(arch, decoder, modality):
    """(JAX variables, the port model holding them, port inputs NHWC)."""
    variables = _jax_variables(arch, decoder, modality)
    model, _ = create_model(arch, device="cpu", decoder=decoder,
                            output_size=OUT, **_kw(arch, modality))
    model.load_state_dict(state_dict_from_jax_variables(
        variables, like=model.state_dict()))
    rgb, radar = _inputs(seed=7)
    inputs = pack_model_inputs(
        {"rgb": torch.from_numpy(rgb), "radar": torch.from_numpy(radar)},
        ARCH_REGISTRY[arch].input_kind, modality)
    return variables, model, inputs


def _nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_export_matches_jax_export(case):
    variables, model, _ = _case(*case)
    got = oracle_state_dict_from_port(model.state_dict())
    want = variables_to_torch_state_dict(variables)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and g.is_contiguous(), k
        assert tuple(g.shape) == w.shape, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    convt = [k for k in got if k.endswith(".convt.weight")]
    assert bool(convt) == case[1].startswith("deconv")
    for k in convt:  # (I,O,k,k) in the oracle, (O,I,k,k) in the port
        assert got[k].shape == model.state_dict()[k].transpose(0, 1).shape
        assert got[k].shape[0] > got[k].shape[1]  # the decoder halves C
    assert "num_batches_tracked" not in " ".join(got)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_export_loads_into_oracle_and_matches_port(case):
    _, model, inputs = _case(*case)
    oracle = _oracle(*case).eval()
    oracle.load_state_dict(oracle_state_dict_from_port(model.state_dict()),
                           strict=True)
    with torch.inference_mode():
        want = oracle(*map(_nchw, inputs))
        got = model(*inputs)
    if not ARCH_REGISTRY[case[0]].multistage:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.permute(0, 2, 3, 1)
        assert g.shape == w.shape == (2, *OUT, 1)
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_oracle_port_is_identity(case):
    _, model, _ = _case(*case)
    want = model.state_dict()
    got = port_state_dict_from_oracle(oracle_state_dict_from_port(want),
                                      like=want)
    assert list(got) == list(want)
    for k, w in want.items():
        assert torch.equal(got[k], w) and got[k].is_contiguous(), k


def test_oracle_state_dict_into_the_port():
    """The oracle's own state_dict (with nn.BatchNorm2d's
    num_batches_tracked, which no port module holds) into the port: the
    same forward."""
    torch.manual_seed(0)
    oracle = TorchLateFusionNet(18, "deconv3", OUT)
    oracle.train()
    rgb, radar = (torch.from_numpy(x) for x in _inputs(seed=9))
    with torch.no_grad():  # non-trivial running statistics
        oracle(_nchw(rgb), _nchw(radar))
    oracle.eval()
    model, _ = create_model("resnet18_latefusion", device="cpu",
                            decoder="deconv3", output_size=OUT)
    model.load_state_dict(port_state_dict_from_oracle(
        oracle.state_dict(), like=model.state_dict()))
    with torch.inference_mode():
        want = oracle(_nchw(rgb), _nchw(radar)).permute(0, 2, 3, 1)
        got = model(rgb, radar)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_port_from_oracle_checks_keys_and_shapes():
    model, _ = create_model("resnet18", device="cpu", decoder="deconv2",
                            output_size=OUT)
    like = model.state_dict()
    sd = oracle_state_dict_from_port(like)
    first = next(iter(sd))
    with pytest.raises(KeyError, match="missing"):
        port_state_dict_from_oracle(
            {k: v for k, v in sd.items() if k != first}, like=like)
    with pytest.raises(KeyError, match="extra"):
        port_state_dict_from_oracle(
            dict(sd, **{"extra.weight": torch.zeros(1)}), like=like)
    with pytest.raises(ValueError, match="shape"):
        port_state_dict_from_oracle(dict(sd, **{first: sd[first][:1]}),
                                    like=like)
    with pytest.raises(KeyError, match="running_std"):
        port_state_dict_from_oracle({"bn.running_std": torch.ones(2)})


def test_uncertainty_arch_raises_key_error():
    """``stage_log_var`` has no oracle counterpart: the JAX export raises
    KeyError, and so does the port's, naming the leaf."""
    arch = "resnet18_multistage_uncertainty"
    variables, model, _ = _case(arch, "upproj", "rgbd")
    assert "stage_log_var" in variables["params"]
    with pytest.raises(KeyError):
        variables_to_torch_state_dict(variables)
    with pytest.raises(KeyError, match="stage_log_var"):
        oracle_state_dict_from_port(model.state_dict())


def test_flags_match_jax_script(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_export_torch", os.path.join(REPO, "scripts", "export_torch.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)

    def flags(main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            main()
        return {t.strip("[](),.") for t in out.getvalue().split()
                if t.startswith(("--", "[--"))}

    monkeypatch.setattr(sys, "argv", ["export_torch.py", "--help"])
    want = flags(jax_script.main)
    assert flags(lambda: export_oracle.main(["--help"])) == want
    assert {"--run", "--out", "--arch", "--modality", "--decoder", "--height",
            "--width"} < want


def test_cli_exports_the_best_checkpoint(tmp_path):
    """A run directory written by the port's train/checkpoint.py, two
    epochs with the better RMSE first: the CLI writes the best epoch's
    weights under the oracle's names, and they load into the oracle."""
    run = str(tmp_path / "run")
    cfg = TrainConfig(data=DataConfig(height=OUT[0], width=OUT[1]),
                      model=ModelConfig(arch="resnet18_latefusion",
                                        decoder="deconv2"))
    os.makedirs(run)
    save_config(cfg, os.path.join(run, "config.json"))
    mgr = ckpt_lib.CheckpointManager(run)
    models = []
    for epoch, rmse in ((0, 2.0), (1, 3.0)):
        model, _ = create_model("resnet18_latefusion", device="cpu",
                                decoder="deconv2", output_size=OUT)
        init_random(model, seed=epoch)
        mgr.save(epoch, create_train_state(model, cfg.optim, 2),
                 {"rmse": rmse}, wait=True)
        models.append(model)
    mgr.close()
    out = str(tmp_path / "exp.pth")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = export_oracle.main(["--run", run, "--out", out, "--arch",
                                 "resnet18_latefusion", "--decoder", "deconv2",
                                 "--height", str(OUT[0]), "--width",
                                 str(OUT[1])])
    assert rc == 0
    sd = torch.load(out, weights_only=True)
    assert buf.getvalue() == f"exported {len(sd)} tensors → {out}\n"
    want = oracle_state_dict_from_port(models[0].state_dict())
    assert list(sd) == list(want)
    for k, w in want.items():
        assert sd[k].device.type == "cpu" and sd[k].dtype == torch.float32
        assert torch.equal(sd[k], w), k
    TorchLateFusionNet(18, "deconv2", OUT).load_state_dict(sd, strict=True)
    # and back: bit-equal to the checkpoint the CLI read
    payload = ckpt_lib.load_payload(ckpt_lib.resolve_checkpoint(run))
    back = port_state_dict_from_oracle(sd, like=payload["model"])
    assert all(torch.equal(back[k], v) for k, v in payload["model"].items())
