"""The port's public ops API against the JAX package's on the CPU:
``radar_depth_tpu_torch.ops`` exports the names of ``radar_depth_tpu.ops``
and stays light to import; ``radar_to_depth_map`` and
``ops.raster.depth_map_to_points`` are bit-equal to the JAX functions (the
padding rows of ``depth_map_to_points`` included); and the profiling
helpers (``utils/profiling.py``) run as ``tests/test_utils.py`` runs the
JAX ones, and name the kernels' operators in the trace of a served
forward."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radar_depth_tpu.ops as jax_ops
import radar_depth_tpu_torch.ops as ops
from radar_depth_tpu.ops.raster import (
    depth_map_to_points as jax_depth_map_to_points,
)
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.ops.raster import (
    RASTER_BACKENDS,
    depth_map_to_points,
    radar_to_depth_map,
    rasterize_min_depth,
)

REPO = Path(__file__).resolve().parent.parent
SYNTH = SampleSpec(height=64, width=96, num_sweeps=3, lidar_points=2048)


def test_ops_exports_the_jax_names():
    assert ops.__all__ == jax_ops.__all__
    assert all(callable(getattr(ops, name)) for name in ops.__all__)
    assert set(dir(ops)) >= set(ops.__all__)
    with pytest.raises(AttributeError):
        ops.not_an_op  # noqa: B018


def test_ops_package_is_light_and_builds_nothing_on_the_cpu():
    """Importing the package loads neither raster nor the kernels' module;
    a call on the CPU runs the plain version and loads no CUDA library."""
    code = (
        "import sys\n"
        "import radar_depth_tpu_torch.ops as ops\n"
        "names = ops.__all__\n"
        "assert 'radar_depth_tpu_torch.ops.kernels' not in sys.modules\n"
        "assert 'radar_depth_tpu_torch.ops.raster' not in sys.modules\n"
        "import torch\n"
        "from radar_depth_tpu_torch.ops import kernels, radar_to_depth_map\n"
        "assert kernels._LIBS == {}\n"
        "T = torch.eye(4).expand(1, 2, 4, 4)\n"
        "K = torch.tensor([[30.0, 0, 20], [0, 30.0, 10], [0, 0, 1]])\n"
        "pts = torch.tensor([[[0.5, 0.2, 10.0]] * 3] * 2)[None]\n"
        "out = radar_to_depth_map(pts, torch.ones(1, 2, 3, dtype=torch.bool),"
        " T, K[None], 20, 40)\n"
        "assert out.shape == (1, 20, 40) and (out > 0).sum() == 1\n"
        "assert kernels._LIBS == {}\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _scene():
    """tests/test_raster.py's end-to-end scene: 2 sweeps of 30 points in
    front of a 20x40 camera, one of them moved by a small rotation."""
    rng = np.random.default_rng(0)
    h, w, s, p = 20, 40, 2, 30
    K = np.array([[30.0, 0, 20], [0, 30.0, 10], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform([-3, -1, 2], [3, 1, 40], size=(p, 3))
                    .astype(np.float32) for _ in range(s)])
    valid = rng.uniform(size=(s, p)) > 0.2
    q = np.stack([np.array([1.0, 0, 0, 0]),
                  np.array([0.999, 0.02, 0.02, 0.0])])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.stack([np.zeros(3), np.array([0.3, 0.1, -0.2])]).astype(np.float32)
    T = np.array(jax_ops.se3_from_quat_trans(jnp.asarray(q, jnp.float32),
                                             jnp.asarray(t)))
    return (pts, valid, T, K), dict(height=h, width=w, max_depth=80.0)


def _synthetic():
    b = SyntheticNuScenes(3, spec=SYNTH, seed=0).batch(range(3))
    return ((b["radar_points"], b["radar_valid"], b["radar_transform"],
             b["intrinsics"]),
            dict(height=SYNTH.height, width=SYNTH.width,
                 max_depth=SYNTH.max_depth))


@pytest.mark.parametrize("backend", RASTER_BACKENDS)
@pytest.mark.parametrize("height_extension", [0, 2])
@pytest.mark.parametrize("inputs", ["scene", "synthetic"])
def test_radar_to_depth_map_matches_jax(inputs, height_extension, backend):
    args, kw = _scene() if inputs == "scene" else _synthetic()
    want = np.asarray(jax_ops.radar_to_depth_map(
        *(jnp.asarray(a) for a in args), **kw,
        height_extension=height_extension))
    got = radar_to_depth_map(*(torch.from_numpy(a) for a in args), **kw,
                             height_extension=height_extension,
                             backend=backend)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 10  # the map is not trivially empty


def test_radar_to_depth_map_keeps_the_jax_defaults():
    """max_depth=100 (the port's rasterize_min_depth defaults to inf):
    points beyond 100 m are dropped, as in JAX."""
    (pts, valid, T, K), kw = _scene()
    pts = pts.copy()
    pts[0, :, 2] += 90.0  # sweep 0 mostly beyond 100 m
    kw.pop("max_depth")
    want = np.asarray(jax_ops.radar_to_depth_map(
        *(jnp.asarray(a) for a in (pts, valid, T, K)), **kw))
    got = radar_to_depth_map(*(torch.from_numpy(a) for a in
                               (pts, valid, T, K)), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() < 100.0


def _sparse_maps(n_set, seed):
    """(2, 12, 20) maps with ``n_set`` set pixels each, some negative and
    NaN pixels among the unset ones."""
    rng = np.random.default_rng(seed)
    depth = np.zeros((2, 12, 20), np.float32)
    for b in range(2):
        flat = depth[b].reshape(-1)
        idx = rng.permutation(flat.size)
        flat[idx[:n_set]] = rng.uniform(0.5, 80, n_set)
        flat[idx[n_set:n_set + 3]] = -1.0
        flat[idx[n_set + 3]] = np.nan
    return depth


@pytest.mark.parametrize("n_set,max_points", [(5, 16), (30, 16), (0, 8),
                                              (16, 16)])
def test_depth_map_to_points_matches_jax(n_set, max_points):
    """Bit-equal uv, z and valid, the padding rows (the unset pixels in
    row-major order) included."""
    depth = _sparse_maps(n_set, seed=n_set)
    want = jax_depth_map_to_points(jnp.asarray(depth), max_points)
    got = depth_map_to_points(torch.from_numpy(depth), max_points)
    for g, w in zip(got, want):
        assert g.dtype == {np.float32: torch.float32,
                           np.bool_: torch.bool}[np.asarray(w).dtype.type]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) == 2 * min(n_set, max_points)


@pytest.mark.parametrize("backend", RASTER_BACKENDS)
def test_depth_map_to_points_round_trip(backend):
    """tests/test_raster.py's round trip through the port's z-buffer."""
    depth = np.zeros((16, 16), np.float32)
    depth[3, 4] = 7.5
    depth[10, 2] = 2.0
    uv, z, valid = depth_map_to_points(torch.from_numpy(depth), max_points=8)
    assert int(valid.sum()) == 2
    recon = rasterize_min_depth(uv, z, valid, 16, 16, backend=backend)
    np.testing.assert_array_equal(recon.numpy(), depth)


def test_depth_map_to_points_refuses_more_points_than_pixels():
    with pytest.raises(ValueError, match="max_points=13"):
        depth_map_to_points(torch.zeros(3, 4), 13)


# ---------------------------------------------------------------- profiling


def test_profiling_helpers(tmp_path):
    """device_trace writes a trace; annotate and StepTimer run around the
    work (the counterpart of tests/test_utils.py::test_profiling_helpers)."""
    from radar_depth_tpu_torch.utils.profiling import (
        StepTimer,
        annotate,
        device_trace,
    )

    t = StepTimer()
    x = torch.arange(8.0)
    t.data_done()
    with device_trace(str(tmp_path / "trace"), device="cpu"):
        with annotate("square"):
            y = x * x
    t.step_done({"y": [y]})
    assert t.data_time >= 0 and t.step_time > 0
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and "square" in files[0].read_text()


def test_device_trace_names_the_kernel_ops(tmp_path):
    """The trace of a served forward on the CPU names the registered
    operators of kernels B and C."""
    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.models import create_model, init_random
    from radar_depth_tpu_torch.utils.profiling import device_trace

    cfg = ServeConfig(arch="resnet18", modality="rgbd", decoder="deconv2",
                      height=64, width=96, num_sweeps=3)
    sd = init_random(create_model(cfg.arch, device="cpu", modality="rgbd",
                                  decoder="deconv2",
                                  output_size=(64, 96))[0], 3).state_dict()
    pred = Predictor(cfg, sd, device="cpu")
    batch = SyntheticNuScenes(2, spec=SYNTH, seed=2).batch(range(2))
    with device_trace(str(tmp_path), device="cpu"):
        pred.predict(batch)
    text = next(tmp_path.glob("*.pt.trace.json")).read_text()
    assert "rdt::batch_norm_relu" in text
    assert "rdt::zbuffer_min_depth_sorted" in text


def test_device_trace_defaults_to_the_card(tmp_path, monkeypatch):
    """device=None means the card: without one it raises before it makes
    the directory."""
    from radar_depth_tpu_torch.utils.profiling import device_trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with device_trace(str(tmp_path / "trace")):
            pass
    assert not (tmp_path / "trace").exists()
