"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips without a CUDA device (the kernels have no CPU
build). This file imports no JAX, so it also runs where only the port is
installed:  python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import contextlib

import numpy as np
import pytest
import torch

from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.raster import bin_points, sort_points_by_pixel


ZBUFFER_EDGE_CASES = ("tile_edges", "hw_not_multiple_of_4", "b1_p1",
                      "one_tile_p4096", "kept_zero",
                      "empty_row_beside_full_row")


def zbuffer_edge_case(name):
    """(lin, z, height, width) of one z-buffer edge case, as numpy arrays:
    lin (B, P) int32 linear pixel indices with -1 for a dropped point, z
    (B, P) float32 depths. 40x64 has 2560 pixels: two full 1024-pixel tiles
    and a partial last one; 37x61 has 2257, not a multiple of 4."""
    rng = np.random.default_rng(ZBUFFER_EDGE_CASES.index(name))
    depth = lambda shape: rng.uniform(0.5, 80, size=shape).astype(np.float32)
    if name == "tile_edges":  # the last pixel of the partial last tile too
        h, w = 40, 64
        edges = np.repeat(np.asarray([1023, 1024, 2047, 2048, h * w - 1]), 3)
        lin = np.stack([rng.permutation(np.concatenate(
            [edges, rng.integers(-1, h * w, 49)])) for _ in range(2)])
        return lin.astype(np.int32), depth(lin.shape), h, w
    if name == "hw_not_multiple_of_4":
        h, w = 37, 61
        lin = rng.integers(-1, h * w, (3, 300)).astype(np.int32)
        lin[:, :10] = np.tile([1023, 1024, 2047, 2048, h * w - 1], 2)
        return lin, depth(lin.shape), h, w
    if name == "b1_p1":
        return (np.asarray([[1500]], np.int32), np.asarray([[7.5]], np.float32),
                40, 64)
    if name == "one_tile_p4096":  # every point in tile 1, many per pixel
        lin = rng.integers(1024, 2048, (2, 4096)).astype(np.int32)
        return lin, depth(lin.shape), 40, 64
    if name == "kept_zero":  # a depth of exactly +0.0 beside larger ones
        lin = np.asarray([[1024, 1024, 1024, 7, 7, 2559, 300, -1],
                          [5, 5, 2048, 2048, 0, 0, -1, 1023]], np.int32)
        z = np.asarray([[5, 0, 3, 0, 5, 0, 2, 0],
                        [0, 0, 4, 1, 9, 0, 0, 6]], np.float32)
        return lin, z, 40, 64
    if name == "empty_row_beside_full_row":  # row 1 hits every pixel twice
        h, w = 16, 32
        full = rng.permutation(np.tile(np.arange(h * w), 2))
        lin = np.stack([np.full_like(full, -1), full]).astype(np.int32)
        return lin, depth(lin.shape), h, w
    raise ValueError(name)


def sort_by_pixel(lin, z):
    """numpy (lin with -1 for dropped, z) -> the sorted form kernel C takes:
    each row stably sorted by pixel, dropped points at the sentinel."""
    key = np.where(lin >= 0, lin, kernels.SORTED_INVALID).astype(np.int32)
    order = np.argsort(key, axis=-1, kind="stable")
    return (np.take_along_axis(key, order, -1),
            np.take_along_axis(z, order, -1))


def _random_points(b, p, h, w, seed):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(-5, w * 1.4, size=(b, p)),
                   rng.uniform(-5, h * 1.4, size=(b, p))],
                  axis=-1).astype(np.float32)
    z = rng.uniform(-2, 90, size=(b, p)).astype(np.float32)
    valid = rng.uniform(size=(b, p)) > 0.15
    return uv, z, valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_card(dtype):
    """Both CUDA kernels against their plain versions on the card: the
    z-buffer bit-exact, the epilogue bit-exact too (the kernel rounds in the
    plain version's order, without fused multiply-adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    dev = torch.device("cuda")
    uv, z, valid = _random_points(4, 640, 90, 160, seed=1)
    lin, zf, _ = bin_points(torch.from_numpy(uv).to(dev),
                            torch.from_numpy(z).to(dev),
                            torch.from_numpy(valid).to(dev), 90, 160, 0.0,
                            80.0, -1)
    got = kernels.zbuffer_min_depth(lin, zf, 90, 160)
    assert torch.equal(got, kernels.zbuffer_min_depth_reference(lin, zf, 90,
                                                                160))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 64, 30, 50, generator=g, device=dev).to(
        dtype, memory_format=torch.channels_last)
    r = torch.randn(2, 64, 30, 50, generator=g, device=dev).to(
        dtype, memory_format=torch.channels_last)
    s = torch.randn(64, generator=g, device=dev)
    b = torch.randn(64, generator=g, device=dev)
    for res in (None, r):
        assert torch.equal(kernels.scale_bias_relu(x, s, b, res),
                           kernels.scale_bias_relu_reference(x, s, b, res))


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(4, 640), (2, 40960), (3, 641)])
def test_sorted_zbuffer_matches_plain_and_kernel_a_on_card(b, p):
    """Kernel C against its plain version and against kernel A on the same
    points, bit-exact, twice (the map does not depend on the order in which
    the atomics land); P=641 is not a multiple of the block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    dev = torch.device("cuda")
    h, w = 90, 160
    uv, z, valid = (torch.from_numpy(a).to(dev)
                    for a in _random_points(b, p, h, w, seed=p))
    lin, zs = sort_points_by_pixel(uv, z, valid, h, w, 0.0, 80.0)
    got = kernels.zbuffer_min_depth_sorted(lin, zs, h, w)
    assert torch.equal(got, kernels.zbuffer_min_depth_sorted(lin, zs, h, w))
    assert torch.equal(got, kernels.zbuffer_min_depth_sorted_reference(
        lin, zs, h, w))
    lin_a, zf_a, _ = bin_points(uv, z, valid, h, w, 0.0, 80.0, -1)
    assert torch.equal(got, kernels.zbuffer_min_depth(lin_a, zf_a, h, w))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ZBUFFER_EDGE_CASES)
def test_zbuffer_edge_cases_on_card(case):
    """Kernels A and C on the edge cases, twice each, against their plain
    versions and against each other: bit-exact, except that kernel A writes
    -0.0 where a kept +0.0 is a pixel's minimum, which equals the plain
    version's +0.0 only as a float."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    dev = torch.device("cuda")
    lin, z, h, w = zbuffer_edge_case(case)
    lin_s, z_s = sort_by_pixel(lin, z)
    lin, z, lin_s, z_s = (torch.from_numpy(a).to(dev)
                          for a in (lin, z, lin_s, z_s))
    want = kernels.zbuffer_min_depth_reference(lin, z, h, w)
    bits = lambda x: x.view(torch.int32)
    for _ in range(2):
        a = kernels.zbuffer_min_depth(lin, z, h, w)
        c = kernels.zbuffer_min_depth_sorted(lin_s, z_s, h, w)
        assert torch.equal(bits(c), bits(want))
        assert torch.equal(a, want) and torch.equal(a, c)
        if case == "kept_zero":
            assert (bits(a) == torch.iinfo(torch.int32).min).any()
        else:
            assert torch.equal(bits(a), bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_on_card(dtype):
    """torch.library.opcheck on the CUDA implementations of the three
    operators: schema, fake implementation against the kernel's output
    (shape, dtype, strides: channels_last kept), tracing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    x, r = (torch.randn(2, 64, 30, 50, generator=g, device=dev).to(
        dtype, memory_format=torch.channels_last) for _ in range(2))
    s = torch.rand(64, generator=g, device=dev) + 0.5
    b = torch.randn(64, generator=g, device=dev)
    for res in (None, r):
        torch.library.opcheck(torch.ops.rdt.scale_bias_relu.default,
                              (x, s, b, res))
    lin, z, h, w = zbuffer_edge_case("tile_edges")
    lin_s, z_s = sort_by_pixel(lin, z)
    lin, z, lin_s, z_s = (torch.from_numpy(a).to(dev)
                          for a in (lin, z, lin_s, z_s))
    torch.library.opcheck(torch.ops.rdt.zbuffer_min_depth.default,
                          (lin, z, h, w))
    torch.library.opcheck(torch.ops.rdt.zbuffer_min_depth_sorted.default,
                          (lin_s, z_s, h, w))


def _small_flagship(dtype):
    """A 64x96 flagship Predictor on the card and a B=2 batch."""
    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.models import create_model, init_random

    cfg = ServeConfig(arch="resnet18_multistage", height=64, width=96,
                      num_sweeps=3, abs_threshold=8.0, dtype=dtype)
    sd = init_random(create_model(cfg.arch, device="cpu",
                                  output_size=(64, 96))[0], 5).state_dict()
    batch = SyntheticNuScenes(2, spec=SampleSpec(height=64, width=96,
                                                 num_sweeps=3),
                              seed=3).batch(range(2))
    return Predictor(cfg, sd), batch


def _export_and_call(pred, batch, path):
    """Export ``pred`` at B=2, load it on the card (device=None) and call
    it once, counted: kernel B at its 84 sites, kernel C once."""
    from radar_depth_tpu_torch.inference import load_serving

    pred.export_serving(path, 2)
    serve = load_serving(path)
    kernels.scale_bias_relu.launches = 0
    kernels.zbuffer_min_depth_sorted.launches = 0
    got = serve(batch)
    assert kernels.scale_bias_relu.launches == 84
    assert kernels.zbuffer_min_depth_sorted.launches == 1
    return got


@pytest.mark.gpu
def test_export_load_on_card(tmp_path):
    """A B=2 artifact of the flagship in bfloat16, its serving dtype,
    exported on the card, loads on the card (device=None), equals
    Predictor.predict bit for bit, and one call of it launches kernel B at
    its 84 sites and kernel C once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    pred, batch = _small_flagship("bfloat16")
    got = _export_and_call(pred, batch, str(tmp_path / "card.pt2"))
    np.testing.assert_array_equal(got, pred.predict(batch))


@pytest.mark.gpu
def test_export_load_float32_on_card(tmp_path):
    """The same in float32 (IEEE convolutions and cuDNN's deterministic
    algorithms, the port's setting): the artifact equals Predictor.predict
    bit for bit, as chip_smoke.py's phase precision measured at 450x800."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    pred, batch = _small_flagship("float32")
    got = _export_and_call(pred, batch, str(tmp_path / "card32.pt2"))
    np.testing.assert_array_equal(got, pred.predict(batch))


@pytest.mark.gpu
def test_float32_predict_repeats_on_card():
    """Two float32 predict calls on the same batch are bit-equal (cuDNN's
    deterministic algorithms, set by the Predictor)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    pred, batch = _small_flagship("float32")
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.allow_tf32
    np.testing.assert_array_equal(pred.predict(batch), pred.predict(batch))


@pytest.mark.gpu
def test_ops_build_at_first_use_on_card():
    """ops.radar_to_depth_map on the card, in a fresh process: importing
    the ops loads no kernel library; the first call loads kernel C's (and
    builds it from its source if that source's build is not on disk), and
    both backends are bit-equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from radar_depth_tpu_torch.data import SampleSpec\n"
        "from radar_depth_tpu_torch.data import SyntheticNuScenes\n"
        "from radar_depth_tpu_torch.ops import kernels, radar_to_depth_map\n"
        "assert kernels._LIBS == {}\n"
        "b = SyntheticNuScenes(2, spec=SampleSpec(height=90, width=160), "
        "seed=1).batch(range(2))\n"
        "args = [torch.from_numpy(b[k]).cuda() for k in ('radar_points', "
        "'radar_valid', 'radar_transform', 'intrinsics')] + [90, 160]\n"
        "for backend, lib in (('sorted', 'zbuffer_sorted'), "
        "('scatter', 'zbuffer')):\n"
        "    assert lib not in kernels._LIBS\n"
        "    got = radar_to_depth_map(*args, backend=backend)\n"
        "    assert lib in kernels._LIBS\n"
        "    want = radar_to_depth_map(*args, backend=backend, plain=True)\n"
        "    assert torch.equal(got, want) and (got > 0).sum() > 10\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          cwd=str(Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _flagship_sites(dev):
    """(shape, has_residual) of every kernel-B site of one eval forward of
    the flagship at B=8, 450x800, bfloat16 (the BatchNorm calls made with
    relu=True)."""
    from radar_depth_tpu_torch.models import (
        BatchNorm,
        create_model,
        init_random,
    )
    from radar_depth_tpu_torch.ops.preprocess import pack_model_inputs

    model, spec = create_model("resnet18_multistage", device="cpu",
                               dtype=torch.bfloat16, output_size=(450, 800))
    model = init_random(model, 0).to(dev)
    seen = set()

    def hook(module, args, kwargs):
        if kwargs.get("relu"):
            seen.add((tuple(args[0].shape),
                      kwargs.get("residual") is not None))

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(hook, with_kwargs=True)
    prepared = {"rgb": torch.rand(8, 450, 800, 3, device=dev),
                "radar": torch.rand(8, 450, 800, 1, device=dev) * 50}
    with torch.inference_mode():
        model(*pack_model_inputs(prepared, spec.input_kind))
    return sorted(seen)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_epilogue_ops_at_every_flagship_site_on_card(dtype):
    """rdt::batch_norm_relu (the BN folded in the kernel) and
    rdt::scale_bias_relu against their plain versions at every (shape,
    residual) of the flagship's eval forward at B=8, 450x800: bit-equal,
    signed zeros aside; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    import chip_smoke as cs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    sites = _flagship_sites(dev)
    assert len(sites) >= 10
    for shape, has_res in sites:
        x, r = (torch.randn(shape, generator=g, device=dev).to(
            dtype, memory_format=torch.channels_last) for _ in range(2))
        r = r if has_res else None
        bn = cs.bn_params(torch, dev, g, shape[1])
        scale, bias = kernels.fold_batch_norm(*bn, cs.EPS)
        kernels.scale_bias_relu.launches = 0
        got = kernels.batch_norm_relu(x, *bn, cs.EPS, r)
        want = kernels.batch_norm_relu_reference(x, *bn, cs.EPS, r)
        assert not cs.bits_differ(torch, got, want)[0].any(), shape
        got = kernels.scale_bias_relu(x, scale, bias, r)
        want = kernels.scale_bias_relu_reference(x, scale, bias, r)
        assert not cs.bits_differ(torch, got, want)[0].any(), shape
        assert kernels.scale_bias_relu.launches == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_odd_channels_and_unaligned_view_on_card(dtype):
    """A C that is not a multiple of the 16-byte lane count, and a view
    whose data does not start on 16 bytes, each take one launch of kernel B
    (its one-lane variant) and match the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    import chip_smoke as cs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    odd = torch.randn(3, 37, 9, 11, generator=g, device=dev).to(
        dtype, memory_format=torch.channels_last)
    base = torch.randn(1 + 300 * 64, generator=g, device=dev).to(dtype)
    unaligned = base[1:].view(300, 64)
    assert unaligned.data_ptr() % 16 != 0
    for x in (odd, unaligned):
        c = x.shape[1] if x.dim() == 4 else x.shape[-1]
        bn = cs.bn_params(torch, dev, g, c)
        for res in (None, torch.randn(x.shape, generator=g, device=dev).to(
                dtype, memory_format=torch.channels_last
                if x.dim() == 4 else torch.contiguous_format)):
            kernels.scale_bias_relu.launches = 0
            got = kernels.batch_norm_relu(x, *bn, cs.EPS, res)
            assert kernels.scale_bias_relu.launches == 1
            want = kernels.batch_norm_relu_reference(x, *bn, cs.EPS, res)
            assert not cs.bits_differ(torch, got, want)[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("site", ["stem", "layer4"])
def test_conv_then_kernel_b_race_on_card(site):
    """Programmatic dependent launch: a cuDNN conv writes x and kernel B
    reads it with nothing between them on the stream, 200 times, every
    result bit-equal to the plain version (chip_smoke.epilogue_race_check,
    which raises on a mismatch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    import chip_smoke

    out = chip_smoke.epilogue_race_check(torch, torch.device("cuda"), site)
    assert out["iters"] == 200 and out["mismatched_elements"] == 0


BN_TRAIN_CASES = [  # (NCHW shape, relu, residual): lanes of 16 bytes, ragged
    ((8, 64, 57, 100), True, True),  # rows, one lane (C=5, 33), a 1x1 map
    ((4, 512, 15, 25), False, False),
    ((3, 5, 7, 9), True, True),
    ((5, 33, 17, 19), True, False),
    ((1, 24, 1, 1), False, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(BN_TRAIN_CASES)))
def test_bn_train_kernels_match_plain_versions_on_card(dtype, case):
    """Kernel D's four calls against their plain versions on the same
    inputs (chip_smoke.bn_train_case, which raises on a failure): the
    statistics, gradient sums and input gradient within its stated
    tolerances, the apply and its running update bit-equal given the
    kernel's statistics, the BN through autograd against plain=True, two
    runs bit-equal; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    import chip_smoke as cs

    dev = torch.device("cuda")
    shape, relu, residual = BN_TRAIN_CASES[case]
    names = ("bn_stats", "bn_apply", "bn_grad_stats", "bn_grad_input")
    for n in names:
        getattr(kernels, n).launches = 0
    out = cs.bn_train_case(torch, dev, shape, dtype, relu, residual,
                           torch.Generator(device=dev).manual_seed(case),
                           None, timed=False)
    assert out["ok"] and out["apply_bits_differ"] == 0
    # checked once, repeated once, and once more through autograd
    assert [getattr(kernels, n).launches for n in names] == [3, 3, 3, 3]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_goes_through_kernel_d_on_card(dtype):
    """One train step of the flagship at B=2, 64x96 on the card: each of
    kernel D's four calls once per train-mode BN site (106), kernel B
    never; the BN's running statistics and the loss finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    import chip_smoke as cs
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes

    dev = torch.device("cuda")
    dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg = cs.train_config(dt, height=64, width=96, sweeps=2)
    model, spec, state, step = cs.train_setup(torch, cfg, dev)
    batch = SyntheticNuScenes(2, spec=SampleSpec(
        height=64, width=96, num_sweeps=2, lidar_points=2048),
        seed=1).batch(range(2))
    cs.reset_launches()
    sums = step(state, batch, generator=torch.Generator(
        device=dev).manual_seed(0))
    got = cs.read_launches()
    assert cs.bn_sites(model) == cs.FLAGSHIP_TRAIN_SITES
    assert got == {"zbuffer_min_depth": 0, "scale_bias_relu": 0,
                   "zbuffer_min_depth_sorted": 1,
                   **cs.bn_train_launches(cs.FLAGSHIP_TRAIN_SITES, 1)}
    assert np.isfinite(float(sums["loss"]))
    assert all(torch.isfinite(t).all() for k, t in
               model.state_dict().items() if k.endswith("running_var"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphs_match_the_eager_path_on_card(dtype):
    """The flagship at 64x96 on the card through its per-shape CUDA graphs
    (graphs.py) against the eager path (graphs.disable_graphs) from the same
    weights: three B=2 predict calls and three host-augmented B=2 train
    steps bit-equal (maps; parameters, momentum, BN statistics, sums), and
    each kernel's launches after the replays equal to the eager calls'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    import chip_smoke as cs
    from radar_depth_tpu_torch import graphs
    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.models import create_model, init_random
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import make_train_step

    dev = torch.device("cuda")
    spec = SampleSpec(height=64, width=96, num_sweeps=2, lidar_points=2048)
    batches = [SyntheticNuScenes(2, spec=spec, seed=s).batch(range(2))
               for s in range(3)]
    sd = init_random(create_model("resnet18_multistage", device="cpu",
                                  output_size=(64, 96))[0], 0).state_dict()
    cfg = ServeConfig(arch="resnet18_multistage", decoder="upproj",
                      height=64, width=96, num_sweeps=2, dtype=dtype)
    maps, launches = {}, {}
    for mode in ("graph", "eager"):
        pred = Predictor(cfg, sd, device=dev)
        ctx = graphs.disable_graphs() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            cs.reset_launches()
            maps[mode] = [pred.predict(b) for b in batches]
            launches[mode] = cs.read_launches()
    assert pred.graphs.stats["replays"] == 0
    assert all(np.array_equal(a, b) for a, b in zip(maps["graph"],
                                                    maps["eager"]))
    assert launches["graph"] == launches["eager"]
    assert launches["graph"]["scale_bias_relu"] == 3 * 84

    tcfg = cs.train_config(dtype, height=64, width=96, sweeps=2)
    runs = {}
    for mode in ("graph", "eager"):
        model, arch_spec = create_model(
            "resnet18_multistage", device=dev, output_size=(64, 96),
            dtype=tcfg.model.torch_dtype, param_dtype=torch.float32)
        cs.train_init(torch, model, 0)
        state = create_train_state(model, tcfg.optim, 100)
        step = make_train_step(model, arch_spec, tcfg, host_augmented=True)
        ctx = graphs.disable_graphs() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            cs.reset_launches()
            sums = [step(state, b) for b in batches]
            torch.cuda.synchronize()
            runs[mode] = (state, sums, cs.read_launches(),
                          dict(step.graphs.stats))
    (gs, gsum, gl, stats), (es, esum, el, _) = runs["graph"], runs["eager"]
    assert stats == {"eager": 1, "captures": 1, "replays": 2}
    assert cs.graph_states_equal(torch, gs, es)
    assert cs.sums_equal(torch, gsum, esum)
    assert gl == el and gl["zbuffer_min_depth_sorted"] == 3
