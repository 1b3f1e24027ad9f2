#!/usr/bin/env python3
"""Smoke run of the PyTorch port (radar_depth_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases, each printing one JSON line:
  build      compile both CUDA kernels from csrc/ (one nvcc each, in parallel)
  device     torch's device name, and nvidia-smi's name and power limit
  zbuffer    kernel A against its plain version (bit equality) and against
             scatter_reduce_(amin), at the serving shape (B=8, P=640,
             450x800), at LiDAR density (B=2, P=40960) and on edge cases
  epilogue   kernel B against its plain version at every (shape, residual)
             the flagship gives it at B=8, in bfloat16 and float32
  serve      the flagship (resnet18_multistage/upproj, 450x800, 5 sweeps,
             bfloat16, seeded random weights) through Predictor: predict on
             B=8, 5, 16 and predict_stream over 3 batches, with the kernels'
             launch counts; float32 parity of the kernel path against the
             plain path on the card (TF32 off) and against the CPU on a small
             input; img/s and peak memory
  profile    device time by kernel category over one B=8 predict call
Then the kernels' summary line, nvidia-smi's line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero before that line;
without a card, or without the package beside it, it exits non-zero at once.
Full per-case results go to --out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

B_SERVE = 8
H, W = 450, 800
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
EPILOGUE_SITES_PER_FORWARD = 84
FP32_ABS_TOL = 1e-6  # kernel B vs plain, float32
PARITY_REL_RMSE_TOL = 1e-5  # float32 forward, kernels vs plain, same card
SMALL_TOL = dict(atol=2e-4, rtol=1e-3)  # card vs CPU, as the CPU parity tests
BF16_REL_RMSE_TOL = 0.2  # bfloat16 forward vs float32 plain: sanity bound


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    """Median of per-launch CUDA-event times over ``iters`` runs.

    The runs are queued behind a ~50 ms device sleep, so the host has
    enqueued them all before the card reaches the first: each event pair
    then brackets the device's work alone, not the host's launch overhead
    (a function that synchronises inside, like the plain z-buffer, still
    pays its host gaps)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- kernel A


def zbuffer_library(torch, lin, zf, height, width):
    """The same function through scatter_reduce_(amin): the yardstick only;
    the port never calls it."""
    b, hw = lin.shape[0], height * width
    idx = torch.where(lin >= 0, lin, hw).long()
    buf = torch.full((b, hw + 1), float("inf"), device=lin.device)
    buf.scatter_reduce_(1, idx, zf, reduce="amin")
    out = buf[:, :hw]
    return torch.where(torch.isinf(out), 0.0, out).view(b, height, width)


def phase_zbuffer(torch, dev, batch):
    from radar_depth_tpu_torch.ops import kernels
    from radar_depth_tpu_torch.ops.geometry import project_points
    from radar_depth_tpu_torch.ops.preprocess import _radar_uvz, to_device
    from radar_depth_tpu_torch.ops.raster import bin_points

    g = torch.Generator(device=dev).manual_seed(0)
    b = to_device({k: v[:B_SERVE] for k, v in batch.items()}, dev)
    cases = {}
    uv, z, valid = _radar_uvz(b)
    cases["serve_radar"] = bin_points(uv, z, valid, H, W, 0.0, 80.0, -1)[:2]
    luv, lz = project_points(b["lidar_points"][:2], b["intrinsics"][:2])
    cases["lidar_density"] = bin_points(luv, lz, b["lidar_valid"][:2], H, W,
                                        0.0, 80.0, -1)[:2]
    hw = H * W
    cases["all_invalid"] = (torch.full((2, 640), -1, dtype=torch.int32,
                                       device=dev),
                            torch.full((2, 640), float("inf"), device=dev))
    dup = torch.randint(0, 16, (2, 640), generator=g, device=dev,
                        dtype=torch.int32) * (hw // 16)
    cases["duplicates"] = (dup, torch.rand((2, 640), generator=g,
                                           device=dev) * 80 + 0.01)
    cases["one_pixel"] = (torch.full((2, 640), hw - 1, dtype=torch.int32,
                                     device=dev),
                          torch.linspace(80, 1, 640, device=dev).repeat(2, 1))
    rag = torch.randint(-1, hw, (3, 641), generator=g, device=dev,
                        dtype=torch.int32)
    cases["ragged_tail"] = (rag, torch.rand((3, 641), generator=g,
                                            device=dev) * 80 + 0.01)
    results = {}
    for name, (lin, zf) in cases.items():
        lin, zf = lin.contiguous(), zf.contiguous()
        got = kernels.zbuffer_min_depth(lin, zf, H, W)
        want = kernels.zbuffer_min_depth_reference(lin, zf, H, W)
        lib = zbuffer_library(torch, lin, zf, H, W)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"zbuffer {name}: kernel != plain version")
        if not torch.equal(got, lib):
            raise AssertionError(f"zbuffer {name}: kernel != scatter_reduce_")
        r = {"B": lin.shape[0], "P": lin.shape[1],
             "kept": int((lin >= 0).sum()), "bit_equal": True}
        if name in ("serve_radar", "lidar_density"):
            r["ms"] = cuda_ms(torch, lambda: kernels.zbuffer_min_depth(
                lin, zf, H, W))
            r["plain_ms"] = cuda_ms(torch, lambda: kernels.
                                    zbuffer_min_depth_reference(lin, zf, H, W))
            r["library_ms"] = cuda_ms(torch, lambda: zbuffer_library(
                torch, lin, zf, H, W))
            nbytes = lin.numel() * 8 + lin.shape[0] * hw * 4
            r["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        results[name] = r
    emit({"phase": "zbuffer", **{k: v for k, v in results.items()}})
    return results


# ------------------------------------------------------------- kernel B


def record_epilogue_sites(torch, pred, batch):
    """(shape, has_residual) of every kernel-B site in one forward: the
    BatchNorm calls made with relu=True."""
    from radar_depth_tpu_torch.models import BatchNorm

    seen = []

    def hook(module, args, kwargs):
        if kwargs.get("relu"):
            seen.append((tuple(args[0].shape),
                         kwargs.get("residual") is not None))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in pred.model.modules() if isinstance(m, BatchNorm)]
    try:
        pred.infer(batch)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return seen


def bf16_ulp(torch, x):
    a = x.float().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 7), torch.full_like(a, 2.0**-133))


def phase_epilogue(torch, dev, sites):
    from radar_depth_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(1)
    shapes = sorted(set(sites), key=lambda s: (-math.prod(s[0]), s[1]))
    results, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    for dtype, dname in ((torch.bfloat16, "bfloat16"),
                         (torch.float32, "float32")):
        for shape, has_res in shapes:
            c = shape[1]
            mk = lambda: torch.randn(shape, generator=g, device=dev).to(
                dtype, memory_format=torch.channels_last)
            x = mk()
            res = mk() if has_res else None
            scale = torch.rand(c, generator=g, device=dev) + 0.5
            bias = torch.randn(c, generator=g, device=dev) * 0.1
            got = kernels.scale_bias_relu(x, scale, bias, res)
            want = kernels.scale_bias_relu_reference(x, scale, bias, res)
            err = (got.float() - want.float()).abs()
            tol = (FP32_ABS_TOL if dtype == torch.float32
                   else bf16_ulp(torch, want))
            if not bool((err <= tol).all()):
                raise AssertionError(
                    f"epilogue {dname} {shape} res={has_res}: max err "
                    f"{float(err.max())} over tolerance")
            max_err[dname] = max(max_err[dname], float(err.max()))
            elem = 2 if dtype == torch.bfloat16 else 4
            nbytes = x.numel() * elem * (3 if has_res else 2) + 2 * c * 4
            results.append({
                "dtype": dname, "shape_nchw": list(shape),
                "residual": has_res, "max_abs_err": float(err.max()),
                "sites_per_forward": sites.count((shape, has_res)),
                "ms": cuda_ms(torch, lambda: kernels.scale_bias_relu(
                    x, scale, bias, res)),
                "plain_ms": cuda_ms(torch, lambda: kernels.
                                    scale_bias_relu_reference(x, scale, bias,
                                                              res)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    emit({"phase": "epilogue", "cases": len(results), "max_abs_err": max_err,
          "tolerance": {"float32": FP32_ABS_TOL,
                        "bfloat16": "one bf16 ulp of the plain result"}})
    return results, max_err


# ------------------------------------------------------------- serving


def rel_rmse(np, a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def phase_serve(torch, np, dev, batch, sd):
    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.ops import kernels

    cfg = ServeConfig(arch="resnet18_multistage", decoder="upproj",
                      dtype="bfloat16", height=H, width=W, num_sweeps=5)
    pred = Predictor(cfg, sd, device=dev)
    take = lambda lo, hi: {k: v[lo:hi] for k, v in batch.items()}
    pred.predict(take(0, B_SERVE))  # warm-up: library load, cuDNN set-up
    sites = record_epilogue_sites(torch, pred, take(0, B_SERVE))
    if len(sites) != EPILOGUE_SITES_PER_FORWARD:
        raise AssertionError(f"{len(sites)} epilogue sites per forward, "
                             f"expected {EPILOGUE_SITES_PER_FORWARD}")

    # the main path, counted: 3 predict calls (one chunk each) + 3 streamed
    kernels.zbuffer_min_depth.launches = 0
    kernels.scale_bias_relu.launches = 0
    outs = {n: pred.predict(take(0, n)) for n in (8, 5, 16)}
    streamed = list(pred.predict_stream(
        iter([take(i, i + B_SERVE) for i in (0, 8, 16)])))
    launches = {"zbuffer_min_depth": kernels.zbuffer_min_depth.launches,
                "scale_bias_relu": kernels.scale_bias_relu.launches}
    forwards = 6
    if launches != {"zbuffer_min_depth": forwards,
                    "scale_bias_relu": EPILOGUE_SITES_PER_FORWARD * forwards}:
        raise AssertionError(f"launches {launches} over {forwards} forwards")
    for n, out in outs.items():
        if out.shape != (n, H, W) or not np.isfinite(out).all():
            raise AssertionError(f"predict B={n}: shape {out.shape} or "
                                 "non-finite values")
    if len(streamed) != 3 or any(s.shape != (B_SERVE, H, W)
                                 or not np.isfinite(s).all() for s in streamed):
        raise AssertionError("predict_stream output")
    if not np.array_equal(streamed[0], outs[8]):
        raise AssertionError("predict_stream differs from predict")

    # throughput: host clock around whole predict calls (upload, preprocess,
    # forward, fetch); predict returns host arrays, so each call has waited
    speed = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for n in (8, 16):
        b = take(0, n)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred.predict(b)
            times.append(time.perf_counter() - t0)
        speed[f"img_per_s_b{n}"] = n / statistics.median(times)
        speed[f"ms_per_call_b{n}"] = statistics.median(times) * 1e3
    speed["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    sample = outs[8]

    # float32 parity on the card: kernel path vs plain path, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b8 = take(0, B_SERVE)
    k32 = Predictor(cfg32, sd, device=dev).predict(b8)
    p32 = Predictor(cfg32, sd, device=dev, plain=True).predict(b8)
    parity = {"fp32_kernels_vs_plain_max_abs": float(np.abs(k32 - p32).max()),
              "fp32_kernels_vs_plain_rel_rmse": rel_rmse(np, k32, p32),
              "bf16_vs_fp32_plain_max_abs": float(np.abs(sample - p32).max()),
              "bf16_vs_fp32_plain_rel_rmse": rel_rmse(np, sample, p32),
              "pred_mean_m": float(p32.mean()), "pred_std_m": float(p32.std())}
    if parity["fp32_kernels_vs_plain_rel_rmse"] > PARITY_REL_RMSE_TOL:
        raise AssertionError(f"float32 parity {parity}")
    if parity["bf16_vs_fp32_plain_rel_rmse"] > BF16_REL_RMSE_TOL:
        raise AssertionError(f"bfloat16 vs float32 {parity}")

    # small input: the card's kernel path against the CPU's plain path
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.models import create_model, init_random

    small = ServeConfig(arch="resnet18_multistage", height=64, width=96,
                        num_sweeps=3, abs_threshold=8.0)
    ssd = init_random(create_model(small.arch, device="cpu",
                                   output_size=(64, 96))[0], 5).state_dict()
    sb = SyntheticNuScenes(2, spec=SampleSpec(height=64, width=96,
                                              num_sweeps=3, lidar_points=2048),
                           seed=4).batch(range(2))
    on_card = Predictor(small, ssd, device=dev).predict(sb)
    on_cpu = Predictor(small, ssd, device="cpu").predict(sb)
    np.testing.assert_allclose(on_card, on_cpu, **SMALL_TOL)
    parity["small_card_vs_cpu_max_abs"] = float(np.abs(on_card - on_cpu).max())

    emit({"phase": "serve", "arch": cfg.arch, "decoder": cfg.decoder,
          "dtype": cfg.dtype, "hw": [H, W], "sweeps": cfg.num_sweeps,
          "forwards": forwards, "launches": launches,
          "launches_per_forward": {k: v / forwards
                                   for k, v in launches.items()},
          **speed, **parity})
    return launches, speed, parity, pred, sites


def _category(name: str) -> str:
    n = name.lower()
    if "sbr_" in n:
        return "kernel_B_epilogue"
    if "zb_" in n:
        return "kernel_A_zbuffer"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if any(k in n for k in ("conv", "xmma", "cudnn", "sm90", "sm80", "gemm",
                            "implicit", "dgrad", "wgrad", "cutlass")):
        return "conv"
    return "other"


def phase_profile(torch, pred, batch):
    """Device time by kernel category over one B=8 predict call
    (torch.profiler, CUPTI), against the call's host-clock wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred.predict(batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats, kernels_by_name, launches = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        cats[_category(e.key)] = cats.get(_category(e.key), 0.0) + us / 1e3
        kernels_by_name[e.key[:80]] = us / 1e3
        launches += e.count
    busy = sum(cats.values())
    top = sorted(kernels_by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"phase": "profile", "batch": next(iter(batch.values())).shape[0],
           "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": (1 - busy / wall_ms) if busy else None,
           "device_ms_by_category": cats, "device_events": launches,
           "top_kernels_ms": top}
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
        from radar_depth_tpu_torch.models import create_model, init_random
        from radar_depth_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built,
          "libraries": [kernels.library_path(n).name
                        for n in kernels.SOURCES]})

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    batch = SyntheticNuScenes(24, spec=SampleSpec(height=H, width=W,
                                                  num_sweeps=5),
                              seed=0).batch(range(24))
    sd = init_random(create_model("resnet18_multistage", device="cpu",
                                  output_size=(H, W))[0], 0).state_dict()
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "samples": 24, "weights_seed": 0})

    zb = phase_zbuffer(torch, dev, batch)
    launches, speed, parity, pred, sites = phase_serve(torch, np, dev, batch,
                                                       sd)
    epi, epi_err = phase_epilogue(torch, dev, sites)
    prof = phase_profile(torch, pred, {k: v[:B_SERVE]
                                       for k, v in batch.items()})

    stem = next(r for r in epi if r["dtype"] == "bfloat16"
                and not r["residual"] and r["shape_nchw"][1] == 64
                and r["shape_nchw"][2] == (H + 1) // 2)
    serve = zb["serve_radar"]
    summary = {"kernels": [
        {"name": "zbuffer_min_depth", "route": "cuda",
         "source": "radar_depth_tpu_torch/csrc/zbuffer.cu",
         "replaces": "radar_depth_tpu/ops/pallas_kernels.py:71",
         "launches": launches["zbuffer_min_depth"], "max_abs_err": 0.0,
         "ms": serve["ms"], "plain_ms": serve["plain_ms"],
         "bound_ms": serve["bound_ms"], "bound_by": "bytes",
         "library_ms": serve["library_ms"]},
        {"name": "scale_bias_relu", "route": "cuda",
         "source": "radar_depth_tpu_torch/csrc/epilogue.cu",
         "replaces": "radar_depth_tpu/ops/pallas_kernels.py:251",
         "launches": launches["scale_bias_relu"],
         "max_abs_err": max(epi_err.values()),
         "ms": stem["ms"], "plain_ms": stem["plain_ms"],
         "bound_ms": stem["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": {"torch_name": kind, "nvidia_smi": smi},
                       "zbuffer": zb, "epilogue": epi, "speed": speed,
                       "parity": parity, "launches": launches,
                       "profile": prof,
                       "summary": summary}, f, indent=1)
    emit(summary)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
