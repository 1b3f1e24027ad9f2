#!/usr/bin/env python3
"""Smoke run of the PyTorch port (radar_depth_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases, each printing one JSON line:
  build          compile the three CUDA kernels from csrc/ (one nvcc each, in
                 parallel), with ptxas's registers, shared memory and spills
  device         torch's device name, and nvidia-smi's name and power limit
  zbuffer        kernel A, twice, against its plain version (bit equality;
                 value equality for a kept +0.0) and against
                 scatter_reduce_(amin), at the serving shape (B=8, P=640,
                 450x800), at LiDAR density (B=8, P=40960) and on edge cases
                 (tile edges, hw % 4 != 0, a kept +0.0, B=1); warm, L2-cold
                 and back-to-back times against the bound, device time,
                 plain and library times, and the event times of a trivial
                 launch
  zbuffer_sorted kernel C, twice, against its plain version and kernel A on
                 the same points (bit equality), at radar density (B=8,
                 P=640) and LiDAR density (B=8, P=40960), and on the same
                 edge cases; warm, L2-cold and back-to-back times, device
                 time, plain, sort and scatter_reduce_ times
  serve          the flagship (resnet18_multistage/upproj, 450x800, 5 sweeps,
                 bfloat16, seeded random weights) through Predictor: predict on
                 B=8, 5, 16 and predict_stream over 3 batches, with the kernels'
                 launch counts; then raster_backend="scatter" (kernel A), whose
                 predictions must be bit-equal; float32 parity of the kernel
                 path against the plain path on the card (TF32 off) and
                 against the CPU on a small input; img/s of both backends and
                 peak memory
  epilogue       kernel B against its plain version at every (shape, residual)
                 the flagship gives it at B=8, in bfloat16 and float32
  train          the flagship's train step at B=8 on SyntheticNuScenes(seed=0):
                 10 float32 and 10 bfloat16 steps on a repeated batch (loss
                 finite and falling), 3 steps with gt_augment="rerasterize",
                 launch counts per step, img/s and peak memory (and B=32
                 bfloat16 if it fits); one float32 step of the kernel path
                 against the plain path on the card (TF32 off) and against the
                 CPU on a small input
  eval           make_eval_step on B=8: launch counts, metric sums against
                 the plain path
  profile        device time by kernel category over one B=8 predict call
  profile_train  the same over one B=8 train step, float32 and bfloat16
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
B_TRAIN = 8
TRAIN_STEPS = 10
H, W = 450, 800
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
L2_FLUSH_BYTES = 128 << 20  # written before each L2-cold run: > the 50 MB L2
EPILOGUE_SITES_PER_FORWARD = 84
FP32_ABS_TOL = 1e-6  # kernel B vs plain, float32
PARITY_REL_RMSE_TOL = 1e-5  # float32 forward, kernels vs plain, same card
SMALL_TOL = dict(atol=2e-4, rtol=1e-3)  # card vs CPU, as the CPU parity tests
BF16_REL_RMSE_TOL = 0.2  # bfloat16 forward vs float32 plain: sanity bound
SUMS_RTOL = 1e-4  # loss and metric sums, as the CPU parity tests
UPDATE_TOL = 5e-2  # per-tensor update error, normalized as the CPU tests
STATS_TOL = dict(atol=1e-5, rtol=1e-4)  # BN running statistics


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3, flush=None) -> float:
    """Median of per-launch CUDA-event times over ``iters`` runs.

    The runs are queued behind a ~50 ms device sleep, so the host has
    enqueued them all before the card reaches the first: each event pair
    then brackets the device's work alone, not the host's launch overhead
    (a function that synchronises inside, like the plain z-buffer, still
    pays its host gaps). With ``flush`` (from ``l2_flusher``), each run is
    preceded, outside its event pair, by a write of a buffer larger than the
    L2, so the run finds the L2 full of other dirty lines: the L2-cold
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    events = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def cuda_ms_back_to_back(torch, fn, launches=50, warmup=3) -> float:
    """Event time of ``launches`` back-to-back runs, over their count: each
    run's launch overlaps the run before it, as inside a stream of work, so
    the per-launch cost of one event pair is spread over all of them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(launches):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / launches


def l2_flusher(torch, dev):
    """A function that writes L2_FLUSH_BYTES of scratch on ``dev``."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    return lambda: scratch.fill_(1.0)


def warm_and_cold(torch, fn, flush, bound_ms) -> dict:
    """Warm, L2-cold and back-to-back times of ``fn``, and the bound's share
    of the cold one."""
    cold = cuda_ms(torch, fn, flush=flush)
    return {"ms": cuda_ms(torch, fn), "ms_cold": cold,
            "ms_back_to_back": cuda_ms_back_to_back(torch, fn),
            "bound_ms": bound_ms, "bound_share": bound_ms / cold}


def kernel_us(torch, fn, iters=20) -> dict:
    """Mean device time per call, in us, of each CUDA kernel that ``fn``
    launches (torch.profiler over ``iters`` back-to-back calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key[:60]] = us / iters
    return out


def device_split(torch, fn, ms, name) -> dict:
    """Device time of the kernels of ``fn`` whose names contain ``name``
    (torch.profiler, asked twice if its first trace lacks them), and the
    rest of its warm event time ``ms``: launch, ramp and the events' own
    cost."""
    for _ in range(2):
        us = {k: v for k, v in kernel_us(torch, fn).items() if name in k}
        if us:
            break
    return {"device_us_by_kernel": us,
            "outside_kernels_us": ms * 1e3 - sum(us.values())}


def launch_floor(torch, dev) -> dict:
    """Event times of one trivial kernel (a 1-element fill), per launch and
    back to back: what ``cuda_ms`` and ``cuda_ms_back_to_back`` read for a
    launch that does no work."""
    one = torch.zeros(1, device=dev)
    fn = lambda: one.fill_(1.0)
    return {"ms": cuda_ms(torch, fn),
            "ms_back_to_back": cuda_ms_back_to_back(torch, fn)}


def map_bound_ms(lin, hw) -> float:
    """Least time of a z-buffer on the card: each point's index and depth
    read once (8 B), the (B, hw) float32 map written once."""
    return (lin.numel() * 8 + lin.shape[0] * hw * 4) / HBM_BYTES_PER_S * 1e3


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------- kernels A and C


def zbuffer_points(torch, dev, batch, n):
    """(uv, z, valid) on the card of the first ``n`` samples' radar points
    (5 sweeps, P=640, as served) and LiDAR points (P=40960)."""
    from radar_depth_tpu_torch.ops.geometry import project_points
    from radar_depth_tpu_torch.ops.preprocess import _radar_uvz, to_device

    b = to_device({k: v[:n] for k, v in batch.items()}, dev)
    luv, lz = project_points(b["lidar_points"], b["intrinsics"])
    return {"radar": _radar_uvz(b), "lidar_density": (luv, lz, b["lidar_valid"])}


def zbuffer_edge_cases(torch, dev, g):
    """Edge cases of both z-buffers, as (lin with -1 for dropped, z, height,
    width): points on tile edges (pixels 1023, 1024, 2047, 2048 and the last
    one, in the partial last tile), hw % 4 != 0 (37x61), a kept depth of
    exactly +0.0 beside larger ones, and B=1, P=1."""
    hw, odd = H * W, 37 * 61
    ints = lambda rows: torch.tensor(rows, dtype=torch.int32, device=dev)
    depth = lambda shape: torch.rand(shape, generator=g, device=dev) * 80 + 0.01
    edges = torch.randint(-1, hw, (2, 640), generator=g, device=dev,
                          dtype=torch.int32)
    edges[:, :15] = ints([1023, 1024, 2047, 2048, hw - 1]).repeat(3)
    ragged = torch.randint(-1, odd, (3, 300), generator=g, device=dev,
                           dtype=torch.int32)
    ragged[:, :10] = ints([1023, 1024, 2047, 2048, odd - 1]).repeat(2)
    zero_z = torch.tensor([[5.0, 0.0, 3.0, 0.0, 5.0, 0.0, 2.0, 0.0]],
                          device=dev)
    return {
        "tile_edges": (edges, depth((2, 640)), H, W),
        "hw_not_multiple_of_4": (ragged, depth((3, 300)), 37, 61),
        "kept_zero": (ints([[1024, 1024, 1024, 7, 7, hw - 1, 300, -1]]),
                      zero_z, H, W),
        "b1_p1": (ints([[1500]]), torch.full((1, 1), 7.5, device=dev), H, W)}


def zbuffer_library(torch, lin, zf, height, width):
    """The same function through scatter_reduce_(amin): the yardstick only;
    the port never calls it."""
    b, hw = lin.shape[0], height * width
    idx = torch.where(lin >= 0, lin, hw).long()
    buf = torch.full((b, hw + 1), float("inf"), device=lin.device)
    buf.scatter_reduce_(1, idx, zf, reduce="amin")
    out = buf[:, :hw]
    return torch.where(torch.isinf(out), 0.0, out).view(b, height, width)


def phase_zbuffer(torch, dev, batch, flush):
    from radar_depth_tpu_torch.ops import kernels
    from radar_depth_tpu_torch.ops.raster import bin_points

    g = torch.Generator(device=dev).manual_seed(0)
    bits = lambda x: x.view(torch.int32)
    cases = {}
    for name, (uv, z, valid) in zbuffer_points(torch, dev, batch,
                                               B_SERVE).items():
        lin, zf, _ = bin_points(uv, z, valid, H, W, 0.0, 80.0, -1)
        cases["serve_radar" if name == "radar" else name] = (lin, zf, H, W)
    hw = H * W
    cases["all_invalid"] = (torch.full((2, 640), -1, dtype=torch.int32,
                                       device=dev),
                            torch.full((2, 640), float("inf"), device=dev),
                            H, W)
    dup = torch.randint(0, 16, (2, 640), generator=g, device=dev,
                        dtype=torch.int32) * (hw // 16)
    cases["duplicates"] = (dup, torch.rand((2, 640), generator=g,
                                           device=dev) * 80 + 0.01, H, W)
    cases["one_pixel"] = (torch.full((2, 640), hw - 1, dtype=torch.int32,
                                     device=dev),
                          torch.linspace(80, 1, 640, device=dev).repeat(2, 1),
                          H, W)
    rag = torch.randint(-1, hw, (3, 641), generator=g, device=dev,
                        dtype=torch.int32)
    cases["ragged_tail"] = (rag, torch.rand((3, 641), generator=g,
                                            device=dev) * 80 + 0.01, H, W)
    cases.update(zbuffer_edge_cases(torch, dev, g))
    results = {}
    for name, (lin, zf, h, w) in cases.items():
        lin, zf = lin.contiguous(), zf.contiguous()
        got = kernels.zbuffer_min_depth(lin, zf, h, w)
        again = kernels.zbuffer_min_depth(lin, zf, h, w)
        want = kernels.zbuffer_min_depth_reference(lin, zf, h, w)
        lib = zbuffer_library(torch, lin, zf, h, w)
        torch.cuda.synchronize()
        if not torch.equal(bits(got), bits(again)):
            raise AssertionError(f"zbuffer {name}: two runs differ")
        if not (torch.equal(got, want) and torch.equal(got, lib)):
            raise AssertionError(f"zbuffer {name}: kernel != plain version "
                                 "or scatter_reduce_")
        bit_equal = torch.equal(bits(got), bits(want))
        # only a kept +0.0 may differ in its bits: -0.0 from the kernel
        if not bit_equal and not (name == "kept_zero" and bool(
                (bits(got) == torch.iinfo(torch.int32).min).any())):
            raise AssertionError(f"zbuffer {name}: kernel and plain version "
                                 "differ in their bits")
        r = {"B": lin.shape[0], "P": lin.shape[1], "hw": h * w,
             "kept": int((lin >= 0).sum()), "bit_equal": bit_equal}
        if name in ("serve_radar", "lidar_density"):
            fn = lambda: kernels.zbuffer_min_depth(lin, zf, h, w)
            r.update(warm_and_cold(torch, fn, flush, map_bound_ms(lin, h * w)))
            r["plain_ms"] = cuda_ms(torch, lambda: kernels.
                                    zbuffer_min_depth_reference(lin, zf, h, w))
            r["library_ms"] = cuda_ms(torch, lambda: zbuffer_library(
                torch, lin, zf, h, w))
            r.update(device_split(torch, fn, r["ms"], "zb_"))
        results[name] = r
    results["launch_floor"] = launch_floor(torch, dev)
    emit({"phase": "zbuffer", **results})
    return results


def sorted_library(torch, lin_sorted, z_sorted, height, width):
    """scatter_reduce_(amin) over the sorted points (the sentinel dropped):
    the yardstick only; the port never calls it."""
    hw = height * width
    lin = torch.where(lin_sorted < hw, lin_sorted, -1)
    return zbuffer_library(torch, lin, z_sorted, height, width)


def sort_lin(torch, lin, zf):
    """(lin with -1 for dropped, z) -> the sorted form kernel C takes."""
    from radar_depth_tpu_torch.ops import kernels

    key = torch.where(lin >= 0, lin, kernels.SORTED_INVALID)
    lin_s, order = torch.sort(key, dim=-1, stable=True)
    return lin_s.contiguous(), torch.gather(zf, -1, order).contiguous()


def phase_zbuffer_sorted(torch, dev, batch, flush):
    from radar_depth_tpu_torch.ops import kernels
    from radar_depth_tpu_torch.ops.raster import bin_points, sort_points_by_pixel

    g = torch.Generator(device=dev).manual_seed(2)
    bits = lambda x: x.view(torch.int32)
    hw = H * W
    cases = {}
    for name, (uv, z, valid) in zbuffer_points(torch, dev, batch,
                                               B_TRAIN).items():
        lin_a, zf_a, _ = bin_points(uv, z, valid, H, W, 0.0, 80.0, -1)
        cases[name] = (lin_a.contiguous(), zf_a.contiguous(), H, W,
                       (uv, z, valid))
    rnd = lambda shape, lo, hi: torch.randint(lo, hi, shape, generator=g,
                                              device=dev, dtype=torch.int32)
    depth = lambda shape: torch.rand(shape, generator=g, device=dev) * 80 + 0.01
    cases["all_invalid"] = (torch.full((2, 640), -1, dtype=torch.int32,
                                       device=dev),
                            torch.full((2, 640), float("inf"), device=dev),
                            H, W, None)
    cases["duplicates"] = (rnd((2, 640), 0, 16) * (hw // 16), depth((2, 640)),
                           H, W, None)
    cases["one_pixel"] = (torch.full((2, 640), hw - 1, dtype=torch.int32,
                                     device=dev),
                          torch.linspace(80, 1, 640, device=dev).repeat(2, 1),
                          H, W, None)
    cases["ragged_p641"] = (rnd((3, 641), -1, hw), depth((3, 641)), H, W, None)
    cases["one_tile"] = (rnd((2, 4096), 0, 1024), depth((2, 4096)), H, W, None)
    for name, (lin, zf, h, w) in zbuffer_edge_cases(torch, dev, g).items():
        cases[name] = (lin, zf, h, w, None)
    results = {}
    for name, (lin_a, zf_a, h, w, raw) in cases.items():
        if raw is None:
            lin_s, z_s = sort_lin(torch, lin_a, zf_a)
        else:
            lin_s, z_s = sort_points_by_pixel(*raw, H, W, 0.0, 80.0)
        got = kernels.zbuffer_min_depth_sorted(lin_s, z_s, h, w)
        again = kernels.zbuffer_min_depth_sorted(lin_s, z_s, h, w)
        want = kernels.zbuffer_min_depth_sorted_reference(lin_s, z_s, h, w)
        kernel_a = kernels.zbuffer_min_depth(lin_a, zf_a, h, w)
        torch.cuda.synchronize()
        for other, what in ((again, "a second run"), (want, "plain version")):
            if not torch.equal(bits(got), bits(other)):
                raise AssertionError(f"zbuffer_sorted {name}: kernel C != "
                                     f"{what}")
        # kernel A writes -0.0 for a kept +0.0 (kernels.zbuffer_min_depth)
        if not (torch.equal(got, kernel_a) and (
                name == "kept_zero" or torch.equal(bits(got), bits(kernel_a)))):
            raise AssertionError(f"zbuffer_sorted {name}: kernel C != kernel A")
        r = {"B": lin_s.shape[0], "P": lin_s.shape[1], "hw": h * w,
             "kept": int((lin_s < h * w).sum()), "bit_equal": True}
        if raw is not None:
            fn = lambda: kernels.zbuffer_min_depth_sorted(lin_s, z_s, H, W)
            r.update(warm_and_cold(torch, fn, flush, map_bound_ms(lin_s, hw)))
            r.update(device_split(torch, fn, r["ms"], "zbs_"))
            r["plain_ms"] = cuda_ms(torch, lambda: kernels.
                                    zbuffer_min_depth_sorted_reference(
                                        lin_s, z_s, H, W))
            r["sort_ms"] = cuda_ms(torch, lambda: sort_points_by_pixel(
                *raw, H, W, 0.0, 80.0))
            r["library_ms"] = cuda_ms(torch, lambda: sorted_library(
                torch, lin_s, z_s, H, W))
        results[name] = r
    emit({"phase": "zbuffer_sorted", **results})
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


def reset_launches():
    from radar_depth_tpu_torch.ops import kernels

    for fn in KERNELS.values():
        getattr(kernels, fn).launches = 0


def read_launches():
    from radar_depth_tpu_torch.ops import kernels

    return {fn: getattr(kernels, fn).launches for fn in KERNELS.values()}


KERNELS = {"A": "zbuffer_min_depth", "B": "scale_bias_relu",
           "C": "zbuffer_min_depth_sorted"}


class tf32:
    """Context: TF32 for cuDNN convolutions and matmuls on or off, restored
    on exit."""

    def __init__(self, torch, enabled):
        self.torch, self.enabled = torch, enabled

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = self.enabled

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = self.saved


def serve_speed(preds, take, reps=6):
    """img/s of each Predictor in ``preds`` at B=8 and 16: host clock around
    whole predict calls (upload, preprocess, forward, fetch; predict returns
    host arrays, so each call has waited), the Predictors taken in turns,
    the order reversed every round (ABBA), medians over ``reps`` rounds."""
    speed = {name: {} for name in preds}
    names = list(preds)
    for n in (8, 16):
        b = take(0, n)
        times = {name: [] for name in names}
        for r in range(reps):
            for name in (names if r % 2 == 0 else names[::-1]):
                t0 = time.perf_counter()
                preds[name].predict(b)
                times[name].append(time.perf_counter() - t0)
        for name in names:
            med = statistics.median(times[name])
            speed[name][f"img_per_s_b{n}"] = n / med
            speed[name][f"ms_per_call_b{n}"] = med * 1e3
            speed[name][f"ms_per_call_b{n}_all"] = [t * 1e3
                                                    for t in times[name]]
    return speed


def phase_serve(torch, np, dev, batch, sd):
    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.inference import Predictor

    cfg = ServeConfig(arch="resnet18_multistage", decoder="upproj",
                      dtype="bfloat16", height=H, width=W, num_sweeps=5)
    if cfg.raster_backend != "sorted":
        raise AssertionError("the serving default is the sorted z-buffer")
    pred = Predictor(cfg, sd, device=dev)
    take = lambda lo, hi: {k: v[lo:hi] for k, v in batch.items()}
    pred.predict(take(0, B_SERVE))  # warm-up: library load, cuDNN set-up
    sites = record_epilogue_sites(torch, pred, take(0, B_SERVE))
    if len(sites) != EPILOGUE_SITES_PER_FORWARD:
        raise AssertionError(f"{len(sites)} epilogue sites per forward, "
                             f"expected {EPILOGUE_SITES_PER_FORWARD}")

    # the main path, counted: 3 predict calls (one chunk each) + 3 streamed
    reset_launches()
    outs = {n: pred.predict(take(0, n)) for n in (8, 5, 16)}
    streamed = list(pred.predict_stream(
        iter([take(i, i + B_SERVE) for i in (0, 8, 16)])))
    launches = read_launches()
    forwards = 6
    want = {KERNELS["A"]: 0, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD * forwards,
            KERNELS["C"]: forwards}
    if launches != want:
        raise AssertionError(f"launches {launches} over {forwards} forwards, "
                             f"expected {want}")
    for n, out in outs.items():
        if out.shape != (n, H, W) or not np.isfinite(out).all():
            raise AssertionError(f"predict B={n}: shape {out.shape} or "
                                 "non-finite values")
    if len(streamed) != 3 or any(s.shape != (B_SERVE, H, W)
                                 or not np.isfinite(s).all() for s in streamed):
        raise AssertionError("predict_stream output")
    if not np.array_equal(streamed[0], outs[8]):
        raise AssertionError("predict_stream differs from predict")

    sample = outs[8]

    # the scatter backend (kernel A), counted, and bit-equal predictions
    pred_sc = Predictor(dataclasses.replace(cfg, raster_backend="scatter"), sd,
                        device=dev)
    pred_sc.predict(take(0, B_SERVE))
    reset_launches()
    sc = {n: pred_sc.predict(take(0, n)) for n in (8, 16)}
    launches_scatter = read_launches()
    want = {KERNELS["A"]: 2, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD * 2,
            KERNELS["C"]: 0}
    if launches_scatter != want:
        raise AssertionError(f"scatter backend launches {launches_scatter}, "
                             f"expected {want}")
    for n in (8, 16):
        if not np.array_equal(sc[n], outs[n]):
            raise AssertionError(f"B={n}: raster_backend scatter and sorted "
                                 "predictions differ")
    torch.cuda.reset_peak_memory_stats(dev)
    speed = serve_speed({"sorted": pred, "scatter": pred_sc}, take)
    speed["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del pred_sc

    # float32 parity on the card: kernel path vs plain path, TF32 off
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b8 = take(0, B_SERVE)
    with tf32(torch, False):
        k32 = Predictor(cfg32, sd, device=dev).predict(b8)
        p32 = Predictor(cfg32, sd, device=dev, plain=True).predict(b8)
    parity = {"fp32_kernels_vs_plain_max_abs": float(np.abs(k32 - p32).max()),
              "fp32_kernels_vs_plain_rel_rmse": rel_rmse(np, k32, p32),
              "bf16_vs_fp32_plain_max_abs": float(np.abs(sample - p32).max()),
              "bf16_vs_fp32_plain_rel_rmse": rel_rmse(np, sample, p32),
              "pred_mean_m": float(p32.mean()), "pred_std_m": float(p32.std()),
              "scatter_vs_sorted_bit_equal": True}
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
    with tf32(torch, False):
        on_card = Predictor(small, ssd, device=dev).predict(sb)
    on_cpu = Predictor(small, ssd, device="cpu").predict(sb)
    np.testing.assert_allclose(on_card, on_cpu, **SMALL_TOL)
    parity["small_card_vs_cpu_max_abs"] = float(np.abs(on_card - on_cpu).max())

    emit({"phase": "serve", "arch": cfg.arch, "decoder": cfg.decoder,
          "dtype": cfg.dtype, "hw": [H, W], "sweeps": cfg.num_sweeps,
          "forwards": forwards, "launches": launches,
          "launches_scatter_backend": launches_scatter,
          "launches_per_forward": {k: v / forwards
                                   for k, v in launches.items()},
          **speed, **parity})
    return launches, launches_scatter, speed, parity, pred, sites


# ------------------------------------------------------------- training


def train_init(torch, model, seed):
    """Seeded random weights for training: init_random's convs, BN scale 1
    and bias 0 (a freshly initialised BN), and the 3x3 heads made positive
    and scaled up so the first predictions are positive depths of tens of
    meters (the CPU parity tests start from the same kind of weights)."""
    from radar_depth_tpu_torch.models import BatchNorm, init_random

    init_random(model, seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("conv3.weight"):
                p.abs_().mul_(50.0)
    return model


def train_config(dtype="float32", height=None, width=None, sweeps=5, **data):
    from radar_depth_tpu_torch.config import DataConfig, ModelConfig, TrainConfig

    return TrainConfig(
        data=DataConfig(height=height or H, width=width or W,
                        num_sweeps=sweeps, **data),
        model=ModelConfig(arch="resnet18_multistage", dtype=dtype),
        batch_size=B_TRAIN)


def train_setup(torch, cfg, device, seed=0, state_dict=None):
    from radar_depth_tpu_torch.models import create_model
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import make_train_step

    model, spec = create_model(
        cfg.model.arch, device=device,
        output_size=(cfg.data.height, cfg.data.width),
        dtype=cfg.model.torch_dtype, param_dtype=torch.float32)
    if state_dict is None:
        train_init(torch, model, seed)
    else:
        model.load_state_dict(state_dict)
    state = create_train_state(model, cfg.optim, steps_per_epoch=32)
    return model, spec, state, make_train_step(model, spec, cfg)


def run_steps(torch, dev, step, state, batch, steps, seed=0):
    """``steps`` train steps on one batch with the same augmentation each
    time (the generator reseeded), so the loss must fall. Returns the losses
    and the host-clock seconds of each step (each ends in a fetch of its
    loss)."""
    losses, times = [], []
    gen = torch.Generator(device=dev)
    for _ in range(steps):
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        sums = step(state, batch, generator=gen)
        losses.append(float(sums["loss"]))
        times.append(time.perf_counter() - t0)
    return losses, times


def param_snapshot(model):
    return {k: v.detach().double().cpu() for k, v in model.named_parameters()}


def stats_snapshot(model):
    return {k: v.detach().double().cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def compare_steps(np, before, got_model, want_model, got_sums,
                  want_sums, what):
    """One train step of two runs from the same weights: sums within
    SUMS_RTOL, per-tensor updates within UPDATE_TOL (normalized by the
    tensor's norm plus sqrt(n) times the RMS over all updates, as
    tests/test_torch_train.py does), running statistics within STATS_TOL.
    Returns the largest errors."""
    sums_err = max(abs(float(got_sums[k]) - float(want_sums[k]))
                   / max(abs(float(want_sums[k])), 1e-30) for k in want_sums)
    if sums_err > SUMS_RTOL:
        raise AssertionError(f"{what}: sums differ by {sums_err:.2e}")
    got = {k: v - before[k] for k, v in param_snapshot(got_model).items()}
    want = {k: v - before[k] for k, v in param_snapshot(want_model).items()}
    rms = math.sqrt(sum(float((w * w).sum()) for w in want.values())
                    / sum(w.numel() for w in want.values()))
    upd_err = max(float((got[k] - w).norm())
                  / (float(w.norm()) + math.sqrt(w.numel()) * rms)
                  for k, w in want.items())
    glob = math.sqrt(sum(float(((got[k] - w) ** 2).sum())
                         for k, w in want.items())
                     / sum(float((w * w).sum()) for w in want.values()))
    if upd_err > UPDATE_TOL:
        raise AssertionError(f"{what}: updates differ by {upd_err:.2e}")
    gs, ws = stats_snapshot(got_model), stats_snapshot(want_model)
    stats_err = 0.0
    for k, w in ws.items():
        np.testing.assert_allclose(gs[k].numpy(), w.numpy(), err_msg=k,
                                   **STATS_TOL)
        stats_err = max(stats_err, float((gs[k] - w).abs().max()))
    return {"sums_max_rel": sums_err, "update_max_err": upd_err,
            "update_global_rel": glob, "stats_max_abs": stats_err}


def phase_train(torch, np, dev, batch):
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.ops.augment import AugmentConfig, sample_affine_params

    take = lambda lo, hi: {k: v[lo:hi] for k, v in batch.items()}
    b8 = take(0, B_TRAIN)
    out = {"batch": B_TRAIN, "steps": TRAIN_STEPS, "tf32": False}
    launches, trained = {}, {}
    with tf32(torch, False):
        for dtype in ("float32", "bfloat16"):
            cfg = train_config(dtype)
            model, spec, state, step = train_setup(torch, cfg, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            losses, times = run_steps(torch, dev, step, state, b8, TRAIN_STEPS)
            launches[dtype] = read_launches()
            want = {KERNELS["A"]: 0, KERNELS["B"]: 0,
                    KERNELS["C"]: TRAIN_STEPS}
            if launches[dtype] != want:
                raise AssertionError(f"train {dtype}: launches "
                                     f"{launches[dtype]}, expected {want}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"train {dtype}: losses {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"train {dtype}: loss did not fall "
                                     f"{losses}")
            out[dtype] = {
                "losses": losses, "step_ms": [t * 1e3 for t in times],
                "img_per_s": B_TRAIN / statistics.median(times[1:]),
                "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
            trained[dtype] = (model, spec, state, step)

        # gt_augment="rerasterize": the LiDAR GT goes through kernel C too
        cfg = train_config("float32", gt_augment="rerasterize")
        model, spec, state, step = train_setup(torch, cfg, dev)
        reset_launches()
        losses, _ = run_steps(torch, dev, step, state, b8, 3)
        launches["rerasterize"] = read_launches()
        want = {KERNELS["A"]: 0, KERNELS["B"]: 0, KERNELS["C"]: 6}
        if launches["rerasterize"] != want:
            raise AssertionError(f"rerasterize launches "
                                 f"{launches['rerasterize']}, expected {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"rerasterize losses {losses}")
        out["rerasterize"] = {"losses": losses}
        del model, state, step

        # kernel path against the plain path on the card, one float32 step
        cfg = train_config("float32")
        sd = train_init(torch, train_setup(torch, cfg, "cpu")[0], 1).state_dict()
        from radar_depth_tpu_torch.train.step import make_train_step

        runs = {}
        for plain in (False, True):
            model, spec, state, _ = train_setup(torch, cfg, dev,
                                                state_dict=sd)
            step = make_train_step(model, spec, cfg, plain=plain)
            gen = torch.Generator(device=dev).manual_seed(3)
            runs[plain] = (model, step(state, b8, generator=gen))
        before = {k: v.double() for k, v in sd.items()}
        out["kernels_vs_plain"] = compare_steps(
            np, before, runs[False][0], runs[True][0], runs[False][1],
            runs[True][1], "train kernels vs plain")
        del runs

        # small input: the card's kernel path against the CPU's plain path
        small = train_config("float32", height=64, width=96, sweeps=3)
        sb = SyntheticNuScenes(2, spec=SampleSpec(height=64, width=96,
                                                  num_sweeps=3,
                                                  lidar_points=2048),
                               seed=4).batch(range(2))
        sd = train_init(torch, train_setup(torch, small, "cpu")[0],
                        2).state_dict()
        aug = sample_affine_params(torch.Generator().manual_seed(4),
                                   AugmentConfig(), 2)
        runs = {}
        for device in (dev, "cpu"):
            with torch.backends.mkldnn.flags(enabled=False):
                model, _, state, step = train_setup(torch, small, device,
                                                    state_dict=sd)
                runs[str(device)] = (model, step(state, sb, aug_params=aug))
        before = {k: v.double() for k, v in sd.items()}
        out["small_card_vs_cpu"] = compare_steps(
            np, before, runs[str(dev)][0], runs["cpu"][0],
            runs[str(dev)][1], runs["cpu"][1], "train card vs CPU")
        del runs

    # B=32 in bfloat16, if it fits (TF32 does not apply to bfloat16)
    b32 = {k: np.concatenate([v, v[:32 - len(v)]]) for k, v in batch.items()}
    try:
        model, spec, state, step = train_setup(torch, train_config("bfloat16"),
                                               dev)
        torch.cuda.reset_peak_memory_stats(dev)
        losses, times = run_steps(torch, dev, step, state, b32, 4)
        out["bfloat16_b32"] = {
            "fits": True, "losses": losses,
            "img_per_s": 32 / statistics.median(times[1:]),
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    except torch.cuda.OutOfMemoryError as e:
        out["bfloat16_b32"] = {"fits": False, "error": str(e)[:200]}
    model = state = step = None
    torch.cuda.empty_cache()
    emit({"phase": "train", "launches": launches, **out})
    return out, launches, trained


def phase_eval(torch, np, dev, batch, trained):
    from radar_depth_tpu_torch.train.step import make_eval_step

    model, spec, _, _ = trained["float32"]
    cfg = train_config("float32")
    b8 = {k: v[:B_TRAIN] for k, v in batch.items()}
    eval_step = make_eval_step(model, spec, cfg)
    with tf32(torch, False):
        eval_step(b8)  # warm-up
        reset_launches()
        got = eval_step(b8)
        torch.cuda.synchronize()
        launches = read_launches()
        want = make_eval_step(model, spec, cfg, plain=True)(b8)
    expect = {KERNELS["A"]: 0, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD,
              KERNELS["C"]: 1}
    if launches != expect:
        raise AssertionError(f"eval launches {launches}, expected {expect}")
    got = {k: float(v) for k, v in got.items()}
    want = {k: float(v) for k, v in want.items()}
    if not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"eval sums {got}")
    err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want)
    if err > SUMS_RTOL:
        raise AssertionError(f"eval sums differ from the plain path by {err}")
    out = {"phase": "eval", "launches": launches, "sums": got,
           "plain_sums_max_rel": err, "bit_equal": got == want}
    emit(out)
    return out


def _category(name: str) -> str:
    n = name.lower()
    if "sbr_" in n:
        return "kernel_B_epilogue"
    if "zbs_" in n:
        return "kernel_C_zbuffer_sorted"
    if "zb_" in n:
        return "kernel_A_zbuffer"
    if "foreach" in n:
        return "optimizer"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if any(k in n for k in ("conv", "xmma", "cudnn", "sm90", "sm80", "gemm",
                            "implicit", "dgrad", "wgrad", "cutlass")):
        return "conv"
    return "other"


def profile_device(torch, fn, name, batch_size):
    """Device time by kernel category over one call of ``fn`` (torch.profiler,
    CUPTI), against the call's host-clock wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats, kernels_by_name, launches = {}, {}, 0
    for e in prof.key_averages():
        # user annotations (Optimizer.step's range) span kernels counted
        # on their own
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        cats[_category(e.key)] = cats.get(_category(e.key), 0.0) + us / 1e3
        kernels_by_name[e.key[:80]] = us / 1e3
        launches += e.count
    busy = sum(cats.values())
    top = sorted(kernels_by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"phase": name, "batch": batch_size,
           "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": (1 - busy / wall_ms) if busy else None,
           "device_ms_by_category": cats, "device_events": launches,
           "top_kernels_ms": top}
    emit(out)
    return out


def phase_profile(torch, pred, batch):
    return profile_device(torch, lambda: pred.predict(batch), "profile",
                          next(iter(batch.values())).shape[0])


def phase_profile_train(torch, dev, trained, batch):
    """One B=8 train step of each dtype (float32 with TF32 off)."""
    b8 = {k: v[:B_TRAIN] for k, v in batch.items()}
    gen = torch.Generator(device=dev)
    out = {}
    for dtype, (_, _, state, step) in trained.items():
        def one_step():
            gen.manual_seed(0)
            step(state, b8, generator=gen)

        with tf32(torch, False):
            out[dtype] = profile_device(torch, one_step,
                                        f"profile_train_{dtype}", B_TRAIN)
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
          "nvcc": built,
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

    flush = l2_flusher(torch, dev)
    zb = phase_zbuffer(torch, dev, batch, flush)
    zbs = phase_zbuffer_sorted(torch, dev, batch, flush)
    del flush
    launches, launches_sc, speed, parity, pred, sites = phase_serve(
        torch, np, dev, batch, sd)
    epi, epi_err = phase_epilogue(torch, dev, sites)
    prof = phase_profile(torch, pred, {k: v[:B_SERVE]
                                       for k, v in batch.items()})
    del pred
    train, train_launches, trained = phase_train(torch, np, dev, batch)
    ev = phase_eval(torch, np, dev, batch, trained)
    prof_train = phase_profile_train(torch, dev, trained, batch)

    stem = next(r for r in epi if r["dtype"] == "bfloat16"
                and not r["residual"] and r["shape_nchw"][1] == 64
                and r["shape_nchw"][2] == (H + 1) // 2)
    serve = zb["serve_radar"]
    radar = zbs["radar"]
    summary = {"kernels": [
        {"name": "zbuffer_min_depth", "route": "cuda",
         "source": "radar_depth_tpu_torch/csrc/zbuffer.cu",
         "replaces": "radar_depth_tpu/ops/pallas_kernels.py:71",
         "launches": launches_sc[KERNELS["A"]], "max_abs_err": 0.0,
         "ms": serve["ms"], "ms_cold": serve["ms_cold"],
         "ms_back_to_back": serve["ms_back_to_back"],
         "plain_ms": serve["plain_ms"],
         "bound_ms": serve["bound_ms"], "bound_by": "bytes",
         "bound_share": serve["bound_share"],
         "library_ms": serve["library_ms"]},
        {"name": "scale_bias_relu", "route": "cuda",
         "source": "radar_depth_tpu_torch/csrc/epilogue.cu",
         "replaces": "radar_depth_tpu/ops/pallas_kernels.py:251",
         "launches": launches[KERNELS["B"]],
         "max_abs_err": max(epi_err.values()),
         "ms": stem["ms"], "plain_ms": stem["plain_ms"],
         "bound_ms": stem["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "zbuffer_min_depth_sorted", "route": "cuda",
         "source": "radar_depth_tpu_torch/csrc/zbuffer_sorted.cu",
         "replaces": "radar_depth_tpu/ops/pallas_kernels.py:176",
         "launches": train_launches["float32"][KERNELS["C"]],
         "max_abs_err": 0.0,
         "ms": radar["ms"], "ms_cold": radar["ms_cold"],
         "ms_back_to_back": radar["ms_back_to_back"],
         "plain_ms": radar["plain_ms"],
         "bound_ms": radar["bound_ms"], "bound_by": "bytes",
         "bound_share": radar["bound_share"],
         "library_ms": radar["library_ms"]},
    ]}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": {"torch_name": kind, "nvidia_smi": smi},
                       "zbuffer": zb, "zbuffer_sorted": zbs, "epilogue": epi,
                       "speed": speed, "parity": parity,
                       "launches": {"serve": launches,
                                    "serve_scatter": launches_sc,
                                    "train": train_launches,
                                    "eval": ev["launches"]},
                       "train": train, "eval": ev, "profile": prof,
                       "profile_train": prof_train,
                       "summary": summary}, f, indent=1)
    emit(summary)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
