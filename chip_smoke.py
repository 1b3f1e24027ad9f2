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
  precision      the port's float32 setting (device.py): TF32 switched on,
                 then a default float32 flagship Predictor built with no
                 context leaves IEEE convolutions and matmuls and cuDNN's
                 deterministic algorithms; its B=8 predict bit-equal to the
                 same forward under an explicit TF32-off context and to a
                 second call (84 B + 1 C launches), beside the TF32 forward's
                 difference; a float32 B=2 artifact against predict (rel RMSE
                 <= 1e-6); in turns (ABBA), TF32 on against the port's
                 setting in float32 served img/s and train-step img/s at
                 B=8, and cuDNN's deterministic algorithms on against off in
                 bfloat16 served img/s at B=8
  profile        device time by kernel category over one B=8 predict call,
                 its device events and device kernels, kernel B's device us
                 at each of its sites
  host_fold_abba the served flagship B=8 forward with the BN fold inside
                 kernel B (rdt::batch_norm_relu) against the same forward
                 with the fold patched back onto the host (five eager ops
                 per site, then rdt::scale_bias_relu), in turns: launches,
                 device kernels and busy ms per forward, host ms to enqueue
                 the model's forward, img/s; predictions bit-equal, at least
                 400 device kernels fewer per forward
  serve_http     the flagship (bfloat16, max_tile=8) behind the HTTP daemon
                 (serve.py::DepthServer on 127.0.0.1, in-process): warmup
                 seconds, /healthz 503 before it and 200 after, requests of 3
                 and 11 samples equal to Predictor.predict with kernel B at
                 84 and kernel C at 1 launch per tile, a malformed request
                 answered by a 400 JSON error with the server still up,
                 every predict made on the daemon's one device thread (its
                 host time kept); 8 clients sending 64 one-sample requests
                 single-flight (window 0) and coalesced (window 5 ms):
                 requests/s, p50/p99 ms, device dispatches
  bench          the port's benchmark entry points, each through its main()
                 in this process, at 450x800 and 5 sweeps (flagship, seeded
                 random weights), each JSON line printed with its launches
                 (asserted per forward or step), host seconds and peak
                 memory: python -m radar_depth_tpu_torch.bench in mode infer
                 (bfloat16 at B=128 and float32 at B=8, --iters 10 --repeat
                 3: img/s median, min, max, mean, and mfu against the card's
                 dense peak), stream (bfloat16, B=128, --stream-iters 8),
                 train (bfloat16, B=32, and B=16 with --grad-accum 2, --iters
                 5, native loader); .bench_latency (--batches 1,8,32
                 --requests 30: device and end-to-end ms p50/p90/p99/mean);
                 .bench_serve_concurrency at its defaults (96x160, 3
                 sweeps, 64 requests: a smoke size) and at 450x800, 5
                 sweeps, 512 requests (req/s, p50/p99 ms, dispatches,
                 single-flight and coalesced); kernel B 84 and kernel C 1
                 per served forward (42 and 1 per resnet18_latefusion
                 daemon forward), kernel C 1 and kernel B 0 per train
                 micro-batch, the launches per call as read; then, at the
                 phase's shapes, each kernel path bit-equal to its plain
                 version: one iteration of the bench's infer function
                 against Predictor.infer and its plain=True twin (bfloat16
                 B=128, float32 B=8), the latency tool's Predictor at
                 B=1, 8, 32 and the daemon's at tiles 1, 2, 4, 8 (both
                 sizes) against their plain twins, kernel C on the B=32
                 native-loader train batch against the plain z-buffer;
                 host seconds of 8 synthetic samples in the bench's
                 thread pool and one by one, at 64x96 and 450x800
  export         the flagship at B=8 (bfloat16) exported with both
                 raster_backend values (Predictor.export_serving): bytes,
                 export and load seconds, the rdt.* nodes of each graph; one
                 call of each loaded artifact counted (84 B and 1 C, or 1 A)
                 and equal to Predictor.predict; the sorted artifact loaded
                 and checked again in a fresh process that imports only the
                 port; img/s of the artifact beside Predictor.predict (ABBA)
  ops_api        the public ops (radar_depth_tpu_torch.ops): radar_to_depth_map
                 at B=8, 5 sweeps, 450x800 with both z-buffer backends, each
                 bit-equal to plain=True, counted (1 C or 1 A) and timed
                 beside it; utils.profiling.device_trace (the card by
                 default) around one served B=8 forward, its trace naming
                 rdt::batch_norm_relu and rdt::zbuffer_min_depth_sorted
  zoo            the rest of the registry at full width (bfloat16, B=8,
                 seeded random weights), each through Predictor with its
                 kernel B sites per forward checked against the module
                 structure and its launches counted, img/s and peak memory,
                 float32 parity of the kernel path against the plain path
                 (TF32 off): resnet34_latefusion (5 sweeps), resnet18 rgbd
                 and rgb (1 sweep), resnet50_multistage (profiled: kernel B's
                 share of device time), resnet18_latefusion with deconv2,
                 deconv3 and upconv; bf16 train steps (loss finite and
                 falling, launches, img/s, peak memory) of resnet34_latefusion,
                 resnet18 rgbd, resnet50_multistage, resnet18_multistage with
                 stage2_coarse and as _uncertainty, resnet18 rgbd under
                 --sparsifier uar (no z-buffer launch); the flagship's step
                 with and without --remat from the same weights, BN running
                 statistics after one step bit-equal; whether a DeConv
                 decoder's bf16 train step repeats bit for bit, with cuDNN's
                 default and its deterministic algorithms
  epilogue       kernel B's two operators, rdt::batch_norm_relu (the BN
                 folded in the kernel) and rdt::scale_bias_relu (folded scale
                 and bias given), against their plain versions at every
                 (shape, residual) that the flagship and the zoo give it at
                 B=8, in bfloat16 and float32: bit-equal (signed zeros
                 aside); warm, L2-cold, back-to-back and plain times against
                 the bytes bound (device us per flagship site from phase
                 profile), and F.batch_norm's time (less
                 work: a yardstick, never called by the port); the host time
                 per call of both operators, their wrappers and bare ctypes
                 launches, the host fold before the wrapper, and a
                 torch.library.custom_op form, at the smallest flagship site;
                 the race check of programmatic dependent launch (a cuDNN
                 conv writes x, kernel B reads it, 200 times at the stem and
                 layer4 sites, each result bit-equal); the flagship's
                 serving img/s at B=8 through the registered operators
  train          the flagship's train step at B=8 on SyntheticNuScenes(seed=0):
                 10 float32 and 10 bfloat16 steps on a repeated batch (loss
                 finite and falling), 3 steps with gt_augment="rerasterize",
                 launch counts per step, img/s and peak memory (and B=32
                 bfloat16 if it fits); one float32 step of the kernel path
                 against the plain path on the card (TF32 off) and against the
                 CPU on a small input
  eval           make_eval_step on B=8: launch counts, metric sums against
                 the plain path
  profile_train  the same over one B=8 train step, float32 and bfloat16
  harness        the training harness at full width (flagship, bfloat16,
                 B=8, 450x800) on packed SyntheticNuScenes shards (48 train,
                 16 val; written by python -m
                 radar_depth_tpu_torch.generate_dataset in a child process)
                 through the native loader with host augmentation:
                 train.main for 2 epochs (launch counts per train step and
                 per val forward), the run directory's files, --resume to
                 epoch 3 against a straight 3-epoch run, --evaluate against
                 the best stored row, Predictor.from_run against the
                 Trainer model's eval-mode prediction; epoch img/s, data and
                 device time per step, epoch walls, checkpoint size and save
                 time, --evaluate img/s; then resnet50_multistage through
                 train.main, one bfloat16 epoch of 16 packed samples at B=8
                 and --evaluate of the run: epoch img/s, peak memory,
                 checkpoint bytes, kernel B at 212 launches per eval forward
  ingest         the day-one chain of radar_depth_tpu_torch/rehearse.py at
                 full width: 80 reference-format pickles at 900x1600
                 (rehearse.fabricate, seed 0, 10% map-only radar, 25%
                 night), imported in a child process (rehearse.run_importer:
                 450x800, 1 sweep, 70 train / 10 val; peak RSS under 2 GB,
                 at least 2 train shards, val sidecars with day and night),
                 one epoch of rehearse.train_argv's run (resnet18_latefusion,
                 B=32, bfloat16) through train.main and --evaluate
                 --eval-splits, both counted (kernel C 1 per train step and
                 per forward, kernel B at every eval BN->ReLU site of the
                 built model per forward, kernel A 0; --evaluate within
                 1e-5 of the stored row, test_day.csv and test_night.csv),
                 python -m radar_depth_tpu_torch.export_oracle in a child
                 process that sees no card: the export mapped back to the
                 checkpoint bit for bit, and a float32 Predictor of it
                 bit-equal to Predictor.from_run at B=8; seconds of each
                 step, RSS, shards and MB, epoch and --evaluate img/s
  eval_two_stage python -m radar_depth_tpu_torch.eval_two_stage on the card:
                 the float32 flagship of phase serve's weights saved as a
                 port run over the harness's 16 val samples (day/night),
                 --split all,day,night --batch 8: kernel B 84 and kernel C 1
                 launch per batch, the JSON lines against the same tool with
                 the Predictor's plain=True (metrics rtol 1e-4 + 5e-6,
                 efficacy counts equal but for pixels near a threshold),
                 img/s of a warm pass
  profile_harness  device time and idle share over one harness train epoch
  data_parallel  the data-parallel path (parallel/mesh.py) with the flagship
                 at full width: (a) a 1-rank NCCL group on card 0, 6 float32
                 (TF32 off) and 6 bfloat16 B=8 train steps through the DP
                 path bit-equal to the same steps without a group, and one
                 eval step bit-equal too, launches counted (kernel C 1 per
                 step; 84 B + 1 C per eval step), all-reduces per step, the
                 ms of the flat gradient all-reduce, img/s of the DP path
                 beside the plain step's; (b) two processes on card 0 over
                 gloo (NCCL refuses two ranks on one device), 4 rows each
                 of B=8, one float32 train step against the 1-process B=8
                 step under phase train's gates, the ranks' parameters
                 bit-equal, per rank kernel C 1 per train step and 84 B + 1
                 C per eval step, eval sums rtol 1e-4 (a correctness check,
                 not a scaling number); (c) torchrun --nproc-per-node 1 of
                 train.main (NCCL) for 1 epoch on the harness shards, its
                 test.csv row against the harness's straight run's epoch 0
  spatial        spatial partitioning (parallel/spatial.py), the flagship at
                 full width with image height sharded over two gloo
                 processes on card 0 (chip_smoke.py --spatial-worker DIR,
                 started by the phase; a correctness check, not a scaling
                 number): (a) a float32 Predictor forward of B=8 (TF32 off)
                 against the single-process plain-kernel Predictor, rel RMSE
                 <= 1e-5, both ranks' maps bit-equal, per rank kernel C 1 and
                 kernel B 84; (b) the micro-step gradients summed over ranks
                 against the single-process ones, every parameter's norm
                 ratio in 0.98-1.02, and two float32 train steps under phase
                 train's gates (the second from the plain step's
                 parameters), the ranks' parameters bit-equal after each;
                 (c) halo exchanges per forward and per train step, bytes per
                 exchange, host ms of the exchanges, bf16 B=8 step img/s and
                 per-rank peak memory beside the plain step's
  serve_http_spatial  the HTTP daemon over ranks (serve.py::run_daemon, the
                 path of `torchrun ... -m radar_depth_tpu_torch.serve
                 --spatial 2`): two processes sharing card 0 over gloo
                 (chip_smoke.py --serve-spatial-worker DIR, started by the
                 phase), a (1, 2) mesh, the float32 flagship of phase
                 spatial's weights, max_tile 8, window 5 ms; /healthz 503
                 then 200; one B=8 and eight B=1 requests against the
                 single-process predict (rel RMSE <= 1e-5); 8 clients x 16
                 one-sample requests (req/s, p50/p99 beside serve_http's
                 coalesced numbers; gloo copies through the host: a check,
                 not a speed); a body the schema check refuses answered 400
                 and the next one served; SIGINT to rank 0, both ranks exit
                 0 with equal dispatch counts; per rank kernel C 1 and
                 kernel B 84 per predict call; the leader's host ms and
                 bytes per broadcast
Then the script's wall time, the kernels' summary line (kernel B's with its
launches per forward for each configuration), nvidia-smi's line, and last
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
EPS = 1e-5  # the model's BN epsilon (models/layers.py::make_norm)
RACE_ITERS = 200  # conv-then-kernel-B launches per site of the race check
# kernel B's timed runs (<= 50 launches of a few kernels) are enqueued in
# well under the ~10 ms of this device sleep
EPILOGUE_SLEEP_CYCLES = 20_000_000
HOST_FOLD_MIN_KERNELS = 400  # device kernels per flagship forward the fold
# inside kernel B must save (84 sites x 5 fold ops = 420)
FP32_ABS_TOL = 1e-6  # kernel B vs plain, float32
PARITY_REL_RMSE_TOL = 1e-5  # float32 forward, kernels vs plain, same card
SMALL_TOL = dict(atol=2e-4, rtol=1e-3)  # card vs CPU, as the CPU parity tests
BF16_REL_RMSE_TOL = 0.2  # bfloat16 forward vs float32 plain: sanity bound
SUMS_RTOL = 1e-4  # loss and metric sums, as the CPU parity tests
UPDATE_TOL = 5e-2  # per-tensor update error, normalized as the CPU tests
STATS_TOL = dict(atol=1e-5, rtol=1e-4)  # BN running statistics
HARNESS_TRAIN, HARNESS_VAL = 48, 16  # packed samples per split
RESUME_RTOL = 1e-3  # resumed vs straight run, last test.csv row, on the card
EVAL_RTOL = 1e-5  # --evaluate vs the best epoch's stored test.csv row
CSV_METRICS = ("mse", "rmse", "absrel", "lg10", "mae", "delta1", "delta2",
               "delta3")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3, flush=None,
            sleep_cycles=100_000_000) -> float:
    """Median of per-launch CUDA-event times over ``iters`` runs.

    The runs are queued behind a device sleep (``sleep_cycles``, ~50 ms by
    default), so the host has enqueued them all before the card reaches the
    first: each event pair
    then brackets the device's work alone, not the host's launch overhead
    (a function that synchronises inside, like the plain z-buffer, still
    pays its host gaps). With ``flush`` (from ``l2_flusher``), each run is
    preceded, outside its event pair, by a write of a buffer larger than the
    L2, so the run finds the L2 full of other dirty lines: the L2-cold
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
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


def cuda_ms_back_to_back(torch, fn, launches=50, warmup=3,
                         sleep_cycles=100_000_000) -> float:
    """Event time of ``launches`` back-to-back runs, over their count: each
    run's launch overlaps the run before it, as inside a stream of work, so
    the per-launch cost of one event pair is spread over all of them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
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


def warm_and_cold(torch, fn, flush, bound_ms,
                  sleep_cycles=100_000_000) -> dict:
    """Warm, L2-cold and back-to-back times of ``fn``, and the bound's share
    of the cold one."""
    cold = cuda_ms(torch, fn, flush=flush, sleep_cycles=sleep_cycles)
    return {"ms": cuda_ms(torch, fn, sleep_cycles=sleep_cycles),
            "ms_cold": cold,
            "ms_back_to_back": cuda_ms_back_to_back(
                torch, fn, sleep_cycles=sleep_cycles),
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


def bn_params(torch, dev, g, c):
    """A BN's float32 (weight, bias, running_mean, running_var) near
    identity, as init_random draws them: weight and var in [0.5, 1.5), bias
    and mean N(0, 0.1)."""
    near_one = lambda: torch.rand(c, generator=g, device=dev) + 0.5
    small = lambda: torch.randn(c, generator=g, device=dev) * 0.1
    return near_one(), small(), small(), near_one()


def bits_differ(torch, got, want):
    """(elements whose bits differ, a zero of the other sign aside; the
    zeros that differ only in their sign), as boolean tensors."""
    idtype = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    differ = got.view(idtype) != want.view(idtype)
    zeros = differ & (got == 0) & (want == 0)
    return differ & ~zeros, zeros


def epilogue_host_us(torch, dev, calls=128, reps=6):
    """Host time per call, in us, of kernel B's forms at the smallest
    flagship site (bf16 8x512x15x25, no residual): with the fold in the
    kernel, the registered operator torch.ops.rdt.batch_norm_relu, its
    wrapper (argument checks, then the operator) and its bare ctypes
    launch; the site as it was before, the fold on the host
    (kernels.fold_batch_norm, five eager ops) then the wrapper of
    rdt::scale_bias_relu; and rdt::scale_bias_relu itself as operator,
    wrapper, torch.library.custom_op form and bare launch. Each run of
    ``calls`` calls is queued behind a device sleep longer than the run, so
    the host never waits for the card and its clock over the run measures
    the calls alone (128 calls keep the host-fold form's 768 launches
    inside the launch queue); the forms in turns, the order reversed every
    round, medians over ``reps`` runs."""
    from radar_depth_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((8, 512, 15, 25), generator=g, device=dev).to(
        torch.bfloat16, memory_format=torch.channels_last)
    w, b, m, v = bn_params(torch, dev, g, 512)
    scale, bias = kernels.fold_batch_norm(w, b, m, v, EPS)
    out = torch.empty_like(x)

    def custom_impl(x, scale, bias):
        y = torch.empty_like(x)
        kernels.launch_epilogue(x, None, y, scale, bias)
        return y

    custom = torch.library.custom_op(
        "rdt_smoke::scale_bias_relu", custom_impl, mutates_args=(),
        schema="(Tensor x, Tensor scale, Tensor bias) -> Tensor")
    fns = {"bnr_bare_ctypes_launch": lambda: kernels.launch_epilogue(
               x, None, out, w, b, m, v, EPS),
           "bnr_rdt_op": lambda: torch.ops.rdt.batch_norm_relu(
               x, w, b, m, v, EPS),
           "bnr_wrapper": lambda: kernels.batch_norm_relu(x, w, b, m, v, EPS),
           "host_fold_then_wrapper": lambda: kernels.scale_bias_relu(
               x, *kernels.fold_batch_norm(w, b, m, v, EPS)),
           "bare_ctypes_launch": lambda: kernels.launch_epilogue(
               x, None, out, scale, bias),
           "rdt_op": lambda: torch.ops.rdt.scale_bias_relu(x, scale, bias),
           "wrapper": lambda: kernels.scale_bias_relu(x, scale, bias),
           "custom_op": lambda: custom(x, scale, bias)}
    want = kernels.batch_norm_relu_reference(x, w, b, m, v, EPS)
    for name, fn in fns.items():
        got = fn()
        if "bare" in name:
            got = out
        torch.cuda.synchronize()
        if bits_differ(torch, got, want)[0].any():
            raise AssertionError(f"epilogue host timing: {name} differs")
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)  # ~25 ms > 128 calls of any form
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[name]()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return {"shape_nchw": list(x.shape), "calls_per_run": calls,
            **{f"{name}_us": statistics.median(t) for name, t in times.items()},
            **{f"{name}_us_all": t for name, t in times.items()}}


def epilogue_race_check(torch, dev, site, iters=RACE_ITERS):
    """Kernel B's programmatic dependent launch against its hazard: a cuDNN
    conv writes x (at "layer4" a 1x1 conv writes the residual first), and
    batch_norm_relu reads it with nothing between them on the stream.
    ``iters`` times, the conv's input taken from three in turn, so that the
    buffer the allocator hands x again held other values before; every
    result held bit-equal (signed zeros aside) to the plain version on the
    same x, the mismatches summed on the card. Sites, bf16, B=8: "stem"
    (8x64x225x400, the 7x7 stride-2 conv of 8x3x450x800, no residual) and
    "layer4" (8x512x15x25, a 3x3 conv, with the residual)."""
    import torch.nn.functional as F

    from radar_depth_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(11)
    cl = torch.channels_last
    if site == "stem":
        cin, c, hw, k, stride = 3, 64, (H, W), 7, 2
    else:
        cin, c, hw, k, stride = 512, 512, (15, 25), 3, 1
    he = lambda co, ci, kk: (torch.randn(co, ci, kk, kk, generator=g,
                                         device=dev) * (2.0 / (ci * kk * kk))
                             ** 0.5).to(torch.bfloat16, memory_format=cl)
    inputs = [torch.randn(B_SERVE, cin, *hw, generator=g, device=dev).to(
        torch.bfloat16, memory_format=cl) for _ in range(3)]
    weight = he(c, cin, k)
    shortcut = he(c, cin, 1) if site == "layer4" else None
    params = bn_params(torch, dev, g, c)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    layouts = set()
    torch.cuda.synchronize()
    for i in range(iters):
        inp = inputs[i % 3]
        r = None if shortcut is None else F.conv2d(inp, shortcut)
        x = F.conv2d(inp, weight, stride=stride, padding=k // 2)
        layouts.add(x.is_contiguous(memory_format=cl))
        y = kernels.batch_norm_relu(x, *params, EPS, r)
        want = kernels.batch_norm_relu_reference(x, *params, EPS, r)
        bad += bits_differ(torch, y, want)[0].sum()
        del r, x, y, want
    torch.cuda.synchronize()
    out = {"site": site, "dtype": "bfloat16", "iters": iters,
           "residual": shortcut is not None,
           "conv_output_channels_last": sorted(layouts),
           "mismatched_elements": int(bad)}
    if out["mismatched_elements"] or layouts != {True}:
        raise AssertionError(f"epilogue race check: {out}")
    return out


def epilogue_ops(kernels, x, res, bn, folded):
    """{operator: (its wrapper's call, its plain version's call, the bytes
    it must move)} of kernel B's two operators on x and the residual, with
    the BN's (weight, bias, running_mean, running_var) ``bn`` or their
    ``folded`` (scale, bias)."""
    c = bn[0].shape[0]
    moved = x.numel() * x.element_size() * (2 if res is None else 3)
    return {
        "batch_norm_relu": (
            lambda: kernels.batch_norm_relu(x, *bn, EPS, res),
            lambda: kernels.batch_norm_relu_reference(x, *bn, EPS, res),
            moved + 4 * c * 4),
        "scale_bias_relu": (
            lambda: kernels.scale_bias_relu(x, *folded, res),
            lambda: kernels.scale_bias_relu_reference(x, *folded, res),
            moved + 2 * c * 4)}


def phase_epilogue(torch, dev, sites_by_config, device_us_by_site,
                   serve_img_per_s):
    """Kernel B's two operators against their plain versions at every
    (shape, residual) that the served configurations give it
    (``sites_by_config``: config name -> the sites of one B=8 forward), in
    bfloat16 and float32: bit-equal (a signed zero aside); warm, L2-cold,
    back-to-back and plain ms beside the bytes bound, and the device us of
    the flagship's bf16 sites in a profiled served forward
    (``device_us_by_site``, from phase profile); the yardstick
    F.batch_norm (less work: no ReLU, no residual), timed only; the host
    cost per call (``epilogue_host_us``); the conv-then-kernel race check at
    the stem and layer4 sites; the flagship's serving img/s at B=8 through
    the operators (``serve_img_per_s``, from phase serve)."""
    import torch.nn.functional as F

    from radar_depth_tpu_torch.ops import kernels

    per_site = {}
    for name, sites in sites_by_config.items():
        for site in sites:
            counts = per_site.setdefault(site, {})
            counts[name] = counts.get(name, 0) + 1
    g = torch.Generator(device=dev).manual_seed(1)
    flush = l2_flusher(torch, dev)
    shapes = sorted(per_site, key=lambda s: (-math.prod(s[0]), s[1]))
    results, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    for dtype, dname in ((torch.bfloat16, "bfloat16"),
                         (torch.float32, "float32")):
        for shape, has_res in shapes:
            mk = lambda: torch.randn(shape, generator=g, device=dev).to(
                dtype, memory_format=torch.channels_last)
            x = mk()
            res = mk() if has_res else None
            w, b, m, v = bn_params(torch, dev, g, shape[1])
            scale, bias = kernels.fold_batch_norm(w, b, m, v, EPS)
            r = {"dtype": dname, "shape_nchw": list(shape), "residual": has_res,
                 "sites_per_forward": per_site[(shape, has_res)]}
            for op, (fn, plain, nbytes) in epilogue_ops(
                    kernels, x, res, (w, b, m, v), (scale, bias)).items():
                got, want = fn(), plain()
                differ, zeros = bits_differ(torch, got, want)
                err = float((got.float() - want.float()).abs().max())
                if differ.any():
                    raise AssertionError(
                        f"epilogue {op} {dname} {shape} res={has_res}: "
                        f"{int(differ.sum())} values differ from the plain "
                        f"version in their bits (max err {err})")
                max_err[dname] = max(max_err[dname], err)
                r[op] = {"max_abs_err": err,
                         "signed_zero_diffs": int(zeros.sum()),
                         **warm_and_cold(torch, fn, flush,
                                         nbytes / HBM_BYTES_PER_S * 1e3,
                                         EPILOGUE_SLEEP_CYCLES),
                         "plain_ms": cuda_ms(
                             torch, plain,
                             sleep_cycles=EPILOGUE_SLEEP_CYCLES)}
            in_forward = device_us_by_site.get((shape, has_res))
            if dtype == torch.bfloat16 and in_forward:
                r["batch_norm_relu"]["device_us_in_forward"] = (
                    statistics.median(in_forward))
            r["f_batch_norm_ms"] = cuda_ms(  # timed here, before x is rebound
                torch, lambda: F.batch_norm(x, m, v, w, b, training=False,
                                            eps=EPS),
                sleep_cycles=EPILOGUE_SLEEP_CYCLES)
            results.append(r)
    del flush
    host = epilogue_host_us(torch, dev)
    race = [epilogue_race_check(torch, dev, site) for site in ("stem",
                                                               "layer4")]
    emit({"phase": "epilogue", "cases": len(results), "max_abs_err": max_err,
          "configs": sorted(sites_by_config),
          "check": "both operators bit-equal to their plain versions "
                   "(signed zeros aside)",
          "host_us_per_call": {k: v for k, v in host.items()
                               if not k.endswith("_all")},
          "race_check": race,
          "flagship_serve_img_per_s_b8_registered_ops": serve_img_per_s})
    return results, max_err, host, race


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
    on exit; through the flags the port sets (device.py::use_ieee_float32),
    for the phase that holds the port's setting against an explicit one."""

    def __init__(self, torch, enabled):
        self.torch, self.enabled = torch, enabled

    def __enter__(self):
        t = self.torch
        self.saved = (t.backends.cudnn.allow_tf32,
                      t.get_float32_matmul_precision())
        t.backends.cudnn.allow_tf32 = self.enabled
        t.set_float32_matmul_precision("high" if self.enabled else "highest")

    def __exit__(self, *exc):
        t = self.torch
        t.backends.cudnn.allow_tf32 = self.saved[0]
        t.set_float32_matmul_precision(self.saved[1])


def float32_precision(torch) -> dict:
    """The process's float32 settings as torch reads them back."""
    b = torch.backends
    return {"cudnn_allow_tf32": b.cudnn.allow_tf32,
            "matmul_precision": torch.get_float32_matmul_precision(),
            "cudnn_conv_fp32_precision": b.cudnn.conv.fp32_precision,
            "cuda_matmul_fp32_precision": b.cuda.matmul.fp32_precision,
            "cudnn_deterministic": b.cudnn.deterministic}


def check_ieee(precision: dict, what: str) -> None:
    """The port's setting: TF32 off for convolutions and matmuls."""
    if (precision["cudnn_allow_tf32"]
            or precision["matmul_precision"] != "highest"
            or precision["cudnn_conv_fp32_precision"] == "tf32"
            or precision["cuda_matmul_fp32_precision"] != "ieee"):
        raise AssertionError(f"{what}: float32 precision {precision}")


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


# ------------------------------------------------------- precision

PRECISION_REPS = 8  # ABBA rounds of each cost measurement
ARTIFACT32_BATCH = 2
ARTIFACT32_REL_RMSE_TOL = 1e-6  # float32 artifact vs predict


def phase_precision(torch, np, dev, batch, sd, pred_bf16):
    """The port's float32 setting (device.py): with TF32 switched on first,
    a default float32 flagship Predictor built with no context sets IEEE
    float32 and cuDNN's deterministic algorithms, its B=8 predict is
    bit-equal to the same forward under an explicit TF32-off context and
    to a second call, and a float32 B=2 artifact matches predict. The costs,
    in turns (ABBA): TF32 on against the port's setting, served float32
    img/s at B=8 and float32 B=8 train-step img/s (phase train's cuDNN
    algorithms); cuDNN's deterministic algorithms on against off, served
    bfloat16 img/s at B=8 (phase serve's Predictor)."""
    import tempfile

    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.inference import Predictor, load_serving

    take = lambda lo, hi: {k: v[lo:hi] for k, v in batch.items()}
    b8 = take(0, B_SERVE)
    out = {"phase": "precision"}
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.deterministic = False
    out["before"] = float32_precision(torch)
    cfg = ServeConfig(arch="resnet18_multistage", decoder="upproj",
                      height=H, width=W, num_sweeps=5)
    if cfg.dtype != "float32":
        raise AssertionError("the serving default dtype is float32")
    pred = Predictor(cfg, sd, device=dev)
    out["after_predictor"] = float32_precision(torch)
    check_ieee(out["after_predictor"], "precision: a float32 Predictor")
    if not out["after_predictor"]["cudnn_deterministic"]:
        raise AssertionError("the Predictor leaves cuDNN's deterministic "
                             "algorithms off")

    pred.predict(b8)  # warm-up: cuDNN set-up
    reset_launches()
    first = pred.predict(b8)
    launches = read_launches()
    want = {KERNELS["A"]: 0, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD,
            KERNELS["C"]: 1}
    if launches != want:
        raise AssertionError(f"precision launches {launches}, "
                             f"expected {want}")
    second = pred.predict(b8)
    with tf32(torch, False):
        explicit = pred.predict(b8)
    with tf32(torch, True):
        tf32_on = pred.predict(b8)
    out.update({
        "launches": launches,
        "bit_equal_explicit_tf32_off": bool(np.array_equal(first, explicit)),
        "repeat_bit_equal": bool(np.array_equal(first, second)),
        "repeat_max_abs": float(np.abs(first - second).max()),
        "tf32_on_vs_ieee_rel_rmse": rel_rmse(np, tf32_on, first),
        "tf32_on_vs_ieee_max_abs": float(np.abs(tf32_on - first).max())})

    tmp = tempfile.mkdtemp(prefix="rdt-precision-")
    try:
        path = os.path.join(tmp, "float32.pt2")
        t0 = time.perf_counter()
        pred.export_serving(path, ARTIFACT32_BATCH)
        export_s = time.perf_counter() - t0
        serve = load_serving(path)
        b2 = take(0, ARTIFACT32_BATCH)
        got, want_b2 = serve(b2), pred.predict(b2)
        del serve
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    out["artifact_float32_b2"] = {
        "export_s": export_s, "bit_equal": bool(np.array_equal(got, want_b2)),
        "rel_rmse": rel_rmse(np, got, want_b2),
        "max_abs": float(np.abs(got - want_b2).max())}
    out["after_load_serving"] = float32_precision(torch)
    check_ieee(out["after_load_serving"], "precision: after load_serving")

    def served(p, ctx):
        def fn():
            with ctx:
                p.predict(b8)
        return fn

    def turns(fns):
        for fn in fns.values():  # each arm's cuDNN set-up, untimed
            fn()
        return abba(fns, PRECISION_REPS)

    times = turns({"tf32_on": served(pred, tf32(torch, True)),
                   "ieee": served(pred, tf32(torch, False))})
    out["serve_float32_b8"] = {k: {"img_per_s": B_SERVE
                                   / statistics.median(v),
                                   "ms_all": [t * 1e3 for t in v]}
                               for k, v in times.items()}
    del pred
    times = turns({"deterministic": served(pred_bf16,
                                           deterministic_cudnn(torch, True)),
                   "default": served(pred_bf16,
                                     deterministic_cudnn(torch, False))})
    out["serve_bfloat16_b8_cudnn"] = {
        k: {"img_per_s": B_SERVE / statistics.median(v),
            "ms_all": [t * 1e3 for t in v]} for k, v in times.items()}

    model, spec, state, step = train_setup(torch, train_config("float32"),
                                           dev)
    gen = torch.Generator(device=dev)

    def train_step(ctx):
        def fn():
            gen.manual_seed(0)
            with ctx, deterministic_cudnn(torch, False):
                float(step(state, b8, generator=gen)["loss"])
        return fn

    times = turns({"tf32_on": train_step(tf32(torch, True)),
                   "ieee": train_step(tf32(torch, False))})
    out["train_float32_b8"] = {k: {"img_per_s": B_TRAIN
                                   / statistics.median(v),
                                   "ms_all": [t * 1e3 for t in v]}
                               for k, v in times.items()}
    del model, state, step
    torch.cuda.empty_cache()
    out["end"] = float32_precision(torch)
    check_ieee(out["end"], "precision: at the end of the phase")
    emit(out)
    if not out["bit_equal_explicit_tf32_off"]:
        raise AssertionError("the default float32 Predictor differs from "
                             "the same forward with TF32 explicitly off")
    if not out["repeat_bit_equal"]:
        raise AssertionError("two float32 predict calls differ by "
                             f"{out['repeat_max_abs']}")
    if out["artifact_float32_b2"]["rel_rmse"] > ARTIFACT32_REL_RMSE_TOL:
        raise AssertionError(f"float32 artifact vs predict "
                             f"{out['artifact_float32_b2']}")
    return out


# ------------------------------------------------------- HTTP daemon

HTTP_TIMEOUT = 120  # seconds, for every request and every join
HTTP_CLIENTS, HTTP_REQUESTS = 8, 64  # scripts/bench_serve_concurrency.py
HTTP_WINDOW_MS = 5.0
SERVE_TILE = 8  # the daemon's max_tile


def npz_body(np, batch) -> bytes:
    import io

    buf = io.BytesIO()
    np.savez(buf, **batch)
    return buf.getvalue()


def npz_depth(np, body):
    import io

    return np.load(io.BytesIO(body))["depth"]


def http(url, body=None):
    """(status, body) of a GET of ``url``, or of a POST of ``body``; an HTTP
    error's too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def tiles_of(n, max_tile=SERVE_TILE):
    """The device batches Predictor.predict cuts a request of n into."""
    tile = 1
    while tile < n and tile < max_tile:
        tile *= 2
    return math.ceil(n / tile)


class DeviceThreadChecked:
    """A Predictor whose predict raises unless it runs on the daemon's one
    device thread (no other thread launches work on the card), and which
    keeps the host-clock seconds of each predict call."""

    def __init__(self, pred):
        self.pred, self.cfg = pred, pred.cfg
        self.seconds, self.threads = [], set()

    def predict(self, batch, max_tile):
        import threading

        thread = threading.current_thread()
        self.threads.add(thread.ident)
        if not thread.name.startswith("rdt-device") or len(self.threads) > 1:
            raise AssertionError(f"predict on thread {thread.name}, threads "
                                 f"{self.threads}: not the one device thread")
        t0 = time.perf_counter()
        out = self.pred.predict(batch, max_tile=max_tile)
        self.seconds.append(time.perf_counter() - t0)
        return out


class http_server:
    """Context: a DepthServer over ``pred`` (checked to run on the device
    thread) on an ephemeral 127.0.0.1 port, serve_forever on a thread;
    yields (server, checked predictor, url); closed, shut down and joined on
    exit."""

    def __init__(self, pred, window_ms=0.0):
        self.pred, self.window_ms = pred, window_ms

    def __enter__(self):
        import threading

        from radar_depth_tpu_torch.serve import DepthServer

        checked = DeviceThreadChecked(self.pred)
        self.srv = DepthServer(checked, max_tile=SERVE_TILE,
                               batch_window_ms=self.window_ms)
        self.httpd = self.srv.serve("127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        return (self.srv, checked,
                f"http://127.0.0.1:{self.httpd.server_address[1]}")

    def __exit__(self, *exc):
        self.srv.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=HTTP_TIMEOUT)
        if self.thread.is_alive():
            raise AssertionError("serve_forever did not stop")


def run_clients(np, url, bodies, per_client, label):
    """HTTP_CLIENTS clients, client i sending ``bodies[i]`` (one sample)
    ``per_client`` times in turn: requests/s, p50/p99 ms; every answer a
    finite (1, H, W) map."""
    import threading

    lat, bad, lock = [], [], threading.Lock()

    def client(ci):
        for _ in range(per_client):
            t0 = time.perf_counter()
            status, body = http(f"{url}/predict", bodies[ci])
            dt = time.perf_counter() - t0
            ok = status == 200
            if ok:
                d = npz_depth(np, body)
                ok = d.shape == (1, H, W) and bool(np.isfinite(d).all())
            with lock:
                lat.append(dt)
                if not ok:
                    bad.append(status)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(HTTP_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{label}: a client hung")
    if bad or len(lat) != HTTP_CLIENTS * per_client:
        raise AssertionError(f"{label}: {len(lat)} requests, failures {bad}")
    lat_ms = np.asarray(lat) * 1e3
    return {"clients": HTTP_CLIENTS, "requests": len(lat), "wall_s": wall,
            "req_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99))}


def concurrency(np, pred, bodies, window_ms):
    """HTTP_CLIENTS clients, each sending its own one-sample request in
    turn, HTTP_REQUESTS requests in all (scripts/bench_serve_concurrency.py
    for the JAX daemon): requests/s, p50/p99 ms, device dispatches."""
    with http_server(pred, window_ms) as (srv, checked, url):
        srv.warmup()
        warm_calls = len(checked.seconds)
        stats = run_clients(np, url, bodies, HTTP_REQUESTS // HTTP_CLIENTS,
                            f"window {window_ms} ms")
        return {"window_ms": window_ms, **stats,
                "device_dispatches": srv.dispatch_count,
                "predict_s_total": sum(checked.seconds[warm_calls:])}


def phase_serve_http(torch, np, pred, batch):
    """The flagship's Predictor behind the HTTP daemon, in-process."""
    take = lambda n: {k: v[:n] for k, v in batch.items()}
    out = {"phase": "serve_http", "arch": pred.cfg.arch,
           "dtype": pred.cfg.dtype, "hw": [H, W], "max_tile": SERVE_TILE}
    requests = {}
    with http_server(pred) as (srv, checked, url):
        out["healthz_before_warmup"] = http(f"{url}/healthz")[0]
        t0 = time.perf_counter()
        srv.warmup()
        out["warmup_s"] = time.perf_counter() - t0
        out["healthz_after_warmup"] = http(f"{url}/healthz")[0]
        if (out["healthz_before_warmup"], out["healthz_after_warmup"]) != (
                503, 200):
            raise AssertionError(f"healthz {out}")

        # the main path, counted per request
        for n in (3, 11):
            body = npz_body(np, take(n))
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            status, resp = http(f"{url}/predict", body)
            call_ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
            predict_ms = checked.seconds[-1] * 1e3
            if status != 200:
                raise AssertionError(f"POST B={n}: {status} {resp[:300]!r}")
            depth = npz_depth(np, resp)
            want = pred.predict(take(n), max_tile=SERVE_TILE)
            tiles = tiles_of(n)
            want_launches = {KERNELS["A"]: 0,
                             KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD * tiles,
                             KERNELS["C"]: tiles}
            if launches != want_launches:
                raise AssertionError(f"POST B={n}: launches {launches}, "
                                     f"expected {want_launches}")
            if depth.shape != (n, H, W) or depth.dtype != np.float32:
                raise AssertionError(f"POST B={n}: {depth.dtype} "
                                     f"{depth.shape}")
            r = {"tiles": tiles, "launches": launches, "call_ms": call_ms,
                 "predict_ms": predict_ms,
                 "request_bytes": len(body), "response_bytes": len(resp),
                 "bit_equal_to_predict": bool(np.array_equal(depth, want))}
            if not r["bit_equal_to_predict"]:
                r["rel_rmse_vs_predict"] = rel_rmse(np, depth, want)
                if r["rel_rmse_vs_predict"] > PARITY_REL_RMSE_TOL:
                    raise AssertionError(f"POST B={n} vs predict: {r}")
            requests[f"b{n}"] = r

        status, resp = http(f"{url}/predict", b"not an npz")
        error = json.loads(resp).get("error", "") if status == 400 else ""
        out["bad_request"] = {"status": status, "error": error[:160]}
        out["healthz_after_bad_request"] = http(f"{url}/healthz")[0]
        if status != 400 or not error or out[
                "healthz_after_bad_request"] != 200:
            raise AssertionError(f"malformed request: {status} {resp[:300]!r}")
        out["predict_calls_on_device_thread"] = len(checked.seconds)
    out["requests"] = requests
    bodies = [npz_body(np, {k: v[i:i + 1] for k, v in batch.items()})
              for i in range(HTTP_CLIENTS)]
    out["concurrency"] = {
        "single_flight": concurrency(np, pred, bodies, 0.0),
        "coalesced": concurrency(np, pred, bodies, HTTP_WINDOW_MS)}
    out["closed"] = True
    emit(out)
    return out


# ------------------------------------------------------------- bench

BENCH_SIZE = ["--height", str(H), "--width", str(W), "--sweeps", "5"]
BENCH_TIMED = ["--iters", "10", "--repeat", "3"]  # after --warmup's 5
BENCH_WARMUP = 5  # the entry points' default --warmup
BENCH_FORWARDS = BENCH_WARMUP + 10 * 3  # of one infer run
LATENCY_BATCHES, LATENCY_REQUESTS, LATENCY_WARMUP = (1, 8, 32), 30, 3
LATEFUSION_SITES = 42  # kernel B per resnet18_latefusion forward
DAEMON_TILES = (1, 2, 4, 8)  # the daemon's tile ladder at max_tile 8
LADDER_TILES = len(DAEMON_TILES)  # forwards of the daemon's warmup
DAEMON_FULL_REQUESTS = 512  # per mode at 450x800: a p99 of 512 latencies


def run_entry(main, argv):
    """``main(argv)`` of an entry point in this process, as its command
    line runs it -> (the JSON lines it printed, host seconds)."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{argv}: exit code {rc}")
    return [json.loads(x) for x in out.getvalue().splitlines()], seconds


def bench_run(torch, dev, name, main, argv, calls, per_call):
    """One counted run of an entry point: every kernel's launches over the
    run, which makes ``calls`` forwards or steps (a number, or a function
    of the printed lines), must be ``per_call`` (A, B, C) times as many.
    Prints and returns its lines, seconds, launches and peak memory."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    lines, seconds = run_entry(main, argv)
    launches = read_launches()
    n = calls(lines) if callable(calls) else calls
    want = {KERNELS[k]: per * n for k, per in per_call.items()}
    if launches != want:
        raise AssertionError(f"{name} {argv}: launches {launches} over {n} "
                             f"calls, expected {want}")
    out = {"phase": "bench", "run": name, "argv": argv, "lines": lines,
           "seconds": seconds, "calls": n, "launches": launches,
           "launches_per_call": {KERNELS[k]: launches[KERNELS[k]] / n
                                 for k in per_call},
           "mem_before_gib": base / 2**30,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    emit(out)
    return out


def held_to_plain(torch, got, want, what):
    """A kernel path's output against its plain version's: finite and
    bit-equal, or raise. -> its record."""
    err = float((got.float() - want.float()).abs().max())
    out = {"shape": list(got.shape), "max_abs_err": err,
           "bit_equal": bool(torch.equal(got, want)),
           "finite": bool(torch.isfinite(got).all())}
    if not (out["bit_equal"] and out["finite"]):
        raise AssertionError(f"{what}: {out}")
    return out


def bench_bit_equal(torch, dev, dtype, n):
    """One iteration of the bench's infer function against
    ``Predictor(cfg, sd).infer`` and against its ``plain=True`` twin (the
    kernels' plain versions) on the same batch and weights."""
    from radar_depth_tpu_torch import bench
    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.ops.preprocess import PreprocessConfig

    args = bench.build_parser().parse_args(
        BENCH_SIZE + ["--batch", str(n), "--dtype", dtype])
    spec = bench.sample_spec(args)
    model, arch_spec = bench.build_model(args, dev)
    batch = bench.resident(bench.synthetic_batch(spec, n), dev)
    got = bench.make_infer_fn(model, arch_spec, PreprocessConfig(spec=spec),
                              dev)(batch)
    if got.shape != (n, H, W):
        raise AssertionError(f"bench infer: shape {tuple(got.shape)}")
    cfg = ServeConfig(arch=args.arch, dtype=dtype, height=H, width=W,
                      num_sweeps=5)
    sd = model.state_dict()
    del model
    out = {"dtype": dtype, "batch": n}
    for name, plain in (("predictor_infer", False), ("plain", True)):
        want = Predictor(cfg, sd, device=dev, plain=plain).infer(batch)
        out[name] = held_to_plain(torch, got, want,
                                  f"bench infer vs {name}, {dtype} B={n}")
        del want
    return out


def seeded_vs_plain(torch, dev, cfg, tiles, seed=0):
    """The seeded Predictor of ``cfg`` that a tool serves against its
    ``plain=True`` twin, ``Predictor.infer`` at each tile size."""
    from radar_depth_tpu_torch import bench

    kern = bench.seeded_predictor(cfg, dev)
    plain = bench.seeded_predictor(cfg, dev, plain=True)
    host = bench.synthetic_batch(cfg.sample_spec(), max(tiles), seed)
    out = {"arch": cfg.arch, "dtype": cfg.dtype,
           "hw": [cfg.height, cfg.width], "sweeps": cfg.num_sweeps}
    for n in tiles:
        batch = bench.resident({k: v[:n] for k, v in host.items()}, dev)
        out[f"B{n}"] = held_to_plain(
            torch, kern.infer(batch), plain.infer(batch),
            f"{cfg.arch} {cfg.dtype} {cfg.height}x{cfg.width} B={n}")
    kern.close()
    plain.close()
    return out


def train_batch_vs_plain(torch, dev, n):
    """Kernel C against the plain z-buffer on the bench's train batch
    (native loader, worker-augmented, B=``n``), through the step's own
    preprocessing (``prepare_eval_batch`` of a host-augmented batch)."""
    from radar_depth_tpu_torch import bench
    from radar_depth_tpu_torch.data.packed import native_available
    from radar_depth_tpu_torch.ops.preprocess import prepare_eval_batch
    from radar_depth_tpu_torch.train.step import make_preprocess_config

    if not native_available():
        raise AssertionError("the native loader is not built")
    args = bench.build_parser().parse_args(
        BENCH_SIZE + ["--mode", "train", "--batch", str(n)])
    cfg = bench.train_config(args)
    host = bench.train_batch(args, cfg, True)[0]
    batch = bench.resident(host, dev)
    pre = make_preprocess_config(cfg)
    got, want = (prepare_eval_batch(batch, pre, dev, plain=p)["radar"]
                 for p in (False, True))
    out = held_to_plain(torch, got.view(torch.int32), want.view(torch.int32),
                        f"kernel C on the train batch B={n}")
    out["max_abs_err"] = float((got - want).abs().max())
    out["points"] = list(host["radar_points"].shape)
    return out


def sample_seconds(np, n=8):
    """Host seconds to make ``n`` synthetic samples in the bench's thread
    pool (``bench.synthetic_samples``) and one after another, at the
    tests' size and at full size."""
    from radar_depth_tpu_torch import bench
    from radar_depth_tpu_torch.data.schema import SampleSpec
    from radar_depth_tpu_torch.data.synthetic import SyntheticNuScenes

    out = {}
    for h, w, sweeps in ((64, 96, 2), (H, W, 5)):
        spec = SampleSpec(height=h, width=w, num_sweeps=sweeps,
                          max_depth=80.0)
        t0 = time.perf_counter()
        pooled = bench.synthetic_samples(spec, n)
        t1 = time.perf_counter()
        ds = SyntheticNuScenes(n, spec=spec, seed=0)
        serial = [ds[i] for i in range(n)]
        t2 = time.perf_counter()
        if not all(np.array_equal(a[k], b[k]) for a, b in zip(pooled, serial)
                   for k in b):
            raise AssertionError(f"pooled samples differ at {h}x{w}")
        out[f"{h}x{w}"] = {"n": n, "pool_s": t1 - t0, "serial_s": t2 - t1}
    return out


def launches_bench(bench_out, kernel):
    """A kernel's launches per forward or step (per micro-batch) in each
    run of phase bench."""
    return {name: r["launches_per_call"][KERNELS[kernel]]
            for name, r in bench_out["runs"].items()}


def phase_bench(torch, np, dev, smi):
    """The port's benchmark entry points (python -m radar_depth_tpu_torch.
    bench, .bench_latency, .bench_serve_concurrency) run in this process
    through their main(), each counted, then the bench's infer iteration
    against Predictor.infer in both dtypes."""
    from radar_depth_tpu_torch import (bench, bench_latency,
                                       bench_serve_concurrency)

    serve = {"A": 0, "B": EPILOGUE_SITES_PER_FORWARD, "C": 1}
    step = {"A": 0, "B": 0, "C": 1}  # per micro-batch
    daemon = {"A": 0, "B": LATEFUSION_SITES, "C": 1}
    daemon_forwards = lambda lines: sum(LADDER_TILES + x["device_dispatches"]
                                        for x in lines)
    infer = BENCH_SIZE + BENCH_TIMED
    train = BENCH_SIZE + ["--mode", "train", "--iters", "5"]
    runs = {}
    for name, main, argv, calls, per_call in [
        ("infer_bf16_b128", bench.main, infer + ["--batch", "128"],
         BENCH_FORWARDS, serve),
        ("infer_float32_b8", bench.main,
         infer + ["--batch", "8", "--dtype", "float32"], BENCH_FORWARDS,
         serve),
        # the resident loops, one warm step, then the streamed steps
        ("stream_bf16_b128", bench.main,
         infer + ["--batch", "128", "--mode", "stream", "--stream-iters",
                  "8"], BENCH_FORWARDS + 1 + 8, serve),
        ("train_bf16_b32", bench.main, train + ["--batch", "32"],
         BENCH_WARMUP + 5, step),
        ("train_bf16_b16_accum2", bench.main,
         train + ["--batch", "16", "--grad-accum", "2"],
         2 * (BENCH_WARMUP + 5), step),
        # per batch size: the resident path's warmup and requests, then
        # predict's (one tile each)
        ("bench_latency", bench_latency.main,
         ["--batches", ",".join(map(str, LATENCY_BATCHES)), "--requests",
          str(LATENCY_REQUESTS)],
         len(LATENCY_BATCHES) * 2 * (LATENCY_WARMUP + LATENCY_REQUESTS),
         serve),
        # per mode: the warmup's tile ladder, then one forward per
        # dispatch; at the tool's defaults (96x160, 3 sweeps: a smoke
        # size), then at full size with requests enough for a p99
        ("bench_serve_concurrency", bench_serve_concurrency.main, [],
         daemon_forwards, daemon),
        ("bench_serve_concurrency_full", bench_serve_concurrency.main,
         BENCH_SIZE + ["--requests", str(DAEMON_FULL_REQUESTS)],
         daemon_forwards, daemon),
    ]:
        runs[name] = bench_run(torch, dev, name, main, argv, calls, per_call)

    kind = torch.cuda.get_device_name(dev)
    for name, r in runs.items():
        if name.startswith(("infer", "stream", "train")):
            line, = r["lines"]
            if not line["value"] > 0:
                raise AssertionError(f"{name}: {line}")
            if name.startswith("infer") and (
                    line.get("device") != kind or "mfu" not in line):
                raise AssertionError(f"{name}: no card keys in {line}")
    lat = runs["bench_latency"]["lines"]
    if [x["batch"] for x in lat] != list(LATENCY_BATCHES):
        raise AssertionError(f"bench_latency: {lat}")
    for name, requests in (("bench_serve_concurrency", HTTP_REQUESTS),
                           ("bench_serve_concurrency_full",
                            DAEMON_FULL_REQUESTS)):
        single, coalesced = runs[name]["lines"]
        if ([single["mode"], coalesced["mode"]]
                != ["single-flight", "coalesced"]
                or {single["requests"], coalesced["requests"]} != {requests}
                or coalesced["device_dispatches"]
                > single["device_dispatches"]):
            raise AssertionError(f"{name}: {single} {coalesced}")

    # the kernels against their plain versions at this phase's shapes
    from radar_depth_tpu_torch.config import ServeConfig

    latency = ServeConfig(arch="resnet18_multistage", dtype="bfloat16",
                          height=H, width=W, num_sweeps=5)
    daemon_cfg = lambda h, w, sweeps: ServeConfig(
        arch="resnet18_latefusion", dtype="float32", height=h, width=w,
        num_sweeps=sweeps)
    t0 = time.perf_counter()
    plain = {
        "bench_infer": [bench_bit_equal(torch, dev, "bfloat16", 128),
                        bench_bit_equal(torch, dev, "float32", 8)],
        "bench_latency": seeded_vs_plain(torch, dev, latency,
                                         LATENCY_BATCHES),
        "daemon": seeded_vs_plain(torch, dev, daemon_cfg(96, 160, 3),
                                  DAEMON_TILES, seed=3),
        "daemon_full": seeded_vs_plain(torch, dev, daemon_cfg(H, W, 5),
                                       DAEMON_TILES, seed=3),
        "train_kernel_c": train_batch_vs_plain(torch, dev, 32)}
    plain_s = time.perf_counter() - t0
    out = {"phase": "bench", "device": kind, "nvidia_smi": smi,
           "mfu": {k: r["lines"][0]["mfu"] for k, r in runs.items()
                   if k.startswith("infer")},
           "peak_mem_gib": {k: r["peak_mem_gib"] for k, r in runs.items()},
           "launches_per_call": {k: r["launches_per_call"]
                                 for k, r in runs.items()},
           "held_to_plain": plain, "held_to_plain_s": plain_s,
           "synthetic_samples_s": sample_seconds(np)}
    emit(out)
    return {**out, "runs": runs}


# ------------------------------------------------------------- export

EXPORT_BATCH = 8

# Run in a fresh interpreter: load an artifact with nothing but the port
# imported, run it on a batch, and compare with a saved prediction.
FRESH_LOAD = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from radar_depth_tpu_torch.inference import load_serving
from radar_depth_tpu_torch.ops import kernels
names = ("zbuffer_min_depth", "scale_bias_relu", "zbuffer_min_depth_sorted")
serve = load_serving(sys.argv[2])
batch = dict(np.load(sys.argv[3]))
want = np.load(sys.argv[4])
serve(batch)
for n in names:
    getattr(kernels, n).launches = 0
got = serve(batch)
launches = {n: getattr(kernels, n).launches for n in names}
foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "radar_depth_tpu"))
print(json.dumps({
    "launches": launches, "shape": list(got.shape),
    "bit_equal": bool(np.array_equal(got, want)),
    "rel_rmse": float(np.sqrt(np.mean((got - want) ** 2))
                      / np.sqrt(np.mean(want ** 2))),
    "foreign_modules": foreign}))
"""


def abba(fns, reps=6):
    """Host-clock seconds of each function (each ends in a fetch to the
    host), taken in turns, the order reversed every round."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            fns[name]()
            times[name].append(time.perf_counter() - t0)
    return times


def phase_export(torch, np, dev, batch, sd, pred):
    """The flagship's serving artifact at B=8, both z-buffer backends."""
    import shutil
    import tempfile

    from radar_depth_tpu_torch.inference import Predictor, load_serving

    b8 = {k: v[:EXPORT_BATCH] for k, v in batch.items()}
    preds = {"sorted": pred,
             "scatter": Predictor(dataclasses.replace(
                 pred.cfg, raster_backend="scatter"), sd, device=dev)}
    zbuffer = {"sorted": KERNELS["C"], "scatter": KERNELS["A"]}
    out = {"phase": "export", "arch": pred.cfg.arch, "dtype": pred.cfg.dtype,
           "hw": [H, W], "batch": EXPORT_BATCH}
    tmp = tempfile.mkdtemp(prefix="rdt-export-")
    try:
        served = {}
        for backend, p in preds.items():
            path = os.path.join(tmp, f"{backend}.pt2")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = p.export_serving(path, EXPORT_BATCH)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            serve = load_serving(path)
            load_s = time.perf_counter() - t0
            # the rdt.* nodes, and the copies of a layout (clone) that the
            # trace added where its fake tensors' layout differed
            nodes = {}
            for n in torch.export.load(path).graph.nodes:
                name = str(n.target)
                if n.op == "call_function" and (name.startswith("rdt.")
                                                or "clone" in name):
                    nodes[name] = nodes.get(name, 0) + 1
            if (nodes.get("rdt.batch_norm_relu.default")
                    != EPILOGUE_SITES_PER_FORWARD
                    or "rdt.scale_bias_relu.default" in nodes):
                raise AssertionError(f"export {backend}: rdt nodes {nodes}")
            serve(b8)  # first call: cuDNN set-up for the artifact's convs
            torch.cuda.synchronize()
            # the main path, counted: one call of the loaded artifact
            reset_launches()
            got = serve(b8)
            launches = read_launches()
            want_launches = {KERNELS["A"]: 0, KERNELS["C"]: 0,
                             KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD}
            want_launches[zbuffer[backend]] = 1
            if launches != want_launches:
                raise AssertionError(f"export {backend}: launches {launches}, "
                                     f"expected {want_launches}")
            want = p.predict(b8)
            r = {"bytes": nbytes, "export_s": export_s, "load_s": load_s,
                 "nodes": nodes, "launches": launches,
                 "bit_equal_to_predict": bool(np.array_equal(got, want))}
            if not r["bit_equal_to_predict"]:
                r["rel_rmse_vs_predict"] = rel_rmse(np, got, want)
                if r["rel_rmse_vs_predict"] > PARITY_REL_RMSE_TOL:
                    raise AssertionError(f"export {backend} vs predict: {r}")
            out[backend] = r
            served[backend] = (serve, path, want)

        # the sorted artifact in a fresh process that imports only the port
        serve, path, want = served["sorted"]
        np.savez(os.path.join(tmp, "batch.npz"), **b8)
        np.save(os.path.join(tmp, "want.npy"), want)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", FRESH_LOAD,
             os.path.dirname(os.path.abspath(__file__)), path,
             os.path.join(tmp, "batch.npz"), os.path.join(tmp, "want.npy")],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"fresh load failed:\n{proc.stderr[-3000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        fresh["process_s"] = time.perf_counter() - t0
        if (fresh["launches"] != out["sorted"]["launches"]
                or fresh["foreign_modules"]
                or fresh["shape"] != [EXPORT_BATCH, H, W]
                or not (fresh["bit_equal"]
                        or fresh["rel_rmse"] <= PARITY_REL_RMSE_TOL)):
            raise AssertionError(f"fresh load: {fresh}")
        out["fresh_process"] = fresh

        # img/s of the loaded artifact beside Predictor.predict
        times = abba({"artifact": lambda: serve(b8),
                      "predict": lambda: pred.predict(b8)})
        out["speed"] = {
            name: {"img_per_s": EXPORT_BATCH / statistics.median(t),
                   "ms_per_call_all": [x * 1e3 for x in t]}
            for name, t in times.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del preds
    torch.cuda.empty_cache()
    emit(out)
    return out



# ------------------------------------------------------------ ops API

OPS_MAX_DEPTH = 80.0  # SampleSpec's, as the drive recipe passes it


def phase_ops_api(torch, np, dev, batch, pred):
    """The public ops on the card: ``ops.radar_to_depth_map`` at B=8, 5
    sweeps, 450x800 with both z-buffer backends, each bit-equal to its
    ``plain=True`` path, counted and timed beside it; then
    ``utils.profiling.device_trace`` (on the card by default) around one
    served B=8 forward of ``pred``, whose trace must name the operators of
    kernels B and C."""
    import glob
    import shutil
    import tempfile

    from radar_depth_tpu_torch.ops import radar_to_depth_map
    from radar_depth_tpu_torch.utils.profiling import annotate, device_trace

    b8 = {k: torch.from_numpy(v[:B_SERVE]).to(dev) for k, v in batch.items()
          if k.startswith("radar") or k == "intrinsics"}
    args = (b8["radar_points"], b8["radar_valid"], b8["radar_transform"],
            b8["intrinsics"], H, W)
    out = {"phase": "ops_api", "batch": B_SERVE, "hw": [H, W],
           "sweeps": int(b8["radar_points"].shape[1])}
    for backend in ("sorted", "scatter"):
        fn = lambda plain=False: radar_to_depth_map(
            *args, max_depth=OPS_MAX_DEPTH, backend=backend, plain=plain)
        torch.cuda.synchronize()
        reset_launches()
        got = fn()
        launches = read_launches()
        want = fn(plain=True)
        kernel = KERNELS["C" if backend == "sorted" else "A"]
        if (launches[kernel] != 1 or sum(launches.values()) != 1
                or not torch.equal(got, want) or got.shape != (B_SERVE, H, W)):
            raise AssertionError(f"radar_to_depth_map {backend}: launches "
                                 f"{launches}, shape {tuple(got.shape)}, "
                                 "or not bit-equal to plain")
        out[backend] = {"launches": launches, "bit_equal_to_plain": True,
                        "set_pixels": int((got > 0).sum()),
                        "ms": cuda_ms(torch, fn),
                        "plain_ms": cuda_ms(torch, lambda: fn(plain=True))}

    take = {k: v[:B_SERVE] for k, v in batch.items()}
    pred.predict(take)
    tmp = tempfile.mkdtemp(prefix="rdt-trace-")
    try:
        with device_trace(tmp):
            with annotate("served_forward_b8"):
                pred.predict(take)
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"device_trace wrote {files}")
        with open(files[0]) as f:
            text = f.read()
        names = {op: text.count(f'"{op}"') for op in (
            "rdt::batch_norm_relu", "rdt::zbuffer_min_depth_sorted",
            "served_forward_b8")}
        out["trace"] = {"bytes": os.path.getsize(files[0]),
                        "events_named": names}
        if not all(names.values()):
            raise AssertionError(f"the trace names {names}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    return out


# ------------------------------------------------------------- training


def train_init(torch, model, seed):
    """Seeded random weights for training: init_random's convs, BN scale 1
    and bias 0 (a freshly initialised BN), and the 3x3 heads made positive
    and scaled up so the first predictions are positive depths of tens of
    meters (the CPU parity tests start from the same kind of weights)."""
    from radar_depth_tpu_torch.models import (
        BatchNorm,
        head_weight_names,
        init_random,
    )

    init_random(model, seed)
    heads = head_weight_names(model)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name, p in model.named_parameters():
            if name in heads:
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
    out = {"batch": B_TRAIN, "steps": TRAIN_STEPS,
           "tf32": torch.backends.cudnn.allow_tf32}
    launches, trained = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = train_config(dtype)
        model, spec, state, step = train_setup(torch, cfg, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        # the bare step as in a fresh process: cuDNN's default algorithms
        # (the Predictors built before set the deterministic ones
        # process-wide; phase harness times the step with those)
        with deterministic_cudnn(torch, False):
            losses, times = run_steps(torch, dev, step, state, b8,
                                      TRAIN_STEPS)
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


def device_profile(torch, fn, ordered=None) -> dict:
    """Device time by kernel category over one call of ``fn`` (torch.profiler,
    CUPTI), against the call's host-clock wall time; the device events
    (kernels and copies) and the device kernels alone (copies and fills
    aside) that the call ran; with ``ordered``, the device us of each
    kernel whose name holds it, in the order they ran (``ordered_us``)."""
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
    cats, kernels_by_name, launches, device_kernels = {}, {}, 0, 0
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
        if _category(e.key) != "memcpy":
            device_kernels += e.count
    busy = sum(cats.values())
    top = sorted(kernels_by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {}
    if ordered:
        out["ordered_us"] = [
            e.time_range.elapsed_us() for e in sorted(
                (e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and ordered in e.name), key=lambda e: e.time_range.start)]
    return {**out, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "device_ms_by_category": cats, "device_events": launches,
            "device_kernels": device_kernels, "top_kernels_ms": top}


def profile_device(torch, fn, name, batch_size):
    """``device_profile`` of ``fn``, emitted as phase ``name``."""
    out = {"phase": name, "batch": batch_size, **device_profile(torch, fn)}
    emit(out)
    return out


def phase_profile(torch, pred, batch, sites):
    """``device_profile`` of one served predict call, emitted; and kernel
    B's device us at each of the forward's ``sites`` (in forward order, as
    ``record_epilogue_sites`` gives them): {(shape, residual): [us, ...]},
    empty if the trace does not hold one kernel B event per site."""
    out = device_profile(torch, lambda: pred.predict(batch), ordered="sbr_")
    kernel_b_us = out.pop("ordered_us")
    by_site = {}
    if len(kernel_b_us) == len(sites):
        for site, us in zip(sites, kernel_b_us):
            by_site.setdefault(site, []).append(us)
    out = {"phase": "profile", "batch": next(iter(batch.values())).shape[0],
           "kernel_B_events": len(kernel_b_us), **out}
    emit(out)
    return out, by_site


def phase_host_fold_abba(torch, np, pred, batch, reps=6):
    """The served flagship B=8 forward with the BN fold inside kernel B (the
    port's rdt::batch_norm_relu) against the same forward with the fold put
    back on the host (kernels.fold_batch_norm's five eager ops per site,
    then rdt::scale_bias_relu: the form before it), patched in here and
    nowhere in the package. Per form: launches per forward, device kernels
    and busy ms of one predict call (``device_profile``), and in turns, the
    order reversed every round (ABBA), medians over ``reps`` rounds: the
    host ms to enqueue the model's forward on inputs already on the card,
    and img/s of whole predict calls. The predictions of the two forms must
    be bit-equal, and the fold inside the kernel must save at least
    HOST_FOLD_MIN_KERNELS device kernels per forward."""
    from radar_depth_tpu_torch.ops import kernels
    from radar_depth_tpu_torch.ops.preprocess import (
        pack_model_inputs,
        prepare_eval_batch,
    )

    def host_fold(x, weight, bias, running_mean, running_var, eps,
                  residual=None):
        return kernels.scale_bias_relu(x, *kernels.fold_batch_norm(
            weight, bias, running_mean, running_var, eps), residual)

    shipped = kernels.batch_norm_relu
    forms = {"kernel_fold": shipped, "host_fold": host_fold}
    b8 = {k: v[:B_SERVE] for k, v in batch.items()}
    with torch.inference_mode():
        inputs = pack_model_inputs(
            prepare_eval_batch(b8, pred._pre, pred.device),
            pred.arch_spec.input_kind, pred.cfg.modality)

    def forward():
        with torch.inference_mode():
            return pred.model(*inputs)

    out, preds = {}, {}
    names = list(forms)
    host_ms = {n: [] for n in names}
    call_s = {n: [] for n in names}
    try:
        for name in names:
            kernels.batch_norm_relu = forms[name]
            reset_launches()
            preds[name] = pred.predict(b8)
            out[name] = {"launches": read_launches(),
                         **device_profile(torch, lambda: pred.predict(b8))}
        for r in range(reps):
            for name in (names if r % 2 == 0 else names[::-1]):
                kernels.batch_norm_relu = forms[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward()
                host_ms[name].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred.predict(b8)
                call_s[name].append(time.perf_counter() - t0)
    finally:
        kernels.batch_norm_relu = shipped
    for name in names:
        out[name].update({
            "host_ms_per_forward": statistics.median(host_ms[name]),
            "host_ms_per_forward_all": host_ms[name],
            "img_per_s_b8": B_SERVE / statistics.median(call_s[name]),
            "ms_per_call_b8_all": [t * 1e3 for t in call_s[name]]})
    saved = (out["host_fold"]["device_kernels"]
             - out["kernel_fold"]["device_kernels"])
    result = {"phase": "host_fold_abba", "batch": B_SERVE,
              "device_kernels_saved_per_forward": saved,
              "predictions_bit_equal": bool(np.array_equal(
                  preds["kernel_fold"], preds["host_fold"])),
              **out}
    emit(result)
    want = {KERNELS["A"]: 0, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD,
            KERNELS["C"]: 1}
    if (saved < HOST_FOLD_MIN_KERNELS or not result["predictions_bit_equal"]
            or any(out[n]["launches"] != want for n in names)):
        raise AssertionError(f"host fold ABBA: {result}")
    return result


def phase_profile_train(torch, dev, trained, batch):
    """One B=8 train step of each dtype (float32 with TF32 off), with
    phase train's cuDNN algorithms."""
    b8 = {k: v[:B_TRAIN] for k, v in batch.items()}
    gen = torch.Generator(device=dev)
    out = {}
    for dtype, (_, _, state, step) in trained.items():
        def one_step():
            gen.manual_seed(0)
            step(state, b8, generator=gen)

        with deterministic_cudnn(torch, False):
            out[dtype] = profile_device(torch, one_step,
                                        f"profile_train_{dtype}", B_TRAIN)
    return out


# ------------------------------------------------------------- the zoo

# The rest of the registry at full width (450x800, bfloat16, B=8, seeded
# random weights). Served: ``sites`` is kernel B's sites per forward counted
# from the module structure (an encoder's stem and 2 per BasicBlock or 3 per
# Bottleneck, 2 per UpProj block, 1 per DeConv or UpConv block); ``steps``
# bf16 train steps follow (0: serving and parity only); ``baseline`` is the
# BASELINE.json configuration.
ZOO_SERVE = [
    dict(name="resnet34_latefusion", arch="resnet34_latefusion", sweeps=5,
         sites=74, steps=5, baseline=3),
    dict(name="resnet18_rgbd", arch="resnet18", modality="rgbd", sweeps=1,
         sites=25, steps=5, baseline=2),
    dict(name="resnet18_rgb", arch="resnet18", modality="rgb", sweeps=1,
         sites=25, steps=0, baseline=1),
    dict(name="resnet50_multistage", arch="resnet50_multistage", sweeps=5,
         sites=212, steps=3, profile=True),
    *(dict(name=f"resnet18_latefusion_{d}", arch="resnet18_latefusion",
           decoder=d, sweeps=5, sites=38, steps=0)
      for d in ("deconv2", "deconv3", "upconv")),
]
# Trained only: the multistage options and the sparsifier modality.
ZOO_TRAIN = [
    dict(name="resnet18_multistage_stage2_coarse", arch="resnet18_multistage",
         stage2_coarse=True, sweeps=5, steps=3),
    dict(name="resnet18_multistage_uncertainty",
         arch="resnet18_multistage_uncertainty", sweeps=5, steps=3),
    dict(name="resnet18_rgbd_uar", arch="resnet18", modality="rgbd",
         sparsifier="uar", sweeps=1, steps=2),
]
REMAT = dict(name="resnet18_multistage_remat", arch="resnet18_multistage",
             sweeps=5, steps=3)


def zoo_config(entry, dtype="bfloat16", **over):
    """The TrainConfig of a zoo entry at full width, B=8."""
    from radar_depth_tpu_torch.config import DataConfig, ModelConfig, TrainConfig

    e = dict(entry, **over)
    return TrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=e["sweeps"],
                        sparsifier=e.get("sparsifier", "none")),
        model=ModelConfig(arch=e["arch"], dtype=dtype,
                          decoder=e.get("decoder", "upproj"),
                          modality=e.get("modality", "rgbd"),
                          stage2_coarse=e.get("stage2_coarse", False),
                          remat=e.get("remat", False)),
        batch_size=B_TRAIN)


def with_sweeps(batch, n, sweeps):
    """The first ``n`` samples with their first ``sweeps`` radar sweeps."""
    return {k: v[:n, :sweeps] if k.startswith("radar_") else v[:n]
            for k, v in batch.items()}


def zoo_serve(torch, np, dev, entry, batch):
    """Predictor.predict of one zoo entry, counted; img/s and peak memory;
    float32 parity of the kernel path against the plain path (TF32 off)."""
    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.models import init_random
    from radar_depth_tpu_torch.train.loop import build_model

    cfg = serve_config(zoo_config(entry))
    sd = init_random(build_model(zoo_config(entry, "float32"), "cpu")[0],
                     0).state_dict()
    b8 = with_sweeps(batch, B_SERVE, entry["sweeps"])
    pred = Predictor(cfg, sd, device=dev)
    pred.predict(b8)  # warm-up: cuDNN set-up for these shapes
    sites = record_epilogue_sites(torch, pred, b8)
    if len(sites) != entry["sites"]:
        raise AssertionError(f"zoo {entry['name']}: {len(sites)} kernel B "
                             f"sites per forward, expected {entry['sites']}")

    # the main path, counted
    calls = 2
    reset_launches()
    outs = [pred.predict(b8) for _ in range(calls)]
    launches = read_launches()
    want = {KERNELS["A"]: 0, KERNELS["B"]: entry["sites"] * calls,
            KERNELS["C"]: calls}
    if launches != want:
        raise AssertionError(f"zoo {entry['name']}: launches {launches}, "
                             f"expected {want}")
    for out in outs:
        if out.shape != (B_SERVE, H, W) or not np.isfinite(out).all():
            raise AssertionError(f"zoo {entry['name']}: prediction shape "
                                 f"{out.shape} or non-finite values")
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        pred.predict(b8)
        times.append(time.perf_counter() - t0)
    r = {"phase": "zoo", "config": entry["name"], "arch": cfg.arch,
         "decoder": cfg.decoder, "modality": cfg.modality,
         "sweeps": cfg.num_sweeps, "baseline": entry.get("baseline"),
         "dtype": cfg.dtype, "hw": [H, W], "batch": B_SERVE,
         "launches": launches, "sites_per_forward": len(sites),
         "repeat_bit_equal": bool(np.array_equal(outs[0], outs[1])),
         "serve_img_per_s": B_SERVE / statistics.median(times),
         "serve_ms_per_call_all": [t * 1e3 for t in times],
         "serve_peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    prof = None
    if entry.get("profile"):
        prof = profile_device(torch, lambda: pred.predict(b8),
                              f"profile_zoo_{entry['name']}", B_SERVE)
        busy = prof["device_busy_ms"]
        r["kernel_B_device_ms"] = prof["device_ms_by_category"].get(
            "kernel_B_epilogue", 0.0)
        r["kernel_B_share_of_device"] = r["kernel_B_device_ms"] / busy
    del pred
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    k32 = Predictor(cfg32, sd, device=dev).predict(b8)
    p32 = Predictor(cfg32, sd, device=dev, plain=True).predict(b8)
    torch.cuda.empty_cache()
    r.update({"fp32_kernels_vs_plain_max_abs": float(np.abs(k32 - p32).max()),
              "fp32_kernels_vs_plain_rel_rmse": rel_rmse(np, k32, p32),
              "bf16_vs_fp32_plain_rel_rmse": rel_rmse(np, outs[0], p32),
              "pred_mean_m": float(p32.mean()),
              "pred_std_m": float(p32.std())})
    if r["fp32_kernels_vs_plain_rel_rmse"] > PARITY_REL_RMSE_TOL:
        raise AssertionError(f"zoo {entry['name']}: float32 parity {r}")
    return r, sites, prof


def zoo_train(torch, dev, entry, batch, sd=None):
    """``entry['steps']`` bf16 train steps at B=8 on one batch (the same
    augmentation or sparsifier draws each step), counted: the loss finite
    and falling, img/s and peak memory. Returns the results, the model's BN
    running statistics after the first step, and its launches."""
    from radar_depth_tpu_torch.train.loop import build_model
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import make_train_step

    cfg = zoo_config(entry)
    model, spec = build_model(cfg, dev)
    if sd is None:
        train_init(torch, model, 0)
    else:
        model.load_state_dict(sd)
    state = create_train_state(model, cfg.optim, steps_per_epoch=32)
    step = make_train_step(model, spec, cfg)
    b8 = with_sweeps(batch, B_TRAIN, entry["sweeps"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses, times = run_steps(torch, dev, step, state, b8, 1)
    first_stats = stats_snapshot(model)
    more, more_t = run_steps(torch, dev, step, state, b8, entry["steps"] - 1)
    launches = read_launches()
    losses, times = losses + more, times + more_t
    per_step = 0 if cfg.data.sparsifier != "none" else 1
    want = {KERNELS["A"]: 0, KERNELS["B"]: 0,
            KERNELS["C"]: per_step * entry["steps"]}
    if launches != want:
        raise AssertionError(f"zoo train {entry['name']}: launches "
                             f"{launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"zoo train {entry['name']}: losses {losses}")
    r = {"train_steps": entry["steps"], "train_launches": launches,
         "train_losses": losses, "train_step_ms": [t * 1e3 for t in times],
         "train_img_per_s": B_TRAIN / statistics.median(times[1:]),
         "train_peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    log_var = getattr(model, "stage_log_var", None)
    if log_var is not None:
        r["stage_log_var"] = log_var.detach().cpu().tolist()
        if not all(math.isfinite(v) and v != 0.0 for v in r["stage_log_var"]):
            raise AssertionError(f"stage_log_var {r['stage_log_var']}")
    del model, state, step
    torch.cuda.empty_cache()
    return r, first_stats


def zoo_remat(torch, dev, batch):
    """The flagship's bf16 step with and without --remat from the same
    weights: BN running statistics after one step bit-equal (the recompute
    leaves them alone), the losses of 3 steps, img/s and peak memory."""
    from radar_depth_tpu_torch.train.loop import build_model

    sd = train_init(torch, build_model(zoo_config(REMAT), "cpu")[0],
                    0).state_dict()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {name: zoo_train(torch, dev, dict(REMAT, remat=remat), batch,
                                sd=sd)
                for name, remat in (("plain", False), ("remat", True))}
    finally:
        torch.backends.cudnn.deterministic = saved
    plain, remat = runs["plain"][1], runs["remat"][1]
    differ = [k for k, v in plain.items() if not torch.equal(remat[k], v)]
    if differ:
        raise AssertionError(f"remat: BN statistics after one step differ "
                             f"from the plain step's in {differ[:4]}")
    out = {"phase": "zoo", "config": REMAT["name"],
           "stats_bit_equal_after_one_step": True, "bn_buffers": len(plain),
           **{f"{name}_{k}": v for name, (r, _) in runs.items()
              for k, v in r.items()}}
    emit(out)
    return out


def zoo_deconv_determinism(torch, dev, batch):
    """Is a bf16 train step of a DeConv decoder deterministic on the card?
    resnet18_latefusion with deconv2 and deconv3: the same weights and batch
    stepped twice, with cuDNN's default algorithms and with its
    deterministic ones; whether the two runs' parameters are bit-equal."""
    from radar_depth_tpu_torch.train.loop import build_model
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import make_train_step

    out = {"phase": "zoo", "config": "deconv_determinism"}
    saved = torch.backends.cudnn.deterministic
    try:
        for decoder in ("deconv2", "deconv3"):
            entry = dict(arch="resnet18_latefusion", decoder=decoder,
                         sweeps=5)
            cfg = zoo_config(entry)
            sd = train_init(torch, build_model(cfg, "cpu")[0], 0).state_dict()
            for det in (False, True):
                torch.backends.cudnn.deterministic = det
                params = []
                for _ in range(2):
                    model, spec = build_model(cfg, dev)
                    model.load_state_dict(sd)
                    state = create_train_state(model, cfg.optim, 32)
                    run_steps(torch, dev, make_train_step(model, spec, cfg),
                              state, with_sweeps(batch, B_TRAIN, 5), 1)
                    params.append(param_snapshot(model))
                    del model, state
                differ = [k for k, v in params[0].items()
                          if not torch.equal(params[1][k], v)]
                key = f"{decoder}_{'deterministic' if det else 'default'}"
                out[f"{key}_bit_equal"] = not differ
                out[f"{key}_tensors_differing"] = differ[:6]
    finally:
        torch.backends.cudnn.deterministic = saved
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_zoo(torch, np, dev, batch):
    """Every entry of ZOO_SERVE (served, counted, float32 parity, then
    trained if it has steps), of ZOO_TRAIN, and the remat pair."""
    results, sites, prof = {}, {}, None
    for entry in ZOO_SERVE:
        r, sites[entry["name"]], p = zoo_serve(torch, np, dev, entry, batch)
        prof = p or prof
        if entry["steps"]:
            r.update(zoo_train(torch, dev, entry, batch)[0])
        emit(r)
        results[entry["name"]] = r
    for entry in ZOO_TRAIN:
        r = {"phase": "zoo", "config": entry["name"], "arch": entry["arch"],
             "sweeps": entry["sweeps"], **zoo_train(torch, dev, entry,
                                                    batch)[0]}
        emit(r)
        results[entry["name"]] = r
    results[REMAT["name"]] = zoo_remat(torch, dev, batch)
    results["deconv_determinism"] = zoo_deconv_determinism(torch, dev, batch)
    return results, sites, prof


# ------------------------------------------------------------- harness


def csv_rows(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def row_rel_diff(a, b):
    """Largest relative difference of the metric columns of two CSV rows."""
    return max(abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-12)
               for k in CSV_METRICS)


class count_by_phase:
    """Context: the kernels' launches inside Trainer.train_epoch and
    Trainer.validate, summed per method, read around each call."""

    def __init__(self):
        self.counts = {"train_epoch": {}, "validate": {}}

    def __enter__(self):
        from radar_depth_tpu_torch.train import loop

        self.saved = {n: getattr(loop.Trainer, n) for n in self.counts}
        for name, orig in self.saved.items():
            setattr(loop.Trainer, name, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        def counted(trainer, *args, **kwargs):
            before = read_launches()
            try:
                return orig(trainer, *args, **kwargs)
            finally:
                after = read_launches()
                acc = self.counts[name]
                for k in after:
                    acc[k] = acc.get(k, 0) + after[k] - before[k]
        return counted

    def __exit__(self, *exc):
        from radar_depth_tpu_torch.train import loop

        for name, orig in self.saved.items():
            setattr(loop.Trainer, name, orig)


def write_harness_data(root):
    """Packed train/val shards of SyntheticNuScenes at full size (train seed
    0, val seed 1, 5 sweeps, day/night sidecars), written by ``python -m
    radar_depth_tpu_torch.generate_dataset`` in a child process. Returns
    the child's seconds and the shards' bytes."""
    t0 = time.perf_counter()
    [(rc, out, err)] = run_procs(
        [[sys.executable, "-m", "radar_depth_tpu_torch.generate_dataset",
          "--out", root, "--num-train", str(HARNESS_TRAIN),
          "--num-val", str(HARNESS_VAL), "--height", str(H),
          "--width", str(W), "--sweeps", "5", "--seed", "0"]],
        lambda i: dict(os.environ), timeout=600)
    seconds = time.perf_counter() - t0
    if rc != 0 or not out.startswith(f"train: {HARNESS_TRAIN} samples"):
        raise RuntimeError(f"generate_dataset exited {rc}: {out[-1000:]}"
                           f"{err[-2000:]}")
    return seconds, shard_bytes(root)


def shard_bytes(root) -> int:
    """Bytes of the ``*.rdtp`` shards below ``root`` (sidecars aside)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files
               if f.endswith(".rdtp"))


def check_run_dir(run_dir, epochs, cfg):
    """The files of a run directory after ``epochs`` epochs."""
    from radar_depth_tpu_torch.config import load_config
    from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
    from radar_depth_tpu_torch.utils.csvlog import FIELDNAMES

    names = set(os.listdir(run_dir))
    want = {".trainer.lock", "config.json", "train.csv", "test.csv",
            "best.txt", "checkpoints"} | {f"comparison_epoch{e}.png"
                                          for e in range(epochs)}
    if not want <= names:
        raise AssertionError(f"run dir lacks {sorted(want - names)}")
    if load_config(os.path.join(run_dir, "config.json")) != cfg:
        raise AssertionError("config.json differs from the run's config")
    for name in ("train.csv", "test.csv"):
        with open(os.path.join(run_dir, name)) as f:
            if f.readline().strip() != ",".join(FIELDNAMES):
                raise AssertionError(f"{name} header")
        rows = csv_rows(os.path.join(run_dir, name))
        if [int(r["epoch"]) for r in rows] != list(range(epochs)):
            raise AssertionError(f"{name} epochs {[r['epoch'] for r in rows]}")
        if not all(math.isfinite(float(r[k])) for r in rows
                   for k in CSV_METRICS):
            raise AssertionError(f"{name} has non-finite metrics")
    test = csv_rows(os.path.join(run_dir, "test.csv"))
    best = min(test, key=lambda r: float(r["rmse"]))
    with open(os.path.join(run_dir, "best.txt")) as f:
        if not f.read().startswith(f"epoch={best['epoch']}, "
                                   f"rmse={float(best['rmse']):.4f}"):
            raise AssertionError("best.txt is not the best test.csv row")
    with open(os.path.join(run_dir, f"comparison_epoch{epochs - 1}.png"),
              "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("comparison panel is not a PNG")
    mgr = ckpt_lib.CheckpointManager(run_dir, sweep_stale=False)
    steps = mgr.all_steps()
    if steps[-1] != epochs - 1 or mgr.best_step() != int(best["epoch"]):
        raise AssertionError(f"checkpoints {steps}, best {mgr.best_step()}")
    payload = ckpt_lib.load_payload(os.path.join(mgr.dir, str(steps[-1])))
    if set(payload) != {"model", "optimizer", "step", "epoch", "rmse"}:
        raise AssertionError(f"checkpoint keys {sorted(payload)}")
    return best, steps


def harness_argv(data, arch="resnet18_multistage", dtype="bfloat16"):
    """train.main's flags of the harness phase, on the packed shards in
    ``data``."""
    return ["--arch", arch, "--decoder", "upproj",
            "--dtype", dtype, "-b", str(B_TRAIN),
            "--dataset", "packed", "--data-root", data,
            "--height", str(H), "--width", str(W), "--num-sweeps", "5",
            "--print-freq", "100"]


def phase_harness(torch, np, dev, bare_step, tmp):
    """The training harness through train.main, at full width, in the
    directory ``tmp`` (its packed shards and the straight 3-epoch run are
    phase data_parallel's reference)."""
    from radar_depth_tpu_torch.config import parse_command
    from radar_depth_tpu_torch.data.packed import PackedDataset
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.train.loop import Trainer
    from radar_depth_tpu_torch.train.main import run
    from radar_depth_tpu_torch.train.step import make_predict_fn

    data = os.path.join(tmp, "data")
    data_s, data_bytes = write_harness_data(data)
    base = harness_argv(data)
    run_dir = os.path.join(tmp, "run")

    # the main path, counted: 2 epochs through train.main
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with count_by_phase() as phases:
        r2 = run(base + ["--epochs", "2", "--output-dir", run_dir])
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    if r2["reader"] != "native" or not r2["host_augment"]:
        raise AssertionError(f"harness reader {r2['reader']}, host "
                             f"augmentation {r2['host_augment']}")
    steps = sum(h["train"]["steps"] for h in r2["history"])
    val_batches = 2 * math.ceil(HARNESS_VAL / B_TRAIN)
    panels = 2  # one panel row per epoch (val_viz_every=50)
    want_train = {KERNELS["A"]: 0, KERNELS["B"]: 0, KERNELS["C"]: steps}
    want_val = {KERNELS["A"]: 0,
                KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD
                * (val_batches + panels),
                KERNELS["C"]: val_batches + panels}
    if (phases.counts["train_epoch"] != want_train
            or phases.counts["validate"] != want_val
            or launches != {k: want_train[k] + want_val[k]
                            for k in launches}):
        raise AssertionError(
            f"harness launches {launches} (train {phases.counts}), "
            f"expected train {want_train}, val {want_val}")
    if steps != 2 * (HARNESS_TRAIN // B_TRAIN):
        raise AssertionError(f"{steps} train steps in 2 epochs")
    best2, steps2 = check_run_dir(run_dir, 2, r2["cfg"])

    # --resume to epoch 3 against a straight 3-epoch run
    r3 = run(["--resume", run_dir, "--epochs", "3", "--output-dir",
              run_dir, "--print-freq", "100"])
    straight = os.path.join(tmp, "straight")
    r3s = run(base + ["--epochs", "3", "--output-dir", straight])
    best, ckpt_steps = check_run_dir(run_dir, 3, r3["cfg"])
    check_run_dir(straight, 3, r3s["cfg"])
    got = csv_rows(os.path.join(run_dir, "test.csv"))
    want = csv_rows(os.path.join(straight, "test.csv"))
    resume = {"epoch_rel_diff": [row_rel_diff(a, b)
                                 for a, b in zip(got, want)],
              "last_row_resumed": {k: float(got[-1][k])
                                   for k in CSV_METRICS},
              "last_row_straight": {k: float(want[-1][k])
                                    for k in CSV_METRICS}}
    resume["bit_equal_last_row"] = all(got[-1][k] == want[-1][k]
                                       for k in CSV_METRICS)
    if resume["epoch_rel_diff"][-1] > RESUME_RTOL:
        raise AssertionError(f"resumed vs straight run: {resume}")

    # --evaluate reproduces the best stored row
    t0 = time.perf_counter()
    ev = run(["--evaluate", run_dir, "--eval-splits", "--output-dir",
              os.path.join(tmp, "eval")])
    eval_call_s = time.perf_counter() - t0
    val = ev["validation"]
    # the stored row is rounded to 6 decimals
    eval_err = max((abs(val[k] - float(best[k])) - 5e-7)
                   / max(abs(float(best[k])), 1e-12)
                   for k in CSV_METRICS)
    if eval_err > EVAL_RTOL or set(ev["splits"]) != {"day", "night"}:
        raise AssertionError(f"--evaluate {val} vs best row {best} "
                             f"({eval_err:.2e}), splits "
                             f"{sorted(ev['splits'])}")
    eval_batches = math.ceil(HARNESS_VAL / B_TRAIN)
    eval_loop_s = eval_batches * (val["data_time"] + val["gpu_time"])

    # Predictor.from_run against the Trainer model's eval prediction
    b8 = PackedDataset(os.path.join(data, "val")).batch(range(B_TRAIN))
    served = Predictor.from_run(run_dir).predict(b8)
    tr = Trainer(parse_command(["--evaluate", run_dir, "--output-dir",
                                os.path.join(tmp, "eval2")]))
    tr.load_for_evaluate()
    own = make_predict_fn(tr.model, tr.arch_spec, tr.cfg)(b8)[
        "pred"][..., 0].float().cpu().numpy()
    tr.close()
    del tr
    if served.shape != (B_TRAIN, H, W) or not np.isfinite(served).all():
        raise AssertionError("from_run prediction shape or values")
    np.testing.assert_allclose(served, own, **SMALL_TOL)

    # the bare bf16 step again, now with the Trainer's deterministic
    # cuDNN convolutions (the train phase ran without them)
    model, _, state, step = train_setup(torch, train_config("bfloat16"),
                                        dev)
    _, times = run_steps(torch, dev, step, state, b8, TRAIN_STEPS)
    det_step = B_TRAIN / statistics.median(times[1:])
    del model, state, step

    hist = r2["history"] + r3["history"]
    out = {
        "phase": "harness", "arch": "resnet18_multistage",
        "decoder": "upproj", "dtype": "bfloat16", "batch": B_TRAIN,
        "hw": [H, W], "sweeps": 5, "samples": [HARNESS_TRAIN,
                                               HARNESS_VAL],
        "data_write_s": data_s, "data_bytes": data_bytes,
        "reader": r2["reader"], "host_augment": r2["host_augment"],
        "launches": launches, "launches_by_phase": phases.counts,
        "train_steps": steps, "val_forwards": val_batches + panels,
        "fit_2_epochs_s": fit_s,
        "epochs": [{"epoch": h["epoch"], "walls_s": h["walls"],
                    "img_per_s": h["train"]["steps"] * B_TRAIN
                    / h["walls"]["train"],
                    "data_time_s": h["train"]["data_time"],
                    "gpu_time_s": h["train"]["gpu_time"],
                    "loss": h["train"]["loss"],
                    "val_rmse": h["val"]["rmse"],
                    "val_data_time_s": h["val"]["data_time"],
                    "val_gpu_time_s": h["val"]["gpu_time"]}
                   for h in hist],
        "bare_step_img_per_s_bf16": bare_step,
        "bare_step_img_per_s_bf16_deterministic": det_step,
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "checkpoints": r2["saves"] + r3["saves"],
        "checkpoint_steps": ckpt_steps,
        "resume": resume,
        "evaluate": {"rel_err_vs_best_row": eval_err,
                     "img_per_s": HARNESS_VAL / eval_loop_s,
                     "call_s": eval_call_s,
                     "splits": {t: m["count"]
                                for t, m in ev["splits"].items()}},
        "from_run_vs_trainer_max_abs": float(np.abs(served - own).max()),
    }
    emit(out)
    prof = profile_harness(torch, base, os.path.join(tmp, "prof"))
    return out, prof


# ---------------------------------------------------------------- ingest

# The day-one chain of radar_depth_tpu_torch/rehearse.py at full width:
# reference-format pickles at 900x1600 -> import_pickles (child process,
# 2x down to 450x800, 1 sweep, 1/8 to val) -> one epoch of train_argv's
# run (resnet18_latefusion, B=32, bf16) -> --evaluate --eval-splits ->
# export_oracle.
INGEST_PICKLES = 80  # 70 train, 10 val
INGEST_SHARD_BYTES = 1 << 27  # ~43 records of 3.05 MB: 2 train shards
INGEST_RSS_GB = 2.0  # the importer's bounded-memory contract
INGEST_ARCH, INGEST_BATCH = "resnet18_latefusion", 32  # train_argv's


def val_forwards(n, cfg, viz=True):
    """Forwards of Trainer.validate over ``n`` samples under the run's
    TrainConfig ``cfg``: one per eval batch, and one per comparison-panel
    row (the first sample of every ``cfg.val_viz_every``-th batch, at most
    8) when ``viz``."""
    batches = math.ceil(n / (cfg.eval_batch_size or cfg.batch_size))
    return batches + (min(8, math.ceil(batches / cfg.val_viz_every))
                      if viz else 0)


def phase_ingest(torch, np, dev):
    """rehearse.fabricate -> rehearse.run_importer -> train.main (one
    epoch, counted, in this process) -> --evaluate --eval-splits (counted)
    -> python -m radar_depth_tpu_torch.export_oracle (a child process
    that sees no card) -> the export mapped back bit-equal to the
    checkpoint, and a float32 Predictor of it bit-equal to from_run's;
    then kernel C on an imported train batch and the bf16 Predictor of
    the export (kernels B and C) over the val split and at B=1, each
    bit-equal to its plain version. Its files live in a temp directory
    deleted at the end."""
    import shutil
    import tempfile

    from radar_depth_tpu_torch import rehearse
    from radar_depth_tpu_torch.config import load_config, serve_config
    from radar_depth_tpu_torch.convert import port_state_dict_from_oracle
    from radar_depth_tpu_torch.data.packed import PackedDataset
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.ops import kernels
    from radar_depth_tpu_torch.ops.preprocess import _radar_uvz, to_device
    from radar_depth_tpu_torch.ops.raster import sort_points_by_pixel
    from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
    from radar_depth_tpu_torch.train.main import run

    root = tempfile.mkdtemp(prefix="rdt-ingest-")
    try:
        src, out, run_dir = (os.path.join(root, d)
                             for d in ("pickles", "packed", "run"))
        t0 = time.perf_counter()
        rehearse.fabricate(src, INGEST_PICKLES, seed=0, map_frac=0.1,
                           night_frac=0.25)
        fabricate_s = time.perf_counter() - t0
        src_bytes = sum(os.path.getsize(os.path.join(src, f))
                        for f in os.listdir(src))

        t0 = time.perf_counter()
        rss_gb = rehearse.run_importer(src, out, INGEST_SHARD_BYTES)
        import_s = time.perf_counter() - t0
        shutil.rmtree(src)
        shards = {split: sorted(f for f in os.listdir(os.path.join(out, split))
                                if f.endswith(".rdtp"))
                  for split in ("train", "val")}
        train_ds = PackedDataset(os.path.join(out, "train"))
        n_train = len(train_ds)
        train_batch = train_ds.batch(range(INGEST_BATCH))
        train_ds.close()
        val_ds = PackedDataset(os.path.join(out, "val"))
        n_val, tags = len(val_ds), list(val_ds.tags)
        b8 = val_ds.batch(range(B_SERVE))
        val_all = val_ds.batch(range(n_val))
        val_ds.close()
        if (rss_gb >= INGEST_RSS_GB or len(shards["train"]) < 2
                or set(tags) != {"day", "night"} or (n_train, n_val) != (
                    INGEST_PICKLES - INGEST_PICKLES // 8, INGEST_PICKLES // 8)):
            raise AssertionError(
                f"import: peak RSS {rss_gb:.3f} GB, shards {shards}, "
                f"{n_train} + {n_val} samples, val tags {tags}")

        # the main path, counted: one epoch through train.main
        argv = rehearse.train_argv(out, run_dir, 1)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with count_by_phase() as phases:
            r = run(argv)
        train_s = time.perf_counter() - t0
        train_launches = read_launches()
        h = r["history"][0]
        best, _ = check_run_dir(run_dir, 1, r["cfg"])

        # --evaluate --eval-splits, counted
        reset_launches()
        t0 = time.perf_counter()
        ev = run(argv + ["--evaluate", run_dir, "--eval-splits"])
        eval_s = time.perf_counter() - t0
        eval_launches = read_launches()
        val = ev["validation"]
        eval_err = max((abs(val[k] - float(best[k])) - 5e-7)
                       / max(abs(float(best[k])), 1e-12)
                       for k in CSV_METRICS)
        split_rows = {t: csv_rows(os.path.join(run_dir, f"test_{t}.csv"))
                      for t in ("day", "night")}
        if (eval_err > EVAL_RTOL or set(ev["splits"]) != {"day", "night"}
                or any(len(rows) != 1 for rows in split_rows.values())):
            raise AssertionError(f"--evaluate {val} vs best row {best} "
                                 f"({eval_err:.2e}), splits "
                                 f"{sorted(ev['splits'])}, {split_rows}")

        # export_oracle, a file conversion on the CPU: no card visible
        pth = os.path.join(root, "oracle.pth")
        t0 = time.perf_counter()
        [(rc, stdout, err)] = run_procs(
            [[sys.executable, "-m", "radar_depth_tpu_torch.export_oracle",
              "--run", run_dir, "--out", pth, "--arch", INGEST_ARCH,
              "--height", str(H), "--width", str(W)]],
            lambda i: dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=600)
        export_s = time.perf_counter() - t0
        exported = torch.load(pth, weights_only=True)
        if rc != 0 or stdout != f"exported {len(exported)} tensors → {pth}\n":
            raise AssertionError(f"export_oracle exited {rc}: {stdout}"
                                 f"{err[-2000:]}")
        ckpt = ckpt_lib.load_payload(ckpt_lib.resolve_checkpoint(run_dir))
        back = port_state_dict_from_oracle(exported, like=ckpt["model"])
        if not all(torch.equal(back[k], v) for k, v in ckpt["model"].items()):
            raise AssertionError("export -> port differs from the checkpoint")

        # a Predictor of the exported weights against from_run, float32
        cfg = load_config(os.path.join(run_dir, "config.json"))
        cfg32 = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, dtype="float32"))
        from_run = Predictor.from_run(run_dir, cfg=cfg32)
        sites = len(record_epilogue_sites(torch, from_run, b8))
        want = from_run.predict(b8)
        got = Predictor(serve_config(cfg32), back).predict(b8)
        if (got.shape != (B_SERVE, H, W) or not np.isfinite(got).all()
                or not np.array_equal(got, want)):
            raise AssertionError("Predictor of the export differs from "
                                 "from_run's (float32, B=8)")
        del from_run

        # the kernels against their plain versions at this path's shapes:
        # kernel C on a train batch's sorted radar points, as each train
        # step rasterizes them, and kernels B and C in the bf16 Predictor
        # of the export over the val batch and at B=1 (a panel forward)
        lin, zs = sort_points_by_pixel(
            *_radar_uvz(to_device(train_batch, dev)), H, W, 0.0, 80.0)
        got_c = kernels.zbuffer_min_depth_sorted(lin, zs, H, W)
        want_c = kernels.zbuffer_min_depth_sorted_reference(lin, zs, H, W)
        if not torch.equal(got_c.view(torch.int32), want_c.view(torch.int32)):
            raise AssertionError(
                f"kernel C on the train batch {tuple(lin.shape)} differs "
                f"from its plain version by "
                f"{float((got_c - want_c).abs().max())}")
        kernel_c = {"B": lin.shape[0], "P": lin.shape[1],
                    "kept": int((lin < H * W).sum()), "bit_equal": True}
        serve16 = serve_config(cfg)
        kern16 = Predictor(serve16, back, device=dev)
        plain16 = Predictor(serve16, back, device=dev, plain=True)
        take = lambda n: {k: v[:n] for k, v in val_all.items()}
        reset_launches()
        got16 = {n: kern16.predict(take(n)) for n in (n_val, 1)}
        kern16_launches = read_launches()
        want16 = {n: plain16.predict(take(n)) for n in (n_val, 1)}
        if (read_launches() != kern16_launches
                or kern16_launches[KERNELS["A"]] != 0
                or kern16_launches[KERNELS["C"]] < 2
                or kern16_launches[KERNELS["B"]]
                != sites * kern16_launches[KERNELS["C"]]):
            raise AssertionError(f"bf16 Predictor launches {kern16_launches}"
                                 f", then {read_launches()} with the plain "
                                 f"one; {sites} kernel B sites per forward")
        bf16_err = {n: float(np.abs(got16[n] - want16[n]).max())
                    for n in got16}
        for n, out16 in got16.items():
            if (out16.shape != (n, H, W) or not np.isfinite(out16).all()
                    or not np.array_equal(out16, want16[n])):
                raise AssertionError(f"bf16 Predictor B={n}: kernels vs "
                                     f"plain max abs {bf16_err[n]}")
        del kern16, plain16

        # kernel C once per train step and per forward, kernel B at every
        # eval BN->ReLU site of the built model, kernel A never
        steps = h["train"]["steps"]
        val_fw = val_forwards(n_val, r["cfg"])
        eval_fw = val_fw + sum(val_forwards(tags.count(t), r["cfg"],
                                            viz=False)
                               for t in ("day", "night"))
        want_launches = {
            "train_epoch": {KERNELS["A"]: 0, KERNELS["B"]: 0,
                            KERNELS["C"]: steps},
            "validate": {KERNELS["A"]: 0, KERNELS["B"]: sites * val_fw,
                         KERNELS["C"]: val_fw},
            "evaluate": {KERNELS["A"]: 0, KERNELS["B"]: sites * eval_fw,
                         KERNELS["C"]: eval_fw}}
        got_launches = dict(phases.counts, evaluate=eval_launches)
        if (got_launches != want_launches
                or steps != n_train // INGEST_BATCH
                or train_launches != {
                    k: want_launches["train_epoch"][k]
                    + want_launches["validate"][k] for k in train_launches}):
            raise AssertionError(f"ingest launches {got_launches} (train "
                                 f"{train_launches}), expected "
                                 f"{want_launches}")

        smi = nvidia_smi().split(", ")
        result = {
            "phase": "ingest", "arch": INGEST_ARCH, "dtype": "bfloat16",
            "batch": INGEST_BATCH, "hw": [H, W], "source_hw": [
                rehearse.FULL_H, rehearse.FULL_W], "sweeps": 1,
            "pickles": INGEST_PICKLES, "samples": [n_train, n_val],
            "val_tags": {t: tags.count(t) for t in ("day", "night")},
            "fabricate_s": fabricate_s, "pickle_mb": src_bytes / 1e6,
            "import_s": import_s, "importer_peak_rss_gb": rss_gb,
            "shards": {k: len(v) for k, v in shards.items()},
            "shard_mb": shard_bytes(out) / 1e6,
            "train_epoch_s": train_s, "walls_s": h["walls"],
            # two windows too short for a rate: they read start-up
            "epoch_img_per_s": steps * INGEST_BATCH / h["walls"]["train"],
            "epoch_window_images": steps * INGEST_BATCH,
            "train_steps": steps, "loss": h["train"]["loss"],
            "val_rmse": h["val"]["rmse"],
            "evaluate_s": eval_s,
            "evaluate_img_per_s": n_val / (
                math.ceil(n_val / INGEST_BATCH)
                * (val["data_time"] + val["gpu_time"])),
            "evaluate_window_images": n_val,
            "evaluate_rel_err_vs_best_row": eval_err,
            "splits": {t: m["count"] for t, m in ev["splits"].items()},
            "kernel_B_sites_per_forward": sites,
            "launches": got_launches,
            "export_s": export_s, "exported_tensors": len(exported),
            "export_round_trip_bit_equal": True,
            "predictor_from_export_bit_equal": True,
            "kernel_C_train_batch_vs_plain": kernel_c,
            "predictor_bf16_vs_plain": {
                "batches": list(got16), "launches": kern16_launches,
                "max_abs_err": max(bf16_err.values()), "bit_equal": True},
            "device": {"name": smi[0], "power.limit": smi[-1]}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(result)
    return result


# The zoo through the Trainer: resnet50_multistage, one bf16 epoch of
# ZOO_TRAINER_TRAIN packed samples, validated on the harness's val split.
ZOO_TRAINER_ARCH = "resnet50_multistage"
ZOO_TRAINER_TRAIN = 16
ZOO_TRAINER_SITES = 212  # kernel B sites per resnet50_multistage forward


def checkpoint_bytes(run_dir) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(os.path.join(run_dir, "checkpoints"))
               for f in files)


def phase_harness_zoo(torch, tmp):
    """ZOO_TRAINER_ARCH through train.main on the card (bfloat16, B=8,
    450x800): one epoch on ZOO_TRAINER_TRAIN packed samples with the
    harness's val split, then --evaluate of the run, both counted."""
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.data.packed import write_shards
    from radar_depth_tpu_torch.train.main import run

    data = os.path.join(tmp, "zoo_data")
    ds = SyntheticNuScenes(ZOO_TRAINER_TRAIN, seed=2,
                           spec=SampleSpec(height=H, width=W, num_sweeps=5))
    write_shards(os.path.join(data, "train"),
                 (ds[i] for i in range(ZOO_TRAINER_TRAIN)))
    os.symlink(os.path.join(tmp, "data", "val"), os.path.join(data, "val"))
    run_dir = os.path.join(tmp, "zoo_run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with count_by_phase() as phases:
        r = run(harness_argv(data, ZOO_TRAINER_ARCH)
                + ["--epochs", "1", "--output-dir", run_dir])
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    h = r["history"][0]
    steps = h["train"]["steps"]
    train, val = phases.counts["train_epoch"], phases.counts["validate"]
    if (steps != ZOO_TRAINER_TRAIN // B_TRAIN
            or train != {KERNELS["A"]: 0, KERNELS["B"]: 0,
                         KERNELS["C"]: steps}
            or val[KERNELS["B"]] != ZOO_TRAINER_SITES * val[KERNELS["C"]]
            or not math.isfinite(h["train"]["loss"])
            or not math.isfinite(h["val"]["rmse"])):
        raise AssertionError(f"{ZOO_TRAINER_ARCH} Trainer: {steps} steps, "
                             f"launches {phases.counts}, {h}")
    reset_launches()
    t0 = time.perf_counter()
    ev = run(["--evaluate", run_dir, "--output-dir",
              os.path.join(tmp, "zoo_eval"), "--print-freq", "100"])
    eval_s = time.perf_counter() - t0
    ev_launches = read_launches()
    forwards = ev_launches[KERNELS["C"]]
    if (forwards < math.ceil(HARNESS_VAL / B_TRAIN)
            or ev_launches[KERNELS["B"]] != ZOO_TRAINER_SITES * forwards
            or not math.isfinite(ev["validation"]["rmse"])):
        raise AssertionError(f"{ZOO_TRAINER_ARCH} --evaluate: launches "
                             f"{ev_launches}, {ev['validation']}")
    out = {"phase": "harness", "config": ZOO_TRAINER_ARCH,
           "dtype": "bfloat16", "batch": B_TRAIN, "hw": [H, W],
           "samples": [ZOO_TRAINER_TRAIN, HARNESS_VAL], "train_steps": steps,
           "fit_1_epoch_s": fit_s, "walls_s": h["walls"],
           "img_per_s": steps * B_TRAIN / h["walls"]["train"],
           "loss": h["train"]["loss"], "val_rmse": h["val"]["rmse"],
           "peak_mem_gib": peak, "launches_by_phase": phases.counts,
           "kernel_B_launches_per_eval_forward":
               val[KERNELS["B"]] / val[KERNELS["C"]],
           "checkpoint_bytes": checkpoint_bytes(run_dir),
           "checkpoints": r["saves"],
           "evaluate": {"call_s": eval_s, "launches": ev_launches,
                        "kernel_B_launches_per_forward":
                            ev_launches[KERNELS["B"]] / forwards,
                        "rmse": ev["validation"]["rmse"]}}
    emit(out)
    return out


# ------------------------------------------------- coarse vs refined

TWO_STAGE_SPLITS = "all,day,night"
TIE = 1e-3  # |radar - coarse| this close to a threshold may flip the filter


def two_stage_json(out: str) -> list:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def phase_eval_two_stage(torch, np, dev, tmp, sd):
    """python -m radar_depth_tpu_torch.eval_two_stage on the card: the
    float32 flagship of phase serve's seeded weights saved as a port run
    (no training) over the harness's val split (HARNESS_VAL samples at
    450x800, 5 sweeps, day/night), --split all,day,night --batch 8; its
    main counted (kernel B at 84 and kernel C at 1 launch per batch), and
    its JSON lines against the same tool run with the Predictor's
    plain=True (metrics rtol 1e-4 plus the rounding's 5e-6; efficacy counts
    equal, the kept ones within the pixels near a threshold); img/s of a
    warm pass over the whole split."""
    import contextlib
    import io

    from radar_depth_tpu_torch import config as cfg_lib
    from radar_depth_tpu_torch import eval_two_stage
    from radar_depth_tpu_torch.models import create_model
    from radar_depth_tpu_torch.parallel.mesh import pad_batch_to
    from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
    from radar_depth_tpu_torch.train.state import create_train_state

    data = os.path.join(tmp, "data")  # phase harness's shards
    run_dir = os.path.join(tmp, "two_stage_run")
    os.makedirs(run_dir)
    cfg = cfg_lib.parse_command(harness_argv(data, dtype="float32")
                                + ["--output-dir", run_dir])
    cfg_lib.save_config(cfg, os.path.join(run_dir, "config.json"))
    model = create_model(cfg.model.arch, device="cpu", output_size=(H, W),
                         param_dtype=torch.float32)[0]
    model.load_state_dict(sd)
    ckpt_lib.CheckpointManager(run_dir).save(
        0, create_train_state(model, cfg.optim, 2), {"rmse": 3.0}, wait=True)
    del model
    argv = ["--run", run_dir, "--data-root", data, "--split",
            TWO_STAGE_SPLITS, "--batch", str(B_TRAIN)]
    splits = TWO_STAGE_SPLITS.split(",")

    # a warm pass over the whole split, timed; the pixels near a threshold
    ev = eval_two_stage.TwoStageEval(eval_two_stage.parse_args(argv))
    ev.split("all")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.split("all")
    img_per_s = len(ev.ds) / (time.perf_counter() - t0)
    a = ev.args
    ties, batches = {}, 0
    for split in splits:
        idx = [i for i in range(len(ev.ds))
               if split == "all" or ev.ds.sample_tag(i) == split]
        ties[split] = 0
        for i0 in range(0, len(idx), a.batch):
            batches += 1
            b, _ = pad_batch_to(ev.ds.batch(idx[i0:i0 + a.batch]), a.batch)
            coarse, _, target, radar, _ = ev.infer_both(b)
            limit = (a.abs_threshold if a.filter_mode == "abs"
                     else a.rel_threshold * coarse.clamp_min(1e-3))
            near = ((radar > 0) & (target > 0)
                    & (((radar - coarse).abs() - limit).abs() < TIE))
            ties[split] += int(near.sum())
    ev.ds.close()
    del ev

    outs = {}
    for plain in (False, True):
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = eval_two_stage.main(argv, plain=plain)
        outs[plain] = {"rc": rc, "s": time.perf_counter() - t0,
                       "launches": read_launches(), "text": buf.getvalue(),
                       "json": two_stage_json(buf.getvalue())}
    got, want = outs[False], outs[True]
    per_batch = {k: v / batches for k, v in got["launches"].items()}
    if (got["rc"] != 0 or want["rc"] != 0
            or per_batch != {KERNELS["A"]: 0,
                             KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD,
                             KERNELS["C"]: 1}
            or any(want["launches"].values())
            or len(got["json"]) != len(splits)
            or len(want["json"]) != len(splits)):
        raise AssertionError(
            f"eval_two_stage: {batches} batches, rc {got['rc']} (plain "
            f"{want['rc']}), launches {got['launches']} (plain "
            f"{want['launches']})\n{got['text'][-2000:]}")
    diff = {}
    for split, m, w in zip(splits, got["json"], want["json"]):
        err = 0.0
        for name in ("coarse", "refined", "coarse_radar_local",
                     "refined_radar_local"):
            for k, v in w[name].items():
                if abs(m[name][k] - v) > 5e-6 + 1e-4 * abs(v):
                    raise AssertionError(f"eval_two_stage {split} {name} "
                                         f"{k}: {m[name][k]} vs plain {v}")
                err = max(err, abs(m[name][k] - v))
        e, f = m["filter_efficacy"], w["filter_efficacy"]
        if (list(e) != list(f)
                or any(e[k] != f[k] for k in ("radar_px", "gt_px",
                                              "corrupt_px", "clean_px"))
                or any(abs(e[k] - f[k]) > ties[split]
                       for k in ("corrupt_kept", "clean_kept"))):
            raise AssertionError(f"eval_two_stage {split} efficacy {e} vs "
                                 f"plain {f} ({ties[split]} near a "
                                 "threshold)")
        diff[split] = {"metrics_max_abs": err,
                       "efficacy_equal": e == f, "near_threshold_px":
                           ties[split]}
    out = {"phase": "eval_two_stage", "arch": cfg.model.arch,
           "dtype": cfg.model.dtype, "hw": [H, W], "batch": B_TRAIN,
           "splits": splits, "batches": batches, "img_per_s": img_per_s,
           "main_s": got["s"], "plain_main_s": want["s"],
           "launches": got["launches"], "launches_per_batch": per_batch,
           "json": dict(zip(splits, got["json"])),
           "vs_plain": diff}
    emit(out)
    return out


# ------------------------------------------------------ data parallelism

DP_STEPS = 6  # steps of each path in (a); img/s is the median after the first
DP_TIMEOUT_S = 600  # each process that phase data_parallel starts
DP_BACKEND = "nccl"  # of (a) and (c): one rank on the card


def free_ports(n: int = 1) -> list:
    """``n`` distinct free TCP ports of 127.0.0.1 (the sockets are held
    open together while the ports are picked)."""
    import contextlib
    import socket

    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def run_procs(cmds, env_of, timeout):
    """Start every command at once (each in its own session, with
    ``env_of(i)``), wait for all, kill each whole session that outlives
    ``timeout``. Returns [(returncode, stdout, stderr)]."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(cmd, cwd=here, env=env_of(i),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, start_new_session=True)
             for i, cmd in enumerate(cmds)]
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return out


def dp_env(rank, world, port):
    """torchrun's variables for ``rank`` of ``world`` processes on card 0,
    the rendezvous on this host."""
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), PYTHONPATH=here)


def mesh_from_env(port, **kw):
    """``make_mesh(**kw)`` in this process as rank 0 of 1 under torchrun's
    variables (``dp_env``), which are then restored."""
    from radar_depth_tpu_torch.parallel import mesh as pm

    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    env = dp_env(0, 1, port)
    os.environ.update({k: env[k] for k in keys})
    try:
        return pm.make_mesh(**kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class deterministic_cudnn:
    """Context: cuDNN's deterministic algorithms (the Trainer's and the
    Predictor's) on, or off, restored on exit."""

    def __init__(self, torch, enabled=True):
        self.torch, self.enabled = torch, enabled

    def __enter__(self):
        self.saved = self.torch.backends.cudnn.deterministic
        self.torch.backends.cudnn.deterministic = self.enabled

    def __exit__(self, *exc):
        self.torch.backends.cudnn.deterministic = self.saved


def dp_worker(root) -> int:
    """One rank of part (b) of phase data_parallel: two processes on card
    0 over gloo, each with its 4 rows of the B=8 batch: one float32 train
    step and one eval step through the DP path, counted; prints one JSON
    line; rank 0 writes its model state to ``root``."""
    import numpy as np
    import torch

    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.step import make_eval_step, make_train_step

    mesh = pm.make_mesh(backend="gloo")  # both ranks on card 0 (dp_env)
    dev = mesh.device
    sd = torch.load(os.path.join(root, "weights.pt"), map_location="cpu",
                    weights_only=True)
    rows = pm.local_rows(dict(np.load(os.path.join(root, "batch.npz"))),
                         mesh)
    cfg = train_config("float32")
    with deterministic_cudnn(torch):
        model, spec, state, _ = train_setup(torch, cfg, dev, state_dict=sd)
        step = make_train_step(model, spec, cfg, mesh=mesh)
        torch.cuda.synchronize()
        reset_launches()
        pm.COLLECTIVES.clear()
        t0 = time.perf_counter()
        sums = {k: float(v) for k, v in step(
            state, rows,
            generator=torch.Generator(device=dev).manual_seed(3)).items()}
        step_s = time.perf_counter() - t0
        train_launches, collectives = read_launches(), dict(pm.COLLECTIVES)
        replicated = pm.assert_replicated(model, mesh)
        if mesh.is_main:
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       os.path.join(root, "state.pt"))
        ev_model = train_setup(torch, cfg, dev, state_dict=sd)[0]
        ev = make_eval_step(ev_model, spec, cfg, mesh=mesh)
        reset_launches()
        ev_sums = {k: float(v) for k, v in ev(rows).items()}
        eval_launches = read_launches()
    print(json.dumps({"rank": mesh.rank, "world": mesh.world,
                      "backend": mesh.backend, "rows": len(rows["image"]),
                      "sums": sums, "eval_sums": ev_sums,
                      "train_launches": train_launches,
                      "eval_launches": eval_launches,
                      "collectives": collectives, "replicated": replicated,
                      "step_s": step_s}), flush=True)
    mesh.barrier()
    pm.destroy_mesh(mesh)
    return 0


def dp_steps(torch, dev, cfg, sd, batch, mesh):
    """DP_STEPS train steps from ``sd`` on ``batch``, each drawing from a
    generator seeded 10 + i, through the DP path on ``mesh`` (None: the
    plain step), counted. Returns model, per-step sums and seconds,
    launches, collectives."""
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.step import make_train_step

    model, spec, state, _ = train_setup(torch, cfg, dev, state_dict=sd)
    step = make_train_step(model, spec, cfg, mesh=mesh)
    gen = torch.Generator(device=dev)
    sums, times = [], []
    torch.cuda.synchronize()
    reset_launches()
    pm.COLLECTIVES.clear()
    for i in range(DP_STEPS):
        gen.manual_seed(10 + i)
        t0 = time.perf_counter()
        sums.append({k: float(v) for k, v in step(state, batch,
                                                  generator=gen).items()})
        times.append(time.perf_counter() - t0)
    return {"model": model, "spec": spec, "sums": sums, "times": times,
            "launches": read_launches(), "collectives": dict(pm.COLLECTIVES)}


def states_equal(torch, a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


def phase_data_parallel(torch, np, dev, batch, tmp):
    """The DP path (parallel/mesh.py) on the card: (a) a 1-rank NCCL group,
    (b) two gloo processes on card 0, (c) torchrun with one NCCL rank
    through train.main."""
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.step import make_eval_step

    b8 = {k: v[:B_TRAIN] for k, v in batch.items()}
    sd = train_init(torch, train_setup(torch, train_config("float32"),
                                       "cpu")[0], 5).state_dict()
    out = {"phase": "data_parallel", "batch": B_TRAIN, "steps": DP_STEPS}

    # (a) a 1-rank NCCL group: the DP path bit-equal to the plain step
    mesh = mesh_from_env(free_ports()[0])
    if (mesh.backend, mesh.world, mesh.device) != (DP_BACKEND, 1, dev):
        raise AssertionError(f"data_parallel mesh {mesh}")
    a, dp_launches = {}, {k: 0 for k in KERNELS.values()}
    try:
        with deterministic_cudnn(torch):
            for dtype in ("float32", "bfloat16"):
                cfg = train_config(dtype)
                plain = dp_steps(torch, dev, cfg, sd, b8, None)
                dp = dp_steps(torch, dev, cfg, sd, b8, mesh)
                want = {KERNELS["A"]: 0, KERNELS["B"]: 0,
                        KERNELS["C"]: DP_STEPS}
                if plain["launches"] != want or dp["launches"] != want:
                    raise AssertionError(
                        f"data_parallel {dtype} launches {plain['launches']}"
                        f" / {dp['launches']}, expected {want}")
                if plain["collectives"] or set(dp["collectives"]) != {
                        "all_reduce"}:
                    raise AssertionError(f"collectives {plain['collectives']}"
                                         f" / {dp['collectives']}")
                bit_equal = (plain["sums"] == dp["sums"]
                             and states_equal(torch, plain["model"],
                                              dp["model"]))
                if not bit_equal:
                    raise AssertionError(f"data_parallel {dtype}: the 1-rank "
                                         "group's steps differ from the plain"
                                         " steps")
                for k, n in dp["launches"].items():
                    dp_launches[k] += n
                a[dtype] = {
                    "bit_equal": bit_equal,
                    "losses": [x["loss"] for x in dp["sums"]],
                    "collectives_per_step":
                        dp["collectives"]["all_reduce"] / DP_STEPS,
                    "img_per_s_dp": B_TRAIN / statistics.median(
                        dp["times"][1:]),
                    "img_per_s_plain": B_TRAIN / statistics.median(
                        plain["times"][1:]),
                    "step_ms_dp": [t * 1e3 for t in dp["times"]],
                    "step_ms_plain": [t * 1e3 for t in plain["times"]]}
            # one eval step through the group, beside the plain eval step
            model, spec = dp["model"], dp["spec"]
            cfg = train_config("bfloat16")
            want_ev = make_eval_step(model, spec, cfg)(b8)
            reset_launches()
            pm.COLLECTIVES.clear()
            got_ev = make_eval_step(model, spec, cfg, mesh=mesh)(b8)
            ev_launches = read_launches()
            expect = {KERNELS["A"]: 0, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD,
                      KERNELS["C"]: 1}
            if ev_launches != expect or {k: float(v) for k, v in
                                         got_ev.items()} != {
                    k: float(v) for k, v in want_ev.items()}:
                raise AssertionError(f"data_parallel eval: launches "
                                     f"{ev_launches}, sums {got_ev} vs "
                                     f"{want_ev}")
            for k, n in ev_launches.items():
                dp_launches[k] += n
            a["eval"] = {"launches": ev_launches, "bit_equal": True,
                         "collectives": dict(pm.COLLECTIVES)}
            grads = [torch.ones_like(p) for p in model.parameters()]
            a["grad_all_reduce"] = {
                "tensors": len(grads),
                "bytes": sum(g.numel() * g.element_size() for g in grads),
                "ms": cuda_ms(torch, lambda: pm.all_reduce_sum(grads, mesh))}
            del model, grads, plain, dp
    finally:
        pm.destroy_mesh(mesh)
    torch.cuda.empty_cache()
    out["nccl_world1"] = a
    out["launches"] = dp_launches

    # (b) two processes on card 0 over gloo, each with 4 rows of B=8
    root = os.path.join(tmp, "dp")
    os.makedirs(root, exist_ok=True)
    torch.save(sd, os.path.join(root, "weights.pt"))
    np.savez(os.path.join(root, "batch.npz"), **b8)
    port, = free_ports()
    cmd = [sys.executable, os.path.abspath(__file__), "--dp-worker", root]
    t0 = time.perf_counter()
    results = run_procs([cmd, cmd], lambda r: dp_env(r, 2, port),
                        DP_TIMEOUT_S)
    two_s = time.perf_counter() - t0
    lines = {}
    for rank, (rc, o, e) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"data_parallel rank {rank} exit {rc}:\n"
                                 f"{o[-2000:]}\n{e[-4000:]}")
        rec = json.loads([x for x in o.splitlines() if x.startswith("{")][-1])
        lines[rec["rank"]] = rec
    cfg = train_config("float32")
    with deterministic_cudnn(torch):
        model, spec, state, step = train_setup(torch, cfg, dev,
                                               state_dict=sd)
        ref = step(state, b8,
                   generator=torch.Generator(device=dev).manual_seed(3))
        ref_ev = make_eval_step(train_setup(torch, cfg, dev, state_dict=sd)[0],
                                spec, cfg)(b8)
        got = train_setup(torch, cfg, dev, state_dict=torch.load(
            os.path.join(root, "state.pt"), weights_only=True))[0]
    cmp = compare_steps(np, {k: v.double() for k, v in sd.items()}, got,
                        model, lines[0]["sums"], ref,
                        "data_parallel 2 ranks vs 1 process")
    ev_err = max(abs(lines[r]["eval_sums"][k] - float(v))
                 / max(abs(float(v)), 1e-30)
                 for r in lines for k, v in ref_ev.items())
    want_train = {KERNELS["A"]: 0, KERNELS["B"]: 0, KERNELS["C"]: 1}
    want_eval = {KERNELS["A"]: 0, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD,
                 KERNELS["C"]: 1}
    if (sorted(lines) != [0, 1] or ev_err > SUMS_RTOL
            or lines[0]["sums"] != lines[1]["sums"]
            or not all(r["replicated"] and r["backend"] == "gloo"
                       and r["rows"] == B_TRAIN // 2
                       and r["train_launches"] == want_train
                       and r["eval_launches"] == want_eval
                       for r in lines.values())):
        raise AssertionError(f"data_parallel 2 ranks: {lines}, eval sums "
                             f"rel err {ev_err:.2e}")
    out["gloo_two_ranks"] = {
        "vs_one_process": cmp, "eval_sums_max_rel": ev_err,
        "launches_per_rank": {"train_step": [lines[r]["train_launches"]
                                             for r in sorted(lines)],
                              "eval_step": [lines[r]["eval_launches"]
                                            for r in sorted(lines)]},
        "collectives_per_rank_step": lines[0]["collectives"],
        "params_bit_equal_across_ranks": True, "seconds": two_s}
    del model, state, step, got
    torch.cuda.empty_cache()

    # (c) torchrun, one NCCL rank, train.main on the harness shards
    run_dir = os.path.join(tmp, "dp_cli")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "radar_depth_tpu_torch.train.main",
           *harness_argv(os.path.join(tmp, "data")), "--epochs", "1",
           "--output-dir", run_dir]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    (rc, o, e), = run_procs([cmd], lambda _: dict(os.environ, PYTHONPATH=here),
                            DP_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    if rc != 0 or f"1 ranks ({DP_BACKEND})" not in o:
        raise AssertionError(f"torchrun train.main exit {rc}:\n{o[-2000:]}\n"
                             f"{e[-4000:]}")
    row = csv_rows(os.path.join(run_dir, "test.csv"))[0]
    want = csv_rows(os.path.join(tmp, "straight", "test.csv"))[0]
    rel = row_rel_diff(row, want)
    if rel > RESUME_RTOL:
        raise AssertionError(f"torchrun row {row} vs non-distributed {want}")
    out["torchrun_nccl_world1"] = {
        "seconds": cli_s, "row_rel_diff": rel,
        "bit_equal_row": all(row[k] == want[k] for k in CSV_METRICS),
        "row": {k: float(row[k]) for k in CSV_METRICS}}
    emit(out)
    return out


# ------------------------------------------------- spatial partitioning

SPATIAL = 2  # ranks of the space axis in phase spatial (data axis: 1)
SPATIAL_BF16_STEPS = 4  # img/s is the median after the first
GRAD_NORM_RATIO = (0.98, 1.02)  # per parameter, as the JAX test_spatial.py


def spatial_worker(root) -> int:
    """One rank of phase spatial: two processes on card 0 over gloo, a
    (1, 2) mesh, image height sharded over both. (a) a float32 Predictor
    forward of the B=8 batch; (b) the micro-step gradients (summed over
    ranks) and two float32 train steps, the second from the plain step's
    parameters after its first (the float32 gradients are ill-conditioned,
    so each step is compared from the same start, as
    tests/test_torch_train.py does); (c) bf16 train steps, timed, with this
    process's peak memory. Prints one JSON line; each rank writes its
    prediction to ``root``, rank 0 its gradients and states."""
    import numpy as np
    import torch

    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.parallel import spatial as sp
    from radar_depth_tpu_torch.train.step import (
        make_micro_grad_fn,
        make_train_step,
    )

    mesh = pm.make_spatial_mesh(SPATIAL, backend="gloo")  # dp_env
    dev = mesh.device
    sd = torch.load(os.path.join(root, "weights.pt"), map_location="cpu",
                    weights_only=True)
    b8 = dict(np.load(os.path.join(root, "batch.npz")))
    out = {"rank": mesh.rank, "axes": list(mesh.axis_names),
           "shape": list(mesh.shape), "backend": mesh.backend}

    def counted():
        torch.cuda.synchronize()
        reset_launches()
        pm.COLLECTIVES.clear()
        sp.HALO.clear()

    def counts():
        return {"launches": read_launches(),
                "collectives": dict(pm.COLLECTIVES),
                "halo_bytes": sp.HALO["bytes"],
                "halo_host_ms": sp.HALO["seconds"] * 1e3}

    cfg = train_config("float32")
    with deterministic_cudnn(torch):
        pred = Predictor(serve_config(cfg), sd, mesh=mesh)
        counted()
        depth = pred.predict(b8)
        out["predict"] = counts()
        np.save(os.path.join(root, f"pred-{mesh.rank}.npy"), depth)
        del pred
        model, spec, _, _ = train_setup(torch, cfg, dev, state_dict=sd)
        grads, _ = make_micro_grad_fn(model, spec, cfg, mesh=mesh)(
            b8, generator=torch.Generator(device=dev).manual_seed(3))
        names = list(grads)
        grads = dict(zip(names, pm.all_reduce_sum(
            [grads[k] for k in names], mesh)))
        if mesh.is_main:
            torch.save({k: v.cpu() for k, v in grads.items()},
                       os.path.join(root, "grads.pt"))
        del model, grads
        model, spec, state, _ = train_setup(torch, cfg, dev, state_dict=sd)
        step = make_train_step(model, spec, cfg, mesh=mesh)
        out["steps"] = []
        for i in range(2):
            if i:  # from the plain step's parameters, momentum our own
                model.load_state_dict(torch.load(
                    os.path.join(root, "ref-state-0.pt"), weights_only=True))
            counted()
            sums = step(state, b8, generator=torch.Generator(
                device=dev).manual_seed(10 + i))
            sums = {k: float(v) for k, v in sums.items()}
            out["steps"].append(dict(counts(), sums=sums,
                                     replicated=pm.assert_replicated(
                                         model, mesh)))
            if mesh.is_main:
                torch.save({k: v.cpu() for k, v in
                            model.state_dict().items()},
                           os.path.join(root, f"state-{i}.pt"))
        del model, state, step
    torch.cuda.empty_cache()
    out["bf16"] = spatial_bf16_steps(torch, dev, sd, b8, mesh)
    out["float32_precision"] = float32_precision(torch)
    print(json.dumps(out), flush=True)
    mesh.barrier()
    pm.destroy_mesh(mesh)
    return 0


def spatial_bf16_steps(torch, dev, sd, b8, mesh):
    """SPATIAL_BF16_STEPS bf16 B=8 train steps from ``sd`` through ``mesh``
    (None: the plain step): host-clock seconds of each (each ends in a
    fetch of its loss), img/s, the halo exchanges and their host ms per
    step, and the peak memory of this process beside what it held before."""
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.parallel import spatial as sp
    from radar_depth_tpu_torch.train.step import make_train_step

    cfg = train_config("bfloat16")
    model, spec, state, _ = train_setup(torch, cfg, dev, state_dict=sd)
    step = make_train_step(model, spec, cfg, mesh=mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pm.COLLECTIVES.clear()
    sp.HALO.clear()
    times, losses = [], []
    gen = torch.Generator(device=dev)
    for i in range(SPATIAL_BF16_STEPS):
        gen.manual_seed(20 + i)
        t0 = time.perf_counter()
        losses.append(float(step(state, b8, generator=gen)["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    n = SPATIAL_BF16_STEPS
    out = {"img_per_s": B_TRAIN / statistics.median(times[1:]),
           "step_ms": [t * 1e3 for t in times], "losses": losses,
           "peak_gib": peak / 2**30, "held_before_gib": base / 2**30,
           "step_peak_gib": (peak - base) / 2**30,
           "halo_per_step": pm.COLLECTIVES["halo"] / n,
           "halo_grad_per_step": pm.COLLECTIVES["halo_grad"] / n,
           "halo_host_ms_per_step": sp.HALO["seconds"] * 1e3 / n}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def phase_spatial(torch, np, dev, batch, tmp):
    """Spatial partitioning (parallel/spatial.py) on the card: two gloo
    processes on card 0 with image height sharded over both, against the
    single-process paths on the same weights and batch."""
    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.train.step import make_micro_grad_fn

    b8 = {k: v[:B_TRAIN] for k, v in batch.items()}
    cfg = train_config("float32")
    sd = train_init(torch, train_setup(torch, cfg, "cpu")[0], 5).state_dict()
    out = {"phase": "spatial", "batch": B_TRAIN, "space": SPATIAL,
           "height": H, "width": W, "ranks_on_card_0": SPATIAL,
           "backend": "gloo"}
    # the single-process references, the card to itself
    with deterministic_cudnn(torch):
        plain_bf16 = spatial_bf16_steps(torch, dev, sd, b8, None)
    with deterministic_cudnn(torch):
        ref_depth = Predictor(serve_config(cfg), sd, device=dev,
                              plain=True).predict(b8)
        model, spec, _, _ = train_setup(torch, cfg, dev, state_dict=sd)
        ref_grads, _ = make_micro_grad_fn(model, spec, cfg)(
            b8, generator=torch.Generator(device=dev).manual_seed(3))
        ref_grads = {k: v.double().cpu() for k, v in ref_grads.items()}
        ref_model, spec, ref_state, ref_step = train_setup(
            torch, cfg, dev, state_dict=sd)
        ref_sums, ref_states = [], []
        for i in range(2):
            ref_sums.append({k: float(v) for k, v in ref_step(
                ref_state, b8, generator=torch.Generator(
                    device=dev).manual_seed(10 + i)).items()})
            ref_states.append({k: v.detach().cpu().clone()
                               for k, v in ref_model.state_dict().items()})
        del model
    torch.cuda.empty_cache()

    root = os.path.join(tmp, "spatial")
    os.makedirs(root, exist_ok=True)
    torch.save(sd, os.path.join(root, "weights.pt"))
    torch.save(ref_states[0], os.path.join(root, "ref-state-0.pt"))
    np.savez(os.path.join(root, "batch.npz"), **b8)
    port, = free_ports()
    cmd = [sys.executable, os.path.abspath(__file__), "--spatial-worker",
           root]
    t0 = time.perf_counter()
    results = run_procs([cmd] * SPATIAL,
                        lambda r: dp_env(r, SPATIAL, port), DP_TIMEOUT_S)
    out["seconds"] = time.perf_counter() - t0
    lines = {}
    for rank, (rc, o, e) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"spatial rank {rank} exit {rc}:\n"
                                 f"{o[-2000:]}\n{e[-4000:]}")
        rec = json.loads([x for x in o.splitlines() if x.startswith("{")][-1])
        lines[rec["rank"]] = rec
    if sorted(lines) != list(range(SPATIAL)):
        raise AssertionError(f"spatial ranks {sorted(lines)}")
    for r, rec in lines.items():  # what the rank's entry points set
        check_ieee(rec["float32_precision"], f"spatial rank {r}")
    out["float32_precision_per_rank"] = [lines[r]["float32_precision"]
                                         for r in range(SPATIAL)]

    # (a) the forward: each rank the whole map, the plain path's
    depths = [np.load(os.path.join(root, f"pred-{r}.npy"))
              for r in range(SPATIAL)]
    err = rel_rmse(np, depths[0], ref_depth)
    want = {KERNELS["A"]: 0, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD,
            KERNELS["C"]: 1}
    got = [lines[r]["predict"]["launches"] for r in range(SPATIAL)]
    if (err > PARITY_REL_RMSE_TOL or depths[0].shape != ref_depth.shape
            or not all(np.array_equal(d, depths[0]) for d in depths)
            or any(g != want for g in got)):
        raise AssertionError(f"spatial predict: rel RMSE {err:.2e}, "
                             f"launches {got}, expected {want}")
    fwd = lines[0]["predict"]
    halos = fwd["collectives"].get("halo", 0)
    out["predict"] = {
        "rel_rmse_vs_plain": err, "ranks_bit_equal": True,
        "launches_per_rank": got,
        "halo_exchanges_per_forward": halos,
        "halo_bytes_per_exchange": fwd["halo_bytes"] / max(halos, 1),
        "halo_host_ms": fwd["halo_host_ms"],
        "collectives_per_rank": fwd["collectives"]}

    # (b) the train step: gradients, two steps, replicas
    grads = torch.load(os.path.join(root, "grads.pt"), weights_only=True)
    ratios = {k: float(grads[k].double().norm() / w.norm())
              for k, w in ref_grads.items() if float(w.norm()) > 0}
    lo, hi = min(ratios.values()), max(ratios.values())
    if not GRAD_NORM_RATIO[0] < lo <= hi < GRAD_NORM_RATIO[1]:
        raise AssertionError(f"spatial gradient norm ratios {lo:.4f}-"
                             f"{hi:.4f}: {min(ratios, key=ratios.get)}, "
                             f"{max(ratios, key=ratios.get)}")
    steps = lines[0]["steps"]
    cmp = []
    for i in range(2):  # each from the same parameters (the worker's note)
        before = sd if i == 0 else ref_states[0]
        got_model, want_model = (train_setup(torch, cfg, dev, state_dict=t)[0]
                                 for t in (torch.load(os.path.join(
                                     root, f"state-{i}.pt"),
                                     weights_only=True), ref_states[i]))
        cmp.append(compare_steps(
            np, {k: v.double() for k, v in before.items()}, got_model,
            want_model, steps[i]["sums"], ref_sums[i],
            f"spatial step {i} vs 1 process"))
        del got_model, want_model
    want_train = {KERNELS["A"]: 0, KERNELS["B"]: 0, KERNELS["C"]: 1}
    for r in range(SPATIAL):
        for i, st in enumerate(lines[r]["steps"]):
            if (not st["replicated"] or st["launches"] != want_train
                    or st["sums"] != steps[i]["sums"]):
                raise AssertionError(f"spatial rank {r} step {i}: {st}")
    st = steps[0]
    out["train"] = {
        "grad_norm_ratio": [lo, hi], "vs_one_process_steps": cmp,
        "losses": [s["sums"]["loss"] for s in steps],
        "ref_losses": [s["loss"] for s in ref_sums],
        "params_bit_equal_across_ranks": True,
        "launches_per_rank_step": st["launches"],
        "halo_exchanges_per_step": st["collectives"].get("halo", 0),
        "halo_grad_exchanges_per_step": st["collectives"].get("halo_grad", 0),
        "halo_bytes_per_exchange": st["halo_bytes"] / max(
            st["collectives"].get("halo", 0)
            + st["collectives"].get("halo_grad", 0), 1),
        "halo_host_ms_per_step": st["halo_host_ms"],
        "collectives_per_rank_step": st["collectives"]}
    del ref_model, ref_state, ref_step
    torch.cuda.empty_cache()

    # (c) bf16 speed and per-rank memory beside the plain step's
    out["bf16"] = {"spatial_rank": [lines[r]["bf16"] for r in range(SPATIAL)],
                   "plain": plain_bf16,
                   "img_per_s_spatial": lines[0]["bf16"]["img_per_s"],
                   "img_per_s_plain": plain_bf16["img_per_s"],
                   "rank_step_peak_over_plain": max(
                       lines[r]["bf16"]["step_peak_gib"]
                       for r in range(SPATIAL))
                   / plain_bf16["step_peak_gib"]}
    emit(out)
    return out


# ------------------------------------------------- the daemon over ranks

SERVE_SPATIAL_PER_CLIENT = 16  # one-sample requests per client in (c)
SERVE_SPATIAL_START_S = 600  # the ranks' start and warmup
SERVE_SPATIAL_EXIT_S = 60  # every rank's exit after SIGINT to rank 0


def serve_spatial_worker(root, port) -> int:
    """One rank of phase serve_http_spatial: two processes on card 0 over
    gloo, a (1, 2) mesh, the float32 flagship of phase spatial's weights
    (TF32 off) served through ``serve.run_daemon``, the code path of
    ``python -m radar_depth_tpu_torch.serve``: rank 0 leads on
    127.0.0.1:``port``, rank 1 follows. Counts the kernels' launches from
    the daemon's start to its stop and prints them, with the server's
    counts, as one JSON line last."""
    import torch

    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.serve import run_daemon

    mesh = pm.make_spatial_mesh(SPATIAL, backend="gloo")  # dp_env
    sd = torch.load(os.path.join(root, "weights.pt"), map_location="cpu",
                    weights_only=True)
    pred = Predictor(serve_config(train_config("float32")), sd,
                     mesh=mesh)
    torch.cuda.synchronize()
    reset_launches()
    srv = run_daemon(pred, "127.0.0.1", port, max_tile=SERVE_TILE,
                     batch_window_ms=HTTP_WINDOW_MS)
    torch.cuda.synchronize()
    print(json.dumps({"rank": mesh.rank, "leader": srv.is_leader,
                      "dispatches": srv.dispatch_count,
                      "predict_calls": srv.predict_calls,
                      "launches": read_launches(),
                      "broadcast": srv.broadcast,
                      "float32_precision": float32_precision(torch)}),
          flush=True)
    pm.destroy_mesh(mesh)
    return 0


def phase_serve_http_spatial(torch, np, dev, batch, tmp, coalesced):
    """The HTTP daemon over ranks on the card: two processes sharing card 0
    over gloo (NCCL refuses two ranks on one card), image height sharded
    over both, the leader on 127.0.0.1 (a correctness check, not a
    scaling number). ``coalesced``: phase serve_http's numbers, beside."""
    import signal

    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor

    root = os.path.join(tmp, "spatial")  # phase spatial's weights.pt
    sd = torch.load(os.path.join(root, "weights.pt"), map_location="cpu",
                    weights_only=True)
    take = lambda lo, hi: {k: v[lo:hi] for k, v in batch.items()}
    ref_pred = Predictor(serve_config(train_config("float32")), sd,
                         device=dev)
    ref8 = ref_pred.predict(take(0, B_SERVE), max_tile=SERVE_TILE)
    ref1 = [ref_pred.predict(take(i, i + 1), max_tile=SERVE_TILE)
            for i in range(B_SERVE)]
    del ref_pred
    torch.cuda.empty_cache()

    port, master = free_ports(2)
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, os.path.abspath(__file__), "--serve-spatial-worker",
           root, "--http-port", str(port)]
    here = os.path.dirname(os.path.abspath(__file__))
    out = {"phase": "serve_http_spatial", "space": SPATIAL, "backend": "gloo",
           "ranks_on_card_0": SPATIAL, "dtype": "float32", "hw": [H, W],
           "max_tile": SERVE_TILE, "window_ms": HTTP_WINDOW_MS}
    logs = [(open(os.path.join(root, f"serve{r}.out"), "w+"),
             open(os.path.join(root, f"serve{r}.err"), "w+"))
            for r in range(SPATIAL)]

    def tails():
        text = []
        for r, (o, e) in enumerate(logs):
            for f in (o, e):
                f.flush()
                f.seek(0)
            text.append(f"rank {r}:\n{o.read()[-2000:]}\n{e.read()[-4000:]}")
        return "\n".join(text)

    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=here, env=dp_env(r, SPATIAL, master),
                              stdout=logs[r][0], stderr=logs[r][1],
                              start_new_session=True)
             for r in range(SPATIAL)]
    try:
        # (a) /healthz: 503 while the ranks warm up, then 200
        codes = []
        deadline = time.monotonic() + SERVE_SPATIAL_START_S
        while not codes or codes[-1] != 200:
            if time.monotonic() > deadline or any(p.poll() is not None
                                                  for p in procs):
                raise AssertionError(f"healthz {codes[-3:]}:\n{tails()}")
            try:
                codes.append(http(f"{url}/healthz")[0])
            except OSError:  # not bound yet
                pass
            time.sleep(0.1)
        out["ready_s"] = time.perf_counter() - t0
        out["healthz_503_then_200"] = 503 in codes

        # (b) one B=8 and eight B=1 requests against one process's predict
        def served(lo, n):
            status, body = http(f"{url}/predict",
                                npz_body(np, take(lo, lo + n)))
            if status != 200:
                raise AssertionError(f"POST B={n}: {status} {body[:300]!r}")
            return npz_depth(np, body)

        t1 = time.perf_counter()
        d8 = served(0, B_SERVE)
        out["b8_call_ms"] = (time.perf_counter() - t1) * 1e3
        errs = [rel_rmse(np, d8, ref8)] + [
            rel_rmse(np, served(i, 1), ref1[i]) for i in range(B_SERVE)]
        out["rel_rmse_vs_one_process"] = {"b8": errs[0],
                                          "b1_max": max(errs[1:])}
        if d8.shape != (B_SERVE, H, W) or max(errs) > PARITY_REL_RMSE_TOL:
            raise AssertionError(f"served over ranks vs one process: {out}")

        # (c) 8 clients x 16 one-sample requests, coalesced at 5 ms
        bodies = [npz_body(np, take(i, i + 1)) for i in range(HTTP_CLIENTS)]
        out["concurrency"] = run_clients(np, url, bodies,
                                         SERVE_SPATIAL_PER_CLIENT,
                                         "over ranks")
        out["concurrency_serve_http_coalesced"] = {
            k: coalesced[k] for k in ("req_per_s", "p50_ms", "p99_ms",
                                      "requests")}

        # (d) a body the schema check refuses: 400, and nothing was sent
        bad = take(0, 1)
        del bad["intrinsics"]
        status, resp = http(f"{url}/predict", npz_body(np, bad))
        error = json.loads(resp).get("error", "") if status == 400 else ""
        out["bad_request"] = {"status": status, "error": error[:160]}
        if status != 400 or "batch keys" not in error:
            raise AssertionError(f"malformed request: {status} {resp[:300]!r}")
        served(0, 1)

        # (g) SIGINT to rank 0: stop sent, both ranks exit 0
        t1 = time.perf_counter()
        os.kill(procs[0].pid, signal.SIGINT)
        for p in procs:
            p.wait(timeout=max(1.0, SERVE_SPATIAL_EXIT_S
                               - (time.perf_counter() - t1)))
        out["stop_s"] = time.perf_counter() - t1
        rcs = [p.returncode for p in procs]
        if rcs != [0] * SPATIAL:
            raise AssertionError(f"exit codes {rcs}:\n{tails()}")
        lines = []
        for o, _ in logs:
            o.flush()
            o.seek(0)
            lines.append(json.loads(o.read().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for o, e in logs:
            o.close()
            e.close()

    # (e) launches per rank per predict call; (f) the leader's broadcasts;
    # (g) every follower's dispatches equal to the leader's
    leader = lines[0]
    per_call = [{k: v / r["predict_calls"] for k, v in r["launches"].items()}
                for r in lines]
    want = {KERNELS["A"]: 0, KERNELS["B"]: EPILOGUE_SITES_PER_FORWARD,
            KERNELS["C"]: 1}
    if (not leader["leader"] or any(r["leader"] for r in lines[1:])
            or any(pc != want for pc in per_call)
            or any(r["dispatches"] != leader["dispatches"]
                   or r["predict_calls"] != leader["predict_calls"]
                   for r in lines[1:])):
        raise AssertionError(f"serve over ranks: {lines}")
    for r, rec in enumerate(lines):  # what the rank's entry points set
        check_ieee(rec["float32_precision"], f"serve_http_spatial rank {r}")
        if not rec["float32_precision"]["cudnn_deterministic"]:
            raise AssertionError(f"serve_http_spatial rank {r}: cuDNN's "
                                 "default algorithms")
    bc = leader["broadcast"]
    out.update({
        "ranks": lines, "launches_per_rank_per_predict": per_call,
        "dispatches": leader["dispatches"],
        "predict_calls": leader["predict_calls"],
        "broadcast_messages": bc["messages"],
        "broadcast_ms_per_message": bc["seconds"] * 1e3 / bc["messages"],
        "broadcast_mb_per_message": bc["bytes"] / bc["messages"] / 1e6,
        "request_bytes_b8": len(npz_body(np, take(0, B_SERVE)))})
    emit(out)
    return out


def profile_harness(torch, base, out_dir):
    """Device time and idle share of one harness train epoch (the second:
    the first warms up), native loader with host augmentation, under
    torch.profiler."""
    from radar_depth_tpu_torch.config import parse_command
    from radar_depth_tpu_torch.train.loop import Trainer

    tr = Trainer(parse_command(base + ["--epochs", "2", "--output-dir",
                                       out_dir]))
    epochs = iter(range(2))
    try:
        return profile_device(torch, lambda: tr.train_epoch(next(epochs)),
                              "profile_harness", B_TRAIN)
    finally:
        tr.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    ap.add_argument("--dp-worker", metavar="DIR",
                    help="run one rank of phase data_parallel's part (b) on "
                         "the files in DIR (the phase starts these itself)")
    ap.add_argument("--spatial-worker", metavar="DIR",
                    help="run one rank of phase spatial on the files in DIR "
                         "(the phase starts these itself)")
    ap.add_argument("--serve-spatial-worker", metavar="DIR",
                    help="run one rank of phase serve_http_spatial on the "
                         "files in DIR (the phase starts these itself)")
    ap.add_argument("--http-port", type=int, default=0,
                    help="the port of --serve-spatial-worker's leader")
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
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if args.spatial_worker:
        return spatial_worker(args.spatial_worker)
    if args.serve_spatial_worker:
        return serve_spatial_worker(args.serve_spatial_worker, args.http_port)

    dev = torch.device("cuda", 0)
    t_start = t0 = time.perf_counter()
    laps, last = {}, [t_start]

    def lap(phase):  # seconds of each phase, for the wall line
        now = time.perf_counter()
        laps[phase], last[0] = now - last[0], now

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
    lap("build_device_data")

    flush = l2_flusher(torch, dev)
    zb = phase_zbuffer(torch, dev, batch, flush)
    lap("zbuffer")
    zbs = phase_zbuffer_sorted(torch, dev, batch, flush)
    lap("zbuffer_sorted")
    del flush
    launches, launches_sc, speed, parity, pred, sites = phase_serve(
        torch, np, dev, batch, sd)
    lap("serve")
    precision = phase_precision(torch, np, dev, batch, sd, pred)
    lap("precision")
    prof, kernel_b_us_by_site = phase_profile(
        torch, pred, {k: v[:B_SERVE] for k, v in batch.items()}, sites)
    lap("profile")
    host_fold = phase_host_fold_abba(torch, np, pred, batch)
    lap("host_fold_abba")
    serve_http = phase_serve_http(torch, np, pred, batch)
    lap("serve_http")
    bench_out = phase_bench(torch, np, dev, smi)
    lap("bench")
    export = phase_export(torch, np, dev, batch, sd, pred)
    lap("export")
    ops_api = phase_ops_api(torch, np, dev, batch, pred)
    lap("ops_api")
    del pred
    torch.cuda.empty_cache()
    zoo, zoo_sites, prof_zoo = phase_zoo(torch, np, dev, batch)
    lap("zoo")
    epi, epi_err, epi_host, epi_race = phase_epilogue(
        torch, dev, {"resnet18_multistage": sites, **zoo_sites},
        kernel_b_us_by_site, speed["sorted"]["img_per_s_b8"])
    lap("epilogue")
    train, train_launches, trained = phase_train(torch, np, dev, batch)
    lap("train")
    ev = phase_eval(torch, np, dev, batch, trained)
    lap("eval")
    prof_train = phase_profile_train(torch, dev, trained, batch)
    lap("profile_train")
    del trained
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="rdt-harness-")
    try:
        harness, prof_harness = phase_harness(
            torch, np, dev, train["bfloat16"]["img_per_s"], tmp)
        lap("harness")
        ingest = phase_ingest(torch, np, dev)
        lap("ingest")
        harness_zoo = phase_harness_zoo(torch, tmp)
        lap("harness_zoo")
        two_stage = phase_eval_two_stage(torch, np, dev, tmp, sd)
        lap("eval_two_stage")
        dp = phase_data_parallel(torch, np, dev, batch, tmp)
        lap("data_parallel")
        spatial = phase_spatial(torch, np, dev, batch, tmp)
        lap("spatial")
        serve_spatial = phase_serve_http_spatial(
            torch, np, dev, batch, tmp,
            serve_http["concurrency"]["coalesced"])
        lap("serve_http_spatial")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    stem_site = next(r for r in epi if r["dtype"] == "bfloat16"
                     and not r["residual"] and r["shape_nchw"][1] == 64
                     and r["shape_nchw"][2] == (H + 1) // 2)
    stem = stem_site["batch_norm_relu"]
    serve = zb["serve_radar"]
    radar = zbs["radar"]
    summary = {"kernels": [
        {"name": "zbuffer_min_depth", "route": "cuda",
         "op": "rdt::zbuffer_min_depth",
         "source": "radar_depth_tpu_torch/csrc/zbuffer.cu",
         "replaces": "radar_depth_tpu/ops/pallas_kernels.py:71",
         "launches": launches_sc[KERNELS["A"]],
         "launches_harness": harness["launches"][KERNELS["A"]],
         "launches_ingest": {k: n[KERNELS["A"]]
                             for k, n in ingest["launches"].items()},
         "launches_data_parallel": dp["launches"][KERNELS["A"]],
         "launches_export_call": export["scatter"]["launches"][KERNELS["A"]],
         "launches_ops_api": ops_api["scatter"]["launches"][KERNELS["A"]],
         "launches_bench": launches_bench(bench_out, "A"),
         "max_abs_err": 0.0,
         "ms": serve["ms"], "ms_cold": serve["ms_cold"],
         "ms_back_to_back": serve["ms_back_to_back"],
         "plain_ms": serve["plain_ms"],
         "bound_ms": serve["bound_ms"], "bound_by": "bytes",
         "bound_share": serve["bound_share"],
         "library_ms": serve["library_ms"]},
        {"name": "scale_bias_relu", "route": "cuda",
         "op": "rdt::batch_norm_relu (the BN folded in the kernel; "
               "rdt::scale_bias_relu takes the folded scale and bias)",
         "source": "radar_depth_tpu_torch/csrc/epilogue.cu",
         "replaces": "radar_depth_tpu/ops/pallas_kernels.py:251",
         "launches": launches[KERNELS["B"]],
         "launches_harness": harness["launches"][KERNELS["B"]],
         "launches_ingest": {k: n[KERNELS["B"]]
                             for k, n in ingest["launches"].items()},
         "launches_data_parallel": dp["launches"][KERNELS["B"]],
         "launches_data_parallel_rank_eval_step": [
             r[KERNELS["B"]] for r in dp["gloo_two_ranks"][
                 "launches_per_rank"]["eval_step"]],
         "launches_spatial_rank_forward": [
             r[KERNELS["B"]] for r in spatial["predict"][
                 "launches_per_rank"]],
         "launches_serve_http_spatial_rank": [
             r[KERNELS["B"]] for r in serve_spatial[
                 "launches_per_rank_per_predict"]],
         "launches_serve_http": {
             k: r["launches"][KERNELS["B"]]
             for k, r in serve_http["requests"].items()},
         "launches_export_call": export["sorted"]["launches"][KERNELS["B"]],
         "launches_precision_forward": precision["launches"][KERNELS["B"]],
         "launches_eval_two_stage_per_batch":
             two_stage["launches_per_batch"][KERNELS["B"]],
         "launches_harness_resnet50_multistage_eval_forward":
             harness_zoo["kernel_B_launches_per_eval_forward"],
         "launches_bench": launches_bench(bench_out, "B"),
         "host_us_per_call": {k: epi_host[f"{k}_us"] for k in (
             "bnr_bare_ctypes_launch", "bnr_rdt_op", "bnr_wrapper",
             "host_fold_then_wrapper", "bare_ctypes_launch", "rdt_op",
             "wrapper", "custom_op")},
         "race_check_mismatches": {r["site"]: r["mismatched_elements"]
                                   for r in epi_race},
         "device_kernels_per_flagship_forward": {
             k: host_fold[k]["device_kernels"]
             for k in ("kernel_fold", "host_fold")},
         "launches_per_forward": {
             name: n[KERNELS["B"]] // n[KERNELS["C"]]
             for name, n in (("resnet18_multistage", launches),
                             *((k, r["launches"]) for k, r in zoo.items()
                               if "launches" in r))},
         "max_abs_err": max(epi_err.values()),
         "ms": stem["ms"], "ms_cold": stem["ms_cold"],
         "ms_back_to_back": stem["ms_back_to_back"],
         "device_us_in_forward": stem.get("device_us_in_forward"),
         "plain_ms": stem["plain_ms"],
         "bound_ms": stem["bound_ms"], "bound_by": "bytes",
         "bound_share": stem["bound_share"],
         "library_ms": None,
         "yardstick_f_batch_norm_ms": stem_site["f_batch_norm_ms"]},
        {"name": "zbuffer_min_depth_sorted", "route": "cuda",
         "op": "rdt::zbuffer_min_depth_sorted",
         "source": "radar_depth_tpu_torch/csrc/zbuffer_sorted.cu",
         "replaces": "radar_depth_tpu/ops/pallas_kernels.py:176",
         "launches": train_launches["float32"][KERNELS["C"]],
         "launches_harness": harness["launches"][KERNELS["C"]],
         "launches_ingest": {k: n[KERNELS["C"]]
                             for k, n in ingest["launches"].items()},
         "launches_data_parallel": dp["launches"][KERNELS["C"]],
         "launches_data_parallel_rank_train_step": [
             r[KERNELS["C"]] for r in dp["gloo_two_ranks"][
                 "launches_per_rank"]["train_step"]],
         "launches_spatial_rank_forward": [
             r[KERNELS["C"]] for r in spatial["predict"][
                 "launches_per_rank"]],
         "launches_serve_http_spatial_rank": [
             r[KERNELS["C"]] for r in serve_spatial[
                 "launches_per_rank_per_predict"]],
         "launches_ops_api": ops_api["sorted"]["launches"][KERNELS["C"]],
         "launches_serve_http": {
             k: r["launches"][KERNELS["C"]]
             for k, r in serve_http["requests"].items()},
         "launches_export_call": export["sorted"]["launches"][KERNELS["C"]],
         "launches_precision_forward": precision["launches"][KERNELS["C"]],
         "launches_eval_two_stage_per_batch":
             two_stage["launches_per_batch"][KERNELS["C"]],
         "launches_bench": launches_bench(bench_out, "C"),
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
                                    "eval": ev["launches"],
                                    "harness": harness["launches"],
                                    "data_parallel": dp["launches"]},
                       "train": train, "eval": ev, "profile": prof,
                       "profile_train": prof_train,
                       "harness": harness, "profile_harness": prof_harness,
                       "harness_zoo": harness_zoo, "precision": precision,
                       "ingest": ingest,
                       "eval_two_stage": two_stage,
                       "data_parallel": dp, "spatial": spatial,
                       "serve_http_spatial": serve_spatial,
                       "ops_api": ops_api,
                       "serve_http": serve_http, "export": export,
                       "bench": bench_out,
                       "epilogue_host_us": epi_host,
                       "epilogue_race_check": epi_race,
                       "host_fold_abba": host_fold,
                       "zoo": zoo, "profile_zoo": prof_zoo,
                       "wall_s": time.perf_counter() - t_start,
                       "summary": summary}, f, indent=1)
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start,
          "phase_seconds": laps})
    emit(summary)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
