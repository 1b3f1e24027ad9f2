#!/usr/bin/env python3
"""Where the data-parallel path's extra time goes, on one CUDA card with a
1-rank NCCL group (radar_depth_tpu_torch/parallel/mesh.py).

    python3 scripts/torch_dp_overhead.py [--calls 200] [--batch 8] \
        [--label NAME]

Each piece is timed twice over ``calls`` calls: host microseconds per call
(the Python thread's time to enqueue them, perf_counter to the last call's
return) and device microseconds per call (CUDA events around the same calls
queued behind a device sleep, so they bracket the device's work when the
host keeps ahead); and one call's host ms behind a device sleep (about the
sleep if the call waits for the card). The pieces: ``dist.all_reduce`` of
a 256-float tensor (a BN layer's statistics), ``all_reduce_sum`` of it,
``all_reduce_grad`` forward and backward, ``global_moments`` forward and
backward beside ``var_mean``'s and beside the same moments taken through
two ``all_reduce_grad`` calls (four all-reduces, each its own node), and
``all_reduce_sum`` of the flagship's gradients (320 tensors).

Then one bfloat16 train step of the flagship (450x800, B=``batch``, seeded
weights, SyntheticNuScenes(seed=0)) without the group, with it, and with
it but BN on the rank's own moments (``dp_local_bn``: what the rest of the
DP path costs). Unprofiled: the host ms until a step returns beside its
wall ms once the card is done, the caching allocator's device
allocations, frees and retries over those steps, and the calls that wait
for the card in one step (``torch.cuda.set_sync_debug_mode``). Profiled:
wall ms, device busy ms (kernels and copies), and the CPU ops that cost
the most host time.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(torch, fn, calls):
    """(host us, device us) per call of ``fn``, and the host ms of one call
    queued behind a device sleep of ~100 ms: about the sleep if the call
    waits for the card, else about ``host_us``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    fn()
    behind = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    torch.cuda.synchronize()
    return {"host_us": host, "device_us": s.elapsed_time(e) * 1e3 / calls,
            "host_ms_behind_sleep": behind}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8,
                    help="rows of the train step (one rank's batch)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("torch_dp_overhead: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.models import layers
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.step import make_train_step

    dev = torch.device("cuda", 0)
    mesh = cs.mesh_from_env(cs.free_port())  # rank 0 of a 1-rank group
    out = {"label": args.label, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi(), "torch": torch.__version__,
           "backend": mesh.backend, "calls": args.calls,
           "batch": args.batch,
           "env": {k: v for k, v in os.environ.items()
                   if k.startswith(("TORCH_NCCL", "NCCL_"))}}
    try:
        t = torch.randn(256, device=dev)
        tg = torch.randn(256, device=dev, requires_grad=True)
        x = torch.randn(8, 256, 15, 25, device=dev, requires_grad=True)
        up = torch.randn(256, device=dev)

        def grad_ar():
            torch.autograd.grad((pm.all_reduce_grad(tg, mesh) * up).sum(), tg)

        def unfused(mean, var, mesh):
            w = 1.0 / mesh.world
            gmean = pm.all_reduce_grad(mean * w, mesh)
            return gmean, pm.all_reduce_grad(
                (var + torch.square(mean - gmean)) * w, mesh)

        def moments(fn):
            def call():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                if fn is not None:
                    mean, var = fn(mean, var, mesh)
                torch.autograd.grad(((mean + var) * up).sum(), x)
            return call

        model, spec, state, _ = cs.train_setup(
            torch, cs.train_config("bfloat16"), dev, seed=0)
        grads = [torch.ones_like(p) for p in model.parameters()]
        pieces = {
            "dist_all_reduce_256": lambda: dist.all_reduce(t),
            "all_reduce_sum_256": lambda: pm.all_reduce_sum([t], mesh),
            "all_reduce_grad_256_fwd_bwd": grad_ar,
            "var_mean_fwd_bwd": moments(None),
            "global_moments_fwd_bwd": moments(pm.global_moments),
            "moments_two_all_reduce_grad_fwd_bwd": moments(unfused),
            "sleep_alone": lambda: None,
            "all_reduce_sum_grads": lambda: pm.all_reduce_sum(grads, mesh),
        }
        out["pieces"] = {k: per_call_us(torch, fn, args.calls if "grads"
                                        not in k else 20)
                         for k, fn in pieces.items()}
        del grads

        spec5 = SampleSpec(height=cs.H, width=cs.W, num_sweeps=5)
        batch = SyntheticNuScenes(args.batch, spec=spec5,
                                  seed=0).batch(range(args.batch))
        steps = {}
        for name, m in (("plain", None), ("dp", mesh), ("dp_local_bn", mesh)):
            # dp_local_bn: the DP step with BN on each rank's own moments
            # (wrong beyond world 1): what the rest of the DP path costs
            layers.global_moments = (
                (lambda mean, var, mesh: (mean, var))
                if name == "dp_local_bn" else pm.global_moments)
            step = make_train_step(model, spec, cs.train_config("bfloat16"),
                                   mesh=m)
            gen = torch.Generator(device=dev).manual_seed(0)
            for _ in range(3):
                step(state, batch, generator=gen)
            torch.cuda.synchronize()
            before = torch.cuda.memory_stats()
            enqueue, walls = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                step(state, batch, generator=gen)
                enqueue.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            after = torch.cuda.memory_stats()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step(state, batch, generator=gen)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            syncs = [str(w.message).splitlines()[0] for w in caught
                     if "synchroniz" in str(w.message)]
            unprofiled = {
                "enqueue_ms": statistics.median(enqueue) * 1e3,
                "wall_ms": statistics.median(walls) * 1e3,
                "allocator": {k: after[k] - before[k] for k in (
                    "num_device_alloc", "num_device_free",
                    "num_alloc_retries", "num_sync_all_streams")},
                "syncing_calls": len(syncs), "first_syncs": syncs[:3]}
            pm.COLLECTIVES.clear()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                float(step(state, batch, generator=gen)["loss"])
                wall = time.perf_counter() - t0
            events = prof.key_averages()
            # kernels and copies alone: a CPU op's row and a user
            # annotation's (Optimizer.step) repeat their kernels' time
            busy = sum(e.self_device_time_total for e in events
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)) / 1e3
            top = sorted(events, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:12]
            steps[name] = {
                "unprofiled": unprofiled,
                "wall_ms": wall * 1e3, "device_busy_ms": busy,
                "collectives": dict(pm.COLLECTIVES),
                "top_self_cpu": [{"name": e.key, "calls": e.count,
                                  "self_cpu_ms": e.self_cpu_time_total / 1e3}
                                 for e in top]}
        layers.global_moments = pm.global_moments
        out["train_step_bf16"] = steps
    finally:
        pm.destroy_mesh(mesh)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
