#!/usr/bin/env python3
"""Times of kernel B at every eval-mode BN->ReLU site of the flagship
(resnet18_multistage / upproj, B=8, 450x800, bfloat16), of one checkout of
the port, on one CUDA card.

    python3 scripts/torch_epilogue_timing.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``radar_depth_tpu_torch`` is built and
timed (default: this repository), so that two commits are compared on one
card in one run of the machine: run the parent's checkout and this one in
turns (parent, change, change, parent), one process each. Per site, both
as the model runs it and as the bare epilogue:

* ``site``: the eval-mode ``BatchNorm`` module called as the model calls it
  (``bn(x, relu=True, residual=r)``), whatever that checkout launches for it
  (a host fold of five ops and ``rdt::scale_bias_relu``, or one
  ``rdt::batch_norm_relu``): warm, L2-cold and back-to-back event times;
* ``scale_bias_relu``: the operator both checkouts have, on the folded
  scale and bias: the same three times.

Each result is checked against the plain version before it is timed. The
inputs are drawn from a seed; the sites come from one eval forward of the
checkout's own flagship model. Sums are weighted by the sites per forward;
the host time per call of both forms is taken at the smallest site, behind
a device sleep. The timing helpers (``chip_smoke.cuda_ms`` and the L2
flush) are this repository's. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(torch, fn, calls=128, reps=6) -> float:
    """Median host time per call, in us, of ``calls`` calls queued behind a
    device sleep longer than the run."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose radar_depth_tpu_torch is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_epilogue_timing: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from radar_depth_tpu_torch.models import (
        BatchNorm,
        create_model,
        init_random,
    )
    from radar_depth_tpu_torch.ops import kernels
    from radar_depth_tpu_torch.ops.preprocess import pack_model_inputs

    if not kernels.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {kernels.__file__}, not from {root}")
    built = kernels.build(("epilogue",))
    dev = torch.device("cuda", 0)
    model, arch = create_model("resnet18_multistage", device="cpu",
                               dtype=torch.bfloat16, output_size=(cs.H, cs.W))
    model = init_random(model, 0).to(dev)
    sites = {}

    def hook(module, hargs, kwargs):
        if kwargs.get("relu"):
            key = (tuple(hargs[0].shape), kwargs.get("residual") is not None)
            sites[key] = sites.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, BatchNorm)]
    g = torch.Generator(device=dev).manual_seed(0)
    prepared = {"rgb": torch.rand(cs.B_SERVE, cs.H, cs.W, 3, generator=g,
                                  device=dev),
                "radar": torch.rand(cs.B_SERVE, cs.H, cs.W, 1, generator=g,
                                    device=dev) * 50}
    with torch.inference_mode():
        model(*pack_model_inputs(prepared, arch.input_kind))
    for h in handles:
        h.remove()
    del model

    flush = cs.l2_flusher(torch, dev)
    rows, sums, smallest = [], {}, None
    for (shape, has_res), count in sorted(
            sites.items(), key=lambda kv: (-math.prod(kv[0][0]), kv[0][1])):
        mk = lambda: torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        x = mk()
        res = mk() if has_res else None
        bn = BatchNorm(shape[1], device=dev).eval()
        with torch.no_grad():
            for t, v in zip((bn.weight, bn.bias, bn.running_mean,
                             bn.running_var),
                            cs.bn_params(torch, dev, g, shape[1])):
                t.copy_(v)
            scale, bias = bn.folded()

        def site(x=x, res=res, bn=bn):
            with torch.inference_mode():
                return bn(x, relu=True, residual=res)

        def epilogue(x=x, res=res, scale=scale, bias=bias):
            return kernels.scale_bias_relu(x, scale, bias, res)

        want = kernels.scale_bias_relu_reference(x, scale, bias, res)
        row = {"shape_nchw": list(shape), "residual": has_res,
               "sites_per_forward": count}
        moved = x.numel() * 2 * (3 if has_res else 2)
        for name, fn, nbytes in (("site", site, moved + 4 * shape[1] * 4),
                                 ("scale_bias_relu", epilogue,
                                  moved + 2 * shape[1] * 4)):
            got = fn()
            idt = torch.int16
            differ = ((got.view(idt) != want.view(idt))
                      & ~((got == 0) & (want == 0)))
            if differ.any():
                raise AssertionError(f"{name} {shape} res={has_res}: "
                                     f"{int(differ.sum())} values differ")
            row[name] = cs.warm_and_cold(torch, fn, flush,
                                         nbytes / cs.HBM_BYTES_PER_S * 1e3)
            for k in ("ms", "ms_cold", "ms_back_to_back", "bound_ms"):
                sums.setdefault(name, {}).setdefault(k, 0.0)
                sums[name][k] += count * row[name][k]
        rows.append(row)
        smallest = (site, epilogue, list(shape))
    site, epilogue, shape = smallest
    print(json.dumps({"label": args.label, "root": root,
                      "device": cs.nvidia_smi(), "nvcc": built,
                      "dtype": "bfloat16", "batch": cs.B_SERVE,
                      "sites_per_forward": sum(sites.values()),
                      "sums_per_forward": sums,
                      "host_us_per_call": {
                          "shape_nchw": shape, "site": host_us(torch, site),
                          "scale_bias_relu": host_us(torch, epilogue)},
                      "launch_floor": cs.launch_floor(torch, dev),
                      "sites": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
