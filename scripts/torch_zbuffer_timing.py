#!/usr/bin/env python3
"""Warm and L2-cold times of the port's z-buffer kernels A and C, of one
checkout of the port, on one CUDA card, at the shapes of the main path:
B=8, 450x800, radar density (P=640) and LiDAR density (P=40960).

    python3 scripts/torch_zbuffer_timing.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``radar_depth_tpu_torch`` is built and
timed (default: this repository), so that two commits are compared on one
card in one machine session: run the parent's checkout and this one in
turns (parent, change, change, parent), one process each. The inputs
(SyntheticNuScenes(seed=0)) and the timing (``chip_smoke.cuda_ms``, warm and
after a 128 MiB write) are this repository's. Each kernel's map is checked
against the plain version before it is timed; its device time comes from
torch.profiler. Prints one JSON line, with the event times of a trivial
launch beside the kernels'.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        print("torch_zbuffer_timing: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.ops import kernels
    from radar_depth_tpu_torch.ops.raster import bin_points, sort_points_by_pixel

    if not kernels.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {kernels.__file__}, not from {root}")
    built = kernels.build(("zbuffer", "zbuffer_sorted"))
    dev = torch.device("cuda", 0)
    h, w = cs.H, cs.W
    # 24 samples as chip_smoke.py makes them; the first B_SERVE are timed
    batch = SyntheticNuScenes(24, spec=SampleSpec(height=h, width=w,
                                                  num_sweeps=5),
                              seed=0).batch(range(24))
    flush = cs.l2_flusher(torch, dev)
    out = {}
    for name, (uv, z, valid) in cs.zbuffer_points(torch, dev, batch,
                                                  cs.B_SERVE).items():
        lin, zf, _ = bin_points(uv, z, valid, h, w, 0.0, 80.0, -1)
        lin_s, z_s = sort_points_by_pixel(uv, z, valid, h, w, 0.0, 80.0)
        lin, zf, lin_s, z_s = (t.contiguous() for t in (lin, zf, lin_s, z_s))
        fns = {"A": lambda: kernels.zbuffer_min_depth(lin, zf, h, w),
               "C": lambda: kernels.zbuffer_min_depth_sorted(lin_s, z_s, h, w)}
        want = kernels.zbuffer_min_depth_reference(lin, zf, h, w)
        for kernel, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{kernel} {name}: != plain version")
            r = cs.warm_and_cold(torch, fn, flush, cs.map_bound_ms(lin, h * w))
            r.update(cs.device_split(torch, fn, r["ms"],
                                     "zbs_" if kernel == "C" else "zb_"))
            out.setdefault(kernel, {})[name] = r
    print(json.dumps({"label": args.label, "root": root,
                      "device": cs.nvidia_smi(),
                      "nvcc": built,
                      "launch_floor": cs.launch_floor(torch, dev),
                      "kernels": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
