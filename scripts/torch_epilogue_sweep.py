#!/usr/bin/env python3
"""Kernel B's launch shape swept on one CUDA card: each variant of
``radar_depth_tpu_torch/csrc/epilogue.cu`` with other values of its three
tunables (resident blocks per SM, 16-byte loads in flight per thread, grid
cap in waves) is built into a temporary directory and timed at every
eval-mode BN->ReLU site of the flagship (resnet18_multistage / upproj,
B=8, 450x800, bfloat16, with the BN folded in the kernel, as the model
calls it), beside the variant as committed.

    python3 scripts/torch_epilogue_sweep.py [--variants 4,4,1 3,8,1 ...]

Each variant's output is held bit-equal (signed zeros aside) to the plain
version before it is timed; warm, L2-cold and back-to-back event times
come from ``chip_smoke.py``'s helpers, and each variant's sum is weighted
by the sites per forward. Prints one JSON line per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# (N, C, H, W), residual, sites per forward: the flagship's bf16 B=8 sites
# (scripts/torch_epilogue_timing.py records them from one eval forward)
SITES = [((8, 64, 225, 400), False, 4), ((8, 16, 240, 400), False, 2),
         ((8, 16, 240, 400), True, 2), ((8, 64, 113, 200), False, 8),
         ((8, 64, 113, 200), True, 8), ((8, 32, 120, 200), False, 2),
         ((8, 32, 120, 200), True, 2), ((8, 128, 57, 100), False, 8),
         ((8, 128, 57, 100), True, 8), ((8, 64, 60, 100), False, 2),
         ((8, 64, 60, 100), True, 2), ((8, 256, 29, 50), False, 8),
         ((8, 256, 29, 50), True, 8), ((8, 512, 15, 25), False, 8),
         ((8, 128, 30, 50), False, 2), ((8, 512, 15, 25), True, 8),
         ((8, 128, 30, 50), True, 2)]
TUNABLES = ("kBlocksPerSm", "kLoadsInFlight", "kWaves")


def build_variant(src: str, values, out_dir: str):
    """Start nvcc on ``src`` with the tunables set to ``values``; returns
    (process, library path)."""
    for name, v in zip(TUNABLES, values):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {v};", src)
        if n != 1:
            raise ValueError(f"{name} not found once in epilogue.cu")
    tag = "_".join(map(str, values))
    path = os.path.join(out_dir, f"epilogue_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    from radar_depth_tpu_torch.ops import kernels

    lib = os.path.join(out_dir, f"libepilogue_{tag}.so")
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
                             path], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+",
                    default=["4,4,1", "4,4,2", "4,4,4", "4,4,16", "3,8,1",
                             "3,8,4", "4,2,8"],
                    help="blocks per SM, loads in flight, waves")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_epilogue_sweep: no CUDA device", file=sys.stderr)
        return 2
    from radar_depth_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    src = (kernels.CSRC / kernels.SOURCES["epilogue"]).read_text()
    variants = [tuple(int(v) for v in s.split(",")) for s in args.variants]
    tmp = tempfile.mkdtemp(prefix="rdt-sweep-")
    builds = {v: build_variant(src, v, tmp) for v in variants}
    fns = {}
    for v, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {v}: nvcc failed\n{log}")
        fn = ctypes.CDLL(lib).rdt_scale_bias_relu
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_float,
                       ctypes.c_longlong, ci, ci, vp]
        fn.restype = ci
        fns[v] = (fn, [line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line])

    g = torch.Generator(device=dev).manual_seed(0)
    flush = cs.l2_flusher(torch, dev)
    cases = []
    for shape, has_res, count in SITES:
        mk = lambda: torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        x = mk()
        res = mk() if has_res else None
        bn = cs.bn_params(torch, dev, g, shape[1])
        want = kernels.batch_norm_relu_reference(x, *bn, cs.EPS, res)
        nbytes = x.numel() * 2 * (3 if has_res else 2) + 4 * shape[1] * 4
        cases.append((shape, has_res, count, x, res, bn, want, nbytes))
    for v, (fn, ptxas) in fns.items():
        rows, sums = [], {"ms": 0.0, "ms_cold": 0.0, "ms_back_to_back": 0.0,
                          "bound_ms": 0.0}
        for shape, has_res, count, x, res, bn, want, nbytes in cases:
            out = torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream

            def launch(x=x, res=res, bn=bn, out=out):
                err = fn(x.data_ptr(),
                         None if res is None else res.data_ptr(),
                         out.data_ptr(), *(t.data_ptr() for t in bn),
                         cs.EPS, x.numel(), x.shape[1], 1, stream)
                if err:
                    raise RuntimeError(f"variant {v}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if cs.bits_differ(torch, out, want)[0].any():
                raise AssertionError(f"variant {v} {shape} res={has_res}: "
                                     "differs from the plain version")
            r = cs.warm_and_cold(torch, launch, flush,
                                 nbytes / cs.HBM_BYTES_PER_S * 1e3)
            for k in sums:
                sums[k] += count * r[k]
            rows.append({"shape_nchw": list(shape), "residual": has_res,
                         **{k: r[k] for k in ("ms", "ms_cold",
                                              "ms_back_to_back")}})
        print(json.dumps({"variant": dict(zip(TUNABLES, v)),
                          "device": cs.nvidia_smi(), "ptxas": ptxas,
                          "sums_per_forward": sums, "sites": rows}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
