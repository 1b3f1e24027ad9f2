"""Parameter counts, BN-statistic counts and forward FLOPs of the
registry's archs, the port's ``scripts/model_summary.py``:

    python -m radar_depth_tpu_torch.model_summary          # every arch, 450x800
    python -m radar_depth_tpu_torch.model_summary --arch resnet18_multistage \\
        --height 224 [--no-flops]

Parameters are the model's ``parameters()`` (the flax ``params`` tree);
BN statistics its ``running_mean`` and ``running_var`` buffers (the flax
``batch_stats``). FLOPs: one eval-mode forward at B=1 on the CPU (zero
weights and inputs; every kernel runs its plain version there), counted by
``torch.utils.flop_counter.FlopCounterMode``, which counts the
convolutions and matmuls only (two per multiply-add). The JAX script's
column is XLA's ``cost_analysis()`` of its compiled forward, which counts
elementwise work too, so the two are not the same quantity: for
``resnet18_multistage`` / ``upproj`` this counter reads 0.9935x XLA's at
450x800 (119.14 against 119.93 GFLOPs), 1.0706x at 128x224 and 1.2045x at
64x96 (XLA on the CPU, float32; convolutions are 99.4% of this count).
"""

from __future__ import annotations

import argparse
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from radar_depth_tpu_torch.config import DECODER_NAMES
from radar_depth_tpu_torch.models import ARCH_REGISTRY, create_model

BN_STATS = ("running_mean", "running_var")


def summarize(arch: str, height: int = 450, width: int = 800,
              decoder: str = "upproj", flops: bool = True) -> tuple:
    """(parameters, BN statistics, forward FLOPs at B=1 or None)."""
    model, spec = create_model(arch, device="cpu", decoder=decoder,
                               output_size=(height, width))
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(b.numel() for name, b in model.named_buffers()
                  if name.endswith(BN_STATS))
    if not flops:
        return n_params, n_stats, None
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    rgb = torch.zeros(1, height, width, 3)
    radar = torch.zeros(1, height, width, 1)
    if spec.input_kind == "late":
        inputs = (rgb, radar)
    else:
        inputs = (torch.cat([rgb, radar], dim=-1),)
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(*inputs)
    return n_params, n_stats, counter.get_total_flops()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None, help="default: every registry arch")
    p.add_argument("--decoder", default="upproj", choices=list(DECODER_NAMES))
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--no-flops", action="store_true",
                   help="skip the forward (counts only; much faster)")
    args = p.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCH_REGISTRY)
    print(f"{'arch':36s} {'params':>12s} {'bn stats':>10s} "
          f"{'conv+matmul GFLOPs@B=1':>23s}")
    for arch in archs:
        n_params, n_stats, flops = summarize(
            arch, args.height, args.width, args.decoder,
            flops=not args.no_flops)
        f = f"{flops / 1e9:23.1f}" if flops else f"{'n/a':>23s}"
        print(f"{arch:36s} {n_params:12,d} {n_stats:10,d} {f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
