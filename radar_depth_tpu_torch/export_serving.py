"""Export a trained run to a serving artifact: the whole raw-batch -> depth
path (preprocessing with its z-buffer, the model, the blend) as one
``torch.export`` program with the weights baked in, at a fixed batch size,
on the card unless ``--platform cpu``. Load it with
``radar_depth_tpu_torch.inference.load_serving``.

    python -m radar_depth_tpu_torch.export_serving --run runs/ms \\
        --out ms_serving.pt2 --batch 8 [--dtype bfloat16] [--platform cpu]

The model and data flags are those of ``scripts/export_serving.py``. Each
one given overrides the run's config.json; the rest come from it (from the
defaults of ``TrainConfig`` if the run has none).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from radar_depth_tpu_torch.config import (
    _RUN_CONFIG_FLAGS,
    ARCH_NAMES,
    DECODER_NAMES,
    MODALITIES,
    TrainConfig,
    load_config,
)
from radar_depth_tpu_torch.device import resolve_device
from radar_depth_tpu_torch.inference import Predictor


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--arch", choices=sorted(ARCH_NAMES))
    p.add_argument("--modality", choices=sorted(MODALITIES))
    p.add_argument("--decoder", choices=list(DECODER_NAMES))
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--num-sweeps", type=int)
    p.add_argument("--height-extension", type=int)
    p.add_argument("--raster-backend", choices=["sorted", "scatter"])
    p.add_argument("--dtype", choices=["float32", "bfloat16"])
    # the multistage stage-2 filter must match training: a run's config.json
    # carries it, and a flag given here overrides it
    p.add_argument("--filter-mode", choices=["abs", "rel", "or"])
    p.add_argument("--abs-threshold", type=float)
    p.add_argument("--rel-threshold", type=float)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--platform", default="default", choices=["default", "cpu"],
                   help="'default' exports on the CUDA card (and fails "
                        "without one); 'cpu' exports for the CPU")
    return p.parse_args(argv)


def run_config(args: argparse.Namespace):
    """The run's TrainConfig with the flags given on the command line
    replacing its fields."""
    path = os.path.join(args.run, "config.json")
    cfg = load_config(path) if os.path.isfile(path) else TrainConfig()
    sections = {"data": {}, "model": {}}
    for dest, keys in _RUN_CONFIG_FLAGS.items():
        value = getattr(args, dest, None)
        if value is not None:
            section, field = keys
            sections[section][field] = value
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, **sections["data"]),
        model=dataclasses.replace(cfg.model, **sections["model"]))


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    cfg = run_config(args)
    pred = Predictor.from_run(args.run, cfg=cfg, device=device)
    nbytes = pred.export_serving(args.out, args.batch)
    print(f"exported {nbytes / 1e6:.1f} MB -> {args.out} (batch={args.batch}, "
          f"{cfg.data.height}x{cfg.data.width}, {cfg.model.arch}, "
          f"{cfg.model.dtype}, {device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
