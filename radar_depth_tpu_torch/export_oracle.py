"""Export a trained run to a torch state_dict ``.pth`` that the reference's
torch modules load (the oracle, ``radar_depth_tpu/oracle/torch_model.py``):
the port's ``scripts/export_torch.py``, the other direction of
``--pretrained``.

    python -m radar_depth_tpu_torch.export_oracle --run RUN --out F.pth \\
        [--arch resnet18_latefusion] [--modality rgbd] [--decoder upproj] \\
        [--height 450] [--width 800]

The flags build the config, as the JAX script's do; the run's best (else
latest) checkpoint is read through ``train/checkpoint.py`` into a float32
model of that config on the CPU (keys and shapes checked), and its
state_dict is mapped by ``convert.oracle_state_dict_from_port``. The file
holds {name: float32 CPU tensor}. This is a file conversion: it runs on
the CPU and neither needs nor touches a card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from radar_depth_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from radar_depth_tpu_torch.convert import oracle_state_dict_from_port
from radar_depth_tpu_torch.inference import Predictor


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--arch", default="resnet18_latefusion")
    p.add_argument("--modality", default="rgbd")
    p.add_argument("--decoder", default="upproj")
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--width", type=int, default=800)
    args = p.parse_args(argv)

    cfg = TrainConfig(
        data=DataConfig(height=args.height, width=args.width),
        model=ModelConfig(arch=args.arch, modality=args.modality,
                          decoder=args.decoder),
    )
    pred = Predictor.from_run(args.run, cfg=cfg, device="cpu")
    sd = oracle_state_dict_from_port(pred.model.state_dict())
    torch.save(sd, args.out)
    print(f"exported {len(sd)} tensors → {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
