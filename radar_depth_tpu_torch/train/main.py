"""Command line of the port's training harness (``radar_depth_tpu/train/
main.py``), on the CUDA card unless ``--platform cpu``:

  train:     python -m radar_depth_tpu_torch.train.main --arch resnet18_multistage ...
  resume:    ... --resume RUN --epochs N
  evaluate:  ... --evaluate RUN [--eval-splits]

``run(argv)`` is the same flow and returns what it measured, for callers in
Python: {"cfg", "reader", "host_augment", and "validation" + "splits" after
--evaluate, or "history" (per epoch: metrics, walls) + "saves" after a
training run}.
"""

from __future__ import annotations

import sys
from typing import Dict

from radar_depth_tpu_torch.config import parse_command
from radar_depth_tpu_torch.train.loop import Trainer


def run(argv=None) -> Dict:
    cfg = parse_command(argv)
    trainer = Trainer(cfg)
    out = {"cfg": cfg, "reader": trainer.reader,
           "host_augment": trainer.host_augment}
    print(f"train data: {trainer.reader} reader, augmentation "
          f"{'in the loader threads' if trainer.host_augment else 'in the step'}"
          f"; device {trainer.device}")
    if cfg.evaluate:
        try:
            trainer.load_for_evaluate()
            metrics = trainer.validate(epoch=0)
            print("validation:", {k: round(v, 4) for k, v in metrics.items()})
            splits = {}
            if cfg.eval_splits:
                splits = trainer.validate_splits(epoch=0)
                if not splits:
                    print("--eval-splits: val dataset carries no (or only "
                          "one) split tag — packed shards need a tags.json "
                          "sidecar (write_shard(tags=...)); nothing to report")
                for tag, m in splits.items():
                    print(f"validation[{tag}]:",
                          {k: round(v, 4) for k, v in m.items()})
                trainer.write_split_csvs(splits)
        finally:
            trainer.close()
        return dict(out, validation=metrics, splits=splits)
    trainer.fit()
    return dict(out, history=trainer.history, saves=trainer.saves)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
