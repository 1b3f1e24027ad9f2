"""Command line of the port's training harness (``radar_depth_tpu/train/
main.py``), on the CUDA card unless ``--platform cpu``:

  train:     python -m radar_depth_tpu_torch.train.main --arch resnet18_multistage ...
  resume:    ... --resume RUN --epochs N
  evaluate:  ... --evaluate RUN [--eval-splits]

Data-parallel over N cards of one host, one process per card (NCCL), with
the same flags; ``-b`` and ``--eval-batch-size`` are global and must be
multiples of N:

  python -m torch.distributed.run --standalone --nproc-per-node N \
      -m radar_depth_tpu_torch.train.main ...

``--platform cpu`` runs the ranks on the CPU over gloo. As the JAX CLI,
which takes every visible device, there is no flag for it: ``torchrun``'s
``RANK``/``WORLD_SIZE`` make the mesh (``parallel/mesh.py::make_mesh``),
and rank 0 alone writes the run directory and prints.

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
    trainer.say(
        f"train data: {trainer.reader} reader, augmentation "
        f"{'in the loader threads' if trainer.host_augment else 'in the step'}"
        f"; device {trainer.device}"
        + (f"; {trainer.mesh.world} ranks ({trainer.mesh.backend})"
           if trainer.mesh.group is not None else "")
        + (f", data {trainer.mesh.data_size} x space "
           f"{trainer.mesh.space_size}" if trainer.mesh.space_size > 1
           else ""))
    if cfg.evaluate:
        try:
            trainer.load_for_evaluate()
            metrics = trainer.validate(epoch=0)
            trainer.say("validation:",
                        {k: round(v, 4) for k, v in metrics.items()})
            splits = {}
            if cfg.eval_splits:
                splits = trainer.validate_splits(epoch=0)
                if not splits:
                    trainer.say("--eval-splits: val dataset carries no (or "
                                "only one) split tag — packed shards need a "
                                "tags.json sidecar (write_shard(tags=...)); "
                                "nothing to report")
                for tag, m in splits.items():
                    trainer.say(f"validation[{tag}]:",
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
