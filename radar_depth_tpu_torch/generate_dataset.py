"""Write the synthetic nuScenes-like dataset as packed shards, the port's
``scripts/generate_dataset.py``: ``data/synthetic.py::SyntheticNuScenes``
through ``data/packed.py::write_shards``, streamed (memory bounded by one
record), each shard with its day/night tags sidecar. The shards are
byte-equal to the JAX script's.

    python -m radar_depth_tpu_torch.generate_dataset --out DIR \\
        [--num-train 512] [--num-val 128] [--height 450] [--width 800] \\
        [--sweeps 5] [--seed 0] [--max-shard-bytes N] \\
        [--night-severity S] [--night-frac F] [--val-night-frac F]

``DIR/train`` takes seed ``--seed``, ``DIR/val`` seed ``--seed`` + 1.
Train with ``train.main --dataset packed --data-root DIR``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from radar_depth_tpu_torch.data.packed import write_shards
from radar_depth_tpu_torch.data.schema import SampleSpec
from radar_depth_tpu_torch.data.synthetic import SceneConfig, SyntheticNuScenes


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--num-train", type=int, default=512)
    p.add_argument("--num-val", type=int, default=128)
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--sweeps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-shard-bytes", type=int, default=4 << 30,
                   help="roll to a new shard file at this size (streaming "
                        "writes, bounded memory)")
    p.add_argument("--night-severity", type=float, default=0.0,
                   help="0..1: information-destroying night rendering "
                        "(shadow crush, motion blur, heavy noise); 0 = the "
                        "mild model")
    p.add_argument("--night-frac", type=float, default=None,
                   help="fraction of night scenes (default: SceneConfig's "
                        "0.25); applies to both splits unless overridden")
    p.add_argument("--val-night-frac", type=float, default=None,
                   help="override the night fraction for the VAL split "
                        "only (a night split large enough to report)")
    args = p.parse_args(argv)

    def make_scene(split: str) -> SceneConfig:
        kw = {"night_severity": args.night_severity}
        nf = args.night_frac
        if split == "val" and args.val_night_frac is not None:
            nf = args.val_night_frac
        if nf is not None:
            kw["night_frac"] = nf
        return SceneConfig(**kw)

    spec = SampleSpec(height=args.height, width=args.width,
                      num_sweeps=args.sweeps)
    for split, n, seed in (("train", args.num_train, args.seed),
                           ("val", args.num_val, args.seed + 1)):
        ds = SyntheticNuScenes(n, spec=spec, seed=seed, scene=make_scene(split))
        out_dir = os.path.join(args.out, split)
        t0 = time.time()
        paths = write_shards(out_dir, (ds[i] for i in range(n)),
                             tags=(ds.sample_tag(i) for i in range(n)),
                             max_shard_bytes=args.max_shard_bytes)
        size_mb = sum(os.path.getsize(q) for q in paths) / 1e6
        print(f"{split}: {n} samples → {out_dir} ({len(paths)} shard(s), "
              f"{size_mb:.0f} MB, {time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
