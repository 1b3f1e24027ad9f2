"""Coarse-vs-refined evaluation of a trained two-stage run, the port's
``scripts/eval_two_stage.py``: the full metric set of BOTH MultiStageNet
outputs (D1, the coarse stage-1 depth, and D2, the refined stage-2 depth
after the radar filter ``filter_radar_by_prediction``) on a packed val
split, and the same metrics restricted to pixels near a projected radar
return, where the filter acts, with the filter's efficacy counts. If the
filter pays, D2 < D1 overall and the gap widens on radar-local pixels.

    python -m radar_depth_tpu_torch.eval_two_stage --run RUN --data-root DIR \\
        [--split all,day,night] [--batch 32] [--radius 4] [--platform cpu]

The model and data flags (arch, decoder, dtype, the filter's mode and
thresholds, ``stage2_coarse``, height, width, sweeps) default to the run's
own ``config.json``, and its ``height_extension`` and ``raster_backend``
are taken from it as well; a flag given overrides the run's value. This is
about correctness: the filter has no parameters, so evaluating a run with
a mode or threshold other than its own gives wrong refined outputs and
keep-masks, silently. The run's ``spatial`` is not adopted: the tool runs
in one process on one device (the card unless ``--platform cpu``).

The radar-local mask is a max over a (2r+1)^2 window of the occupancy map
(``F.max_pool2d``), an op along the image height: a spatially partitioned
version would have to take its halo rows through
``parallel/spatial.py::gather_rows``.

Output, per split: the text report and one JSON line with the metrics of
the four outputs (5 decimals) and the efficacy counts. Exit status 1 when
a split is empty or no sample carries its tag.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

from radar_depth_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
    load_config,
)
from radar_depth_tpu_torch.data.packed import PackedDataset
from radar_depth_tpu_torch.device import resolve_device
from radar_depth_tpu_torch.inference import Predictor
from radar_depth_tpu_torch.metrics import (
    accumulate_metric_sums,
    compute_metric_sums,
    finalize_metrics,
)
from radar_depth_tpu_torch.models.fusion import filter_radar_by_prediction
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    pack_model_inputs,
    prepare_eval_batch,
)
from radar_depth_tpu_torch.parallel.mesh import pad_batch_to

KEYS = ("rmse", "mae", "absrel", "delta1")
OUTPUTS = ("coarse", "refined", "coarse_radar_local", "refined_radar_local")
EFFICACY = ("radar_px", "gt_px", "corrupt_px", "corrupt_kept", "clean_px",
            "clean_kept")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True)
    p.add_argument("--data-root", required=True)
    # model and data flags override the run's config.json (module docstring)
    p.add_argument("--arch", default=None,
                   help="override the run's arch "
                        "(e.g. resnet18_multistage_uncertainty)")
    p.add_argument("--decoder", default=None,
                   choices=["deconv2", "deconv3", "upconv", "upproj"])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--sweeps", type=int, default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--filter-mode", default=None, choices=["abs", "rel", "or"])
    p.add_argument("--stage2-coarse", action="store_true", default=None,
                   help="the run used --stage2-coarse (D1 as a stage-2 "
                        "radar-branch channel)")
    p.add_argument("--abs-threshold", type=float, default=None)
    p.add_argument("--rel-threshold", type=float, default=None)
    p.add_argument("--radius", type=int, default=4,
                   help="pixels around each projected radar return counted "
                        "as 'radar-local' for the per-pixel breakdown")
    p.add_argument("--metric-avg", default="batch",
                   choices=["batch", "sample"],
                   help="averaging convention; 'batch' matches the trainer "
                        "CSVs / reference AverageMeter")
    p.add_argument("--split", default="",
                   help="restrict to one tag from the val tags sidecar "
                        "(e.g. day / night); comma-separated tags evaluate "
                        "each split in one process, with one model; 'all' "
                        "means the whole set")
    p.add_argument("--out-prefix", default="",
                   help="with multiple --split tags: also write each "
                        "split's report to <out-prefix><split>.txt")
    p.add_argument("--platform", default="default", choices=["default", "cpu"],
                   help="'default' evaluates on the CUDA card (and fails "
                        "without one); 'cpu' on the CPU")
    return p.parse_args(argv)


def run_config(args: argparse.Namespace) -> TrainConfig:
    """The evaluation's config: each model and data flag from the command
    line, else from the run's config.json, else the JAX script's default;
    ``args`` is filled in with the values chosen."""
    stored = None
    path = os.path.join(args.run, "config.json")
    if os.path.isfile(path):
        stored = load_config(path)

    def pick(cli, section, name, default):
        if cli is not None:
            return cli
        if stored is not None:
            return getattr(getattr(stored, section), name)
        return default

    args.arch = pick(args.arch, "model", "arch", "resnet18_multistage")
    args.decoder = pick(args.decoder, "model", "decoder", "upproj")
    args.dtype = pick(args.dtype, "model", "dtype", "bfloat16")
    args.filter_mode = pick(args.filter_mode, "model", "filter_mode", "abs")
    args.abs_threshold = pick(args.abs_threshold, "model", "abs_threshold",
                              2.0)
    args.rel_threshold = pick(args.rel_threshold, "model", "rel_threshold",
                              0.15)
    args.stage2_coarse = bool(pick(args.stage2_coarse, "model",
                                   "stage2_coarse", False))
    args.height = pick(args.height, "data", "height", 450)
    args.width = pick(args.width, "data", "width", 800)
    args.sweeps = pick(args.sweeps, "data", "num_sweeps", 5)
    return TrainConfig(
        data=DataConfig(
            dataset="packed", data_root=args.data_root, height=args.height,
            width=args.width, num_sweeps=args.sweeps,
            height_extension=pick(None, "data", "height_extension", 0),
            raster_backend=pick(None, "data", "raster_backend", "sorted")),
        model=ModelConfig(arch=args.arch, decoder=args.decoder,
                          dtype=args.dtype, filter_mode=args.filter_mode,
                          abs_threshold=args.abs_threshold,
                          rel_threshold=args.rel_threshold,
                          stage2_coarse=args.stage2_coarse),
        batch_size=args.batch)


class TwoStageEval:
    """A run's Predictor (``plain=True``: the kernels' plain versions, the
    reference a run on the card is held against) over the run's packed val
    split, evaluated one split tag at a time."""

    def __init__(self, args: argparse.Namespace, plain: bool = False):
        self.args = args
        device = resolve_device("cpu" if args.platform == "cpu" else None)
        cfg = run_config(args)
        self.pred = Predictor.from_run(args.run, cfg, device=device,
                                       plain=plain)
        if not self.pred.arch_spec.multistage:
            raise ValueError(f"{args.arch} has one stage: the tool compares "
                             "a two-stage run's coarse and refined outputs")
        # the training-time rasterization: a run trained with radar height
        # extension evaluated without it sees other radar maps
        self.pre = PreprocessConfig(
            spec=cfg.data.sample_spec(),
            height_extension=cfg.data.height_extension,
            raster_backend=cfg.data.raster_backend)
        self.ds = PackedDataset(os.path.join(args.data_root, "val"))

    @torch.inference_mode()
    def infer_both(self, batch):
        """One padded batch -> coarse, refined, target, radar (B, H, W, 1)
        and the efficacy counts (EFFICACY order), on the device."""
        a, p = self.args, self.pred
        prepared = prepare_eval_batch(batch, self.pre, p.device,
                                      plain=p.plain)
        out = p.model(*pack_model_inputs(prepared, p.arch_spec.input_kind,
                                         p.cfg.modality))
        coarse, refined = out[0], out[1]  # uncertainty appends log-vars
        radar, target = prepared["radar"], prepared["target"]
        # the model's keep-mask, and each radar pixel with a GT classified
        # corrupt (disagrees with it) or clean
        kept = filter_radar_by_prediction(
            radar, coarse, abs_threshold=a.abs_threshold,
            rel_threshold=a.rel_threshold, mode=a.filter_mode) > 0
        has_gt = (radar > 0) & (target > 0)
        err = (radar - target).abs()
        corrupt = has_gt & (err > 2.0) & (err / target.clamp_min(1e-3) > 0.15)
        clean = has_gt & ~corrupt
        eff = torch.stack([(radar > 0).sum(), has_gt.sum(), corrupt.sum(),
                           (corrupt & kept).sum(), clean.sum(),
                           (clean & kept).sum()])
        return coarse, refined, target, radar, eff

    @torch.inference_mode()
    def split(self, split: str) -> tuple:
        """One split's report lines and whether it had samples."""
        a, ds = self.args, self.ds
        if split and split != "all":
            # Ragged tails are padded by repeating the last sample with a
            # zeroed target (pad_batch_to), which the masked metrics and
            # the efficacy counts (has_gt needs target > 0) skip;
            # radar_px alone counts padded returns.
            indices = [i for i in range(len(ds)) if ds.sample_tag(i) == split]
            if not indices:
                return [f"no samples tagged {split!r}"], False
        else:
            indices = list(range(len(ds)))
        if not indices:
            return [f"no samples in split {split or 'all'!r} "
                    f"(empty val set at {a.data_root})"], False

        n, r = len(indices), a.radius
        sums = dict.fromkeys(OUTPUTS)
        eff_tot = 0
        for i0 in range(0, n, a.batch):
            batch, _ = pad_batch_to(ds.batch(indices[i0:i0 + a.batch]),
                                    a.batch)
            coarse, refined, target, radar, eff = self.infer_both(batch)
            eff_tot = eff_tot + eff
            # radar-local: the radar-return pixels dilated by the radius
            occ = (radar > 0).float().permute(0, 3, 1, 2)
            local = F.max_pool2d(occ, 2 * r + 1, stride=1,
                                 padding=r).permute(0, 2, 3, 1) > 0
            t_local = torch.where(local, target, torch.zeros_like(target))
            for name, pred, tgt in (
                    ("coarse", coarse, target), ("refined", refined, target),
                    ("coarse_radar_local", coarse, t_local),
                    ("refined_radar_local", refined, t_local)):
                s = compute_metric_sums(pred, tgt, a.metric_avg)
                sums[name] = (s if sums[name] is None
                              else accumulate_metric_sums(sums[name], s))

        out = {k: finalize_metrics(v) for k, v in sums.items()}
        lines = [f"run={a.run} filter={a.filter_mode} "
                 f"(abs={a.abs_threshold}, rel={a.rel_threshold}) "
                 f"val n={n}" + (f" split={split}" if split else "")]
        lines.append(f"{'output':24s} " + " ".join(f"{k:>8s}" for k in KEYS))
        for name in OUTPUTS:
            row = out[name]
            lines.append(f"{name:24s} "
                         + " ".join(f"{row[k]:8.4f}" for k in KEYS))
        # sorted by name, as the JAX script's tree_map leaves them
        e = dict(sorted(zip(EFFICACY, (int(v) for v in eff_tot.tolist()))))
        drop_c = 1 - e["corrupt_kept"] / max(e["corrupt_px"], 1)
        drop_k = 1 - e["clean_kept"] / max(e["clean_px"], 1)
        lines.append(
            f"filter efficacy (GT-checkable radar px {e['gt_px']} of "
            f"{e['radar_px']}): corrupt {e['corrupt_px']} px, "
            f"{drop_c:.1%} dropped; clean {e['clean_px']} px, "
            f"{drop_k:.1%} dropped (false positives)")
        out["filter_efficacy"] = e
        lines.append(json.dumps({k: ({m: round(float(v[m]), 5) for m in KEYS}
                                     if k != "filter_efficacy" else v)
                                 for k, v in out.items()}))
        return lines, True


def main(argv=None, plain: bool = False) -> int:
    """The command line; ``plain`` runs the kernels' plain versions."""
    args = parse_args(argv)
    ev = TwoStageEval(args, plain=plain)
    splits = ([s.strip() for s in args.split.split(",") if s.strip()]
              if args.split else [""])
    ok = True
    try:
        for split in splits:
            lines, good = ev.split(split)
            ok = ok and good
            text = "\n".join(lines) + "\n"
            sys.stdout.write(text)
            sys.stdout.flush()
            if args.out_prefix and good:
                with open(f"{args.out_prefix}{split or 'all'}.txt", "w") as f:
                    f.write(text)
    finally:
        ev.ds.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
