"""Configuration of the port: the JAX package's config tree
(``radar_depth_tpu/config.py``) with the same names, defaults, JSON schema
and command line, and the serving subset ``ServeConfig``.

A ``config.json`` written by either package loads in the other
(``save_config`` / ``load_config``). Every flag and choice of the JAX CLI
parses here and runs, except ``--spatial`` > 1, which parses and loads and
for which ``require_ported`` (called by the Trainer and
``Predictor.from_run``) raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Tuple

import torch

from radar_depth_tpu_torch.data.schema import SampleSpec
from radar_depth_tpu_torch.ops.augment import AugmentConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The JAX package's registry names and choices, for the CLI (the port's own
# registry, ``models.ARCH_REGISTRY``, holds the same archs).
ARCH_NAMES = (
    "resnet18", "resnet34", "resnet50",
    "resnet18_latefusion", "resnet34_latefusion", "resnet50_latefusion",
    "resnet18_multistage", "resnet34_multistage", "resnet50_multistage",
    "resnet18_multistage_uncertainty", "resnet34_multistage_uncertainty",
)
MODALITIES = ("rgb", "rgbd", "d")
DECODER_NAMES = ("deconv2", "deconv3", "upconv", "upproj")


def _check_dtype(dtype: str) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"dtype={dtype!r}: expected one of {sorted(DTYPES)}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    arch: str = "resnet18_latefusion"
    modality: str = "rgbd"  # for single-branch archs: rgb | rgbd | d
    decoder: str = "upproj"
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    height: int = 450
    width: int = 800
    num_sweeps: int = 5
    max_depth: float = 80.0
    height_extension: int = 0
    raster_backend: str = "sorted"  # z-buffer: sorted (kernel C) | scatter
    # two-stage radar filter (multistage archs)
    filter_mode: str = "abs"
    abs_threshold: float = 2.0
    rel_threshold: float = 0.15
    # feed the coarse prediction to stage 2 as a second radar channel
    stage2_coarse: bool = False
    # >0: emit refined where the mean RGB < tau, coarse where brighter
    blend_tau: float = 0.0

    def __post_init__(self):
        _check_dtype(self.dtype)

    def sample_spec(self) -> SampleSpec:
        return SampleSpec(height=self.height, width=self.width,
                          num_sweeps=self.num_sweeps, max_depth=self.max_depth)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def arch_kwargs(self) -> dict:
        """The arch-specific ``models.create_model`` arguments: the
        modality (which only the single-branch archs read), and the radar
        filter and ``stage2_coarse`` of the multistage archs."""
        if "multistage" not in self.arch:
            return dict(modality=self.modality)
        return dict(modality=self.modality, filter_mode=self.filter_mode,
                    abs_threshold=self.abs_threshold,
                    rel_threshold=self.rel_threshold,
                    stage2_coarse=self.stage2_coarse)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"  # synthetic | packed (binary shards on disk)
    data_root: str = ""  # for packed datasets
    height: int = 450
    width: int = 800
    num_sweeps: int = 5
    max_depth: float = 80.0
    height_extension: int = 0
    num_train: int = 256  # synthetic split sizes
    num_val: int = 64
    seed: int = 0
    sparsifier: str = "none"  # none | uar | sim_stereo
    num_samples: int = 200
    raster_backend: str = "sorted"  # z-buffer: sorted (kernel C) | scatter
    # LiDAR GT under in-graph train augmentation: warp | rerasterize
    gt_augment: str = "warp"

    def sample_spec(self) -> SampleSpec:
        return SampleSpec(height=self.height, width=self.width,
                          num_sweeps=self.num_sweeps, max_depth=self.max_depth)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "resnet18_latefusion"
    modality: str = "rgbd"  # for single-branch archs: rgb | rgbd | d
    decoder: str = "upproj"
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    filter_mode: str = "abs"
    abs_threshold: float = 2.0
    rel_threshold: float = 0.15
    pretrained: str = ""  # converted torchvision weights
    stage1_path: str = ""  # init both multistage stages from a late-fusion run
    remat: bool = False
    stage2_coarse: bool = False
    blend_tau: float = 0.0

    def __post_init__(self):
        _check_dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_decay_epochs: int = 5  # step decay x factor every N epochs
    lr_decay_factor: float = 0.1
    criterion: str = "l1"  # l1 | l2
    stage_weights: Tuple[float, float] = (1.0, 1.0)
    # micro-batches averaged per optimizer step; BN statistics update per
    # micro-batch
    grad_accum: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    data: DataConfig = DataConfig()
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig()
    augment: AugmentConfig = AugmentConfig()
    batch_size: int = 8
    # val-pass batch size (0 = batch_size); with metric_avg "batch" it is the
    # pooling granularity, so it changes rmse/irmse slightly
    eval_batch_size: int = 0
    workers: int = 0  # native-loader threads (0 = 4)
    epochs: int = 15
    seed: int = 42
    output_dir: str = "runs/default"
    resume: str = ""
    init_from: str = ""  # warm start: params and BN statistics only
    evaluate: str = ""
    print_freq: int = 10
    val_viz_every: int = 50  # comparison PNG row every N val batches
    # "batch": the reference's AverageMeter weighting; "sample": per-sample
    # means (batch-size invariant)
    metric_avg: str = "batch"
    eval_splits: bool = False  # --evaluate also reports day/night splits
    tensorboard: bool = False
    mesh_axis: str = "data"
    stall_timeout: float = 3600.0  # exit 86 without progress; 0 disables
    ckpt_every: int = 1
    spatial: int = 1
    # "default": the CUDA card (raises without one); "cpu": the CPU. A host
    # knob, not adopted from a run's config.json.
    platform: str = "default"


# ------------------------------------------------------------------ ported?


def unported(cfg: TrainConfig) -> List[str]:
    """The settings of ``cfg`` that the port does not run yet, each with the
    ROADMAP item that ports it: ``--spatial`` alone."""
    if cfg.spatial > 1:
        return [f"--spatial {cfg.spatial} (ROADMAP Queue A item 10)"]
    return []


def require_ported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for any setting the port does not run."""
    missing = unported(cfg)
    if missing:
        raise NotImplementedError(
            "not ported to radar_depth_tpu_torch yet: " + "; ".join(missing))


def serve_config(cfg: TrainConfig) -> ServeConfig:
    """The serving subset of a training run's config."""
    d, m = cfg.data, cfg.model
    return ServeConfig(
        arch=m.arch, modality=m.modality, decoder=m.decoder, dtype=m.dtype,
        height=d.height,
        width=d.width, num_sweeps=d.num_sweeps, max_depth=d.max_depth,
        height_extension=d.height_extension, raster_backend=d.raster_backend,
        filter_mode=m.filter_mode, abs_threshold=m.abs_threshold,
        rel_threshold=m.rel_threshold, stage2_coarse=m.stage2_coarse,
        blend_tau=m.blend_tau)


# ------------------------------------------------------------- config.json


def save_config(cfg: TrainConfig, path: str) -> None:
    """The whole tree as JSON, in the JAX package's schema."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)


def _known_fields(cls, d: dict) -> dict:
    """Keep only the keys ``cls`` defines: a config.json of another version
    loads, unknown keys dropped, missing ones at their defaults."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def load_config(path: str) -> TrainConfig:
    """Inverse of ``save_config``, tolerant of other versions."""
    with open(path) as f:
        d = json.load(f)
    optim = _known_fields(OptimConfig, d.get("optim", {}))
    if "stage_weights" in optim:
        optim["stage_weights"] = tuple(optim["stage_weights"])
    aug = _known_fields(AugmentConfig, d.get("augment", {}))
    if "scale_range" in aug:
        aug["scale_range"] = tuple(aug["scale_range"])
    top = _known_fields(TrainConfig, {
        k: v for k, v in d.items()
        if k not in ("data", "model", "optim", "augment")})
    return TrainConfig(
        data=DataConfig(**_known_fields(DataConfig, d.get("data", {}))),
        model=ModelConfig(**_known_fields(ModelConfig, d.get("model", {}))),
        optim=OptimConfig(**optim), augment=AugmentConfig(**aug), **top)


# argparse dest -> path in config.json, for the flags a run's config.json
# supplies at --evaluate/--resume when the command line leaves them at their
# default (an explicit non-default flag wins)
_RUN_CONFIG_FLAGS = {
    "arch": ("model", "arch"), "modality": ("model", "modality"),
    "decoder": ("model", "decoder"), "dtype": ("model", "dtype"),
    "filter_mode": ("model", "filter_mode"),
    "abs_threshold": ("model", "abs_threshold"),
    "rel_threshold": ("model", "rel_threshold"),
    "stage2_coarse": ("model", "stage2_coarse"),
    "blend_tau": ("model", "blend_tau"),
    "height": ("data", "height"), "width": ("data", "width"),
    "num_sweeps": ("data", "num_sweeps"), "max_depth": ("data", "max_depth"),
    "height_extension": ("data", "height_extension"),
    "sparsifier": ("data", "sparsifier"),
    "num_samples": ("data", "num_samples"),
    "raster_backend": ("data", "raster_backend"),
    "gt_augment": ("data", "gt_augment"),
    "dataset": ("data", "dataset"), "data_root": ("data", "data_root"),
    "num_train": ("data", "num_train"), "num_val": ("data", "num_val"),
    "batch_size": ("batch_size",), "eval_batch_size": ("eval_batch_size",),
    "metric_avg": ("metric_avg",),
}


def run_dir_of(path: str) -> str:
    """The run directory of a path given to --evaluate/--resume: the run
    itself, its ``checkpoints/`` or one numeric step directory in it."""
    path = path.rstrip(os.sep) or path
    if os.path.basename(path).isdigit():
        path = os.path.dirname(path)
    if os.path.basename(path) == "checkpoints":
        path = os.path.dirname(path)
    return path


def _adopt_run_config(a, parser) -> None:
    """For --evaluate/--resume: fill the model and data flags left at their
    defaults from the run's config.json."""
    path = os.path.join(run_dir_of(a.evaluate or a.resume), "config.json")
    if not os.path.isfile(path):
        if "multistage" in a.arch:
            # the filter has no parameters, so a restore with the wrong
            # filter flags succeeds and evaluates a different graph
            print(f"warning: {path} not found — cannot recover the run's "
                  "filter flags; make sure --filter-mode/--*-threshold"
                  "/--stage2-coarse match how it was trained")
        return
    with open(path) as f:
        saved = json.load(f)
    for dest, keys in _RUN_CONFIG_FLAGS.items():
        if getattr(a, dest) != parser.get_default(dest):
            continue
        node = saved
        try:
            for k in keys:
                node = node[k]
        except KeyError:
            continue  # a config.json without this field
        setattr(a, dest, node)
    if not a.no_augment and not saved.get("augment", {}).get("enabled", True):
        a.no_augment = True


def parse_command(argv=None) -> TrainConfig:
    """The JAX package's CLI (the reference's ``parse_command``), flag for
    flag."""
    p = argparse.ArgumentParser(
        description="radar_depth_tpu_torch training harness")
    p.add_argument("--arch", default="resnet18_latefusion",
                   choices=sorted(ARCH_NAMES))
    p.add_argument("--modality", default="rgbd", choices=sorted(MODALITIES))
    p.add_argument("--decoder", default="upproj", choices=list(DECODER_NAMES))
    p.add_argument("-c", "--criterion", default="l1", choices=["l1", "l2"])
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--eval-batch-size", type=int, default=0,
                   help="val-pass batch size (0 = same as --batch-size)")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--workers", type=int, default=0,
                   help="native-loader threads (0 = 4)")
    p.add_argument("--resume", default="", metavar="CKPT")
    p.add_argument("--init-from", default="", metavar="RUN",
                   help="warm-start params from a same-arch run (fresh "
                        "optimizer/epoch; cf. --resume)")
    p.add_argument("--evaluate", default="", metavar="CKPT")
    p.add_argument("--output-dir", default="runs/default")
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--stall-timeout", type=float, default=3600.0,
                   help="exit 86 (resumable) if no batch completes for this "
                        "many seconds; 0 disables")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="save a checkpoint every k-th epoch (best-RMSE "
                        "improvements and the final epoch always save)")
    p.add_argument("--spatial", type=int, default=1,
                   help="shard image height over this many devices (not "
                        "ported)")
    p.add_argument("--seed", type=int, default=42)
    # data
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "packed"])
    p.add_argument("--data-root", default="")
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--num-sweeps", type=int, default=5)
    p.add_argument("--max-depth", type=float, default=80.0)
    p.add_argument("--height-extension", type=int, default=0)
    p.add_argument("--sparsifier", default="none",
                   choices=["none", "uar", "sim_stereo"])
    p.add_argument("--num-samples", type=int, default=200,
                   help="sparsifier target sample count")
    p.add_argument("--raster-backend", default="sorted",
                   choices=["sorted", "scatter"],
                   help="z-buffer: sorted (sort + kernel C) or scatter "
                        "(kernel A)")
    p.add_argument("--gt-augment", default="warp",
                   choices=["warp", "rerasterize"],
                   help="GT under in-graph augmentation: warp the stored map "
                        "or re-project the LiDAR points")
    p.add_argument("--no-augment", action="store_true",
                   help="disable train-time augmentation")
    p.add_argument("--num-train", type=int, default=256)
    p.add_argument("--num-val", type=int, default=64)
    # model
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--filter-mode", default="abs", choices=["abs", "rel", "or"])
    p.add_argument("--abs-threshold", type=float, default=2.0)
    p.add_argument("--rel-threshold", type=float, default=0.15)
    p.add_argument("--blend-tau", type=float, default=0.0,
                   help="emit refined where the per-sample mean RGB < tau, "
                        "coarse where brighter; 0 disables")
    p.add_argument("--pretrained", default="")
    p.add_argument("--stage1-path", default="")
    p.add_argument("--remat", action="store_true",
                   help="recompute multistage stages in backward")
    p.add_argument("--stage2-coarse", action="store_true",
                   help="feed the coarse prediction to stage 2 as an extra "
                        "radar-branch channel")
    p.add_argument("--multistage-uncertainty", action="store_true",
                   help="learned per-stage log-variance loss weighting")
    p.add_argument("--stage-weights", type=float, nargs=2, default=[1.0, 1.0],
                   metavar=("W1", "W2"),
                   help="loss = W1*l(coarse) + W2*l(refined)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches averaged per optimizer step")
    # schedule
    p.add_argument("--lr-decay-epochs", type=int, default=5)
    p.add_argument("--lr-decay-factor", type=float, default=0.1)
    # metrics
    p.add_argument("--metric-avg", default="batch",
                   choices=["sample", "batch"],
                   help="'batch' = reference AverageMeter weighting; "
                        "'sample' = batch-size-invariant per-sample means")
    p.add_argument("--eval-splits", action="store_true",
                   help="report per-split (day/night) metrics at --evaluate")
    p.add_argument("--platform", default="default", choices=["default", "cpu"],
                   help="'default' runs on the CUDA card (and fails without "
                        "one); 'cpu' runs on the CPU")
    a = p.parse_args(argv)
    if a.evaluate or a.resume:
        _adopt_run_config(a, p)
    if a.multistage_uncertainty:
        if not a.arch.endswith("_multistage"):
            p.error("--multistage-uncertainty requires a *_multistage arch")
        a.arch += "_uncertainty"
    return TrainConfig(
        data=DataConfig(
            dataset=a.dataset, data_root=a.data_root, height=a.height,
            width=a.width, num_sweeps=a.num_sweeps, max_depth=a.max_depth,
            height_extension=a.height_extension, num_train=a.num_train,
            num_val=a.num_val, seed=a.seed,
            sparsifier=a.sparsifier, num_samples=a.num_samples,
            raster_backend=a.raster_backend, gt_augment=a.gt_augment,
        ),
        model=ModelConfig(
            arch=a.arch, modality=a.modality, decoder=a.decoder, dtype=a.dtype,
            filter_mode=a.filter_mode, abs_threshold=a.abs_threshold,
            rel_threshold=a.rel_threshold, pretrained=a.pretrained,
            stage1_path=a.stage1_path, remat=a.remat,
            stage2_coarse=a.stage2_coarse, blend_tau=a.blend_tau,
        ),
        optim=OptimConfig(
            lr=a.lr, momentum=a.momentum, weight_decay=a.weight_decay,
            lr_decay_epochs=a.lr_decay_epochs,
            lr_decay_factor=a.lr_decay_factor,
            criterion=a.criterion, grad_accum=a.grad_accum,
            stage_weights=tuple(a.stage_weights),
        ),
        augment=AugmentConfig(enabled=not a.no_augment),
        batch_size=a.batch_size, eval_batch_size=a.eval_batch_size,
        workers=a.workers, epochs=a.epochs, seed=a.seed,
        output_dir=a.output_dir, resume=a.resume, init_from=a.init_from,
        evaluate=a.evaluate,
        print_freq=a.print_freq, tensorboard=a.tensorboard,
        metric_avg=a.metric_avg, eval_splits=a.eval_splits,
        spatial=a.spatial, stall_timeout=a.stall_timeout,
        ckpt_every=a.ckpt_every,
        platform=a.platform,
    )
