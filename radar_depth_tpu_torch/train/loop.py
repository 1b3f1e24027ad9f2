"""Epoch loops of the port (``radar_depth_tpu/train/loop.py``): the Trainer
builds the model, optimizer and data once and runs epochs of train steps,
validation, CSV rows, best tracking and checkpoints, on one device or, under
``torchrun``, data-parallel over the ranks' devices.

Data parallelism (``parallel/mesh.py``): the mesh comes from the
environment (one rank per card, ``cuda:LOCAL_RANK``, NCCL; gloo with
``--platform cpu``); without ``RANK``/``WORLD_SIZE`` there is no process
group and the run is the single-process one. ``batch_size`` and
``eval_batch_size`` are global and must split evenly over the ranks. Every
rank builds the same model and broadcasts rank 0's weights after any
loading; every rank reads the global batch from its own loader and keeps
its rows (the native loader keys its host augmentation by sample, so the
rows are what a single process draws); a ragged last val batch is padded
(``pad_batch_to``) before the split. The steps make BN statistics, losses
and metrics global and sum the gradients (``train/step.py``), so the
replicas stay bit-equal, which the end of a run checks. Rank 0 alone
writes the run directory (lock, config.json, CSVs, best.txt, checkpoints,
TensorBoard, panels) and prints.

Spatial partitioning (``--spatial S``, ``parallel/spatial.py``): the ranks
form a (data, space) mesh of world // S by S (``make_spatial_mesh``); the
batch sizes split over the data axis, the S ranks of a space group read
the same rows and each runs its slab of image rows through the model.

Timing fields keep the reference's Result.data_time / gpu_time: data_time is
the host's batch assembly per step, gpu_time the device time per step, read
at the sync points as (window wall - window host time) / steps, since the
device runs the steps of a window back to back.

Randomness: the weights come from a generator seeded with ``cfg.seed``; the
in-graph augmentation of epoch e draws from the Trainer's one
``torch.Generator``, seeded again from (``cfg.seed``, e) at the start of
the epoch (one object, so the train step's CUDA graph, which registers it,
is captured once a run, as the JAX step is compiled once with the epoch in
its key argument), and the native loader of epoch e is a new loader
seeded ``cfg.seed + G*e`` (G the loader's golden-ratio constant), which
shuffles as the JAX package's one loader does in its epoch e. So a run
resumed at an epoch boundary draws what the uninterrupted run drew. The
host augmentation of epochs after the first differs from the JAX package's:
its loader keys the augmentation by its own epoch counter, which a new
loader starts at 0.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Iterable

import numpy as np
import torch
from torch import nn

from radar_depth_tpu_torch.config import (
    TrainConfig,
    require_ported,
    save_config,
    serve_config,
)
from radar_depth_tpu_torch.data.synthetic import SyntheticNuScenes
from radar_depth_tpu_torch.device import use_deterministic_convs
from radar_depth_tpu_torch.metrics import AverageMeter, finalize_metrics
from radar_depth_tpu_torch.models import create_model
from radar_depth_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose,
    UnpoolConv,
)
from radar_depth_tpu_torch.parallel.mesh import (
    assert_replicated,
    broadcast_module,
    check_batch_sizes,
    destroy_mesh,
    local_rows,
    make_mesh,
    make_spatial_mesh,
    pad_batch_to,
)
from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
from radar_depth_tpu_torch.train.state import create_train_state
from radar_depth_tpu_torch.train.step import (
    make_eval_step,
    make_predict_fn,
    make_train_step,
)
from radar_depth_tpu_torch.utils.csvlog import EpochCSVLogger, write_best_txt
from radar_depth_tpu_torch.utils.runlock import acquire_run_lock, release_run_lock
from radar_depth_tpu_torch.utils.viz import add_row, comparison_panel, save_image
from radar_depth_tpu_torch.utils.watchdog import StallWatchdog

GOLDEN = 0x9E3779B97F4A7C15  # rdtp_loader.cc's per-epoch shuffle stride
_U64 = (1 << 64) - 1


def should_checkpoint(epoch: int, improved: bool, every: int,
                      total_epochs: int) -> bool:
    """--ckpt-every: improvements and the final epoch always save; otherwise
    every ``every``-th epoch, anchored on the final one. every <= 1 saves
    each epoch (the reference)."""
    if improved or epoch == total_epochs - 1 or every <= 1:
        return True
    return (total_epochs - 1 - epoch) % every == 0


def make_datasets(cfg: TrainConfig):
    if cfg.data.dataset == "synthetic":
        spec = cfg.data.sample_spec()
        train = SyntheticNuScenes(cfg.data.num_train, spec=spec,
                                  seed=cfg.data.seed)
        val = SyntheticNuScenes(cfg.data.num_val, spec=spec,
                                seed=cfg.data.seed + 1)
        return train, val
    if cfg.data.dataset == "packed":
        from radar_depth_tpu_torch.data.packed import PackedDataset

        train = PackedDataset(os.path.join(cfg.data.data_root, "train"))
        val = PackedDataset(os.path.join(cfg.data.data_root, "val"))
        return train, val
    raise ValueError(cfg.data.dataset)


def iterate_batches(dataset, batch_size: int, shuffle: bool, seed: int,
                    drop_last: bool, indices=None) -> Iterable[Dict]:
    """Batches of ``dataset`` in order, or shuffled by numpy's generator
    seeded ``seed`` (the JAX package's order)."""
    order = (np.asarray(list(indices)) if indices is not None
             else np.arange(len(dataset)))
    n = len(order)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        yield dataset.batch(order[i: i + batch_size])


def build_model(cfg: TrainConfig, device) -> tuple:
    """(model, ArchSpec) of a run on ``device``: float32 weights computing
    in ``cfg.model.dtype``, with the arch flags of ``serve_config`` and, for
    the multistage archs, ``--remat``."""
    kw = serve_config(cfg).arch_kwargs()
    if "multistage" in cfg.model.arch:
        kw["remat"] = cfg.model.remat
    return create_model(cfg.model.arch, device=device,
                        decoder=cfg.model.decoder,
                        output_size=(cfg.data.height, cfg.data.width),
                        dtype=cfg.model.torch_dtype,
                        param_dtype=torch.float32, **kw)


def init_model(model: nn.Module, seed: int) -> nn.Module:
    """Fresh weights with flax's initializers, drawn from a CPU generator
    seeded ``seed``: convs truncated-normal lecun (fan-in), the unpool and
    transposed convs He; BN scale 1, bias 0, running mean 0, variance 1;
    the uncertainty archs' ``stage_log_var`` 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        if getattr(model, "stage_log_var", None) is not None:
            model.stage_log_var.zero_()
        for m in model.modules():
            if isinstance(m, Conv2d):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                gain = 2.0 if isinstance(m, (UnpoolConv, ConvTranspose)) else 1.0
                # the std of a unit normal truncated at +-2
                std = math.sqrt(gain / fan_in) / 0.87962566103423978
                v = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                w.copy_(v)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


def widen_to_template(template: torch.Tensor, src: torch.Tensor,
                      name: str = "") -> torch.Tensor:
    """``src`` in ``template``'s shape: equal shapes copy; a conv weight
    (O, I, kh, kw) whose input-channel axis is wider in ``template`` gets
    zeros on the extra channels (``radar_depth_tpu/train/loop.py::
    _widen_to_template``). Any other mismatch raises."""
    if template.shape == src.shape:
        return src
    if (template.dim() == src.dim() == 4 and template.shape[0] == src.shape[0]
            and template.shape[2:] == src.shape[2:]
            and template.shape[1] > src.shape[1]):
        pad = torch.zeros((src.shape[0], template.shape[1] - src.shape[1],
                           *src.shape[2:]), dtype=src.dtype)
        return torch.cat([src, pad], dim=1)
    raise ValueError(
        f"stage checkpoint {name}: shape {tuple(src.shape)} does not fit "
        f"{tuple(template.shape)} (only input-channel widening is supported)")


def _fetch(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device sums -> host floats in one copy (the one wait)."""
    keys = list(sums)
    vals = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def _add(acc, new):
    return new if acc is None else {k: acc[k] + new[k] for k in acc}


def check_spatial(cfg: TrainConfig) -> None:
    """The JAX Trainer's checks of ``--spatial``, with its messages: the
    H/32 bottleneck at least 3 rows (where GSPMD mis-partitioned the
    backward; the port's exchange is exact there, and keeps the limit so
    both packages take the same runs), and the height divisible by the
    space axis."""
    if cfg.data.height // 32 < 3:
        raise ValueError(
            f"--spatial requires height >= 96 (got {cfg.data.height}"
            "): bottleneck feature maps shorter than 3 rows "
            "mis-partition the backward pass")
    if cfg.data.height % cfg.spatial:
        raise ValueError(
            f"height={cfg.data.height} is not divisible by "
            f"--spatial {cfg.spatial}")


class Trainer:
    """Builds the model, optimizer, mesh and data once, runs epochs (the
    reference's main.py::main), on the card unless ``cfg.platform`` is
    "cpu"; data-parallel under ``torchrun`` (module docstring)."""

    def __init__(self, cfg: TrainConfig):
        require_ported(cfg)
        self.cfg = cfg
        platform = "cpu" if cfg.platform == "cpu" else "default"
        if cfg.spatial > 1:
            check_spatial(cfg)
            self.mesh = make_spatial_mesh(cfg.spatial, platform)
        else:
            self.mesh = make_mesh(platform, axis=cfg.mesh_axis)
        self.device = self.mesh.device
        self._main = self.mesh.is_main
        check_batch_sizes(self.mesh, batch_size=cfg.batch_size,
                          eval_batch_size=cfg.eval_batch_size)
        # deterministic cuDNN convolutions: with the matmul resize
        # (models/layers.py) a train step on the card gives the same bits
        # every run, so --resume reproduces the straight run
        use_deterministic_convs(self.device)
        if (cfg.metric_avg == "batch"
                and cfg.eval_batch_size not in (0, cfg.batch_size)):
            self.say("note: --metric-avg batch pools metrics per loop batch "
                     f"(reference Result.evaluate), so --eval-batch-size "
                     f"{cfg.eval_batch_size} != {cfg.batch_size} shifts "
                     "rmse/irmse vs reference-batch-size numbers")
        self.model, self.arch_spec = build_model(cfg, self.device)
        if cfg.optim.grad_accum < 1:
            raise ValueError(f"grad_accum={cfg.optim.grad_accum} must be >= 1")
        self._accum = cfg.optim.grad_accum
        self.train_ds, self.val_ds = make_datasets(cfg)
        if (not cfg.evaluate
                and len(self.train_ds) < cfg.batch_size * self._accum):
            raise ValueError(
                f"effective batch {cfg.batch_size} x grad_accum "
                f"{self._accum} = {cfg.batch_size * self._accum} exceeds the "
                f"{len(self.train_ds)}-sample train split — every epoch "
                "would run zero optimizer steps")
        # the LR decay counts optimizer steps
        steps_per_epoch = max(
            1, len(self.train_ds) // (cfg.batch_size * self._accum))
        # augmentation in the native loader's threads when it can run there;
        # the step then skips the in-graph warps
        self.reader = ("native" if getattr(self.train_ds, "native", False)
                       else "memmap" if cfg.data.dataset == "packed"
                       else "synthetic")
        self.host_augment = (cfg.augment.enabled
                              and cfg.data.sparsifier == "none"
                              and self.reader == "native")
        if cfg.data.dataset == "packed" and self.reader != "native":
            from radar_depth_tpu_torch.data.packed import native_error

            self.say(f"note: packed data through the numpy reader, "
                     f"augmentation in the step ({native_error()})")

        init_model(self.model, cfg.seed)
        if cfg.model.pretrained:
            self._load_pretrained(cfg.model.pretrained)
        self.state = create_train_state(self.model, cfg.optim,
                                        steps_per_epoch)
        self._train_step = make_train_step(
            self.model, self.arch_spec, cfg,
            host_augmented=self.host_augment, mesh=self.mesh)
        self._eval_step = make_eval_step(self.model, self.arch_spec, cfg,
                                         mesh=self.mesh)
        self._predict = make_predict_fn(self.model, self.arch_spec, cfg)
        # the step's one generator, reseeded each epoch (_epoch_generator)
        self._generator = torch.Generator(device=self.device)
        self._loaders: Dict[int, object] = {}

        self._run_lock = None
        self.train_log = self.val_log = None
        if self._main:
            os.makedirs(cfg.output_dir, exist_ok=True)
            if not cfg.evaluate:
                # exclusive writer; --evaluate is read-only, takes no lock
                self._run_lock = acquire_run_lock(cfg.output_dir)
                save_config(cfg, os.path.join(cfg.output_dir, "config.json"))
            self.train_log = EpochCSVLogger(os.path.join(cfg.output_dir,
                                                         "train.csv"))
            self.val_log = EpochCSVLogger(os.path.join(cfg.output_dir,
                                                       "test.csv"))
        # read-only openers never sweep a live writer's save in flight
        self.ckpt = ckpt_lib.CheckpointManager(cfg.output_dir,
                                               sweep_stale=not cfg.evaluate,
                                               mesh=self.mesh)
        self.tboard = None
        if cfg.tensorboard and self._main:
            from radar_depth_tpu_torch.utils.tboard import TensorBoardLogger

            self.tboard = TensorBoardLogger(os.path.join(cfg.output_dir, "tb"))
        self.best_rmse = float("inf")
        self.start_epoch = 0
        self.history: list = []  # per epoch: walls, metrics, checkpoint
        self.saves: list = []  # per checkpoint: times and bytes
        self._watchdog = None

    def say(self, *args) -> None:
        """Print on rank 0 only."""
        if self._main:
            print(*args)

    def _load_pretrained(self, path: str):
        """--pretrained FILE: a torchvision ImageNet ResNet state_dict (a
        ``torch.save`` file on disk; nothing is downloaded) grafted into
        every encoder (``convert.graft_pretrained_encoders``)."""
        from radar_depth_tpu_torch.convert import graft_pretrained_encoders

        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        grafted, report = graft_pretrained_encoders(self.model.state_dict(),
                                                    sd)
        self.model.load_state_dict(grafted)
        self.pretrained_report = report
        for subtree, loaded, skipped in report:
            note = f"; skipped {len(skipped)}: {skipped[:3]}" if skipped else ""
            self.say(f"pretrained: {subtree}: loaded {loaded} tensors{note}")

    # ------------------------------------------------------------- resume

    def maybe_resume(self):
        if self.cfg.resume:
            # read-only: the run lock covers only output_dir, and a --resume
            # from another run must not sweep that run's save in flight
            _, epoch, best_rmse = ckpt_lib.CheckpointManager(
                self.cfg.resume, sweep_stale=False).restore(self.state)
            self.start_epoch = epoch + 1
            self.best_rmse = best_rmse
            self.say(f"resumed from {self.cfg.resume} at epoch {epoch} "
                     f"(best rmse {best_rmse:.4f})")

    def _load_model_from(self, path: str) -> tuple:
        step_dir = ckpt_lib.resolve_checkpoint(path)
        return ckpt_lib.load_payload(step_dir)["model"], step_dir

    def maybe_init_from_stage1(self):
        """Two-phase training: with --stage1-path pointing at a late-fusion
        run, both stages of a multistage arch start from its best (else
        latest) checkpoint. A ``stage2_coarse`` stage 2's wider radar conv1
        gets the checkpoint's kernel with zeros on the new input channel
        (``widen_to_template``), so it computes what a 1-channel graft
        computes."""
        if not self.cfg.model.stage1_path or not self.arch_spec.multistage:
            return
        src, step_dir = self._load_model_from(self.cfg.model.stage1_path)
        sd = self.model.state_dict()
        new = {}
        for stage in ("stage1", "stage2"):
            want = {k[len(stage) + 1:] for k in sd
                    if k.startswith(stage + ".")}
            if set(src) != want:
                raise ValueError(
                    f"stage1 checkpoint {step_dir} does not match a "
                    f"{self.cfg.model.arch} stage (is it a late-fusion run "
                    "with the same depth and decoder?)")
            for k, v in src.items():
                new[f"{stage}.{k}"] = widen_to_template(sd[f"{stage}.{k}"], v,
                                                        k)
        self.model.load_state_dict(new, strict=False)
        self.say(f"initialized stage1+stage2 from {step_dir}")

    def maybe_warm_start(self):
        """--init-from: parameters and BN statistics of a same-arch run's
        best checkpoint, with a fresh optimizer and epoch count."""
        if not self.cfg.init_from:
            return
        src, step_dir = self._load_model_from(self.cfg.init_from)
        try:
            self.model.load_state_dict(src)
        except RuntimeError as e:
            raise ValueError(f"--init-from {step_dir}: checkpoint does not "
                             f"match arch {self.cfg.model.arch}") from e
        self.say(f"warm-started params from {step_dir}")

    def load_for_evaluate(self):
        ckpt_lib.restore_for_evaluate(self.cfg.evaluate, self.state)
        broadcast_module(self.model, self.mesh)

    # ------------------------------------------------------------- epochs

    def _make_loader(self, epoch: int):
        from radar_depth_tpu_torch.data.packed import NativeBatchLoader

        cfg = self.cfg
        return NativeBatchLoader(
            self.train_ds, cfg.batch_size, shuffle=True,
            seed=(cfg.seed + GOLDEN * epoch) & _U64, queue_depth=4,
            threads=cfg.workers or 4,
            augment=cfg.augment if self.host_augment else None)

    def _train_batches(self, epoch: int):
        """The epoch's global batches: from the native loader (augmented in
        its threads when ``_host_augment``), else gathered in numpy order.
        The next epoch's loader starts when this one is drained, so it
        prefetches during validation. Every rank reads the global batch
        and keeps its rows (``train_epoch``)."""
        cfg = self.cfg
        if self.reader != "native":
            yield from iterate_batches(self.train_ds, cfg.batch_size, True,
                                       cfg.seed + epoch, drop_last=True)
            return
        loader = self._loaders.pop(epoch, None) or self._make_loader(epoch)
        try:
            steps = len(self.train_ds) // cfg.batch_size
            # only whole optimizer-step groups (a partial group is dropped)
            steps -= steps % self._accum
            for _ in range(steps):
                yield next(loader)
        finally:
            loader.close()
        if epoch + 1 < cfg.epochs:
            self._loaders[epoch + 1] = self._make_loader(epoch + 1)

    def _train_groups(self, epoch: int):
        """Optimizer-step stream: batches as they are with grad_accum 1,
        else (grad_accum, batch, ...) stacks."""
        if self._accum == 1:
            yield from self._train_batches(epoch)
            return
        group = []
        for batch in self._train_batches(epoch):
            group.append(batch)
            if len(group) == self._accum:
                yield {k: np.stack([g[k] for g in group]) for k in group[0]}
                group = []

    def _upload(self, batch: Dict) -> Dict:
        """The batch on the card, copied through pinned host memory without
        waiting for the stream: a copy from pageable memory waits for the
        card to finish the work queued before it, so every step would sync
        the host. On the CPU the batch stays as it is."""
        if self.device.type != "cuda":
            return batch
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
            self.device, non_blocking=True) for k, v in batch.items()}

    def _epoch_generator(self, epoch: int) -> torch.Generator:
        """The Trainer's one generator, seeded for ``epoch``: it draws what
        a new generator with that seed would, and stays the same object,
        so the train step's graph key does not change with the epoch."""
        seed = (self.cfg.seed * 1_000_003 + epoch) & ((1 << 63) - 1)
        return self._generator.manual_seed(seed)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """Steps launch asynchronously; the metric sums add up on the
        device, and the host waits only at print_freq boundaries and at the
        end of the epoch."""
        cfg = self.cfg
        acc = None
        nsteps = 0
        data_t, step_t = AverageMeter(), AverageMeter()
        gen = self._epoch_generator(epoch)
        t0 = time.perf_counter()
        window_t0, window_n, window_data = t0, 0, 0.0
        for batch in self._train_groups(epoch):
            self._beat()
            batch = self._upload(local_rows(batch, self.mesh,
                                            accum=self._accum > 1))
            t1 = time.perf_counter()
            acc = _add(acc, self._train_step(self.state, batch,
                                             generator=gen))
            data_t.update(t1 - t0)
            window_data += t1 - t0
            nsteps += 1
            if nsteps % cfg.print_freq == 0:
                m = _fetch(acc)
                wall = time.perf_counter() - window_t0
                steps_in_window = max(nsteps - window_n, 1)
                step_t.update(max(wall - window_data, 0.0) / steps_in_window,
                              n=steps_in_window)
                loss = m.pop("loss") / nsteps
                fm = finalize_metrics(m)
                self.say(f"epoch {epoch} step {nsteps}: loss={loss:.4f} "
                         f"rmse={fm['rmse']:.3f} mae={fm['mae']:.3f} "
                         f"{wall / steps_in_window * 1e3:.0f}ms/step")
                window_t0, window_n, window_data = (time.perf_counter(),
                                                    nsteps, 0.0)
            t0 = time.perf_counter()
        m = _fetch(acc) if acc is not None else {}
        if nsteps > window_n:  # the ragged last window
            wall = time.perf_counter() - window_t0
            step_t.update(max(wall - window_data, 0.0) / (nsteps - window_n),
                          n=nsteps - window_n)
        loss_sum = m.pop("loss", 0.0)
        metrics = finalize_metrics(m) if m else {}
        metrics["loss"] = loss_sum / max(nsteps, 1)
        metrics["data_time"] = data_t.average
        metrics["gpu_time"] = step_t.average
        metrics["steps"] = nsteps
        return metrics

    def validate(self, epoch: int = 0, viz: bool = True,
                 indices=None) -> Dict[str, float]:
        """The eval pass (restricted to ``indices`` for a split). The panel
        takes the first sample of every val_viz_every-th batch, up to 8
        rows, in comparison_epoch{epoch}.png (rank 0); its forwards run
        after the timing window. Over several ranks a ragged last batch is
        padded to the eval batch size before each rank takes its rows."""
        cfg = self.cfg
        acc = None
        data_t = AverageMeter()
        t0 = time.perf_counter()
        wall_t0, total_data, nsteps = t0, 0.0, 0
        viz_batches = []
        ebs = cfg.eval_batch_size or cfg.batch_size
        for i, batch in enumerate(iterate_batches(self.val_ds, ebs, False, 0,
                                                  drop_last=False,
                                                  indices=indices)):
            self._beat()
            if (viz and self._main and i % cfg.val_viz_every == 0
                    and len(viz_batches) < 8):
                viz_batches.append({k: v[:1] for k, v in batch.items()})
            if self.mesh.data_size > 1:
                batch = local_rows(pad_batch_to(batch, ebs)[0], self.mesh)
            batch = self._upload(batch)
            t1 = time.perf_counter()
            acc = _add(acc, self._eval_step(batch))
            data_t.update(t1 - t0)
            total_data += t1 - t0
            nsteps += 1
            t0 = time.perf_counter()
        sums = _fetch(acc) if acc is not None else {"count": 0.0}
        wall = time.perf_counter() - wall_t0  # the fetch waited for the card
        sums.pop("loss", None)
        metrics = finalize_metrics(sums)
        metrics["data_time"] = data_t.average
        metrics["gpu_time"] = max(wall - total_data, 0.0) / max(nsteps, 1)
        if viz_batches:
            panel = None
            for b in viz_batches:
                out = {k: v.float().cpu().numpy()
                       for k, v in self._predict(b).items()}
                panel = add_row(panel, comparison_panel(
                    out, max_rows=1, max_depth=cfg.data.max_depth))
            save_image(panel, os.path.join(cfg.output_dir,
                                           f"comparison_epoch{epoch}.png"))
        return metrics

    def validate_splits(self, epoch: int = 0) -> Dict[str, Dict[str, float]]:
        """Per-split evaluation ({tag: metrics}) by the val set's
        ``sample_tag``: synthetic scenes carry day/night, packed shards a
        tags sidecar. Each split is its own eval pass."""
        tag_fn = getattr(self.val_ds, "sample_tag", None)
        if tag_fn is None:
            return {}
        groups: Dict[str, list] = {}
        for i in range(len(self.val_ds)):
            groups.setdefault(tag_fn(i), []).append(i)
        if len(groups) <= 1:
            return {}
        return {tag: self.validate(epoch, viz=False, indices=idx)
                for tag, idx in sorted(groups.items())}

    def write_split_csvs(self, splits: Dict[str, Dict[str, float]],
                         epoch: int = 0) -> None:
        """One test_<tag>.csv row per split, in test.csv's schema (rank
        0)."""
        if not self._main:
            return
        for tag, m in splits.items():
            EpochCSVLogger(os.path.join(
                self.cfg.output_dir, f"test_{tag}.csv")).append(epoch, m)

    def fit(self):
        cfg = self.cfg
        self.maybe_init_from_stage1()
        self.maybe_warm_start()
        self.maybe_resume()
        broadcast_module(self.model, self.mesh)
        try:
            with StallWatchdog(cfg.stall_timeout,
                               context=f"training {cfg.output_dir}") as wd:
                self._watchdog = wd
                self._epochs()
                # rank 0's last checkpoint is on disk before any rank ends
                self.ckpt.wait_all()
                assert_replicated(self.model, self.mesh)
                if self.mesh.world > 1:
                    self.say(f"replicas bit-equal on {self.mesh.world} "
                             f"ranks after {self.state.step} steps")
        finally:
            self._watchdog = None
            self.close()

    def _epochs(self):
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.epochs):
            w0 = time.perf_counter()
            train_m = self.train_epoch(epoch)
            if self._main:
                self.train_log.append(epoch, train_m)
            w1 = time.perf_counter()
            val_m = self.validate(epoch)
            if self._main:
                self.val_log.append(epoch, val_m)
            w2 = time.perf_counter()
            if self.tboard is not None:
                self.tboard.log("train", epoch, train_m)
                self.tboard.log("val", epoch, val_m)
            self.say(f"epoch {epoch}: val rmse={val_m['rmse']:.4f} "
                     f"mae={val_m['mae']:.4f} d1={val_m['delta1']:.4f}")
            # best.txt before the checkpoint: a run killed mid-save never
            # leaves best.txt behind a finished epoch
            improved = val_m["rmse"] < self.best_rmse
            if improved:
                self.best_rmse = val_m["rmse"]
                if self._main:
                    write_best_txt(os.path.join(cfg.output_dir, "best.txt"),
                                   epoch, val_m)
            saved = should_checkpoint(epoch, improved, cfg.ckpt_every,
                                      cfg.epochs)
            if saved:
                self.ckpt.save(epoch, self.state, val_m)
            w3 = time.perf_counter()
            self.say(f"epoch {epoch} walls: train={w1 - w0:.1f}s "
                     f"val={w2 - w1:.1f}s ckpt={w3 - w2:.1f}s")
            self.history.append({
                "epoch": epoch, "train": train_m, "val": val_m,
                "walls": {"train": w1 - w0, "val": w2 - w1,
                          "ckpt": w3 - w2},
                "checkpoint": saved})

    def _beat(self):
        if self._watchdog is not None:
            self._watchdog.beat()

    def close(self):
        """Release the loaders' threads, wait for the checkpoint write,
        close the logs and the run lock, destroy the process group that the
        Trainer made. Idempotent."""
        for loader in self._loaders.values():
            loader.close()
        self._loaders.clear()
        if getattr(self, "ckpt", None) is not None:
            self.ckpt.close()
            self.saves = self.ckpt.saves
            self.ckpt = None
        if getattr(self, "tboard", None) is not None:
            self.tboard.close()
            self.tboard = None
        if getattr(self, "_run_lock", None) is not None:
            release_run_lock(self._run_lock)
            self._run_lock = None
        if getattr(self, "mesh", None) is not None:
            # graphs that captured the group's collectives go first
            # (graphs.ShapeGraphs.release)
            for fn in ("_train_step", "_eval_step", "_predict"):
                shapes = getattr(getattr(self, fn, None), "graphs", None)
                if shapes is not None:
                    shapes.release()
            destroy_mesh(self.mesh)
