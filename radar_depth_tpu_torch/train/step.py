"""Train and eval steps, mirroring ``radar_depth_tpu/train/step.py``.

One train step is the whole per-batch pipeline: on-device preprocessing and
augmentation (kernel C z-buffers the augmented radar, and with
``gt_augment="rerasterize"`` the LiDAR GT) -> two-stage forward with BN in
train mode -> masked multistage loss -> backward -> SGD update, with metric
sums on the device. The eval step runs the eval-mode forward (kernel B at
every BN->ReLU) on the eval preprocessing. Raw schema batches go in; the
steps return dicts of device scalars and do not wait for the card. With
``host_augmented=True`` the batch comes augmented from the native loader's
threads and the train step takes the eval preprocessing.

The model is the state: a step updates its parameters and BN running
statistics in place, where the JAX step returns new ones.

``mesh`` (``parallel.mesh.DataMesh``): with a process group, each rank
passes its own rows of the global batch (``parallel.mesh.local_rows``) and
the step computes what the JAX step computes over the global batch on its
one graph: augmentation parameters and sparsifier draws are drawn for the
global batch from the generator, which every rank seeds alike, and each
rank keeps its rows; train-mode BN normalizes with global statistics; the
masked losses divide by the global valid count; each rank differentiates
its share of the loss and one SUM all-reduce per optimizer step adds the
gradients over ranks. The returned loss and sums are the global batch's,
the same on every rank. Without a group the steps are the single-process
code, with no collective.

A mesh with a space axis (``parallel/mesh.py::make_spatial_mesh``) splits
the batch over its data axis only; each rank prepares its samples at full
height (kernel C z-buffers once per rank), keeps its slab of rows of every
NHWC leaf (``parallel/spatial.py::spatial_constraint``) and runs the model
on slabs, the ops along H exchanging halos. Losses, metrics and BN
statistics still reduce over the world, whose slabs partition the pixels.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from radar_depth_tpu_torch import graphs
from radar_depth_tpu_torch.config import TrainConfig
from radar_depth_tpu_torch.metrics import compute_metric_sums
from radar_depth_tpu_torch.models import (
    ArchSpec,
    blend_by_brightness,
    use_mesh,
    use_plain_kernels,
)
from radar_depth_tpu_torch.objectives import (
    get_loss,
    multistage_loss,
    multistage_uncertainty_loss,
)
from radar_depth_tpu_torch.ops.augment import sample_affine_params
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    pack_model_inputs,
    prepare_eval_batch,
    prepare_train_batch,
    to_device,
)
from radar_depth_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    is_distributed,
    local_rows,
)
from radar_depth_tpu_torch.parallel.spatial import spatial_constraint
from radar_depth_tpu_torch.train.state import TrainState


def make_preprocess_config(cfg: TrainConfig) -> PreprocessConfig:
    return PreprocessConfig(
        spec=cfg.data.sample_spec(),
        height_extension=cfg.data.height_extension,
        augment=cfg.augment,
        raster_backend=cfg.data.raster_backend,
        gt_augment=cfg.data.gt_augment,
        sparsifier=cfg.data.sparsifier,
        num_samples=cfg.data.num_samples,
    )


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _loss_and_pred(out, target, cfg: TrainConfig, spec: ArchSpec, rgb=None,
                   mesh=None):
    """``rgb`` (eval only) turns on the ``blend_tau`` output policy, so the
    metrics score the served output; the loss is always the multistage sum
    over both heads, weighted by the learned log-variances when the model
    returns them (the uncertainty archs). With ``mesh`` the loss is this
    rank's share of the global batch's."""
    if spec.multistage:
        if len(out) == 3:  # (coarse, refined, stage_log_var)
            loss = multistage_uncertainty_loss(out[:2], out[2], target,
                                               cfg.optim.criterion, mesh)
        else:
            loss = multistage_loss(out, target, cfg.optim.criterion,
                                   cfg.optim.stage_weights, mesh)
        pred = out[1]
        if rgb is not None and cfg.model.blend_tau > 0:
            pred = blend_by_brightness(out[0], out[1], rgb,
                                       cfg.model.blend_tau, mesh)
    else:
        loss = get_loss(cfg.optim.criterion)(out, target, mesh)
        pred = out
    return loss, pred


def _global_draws(batch: Dict, pre: PreprocessConfig, mesh, device,
                  aug_params, generator, sparse_u, host_augmented: bool):
    """(aug_params, sparse_u) of this rank's rows: given ones are the
    global batch's; missing ones are drawn for the global batch from
    ``generator``, as the single-process step draws them, so N ranks draw
    what one rank draws. Returns what the preprocessing takes."""
    n = next(iter(batch.values())).shape[0] * mesh.data_size
    if pre.sparsifier != "none":
        if sparse_u is None and generator is not None:
            # ops/sparsify.py::draw_uniform over the global target's shape
            sparse_u = torch.rand((n, pre.spec.height, pre.spec.width),
                                  generator=generator, device=device,
                                  dtype=torch.float32)
        return aug_params, local_rows(sparse_u, mesh)
    if host_augmented or not pre.augment.enabled:
        return aug_params, sparse_u
    if aug_params is None and generator is not None:
        aug_params = sample_affine_params(generator, pre.augment, n)
    return local_rows(aug_params, mesh), sparse_u


def make_micro_grad_fn(model: torch.nn.Module, spec: ArchSpec,
                       cfg: TrainConfig, plain: bool = False,
                       host_augmented: bool = False, mesh=None) -> Callable:
    """One micro-batch of the train step without the optimizer update:
    ``micro_grads(batch, aug_params=None, generator=None, sparse_u=None) ->
    (grads, sums)`` with ``grads`` {parameter name: gradient}. The forward
    runs in train mode, so the model's BN running statistics move, in place.

    The augmentation parameters are ``aug_params`` or drawn from
    ``generator`` (``ops/preprocess.py::prepare_train_batch``); under a
    sparsifier its uniform draws are ``sparse_u`` or drawn from
    ``generator``, fresh each step. With
    ``host_augmented=True`` the batch was augmented already, by the native
    loader's threads (``data/packed.py::NativeBatchLoader(augment=...)``),
    so the step runs the eval preprocessing (the radar through the z-buffer,
    the GT the stored ``lidar_depth`` map) and draws nothing. ``plain=True``
    runs the z-buffer's and the train-mode BN's (kernel D's) plain versions
    (the reference on the card); kernel B does not run in train mode.

    ``mesh`` with a process group (module docstring): ``batch`` is this
    rank's rows, ``aug_params`` and ``sparse_u`` if given are the global
    batch's, and ``grads`` are this rank's share, not yet summed over
    ranks; the sums are global. Each call points the model's BN layers at
    ``mesh`` (``models.use_mesh``; None without a group), so steps built
    on one model with different meshes do not disturb each other."""
    pre = make_preprocess_config(cfg)
    names, params = zip(*model.named_parameters())
    mesh = mesh if is_distributed(mesh) else None

    def micro_grads(batch: Dict, aug_params=None,
                    generator: torch.Generator | None = None,
                    sparse_u=None):
        use_mesh(use_plain_kernels(model.train(), plain), mesh)
        if mesh is not None:
            aug_params, sparse_u = _global_draws(
                batch, pre, mesh, _device(model), aug_params, generator,
                sparse_u, host_augmented)
        if host_augmented:
            prepared = prepare_eval_batch(batch, pre, _device(model), plain,
                                          sparse_u, generator)
        else:
            prepared = prepare_train_batch(batch, pre, aug_params, generator,
                                           _device(model), plain, sparse_u)
        prepared = spatial_constraint(prepared, mesh)
        target = prepared["target"]
        out = model(*pack_model_inputs(prepared, spec.input_kind,
                                       cfg.model.modality))
        loss, pred = _loss_and_pred(out, target, cfg, spec, mesh=mesh)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            sums = compute_metric_sums(pred, target, cfg.metric_avg, mesh)
        sums["loss"], = all_reduce_sum([loss.detach().float()], mesh)
        return dict(zip(names, grads)), sums

    return micro_grads


def _draws(pre: PreprocessConfig, host_augmented: bool, aug_params,
           sparse_u) -> bool:
    """Whether a step draws from a generator: the sparsifier's uniforms or
    the augmentation's parameters, where the caller gave none."""
    if pre.sparsifier != "none":
        return sparse_u is None
    return not host_augmented and pre.augment.enabled and aug_params is None


def _on_device(tree, dev: torch.device):
    """``tree`` (arrays, tensors, lists of them, or None) with every array
    on ``dev``: what ``prepare_train_batch`` would upload, uploaded before a
    graph's capture, where a copy from the host cannot wait."""
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, dev) for v in tree)
    return torch.as_tensor(tree, device=dev)


def _fresh_sums(sums: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A replay's sums, stacked into one new tensor and split again: tensors
    that the next replay does not overwrite, in one launch."""
    keys = list(sums)
    return dict(zip(keys, torch.stack([sums[k] for k in keys]).unbind(0)))


def make_train_step(model: torch.nn.Module, spec: ArchSpec, cfg: TrainConfig,
                    plain: bool = False,
                    host_augmented: bool = False, mesh=None) -> Callable:
    """``train_step(state, batch, generator=None, aug_params=None,
    sparse_u=None) -> sums`` for ``state.model is model``; advances
    ``state`` in place. ``host_augmented``: see ``make_micro_grad_fn``.

    With ``cfg.optim.grad_accum`` = N > 1 the batch's leaves are stacked
    (N, B, ...) and ``aug_params`` and ``sparse_u``, if given, hold one
    entry per micro-batch: the micro-batches run in order, BN statistics carried from one
    to the next, their gradients averaged into one update; the metric sums
    add up and the loss is divided by N, so its scale matches the plain
    step.

    On the card, with the kernels, and without a process group or over an
    NCCL one, a spatial one included (``graphs.wanted``), the step
    (micro-batches, update, BN running statistics, the collectives and the
    halo exchanges) runs as one CUDA graph (``graphs.py``): the first step
    at a batch shape and
    learning rate runs eagerly, the second captures, later ones replay; a
    new learning rate (a setting of the optimizer's, set before the graph),
    or an optimizer whose momentum buffers were replaced
    (``load_state_dict``), captures anew (over a process group it raises:
    build the step again). The step count and the learning rate stay on
    the host. A step that draws from ``generator`` registers it
    with its graph where this torch can (else it runs eagerly); the
    generator is part of the graph's key, so a caller keeps one generator
    and seeds it again (``manual_seed``) rather than making a new one,
    which would capture anew (the Trainer reseeds one generator every
    epoch); a generator of a device that does not capture (the CPU's) runs
    the step eagerly. The sums are new tensors every step.

    ``mesh`` with a process group (module docstring): ``batch`` holds this
    rank's rows (dim 1 of the stacks), ``aug_params`` and ``sparse_u`` if
    given the global batch's; the gradients are summed over ranks in one
    flat all-reduce after the micro-batches, before the division by N."""
    mesh = mesh if is_distributed(mesh) else None
    micro_grads = make_micro_grad_fn(model, spec, cfg, plain, host_augmented,
                                     mesh)
    accum = max(1, cfg.optim.grad_accum)
    pre = make_preprocess_config(cfg)

    def reduce_grads(grads: Dict[str, torch.Tensor]):
        if mesh is None:
            return grads
        return dict(zip(grads, all_reduce_sum(list(grads.values()), mesh)))

    def apply_update(optimizer, grads: Dict[str, torch.Tensor]):
        for name, p in model.named_parameters():
            p.grad = grads[name]
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def update(optimizer, batch: Dict, generator, aug_params,
               sparse_u) -> Dict:
        """The step's device work: the micro-batches and the update."""
        if accum == 1:
            grads, sums = micro_grads(batch, aug_params, generator, sparse_u)
            apply_update(optimizer, reduce_grads(grads))
            return sums
        grads, sums = None, None
        for i in range(accum):
            g, s = micro_grads({k: v[i] for k, v in batch.items()},
                               None if aug_params is None else aug_params[i],
                               generator,
                               None if sparse_u is None else sparse_u[i])
            if grads is None:
                grads, sums = g, s
            else:
                grads = {k: grads[k] + g[k] for k in grads}
                sums = {k: sums[k] + s[k] for k in sums}
        sums["loss"] = sums["loss"] / accum
        apply_update(optimizer, {k: g / accum
                                 for k, g in reduce_grads(grads).items()})
        return sums

    dev = _device(model)
    shapes = (graphs.ShapeGraphs(update, model, fresh=_fresh_sums,
                                 max_graphs=1, mesh=mesh)
              if graphs.wanted(dev, plain, mesh) else None)

    def train_step(state: TrainState, batch: Dict,
                   generator: torch.Generator | None = None,
                   aug_params: Sequence | None = None,
                   sparse_u: Sequence | None = None) -> Dict:
        if state.model is not model:
            raise ValueError("state.model is not the model of this step")
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        draws = _draws(pre, host_augmented, aug_params, sparse_u)
        if shapes is None or (draws and (
                generator is None
                or generator.device.type not in graphs.CAPTURE_DEVICES)):
            sums = update(state.optimizer, batch, generator, aug_params,
                          sparse_u)
        else:
            # what the step sets on the host, which a replay does not run
            use_mesh(use_plain_kernels(model.train(), plain), mesh)
            gen = generator if draws else None
            sums = shapes(state.optimizer, to_device(batch, dev), gen,
                          _on_device(aug_params, dev),
                          _on_device(sparse_u, dev),
                          generators=(gen,) if draws else (),
                          optimizer=state.optimizer)
        state.step += 1
        return sums

    train_step.graphs = shapes
    return train_step


def make_eval_step(model: torch.nn.Module, spec: ArchSpec, cfg: TrainConfig,
                   plain: bool = False, mesh=None) -> Callable:
    """``eval_step(batch) -> sums``: the eval preprocessing (kernel C or A
    z-buffer) and the eval-mode forward (kernel B), the multistage loss and
    the metric sums of the served output (``blend_tau``). ``plain=True``
    runs every kernel's plain version. ``mesh`` with a process group:
    ``batch`` is this rank's rows of a global batch (a ragged last one
    padded with ``parallel.mesh.pad_batch_to`` first) and the sums are the
    global batch's; a sparsifier's draws are those of the global batch.

    A sparsifier draws the same uniforms every call (a generator seeded 0,
    the JAX package's fixed key), from one generator of the step's, seeded
    again before each call. Where ``make_train_step`` captures, so does
    this step: one CUDA graph per batch shape (a ragged last batch is a
    second), the generator registered with it; the sums are new tensors
    every call, so a caller may add them up across calls.
    ``eval_step.graphs`` is the ``graphs.ShapeGraphs`` (None where the step
    stays eager)."""
    pre = make_preprocess_config(cfg)
    mesh = mesh if is_distributed(mesh) else None
    dev = _device(model)
    fixed = (torch.Generator(device=dev) if pre.sparsifier != "none"
             else None)

    def sums_of(batch: Dict, generator) -> Dict:
        """The step's device work."""
        sparse_u = None
        if mesh is not None and generator is not None:
            _, sparse_u = _global_draws(batch, pre, mesh, dev, None,
                                        generator, None, False)
        prepared = spatial_constraint(
            prepare_eval_batch(batch, pre, dev, plain, sparse_u, generator),
            mesh)
        out = model(*pack_model_inputs(prepared, spec.input_kind,
                                       cfg.model.modality))
        loss, pred = _loss_and_pred(out, prepared["target"], cfg, spec,
                                    rgb=prepared["rgb"], mesh=mesh)
        sums = compute_metric_sums(pred, prepared["target"], cfg.metric_avg,
                                   mesh)
        sums["loss"], = all_reduce_sum([loss.float()], mesh)
        return sums

    shapes = (graphs.ShapeGraphs(sums_of, model, fresh=_fresh_sums,
                                 mesh=mesh)
              if graphs.wanted(dev, plain, mesh) else None)

    @torch.no_grad()
    def eval_step(batch: Dict) -> Dict:
        use_mesh(use_plain_kernels(model.eval(), plain), mesh)
        gen = None if fixed is None else fixed.manual_seed(0)
        if shapes is None:
            return sums_of(batch, gen)
        return shapes(to_device(batch, dev), gen, key=(model.training,),
                      generators=() if gen is None else (gen,))

    eval_step.graphs = shapes
    return eval_step


def make_predict_fn(model: torch.nn.Module, spec: ArchSpec,
                    cfg: TrainConfig) -> Callable:
    """``predict(batch) -> {rgb, radar, target, pred}``, all (B, H, W, .)
    on the device: the eval preprocessing and the eval-mode forward, with the
    served output (``blend_tau``), for the comparison panels; in this
    process alone, whatever mesh the model's steps use. On the card it
    captures as the eval step does (one graph per batch shape), its outputs
    copies that the next call leaves as they are; ``predict.graphs``."""
    pre = make_preprocess_config(cfg)
    dev = _device(model)

    def panels_of(batch: Dict) -> Dict[str, torch.Tensor]:
        prepared = prepare_eval_batch(batch, pre, dev)
        out = model(*pack_model_inputs(prepared, spec.input_kind,
                                       cfg.model.modality))
        _, pred = _loss_and_pred(out, prepared["target"], cfg, spec,
                                 rgb=prepared["rgb"])
        return dict(prepared, pred=pred)

    shapes = (graphs.ShapeGraphs(panels_of, model, fresh=graphs.clone_tree)
              if graphs.wanted(dev) else None)

    @torch.no_grad()
    def predict(batch: Dict) -> Dict[str, torch.Tensor]:
        use_mesh(model.eval(), None)
        if shapes is None:
            return panels_of(batch)
        return shapes(to_device(batch, dev), key=(model.training,))

    predict.graphs = shapes
    return predict
