"""Serving entry point of the port: raw schema batch -> depth, on the card.

Mirrors ``radar_depth_tpu/inference.py::Predictor`` (``predict`` with the
same power-of-two tiling, ``predict_stream``):

    from radar_depth_tpu_torch.inference import Predictor
    p = Predictor(cfg, state_dict)      # device="cuda" unless told otherwise
    depth = p.predict(batch)            # (B, H, W) meters, numpy
    p = Predictor.from_run("runs/ms")   # a training run's best checkpoint
    metrics = p.evaluate(batch)         # Result-style dict

The path per chunk: ``prepare_eval_batch`` (z-buffer: sort + kernel C, or
kernel A with ``raster_backend="scatter"``) ->
``pack_model_inputs`` -> the model forward (kernel B at every BN->ReLU) ->
``pred[..., 0]``. PyTorch launches asynchronously; the copy of the result to
the host is the only wait.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Dict, Iterable, Iterator, Mapping

import numpy as np
import torch

from radar_depth_tpu_torch.config import (
    ServeConfig,
    TrainConfig,
    load_config,
    require_ported,
    serve_config,
)
from radar_depth_tpu_torch.device import resolve_device
from radar_depth_tpu_torch.metrics import compute_metric_sums, finalize_metrics
from radar_depth_tpu_torch.models import (
    blend_by_brightness,
    create_model,
    use_plain_kernels,
)
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    pack_model_inputs,
    prepare_eval_batch,
)


class Predictor:
    """Depth predictor over a state_dict (``convert.
    state_dict_from_jax_variables`` carries a JAX run's variables across).

    ``plain=True`` runs the kernels' plain PyTorch versions, on any device:
    the reference that a kernel run on the card is held against."""

    def __init__(self, cfg: ServeConfig, state_dict: Mapping,
                 device: str | torch.device | None = None, plain: bool = False,
                 metric_avg: str = "batch"):
        self.cfg = cfg
        self.metric_avg = metric_avg
        self.device = resolve_device(device)
        self.plain = plain
        spec = cfg.sample_spec()
        self.model, self.arch_spec = create_model(
            cfg.arch, device=self.device, decoder=cfg.decoder,
            output_size=(spec.height, spec.width), dtype=cfg.torch_dtype,
            **cfg.arch_kwargs())
        self.model.load_state_dict(state_dict)
        use_plain_kernels(self.model, plain)
        self._pre = PreprocessConfig(spec=spec,
                                     height_extension=cfg.height_extension,
                                     raster_backend=cfg.raster_backend)

    @classmethod
    def from_run(cls, run_dir: str, cfg: TrainConfig | None = None,
                 device: str | torch.device | None = None, plain: bool = False,
                 **cfg_overrides) -> "Predictor":
        """The best (else latest) checkpoint of a training run. The run's
        config.json gives the model and data flags; ``cfg`` replaces it and
        ``cfg_overrides`` (top-level TrainConfig fields) amend it."""
        from radar_depth_tpu_torch.train import checkpoint as ckpt_lib

        if cfg is None:
            path = os.path.join(run_dir, "config.json")
            cfg = (load_config(path) if os.path.isfile(path)
                   else TrainConfig())
        cfg = dataclasses.replace(cfg, **cfg_overrides)
        require_ported(cfg)
        step_dir = ckpt_lib.resolve_checkpoint(run_dir)
        state_dict = ckpt_lib.load_payload(step_dir)["model"]
        return cls(serve_config(cfg), state_dict, device=device, plain=plain,
                   metric_avg=cfg.metric_avg)

    @torch.inference_mode()
    def _forward(self, batch: Dict):
        prepared = prepare_eval_batch(batch, self._pre, self.device,
                                      plain=self.plain)
        out = self.model(*pack_model_inputs(
            prepared, self.arch_spec.input_kind, self.cfg.modality))
        pred = out[1] if self.arch_spec.multistage else out
        if self.arch_spec.multistage and self.cfg.blend_tau > 0:
            pred = blend_by_brightness(out[0], out[1], prepared["rgb"],
                                       self.cfg.blend_tau)
        return pred, prepared["target"]

    def infer(self, batch: Dict) -> torch.Tensor:
        """One raw batch -> (B, H, W) float32 prediction on the device,
        without waiting for it."""
        return self._forward(batch)[0][..., 0]

    def evaluate(self, batch: Dict) -> Dict[str, float]:
        """Raw schema batch -> the reference's Result-style metrics against
        the batch's LiDAR depth (``metric_avg`` convention)."""
        pred, target = self._forward(batch)
        return finalize_metrics(compute_metric_sums(pred, target,
                                                    self.metric_avg))

    def predict(self, batch: Dict, max_tile: int = 128) -> np.ndarray:
        """Raw schema batch -> (B, H, W) predicted depth in meters.

        Requests are tiled into power-of-two chunks of at most ``max_tile``
        samples, a short tail padded by repeating the last sample and the
        padding sliced off, as the JAX Predictor does. Eval-mode BN and no
        cross-sample ops make tiling value-identical to a single call."""
        arrs = {k: np.asarray(v) for k, v in batch.items()}
        b = next(iter(arrs.values())).shape[0]
        tile = 1
        while tile < b and tile < max_tile:
            tile *= 2
        outs = []
        for i in range(0, b, tile):
            chunk = {k: v[i:i + tile] for k, v in arrs.items()}
            n = next(iter(chunk.values())).shape[0]
            if n < tile:
                chunk = {k: np.concatenate(
                    [v, np.repeat(v[-1:], tile - n, axis=0)], axis=0)
                    for k, v in chunk.items()}
            outs.append(self.infer(chunk)[:n].cpu().numpy())
        return np.concatenate(outs, axis=0)

    def predict_stream(self, batches: Iterable[Dict],
                       depth: int = 2) -> Iterator[np.ndarray]:
        """Yield (B, H, W) depth maps for an iterator of raw batches, keeping
        up to ``depth`` batches launched and not yet fetched, so the upload
        and launch of batch i+1 overlap the device's work on batch i."""
        inflight: deque = deque()
        for batch in batches:
            inflight.append(self.infer(batch))
            if len(inflight) >= depth:
                yield inflight.popleft().cpu().numpy()
        while inflight:
            yield inflight.popleft().cpu().numpy()
