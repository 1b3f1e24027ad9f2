"""Serving entry point of the port: raw schema batch -> depth, on the card.

Mirrors ``radar_depth_tpu/inference.py::Predictor`` (``predict`` with the
same power-of-two tiling, ``predict_stream``):

    from radar_depth_tpu_torch.inference import Predictor
    p = Predictor(cfg, state_dict)      # device="cuda" unless told otherwise
    depth = p.predict(batch)            # (B, H, W) meters, numpy
    p = Predictor.from_run("runs/ms")   # a training run's best checkpoint
    metrics = p.evaluate(batch)         # Result-style dict
    nbytes = p.export_serving("ms.pt2", batch_size=8)
    serve = load_serving("ms.pt2")      # on the card, or device="cpu"
    depth = serve(batch)                # the same path, weights baked in

The path per chunk: ``prepare_eval_batch`` (z-buffer: sort + kernel C, or
kernel A with ``raster_backend="scatter"``) ->
``pack_model_inputs`` -> the model forward (kernel B at every BN->ReLU) ->
``pred[..., 0]``. PyTorch launches asynchronously; the copy of the result to
the host is the only wait.

On the card (not ``plain``; without a mesh or over an NCCL one) ``infer``
and ``evaluate`` run that path as one CUDA graph per tile shape
(``graphs.py``, the counterpart of the JAX Predictor's one jitted program
per shape), and so does the artifact of ``load_serving``: the first call at
a shape runs eagerly, the second captures, later ones replay. The eager path
stays the path on the CPU, over a gloo group, under a module hook, inside
``graphs.disable_graphs()`` and for ``plain=True``.

Over ranks (``mesh``, ``Predictor.from_run`` with ``spatial`` > 1 under
``torchrun``): every rank calls ``predict`` with the same global batch and
gets the whole (B, H, W) map. Each rank prepares its data-axis rows at
full height, runs its slab of image rows (``parallel/spatial.py``), and
the slabs and rows are put together again (``unslab``, ``gather_batch``),
inside the graph on the card: every rank captures at the same call and
replays at the same calls, since each calls with the same batches.
"""


from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from collections import deque
from typing import Dict, Iterable, Iterator, Mapping

import numpy as np
import torch

from radar_depth_tpu_torch import graphs
from radar_depth_tpu_torch.config import (
    ServeConfig,
    TrainConfig,
    load_config,
    require_ported,
    serve_config,
)
from radar_depth_tpu_torch.data.schema import sample_dtypes, sample_shapes
from radar_depth_tpu_torch.device import (
    resolve_device,
    use_deterministic_convs,
)
from radar_depth_tpu_torch.metrics import compute_metric_sums, finalize_metrics
from radar_depth_tpu_torch.models import (
    blend_by_brightness,
    create_model,
    use_mesh,
    use_plain_kernels,
)
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    pack_model_inputs,
    prepare_eval_batch,
    to_device,
)
from radar_depth_tpu_torch.parallel.mesh import (
    destroy_mesh,
    gather_batch,
    is_distributed,
    local_rows,
    make_spatial_mesh,
    pad_batch_to,
)
from radar_depth_tpu_torch.parallel.spatial import (
    spatial_constraint,
    unslab,
)

# The serving artifact's own record, stored beside the exported program:
# the device it was exported on and its fixed input shapes and dtypes.
SERVING_META = "rdt_serving.json"


def _serving_meta(path: str) -> Dict:
    """The record of an artifact, read without loading its weights."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist()
                 if n.endswith(f"extra/{SERVING_META}")]
        if not names:
            raise ValueError(f"{path} is not a serving artifact of "
                             "Predictor.export_serving")
        return json.loads(z.read(names[0]))


def load_serving(path: str, device: str | torch.device | None = None):
    """Load an artifact written by ``Predictor.export_serving``. Returns a
    callable: raw schema batch (dict of numpy arrays, the exported batch
    size) -> (B, H, W) float32 depth, numpy. It uploads the batch to
    ``device`` itself.

    ``device=None`` means the card and raises without one; the artifact
    runs only on the kind of device it was exported on. The kernels'
    operators (``torch.ops.rdt.*``) are registered by this module's
    imports; their CUDA libraries are built at first use, as in eager
    mode.

    On the card the exported module runs as one CUDA graph (``graphs.py``;
    the artifact has one batch size, so one graph): the first call runs
    eagerly, the second captures, later ones replay, the upload before the
    graph. The callable's ``graphs`` is its ``graphs.ShapeGraphs`` (None on
    the CPU). ``torch.export``'s own hooks on the loaded module, which check
    its inputs in Python, are taken off: a graph cannot replay them (a
    hooked module runs eagerly), and ``serve`` checks every input against
    the artifact's record itself."""
    dev = resolve_device(device)
    use_deterministic_convs(dev)
    meta = _serving_meta(path)
    if meta["device"] != dev.type:
        raise ValueError(
            f"{path} was exported on {meta['device']!r} and runs only "
            f"there, not on {dev.type!r}: export it again on that device")
    module = torch.export.load(path).module()
    for hooks in (module._forward_pre_hooks, module._forward_hooks,
                  module._forward_hooks_always_called):
        hooks.clear()
    inputs = meta["inputs"]
    shapes = (graphs.ShapeGraphs(module, module, fresh=torch.Tensor.clone,
                                 max_graphs=1)
              if graphs.wanted(dev) else None)

    def serve(batch: Dict) -> np.ndarray:
        if set(batch) != set(inputs):
            raise KeyError(f"batch keys {sorted(batch)} != the artifact's "
                           f"{sorted(inputs)}")
        tensors = {}
        for k, (shape, dtype) in inputs.items():
            v = np.asarray(batch[k])
            if list(v.shape) != shape or str(v.dtype) != dtype:
                raise ValueError(
                    f"{k}: {v.dtype}{list(v.shape)}, but the artifact takes "
                    f"{dtype}{shape} (batch size {meta['batch_size']})")
            tensors[k] = torch.from_numpy(
                np.require(v, requirements="W")).to(dev)
        with torch.no_grad():
            if shapes is None:
                return module(tensors).cpu().numpy()
            return shapes(tensors).cpu().numpy()

    serve.graphs = shapes
    return serve


class _ServingGraph(torch.nn.Module):
    """A Predictor's raw-batch -> depth path as one module, for
    ``torch.export``: the model is a submodule, so its weights are baked
    into the program."""

    def __init__(self, predictor: "Predictor"):
        super().__init__()
        self.model = predictor.model
        self.predictor = predictor

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.predictor._infer_eager(batch)


class Predictor:
    """Depth predictor over a state_dict (``convert.
    state_dict_from_jax_variables`` carries a JAX run's variables across).

    ``plain=True`` runs the kernels' plain PyTorch versions, on any device:
    the reference that a kernel run on the card is held against.

    ``mesh`` (``parallel.mesh.DataMesh`` with a process group, on its
    device): the ranks serve together, each calling with the same global
    batch (module docstring); with a space axis each runs a slab of image
    rows. ``close`` destroys a mesh that ``from_run`` made.

    ``keep`` (a dict, None by default) makes each forward leave its
    prepared batch and the model's output there (``keep["prepared"]``,
    ``keep["out"]``, as ``bench.make_infer_fn``), for a check of what a
    timed run computed (under a graph, copies of what its replay wrote).

    ``graphs`` (a ``graphs.ShapeGraphs``, or None where the path stays
    eager: on the CPU, over a gloo group, with ``plain``) holds the
    captured forwards, one per tile shape, shared by ``infer`` and
    ``evaluate``; over a mesh its key is the ranks' shared one."""

    def __init__(self, cfg: ServeConfig, state_dict: Mapping,
                 device: str | torch.device | None = None, plain: bool = False,
                 metric_avg: str = "batch", mesh=None):
        self.cfg = cfg
        self.metric_avg = metric_avg
        self.mesh = mesh if is_distributed(mesh) else None
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        use_deterministic_convs(self.device)
        self._own_mesh = None
        self.plain = plain
        self.keep = None
        spec = cfg.sample_spec()
        self.model, self.arch_spec = create_model(
            cfg.arch, device=self.device, decoder=cfg.decoder,
            output_size=(spec.height, spec.width), dtype=cfg.torch_dtype,
            **cfg.arch_kwargs())
        self.model.load_state_dict(state_dict)
        use_mesh(use_plain_kernels(self.model, plain), self.mesh)
        self._pre = PreprocessConfig(spec=spec,
                                     height_extension=cfg.height_extension,
                                     raster_backend=cfg.raster_backend)
        self.graphs = (graphs.ShapeGraphs(self._served_map, self.model,
                                          fresh=self._fresh, mesh=self.mesh)
                       if graphs.wanted(self.device, plain, self.mesh)
                       else None)

    @classmethod
    def from_run(cls, run_dir: str, cfg: TrainConfig | None = None,
                 device: str | torch.device | None = None, plain: bool = False,
                 **cfg_overrides) -> "Predictor":
        """The best (else latest) checkpoint of a training run. The run's
        config.json gives the model and data flags; ``cfg`` replaces it and
        ``cfg_overrides`` (top-level TrainConfig fields) amend it. With
        ``spatial`` > 1 it serves over the (data, space) mesh of the
        ``torchrun`` ranks (``make_spatial_mesh``, gloo for
        ``device="cpu"``), which ``close`` destroys."""
        from radar_depth_tpu_torch.train import checkpoint as ckpt_lib

        if cfg is None:
            path = os.path.join(run_dir, "config.json")
            cfg = (load_config(path) if os.path.isfile(path)
                   else TrainConfig())
        cfg = dataclasses.replace(cfg, **cfg_overrides)
        require_ported(cfg)
        step_dir = ckpt_lib.resolve_checkpoint(run_dir)
        state_dict = ckpt_lib.load_payload(step_dir)["model"]
        mesh = None
        if cfg.spatial > 1:
            cpu = device is not None and torch.device(device).type == "cpu"
            mesh = make_spatial_mesh(cfg.spatial, "cpu" if cpu else "default")
        out = cls(serve_config(cfg), state_dict, device=device, plain=plain,
                  metric_avg=cfg.metric_avg, mesh=mesh)
        out._own_mesh = mesh
        return out

    def close(self) -> None:
        """Release the graphs (``graphs.ShapeGraphs.release``: over a mesh
        they hold its communicators), then destroy the process group of a
        mesh that ``from_run`` made. A caller that passed its own mesh
        closes the Predictor before destroying that mesh."""
        if self.graphs is not None:
            self.graphs.release()
        destroy_mesh(self._own_mesh)
        self._own_mesh = None

    def _served(self, batch: Dict):
        """This rank's rows (and slab): (prediction (B, H, W, 1), the
        prepared batch, the model's output)."""
        prepared = spatial_constraint(prepare_eval_batch(
            local_rows(batch, self.mesh), self._pre, self.device,
            plain=self.plain), self.mesh)
        out = self.model(*pack_model_inputs(
            prepared, self.arch_spec.input_kind, self.cfg.modality))
        pred = out[1] if self.arch_spec.multistage else out
        if self.arch_spec.multistage and self.cfg.blend_tau > 0:
            pred = blend_by_brightness(out[0], out[1], prepared["rgb"],
                                       self.cfg.blend_tau, self.mesh)
        return pred, prepared, out

    def _served_map(self, batch: Dict):
        """(the whole (B, H, W) map, this rank's rows (and slab) of it, the
        prepared batch, the model's output): without a mesh the map and
        the rank's share are one tensor."""
        pred, prepared, out = self._served(batch)
        local = pred[..., 0]
        if self.mesh is None:
            return local, local, prepared, out
        full = gather_batch(unslab(local, self.mesh, self.cfg.height, 1),
                            self.mesh)
        return full, local, prepared, out

    def _fresh(self, out):
        """What a replay's caller gets: the map, and with ``keep`` the
        prepared batch and the model's output, as copies (the next replay at
        the tile's shape, for another caller's batch, writes the graph's
        own). The rank's share of the map and the prepared batch stay the
        graph's, for a caller that holds ``graphs.lock``."""
        full, local, prepared, model_out = out
        if self.keep is None:
            return full.clone(), local, prepared, model_out
        return (full.clone(), local, graphs.clone_tree(prepared),
                graphs.clone_tree(model_out))

    @torch.inference_mode()
    def _forward(self, batch: Dict):
        """This rank's rows (and slab) of the prediction and the target."""
        pred, prepared, out = self._served(batch)
        if self.keep is not None:
            self.keep.update(prepared=prepared, out=out)
        return pred, prepared["target"]

    @torch.inference_mode()
    def _infer_eager(self, batch: Dict) -> torch.Tensor:
        full, _, prepared, out = self._served_map(batch)
        if self.keep is not None:
            self.keep.update(prepared=prepared, out=out)
        return full

    @torch.inference_mode()
    def _replay(self, batch: Dict):
        """The tile shape's graph, the upload before any capture: the whole
        map, the rank's share of it and the prepared batch (``_fresh``),
        ``keep`` filled."""
        full, local, prepared, out = self.graphs(
            to_device(batch, self.device), key=(self.model.training,))
        if self.keep is not None:
            self.keep.update(prepared=prepared, out=out)
        return full, local, prepared

    def infer(self, batch: Dict) -> torch.Tensor:
        """One raw batch -> (B, H, W) float32 prediction on the device,
        without waiting for it. Over a mesh: the same global batch on every
        rank (B a multiple of the data axis), the whole map on every
        rank. On the card: through the tile shape's graph (class
        docstring)."""
        if self.graphs is None:
            return self._infer_eager(batch)
        return self._replay(batch)[0]

    def evaluate(self, batch: Dict) -> Dict[str, float]:
        """Raw schema batch -> the reference's Result-style metrics against
        the batch's LiDAR depth (``metric_avg`` convention). Over a mesh the
        batch is padded to a multiple of the data axis with samples that
        carry no valid target. On the card: through ``infer``'s graph of
        the batch's shape."""
        if self.mesh is not None:
            b = len(next(iter(batch.values())))
            d = self.mesh.data_size
            batch = pad_batch_to({k: np.asarray(v) for k, v in batch.items()},
                                 -(-b // d) * d)[0]
        if self.graphs is None:
            pred, target = self._forward(batch)
        else:
            # the target (and over a mesh the rank's share of the map)
            # copied before another caller's replay at this shape rewrites
            # the graph's own
            with self.graphs.lock, torch.inference_mode():
                full, local, prepared = self._replay(batch)
                target = prepared["target"].clone()
                pred = (full if self.mesh is None else local.clone())
            pred = pred[..., None]
        return finalize_metrics(compute_metric_sums(
            pred, target, self.metric_avg, self.mesh))

    def predict(self, batch: Dict, max_tile: int = 128) -> np.ndarray:
        """Raw schema batch -> (B, H, W) predicted depth in meters.

        Requests are tiled into power-of-two chunks of at most ``max_tile``
        samples, a short tail padded by repeating the last sample and the
        padding sliced off, as the JAX Predictor does. Eval-mode BN and no
        cross-sample ops make tiling value-identical to a single call. Over
        a mesh a tile is padded up to a multiple of the data axis."""
        arrs = {k: np.asarray(v) for k, v in batch.items()}
        b = next(iter(arrs.values())).shape[0]
        tile = 1
        while tile < b and tile < max_tile:
            tile *= 2
        if self.mesh is not None:
            d = self.mesh.data_size
            tile = -(-tile // d) * d
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

    def export_serving(self, path: str, batch_size: int) -> int:
        """Write the whole raw-batch -> depth path (``prepare_eval_batch``
        with its z-buffer, the model, the optional blend, ``pred[..., 0]``)
        as one ``torch.export`` program, weights baked in, at a fixed batch
        size, on this Predictor's device. Every kernel is a ``rdt.*`` node
        of the graph. Returns the file's byte count; load it with
        ``load_serving``. A Predictor over a mesh does not export."""
        if self.mesh is not None:
            raise ValueError("export_serving exports a Predictor without a "
                             "mesh: its collectives do not export")
        dtypes = sample_dtypes()
        example = {k: torch.from_numpy(np.zeros((batch_size,) + shape,
                                                dtypes[k])).to(self.device)
                   for k, shape in sample_shapes(self.cfg.sample_spec()).items()}
        with torch.no_grad():
            program = torch.export.export(_ServingGraph(self), (example,))
        meta = {"device": self.device.type, "batch_size": batch_size,
                "inputs": {k: [list(v.shape), str(dtypes[k])]
                           for k, v in example.items()}}
        torch.export.save(program, path,
                          extra_files={SERVING_META: json.dumps(meta)})
        return os.path.getsize(path)

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
