"""Throughput benchmark of the port, flag for flag the JAX package's
``bench.py``, on one CUDA card (``--platform cpu`` for the CPU):

    python -m radar_depth_tpu_torch.bench                      # infer, B=128
    python -m radar_depth_tpu_torch.bench --mode train --batch 32
    python -m radar_depth_tpu_torch.bench --mode stream

The model is the flagship by default (``resnet18_multistage`` / ``upproj``,
450x800, 5 sweeps, bfloat16) with seeded random weights
(``models.init_random(model, 0)``) on ``SyntheticNuScenes(seed=0)`` data.
Modes:
  infer   prepare_eval_batch -> pack_model_inputs -> the eval-mode forward
          (what ``Predictor.infer`` runs) on a batch resident on the card;
          each iteration adds its prediction's sum into one device scalar,
          fetched once per repeat
  stream  the same, each step uploading a fresh host batch from pageable
          numpy, two steps in flight; beside it the resident rate
  train   ``make_train_step`` on one worker-augmented batch of the native
          loader (synthetic batches where the loader is not built), resident
          on the card; the loader's own img/s beside it

Prints ONE JSON line: ``{"metric", "value", "unit", ...}``; img/s "per chip"
is per card this process runs on, which is one. In infer mode the card's
own keys ride along: ``gflops_per_image`` (``model_summary.summarize``'s
FlopCounterMode count of one B=1 forward: convolutions and matmuls),
``model_tflops_per_sec``, ``peak_tflops`` (the card's dense peak for
``--dtype``), ``mfu`` and ``device``. On a card without a known peak the
four FLOP keys are left out, and on the CPU all five, with a note on
stderr.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np
import torch

from radar_depth_tpu_torch.data import schema
from radar_depth_tpu_torch.data.schema import SampleSpec
from radar_depth_tpu_torch.data.synthetic import SyntheticNuScenes
from radar_depth_tpu_torch.device import (
    resolve_device,
    use_deterministic_convs,
)
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    pack_model_inputs,
    prepare_eval_batch,
    to_device,
)

# Dense peaks by the card's name and compute dtype, TFLOP/s, from NVIDIA's
# H100 SXM5 data sheet: bfloat16 on the tensor cores; float32 runs IEEE
# (TF32 off, device.py), so its peak is the CUDA cores', not TF32's.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4, "float32": 66.9},
}
WATCHDOG_S = 600


def device_count_or_die(timeout_s: int = WATCHDOG_S) -> int:
    """The first touch of CUDA, watchdogged as ``bench.py``'s first device
    touch is: a CUDA runtime that hangs there would stall the caller
    forever, so a daemon thread exits the process with code 3 (the
    environment, not the program) and a line on stderr instead."""
    done = threading.Event()

    def watchdog():
        if not done.wait(timeout_s):
            sys.stderr.write(
                f"bench: torch.cuda.device_count() still blocked after "
                f"{timeout_s}s; CUDA does not answer, aborting "
                "instead of hanging\n")
            sys.stderr.flush()
            os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()
    n = torch.cuda.device_count()
    done.set()
    return n


def open_device(platform: str) -> torch.device:
    """The entry point's device: the CPU for ``--platform cpu``; else the
    card, its first touch watchdogged, raising ``as_device``'s error
    without one."""
    if platform == "cpu":
        return resolve_device("cpu")
    device_count_or_die()
    return resolve_device(None)


def synthetic_samples(spec: SampleSpec, n: int, seed: int = 0) -> list:
    """The samples of ``SyntheticNuScenes(n, spec, seed)``, in order, made
    in threads: each depends on (seed, index) only, and its time goes
    mostly to numpy's array work, which runs outside the GIL."""
    ds = SyntheticNuScenes(n, spec=spec, seed=seed)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(ds.__getitem__, range(n)))


def synthetic_batch(spec: SampleSpec, n: int, seed: int = 0) -> Dict:
    """``SyntheticNuScenes(n, spec, seed).batch(range(n))``."""
    return schema.stack_samples(synthetic_samples(spec, n, seed))


def resident(host: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Upload a raw batch once; the preprocessing's own upload
    (``ops/preprocess.py::to_device``) is then a no-op on it, checked."""
    batch = to_device(host, dev)
    again = to_device(batch, dev)
    if any(again[k] is not v for k, v in batch.items()):
        raise AssertionError("to_device copied a resident batch again")
    return batch


def make_infer_fn(model: torch.nn.Module, arch_spec, pre: PreprocessConfig,
                  dev: torch.device) -> Callable:
    """One iteration: what ``Predictor.infer`` runs (the eval
    preprocessing, the eval-mode forward in inference mode, the refined
    head's map) -> (B, H, W) on the device, not waited for."""

    @torch.inference_mode()
    def infer(batch: Dict) -> torch.Tensor:
        prepared = prepare_eval_batch(batch, pre, dev)
        out = model(*pack_model_inputs(prepared, arch_spec.input_kind))
        pred = out[1] if arch_spec.multistage else out
        return pred[..., 0]

    return infer


def time_resident(infer: Callable, batch: Dict, iters: int, warmup: int,
                  repeat: int) -> list:
    """Seconds of each of ``repeat`` loops of ``iters`` iterations. Each
    iteration adds its prediction's float32 sum into one device scalar,
    fetched once per loop: the only wait. (The JAX bench adds ``carry *
    1e-30`` to the inputs because XLA would hoist loop-invariant work out
    of its scan; eager PyTorch runs every call it is given, so the inputs
    stay as they are.)"""

    def loop(n):
        with torch.inference_mode():
            total = torch.zeros((), dtype=torch.float32,
                                device=next(iter(batch.values())).device)
            for _ in range(n):
                total = total + infer(batch).float().sum()
            value = float(total)
        if not np.isfinite(value):
            raise AssertionError(f"prediction sum {value}")

    if warmup > 0:
        loop(warmup)
    dts = []
    for _ in range(max(1, repeat)):
        t0 = time.perf_counter()
        loop(iters)
        dts.append(time.perf_counter() - t0)
    return dts


@functools.lru_cache(maxsize=None)
def forward_flops(arch: str, height: int, width: int) -> int:
    """FLOPs of one B=1 ``upproj`` forward (``model_summary.summarize``,
    on the CPU; kept per shape, since it takes seconds at 450x800)."""
    from radar_depth_tpu_torch.model_summary import summarize

    return summarize(arch, height, width, "upproj")[2]


def card_keys(dev: torch.device, args, rate: float) -> dict:
    """The card's own keys of the infer line (module docstring)."""
    if dev.type != "cuda":
        sys.stderr.write("bench: no card, so no device, gflops_per_image, "
                         "model_tflops_per_sec, peak_tflops or mfu\n")
        return {}
    name = torch.cuda.get_device_name(dev)
    peak = PEAK_TFLOPS.get(name, {}).get(args.dtype)
    if peak is None:
        sys.stderr.write(f"bench: no dense {args.dtype} peak known for "
                         f"{name!r}, so no gflops_per_image, "
                         "model_tflops_per_sec, peak_tflops or mfu\n")
        return {"device": name}
    flops = forward_flops(args.arch, args.height, args.width)
    tfs = flops * rate / 1e12
    return {"gflops_per_image": round(flops / 1e9, 2),
            "model_tflops_per_sec": round(tfs, 2),
            "peak_tflops": peak, "mfu": round(tfs / peak, 4),
            "device": name}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--repeat", type=int, default=3,
                   help="timed repetitions of the measurement loop; the JSON "
                        "value is the median and min/max/mean ride along")
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--sweeps", type=int, default=5)
    p.add_argument("--arch", default="resnet18_multistage")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the stages (multistage archs)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="train mode: micro-batches per optimizer step "
                        "(effective batch = N x --batch)")
    p.add_argument("--mode", default="infer",
                   choices=["infer", "train", "stream"],
                   help="infer: preproc+forward, batch resident on the card; "
                        "train: full step incl. augmentation, backward, SGD "
                        "update; stream: a host->card upload per step, two "
                        "steps in flight")
    p.add_argument("--stream-iters", type=int, default=8,
                   help="stream mode: steps, each uploading a full batch")
    p.add_argument("--platform", default="default", choices=["default", "cpu"],
                   help="'default' runs on the CUDA card (and fails without "
                        "one); 'cpu' runs on the CPU")
    return p


def seeded_predictor(cfg, dev: torch.device, plain: bool = False):
    """A ``Predictor`` of ``cfg`` (a ``ServeConfig``) on ``dev`` with the
    seeded random weights of ``models.init_random(model, 0)``, for the
    tools whose numbers do not depend on the weights; ``plain=True`` runs
    the kernels' plain versions."""
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.models import create_model, init_random

    model = create_model(cfg.arch, device="cpu", decoder=cfg.decoder,
                         output_size=(cfg.height, cfg.width),
                         **cfg.arch_kwargs())[0]
    return Predictor(cfg, init_random(model, 0).state_dict(), device=dev,
                     plain=plain)


def build_model(args, dev: torch.device, train: bool = False):
    """(model, ArchSpec) as ``bench.py`` builds it, seeded weights. For
    training the weights are float32, computing in ``--dtype``, as the
    Trainer holds them; serving holds them in ``--dtype``, as
    ``Predictor`` does."""
    from radar_depth_tpu_torch.config import DTYPES
    from radar_depth_tpu_torch.models import create_model, init_random

    extra = {}
    if args.remat and "multistage" in args.arch:
        extra["remat"] = True
    if train:
        extra["param_dtype"] = torch.float32
    model, arch_spec = create_model(
        args.arch, device=dev, decoder="upproj",
        output_size=(args.height, args.width), dtype=DTYPES[args.dtype],
        **extra)
    return init_random(model, 0), arch_spec


def sample_spec(args) -> SampleSpec:
    return SampleSpec(height=args.height, width=args.width,
                      num_sweeps=args.sweeps, max_depth=80.0)


def bench_infer(args, dev: torch.device) -> dict:
    """Modes infer and stream."""
    spec = sample_spec(args)
    model, arch_spec = build_model(args, dev)
    infer = make_infer_fn(model, arch_spec, PreprocessConfig(spec=spec), dev)
    host = synthetic_batch(spec, args.batch)
    dts = time_resident(infer, resident(host, dev), args.iters, args.warmup,
                        args.repeat)
    rates = sorted(args.batch * args.iters / d for d in dts)
    per_chip = statistics.median(rates)

    if args.mode == "stream":
        def one_step(dev_batch):
            with torch.inference_mode():
                return infer(dev_batch).float().sum()

        def fetch(total):
            value = float(total)
            if not np.isfinite(value):
                raise AssertionError(f"prediction sum {value}")

        # two distinct host buffers, so no upload can reuse the last one
        host_a = host
        host_b = {k: v.copy() for k, v in host.items()}
        fetch(one_step(to_device(host_b, dev)))
        inflight = deque()
        t0 = time.perf_counter()
        for i in range(args.stream_iters):
            src = host_a if i % 2 == 0 else host_b
            inflight.append(one_step(to_device(src, dev)))
            if len(inflight) >= 2:
                fetch(inflight.popleft())
        while inflight:
            fetch(inflight.popleft())
        stream = args.batch * args.stream_iters / (time.perf_counter() - t0)
        return {"metric": "stream_images_per_sec_per_chip",
                "value": round(stream, 2), "unit": "img/s/chip",
                "resident_images_per_sec_per_chip": round(per_chip, 2)}

    out = {"metric": "images_per_sec_per_chip",
           "value": round(per_chip, 2), "unit": "img/s/chip",
           "repeats": len(rates), "min": round(rates[0], 2),
           "max": round(rates[-1], 2),
           "mean": round(sum(rates) / len(rates), 2)}
    out.update(card_keys(dev, args, per_chip))
    return out


def train_config(args):
    from radar_depth_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig, TrainConfig)

    return TrainConfig(
        data=DataConfig(height=args.height, width=args.width,
                        num_sweeps=args.sweeps),
        model=ModelConfig(arch=args.arch, dtype=args.dtype),
        optim=OptimConfig(grad_accum=max(1, args.grad_accum)),
        batch_size=args.batch)


def shard_path(spec: SampleSpec, n: int) -> str:
    """The bench's packed shard, under the temp directory (``$TMPDIR``),
    named apart from the JAX bench's."""
    return os.path.join(
        tempfile.gettempdir(),
        f"rdtp_torch_bench_{spec.height}x{spec.width}_s{spec.num_sweeps}"
        f"_n{n}", "data.rdtp")


def train_batch(args, cfg, host_aug: bool):
    """(stacked host batch, loader img/s or None, loader threads): one
    worker-augmented batch of the native loader (``grad_accum`` of them,
    stacked (A, B, ...)), or without the loader, synthetic
    micro-batches."""
    from radar_depth_tpu_torch.data.packed import (NativeBatchLoader,
                                                   PackedDataset, write_shard)

    spec = cfg.data.sample_spec()
    accum = cfg.optim.grad_accum
    threads = max(2, os.cpu_count() or 1)
    if not host_aug:
        micros = synthetic_batch(spec, args.batch * accum)
        if accum == 1:
            return micros, None, threads
        return ({k: v.reshape((accum, args.batch) + v.shape[1:])
                 for k, v in micros.items()}, None, threads)
    n_samples = max(2 * args.batch, 256)
    shard = shard_path(spec, n_samples)
    if not os.path.exists(shard):
        # written under another name and renamed: a run cut short leaves
        # no partial shard for the next run to read
        tmp = f"{shard}.{os.getpid()}.tmp"
        write_shard(tmp, synthetic_samples(spec, n_samples))
        os.replace(tmp, shard)
    dataset = PackedDataset(shard)
    loader = NativeBatchLoader(dataset, args.batch, shuffle=True, seed=0,
                               queue_depth=4, threads=threads,
                               augment=cfg.augment)
    try:
        next(loader)  # warm the workers and the page cache
        host_batches = 8
        recent = []
        t0 = time.perf_counter()
        for _ in range(host_batches):
            recent = (recent + [next(loader)])[-accum:]
        rate = args.batch * host_batches / (time.perf_counter() - t0)
        while len(recent) < accum:
            recent.append(next(loader))
    finally:
        loader.close()
        dataset.close()
    if accum == 1:
        return recent[0], rate, threads
    return ({k: np.stack([r[k] for r in recent]) for k in recent[0]}, rate,
            threads)


def bench_train(args, dev: torch.device) -> tuple:
    """Mode train: ``--warmup`` steps, then ``--iters`` steps timed, on one
    resident batch; the last loss fetched once. Returns (the JSON line,
    the resident batch, the last loss)."""
    from radar_depth_tpu_torch.data.packed import native_available
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import make_train_step

    cfg = train_config(args)
    accum = cfg.optim.grad_accum
    host_aug = native_available()
    host, loader_rate, loader_threads = train_batch(args, cfg, host_aug)
    batch = resident(host, dev)
    model, arch_spec = build_model(args, dev, train=True)
    state = create_train_state(model, cfg.optim, steps_per_epoch=1000)
    step = make_train_step(model, arch_spec, cfg, host_augmented=host_aug)
    gen = torch.Generator(device=dev).manual_seed(0)

    def steps(n):
        sums = None
        for _ in range(n):
            sums = step(state, batch, generator=gen)
        loss = float(sums["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"train loss {loss}")
        return loss

    if args.warmup > 0:
        steps(args.warmup)
    t0 = time.perf_counter()
    loss = steps(max(1, args.iters))
    dt = time.perf_counter() - t0
    per_chip = args.batch * accum * max(1, args.iters) / dt
    out = {"metric": "train_images_per_sec_per_chip",
           "value": round(per_chip, 2), "unit": "img/s/chip"}
    if accum > 1:
        out["grad_accum"] = accum
    if loader_rate is not None:
        out["loader_img_per_sec"] = round(loader_rate, 1)
        out["loader_threads"] = loader_threads
    return out, batch, loss


def run(argv=None) -> dict:
    """Parse ``argv``, run the mode, return its JSON line as a dict."""
    args = build_parser().parse_args(argv)
    dev = open_device(args.platform)
    use_deterministic_convs(dev)
    if args.mode == "train":
        return bench_train(args, dev)[0]
    return bench_infer(args, dev)


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
