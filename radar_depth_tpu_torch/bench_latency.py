"""Serving latency of the port, flag for flag the JAX package's
``scripts/bench_latency.py``: the per-request latency distribution of the
raw batch -> preprocessing -> two-stage forward path of ``Predictor``, on
one CUDA card (``--platform cpu`` for the CPU):

    python -m radar_depth_tpu_torch.bench_latency [--batches 1,8,32]

Two measurements per batch size:
  device  the batch resident on the card, ``Predictor.infer`` and one
          element of its map fetched per request (``out[0, 0, 0].item()``):
          the service time of preprocessing and forward
  e2e     ``Predictor.predict`` of the host batch per request: upload,
          infer and the full map fetched

Prints one JSON line per batch size:
  {"batch": B, "device_ms": {p50, p90, p99, mean}, "e2e_ms": {...},
   "device_img_per_sec": N}
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from radar_depth_tpu_torch.bench import (
    open_device,
    resident,
    seeded_predictor,
    synthetic_batch,
)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def dist(xs):
    return {"p50": round(pct(xs, 50), 2), "p90": round(pct(xs, 90), 2),
            "p99": round(pct(xs, 99), 2),
            "mean": round(float(np.mean(xs) * 1e3), 2)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", default="1,8,32",
                   help="comma-separated batch sizes")
    p.add_argument("--requests", type=int, default=30)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--sweeps", type=int, default=5)
    p.add_argument("--arch", default="resnet18_multistage")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--run", default="",
                   help="optional run dir (Predictor.from_run); default "
                        "seeded random weights (latency does not depend on "
                        "the weights)")
    p.add_argument("--platform", default="default", choices=["default", "cpu"],
                   help="'default' runs on the CUDA card (and fails without "
                        "one); 'cpu' runs on the CPU")
    return p


def make_predictor(args, dev):
    """``Predictor.from_run(--run)`` with the flags' data and model config,
    else a Predictor of seeded random weights."""
    from radar_depth_tpu_torch.config import (DataConfig, ModelConfig,
                                              ServeConfig, TrainConfig)
    from radar_depth_tpu_torch.inference import Predictor

    if args.run:
        cfg = TrainConfig(
            data=DataConfig(height=args.height, width=args.width,
                            num_sweeps=args.sweeps),
            model=ModelConfig(arch=args.arch, dtype=args.dtype))
        return Predictor.from_run(args.run, cfg, device=dev)
    return seeded_predictor(
        ServeConfig(arch=args.arch, dtype=args.dtype, height=args.height,
                    width=args.width, num_sweeps=args.sweeps), dev)


def latency(pred, b: int, requests: int, warmup: int) -> dict:
    """One batch size's JSON line."""
    host = synthetic_batch(pred.cfg.sample_spec(), b)

    # the service time on the card: one element fetched per request
    dev_batch = resident(host, pred.device)
    for _ in range(warmup):
        pred.infer(dev_batch)[0, 0, 0].item()
    lat_dev = []
    for _ in range(requests):
        t0 = time.perf_counter()
        pred.infer(dev_batch)[0, 0, 0].item()
        lat_dev.append(time.perf_counter() - t0)

    # end to end: upload, infer and the whole map fetched per request
    for _ in range(warmup):
        pred.predict(host)
    lat_e2e = []
    for _ in range(requests):
        t0 = time.perf_counter()
        pred.predict(host)
        lat_e2e.append(time.perf_counter() - t0)

    return {"batch": b, "device_ms": dist(lat_dev), "e2e_ms": dist(lat_e2e),
            "device_img_per_sec": round(b / float(np.median(lat_dev)), 1)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pred = make_predictor(args, open_device(args.platform))
    try:
        for b in [int(x) for x in args.batches.split(",")]:
            print(json.dumps(latency(pred, b, args.requests, args.warmup)),
                  flush=True)
    finally:
        pred.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
