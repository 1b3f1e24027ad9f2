#!/usr/bin/env python3
"""Pinned upload staging against the pageable copy for the served flagship,
on one CUDA card: the measurement behind keeping the pageable copy in
``Predictor``.

    python3 scripts/torch_pinned_upload.py [--rounds 8] [--batch 8]

The flagship (``resnet18_multistage`` + ``upproj``, 450x800, 5 sweeps,
bfloat16, seeded random weights) served through ``Predictor.infer`` in three
modes, in turns (the order reversed every round): ``eager`` (no graph,
pageable upload), ``graph_pageable`` (the graph with ``to_device``'s
pageable copy, the package's path) and ``graph_pinned`` (the graph with the
tile staged through pinned host buffers, one per input and tile shape, sent
without waiting for the card; an event recorded after the copies guards the
buffers' next write). Per mode and round: host ms of ``infer`` on the numpy
tile (upload and enqueue, the card idle before) and e2e ms of the tile to a
host map. Prints one JSON line with every round, the medians and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MODES = ("eager", "graph_pageable", "graph_pinned")


class PinnedUpload:
    """A tile sent up through pinned host buffers, one per input and tile
    shape, without waiting for the card."""

    def __init__(self, torch, dev):
        self.torch, self.dev, self.bufs = torch, dev, {}

    def __call__(self, np, batch):
        t = self.torch
        key = tuple((k, v.shape, v.dtype.str) for k, v in batch.items())
        if key not in self.bufs:
            self.bufs[key] = ({k: t.from_numpy(np.empty_like(v)).pin_memory()
                               for k, v in batch.items()}, t.cuda.Event())
        bufs, copied = self.bufs[key]
        copied.synchronize()  # the previous tile's copies have left
        for k, v in batch.items():
            np.copyto(bufs[k].numpy(), v)
        out = {k: b.to(self.dev, non_blocking=True) for k, b in bufs.items()}
        copied.record()
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_pinned_upload: no CUDA device", file=sys.stderr)
        return 2
    from radar_depth_tpu_torch import bench, graphs
    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.data import SampleSpec
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.models import create_model, init_random

    h, w = 450, 800
    dev = torch.device("cuda", 0)
    sd = init_random(create_model("resnet18_multistage", device="cpu",
                                  output_size=(h, w))[0], 0).state_dict()
    pred = Predictor(ServeConfig(arch="resnet18_multistage",
                                 decoder="upproj", height=h, width=w,
                                 num_sweeps=5, dtype="bfloat16"), sd,
                     device=dev)
    batch = bench.synthetic_batch(SampleSpec(height=h, width=w,
                                             num_sweeps=5), args.batch, 1)
    pinned = PinnedUpload(torch, dev)

    def infer(mode):
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            return pred.infer(pinned(np, batch) if mode == "graph_pinned"
                              else batch)

    for mode in MODES:  # every path warm: graphs captured, buffers pinned
        infer(mode).cpu(), infer(mode).cpu()
    host, e2e = ({m: [] for m in MODES} for _ in range(2))
    for r in range(args.rounds):
        for mode in (MODES if r % 2 == 0 else MODES[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infer(mode)
            host[mode].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infer(mode).cpu().numpy()
            e2e[mode].append((time.perf_counter() - t0) * 1e3)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    med = statistics.median
    print(json.dumps({
        "nvidia_smi": smi, "batch": args.batch, "dtype": "bfloat16",
        "host_ms": {m: med(v) for m, v in host.items()},
        "e2e_ms": {m: med(v) for m, v in e2e.items()},
        "pinned_faster_than_pageable": med(e2e["graph_pinned"])
        < med(e2e["graph_pageable"]),
        "host_ms_all": host, "e2e_ms_all": e2e}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
