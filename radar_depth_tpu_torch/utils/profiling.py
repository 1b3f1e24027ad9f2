"""Tracing and profiling helpers, the counterpart of
``radar_depth_tpu/utils/profiling.py`` on ``torch.profiler``.

The reference only has wall-clock meters (data_time / gpu_time, timed
around a device synchronise), which flow through the CSV logs
(``utils/csvlog.py``); ``StepTimer`` keeps them. Beyond the reference: a
trace of a block (``device_trace``), viewable in Perfetto or
``chrome://tracing``, or in TensorBoard's profiler plugin, and named
regions in it (``annotate``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Mapping

import torch

from radar_depth_tpu_torch.device import as_device


@contextlib.contextmanager
def device_trace(log_dir: str, device: str | torch.device | None = None
                 ) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block into a ``*.pt.trace.json`` file under
    ``log_dir`` (``torch.profiler.tensorboard_trace_handler``, which needs
    no ``tensorboard`` package):

        with device_trace("runs/exp1/trace"):
            train_step(...)

    ``device=None`` means the card, and raises without one: the trace holds
    the host's operators and the card's kernels and copies.
    ``device="cpu"`` traces the host only. Yields the profiler."""
    dev = as_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, Mapping):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class StepTimer:
    """data_time / gpu_time accounting for one loop iteration, mirroring
    the reference's AverageMeter use in train() / validate()."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self._t = time.perf_counter()

    def data_done(self):
        now = time.perf_counter()
        self.data_time = now - self._t
        self._t = now

    def step_done(self, result=None):
        """End the step once ``result`` (a tensor, or a dict, list or tuple
        of them) is computed: the card of each CUDA tensor in it is
        synchronised first; a CPU result is ready when the call returns."""
        for dev in _cuda_devices(result, set()):
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        self.step_time = now - self._t
        self._t = now
