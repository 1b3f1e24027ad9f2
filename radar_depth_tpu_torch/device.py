"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fallback.

Every entry point (``create_model`` and so the Trainer, ``Predictor``,
``load_serving``, ``make_mesh``, the HTTP daemon, the export CLI, the eval
and summary tools) resolves its device through ``resolve_device``, which
also sets the process's float32 precision (``use_ieee_float32``): the JAX
package pins ``Precision.HIGHEST`` on every conv and resize matmul, and
torch would run float32 cuDNN convolutions in TF32 by default. Importing
the port changes nothing; building any of its entry points does, for the
whole process, since cuDNN's flags are process-wide (a context around each
call would not hold against other threads, nor reach ``torchrun``'s other
ranks)."""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"


def use_ieee_float32() -> None:
    """IEEE float32 (TF32 off) for cuDNN convolutions and CUDA matmuls in
    this process, on any device (on the CPU the flags read back and change
    nothing that runs). Set through ``torch.backends.cudnn.allow_tf32`` and
    ``torch.set_float32_matmul_precision``, which torch's per-op
    ``fp32_precision`` attributes read back consistently; setting those
    attributes instead makes the ``allow_tf32`` getters raise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def use_deterministic_convs(dev: torch.device) -> None:
    """cuDNN's deterministic algorithms on the card, process-wide: a train
    step, and an eager forward, give the same bits every run."""
    if dev.type == "cuda":
        torch.backends.cudnn.deterministic = True


def as_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card: ``cuda:LOCAL_RANK`` in a process that
    ``torchrun`` started (one card per rank), else ``cuda``. A CUDA device
    without a card raises; the CPU runs only when it is asked for by
    name. No side effect: the per-call form, for the ops that every
    forward or step runs."""
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"{DEFAULT_DEVICE}:{int(os.environ['LOCAL_RANK'])}"
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "radar_depth_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``as_device`` for an entry point: it also sets the process to IEEE
    float32 (``use_ieee_float32``)."""
    dev = as_device(device)
    use_ieee_float32()
    return dev
