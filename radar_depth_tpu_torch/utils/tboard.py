"""Optional TensorBoard scalars (``radar_depth_tpu/utils/tboard.py``): per
epoch under train/ and val/, through ``torch.utils.tensorboard`` when the
``tensorboard`` package is installed, else a no-op with a one-time
notice."""

from __future__ import annotations

from typing import Dict


class TensorBoardLogger:
    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:
            print("tensorboard logging disabled (tensorboard unavailable)")

    def log(self, prefix: str, epoch: int, metrics: Dict[str, float]) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(f"{prefix}/{k}", v, global_step=epoch)
        self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
