"""Per-epoch CSV logs in the reference's schema, the parity surface of a run
(``radar_depth_tpu/utils/csvlog.py``): train.csv / test.csv rows with the
same fieldnames and 6-decimal values, and the one-line best.txt."""

from __future__ import annotations

import csv
import os
from typing import Dict

FIELDNAMES = ["epoch", "mse", "rmse", "absrel", "lg10", "mae",
              "delta1", "delta2", "delta3", "data_time", "gpu_time"]


class EpochCSVLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=FIELDNAMES).writeheader()

    def append(self, epoch: int, metrics: Dict[str, float]) -> None:
        row = {"epoch": epoch}
        for k in FIELDNAMES[1:]:
            row[k] = f"{float(metrics.get(k, 0.0)):.6f}"
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=FIELDNAMES).writerow(row)


def write_best_txt(path: str, epoch: int, metrics: Dict[str, float]) -> None:
    """One human-readable line for the best epoch so far."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "epoch={epoch}, rmse={rmse:.4f}, mae={mae:.4f}, absrel={absrel:.4f}, "
            "lg10={lg10:.4f}, delta1={delta1:.4f}, delta2={delta2:.4f}, "
            "delta3={delta3:.4f}\n".format(epoch=epoch, **{
                k: float(metrics.get(k, 0.0))
                for k in ("rmse", "mae", "absrel", "lg10",
                          "delta1", "delta2", "delta3")
            })
        )
