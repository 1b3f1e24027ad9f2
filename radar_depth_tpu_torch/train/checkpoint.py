"""Checkpoints with the JAX package's semantics (``radar_depth_tpu/train/
checkpoint.py``, orbax there), written with ``torch.save``.

A run's checkpoints live in ``<output_dir>/checkpoints/<epoch>/``:
``checkpoint.pt``, the payload {model, optimizer, step, epoch, rmse} of
host tensors and plain values (``torch.load(..., weights_only=True)`` reads
it), and ``metrics.json`` ({"epoch", "rmse"}), read to pick the best step
without loading payloads. A save writes ``<epoch>.tmp-<pid>/`` and renames
it, so a process killed mid-save leaves no half checkpoint, only a tmp dir
that the next writer sweeps. Retention keeps the latest step and the best
``max_to_keep`` by val RMSE.

The state is copied to the host before ``save`` returns (the train step
updates the model in place); the write to disk runs in a background thread
and overlaps the next epoch, as orbax's async save does. Readers and
``close`` wait for it.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from radar_depth_tpu_torch.train.state import (
    TrainState,
    load_state_dict,
    state_to_dict,
)

PAYLOAD = "checkpoint.pt"
METRICS = "metrics.json"
_TMP = re.compile(r"\d+\.tmp-\d+")


def _sweep_stale_tmp(ckpt_dir: str) -> List[str]:
    """Remove ``<epoch>.tmp-<pid>`` dirs left by a save that was killed.
    Returns the removed paths."""
    removed = []
    if not os.path.isdir(ckpt_dir):
        return removed
    for name in os.listdir(ckpt_dir):
        if _TMP.fullmatch(name):
            path = os.path.join(ckpt_dir, name)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def _read_metrics(ckpt_dir: str) -> Dict[int, float]:
    """{step: rmse} of the complete checkpoints in ``ckpt_dir``."""
    out = {}
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name, METRICS)
        if name.isdigit() and os.path.isfile(path):
            with open(path) as f:
                out[int(name)] = float(json.load(f)["rmse"])
    return out


def _best(metrics: Dict[int, float]) -> Optional[int]:
    """The step of least RMSE (the earliest of equals), or None."""
    return min(metrics, key=lambda s: (metrics[s], s)) if metrics else None


def load_payload(step_dir: str) -> dict:
    return torch.load(os.path.join(step_dir, PAYLOAD), map_location="cpu",
                      weights_only=True)


class CheckpointManager:
    def __init__(self, output_dir: str, max_to_keep: int = 3,
                 sweep_stale: bool = True):
        """``sweep_stale`` must be False for read-only openers (--evaluate,
        a --resume from another run): a live writer's save in flight has the
        same tmp naming. Writers hold the run lock (``utils/runlock.py``), so
        their sweep sees only the leftovers of dead predecessors."""
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.max_to_keep = max_to_keep
        self._writer = sweep_stale
        if sweep_stale:
            os.makedirs(self.dir, exist_ok=True)
            for path in _sweep_stale_tmp(self.dir):
                print(f"removed stale interrupted-save dir {path}")
        self._metrics = _read_metrics(self.dir)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # per save: epoch, seconds of the host snapshot and of the write,
        # bytes of the payload
        self.saves: List[Dict[str, float]] = []

    # ---------------------------------------------------------------- write

    def save(self, epoch: int, state: TrainState, metrics: Dict[str, float],
             wait: bool = False) -> None:
        """Snapshot ``state`` to the host now; write it in the background
        (``wait=True``: before returning). A save in flight finishes
        first."""
        if not self._writer:
            raise RuntimeError(f"{self.dir} was opened read-only")
        self.wait_until_finished()
        rmse = float(metrics.get("rmse", math.inf))
        t0 = time.perf_counter()
        payload = dict(state_to_dict(state), epoch=int(epoch), rmse=rmse)
        record = {"epoch": int(epoch),
                  "snapshot_seconds": time.perf_counter() - t0}
        self.saves.append(record)
        self._thread = threading.Thread(target=self._write,
                                        args=(int(epoch), payload, record),
                                        name="checkpoint-write")
        self._thread.start()
        if wait:
            self.wait_until_finished()

    def _write(self, epoch: int, payload: dict, record: dict) -> None:
        try:
            t0 = time.perf_counter()
            tmp = os.path.join(self.dir, f"{epoch}.tmp-{os.getpid()}")
            final = os.path.join(self.dir, str(epoch))
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, PAYLOAD))
            with open(os.path.join(tmp, METRICS), "w") as f:
                json.dump({"epoch": epoch, "rmse": payload["rmse"]}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._metrics[epoch] = payload["rmse"]
            self._retain(latest=epoch)
            record["write_seconds"] = time.perf_counter() - t0
            record["bytes"] = os.path.getsize(os.path.join(final, PAYLOAD))
        except Exception as e:  # re-raised by wait_until_finished
            self._error = e

    def _retain(self, latest: int) -> None:
        """Keep the latest step and the best ``max_to_keep`` by RMSE."""
        ranked = sorted(self._metrics, key=lambda s: (self._metrics[s], s))
        keep = set(ranked[:self.max_to_keep]) | {latest}
        for step in list(self._metrics):
            if step not in keep:
                shutil.rmtree(os.path.join(self.dir, str(step)),
                              ignore_errors=True)
                del self._metrics[step]

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    # ----------------------------------------------------------------- read

    def all_steps(self) -> List[int]:
        self.wait_until_finished()
        return sorted(self._metrics)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        self.wait_until_finished()
        return _best(self._metrics)

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, int, float]:
        """Load the latest (or ``step``) checkpoint into ``state``. Returns
        (state, epoch, best RMSE over the latest and best steps), as the
        reference's --resume restores model, optimizer, epoch and best."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        payload = load_payload(os.path.join(self.dir, str(step)))
        load_state_dict(state, payload)
        best_rmse = float(payload["rmse"])
        best = self.best_step()
        if best is not None:
            best_rmse = min(best_rmse, self._metrics[best])
        return state, int(payload["epoch"]), best_rmse

    def close(self) -> None:
        self.wait_until_finished()


def resolve_checkpoint(path: str) -> str:
    """The step directory that --evaluate / ``Predictor.from_run`` load: a
    numeric step directory as given, else the best (else latest) step of a
    run directory or of its ``checkpoints/``."""
    path = os.path.abspath(path)
    if os.path.basename(path).isdigit():
        if not os.path.isfile(os.path.join(path, PAYLOAD)):
            raise FileNotFoundError(f"no checkpoint in {path}")
        return path
    if os.path.basename(path) != "checkpoints":
        path = os.path.join(path, "checkpoints")
    metrics = _read_metrics(path)
    step = _best(metrics)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return os.path.join(path, str(step))


def restore_for_evaluate(path: str, state: TrainState) -> TrainState:
    """--evaluate CKPT: load the checkpoint ``resolve_checkpoint(path)``
    names into ``state``. Never sweeps or writes."""
    return load_state_dict(state, load_payload(resolve_checkpoint(path)))
