"""Exclusive run-directory lock for trainers
(``radar_depth_tpu/utils/runlock.py``).

Two trainers writing one output directory interleave CSV rows and collide on
checkpoint saves; the lock makes the second fail at once. Ownership is a
kernel flock(2) on ``<output_dir>/.trainer.lock``, not the file's existence:
the kernel releases it when the holder dies, so a killed run never blocks
its own --resume. The holder's pid is written into the file for the error
message only, and the file is never unlinked (a waiter on the old inode and
a newcomer on a new one would both "hold" it).
"""

from __future__ import annotations

import fcntl
import os
from typing import Dict

LOCK_NAME = ".trainer.lock"

_HELD: Dict[str, list] = {}  # abspath -> [fd holding the flock, refcount]


def acquire_run_lock(output_dir: str) -> str:
    """flock ``<output_dir>/.trainer.lock``; RuntimeError if another live
    process holds it. A lock this process holds already is refcounted (two
    Trainers of one process on one directory). Returns the lock path."""
    path = os.path.abspath(os.path.join(output_dir, LOCK_NAME))
    held = _HELD.get(path)
    if held is not None:
        held[1] += 1
        return path
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        try:
            holder = os.read(fd, 64).decode(errors="replace").strip() or "?"
        except OSError:
            holder = "?"
        os.close(fd)
        raise RuntimeError(
            f"{output_dir} is being written by a live trainer "
            f"(pid {holder}, lock {path}). Two trainers sharing an output "
            "dir corrupt CSVs and checkpoints — pick another --output-dir, "
            "or wait for that process to exit.") from None
    os.ftruncate(fd, 0)
    os.write(fd, f"{os.getpid()}\n".encode())
    _HELD[path] = [fd, 1]
    return path


def release_run_lock(path: str) -> None:
    """Release one acquisition; the flock drops with the last one. A path
    this process does not hold is a no-op."""
    path = os.path.abspath(path)
    held = _HELD.get(path)
    if held is None:
        return
    held[1] -= 1
    if held[1] > 0:
        return
    del _HELD[path]
    fd = held[0]
    try:
        os.ftruncate(fd, 0)  # clear the pid hint
    except OSError:
        pass
    os.close(fd)  # closing the fd releases the flock
