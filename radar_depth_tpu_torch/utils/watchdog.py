"""Stall watchdog for long device loops (``radar_depth_tpu/utils/
watchdog.py``).

A wedged device can block a launch or a copy forever with no error.
Checkpoints are atomic and --resume is exact, so the run should die loudly
once nothing has progressed for a generous window: a resumable crash
instead of a silent hang. A Python thread cannot interrupt a blocked C call,
so the watchdog hard-exits the process (``os._exit``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class StallWatchdog:
    """Calls ``on_stall(seconds_stalled)`` when ``beat()`` has not been
    called for ``timeout`` seconds. The default prints a diagnostic and
    exits with code 86 (resumable crash). ``clock`` and ``on_stall`` are
    injectable for tests; ``timeout <= 0`` disables it."""

    EXIT_CODE = 86

    def __init__(self, timeout: float, context: str = "",
                 on_stall: Optional[Callable[[float], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 poll: Optional[float] = None):
        self.timeout = float(timeout)
        self.context = context
        self._clock = clock
        self._poll = poll if poll is not None else max(1.0, timeout / 20.0)
        self._on_stall = on_stall or self._default_on_stall
        self._last = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _default_on_stall(self, stalled: float) -> None:
        import os
        import sys

        sys.stderr.write(
            f"StallWatchdog: no progress for {stalled:.0f}s "
            f"(timeout {self.timeout:.0f}s)"
            f"{' in ' + self.context if self.context else ''} — the device "
            "is likely wedged. Exiting 86; checkpoints are atomic, restart "
            "with --resume.\n")
        sys.stderr.flush()
        os._exit(self.EXIT_CODE)

    def beat(self) -> None:
        """Mark progress: one clock read and a store, call it per step."""
        self._last = self._clock()

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            stalled = self._clock() - self._last
            if stalled > self.timeout:
                self._on_stall(stalled)
                return

    def start(self) -> "StallWatchdog":
        if self.timeout <= 0:
            return self
        self._last = self._clock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
