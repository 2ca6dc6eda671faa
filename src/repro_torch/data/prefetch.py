"""Background prefetcher with a bounded queue + straggler watchdog (a copy
of ``repro.data.prefetch``).

The producer thread runs the host-side work (pack + HGum SER); the
consumer (training loop) pops ready wires and decodes them on the device,
so the thread never touches CUDA.  ``StragglerWatchdog`` tracks per-step
wall time and flags steps slower than ``threshold x`` the trailing median —
the launcher reacts by forcing an early checkpoint (see
``launch/train.py``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional


class Prefetcher:
    def __init__(self, make_item: Callable[[], object], depth: int = 2):
        self.make_item = make_item
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                item = self.make_item()
                while not self._stop.is_set():
                    try:
                        self.q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface in consumer
            self._exc = e

    def get(self, timeout: float = 60.0):
        if self._exc is not None:
            raise self._exc
        return self.q.get(timeout=timeout)

    def close(self):
        self._stop.set()
        # drain so the producer unblocks
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=5.0)


class StragglerWatchdog:
    """Flags steps slower than `threshold` x trailing-median step time."""

    def __init__(self, threshold: float = 3.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times = []
        self.flagged = 0
        self._t0 = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Record one step; True when the step was a straggler."""
        dt = time.monotonic() - self._t0
        slow = False
        if len(self.times) >= 8:
            med = sorted(self.times[-self.window :])[len(self.times[-self.window :]) // 2]
            slow = dt > self.threshold * med
        self.times.append(dt)
        if slow:
            self.flagged += 1
        return slow
