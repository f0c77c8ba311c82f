"""Frame-stage profiling utilities (``websplat_tpu/utils/stopwatch.py``).

The reference profiles its GPU stages with timestamp queries
(``GPUStopwatch``, web-splat utils.rs:26-134) and shows a 512-frame plot
(ui.rs:61-92, RingBuffer utils.rs:136-176).  Here :class:`StageStopwatch`
times labeled stages with CUDA events recorded on the current stream of a
CUDA device (the device timeline of the stage's work, read once at
``take_measurements``), or with the host clock on the CPU, and
:class:`FrameClock` tracks the wall-clock EMA FPS like the viewer
(lib.rs:839).
"""

from __future__ import annotations

import time
from typing import Dict, Generic, List, Optional, TypeVar

import torch

T = TypeVar("T")


class RingBuffer(Generic[T]):
    """Fixed-capacity history (utils.rs:136-176); used for frame-time plots."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._data: List[T] = []
        self._pos = 0

    def push(self, item: T) -> None:
        if len(self._data) < self.capacity:
            self._data.append(item)
        else:
            self._data[self._pos] = item
        self._pos = (self._pos + 1) % self.capacity

    def __len__(self) -> int:
        return len(self._data)

    def to_list(self) -> List[T]:
        """Oldest-to-newest."""
        if len(self._data) < self.capacity:
            return list(self._data)
        return self._data[self._pos:] + self._data[: self._pos]


class FrameClock:
    """EMA FPS tracker (lib.rs:839: fps = new*0.05 + fps*0.95)."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.fps = 0.0
        self._last: Optional[float] = None
        self.history: RingBuffer[float] = RingBuffer(512)

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            self.fps = (1.0 / dt) * self.alpha + self.fps * (1.0 - self.alpha)
            self.history.push(dt)
        self._last = now
        return self.fps


class StageStopwatch:
    """Labeled stage timings.

    Usage::

        sw = StageStopwatch("cuda")          # or "cpu"
        with sw.stage("preprocess"):
            out = f(x)                       # work queued on the stream
        sw.take_measurements()  # -> {"preprocess": seconds}

    On a CUDA device each stage records a start and an end event on the
    current stream and nothing waits until ``take_measurements``
    synchronises once; on the CPU the stage is timed by the host clock.
    The device defaults to the card, as every entry point of the package
    does; "cuda" raises where CUDA is absent."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        self._open: Dict[str, object] = {}
        self._done: Dict[str, object] = {}

    def _now(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    class _Ctx:
        def __init__(self, sw, label):
            self.sw = sw
            self.label = label

        def __enter__(self):
            self.sw._open[self.label] = self.sw._now()
            return self

        def __exit__(self, *exc):
            start = self.sw._open.pop(self.label)
            self.sw._done[self.label] = (start, self.sw._now())
            return False

    def stage(self, label: str) -> "_Ctx":
        return self._Ctx(self, label)

    def take_measurements(self) -> Dict[str, float]:
        """Returns and clears the completed stage durations (seconds),
        mirroring GPUStopwatch::take_measurements (utils.rs:100-134)."""
        if self.device.type == "cuda" and self._done:
            torch.cuda.synchronize(self.device)
            out = {k: a.elapsed_time(b) / 1e3 for k, (a, b) in self._done.items()}
        else:
            out = {k: b - a for k, (a, b) in self._done.items()}
        self._done.clear()
        return out
