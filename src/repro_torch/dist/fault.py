"""Fault-tolerance hooks of the port (counterpart of
``repro.dist.fault``): straggler detection, a wedged-step watchdog and
the elastic re-plan of a (data, model) mesh after devices are lost
(:func:`pow2_mesh_shape`; ``ckpt.restore_elastic`` then reads a
checkpoint onto the new mesh)."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from statistics import median as _median
from typing import Callable, List, Optional, Tuple


@dataclass(frozen=True)
class StragglerEvent:
    step: int
    duration: float
    median: float


class StepMonitor:
    """Flags steps that take ``straggler_factor`` x the running median.

    Pure bookkeeping — the training loop calls :meth:`step_started` /
    :meth:`step_finished`; the injected ``clock`` makes it testable.
    """

    def __init__(self,
                 straggler_factor: float = 3.0,
                 on_straggler: Optional[Callable[[StragglerEvent],
                                                 None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 window: int = 64,
                 min_history: int = 3):
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self.clock = clock
        self.window = window
        self.min_history = min_history
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None
        self._step: Optional[int] = None

    def step_started(self, step: int) -> None:
        self._step = step
        self._t0 = self.clock()

    def step_finished(self, step: int) -> None:
        if self._t0 is None or self._step != step:
            return
        dur = self.clock() - self._t0
        self._t0 = None
        if len(self.durations) >= self.min_history:
            med = _median(self.durations[-self.window:])
            if med > 0 and dur > self.straggler_factor * med:
                ev = StragglerEvent(step, dur, med)
                self.events.append(ev)
                if self.on_straggler is not None:
                    self.on_straggler(ev)
        self.durations.append(dur)

    @property
    def median(self) -> float:
        return _median(self.durations) if self.durations else 0.0


class Watchdog:
    """Calls ``on_timeout`` if :meth:`feed` isn't called for ``timeout``
    seconds — catches fully wedged steps (collective deadlock) that the
    straggler monitor can't see because the step never finishes."""

    def __init__(self, timeout: float, on_timeout: Callable[[], None]):
        self.timeout = timeout
        self.on_timeout = on_timeout
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._stopped = False

    def _arm(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
            if self._stopped:
                return
            self._timer = threading.Timer(self.timeout, self._fire)
            self._timer.daemon = True
            self._timer.start()

    def _fire(self) -> None:
        with self._lock:
            if self._stopped:
                return
        self.on_timeout()

    def start(self) -> "Watchdog":
        self._stopped = False
        self._arm()
        return self

    def feed(self) -> None:
        self._arm()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None


def pow2_mesh_shape(chips: int, max_model: int = 16) -> Tuple[int, int]:
    """Re-plan a (data, model) mesh after elastic chip loss: the largest
    power-of-two subset of survivors, with the model axis capped (TP
    beyond ~16 ways is collective-bound — the paper's Table-1-style
    bound on the design space)."""
    assert chips >= 1
    total = 1
    while total * 2 <= chips:
        total *= 2
    mp = 1
    while mp * 2 <= min(max_model, total):
        mp *= 2
    return total // mp, mp
