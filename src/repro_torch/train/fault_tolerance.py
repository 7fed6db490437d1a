"""Fault tolerance for long training runs: preemption, stragglers,
restart.  The PyTorch port's copy of the JAX package's
``train/fault_tolerance.py`` (pure Python).

Mechanisms (each independent, composed by the runner in launch/train.py):

- ``PreemptionGuard``: converts SIGTERM/SIGINT into a checked flag; the
  training loop polls it once per step and performs an *emergency
  checkpoint* + clean exit instead of dying mid-step.
- ``Heartbeat``: per-step progress file (step, wallclock).  An external
  supervisor (or the provided ``watchdog``) detects a wedged/lost worker
  by heartbeat age and restarts the job from the last committed
  checkpoint — crash tolerance without in-band consensus.
- ``StepTimer``: per-step duration EMA + straggler detection (a step
  slower than ``straggler_factor`` x the EMA after ``warmup`` steps).
- ``run_with_restarts``: in-process supervisor loop — run fn, on crash
  restore from the checkpoint dir and retry (bounded); models the
  cluster-level restart controller so the whole recover path is testable.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Callable, Dict, List, Optional


class PreemptionGuard:
    """SIGTERM/SIGINT -> flag; poll with .should_stop once per step."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag


class Heartbeat:
    """Append-free single-file heartbeat: {step, time, host}."""

    def __init__(self, path: str, host_id: int = 0):
        self.path = path
        self.host_id = host_id
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, **extra) -> None:
        tmp = f"{self.path}.tmp{self.host_id}"
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "time": time.time(),
                       "host": self.host_id, **extra}, f)
        os.replace(tmp, self.path)

    def age(self) -> Optional[float]:
        try:
            with open(self.path) as f:
                return time.time() - json.load(f)["time"]
        except (OSError, ValueError, KeyError):
            return None


def watchdog(heartbeats: List[Heartbeat], max_age_s: float) -> List[int]:
    """Hosts whose heartbeat is stale (dead or wedged)."""
    stale = []
    for hb in heartbeats:
        age = hb.age()
        if age is None or age > max_age_s:
            stale.append(hb.host_id)
    return stale


class StepTimer:
    """EMA step timing + straggler flagging (step > factor * median-ish)."""

    def __init__(self, ema: float = 0.9, straggler_factor: float = 2.0,
                 warmup: int = 5):
        self.ema = ema
        self.factor = straggler_factor
        self.warmup = warmup
        self.mean: Optional[float] = None
        self.count = 0
        self.stragglers = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> Dict:
        dt = time.perf_counter() - self._t0
        self.count += 1
        is_straggler = False
        if self.mean is None:
            self.mean = dt
        else:
            if self.count > self.warmup and dt > self.factor * self.mean:
                is_straggler = True
                self.stragglers += 1
            self.mean = self.ema * self.mean + (1 - self.ema) * dt
        return {"step_time": dt, "step_time_ema": self.mean,
                "straggler": is_straggler}


def run_with_restarts(make_and_run: Callable[[int], int],
                      max_restarts: int = 3,
                      retriable=(RuntimeError, OSError)) -> int:
    """In-process restart controller.

    ``make_and_run(attempt)`` must restore from its checkpoint directory
    (if any) and return the final step.  Crash -> restart, bounded.
    """
    attempt = 0
    while True:
        try:
            return make_and_run(attempt)
        except retriable:
            attempt += 1
            if attempt > max_restarts:
                raise
