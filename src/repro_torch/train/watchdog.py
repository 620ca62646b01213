"""Training fault tolerance: NaN/stall watchdog, straggler detection, and
auto-rollback bookkeeping.

On a real multi-pod deployment the same hooks run per-host and feed the
coordinator; here they guard the training loop:

  * NaN/inf loss -> raise RollbackSignal (the trainer restores the last
    checkpoint and, after repeated failures, reduces LR),
  * step-time EMA straggler detection: a step slower than
    `straggler_factor` x EMA flags a straggler event (on hardware: report
    the slow host for eviction / re-mesh),
  * stall detection: loss EMA not improving for `stall_patience` steps.

The reference package's `train/watchdog.py`, copied (pure Python; the
docstring reworded).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional


class RollbackSignal(Exception):
    def __init__(self, reason: str, step: int):
        super().__init__(f"rollback at step {step}: {reason}")
        self.reason = reason
        self.step = step


@dataclasses.dataclass
class WatchdogConfig:
    straggler_factor: float = 3.0
    step_ema_alpha: float = 0.2
    loss_ema_alpha: float = 0.05
    stall_patience: int = 200
    max_loss_spike: float = 4.0       # x loss EMA triggers rollback


class Watchdog:
    def __init__(self, cfg: WatchdogConfig = WatchdogConfig()):
        self.cfg = cfg
        self.step_ema: Optional[float] = None
        self.loss_ema: Optional[float] = None
        self.best_loss = math.inf
        self.since_best = 0
        self.straggler_events: List[dict] = []
        self.rollbacks: List[dict] = []
        self._t_last: Optional[float] = None

    def begin_step(self):
        self._t_last = time.monotonic()

    def end_step(self, step: int, loss: float) -> dict:
        """Returns event dict; raises RollbackSignal on fatal anomalies."""
        dt = time.monotonic() - self._t_last if self._t_last else 0.0
        events = {}
        # straggler detection
        if self.step_ema is not None and dt > self.cfg.straggler_factor \
                * self.step_ema:
            ev = {"step": step, "step_time": dt, "ema": self.step_ema}
            self.straggler_events.append(ev)
            events["straggler"] = ev
        a = self.cfg.step_ema_alpha
        self.step_ema = dt if self.step_ema is None else \
            (1 - a) * self.step_ema + a * dt

        # NaN / divergence
        if not math.isfinite(loss):
            self.rollbacks.append({"step": step, "reason": "nan"})
            raise RollbackSignal("non-finite loss", step)
        if self.loss_ema is not None and \
                loss > self.cfg.max_loss_spike * max(self.loss_ema, 1e-9):
            self.rollbacks.append({"step": step, "reason": "spike"})
            raise RollbackSignal(
                f"loss spike {loss:.3f} vs ema {self.loss_ema:.3f}", step)
        b = self.cfg.loss_ema_alpha
        self.loss_ema = loss if self.loss_ema is None else \
            (1 - b) * self.loss_ema + b * loss

        # stall
        if loss < self.best_loss - 1e-6:
            self.best_loss = loss
            self.since_best = 0
        else:
            self.since_best += 1
        if self.since_best >= self.cfg.stall_patience:
            events["stall"] = {"step": step, "since_best": self.since_best}
            self.since_best = 0
        return events
