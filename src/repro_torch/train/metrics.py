"""Training metrics logging + straggler watchdog.

The watchdog implements the brief's straggler mitigation at the framework
level: each step must complete within ``deadline_s``; violations are
counted, logged and surfaced (at cluster scale the same hook triggers
hot-spare swap / grace restarts — here it marks and accounts).

The port's copy of ``repro/train/metrics.py`` (stdlib only)."""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class StepTimer:
    deadline_s: float = 0.0           # 0 = disabled
    slow_steps: int = 0
    total_steps: int = 0
    worst_s: float = 0.0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> tuple[float, bool]:
        dt = time.perf_counter() - self._t0
        self.total_steps += 1
        self.worst_s = max(self.worst_s, dt)
        slow = bool(self.deadline_s and dt > self.deadline_s)
        if slow:
            self.slow_steps += 1
        return dt, slow

    def summary(self) -> dict:
        return {"slow_steps": self.slow_steps, "total_steps": self.total_steps,
                "worst_s": self.worst_s}


class MetricLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")
        else:
            self._f = None

    def log(self, step: int, **metrics):
        rec = {"step": step,
               **{k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}}
        line = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in rec.items())
        print(line, flush=True)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
