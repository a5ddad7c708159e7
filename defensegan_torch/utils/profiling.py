"""Per-phase wall-clock totals (port of the JAX package's
utils/profiling.py::PhaseTimer).

The device runs asynchronously: a phase that ends on CUDA work is closed
after torch.cuda.synchronize(), so its time is the device's, not the
enqueue's.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulate wall-clock per phase.

    device: the phase's CUDA device (or None): on a CUDA device every
    phase ends with torch.cuda.synchronize(device) before the clock is
    read.
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        """Fold an externally measured duration into the phase totals."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / max(self.counts[k], 1), 4)}
                for k, v in self.totals.items()}

    def __str__(self) -> str:
        return " | ".join(f"{k}: {v:.3f}s/{self.counts[k]}"
                          for k, v in self.totals.items())
