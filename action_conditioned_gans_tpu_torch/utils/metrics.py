"""Metric writing (port of the JAX package's ``utils/metrics.py``): stdout
JSON lines, TensorBoard when ``torch.utils.tensorboard`` imports, and the
step cadence behind the loop's p50 line."""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np


class MetricWriter:
    """Scalars as one JSON line a call on stdout, plus TensorBoard summaries
    under ``logdir`` when ``torch.utils.tensorboard`` (which needs the
    ``tensorboard`` package) is importable; without it :meth:`write_images`
    does nothing. ``echo=False`` prints nothing (a data-parallel run's ranks
    other than 0, which only keep the cadence)."""

    def __init__(self, logdir: Optional[str] = None, latency_window: int = 200,
                 echo: bool = True):
        self._tb, self._echo = None, echo
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir)
        self._latencies = deque(maxlen=latency_window)
        self._last_t: Optional[float] = None

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": int(step)}
        record.update({k: float(v) for k, v in metrics.items()})
        if self._echo:
            print(json.dumps(record), flush=True)
        if self._tb is not None:
            for k, v in record.items():
                if k != "step":
                    self._tb.add_scalar(k, v, global_step=int(step))

    def write_images(self, step: int, tag: str, images) -> None:
        """Image summaries; ``images`` (N, H, W, C) in [-1, 1]."""
        if self._tb is None:
            return
        arr = (np.clip(np.asarray(images, np.float32), -1, 1) + 1.0) / 2.0
        self._tb.add_images(tag, arr, global_step=int(step), dataformats="NHWC")

    # -- step cadence ----------------------------------------------------------

    def tick(self) -> None:
        """Mark the end of one call of the train step."""
        now = time.perf_counter()
        if self._last_t is not None:
            self._latencies.append(now - self._last_t)
        self._last_t = now

    def reset_timing(self) -> None:
        self._latencies.clear()
        self._last_t = None

    def p50_latency(self) -> Optional[float]:
        if not self._latencies:
            return None
        xs = sorted(self._latencies)
        return xs[len(xs) // 2]

    def frames_per_sec(self, frames_per_step: int, num_chips: int = 1) -> Optional[float]:
        p50 = self.p50_latency()
        if not p50:
            return None
        return frames_per_step / p50 / max(num_chips, 1)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
