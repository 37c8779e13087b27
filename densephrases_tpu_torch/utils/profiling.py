"""Stage timers and the profiler trace of the serve pipeline.

``StageTimer`` is the counterpart of the one in
``densephrases_tpu/utils/profiling.py``. On CUDA a stage's wall clock
covers the host's enqueue time unless the stage ends in a synchronising
call (``.cpu()``, ``.item()``), since kernels launch asynchronously.
``trace`` is the counterpart of ``xla_trace``: a ``torch.profiler`` trace
of the host and, where there is a card, the device.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design
    (one per pipeline)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals, key=lambda n: -self.totals[n])
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def log(self, prefix: str = ""):
        for name, row in self.summary().items():
            logger.info("%s%s: %.1fms x%d", prefix, name, row["mean_ms"],
                        row["count"])


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block, written to ``log_dir`` as a
    Chrome trace (TensorBoard's layout); does nothing when log_dir is
    None."""
    if log_dir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
