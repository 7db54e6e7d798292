"""Throughput counters and device traces (port of ``pda/train/profiling.py``).

  * :class:`Throughput`: patches/s and steps/s over a fit; on the card,
    ``stop()`` waits for the device before it reads the clock, so the count
    times the work and not its dispatch;
  * :func:`trace`: ``torch.profiler`` around a block, written for
    TensorBoard / Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class Throughput:
    """Step and sample counts over the timed spans of a run."""

    device: Optional[torch.device] = None
    steps: int = 0
    samples: int = 0
    elapsed: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed += time.perf_counter() - self._t0

    def update(self, batch_size: int):
        self.steps += 1
        self.samples += batch_size

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.elapsed, 1e-9)

    def summary(self) -> dict:
        return {"steps": self.steps, "samples": self.samples, "elapsed_sec": self.elapsed,
                "steps_per_sec": self.steps_per_sec, "patches_per_sec": self.samples_per_sec}


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/profile"):`` records the host and (where there is
    one) the card's activity into ``log_dir`` as a TensorBoard trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
