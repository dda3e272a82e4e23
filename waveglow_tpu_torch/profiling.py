"""Profiling and throughput observability (the port's counterpart of
``waveglow_tpu/profiling.py``).

  * :func:`trace` wraps ``torch.profiler`` capture around a block and
    writes a Chrome trace (``chrome://tracing``, Perfetto) into a folder:
    host ops, and on the card every kernel and copy; the train commands
    expose it as ``--profile-dir``;
  * :class:`StepTimer` aggregates step durations into throughput figures
    (units a second) with warmup exclusion.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: Optional[Path], device: Union[str, torch.device] = "cuda"):
  """``torch.profiler`` over the block, its Chrome trace written to
  ``logdir/trace.json`` at the end (also when the block raises); CPU
  activity, and CUDA activity when ``device`` is a card. A no-op when
  ``logdir`` is None."""
  if logdir is None:
    yield
    return
  from torch.profiler import ProfilerActivity, profile
  logdir = Path(logdir)
  logdir.mkdir(parents=True, exist_ok=True)
  on_card = torch.device(device).type == "cuda"
  activities = [ProfilerActivity.CPU]
  if on_card:
    activities.append(ProfilerActivity.CUDA)
  prof = profile(activities=activities)
  prof.start()
  try:
    yield
  finally:
    if on_card:
      torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(str(logdir / TRACE_FILE))


class StepTimer:
  """Accumulates step durations and reports throughput statistics."""

  def __init__(self, warmup_steps: int = 1):
    self.warmup_steps = warmup_steps
    self._durations = []
    self._count = 0
    self._last: Optional[float] = None

  def start(self) -> None:
    self._last = time.perf_counter()

  def stop(self) -> float:
    if self._last is None:
      raise RuntimeError("StepTimer.stop() before start()")
    duration = time.perf_counter() - self._last
    self._count += 1
    if self._count > self.warmup_steps:
      self._durations.append(duration)
    self._last = None
    return duration

  @contextlib.contextmanager
  def step(self):
    self.start()
    yield
    self.stop()

  @property
  def mean_duration_s(self) -> float:
    return float(np.mean(self._durations)) if self._durations else float("nan")

  def throughput(self, units_per_step: float) -> float:
    """units/sec given a fixed per-step workload (samples, audio-seconds...)."""
    mean = self.mean_duration_s
    return units_per_step / mean if mean and np.isfinite(mean) else float("nan")

  def report(self, units_per_step: float, unit: str) -> Dict:
    return {
        "steps_measured": len(self._durations),
        "mean_step_seconds": round(self.mean_duration_s, 6),
        "throughput": round(self.throughput(units_per_step), 3),
        "unit": unit,
    }
