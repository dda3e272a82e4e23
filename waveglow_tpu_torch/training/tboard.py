"""TensorBoard scalar events for training runs (the port's own copy of
``waveglow_tpu/training/tboard.py``).

Scalars: ``train/loss`` and ``train/duration_s`` per step,
``validation/loss`` at every checkpoint save. Opt-in (``tensorboard_dir``);
the JSONL metrics file of ``training.loop`` stays the canonical record. The
writer is imported lazily, so importing this module costs nothing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union


class TensorBoardLogger:
  """Thin scalar-event writer around ``torch.utils.tensorboard``."""

  def __init__(self, logdir: Union[str, Path]):
    try:
      from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
      raise RuntimeError(
          "tensorboard_dir requires the tensorboard package "
          "(torch.utils.tensorboard could not be imported)") from e
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    self._writer = SummaryWriter(log_dir=str(logdir))

  def log_training(self, iteration: int, loss: float,
                   duration_s: Optional[float] = None) -> None:
    self._writer.add_scalar("train/loss", loss, iteration)
    if duration_s is not None:
      self._writer.add_scalar("train/duration_s", duration_s, iteration)

  def log_validation(self, iteration: int, loss: float) -> None:
    self._writer.add_scalar("validation/loss", loss, iteration)

  def flush(self) -> None:
    self._writer.flush()

  def close(self) -> None:
    self._writer.close()


def make_tensorboard_logger(
    logdir: Optional[Union[str, Path]]) -> Optional[TensorBoardLogger]:
  """``None``-propagating constructor."""
  if logdir is None:
    return None
  return TensorBoardLogger(logdir)
