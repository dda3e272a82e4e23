"""Checkpoint-save scheduling and iteration/epoch arithmetic (the port's own
copy of ``waveglow_tpu/training/schedule.py``).

Save at the first iteration, the last iteration, every
``iters_per_checkpoint``, and at each epoch end when
``epochs_per_checkpoint`` divides. Iterations are 1-based; epoch =
floor((iteration-1) / batch_iterations).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class SaveIterationSettings:
  epochs: int
  batch_iterations: int
  save_first_iteration: bool = True
  save_last_iteration: bool = True
  iters_per_checkpoint: int = 2000
  epochs_per_checkpoint: int = 1


def _check_iteration(iteration: int) -> None:
  if iteration <= 0:
    raise ValueError(f"iterations are 1-based, got {iteration}")


def iteration_to_epoch(iteration: int, batch_iterations: int) -> int:
  _check_iteration(iteration)
  return (iteration - 1) // batch_iterations


def iteration_to_batch_iteration(iteration: int, batch_iterations: int) -> int:
  _check_iteration(iteration)
  return (iteration - 1) % batch_iterations


def get_continue_epoch(current_iteration: int, batch_iterations: int) -> int:
  return iteration_to_epoch(current_iteration + 1, batch_iterations)


def get_continue_batch_iteration(iteration: int, batch_iterations: int) -> int:
  return iteration_to_batch_iteration(iteration + 1, batch_iterations)


def check_save_it(epoch: int, iteration: int,
                  settings: SaveIterationSettings) -> bool:
  if iteration == 1 and settings.save_first_iteration:
    return True
  if (iteration == settings.epochs * settings.batch_iterations
      and settings.save_last_iteration):
    return True
  if (settings.iters_per_checkpoint > 0
      and iteration > 0 and iteration % settings.iters_per_checkpoint == 0):
    return True
  if iteration > 0:
    is_last_in_epoch = (
        iteration_to_batch_iteration(iteration, settings.batch_iterations) + 1
        == settings.batch_iterations)
    if (is_last_in_epoch and settings.epochs_per_checkpoint > 0
        and (epoch + 1) % settings.epochs_per_checkpoint == 0):
      return True
  return False


def get_next_save_it(iteration: int,
                     settings: SaveIterationSettings) -> Optional[int]:
  """The first iteration at or after ``iteration`` that saves, or None when
  none is left before the last one."""
  result = iteration
  while result <= settings.epochs * settings.batch_iterations:
    epoch = iteration_to_epoch(result, settings.batch_iterations)
    if check_save_it(epoch, result, settings):
      return result
    result += 1
  return None
