"""The training loop: resume, warm start, save, validate (counterpart of
``waveglow_tpu/training/loop.py``).

Hparams come from the checkpoint when continuing (overridable by custom
hparams); training resumes mid-epoch at the exact next batch, because the
data pipeline regenerates the remaining crops from (seed, epoch, index);
checkpoints are the npz files the JAX package reads and writes, with the
Adam state in optax's positional layout; validation runs at every save.
Telemetry goes to the logger and a JSONL metrics file in ``logdir``.

Every WN layer's forward runs through the fused CUDA kernel on the card,
whatever ``use_pallas`` says (it chooses the JAX package's route only).
Multi-card meshes and the orbax backend are not ported yet: their settings
raise instead of being ignored.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import asdict
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.from_jax import (
    params_to_numpy, trainable_params_from_numpy)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.device import resolve_device
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, init_params
from waveglow_tpu_torch.training.data import (BatchLoader, Entries,
                                              SegmentDataset)
from waveglow_tpu_torch.training.schedule import (SaveIterationSettings,
                                                  check_save_it,
                                                  get_continue_batch_iteration,
                                                  get_continue_epoch)
from waveglow_tpu_torch.training.step import (adam_state_from_optax,
                                              adam_state_to_optax,
                                              make_eval_loss, make_optimizer,
                                              make_train_step)
from waveglow_tpu_torch.training.tboard import make_tensorboard_logger

logger = logging.getLogger(__name__)


class MetricsLogger:
  """Append-only JSONL metrics log (one record per event)."""

  def __init__(self, logdir: Optional[Path]):
    self.path = None
    if logdir is not None:
      logdir = Path(logdir)
      logdir.mkdir(parents=True, exist_ok=True)
      self.path = logdir / "metrics.jsonl"

  def log(self, **record) -> None:
    if self.path is None:
      return
    record["time"] = time.time()
    with open(self.path, "a") as f:
      f.write(json.dumps(record) + "\n")


def warm_start_params(target: Dict, source: Dict) -> Dict:
  """Copy source leaves into target wherever path and shape match; other
  leaves keep the target's fresh initialisation and are logged."""
  skipped = []

  def merge(t, s, path):
    if isinstance(t, dict):
      return {k: merge(t[k], s.get(k) if isinstance(s, dict) else None,
                       f"{path}/{k}") for k in t}
    if isinstance(t, list):
      s_list = s if isinstance(s, list) else []
      return [merge(t[i], s_list[i] if i < len(s_list) else None,
                    f"{path}/{i}") for i in range(len(t))]
    if s is None or np.shape(s) != np.shape(t):
      skipped.append(path)
      return t
    return s

  merged = merge(target, source, "")
  if skipped:
    logger.warning("Warm start skipped %d mismatched leaves (e.g. %s)",
                   len(skipped), skipped[:5])
  return merged


def _check_supported(hp: HParams) -> None:
  """Raise on settings this slice of the port does not implement."""
  if hp.mesh_data * hp.mesh_model > 1:
    raise ValueError(
        f"mesh_data={hp.mesh_data} x mesh_model={hp.mesh_model}: multi-card "
        "training is not ported yet (ROADMAP.md queue A.6, Parallelism)")
  if hp.checkpoint_backend == "orbax":
    raise ValueError(
        "checkpoint_backend='orbax' is not ported yet (ROADMAP.md queue A.4, "
        "Checkpoint interop); use 'npz'")
  if hp.checkpoint_backend != "npz":
    raise ValueError(f"unknown checkpoint_backend {hp.checkpoint_backend!r} "
                     "(expected 'npz')")
  if hp.checkpoint_async:
    raise ValueError(
        "checkpoint_async=true needs the orbax backend, which is not ported "
        "yet (ROADMAP.md queue A.4, Checkpoint interop)")


def validate_model(eval_loss: Callable, params: Dict, val_loader: BatchLoader,
                   device: torch.device) -> float:
  """Average NLL over the validation set."""
  losses = [float(eval_loss(params, torch.from_numpy(batch).to(device)))
            for batch in val_loader.epoch(0)]
  return float(np.mean(losses)) if losses else float("nan")


def train(custom_hparams: Optional[Dict[str, str]], logdir: Optional[Path],
          trainset: Entries, valset: Entries, save_checkpoint_dir: Path,
          checkpoint: Optional[CheckpointWaveglow] = None,
          warm_model: Optional[CheckpointWaveglow] = None,
          max_iterations: Optional[int] = None,
          tensorboard_dir: Optional[Path] = None,
          device: Union[str, torch.device] = "cuda") -> Dict:
  """Train (or continue training) a WaveGlow model on ``device``: the card
  by default (raises without one), the CPU only when asked.

  ``max_iterations`` bounds this invocation; ``None`` trains to
  ``hparams.epochs``. ``tensorboard_dir`` also writes TensorBoard scalars.
  Returns the final state on the host: ``{"params": numpy tree,
  "opt_state": optax-layout leaves, "step": iteration}``.
  """
  complete_start = time.time()
  device = resolve_device(device)
  hparams = checkpoint.get_hparams() if checkpoint is not None else HParams()
  hparams = overwrite_custom_hparams(hparams, custom_hparams)
  _check_supported(hparams)
  config = WaveGlowConfig.from_hparams(hparams)
  metrics = MetricsLogger(logdir)
  tboard = make_tensorboard_logger(tensorboard_dir)

  # --- model + optimizer state -------------------------------------------
  if checkpoint is not None:
    params_np, iteration = checkpoint.state_dict, checkpoint.iteration
  elif warm_model is not None:
    logger.info("Warm-starting from pretrained model state...")
    params_np = warm_start_params(init_params(config, seed=hparams.seed),
                                  warm_model.state_dict)
    iteration = 0
  else:
    params_np, iteration = init_params(config, seed=hparams.seed), 0
  params = trainable_params_from_numpy(params_np, device)
  optimizer = make_optimizer(params, hparams.learning_rate)
  if checkpoint is not None and checkpoint.optimizer is not None:
    adam_state_from_optax(optimizer, params, checkpoint.optimizer)

  # --- data ---------------------------------------------------------------
  mel_op = MelSTFT(hparams, device)
  batch_iterations = len(trainset) // hparams.batch_size
  if batch_iterations == 0:
    raise RuntimeError("Not enough training data.")
  train_loader = BatchLoader(SegmentDataset(trainset, hparams),
                             hparams.batch_size, drop_last=True)
  val_loader = BatchLoader(SegmentDataset(valset, hparams),
                           hparams.batch_size, drop_last=False)
  train_step = make_train_step(config, hparams, mel_op, optimizer)
  eval_loss = make_eval_loss(config, hparams, mel_op)
  save_settings = SaveIterationSettings(
      epochs=hparams.epochs, batch_iterations=batch_iterations,
      iters_per_checkpoint=hparams.iters_per_checkpoint,
      epochs_per_checkpoint=hparams.epochs_per_checkpoint)

  # --- epoch loop ---------------------------------------------------------
  train_start = time.perf_counter()
  last_t = train_start
  duration_sum, duration_n = 0.0, 0
  stop = False
  continue_epoch = get_continue_epoch(iteration, batch_iterations)
  try:
    for epoch in range(continue_epoch, hparams.epochs):
      if stop:
        break
      start_batch = (get_continue_batch_iteration(iteration, batch_iterations)
                     if epoch == continue_epoch else 0)
      for batch in train_loader.epoch(epoch, start_batch):
        loss = float(train_step(params, torch.from_numpy(batch).to(device)))
        iteration += 1
        if not np.isfinite(loss):
          # the state is already poisoned (non-finite grads reached Adam):
          # the recovery path is continue-train from the last checkpoint
          metrics.log(event="non_finite_loss", iteration=iteration,
                      epoch=epoch)
          raise FloatingPointError(
              f"Non-finite training loss at iteration {iteration} "
              f"(epoch {epoch + 1}). Restart from the last checkpoint "
              f"with continue-train.")

        now = time.perf_counter()
        step_s = now - last_t
        last_t = now
        duration_sum += step_s
        duration_n += 1
        logger.info(
            "Epoch: %d/%d | Iteration: %d | Train loss: %.6f | "
            "%.2fs/it (avg %.2f) | total %.2fh",
            epoch + 1, hparams.epochs, iteration, loss, step_s,
            duration_sum / duration_n, (now - train_start) / 3600)
        metrics.log(event="train_step", iteration=iteration, epoch=epoch,
                    loss=loss, duration_s=step_s)
        if tboard is not None:
          tboard.log_training(iteration, loss, step_s)

        if check_save_it(epoch, iteration, save_settings):
          path = Path(save_checkpoint_dir) / f"{iteration}.npz"
          CheckpointWaveglow(
              state_dict=params_to_numpy(params),
              optimizer=adam_state_to_optax(optimizer, params),
              learning_rate=hparams.learning_rate, iteration=iteration,
              hparams=asdict(hparams)).save(path)
          logger.info("Saved checkpoint %s", path)
          val_loss = validate_model(eval_loss, params, val_loader, device)
          logger.info("Validation loss %d: %9f", iteration, val_loss)
          metrics.log(event="validation", iteration=iteration, loss=val_loss)
          if tboard is not None:
            tboard.log_validation(iteration, val_loss)
          # the save and validation are not billed to the next step
          last_t = time.perf_counter()

        if max_iterations is not None and iteration >= max_iterations:
          stop = True
          break
  finally:
    if tboard is not None:
      tboard.close()

  logger.info("Finished training. Total duration: %.2fm",
              (time.time() - complete_start) / 60)
  return {"params": params_to_numpy(params),
          "opt_state": adam_state_to_optax(optimizer, params),
          "step": iteration}
