"""The training loop: resume, warm start, save, validate (counterpart of
``waveglow_tpu/training/loop.py``).

Hparams come from the checkpoint when continuing (overridable by custom
hparams); training resumes mid-epoch at the exact next batch, because the
data pipeline regenerates the remaining crops from (seed, epoch, index);
checkpoints are the npz files or the orbax directories
(``checkpoint_backend``) the JAX package reads and writes, with the Adam
state in optax's positional layout; validation runs at every save.
Telemetry goes to the logger and a JSONL metrics file in ``logdir``.

Every WN layer's forward runs through the fused CUDA kernel on the card,
whatever ``use_pallas`` says (it chooses the JAX package's route only).

With ``mesh_data * mesh_model > 1``, or several processes
(``parallel.mesh.initialize_multihost``), training runs on a (data, model)
mesh: each process drives its own mesh, the model axis through the
trainable shard, and ``batch_size`` is the global batch, each process
loading its share of the rows from its shard of the entries. npz saves
gather the state and only process 0 writes; orbax saves write the model
ranks' slices as chunks, every process its share, and an orbax checkpoint
resumes on a mesh through ``restore_sharded``, each rank reading its
slices. A checkpoint of either format resumes on any mesh.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import asdict
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing import orbax_store
from waveglow_tpu_torch.checkpointing.from_jax import (
    params_to_numpy, trainable_params_from_numpy)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.device import resolve_device
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, init_params
from waveglow_tpu_torch.parallel.mesh import (DeviceLike, all_reduce_ordered,
                                              make_mesh, process_count,
                                              process_index)
from waveglow_tpu_torch.parallel.sharding import (distinct_leaves,
                                                  gather_trainable_params,
                                                  place_trainable_params,
                                                  shard_trainable_params)
from waveglow_tpu_torch.training.data import (BatchLoader, Entries,
                                              SegmentDataset)
from waveglow_tpu_torch.training.schedule import (SaveIterationSettings,
                                                  check_save_it,
                                                  get_continue_batch_iteration,
                                                  get_continue_epoch)
from waveglow_tpu_torch.training.step import (adam_state_from_optax,
                                              adam_state_from_optax_group,
                                              adam_state_from_optax_ranks,
                                              adam_state_to_optax,
                                              adam_state_to_optax_group,
                                              adam_state_to_optax_ranks,
                                              make_eval_loss,
                                              make_mesh_train_step,
                                              make_optimizer, make_train_step)
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
  """Raise on checkpoint settings that do not go together (the JAX
  package's errors)."""
  if hp.checkpoint_backend not in ("npz", "orbax"):
    raise ValueError(
        f"unknown checkpoint_backend {hp.checkpoint_backend!r} "
        "(expected 'npz' or 'orbax')")
  if hp.checkpoint_async and hp.checkpoint_backend != "orbax":
    raise ValueError(
        "checkpoint_async=true requires checkpoint_backend=orbax (the npz "
        "backend writes synchronously)")


def validate_model(eval_loss: Callable, val_loader: BatchLoader) -> float:
  """Average NLL over the validation set; ``eval_loss(batch)`` takes a host
  batch. In a multi-process run every process calls it on as many batches
  (a collective), and gets the same value."""
  losses = [float(eval_loss(torch.from_numpy(batch)))
            for batch in val_loader.epoch(0)]
  return float(np.mean(losses)) if losses else float("nan")


class _Trainer:
  """The params, optimizer and step of a run, unsharded or on a mesh, with
  the gather of its state into the checkpoint layout. ``orbax_path`` (an
  orbax checkpoint to restore on the mesh) stands in for ``params_np`` and
  ``opt_leaves``."""

  def __init__(self, config: WaveGlowConfig, hp: HParams, params_np: Dict,
               opt_leaves, device: torch.device, mesh_devices,
               orbax_path: Optional[Path] = None):
    self.mesh = None
    if uses_mesh(hp):
      n = hp.mesh_data * hp.mesh_model
      if mesh_devices is None and n == 1:
        mesh_devices = [device]
      self.mesh = make_mesh(hp.mesh_data, hp.mesh_model,
                            devices=mesh_devices)
      if orbax_path is not None:
        rank_params, rank_opt, _ = orbax_store.restore_sharded(orbax_path,
                                                               self.mesh)
        self.replicas = place_trainable_params(rank_params, self.mesh)
      else:
        self.replicas = shard_trainable_params(params_np, self.mesh)
      self.optimizers = [make_optimizer(distinct_leaves(g), hp.learning_rate)
                         for g in self.replicas]
      for opt, group in zip(self.optimizers, self.replicas):
        if orbax_path is not None:
          if rank_opt is not None:
            adam_state_from_optax_ranks(opt, group, rank_opt)
        elif opt_leaves is not None:
          adam_state_from_optax_group(opt, group, opt_leaves)
      self.step = make_mesh_train_step(config, hp, self.replicas,
                                       self.optimizers)
      self.eval_fns = [
          (make_eval_loss(config, hp, MelSTFT(hp, self.mesh.devices[i, 0])),
           group if len(group) > 1 else group[0], self.mesh.devices[i, 0])
          for i, group in enumerate(self.replicas)]
      return
    self.params = trainable_params_from_numpy(params_np, device)
    self.optimizer = make_optimizer(self.params, hp.learning_rate)
    if opt_leaves is not None:
      adam_state_from_optax(self.optimizer, self.params, opt_leaves)
    mel_op = MelSTFT(hp, device)
    train_step = make_train_step(config, hp, mel_op, self.optimizer)
    self.step = lambda audio: train_step(self.params, audio.to(device))
    self.eval_fns = [(make_eval_loss(config, hp, mel_op), self.params,
                      device)]

  def eval_loss(self, audio: torch.Tensor) -> torch.Tensor:
    """The loss of a host batch: its rows split over the data replicas,
    the replicas' losses averaged over every process (rank order)."""
    rows = audio.shape[0] // len(self.eval_fns)
    losses = [fn(params, audio[i * rows:(i + 1) * rows].to(dev))
              for i, (fn, params, dev) in enumerate(self.eval_fns)]
    loss = losses[0]
    for other in losses[1:]:
      loss = loss + other.to(loss.device)
    loss = all_reduce_ordered(loss.reshape(1).float())[0]
    return loss / (len(losses) * process_count())

  def state(self):
    """(params numpy tree, optax-layout Adam leaves): data replica 0's
    model group, gathered."""
    if self.mesh is None:
      return (params_to_numpy(self.params),
              adam_state_to_optax(self.optimizer, self.params))
    return (gather_trainable_params(self.replicas[0]),
            adam_state_to_optax_group(self.optimizers[0], self.replicas[0]))

  def sharded_state(self):
    """The state for an orbax save, left on the device (the store copies
    it to the host once): the params tree and its optax-layout Adam leaves;
    on a mesh, data replica 0's rank trees and each rank's Adam leaves,
    ungathered."""
    if self.mesh is None:
      return (self.params,
              adam_state_to_optax_ranks(self.optimizer, [self.params])[0])
    return (self.replicas[0],
            adam_state_to_optax_ranks(self.optimizers[0], self.replicas[0]))


def uses_mesh(hp: HParams) -> bool:
  """Whether a run trains on a (data, model) mesh."""
  return hp.mesh_data * hp.mesh_model > 1 or process_count() > 1


def train(custom_hparams: Optional[Dict[str, str]], logdir: Optional[Path],
          trainset: Entries, valset: Entries, save_checkpoint_dir: Path,
          checkpoint: Optional[Union[
              CheckpointWaveglow, orbax_store.OrbaxCheckpointRef]] = None,
          warm_model: Optional[CheckpointWaveglow] = None,
          max_iterations: Optional[int] = None,
          tensorboard_dir: Optional[Path] = None,
          device: Union[str, torch.device] = "cuda",
          mesh_devices: Optional[Sequence[DeviceLike]] = None) -> Dict:
  """Train (or continue training) a WaveGlow model on ``device``: the card
  by default (raises without one), the CPU only when asked.

  With ``hparams.mesh_data * mesh_model > 1`` the run uses a (data, model)
  mesh over ``cuda:0 .. cuda:n-1``, or over ``mesh_devices``, which may
  list one device more than once (``["cpu"] * n`` runs the mesh's shards
  one after another on the CPU). In a multi-process run
  (``parallel.mesh.initialize_multihost`` first) each process drives such a
  mesh (one device, ``device``, when the mesh is 1 x 1) and the global data
  axis is the processes times its rows.

  ``checkpoint`` may be an orbax checkpoint by reference
  (``checkpointing.load_checkpoint_lazy`` of a directory): on a mesh each
  model rank reads its slices of it (``orbax_store.restore_sharded``),
  without one it is read whole (``restore_host``). With
  ``checkpoint_backend="orbax"`` saves are orbax directories, written in
  the background when ``checkpoint_async`` is set; the end of ``train()``
  waits for the last one and raises a failed write.

  ``max_iterations`` bounds this invocation; ``None`` trains to
  ``hparams.epochs``. ``tensorboard_dir`` also writes TensorBoard scalars.
  Returns the final state on the host: ``{"params": numpy tree,
  "opt_state": optax-layout leaves, "step": iteration}`` (on a mesh, the
  gathered tree).
  """
  complete_start = time.time()
  device = resolve_device(device)
  hparams = checkpoint.get_hparams() if checkpoint is not None else HParams()
  hparams = overwrite_custom_hparams(hparams, custom_hparams)
  _check_supported(hparams)
  config = WaveGlowConfig.from_hparams(hparams)
  rank, n_procs = process_index(), process_count()
  # one metrics writer a run, not a process
  metrics = MetricsLogger(logdir if rank == 0 else None)
  tboard = make_tensorboard_logger(tensorboard_dir if rank == 0 else None)

  # --- model + optimizer state -------------------------------------------
  orbax_path = None
  if isinstance(checkpoint, orbax_store.OrbaxCheckpointRef):
    if uses_mesh(hparams):
      orbax_path = checkpoint.path
      logger.info("Resuming iteration %d by a sharded orbax restore (%s)",
                  checkpoint.iteration, orbax_path)
    else:
      checkpoint = orbax_store.restore_host(checkpoint.path)
  if orbax_path is not None:
    params_np, iteration = None, checkpoint.iteration
  elif checkpoint is not None:
    params_np, iteration = checkpoint.state_dict, checkpoint.iteration
  elif warm_model is not None:
    logger.info("Warm-starting from pretrained model state...")
    params_np = warm_start_params(init_params(config, seed=hparams.seed),
                                  warm_model.state_dict)
    iteration = 0
  else:
    params_np, iteration = init_params(config, seed=hparams.seed), 0

  # --- data ---------------------------------------------------------------
  # batch_size is the global batch; each process loads its share of the
  # rows from its shard of the entries, and the counts come from global
  # sizes, so the step and save schedule do not depend on the process count
  data_rows = n_procs * hparams.mesh_data
  if hparams.batch_size % data_rows:
    raise ValueError(
        f"batch_size {hparams.batch_size} must be divisible by the data "
        f"axis ({n_procs} processes x mesh_data {hparams.mesh_data})")
  local_batch = hparams.batch_size // n_procs
  train_ds = SegmentDataset(trainset, hparams, rank, n_procs)
  val_ds = SegmentDataset(valset, hparams, rank, n_procs)
  batch_iterations = (len(trainset) // n_procs) // local_batch
  if batch_iterations == 0:
    raise RuntimeError("Not enough training data.")
  train_loader = BatchLoader(train_ds, local_batch, drop_last=True,
                             num_batches=batch_iterations)
  trainer = _Trainer(
      config, hparams, params_np,
      checkpoint.optimizer if params_np is not None and checkpoint is not None
      else None, device, mesh_devices, orbax_path)
  if trainer.mesh is not None:
    # the replicas' batches are full and as many on every process
    val_batches = (len(valset) // n_procs) // local_batch
    if val_batches == 0:
      logger.warning(
          "Validation set (%d entries) is smaller than one global batch "
          "(%d): validation loss will be NaN in mesh mode.",
          len(valset), hparams.batch_size)
    val_loader = BatchLoader(val_ds, local_batch, drop_last=True,
                             num_batches=val_batches)
  else:
    val_loader = BatchLoader(val_ds, local_batch, drop_last=False)
  save_settings = SaveIterationSettings(
      epochs=hparams.epochs, batch_iterations=batch_iterations,
      iters_per_checkpoint=hparams.iters_per_checkpoint,
      epochs_per_checkpoint=hparams.epochs_per_checkpoint)

  # --- epoch loop ---------------------------------------------------------
  train_start = time.perf_counter()
  last_t = train_start
  duration_sum, duration_n = 0.0, 0
  stop = False
  async_saver = None  # made at the first async orbax save
  continue_epoch = get_continue_epoch(iteration, batch_iterations)
  try:
    for epoch in range(continue_epoch, hparams.epochs):
      if stop:
        break
      start_batch = (get_continue_batch_iteration(iteration, batch_iterations)
                     if epoch == continue_epoch else 0)
      for batch in train_loader.epoch(epoch, start_batch):
        loss = float(trainer.step(torch.from_numpy(batch)))
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
          if hparams.checkpoint_backend == "orbax":
            # every process writes its share (a collective)
            params_out, opt_out = trainer.sharded_state()
            if hparams.checkpoint_async:
              if async_saver is None:
                async_saver = orbax_store.AsyncSaver()
              path = async_saver.save(save_checkpoint_dir, iteration,
                                      params_out, opt_out, hparams)
            else:
              path = orbax_store.save_sharded(save_checkpoint_dir, iteration,
                                              params_out, opt_out, hparams)
            if rank == 0:
              logger.info("Saved checkpoint %s", path)
          elif rank == 0:
            params_np, opt_leaves = trainer.state()
            path = Path(save_checkpoint_dir) / f"{iteration}.npz"
            CheckpointWaveglow(
                state_dict=params_np, optimizer=opt_leaves,
                learning_rate=hparams.learning_rate, iteration=iteration,
                hparams=asdict(hparams)).save(path)
            logger.info("Saved checkpoint %s", path)
          val_loss = validate_model(trainer.eval_loss, val_loader)
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
    try:
      if async_saver is not None:
        # the last checkpoint is whole on disk when train() returns, and a
        # failed write raises here
        async_saver.close()
    finally:
      if tboard is not None:
        tboard.close()

  logger.info("Finished training. Total duration: %.2fm",
              (time.time() - complete_start) / 60)
  params_np, opt_leaves = trainer.state()
  return {"params": params_np, "opt_state": opt_leaves, "step": iteration}
