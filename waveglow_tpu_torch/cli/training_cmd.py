"""``train`` / ``continue-train`` subcommands (counterpart of
``waveglow_tpu/cli/training_cmd.py``).

Training runs on ``--device`` (the card by default). ``--num-processes``,
``--process-id`` and ``--coordinator-address`` (``host:port`` of process 0)
join a multi-process run over ``torch.distributed``
(``parallel.mesh.initialize_multihost``: NCCL on the card, gloo with
``--device cpu``), as the JAX commands' flags of the same names do.
"""

from __future__ import annotations

import logging
import tempfile
from argparse import ArgumentParser, Namespace
from pathlib import Path

from waveglow_tpu_torch.cli.argparse_helpers import (add_compute_arguments,
                                                     add_hparams_argument,
                                                     get_optional,
                                                     parse_existing_directory,
                                                     parse_existing_path,
                                                     parse_path)
from waveglow_tpu_torch.hparams import parse_custom_hparams

logger = logging.getLogger(__name__)

DEFAULT_LOG_DIR = Path(tempfile.gettempdir()) / "waveglow-tpu-torch_logs"


def init_training_parser(parser: ArgumentParser):
  parser.description = "Start training of a new model."
  parser.add_argument("train_folder", metavar="TRAIN-FOLDER",
                      type=parse_existing_directory,
                      help="path to folder containing training data "
                           "(i.e., .wav files)")
  parser.add_argument("val_folder", metavar="VAL-FOLDER",
                      type=parse_existing_directory,
                      help="path to folder containing validation data")
  parser.add_argument("checkpoints_dir", metavar="CHECKPOINTS-FOLDER",
                      type=parse_path, help="path to folder to write "
                      "checkpoints")
  add_hparams_argument(parser)
  add_compute_arguments(parser)
  parser.add_argument("--pre-trained-model", metavar="PRE-TRAINED-MODEL",
                      type=get_optional(parse_existing_path), default=None,
                      help="path to checkpoint used for warm start "
                           "(npz, orbax directory or torch .pt)")
  parser.add_argument("--warm-start", action="store_true",
                      help="warm start using PRE-TRAINED-MODEL")
  parser.add_argument("--auto-resume", action="store_true",
                      help="if CHECKPOINTS-FOLDER already holds checkpoints, "
                           "continue from the latest instead of failing, so "
                           "the same command can be run again after an "
                           "interruption")
  _add_log_args(parser)
  _add_multihost_args(parser)
  return train_ns


def init_continue_training_parser(parser: ArgumentParser):
  parser.description = "Continue training from the latest checkpoint."
  parser.add_argument("train_folder", metavar="TRAIN-FOLDER",
                      type=parse_existing_directory)
  parser.add_argument("val_folder", metavar="VAL-FOLDER",
                      type=parse_existing_directory)
  parser.add_argument("checkpoints_dir", metavar="CHECKPOINTS-FOLDER",
                      type=parse_existing_directory)
  add_hparams_argument(parser)
  add_compute_arguments(parser)
  _add_log_args(parser)
  _add_multihost_args(parser)
  return continue_train_ns


def _add_log_args(parser: ArgumentParser) -> None:
  parser.add_argument("--tl-dir", type=parse_path, metavar="LOG-DIR",
                      default=DEFAULT_LOG_DIR,
                      help="folder for training metrics (JSONL)")
  parser.add_argument("--tensorboard-dir", type=get_optional(parse_path),
                      metavar="EVENT-DIR", default=None,
                      help="write TensorBoard scalar events (train loss, "
                           "step duration, validation loss) into this "
                           "folder; needs the tensorboard package (the "
                           "command fails without it)")
  parser.add_argument("--profile-dir", type=get_optional(parse_path),
                      metavar="TRACE-DIR", default=None,
                      help="write a torch.profiler Chrome trace of the run "
                           "(trace.json: host ops, and the card's kernels) "
                           "into this folder; use with a bounded run, "
                           "traces grow with steps")


def _add_multihost_args(parser: ArgumentParser) -> None:
  parser.add_argument("--coordinator-address", default=None,
                      metavar="HOST:PORT",
                      help="process 0's address of a multi-process run "
                           "(torch.distributed, tcp://)")
  parser.add_argument("--num-processes", type=int, default=None)
  parser.add_argument("--process-id", type=int, default=None)


def _maybe_init_multihost(ns: Namespace, device) -> None:
  from waveglow_tpu_torch.parallel.mesh import initialize_multihost
  initialize_multihost(coordinator_address=ns.coordinator_address,
                       num_processes=ns.num_processes,
                       process_id=ns.process_id,
                       backend="gloo" if device.type == "cpu" else None)


def _custom_hparams(ns: Namespace):
  custom = parse_custom_hparams(ns.custom_hparams)
  if ns.compute_dtype:
    custom["compute_dtype"] = ns.compute_dtype
  return custom or None


def _train(ns: Namespace, checkpoint, warm_model, device) -> None:
  from waveglow_tpu_torch.profiling import trace
  from waveglow_tpu_torch.training.data import load_dataset
  from waveglow_tpu_torch.training.loop import train

  _maybe_init_multihost(ns, device)
  trainset = load_dataset(ns.train_folder)
  valset = load_dataset(ns.val_folder)
  logger.info("Trainset: %d entries | Valset: %d entries",
              len(trainset), len(valset))
  with trace(ns.profile_dir, device):
    train(custom_hparams=_custom_hparams(ns), logdir=ns.tl_dir,
          trainset=trainset, valset=valset,
          save_checkpoint_dir=ns.checkpoints_dir, checkpoint=checkpoint,
          warm_model=warm_model, tensorboard_dir=ns.tensorboard_dir,
          device=device)


def train_ns(ns: Namespace) -> bool:
  from waveglow_tpu_torch.checkpointing import (get_all_iterations_any,
                                                get_last_checkpoint_any,
                                                load_checkpoint_any,
                                                load_checkpoint_lazy)
  from waveglow_tpu_torch.device import resolve_device

  device = resolve_device(ns.device)  # no card, no work
  checkpoint = None
  existing = (get_all_iterations_any(ns.checkpoints_dir)
              if Path(ns.checkpoints_dir).exists() else [])
  if ns.auto_resume and existing:
    last_path, last_it = get_last_checkpoint_any(ns.checkpoints_dir)
    logger.info("Auto-resume: continuing from iteration %d (%s)",
                last_it, last_path)
    # an orbax checkpoint opens by reference: on a mesh each model rank
    # reads only its slices
    checkpoint = load_checkpoint_lazy(last_path)
  elif existing:
    # a fresh run would start at iteration 0 and overwrite the earlier
    # run's checkpoints at the same iteration numbers
    logger.error(
        "Checkpoints already exist in %s (iterations %s..%s). Use "
        "continue-train to resume, --auto-resume to make this command "
        "safe to run again, or point CHECKPOINTS-FOLDER somewhere fresh.",
        ns.checkpoints_dir, min(existing), max(existing))
    return False

  if (ns.pre_trained_model is not None) != ns.warm_start:
    # one without the other would train from a random initialisation
    logger.error("--pre-trained-model and --warm-start must be used "
                 "together (got %s without %s).",
                 "--pre-trained-model" if ns.pre_trained_model is not None
                 else "--warm-start",
                 "--warm-start" if ns.pre_trained_model is not None
                 else "--pre-trained-model")
    return False
  warm_model = None
  if ns.pre_trained_model is not None and checkpoint is None:
    warm_model = load_checkpoint_any(ns.pre_trained_model)

  _train(ns, checkpoint, warm_model, device)
  return True


def continue_train_ns(ns: Namespace) -> bool:
  from waveglow_tpu_torch.checkpointing import (get_last_checkpoint_any,
                                                load_checkpoint_lazy)
  from waveglow_tpu_torch.device import resolve_device

  device = resolve_device(ns.device)  # no card, no work
  last_path, last_it = get_last_checkpoint_any(ns.checkpoints_dir)
  logger.info("Continuing from iteration %d (%s)", last_it, last_path)
  _train(ns, load_checkpoint_lazy(last_path), None, device)
  return True
