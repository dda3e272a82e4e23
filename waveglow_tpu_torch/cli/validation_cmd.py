"""``validate`` subcommand (counterpart of
``waveglow_tpu/cli/validation_cmd.py``).

Loops over the selected checkpoints, validates each over the dataset on
``--device`` (the card by default), saves the per-entry artefacts (wavs,
mel ``.npy`` files, PNGs, the comparison stack) and writes the metric rows
as a tab-separated ``total.csv`` per iteration and over all of them.
"""

from __future__ import annotations

import logging
from argparse import ArgumentParser, Namespace

import numpy as np

from waveglow_tpu_torch.cli.argparse_helpers import (
    add_compute_arguments, add_denoiser_and_sigma_arguments,
    add_hparams_argument, get_optional, parse_existing_directory,
    parse_non_empty, parse_non_negative_integer, parse_path,
    parse_positive_integer)
from waveglow_tpu_torch.hparams import parse_custom_hparams

logger = logging.getLogger(__name__)


def init_validation_parser(parser: ArgumentParser):
  parser.description = ("Validate checkpoint(s) using the validation set or "
                        "any other dataset.")
  parser.add_argument("checkpoints_dir", metavar="CHECKPOINTS-FOLDER",
                      type=parse_existing_directory,
                      help="folder containing the checkpoints to validate")
  parser.add_argument("output_dir", metavar="OUTPUT-FOLDER", type=parse_path,
                      help="folder for the resulting files")
  parser.add_argument("dataset_dir", metavar="DATA-FOLDER",
                      type=parse_existing_directory,
                      help="validation-set folder (or any wav dataset)")
  add_denoiser_and_sigma_arguments(parser)
  add_hparams_argument(parser)
  add_compute_arguments(parser)
  parser.add_argument("--full-run", action="store_true",
                      help="validate all files in DATA-FOLDER")
  parser.add_argument("--files", type=parse_non_empty, nargs="*",
                      metavar="UTTERANCE", default=[],
                      help="utterance basenames to validate; a random one "
                           "is chosen if unset")
  parser.add_argument("--custom-checkpoints", type=parse_positive_integer,
                      nargs="*", default=[],
                      help="checkpoint iterations to validate; last if unset")
  parser.add_argument("--select", type=get_optional(parse_positive_integer),
                      default=None,
                      help="validate every SELECT-th discovered checkpoint "
                           "(iterations divisible by SELECT)")
  parser.add_argument("--min-iteration",
                      type=get_optional(parse_non_negative_integer),
                      default=None,
                      help="ignore discovered checkpoints below this "
                           "iteration")
  parser.add_argument("--max-iteration",
                      type=get_optional(parse_non_negative_integer),
                      default=None,
                      help="ignore discovered checkpoints above this "
                           "iteration")
  parser.add_argument("--custom-seed",
                      type=get_optional(parse_non_negative_integer),
                      default=None)
  return validate_ns


def selected_iterations(ns: Namespace, available) -> list:
  """The iterations to validate: ``--custom-checkpoints``, else the
  ``--select``/``--min-iteration``/``--max-iteration`` filter of the
  available ones when any is given, else the newest."""
  from waveglow_tpu_torch.checkpointing.store import filter_checkpoints
  if ns.custom_checkpoints:
    return list(ns.custom_checkpoints)
  if (ns.select or ns.min_iteration is not None
      or ns.max_iteration is not None):
    return filter_checkpoints(available, select=ns.select,
                              min_it=ns.min_iteration,
                              max_it=ns.max_iteration)
  return [max(available)] if available else []


def validate_ns(ns: Namespace) -> bool:
  from waveglow_tpu_torch.checkpointing import (get_all_iterations_any,
                                                get_checkpoint_any,
                                                load_checkpoint_any)
  from waveglow_tpu_torch.device import resolve_device
  from waveglow_tpu_torch.dsp.audio_io import float_to_wav
  from waveglow_tpu_torch.eval.plots import save_image, stack_images_vertically
  from waveglow_tpu_torch.eval.validation import get_rows, validate, write_tsv
  from waveglow_tpu_torch.training.data import load_dataset

  device = resolve_device(ns.device)  # no card, no work
  data = load_dataset(ns.dataset_dir)
  if len(data) == 0:
    logger.error("No wav files found in %s", ns.dataset_dir)
    return False

  available = ([] if ns.custom_checkpoints
               else get_all_iterations_any(ns.checkpoints_dir))
  if not ns.custom_checkpoints and not available:
    logger.error("No checkpoints found in %s", ns.checkpoints_dir)
    return False
  iterations = selected_iterations(ns, available)
  if not iterations:
    logger.error("No checkpoints match the select/min/max filter.")
    return False

  custom_hparams = parse_custom_hparams(ns.custom_hparams)
  if ns.compute_dtype:
    custom_hparams["compute_dtype"] = ns.compute_dtype

  all_rows = []
  for iteration in iterations:
    logger.info("Validating checkpoint iteration %d...", iteration)
    checkpoint = load_checkpoint_any(
        get_checkpoint_any(ns.checkpoints_dir, iteration))
    out_dir = ns.output_dir / str(iteration)

    def save_callback(entry, output, _out_dir=out_dir):
      dest = _out_dir / entry.stem
      dest.mkdir(parents=True, exist_ok=True)
      float_to_wav(output.wav_orig, dest / "original.wav",
                   sample_rate=output.orig_sr)
      float_to_wav(output.wav_inferred_denoised,
                   dest / "inferred_denoised.wav",
                   sample_rate=output.inferred_sr)
      np.save(dest / "original.mel.npy", output.mel_orig)
      np.save(dest / "inferred_denoised.mel.npy",
              output.mel_inferred_denoised)
      save_image(dest / "original.png", output.mel_orig_img)
      save_image(dest / "inferred_denoised.png",
                 output.mel_inferred_denoised_img)
      save_image(dest / "diff.png", output.mel_denoised_diff_img)
      save_image(dest / "comparison.png", stack_images_vertically([
          output.mel_orig_img, output.mel_inferred_denoised_img,
          output.mel_denoised_diff_img]))

    rows = get_rows(validate(
        checkpoint=checkpoint, data=data,
        custom_hparams=custom_hparams or None,
        denoiser_strength=ns.denoiser_strength, sigma=ns.sigma,
        entry_names=set(ns.files), full_run=ns.full_run,
        save_callback=save_callback, seed=ns.custom_seed, device=device))
    if rows:
      out_dir.mkdir(parents=True, exist_ok=True)
      write_tsv(out_dir / "total.csv", rows)
      all_rows.extend(rows)

  if all_rows:
    ns.output_dir.mkdir(parents=True, exist_ok=True)
    write_tsv(ns.output_dir / "total.csv", all_rows)
    logger.info("Wrote %s", ns.output_dir / "total.csv")
  return True
