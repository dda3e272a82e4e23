"""``synthesize`` / ``synthesize-wav`` subcommands (counterpart of
``waveglow_tpu/cli/synthesis_cmd.py``).

Walk FOLDER for ``.npy`` mels (or ``.wav`` files, turned into mels first:
copy synthesis), synthesize each with one seed, given or drawn, peak
normalize and write ``<stem>.wav`` (``<stem>.synthesized.wav`` beside a wav
input), mirroring the subfolder tree. Existing outputs are skipped unless
``-o``; ``*.synthesized.wav`` files are never read back as inputs.
``--batch N`` synthesizes up to N same-bucket files a dispatch through
``Synthesizer.infer_serving_many``. ``--include-stats`` scores each output
against its input mel (MCD with and without DTW, cosine, SSIM), writes
``<stem>.orig.png``, ``<stem>.inferred.png`` and ``<stem>.comparison.png``
beside the wav (labeled renders without text, ``eval.plots``) and a
tab-separated ``stats.csv`` of one row a file in the output directory.
"""

from __future__ import annotations

import logging
import random
import time
from argparse import ArgumentParser, Namespace
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import List

import numpy as np

from waveglow_tpu_torch.cli.argparse_helpers import (
    add_compute_arguments, add_denoiser_and_sigma_arguments,
    add_hparams_argument, get_optional, parse_existing_directory,
    parse_existing_file, parse_non_negative_integer, parse_path,
    parse_positive_integer)
from waveglow_tpu_torch.hparams import parse_custom_hparams

logger = logging.getLogger(__name__)

SYNTHESIZED_SUFFIX = ".synthesized.wav"


@dataclass
class InferenceEntry:
  """One row of ``stats.csv`` (the JAX command's columns, in its order)."""
  mel_path: Path = None
  seed: int = None
  iteration: int = None
  inferred_duration_s: float = None
  inference_duration_s: float = None
  denoising_duration_s: float = None
  was_overamplified: bool = None
  mel_original_frames: int = None
  mel_inferred_frames: int = None
  mcd_dtw: float = None
  mcd_dtw_penalty: float = None
  mcd_dtw_frames: int = None
  mcd: float = None
  mcd_penalty: float = None
  mcd_frames: int = None
  structural_similarity: float = None
  cosine_similarity: float = None
  denoiser_strength: float = None
  sigma: float = None


def _add_common(parser: ArgumentParser) -> None:
  add_denoiser_and_sigma_arguments(parser)
  add_hparams_argument(parser)
  add_compute_arguments(parser)
  parser.add_argument("--custom-seed",
                      type=get_optional(parse_non_negative_integer),
                      default=None, help="custom seed used for synthesis; "
                      "random if unset")
  parser.add_argument("--include-stats", action="store_true",
                      help="compute quality statistics (slower): MCD, "
                           "cosine and SSIM a file into stats.csv, and "
                           "mel plots without text beside each wav")
  parser.add_argument("--chunk-frames",
                      type=get_optional(parse_positive_integer),
                      default=None,
                      help="synthesize in fixed mel windows of this many "
                           "frames (activation memory of one window; "
                           "equal to one-call synthesis up to rounding) — "
                           "for very long inputs")
  parser.add_argument("--bucket-frames", type=parse_non_negative_integer,
                      default=64,
                      help="pad each mel's frame count up to a multiple of "
                           "this with the silence floor before synthesis "
                           "(trimmed afterwards; kept samples are "
                           "unchanged); 0 disables")
  parser.add_argument("--batch", type=parse_positive_integer, default=1,
                      help="synthesize up to this many same-bucket files "
                           "per device dispatch. 1 (default) synthesizes "
                           "one file at a time; batched outputs match it up "
                           "to float rounding (every file draws the same "
                           "seed's noise), and per-file durations in the "
                           "logs are the batch's wall time shared out. "
                           "Ignored with --chunk-frames")
  parser.add_argument("-out", "--output-directory", type=parse_path,
                      default=None,
                      help="custom output directory if FOLDER should not "
                           "be used")
  parser.add_argument("-o", "--overwrite", action="store_true",
                      help="overwrite already synthesized files")


def init_synthesis_parser(parser: ArgumentParser):
  parser.description = "Synthesize mel-spectrograms (.npy) to .wav files."
  parser.add_argument("checkpoint", metavar="CHECKPOINT",
                      type=parse_existing_file,
                      help="checkpoint to synthesize with (.npz or .pt)")
  parser.add_argument("folder", metavar="FOLDER",
                      type=parse_existing_directory,
                      help="folder containing mel-spectrogram .npy files")
  _add_common(parser)
  return lambda ns: _run(ns, source="npy")


def init_synthesis_wav_parser(parser: ArgumentParser):
  parser.description = ("Synthesize .wav files (via copy-synthesis through "
                        "the mel spectrogram).")
  parser.add_argument("checkpoint", metavar="CHECKPOINT",
                      type=parse_existing_file,
                      help="checkpoint to synthesize with (.npz or .pt)")
  parser.add_argument("folder", metavar="FOLDER",
                      type=parse_existing_directory,
                      help="folder containing .wav files")
  _add_common(parser)
  return lambda ns: _run(ns, source="wav")


def input_files(folder, source: str):
  """The inputs under ``folder``, sorted: ``.npy`` mels, or ``.wav`` files
  other than earlier copy-synthesis outputs (``*.synthesized.wav``: a rerun
  that read them would write ``*.synthesized.synthesized.wav``)."""
  suffix = ".npy" if source == "npy" else ".wav"
  return sorted(p for p in folder.rglob(f"*{suffix}")
                if p.is_file() and not (source == "wav"
                                        and p.name.endswith(
                                            SYNTHESIZED_SUFFIX)))


def _run(ns: Namespace, source: str) -> bool:
  from waveglow_tpu_torch.checkpointing import load_checkpoint_any
  from waveglow_tpu_torch.cli.logging_config import (flush_file_stem_loggers,
                                                     get_file_stem_logger,
                                                     init_file_stem_loggers)
  from waveglow_tpu_torch.device import resolve_device
  from waveglow_tpu_torch.dsp.audio_io import float_to_wav, normalize_wav
  from waveglow_tpu_torch.dsp.mel import MelSTFT
  from waveglow_tpu_torch.inference.synthesizer import Synthesizer

  device = resolve_device(ns.device)  # no card, no work
  output_directory = ns.output_directory or ns.folder
  if output_directory.is_file():
    logger.error("Output directory is a file!")
    return False

  seed = ns.custom_seed if ns.custom_seed is not None \
      else random.randint(1, 9999)
  if ns.custom_seed is None:
    logger.info("Using random seed: %d.", seed)

  try:
    checkpoint = load_checkpoint_any(ns.checkpoint)
  except Exception:  # noqa: BLE001
    logger.exception("Checkpoint couldn't be loaded!")
    return False

  synth = Synthesizer(checkpoint,
                      custom_hparams=parse_custom_hparams(ns.custom_hparams)
                      or None,
                      compute_dtype=ns.compute_dtype, device=device)
  mel_op = MelSTFT(synth.hparams, device=device)
  sr = synth.hparams.sampling_rate

  files = input_files(ns.folder, source)
  logger.info("Found %d %s file(s).", len(files),
              ".npy" if source == "npy" else ".wav")
  # per-file queue loggers: the --log file groups a batch job's messages
  # by input file
  stem_keys = [str(p.relative_to(ns.folder)) for p in files]
  stem_queues = init_file_stem_loggers(stem_keys)

  # the work list first, skipping existing outputs; mels load lazily (one
  # at a time solo, one slice batched), so the folder's size never sets
  # host memory
  work = []  # (path, stem_key, wav_out)
  for path, stem_key in zip(files, stem_keys):
    wav_out = (output_directory / path.relative_to(ns.folder).parent
               / f"{path.stem}.wav")
    if source == "wav" and ns.output_directory is None:
      wav_out = wav_out.with_name(f"{path.stem}{SYNTHESIZED_SUFFIX}")
    if wav_out.exists() and not ns.overwrite:
      logger.info("Skipping %s (exists).", wav_out)
      get_file_stem_logger(stem_key).info("Skipped (output exists): %s",
                                          wav_out)
      continue
    work.append((path, stem_key, wav_out))

  def load_mel(path):
    if source == "npy":
      return np.load(path)
    return mel_op.get_mel_from_file(path).cpu().numpy()

  entries: List[InferenceEntry] = []

  def write(item, mel, wav_denoised, infer_s, denoise_s, overamp, note=""):
    path, stem_key, wav_out = item
    wav_norm = normalize_wav(wav_denoised)
    wav_out.parent.mkdir(parents=True, exist_ok=True)
    float_to_wav(wav_norm, wav_out, sample_rate=sr)
    logger.info("%s -> %s (%.2fs audio in %.2fs%s)", path.name, wav_out,
                len(wav_norm) / sr, infer_s, note)
    get_file_stem_logger(stem_key).info(
        "Synthesized %s -> %s: %.2fs audio, infer %.3fs%s, denoise %.3fs, "
        "overamplified=%s", path.name, wav_out, len(wav_norm) / sr, infer_s,
        note, denoise_s, overamp)
    if ns.include_stats:
      entry = InferenceEntry(
          mel_path=path, seed=seed, iteration=checkpoint.iteration,
          inferred_duration_s=len(wav_norm) / sr,
          inference_duration_s=infer_s, denoising_duration_s=denoise_s,
          was_overamplified=overamp, denoiser_strength=ns.denoiser_strength,
          sigma=ns.sigma)
      score_output(entry, mel, mel_op.get_mel(wav_norm).cpu().numpy(),
                   wav_out.parent, path.stem)
      entries.append(entry)
      get_file_stem_logger(stem_key).info(
          "Stats: MCD-DTW %.4f, cosine %.4f, SSIM %.4f", entry.mcd_dtw,
          entry.cosine_similarity, entry.structural_similarity)

  if ns.batch > 1 and not ns.chunk_frames:
    # same-bucket files share a dispatch; each row draws the seed's noise
    # as a solo call would. One slice of mels is resident at a time
    slice_size = 8 * ns.batch
    for s in range(0, len(work), slice_size):
      chunk = work[s:s + slice_size]
      mels = [load_mel(item[0]) for item in chunk]
      t0 = time.perf_counter()
      results = synth.infer_serving_many(
          mels, sigma=ns.sigma, denoiser_strength=ns.denoiser_strength,
          seeds=[seed] * len(chunk), bucket_frames=ns.bucket_frames or None,
          max_batch=ns.batch)
      # the slice's wall time shared out over its files (the denoiser runs
      # inside the dispatch, so no separate denoise time)
      per_file_s = (time.perf_counter() - t0) / len(chunk)
      note = f" amortized over {len(chunk)}-file batch"
      for item, mel, r in zip(chunk, mels, results):
        write(item, mel, r.samples, per_file_s, 0.0, r.was_overamplified,
              note)
  else:
    for item in work:
      mel = load_mel(item[0])
      result = synth.infer(mel, sigma=ns.sigma,
                           denoiser_strength=ns.denoiser_strength, seed=seed,
                           chunk_frames=ns.chunk_frames,
                           bucket_frames=ns.bucket_frames or None)
      write(item, mel, result.wav_denoised, result.inference_duration_s,
            result.denoising_duration_s, result.was_overamplified)

  flush_file_stem_loggers(stem_queues)
  if entries:
    from waveglow_tpu_torch.eval.validation import write_tsv
    csv_path = output_directory / "stats.csv"
    write_tsv(csv_path, [asdict(e) for e in entries])
    logger.info("Wrote statistics to %s", csv_path)
  return True


def score_output(entry: InferenceEntry, mel_orig: np.ndarray,
                 mel_inferred: np.ndarray, dest_dir: Path,
                 out_stem: str) -> None:
  """Fill ``entry``'s metrics of the synthesized mel against the input mel
  and write ``<out_stem>.orig.png``, ``.inferred.png`` and
  ``.comparison.png`` (the labeled renders over the raw renders'
  difference) into ``dest_dir``."""
  from waveglow_tpu_torch.eval.plots import save_image, stack_images_vertically
  from waveglow_tpu_torch.eval.validation import score_mels

  scores = score_mels(mel_orig, mel_inferred)
  entry.mel_original_frames = mel_orig.shape[1]
  entry.mel_inferred_frames = mel_inferred.shape[1]
  entry.mcd_dtw, entry.mcd_dtw_penalty, entry.mcd_dtw_frames = scores.mcd_dtw
  entry.mcd, entry.mcd_penalty, entry.mcd_frames = scores.mcd
  entry.cosine_similarity = scores.cosine_similarity
  entry.structural_similarity = scores.structural_similarity
  orig_img, inf_img = scores.labeled
  save_image(dest_dir / f"{out_stem}.orig.png", orig_img)
  save_image(dest_dir / f"{out_stem}.inferred.png", inf_img)
  save_image(dest_dir / f"{out_stem}.comparison.png",
             stack_images_vertically([orig_img, inf_img, scores.raw_diff]))
  logger.info("MCD DTW: %.4f | MCD: %.4f | SSIM: %.4f | Cosine: %.4f",
              entry.mcd_dtw, entry.mcd, entry.structural_similarity,
              entry.cosine_similarity)
