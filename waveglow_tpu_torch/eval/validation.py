"""Quality validation: synthesize dataset entries and score them against
the originals (the port's counterpart of ``waveglow_tpu/eval/validation.py``).

Entry selection (all, named files, or one seeded-random file), copy
synthesis through the ``Synthesizer`` on its device, then on the host MCD
with and without DTW (16 MFCCs), the padded cosine mel similarity and SSIM
over the raw spectrogram renders; per-entry artefacts go through a save
callback. The report is a list of rows (``get_rows``) that ``write_tsv``
writes as a tab-separated file, as ``pandas.DataFrame.to_csv(sep="\\t",
index=False)`` writes it; the port uses no pandas.
"""

from __future__ import annotations

import csv
import datetime
import logging
import math
import numbers
import random
from dataclasses import dataclass
from pathlib import Path
from typing import (Any, Callable, Dict, List, Optional, Set, Tuple,
                    Union)

import numpy as np

from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.dsp.audio_io import get_duration_s, normalize_wav
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.eval.metrics import (MCD_NO_OF_COEFFS_PER_FRAME,
                                             abs_diff_image,
                                             calculate_structural_similarity_np,
                                             cosine_dist_mels, get_metrics_mels)
from waveglow_tpu_torch.eval.plots import (make_same_width_by_filling_white,
                                           plot_melspec_np)
from waveglow_tpu_torch.inference.synthesizer import (InferenceResult,
                                                      Synthesizer)
from waveglow_tpu_torch.training.data import Entries, Entry

logger = logging.getLogger(__name__)


@dataclass
class ValidationEntry:
  entry: Entry = None
  inference_result: InferenceResult = None
  seed: int = None
  iteration: int = None
  timepoint: datetime.datetime = None
  inferred_duration_s: float = None
  diff_frames: int = None
  mfcc_no_coeffs: int = None
  mfcc_dtw_mcd: float = None
  mfcc_dtw_penalty: float = None
  mfcc_dtw_frames: int = None
  mcd: float = None
  mcd_penalty: float = None
  mcd_frames: int = None
  structural_similarity: float = None
  cosine_similarity: float = None
  denoiser_strength: float = None
  sigma: float = None


class ValidationEntries(List[ValidationEntry]):
  pass


@dataclass
class ValidationEntryOutput:
  mel_orig: np.ndarray = None
  mel_orig_img: np.ndarray = None
  orig_sr: int = None
  wav_orig: np.ndarray = None
  inferred_sr: int = None
  mel_inferred_denoised: np.ndarray = None
  mel_inferred_denoised_img: np.ndarray = None
  wav_inferred_denoised: np.ndarray = None
  mel_denoised_diff_img: np.ndarray = None
  wav_inferred: np.ndarray = None


def get_rows(entries: ValidationEntries) -> List[Dict[str, Any]]:
  """One row a validated entry: the JAX report's 23 columns, in its order."""
  return [
      {
          "Name": e.entry.basename,
          "Subpath": e.entry.stem,
          "Timepoint": f"{e.timepoint:%Y/%m/%d %H:%M:%S}",
          "Iteration": e.iteration,
          "Seed": e.seed,
          "Sigma": e.sigma,
          "Denoiser strength": e.denoiser_strength,
          "Inference duration (s)": e.inference_result.inference_duration_s,
          "Denoising duration (s)": e.inference_result.denoising_duration_s,
          "Overamplified?": e.inference_result.was_overamplified,
          "Inferred wav duration (s)": e.inferred_duration_s,
          "# Difference frames": e.diff_frames,
          "Sampling rate (Hz)": e.inference_result.sampling_rate,
          "# MFCC Coefficients": e.mfcc_no_coeffs,
          "MFCC DTW MCD": e.mfcc_dtw_mcd,
          "MFCC DTW PEN": e.mfcc_dtw_penalty,
          "# MFCC DTW frames": e.mfcc_dtw_frames,
          "MCD": e.mcd,
          "PEN": e.mcd_penalty,
          "# Frames": e.mcd_frames,
          "Cosine Similarity (Padded)": e.cosine_similarity,
          "Structural Similarity (Padded)": e.structural_similarity,
          "Wav path": str(e.entry.wav_absolute_path),
      }
      for e in entries
  ]


def _missing(value) -> bool:
  return value is None or (isinstance(value, float) and math.isnan(value))


def _column_formatter(values: List[Any]) -> Callable[[Any], str]:
  """How pandas writes a column it inferred from these values: booleans as
  ``True``/``False``; integers as integers unless a value is missing (then
  the column is float); a column of float32 values alone in float32's
  shortest form; other numbers with any float as ``repr`` of the float;
  anything else with ``str``. Missing values (None, NaN) are empty."""
  present = [v for v in values if not _missing(v)]
  complete = len(present) == len(values)
  if all(isinstance(v, (bool, np.bool_)) for v in present):
    fmt = str
  elif complete and all(isinstance(v, np.float32) for v in present):
    fmt = str
  elif all(isinstance(v, numbers.Real) and not isinstance(v, (bool, np.bool_))
           for v in present):
    if complete and all(isinstance(v, numbers.Integral) for v in present):
      fmt = lambda v: str(int(v))  # noqa: E731
    else:
      fmt = lambda v: repr(float(v))  # noqa: E731
  else:
    fmt = str
  return lambda v: "" if _missing(v) else fmt(v)


def write_tsv(path: Union[str, Path], rows: List[Dict[str, Any]]) -> None:
  """Write ``rows`` (dicts with one set of keys, the first row's order) as
  tab-separated text with a header: ``\\n`` line ends, fields quoted only
  where they hold a tab, a quote or a line break, the bytes that
  ``pandas.DataFrame(rows).to_csv(path, sep="\\t", index=False)`` writes."""
  if not rows:
    raise ValueError("write_tsv needs at least one row")
  columns = list(rows[0])
  for i, row in enumerate(rows):
    if list(row) != columns:
      raise ValueError(f"row {i} has columns {list(row)}, expected {columns}")
  formats = [_column_formatter([row[c] for row in rows]) for c in columns]
  with open(path, "w", newline="") as f:
    writer = csv.writer(f, delimiter="\t", lineterminator="\n",
                        quoting=csv.QUOTE_MINIMAL)
    writer.writerow(columns)
    for row in rows:
      writer.writerow([fmt(row[c]) for fmt, c in zip(formats, columns)])


@dataclass
class MelScores:
  """An inferred mel scored against its original."""
  mcd_dtw: Tuple[float, float, int]   # (MCD, penalty, frames) after DTW
  mcd: Tuple[float, float, int]       # the same, zero-padded, no DTW
  cosine_similarity: float
  structural_similarity: float        # over the raw renders
  raw_diff: np.ndarray                # |raw render difference|
  labeled: Tuple[np.ndarray, np.ndarray]   # (original, inferred)


def score_mels(mel_orig: np.ndarray, mel_inferred: np.ndarray) -> MelScores:
  """MCD with and without DTW (16 MFCCs), the padded cosine similarity, and
  SSIM over the two raw renders padded with white to one width; with the
  labeled renders for the reports."""
  mcd_dtw = get_metrics_mels(mel_orig, mel_inferred,
                             n_mfcc=MCD_NO_OF_COEFFS_PER_FRAME,
                             take_log=False, use_dtw=True)
  mcd = get_metrics_mels(mel_orig, mel_inferred,
                         n_mfcc=MCD_NO_OF_COEFFS_PER_FRAME, take_log=False,
                         use_dtw=False)
  cosine = cosine_dist_mels(mel_orig, mel_inferred)
  orig_raw, orig_labeled = plot_melspec_np(mel_orig)
  inf_raw, inf_labeled = plot_melspec_np(mel_inferred)
  ssim, raw_diff = calculate_structural_similarity_np(
      *make_same_width_by_filling_white([orig_raw, inf_raw]))
  return MelScores(mcd_dtw=mcd_dtw, mcd=mcd, cosine_similarity=cosine,
                   structural_similarity=ssim, raw_diff=raw_diff,
                   labeled=(orig_labeled, inf_labeled))


def select_entries(data: Entries, entry_names: Set[str], full_run: bool,
                   seed: int) -> Entries:
  """All of ``data`` (``full_run``), the entries of the named files, or one
  entry drawn with ``seed``. Names are matched against basenames; a name
  that matches no file or more than one raises ``ValueError``."""
  if full_run:
    return list(data)
  if len(entry_names) == 0:
    if len(data) == 0:
      raise ValueError("no entries to choose from")
    rng = random.Random(seed)
    return [rng.choice(data)]
  entries = [x for x in data if x.basename in entry_names]
  # by the set of names, not the count: a duplicate basename in another
  # subfolder must not make up for a missing name
  missing = entry_names - {x.basename for x in entries}
  if missing:
    raise ValueError(
        f"Not all entry names were found! Missing: {sorted(missing)}")
  names = [x.basename for x in entries]
  dupes = sorted({n for n in names if names.count(n) > 1})
  if dupes:
    # both files would write into out_dir/<stem>/
    raise ValueError(
        f"Requested name(s) {dupes} match multiple files across "
        "subfolders; their outputs would collide. Validate with "
        "--full-run or point DATA-FOLDER at a tree without duplicates.")
  return entries


def validate(checkpoint: CheckpointWaveglow, data: Entries,
             custom_hparams: Optional[Dict[str, str]],
             denoiser_strength: float, sigma: float,
             entry_names: Set[str], full_run: bool,
             save_callback: Callable[[Entry, ValidationEntryOutput], None],
             seed: Optional[int], device: str = "cuda") -> ValidationEntries:
  """Copy-synthesize the selected entries with ``checkpoint`` on
  ``device`` (the card by default; raises without one) and score each
  against its original. The mels come back to the host for the metrics."""
  validation_entries = ValidationEntries()

  if seed is None:
    seed = random.randint(1, 9999)
    logger.info("As no seed was given, using random seed: %d.", seed)

  entries = select_entries(data, entry_names, full_run, seed)
  if len(entries) == 0:
    logger.info("Nothing to synthesize!")
    return validation_entries

  synth = Synthesizer(checkpoint, custom_hparams=custom_hparams,
                      device=device)
  mel_op = MelSTFT(synth.hparams, device=synth.device)

  for entry in entries:
    # the wav is read once: it feeds the conditioning mel and the output
    wav_orig = mel_op.get_wav_from_file(entry.wav_absolute_path)
    orig_sr = synth.hparams.sampling_rate
    mel = mel_op.get_mel(wav_orig).cpu().numpy()

    timepoint = datetime.datetime.now()
    inference_result = synth.infer(
        mel, sigma=sigma, denoiser_strength=denoiser_strength, seed=seed)

    wav_denoised_norm = normalize_wav(inference_result.wav_denoised)

    val_entry = ValidationEntry(
        entry=entry, inference_result=inference_result, seed=seed,
        iteration=checkpoint.iteration, timepoint=timepoint,
        inferred_duration_s=get_duration_s(
            inference_result.wav_denoised, inference_result.sampling_rate),
        denoiser_strength=denoiser_strength, sigma=sigma,
        mfcc_no_coeffs=MCD_NO_OF_COEFFS_PER_FRAME)

    mel_orig = mel
    mel_inferred_denoised = mel_op.get_mel(wav_denoised_norm).cpu().numpy()

    output = ValidationEntryOutput(
        mel_orig=mel_orig, inferred_sr=inference_result.sampling_rate,
        mel_inferred_denoised=mel_inferred_denoised,
        wav_inferred_denoised=wav_denoised_norm, wav_orig=wav_orig,
        orig_sr=orig_sr, wav_inferred=normalize_wav(inference_result.wav))

    scores = score_mels(mel_orig, mel_inferred_denoised)
    val_entry.diff_frames = mel_inferred_denoised.shape[1] - mel_orig.shape[1]
    (val_entry.mfcc_dtw_mcd, val_entry.mfcc_dtw_penalty,
     val_entry.mfcc_dtw_frames) = scores.mcd_dtw
    val_entry.mcd, val_entry.mcd_penalty, val_entry.mcd_frames = scores.mcd
    val_entry.cosine_similarity = scores.cosine_similarity
    val_entry.structural_similarity = scores.structural_similarity
    output.mel_orig_img, output.mel_inferred_denoised_img = scores.labeled
    output.mel_denoised_diff_img = abs_diff_image(
        *make_same_width_by_filling_white(list(scores.labeled)))

    logger.info("Current: %s | MCD DTW: %.4f (pen %.4f, %d frames) | "
                "MCD: %.4f | SSIM: %.4f | Cosine: %.4f",
                entry.stem, val_entry.mfcc_dtw_mcd,
                val_entry.mfcc_dtw_penalty, val_entry.mfcc_dtw_frames,
                val_entry.mcd, val_entry.structural_similarity,
                val_entry.cosine_similarity)

    save_callback(entry, output)
    validation_entries.append(val_entry)

  return validation_entries
