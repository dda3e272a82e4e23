"""Run-directory layout and per-stem artefact savers (the port's
counterpart of ``waveglow_tpu/cli/io.py``).

It owns two things:

  * the on-disk layout of a training run, ``<train_dir>/{logs,
    checkpoints, inference, validation}``, with per-stem subdirectories and
    the ``<stem>.wav`` / ``<stem>.png`` / ``<stem>_orig.png`` /
    ``<stem>_diff.png`` / ``<stem>_comp.png`` / ``<stem>_v.png`` naming;
  * the savers that write those artefacts from waveforms and mels, on the
    port's numpy renders and PNG codec (``eval.plots``, ``eval.png``).

A library for pipelines that read this directory shape; the
``synthesize`` and ``validate`` commands write their own artefact sets.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from waveglow_tpu_torch.dsp.audio_io import float_to_wav
from waveglow_tpu_torch.eval.metrics import calculate_structural_similarity_np
from waveglow_tpu_torch.eval.plots import (make_same_width_by_filling_white,
                                           plot_melspec_np, save_image,
                                           stack_images_vertically)
from waveglow_tpu_torch.eval.png import read_png

__all__ = [
    "get_train_dir", "get_train_logs_dir", "get_train_log_file",
    "get_train_checkpoints_log_file", "get_checkpoints_dir",
    "get_inference_root_dir", "get_validation_root_dir",
    "save_infer_wav", "save_infer_plot", "save_infer_orig_plot",
    "save_diff_plot", "save_stacked_plot",
    "save_val_wav", "save_val_plot", "save_val_orig_plot",
    "save_val_comparison",
]


def _read_png(path) -> np.ndarray:
  """PNG file -> uint8 RGB array (alpha dropped)."""
  return read_png(path)[..., :3]


# -- directory layout -------------------------------------------------------------

def get_train_dir(base_dir: Path, train_name: str) -> Path:
  return Path(base_dir) / train_name


def get_train_logs_dir(train_dir: Path) -> Path:
  return Path(train_dir) / "logs"


def get_train_log_file(logs_dir: Path) -> Path:
  return Path(logs_dir) / "log.txt"


def get_train_checkpoints_log_file(logs_dir: Path) -> Path:
  return Path(logs_dir) / "log_checkpoints.txt"


def get_checkpoints_dir(train_dir: Path) -> Path:
  return Path(train_dir) / "checkpoints"


def get_inference_root_dir(train_dir: Path) -> Path:
  return Path(train_dir) / "inference"


def get_validation_root_dir(train_dir: Path) -> Path:
  return Path(train_dir) / "validation"


# -- per-stem artefact savers -------------------------------------------------------
# Each entry has its own directory; the files in it carry the directory's
# name.

def _stem(out_dir: Path) -> str:
  return Path(out_dir).name


def save_infer_wav(out_dir: Path, sampling_rate: int,
                   wav: np.ndarray) -> Path:
  """<dir>/<stem>.wav"""
  path = Path(out_dir) / f"{_stem(out_dir)}.wav"
  float_to_wav(np.asarray(wav), path, sample_rate=sampling_rate)
  return path


def save_infer_plot(out_dir: Path, mel: np.ndarray,
                    suffix: str = "") -> Path:
  """<dir>/<stem><suffix>.png: the mel's labeled render (no text)."""
  _, labeled = plot_melspec_np(np.asarray(mel))
  path = Path(out_dir) / f"{_stem(out_dir)}{suffix}.png"
  save_image(path, labeled)
  return path


def save_infer_orig_plot(out_dir: Path, mel: np.ndarray) -> Path:
  """<dir>/<stem>_orig.png"""
  return save_infer_plot(out_dir, mel, suffix="_orig")


def save_diff_plot(out_dir: Path) -> Tuple[float, Path]:
  """<dir>/<stem>_diff.png, and the SSIM of <stem>.png against
  <stem>_orig.png. Render widths follow the frame count, so the narrower
  image is padded with white first."""
  stem = _stem(out_dir)
  img_a = _read_png(Path(out_dir) / f"{stem}.png")
  img_b = _read_png(Path(out_dir) / f"{stem}_orig.png")
  img_a, img_b = make_same_width_by_filling_white([img_a, img_b])
  score, diff = calculate_structural_similarity_np(img_a, img_b)
  path = Path(out_dir) / f"{stem}_diff.png"
  save_image(path, diff)
  return score, path


def save_stacked_plot(out_dir: Path, suffixes=("_orig", "", "_diff"),
                      out_suffix: str = "_v") -> Path:
  """<dir>/<stem>_v.png: existing per-stem PNGs stacked vertically."""
  stem = _stem(out_dir)
  images = [_read_png(Path(out_dir) / f"{stem}{s}.png") for s in suffixes]
  stacked = stack_images_vertically(images)
  path = Path(out_dir) / f"{stem}{out_suffix}.png"
  save_image(path, stacked)
  return path


# -- validation aliases -----------------------------------------------------------

save_val_wav = save_infer_wav
save_val_plot = save_infer_plot
save_val_orig_plot = save_infer_orig_plot


def save_val_comparison(out_dir: Path) -> Path:
  """<dir>/<stem>_comp.png: original over synthesized."""
  return save_stacked_plot(out_dir, suffixes=("_orig", ""),
                           out_suffix="_comp")
