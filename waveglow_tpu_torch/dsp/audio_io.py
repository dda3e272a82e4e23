"""Host-side wav IO in numpy (the port's own copy of what its data path and
its CLI need from ``waveglow_tpu/dsp/audio_io.py``): sample-format
conversion scales by ``-min(src)`` -> ``max(dst)`` and rounds for integer
targets; peak normalization scales to full scale."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np
from scipy.io import wavfile

FLOAT32_64_MIN_WAV = -1.0
FLOAT32_64_MAX_WAV = 1.0


def get_max_value(dtype):
  if dtype in (np.int16, np.int32):
    return np.iinfo(dtype).max
  if dtype in (np.float32, np.float64):
    return FLOAT32_64_MAX_WAV
  raise ValueError(
      f"unsupported wav dtype {dtype} (supported: int16, int32, float32/64)")


def get_min_value(dtype):
  if dtype in (np.int16, np.int32):
    return np.iinfo(dtype).min
  if dtype in (np.float32, np.float64):
    return FLOAT32_64_MIN_WAV
  raise ValueError(
      f"unsupported wav dtype {dtype} (supported: int16, int32, float32/64)")


def convert_wav(wav: np.ndarray, to_dtype) -> np.ndarray:
  """Rescale between int16/int32/float sample conventions."""
  if wav.dtype != to_dtype:
    wav = wav / (-1 * get_min_value(wav.dtype)) * get_max_value(to_dtype)
    if to_dtype in (np.int16, np.int32):
      wav = np.round(wav, 0)
    wav = wav.astype(to_dtype)
  return wav


def is_overamp(wav: np.ndarray) -> bool:
  return bool(np.min(wav) < get_min_value(wav.dtype) or
              np.max(wav) > get_max_value(wav.dtype))


def normalize_wav(wav: np.ndarray) -> np.ndarray:
  """Peak-normalize to full scale (mono or stereo); integer input that
  already reaches its minimum is returned as it is."""
  if wav.dtype in (np.int16, np.int32) and np.min(wav) == get_min_value(
      wav.dtype):
    return wav
  max_val = np.max(np.abs(wav))
  max_possible = get_max_value(wav.dtype)
  if max_val != 0 and max_val != max_possible:
    orig_dtype = wav.dtype
    wav_float = wav.astype(np.float32) * max_possible / max_val
    if orig_dtype in (np.int16, np.int32):
      wav_float = np.round(wav_float, 0)
    wav = wav_float.astype(orig_dtype)
  if np.max(np.abs(wav)) not in (max_possible, 0) or is_overamp(wav):
    raise ValueError(f"normalization left a peak of {np.max(np.abs(wav))}, "
                     f"not {max_possible}")
  return wav


def wav_to_float32(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
  """(float32 samples in [-1, 1] scale, sampling rate) of a wav file."""
  sampling_rate, wav = wavfile.read(str(path))
  try:
    return convert_wav(wav, np.float32), sampling_rate
  except ValueError as e:
    raise ValueError(f"{path}: {e}") from e


def float_to_wav(wav: np.ndarray, path: Union[str, Path], dtype=np.int16,
                 sample_rate: int = 22050) -> None:
  wavfile.write(str(path), sample_rate, convert_wav(np.asarray(wav), dtype))
