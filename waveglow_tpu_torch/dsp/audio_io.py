"""Host-side wav IO in numpy (the port's own copy of
``waveglow_tpu/dsp/audio_io.py``): sample-format conversion scales by
``-min(src)`` -> ``max(dst)`` and rounds for integer targets; peak
normalization scales to full scale; durations, sample counts, random
segment crops and concatenation with pauses."""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple, Union

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


def get_duration_s(wav: np.ndarray, sampling_rate: int) -> float:
  return len(wav) / sampling_rate


def get_duration_s_file(path: Union[str, Path]) -> float:
  sampling_rate, wav = wavfile.read(str(path))
  return get_duration_s(wav, sampling_rate)


def get_sample_count(sampling_rate: int, duration_s: float) -> int:
  return int(round(sampling_rate * duration_s, 0))


def get_wav_segment(wav: np.ndarray, segment_length: int,
                    rng: np.random.Generator) -> np.ndarray:
  """Random fixed-length crop, or trailing zero-pad when too short."""
  if len(wav) >= segment_length:
    start = int(rng.integers(0, len(wav) - segment_length + 1))
    return wav[start:start + segment_length]
  return np.pad(wav, (0, segment_length - len(wav)))


def concatenate_audios(audios: Sequence[np.ndarray], pause_s: float,
                       sampling_rate: int) -> np.ndarray:
  """The audios joined along the last axis with ``pause_s`` of silence
  between each two. The pause has the inputs' dtype, so int16 samples stay
  int16 (a float64 pause would promote them, and a later float-to-int16
  conversion would wrap them)."""
  pause_samples = get_sample_count(sampling_rate, pause_s)
  if len(audios) == 1:
    return np.array(audios[0])
  pause_shape = list(audios[0].shape)
  pause_shape[-1] = pause_samples
  pause = np.zeros(tuple(pause_shape), dtype=np.result_type(*audios))
  parts: List[np.ndarray] = []
  for audio in audios[:-1]:
    parts.append(audio)
    parts.append(pause)
  parts.append(audios[-1])
  return np.concatenate(parts, axis=-1)
