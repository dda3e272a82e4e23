"""Slaney-style mel filterbank in numpy (the port's own copy of
``waveglow_tpu/dsp/mel_filters.py``).

The algorithm of ``librosa.filters.mel`` with ``htk=False`` and
``norm="slaney"``: linear below 1 kHz at 200/3 Hz per mel, logarithmic above
with a factor of 6.4 per 27 mels; triangular filters area-normalised by
``2 / (f_upper - f_lower)``.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0          # Hz per mel in the linear region
_MIN_LOG_HZ = 1000.0         # linear/log boundary
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
  freq = np.asanyarray(freq, dtype=np.float64)
  mels = freq / _F_SP
  log_region = freq >= _MIN_LOG_HZ
  return np.where(
      log_region,
      _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
      mels)


def mel_to_hz(mel):
  mel = np.asanyarray(mel, dtype=np.float64)
  freq = _F_SP * mel
  log_region = mel >= _MIN_LOG_MEL
  return np.where(log_region,
                  _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), freq)


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
  """Centers of ``n_mels`` points uniformly spaced on the mel scale."""
  return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float, dtype=np.float32) -> np.ndarray:
  """Triangular slaney-normalized mel filterbank, shape [n_mels, 1 + n_fft//2]."""
  fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
  mel_f = mel_frequencies(n_mels + 2, fmin, fmax)
  fdiff = np.diff(mel_f)
  ramps = np.subtract.outer(mel_f, fftfreqs)  # mel_f[i] - fftfreqs[j]
  lower = -ramps[:-2] / fdiff[:-1, None]
  upper = ramps[2:] / fdiff[1:, None]
  weights = np.maximum(0.0, np.minimum(lower, upper))
  # Slaney normalization: each triangle has unit area in Hz.
  enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
  weights *= enorm[:, None]
  return weights.astype(dtype)
