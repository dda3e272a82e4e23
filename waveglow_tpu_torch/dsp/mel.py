"""Waveform -> log-mel-spectrogram on the device (counterpart of
``waveglow_tpu/dsp/mel.py``).

``mel = log(clamp(mel_basis @ |STFT|, min=1e-5))`` with an 80-bin slaney
filterbank over 0-8000 Hz. Training computes it from the raw audio segment
inside the step, on the card; the overamplification check lives on the host
file-loading path (:meth:`MelSTFT.get_wav_from_file`, and
:meth:`MelSTFT.get_mel_from_file`, which copy synthesis calls).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from waveglow_tpu_torch.device import resolve_device, to_device
from waveglow_tpu_torch.dsp import audio_io
from waveglow_tpu_torch.dsp.mel_filters import mel_filterbank
from waveglow_tpu_torch.dsp.stft import STFT
from waveglow_tpu_torch.hparams import TSTFTHParams

# Log-clamp floor of the mel front end: log(CLIP_VAL) is the silence level
# that bucket padding fills with.
CLIP_VAL = 1e-5


class MelSTFT:
  """wav -> mel operator with its bases as float32 tensors on ``device``:
  the card by default (raises without one); ``device="cpu"`` for the CPU."""

  def __init__(self, hparams: TSTFTHParams = None,
               device: Optional[Union[str, torch.device]] = None):
    hparams = hparams or TSTFTHParams()
    self.hparams = hparams
    self.n_mel_channels = hparams.n_mel_channels
    self.sampling_rate = hparams.sampling_rate
    self.device = resolve_device(device)
    self.stft = STFT(hparams.filter_length, hparams.hop_length,
                     hparams.win_length, hparams.window, device=self.device)
    basis = mel_filterbank(hparams.sampling_rate, hparams.filter_length,
                           hparams.n_mel_channels, hparams.mel_fmin,
                           hparams.mel_fmax)
    self.mel_basis_t = torch.from_numpy(basis.T.copy()).to(self.device)

  def mel_spectrogram(self, audio: torch.Tensor) -> torch.Tensor:
    """[B, T] in [-1, 1] -> log-mel [B, n_mels, n_frames], float32."""
    magnitude = torch.sqrt(torch.clamp(self.stft.transform_mag2(audio),
                                       min=0.0))
    mel = torch.matmul(magnitude, self.mel_basis_t)      # [B, N, n_mels]
    return torch.log(torch.clamp(mel, min=CLIP_VAL)).transpose(1, 2)

  def get_mel(self, audio: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """One utterance [T] (numpy or tensor) -> log-mel [n_mels, n_frames]
    on the device."""
    audio = to_device(audio, self.device, torch.float32)
    return self.mel_spectrogram(audio[None, :])[0]

  def get_wav_from_file(self, wav_path: Union[str, Path]) -> np.ndarray:
    """float32 samples of a wav file; raises ``ValueError`` on a sampling
    rate other than the model's or on samples outside [-1, 1]."""
    wav, sr = audio_io.wav_to_float32(wav_path)
    if sr != self.sampling_rate:
      raise ValueError(
          f"{wav_path}: sampling rate {sr} Hz does not match target "
          f"{self.sampling_rate} Hz")
    if audio_io.is_overamp(wav):
      raise ValueError(
          f"{wav_path}: samples outside [-1, 1] (overamplified input; "
          "normalize the file first)")
    return wav

  def get_mel_from_file(self, wav_path: Union[str, Path]) -> torch.Tensor:
    """Log-mel [n_mels, n_frames] of a wav file, on the device (the checks
    of :meth:`get_wav_from_file` first)."""
    return self.get_mel(self.get_wav_from_file(wav_path))
