"""Bias removal by spectral subtraction (counterpart of
``waveglow_tpu/inference/denoiser.py``).

At construction the model synthesizes an 88-frame zeros mel at sigma 0
(through the WN kernel on the card) and keeps the first STFT frame of the
result as ``bias_spec``; a call subtracts ``strength * bias_spec`` from the
audio's magnitude spectrogram, clamps at 0 and inverts with the original
phases. It runs in float32 whatever the serving compute dtype.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from waveglow_tpu_torch.dsp.stft import STFT
from waveglow_tpu_torch.hparams import TSTFTHParams
from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, infer

BIAS_MEL_LENGTH = 88


class Denoiser:
  """Removes model bias from audio produced with WaveGlow."""

  def __init__(self, params: Dict, config: WaveGlowConfig,
               hparams: TSTFTHParams, device: torch.device):
    self.stft = STFT(hparams.filter_length, hparams.hop_length,
                     hparams.win_length, hparams.window, device=device)
    mel = torch.zeros((1, hparams.n_mel_channels, BIAS_MEL_LENGTH),
                      dtype=torch.float32, device=device)
    bias_audio = infer(params, config, mel, sigma=0.0, seed=0, device=device)
    bias_spec, _ = self.stft.transform(bias_audio)
    self.bias_spec = bias_spec[:, :, 0:1]  # [1, cutoff, 1], first frame

  def __call__(self, audio: torch.Tensor,
               strength: Union[float, torch.Tensor]) -> torch.Tensor:
    """[B, T] -> denoised [B, T'] (the iSTFT trims to a frame-aligned
    length). ``strength`` is a float or a per-row [B, 1, 1] tensor."""
    audio_spec, audio_angles = self.stft.transform(audio)
    denoised = torch.clamp(audio_spec - self.bias_spec * strength, min=0.0)
    return self.stft.inverse(denoised, audio_angles)
