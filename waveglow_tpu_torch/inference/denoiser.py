"""Bias removal by spectral subtraction (counterpart of
``waveglow_tpu/inference/denoiser.py``).

At construction the model synthesizes an 88-frame zero mel at sigma 0
(through the WN kernel on the card) and keeps the first STFT frame of the
result as ``bias_spec``; a call subtracts ``strength * bias_spec`` from the
audio's magnitude spectrogram, clamps at 0 and inverts with the original
phases. It runs in float32 whatever the serving compute dtype. On a
tensor-parallel group (a list of model ranks' params) the bias is captured
through the group. :func:`capture_bias` is the capture of any mel, in any
compute dtype, through any layer function.
"""

from __future__ import annotations

import copy
from typing import Optional, Union

import torch

from waveglow_tpu_torch.dsp.stft import STFT, reflect_pad
from waveglow_tpu_torch.hparams import TSTFTHParams
from waveglow_tpu_torch.kernels.wn_layer import wn_layer_fused
from waveglow_tpu_torch.models.waveglow import (WaveGlowConfig, infer,
                                                params_for_compute)

BIAS_MEL_LENGTH = 88


def capture_bias(params, config: WaveGlowConfig, stft: STFT,
                 mel: torch.Tensor, compute_dtype=None,
                 layer=wn_layer_fused) -> torch.Tensor:
  """The first STFT frame, [1, cutoff, 1] f32, of ``infer`` of ``mel`` at
  sigma 0 with f32 ``params`` (a tree, or a tensor-parallel list of trees)
  in ``compute_dtype``, every WN layer through ``layer``."""
  if isinstance(params, (list, tuple)):
    params = [params_for_compute(tree, compute_dtype) for tree in params]
  else:
    params = params_for_compute(params, compute_dtype)
  audio = infer(params, config, mel, sigma=0.0, seed=0,
                compute_dtype=compute_dtype, layer=layer,
                device=stft.device)
  spec, _ = stft.transform(audio.float())
  return spec[:, :, 0:1]


def denoise_window(stft: STFT, padded: torch.Tensor, bias: torch.Tensor,
                   strength: Union[float, torch.Tensor],
                   inv_env: Optional[torch.Tensor]) -> torch.Tensor:
  """Spectral subtraction over reflect-padded audio, without the trim:
  [B, W] -> [B, W]. Frames at stride ``hop`` (:meth:`STFT.polar`),
  ``bias * strength`` subtracted from the magnitude and clamped at 0, the
  inverse basis and overlap-add (:meth:`STFT.overlap_frames`), then the
  envelope ``inv_env`` [W] (None: no window, so none). ``bias`` is
  [1, 1, cutoff]; ``strength`` a float or a per-row [B, 1, 1] tensor.
  """
  magnitude, phase = stft.polar(padded)
  magnitude = torch.clamp(magnitude - bias * strength, min=0.0)
  signal = stft.overlap_frames(magnitude, phase)
  return signal if inv_env is None else signal * inv_env[None, :]


class Denoiser:
  """Removes model bias from audio produced with WaveGlow."""

  def __init__(self, params, config: WaveGlowConfig,
               hparams: TSTFTHParams, device: torch.device):
    self.stft = STFT(hparams.filter_length, hparams.hop_length,
                     hparams.win_length, hparams.window, device=device)
    mel = torch.zeros((1, hparams.n_mel_channels, BIAS_MEL_LENGTH),
                      dtype=torch.float32, device=self.stft.device)
    self.bias_spec = capture_bias(params, config, self.stft, mel)

  def to(self, device: torch.device) -> "Denoiser":
    """This denoiser on ``device``: the same bias, copied there (itself
    when it is there already)."""
    if device == self.stft.device:
      return self
    other = copy.copy(self)
    stft = self.stft
    other.stft = STFT(stft.filter_length, stft.hop_length, stft.win_length,
                      stft.window, device=device)
    other.bias_spec = self.bias_spec.to(device)
    return other

  def __call__(self, audio: torch.Tensor,
               strength: Union[float, torch.Tensor]) -> torch.Tensor:
    """[B, T] -> denoised [B, T'] (the iSTFT trims to a frame-aligned
    length). ``strength`` is a float or a per-row [B, 1, 1] tensor."""
    stft = self.stft
    half = stft.filter_length // 2
    padded = reflect_pad(audio.float(), half)
    n_frames = (padded.shape[-1] - stft.filter_length) // stft.hop_length + 1
    inv_env = None if stft.window is None else stft.envelope(n_frames)
    out = denoise_window(stft, padded, self.bias_spec.transpose(1, 2),
                         strength, inv_env)
    return out[:, half:-half]
