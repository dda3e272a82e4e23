"""STFT / iSTFT as framed matmuls (counterpart of ``waveglow_tpu/dsp/stft.py``).

The forward transform correlates reflect-padded audio with windowed rows of
``fft(eye(n_fft))`` as ONE ``[n_frames, n_fft] @ [n_fft, 2*cutoff]`` product;
the inverse projects frames through the windowed pseudo-inverse basis,
overlap-adds them, divides out the squared-window envelope, rescales by
``filter_length / hop_length`` and trims ``filter_length/2`` from both ends.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import get_window


def window_sumsquare_np(window: str, n_frames: int, hop_length: int,
                        win_length: int, n_fft: int,
                        dtype=np.float32) -> np.ndarray:
  """Sum-square envelope of the analysis window at a given hop (numpy)."""
  n = n_fft + hop_length * (n_frames - 1)
  x = np.zeros(n, dtype=dtype)
  win_sq = get_window(window, win_length, fftbins=True).astype(np.float64) ** 2
  pad = n_fft - win_length
  win_sq = np.pad(win_sq, (pad // 2, pad - pad // 2))
  for i in range(n_frames):
    sample = i * hop_length
    x[sample:min(n, sample + n_fft)] += win_sq[:max(0, min(n_fft, n - sample))]
  return x


@functools.lru_cache(maxsize=8)
def _bases(filter_length: int, hop_length: int, win_length: int,
           window: Optional[str]) -> Tuple[np.ndarray, np.ndarray]:
  """(forward_basis [n_fft, 2*cutoff], inverse_basis [2*cutoff, n_fft]):
  the first ``cutoff`` columns are Re(DFT), the rest Im(DFT)."""
  scale = filter_length / hop_length
  fourier = np.fft.fft(np.eye(filter_length))
  cutoff = filter_length // 2 + 1
  fourier = np.vstack([np.real(fourier[:cutoff]), np.imag(fourier[:cutoff])])
  forward = fourier.copy()
  inverse = np.linalg.pinv(scale * fourier).T
  if window is not None:
    if filter_length < win_length:
      raise ValueError("win_length must not exceed filter_length")
    win = get_window(window, win_length, fftbins=True)
    pad = filter_length - win_length
    win = np.pad(win, (pad // 2, pad - pad // 2))
    forward = forward * win[None, :]
    inverse = inverse * win[None, :]
  return forward.T.astype(np.float32), inverse.astype(np.float32)


class STFT:
  """STFT operator with its bases as float32 tensors on ``device``."""

  def __init__(self, filter_length: int = 1024, hop_length: int = 256,
               win_length: int = 1024, window: Optional[str] = "hann",
               device: torch.device = torch.device("cpu")):
    if filter_length % hop_length:
      raise ValueError("hop_length must divide filter_length")
    self.filter_length = filter_length
    self.hop_length = hop_length
    self.win_length = win_length
    self.window = window
    self.device = torch.device(device)
    fwd, inv = _bases(filter_length, hop_length, win_length, window)
    self.forward_basis = torch.from_numpy(fwd).to(self.device)
    self.inverse_basis = torch.from_numpy(inv).to(self.device)
    self.cutoff = filter_length // 2 + 1
    self._inv_env: Dict[int, torch.Tensor] = {}

  def transform(self, audio: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] -> (magnitude, phase), each [B, cutoff, n_frames]."""
    half = self.filter_length // 2
    padded = F.pad(audio.float()[:, None, :], (half, half),
                   mode="reflect")[:, 0]
    frames = padded.unfold(-1, self.filter_length, self.hop_length)
    spec = torch.matmul(frames, self.forward_basis)   # [B, N, 2*cutoff]
    real = spec[..., :self.cutoff]
    imag = spec[..., self.cutoff:]
    magnitude = torch.sqrt(real * real + imag * imag)
    phase = torch.atan2(imag, real)
    return magnitude.transpose(1, 2), phase.transpose(1, 2)

  def _envelope(self, n_frames: int) -> torch.Tensor:
    """1 / window-sum-square where it exceeds float32 tiny, else 1, times
    the hop-ratio rescale (cached per frame count)."""
    env = self._inv_env.get(n_frames)
    if env is None:
      wss = window_sumsquare_np(self.window, n_frames, self.hop_length,
                                self.win_length, self.filter_length)
      tiny = np.finfo(np.float32).tiny
      inv = np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0)
      inv = inv.astype(np.float32) * np.float32(
          float(self.filter_length) / self.hop_length)
      env = torch.from_numpy(inv.astype(np.float32)).to(self.device)
      self._inv_env[n_frames] = env
    return env

  def inverse(self, magnitude: torch.Tensor,
              phase: torch.Tensor) -> torch.Tensor:
    """(mag, phase) [B, cutoff, n_frames] -> audio [B, T]."""
    batch, _, n_frames = magnitude.shape
    recombined = torch.cat([magnitude * torch.cos(phase),
                            magnitude * torch.sin(phase)],
                           dim=1).transpose(1, 2)        # [B, N, 2*cutoff]
    frames = torch.matmul(recombined, self.inverse_basis)  # [B, N, n_fft]
    hop = self.hop_length
    ratio = self.filter_length // hop
    chunks = frames.reshape(batch, n_frames, ratio, hop)
    signal = torch.zeros((batch, (n_frames + ratio - 1) * hop),
                         dtype=frames.dtype, device=frames.device)
    body = n_frames * hop
    for j in range(ratio):
      signal[:, j * hop:j * hop + body] += chunks[:, :, j, :].reshape(
          batch, body)
    if self.window is not None:
      signal = signal * self._envelope(n_frames)[None, :]
    half = self.filter_length // 2
    return signal[:, half:-half]
