"""STFT / iSTFT as framed matmuls (counterpart of ``waveglow_tpu/dsp/stft.py``).

The forward transform correlates reflect-padded audio with windowed rows of
``fft(eye(n_fft))`` as ONE ``[n_frames, n_fft] @ [n_fft, 2*cutoff]`` product;
the inverse projects frames through the windowed pseudo-inverse basis,
overlap-adds them, divides out the squared-window envelope, rescales by
``filter_length / hop_length`` and trims ``filter_length/2`` from both ends.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import get_window

from waveglow_tpu_torch.device import resolve_device, to_device

# Envelopes an STFT keeps on its device, one a frame count, least recently
# used dropped first: a folder of distinct lengths keeps at most this many.
ENV_CACHE_SIZE = 4


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


def inverse_envelope(wss: np.ndarray, scale: float) -> np.ndarray:
  """float32 ``scale / wss`` where the window-sum-square exceeds float32
  tiny, else ``scale``: the iSTFT's normalisation and hop-ratio rescale as
  one factor a position."""
  tiny = np.finfo(np.float32).tiny
  inv = np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0)
  return inv.astype(np.float32) * np.float32(scale)


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


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
  """[B, T] -> [B, T + 2 * pad], reflected at both ends without repeating
  the edge sample, as ``np.pad(mode="reflect")``: where ``pad`` is not
  shorter than T, the reflection repeats (period ``2 * (T - 1)``)."""
  t = x.shape[-1]
  if pad < t:
    return F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
  pos = torch.arange(-pad, t + pad, device=x.device)
  if t == 1:
    return x[:, torch.zeros_like(pos)]
  period = 2 * (t - 1)
  pos = torch.remainder(pos, period)
  return x[:, torch.where(pos < t, pos, period - pos)]


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
  """Frame [B, T] into [B, n_frames, frame_length] at stride ``hop_length``
  (a view; ``n_frames = (T - frame_length) // hop_length + 1``)."""
  return x.unfold(-1, frame_length, hop_length)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
  """Overlap-add [B, n_frames, L] at stride ``hop_length`` ->
  [B, (n_frames - 1) * hop_length + L]; ``L`` must be a multiple of the
  hop. Positions sum their frames in increasing frame order."""
  batch, n_frames, length = frames.shape
  if length % hop_length:
    raise ValueError(f"frame length {length} is not a multiple of the hop "
                     f"{hop_length}")
  ratio = length // hop_length
  chunks = frames.reshape(batch, n_frames, ratio, hop_length)
  signal = torch.zeros((batch, (n_frames + ratio - 1) * hop_length),
                       dtype=frames.dtype, device=frames.device)
  body = n_frames * hop_length
  for j in range(ratio):
    signal[:, j * hop_length:j * hop_length + body] += chunks[
        :, :, j, :].reshape(batch, body)
  return signal


class STFT:
  """STFT operator with its bases as float32 tensors on ``device``: the
  card by default (raises without one); ``device="cpu"`` for the CPU."""

  def __init__(self, filter_length: int = 1024, hop_length: int = 256,
               win_length: int = 1024, window: Optional[str] = "hann",
               device: Optional[Union[str, torch.device]] = None):
    if filter_length % hop_length:
      raise ValueError("hop_length must divide filter_length")
    self.filter_length = filter_length
    self.hop_length = hop_length
    self.win_length = win_length
    self.window = window
    self.device = resolve_device(device)
    fwd, inv = _bases(filter_length, hop_length, win_length, window)
    self.forward_basis = torch.from_numpy(fwd).to(self.device)
    self.inverse_basis = torch.from_numpy(inv).to(self.device)
    self.cutoff = filter_length // 2 + 1
    self._inv_env: "OrderedDict[int, torch.Tensor]" = OrderedDict()

  def _spectrum(self, padded: torch.Tensor) -> torch.Tensor:
    """Padded [B, W] -> [B, n_frames, 2*cutoff] (Re, then Im): one DFT
    matmul over the frames at stride ``hop``."""
    frames = frame_signal(padded, self.filter_length, self.hop_length)
    return torch.matmul(frames, self.forward_basis)

  def polar(self, padded: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded [B, W] -> (magnitude, phase), each [B, n_frames, cutoff]
    (channels-last, no reflect pad)."""
    spec = self._spectrum(padded)
    real = spec[..., :self.cutoff]
    imag = spec[..., self.cutoff:]
    return torch.sqrt(real * real + imag * imag), torch.atan2(imag, real)

  def transform(self, audio: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] -> (magnitude, phase), each [B, cutoff, n_frames]."""
    magnitude, phase = self.polar(
        reflect_pad(audio.float(), self.filter_length // 2))
    return magnitude.transpose(1, 2), phase.transpose(1, 2)

  def transform_mag2(self, audio: torch.Tensor) -> torch.Tensor:
    """[B, T] -> squared magnitude [B, n_frames, cutoff] (channels-last),
    the mel front end's input."""
    spec = self._spectrum(reflect_pad(audio.float(), self.filter_length // 2))
    real = spec[..., :self.cutoff]
    imag = spec[..., self.cutoff:]
    return real * real + imag * imag

  def overlap_frames(self, magnitude: torch.Tensor,
                     phase: torch.Tensor) -> torch.Tensor:
    """(magnitude, phase) [B, n_frames, cutoff] -> the overlap-added
    [B, (n_frames - 1) * hop + filter_length] before the envelope and the
    trim: the inverse basis applied to each frame."""
    recombined = torch.cat([magnitude * torch.cos(phase),
                            magnitude * torch.sin(phase)], dim=-1)
    return overlap_add(torch.matmul(recombined, self.inverse_basis),
                       self.hop_length)

  def envelope(self, n_frames: int) -> torch.Tensor:
    """:func:`inverse_envelope` of ``n_frames`` frames on the device; the
    last ``ENV_CACHE_SIZE`` frame counts used are kept."""
    env = self._inv_env.get(n_frames)
    if env is None:
      wss = window_sumsquare_np(self.window, n_frames, self.hop_length,
                                self.win_length, self.filter_length)
      env = to_device(inverse_envelope(
          wss, float(self.filter_length) / self.hop_length), self.device)
      self._inv_env[n_frames] = env
      if len(self._inv_env) > ENV_CACHE_SIZE:
        self._inv_env.popitem(last=False)
    else:
      self._inv_env.move_to_end(n_frames)
    return env

  def inverse(self, magnitude: torch.Tensor,
              phase: torch.Tensor) -> torch.Tensor:
    """(mag, phase) [B, cutoff, n_frames] -> audio [B, T]."""
    signal = self.overlap_frames(magnitude.transpose(1, 2),
                                 phase.transpose(1, 2))
    if self.window is not None:
      signal = signal * self.envelope(magnitude.shape[-1])[None, :]
    half = self.filter_length // 2
    return signal[:, half:-half]
