"""Streaming bias removal: windowed spectral subtraction over waveform
pieces (counterpart of ``waveglow_tpu/inference/stream_denoise.py``).

The one-call :class:`inference.denoiser.Denoiser` runs a whole-utterance
STFT round trip, but every stage of it is local in time: an STFT frame
reads ``filter_length`` samples, the overlap-add writes each sample from
the ``filter_length / hop`` frames that cover it, and the window-sum-square
envelope is periodic (period ``hop``) in the interior, with fixed patterns
over the first and last ``filter_length - hop`` padded positions that do
not depend on the length.

:class:`StreamingDenoiser` therefore slides a window of a fixed size over
the reflect-padded waveform. Each window goes through the one-call
denoiser's own :func:`inference.denoiser.denoise_window`, on the
denoiser's device, and only samples whose covering frames all lie inside
the window are emitted. Their frames, overlap-add order and envelope bits
are the one-call denoiser's, so the emitted blocks reassemble to
``Denoiser(wav, strength)`` up to the rounding of differently shaped
matrix products.

A block of ``block_samples`` output can be computed once ``block_end +
filter_length - hop`` raw samples exist: the denoised stream lags the raw
one by less than ``filter_length`` samples.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from waveglow_tpu_torch.dsp.stft import inverse_envelope, window_sumsquare_np
from waveglow_tpu_torch.inference.denoiser import Denoiser, denoise_window
from waveglow_tpu_torch.inference.streaming import pcm16_on_device


@functools.lru_cache(maxsize=16)
def _env_patterns(window: Optional[str], filter_length: int, hop_length: int,
                  win_length: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """(left[edge], interior[hop], right[edge]) window-sum-square patterns,
  ``edge = filter_length - hop``: the only padded positions whose envelope
  differs from the periodic interior. They are slices of a full
  :func:`window_sumsquare_np`, with each position summed in the same frame
  order, so their bits equal the one-call envelope's. The reference signal
  spans both edge zones and one clean interior period (at least
  ``filter_length / hop`` frames)."""
  ref_frames = max(16, -(-filter_length // hop_length) + 2)
  wss = window_sumsquare_np(window, ref_frames, hop_length, win_length,
                            filter_length)
  edge = filter_length - hop_length
  return (wss[:edge].copy(), wss[edge:edge + hop_length].copy(),
          wss[-edge:].copy())


class StreamingDenoiser:
  """Incremental ``Denoiser(wav, strength)`` over waveform pieces::

      sd = StreamingDenoiser(denoiser, strength)
      for start, piece in raw_stream:
        for out_start, out in sd.push(piece):
          play(out_start, out)
      for out_start, out in sd.flush():
        play(out_start, out)

  Emitted numpy blocks concatenate to the one-call denoised waveform, of
  length ``floor(T / hop) * hop`` (the iSTFT's frame-aligned trim).
  ``pcm16=True`` converts blocks to int16 on the device. Raw samples wait
  in a host buffer that keeps only what a later window can still read.
  """

  def __init__(self, denoiser: Denoiser, strength: float, *,
               block_samples: int = 16384, pcm16: bool = False):
    stft = denoiser.stft
    self.n_fft = stft.filter_length
    self.hop = stft.hop_length
    self.half = self.n_fft // 2
    self.edge = self.n_fft - self.hop  # boundary-envelope width a side
    if self.half % self.hop:
      # window starts sit at half + k * block - edge, on the one-call frame
      # grid only when the hop divides filter_length / 2
      raise ValueError(
          f"streaming denoiser requires hop ({self.hop}) to divide "
          f"filter_length/2 ({self.half}); this STFT geometry would "
          "misalign the window frame grid — denoise non-streamed instead")
    if block_samples < self.hop or block_samples % self.hop:
      raise ValueError(
          f"block_samples must be a positive multiple of hop={self.hop}, "
          f"got {block_samples}")
    self.block = block_samples
    # the emitted block plus one exactness halo a side: every frame that
    # covers an emitted sample lies inside the window
    self.window = self.block + 2 * self.edge
    self.pcm16 = pcm16
    self._stft = stft
    self._scale = float(self.n_fft) / self.hop
    self._patterns = (None if stft.window is None else
                      _env_patterns(stft.window, self.n_fft, self.hop,
                                    stft.win_length))
    # Denoiser.bias_spec is [1, cutoff, 1]; the window is channels-last
    self._bias = denoiser.bias_spec.transpose(1, 2)
    self._strength = float(strength)
    self._denoiser = denoiser  # the short-utterance one-shot fallback
    self._buf = np.zeros((0,), np.float32)
    self._buf_start = 0   # absolute raw index of _buf[0]
    self._received = 0    # raw samples pushed
    self._emitted = 0     # next output sample to emit
    self._finished = False

  def push(self, piece: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """Feed the next raw piece; return every (start_sample, block) that is
    now determined (possibly none)."""
    if self._finished:
      raise RuntimeError("push() after flush()")
    piece = np.asarray(piece, dtype=np.float32).reshape(-1)
    if piece.size:
      self._buf = np.concatenate([self._buf, piece])
      self._received += piece.size
    out: List[Tuple[int, np.ndarray]] = []
    while True:
      k = self._emitted // self.block
      a = max(0, self.half + k * self.block - self.edge)
      # the window needs raw samples up to padded position a + window
      if self._received < a + self.window - self.half:
        break
      out.append(self._run_block(k, a, total=None))
    return out

  def flush(self) -> List[Tuple[int, np.ndarray]]:
    """End of stream: emit every remaining block with the true right-edge
    reflection and envelope."""
    if self._finished:
      return []
    self._finished = True
    total = self._received
    total_out = (total // self.hop) * self.hop
    if total_out == 0:
      # nothing frame-aligned to emit (no audio, or less than a hop)
      return []
    padded_len = total_out + self.n_fft
    if padded_len < self.window:
      # shorter than one window: the one-call denoiser. The first push
      # block needs more raw samples than this, so nothing was emitted.
      if self._emitted:
        raise RuntimeError(
            f"{self._emitted} samples emitted before a flush of a stream "
            "shorter than one window")
      audio = torch.from_numpy(self._buf[None, :total]).to(
          self._stft.device)
      wav = self._denoiser(audio, self._strength)
      if self.pcm16:
        wav = pcm16_on_device(wav)
      return [(0, wav[0].cpu().numpy())]
    out: List[Tuple[int, np.ndarray]] = []
    while self._emitted < total_out:
      k = self._emitted // self.block
      a = max(0, min(self.half + k * self.block - self.edge,
                     padded_len - self.window))
      out.append(self._run_block(k, a, total=total))
    return out

  def _run_block(self, k: int, a: int, total: Optional[int]
                 ) -> Tuple[int, np.ndarray]:
    """Denoise window [a, a + W) of the padded signal; emit block k."""
    emit_start = k * self.block
    if total is None:
      emit_end = emit_start + self.block
      env_total = None
    else:
      total_out = (total // self.hop) * self.hop
      emit_end = min(emit_start + self.block, total_out)
      env_total = total_out + self.n_fft
    device = self._stft.device
    window_audio = torch.from_numpy(self._window_values(a, total)).to(device)
    inv_env = torch.from_numpy(self._inv_env(a, env_total)).to(device)
    out = denoise_window(self._stft, window_audio[None, :], self._bias,
                         self._strength, inv_env)
    if self.pcm16:
      out = pcm16_on_device(out)
    lo = emit_start + self.half - a
    piece = out[0, lo:lo + (emit_end - emit_start)].cpu().numpy()
    self._emitted = emit_end
    # drop raw samples no later window reads. A push window reaches back
    # edge + n_fft before the emit point; the flush-time last window is
    # left-clamped to padded_len - window and can reach back
    # block + 2 * edge + half - n_fft.
    reach = max(self.edge + self.n_fft,
                self.block + 2 * self.edge + self.half - self.n_fft)
    keep_from = max(0, self._emitted - reach)
    if keep_from > self._buf_start:
      self._buf = self._buf[keep_from - self._buf_start:]
      self._buf_start = keep_from
    return emit_start, piece

  def _window_values(self, a: int, total: Optional[int]) -> np.ndarray:
    """Padded-signal values at positions [a, a + W): raw samples shifted by
    ``half``, reflected at whichever signal edge the window touches."""
    lo_raw = a - self.half
    hi_raw = a + self.window - self.half
    seg_lo = max(0, lo_raw)
    seg_hi = min(self._received, hi_raw)
    if seg_lo < self._buf_start:
      raise RuntimeError(
          f"window reads raw sample {seg_lo}, but the buffer starts at "
          f"{self._buf_start}")
    if hi_raw > seg_hi and total is None:
      raise RuntimeError("window past the received samples before flush()")
    seg = self._buf[seg_lo - self._buf_start:seg_hi - self._buf_start]
    front = seg_lo - lo_raw
    back = hi_raw - seg_hi
    if front or back:
      seg = np.pad(seg, (front, back), mode="reflect")
    return seg

  def _inv_env(self, a: int, padded_len: Optional[int]) -> np.ndarray:
    """The one-call iSTFT's envelope at padded positions [a, a + W); the
    right edge zone exists only once the length is known (at flush).
    Without a window the iSTFT neither normalises nor rescales."""
    if self._patterns is None:
      return np.ones((self.window,), np.float32)
    left, interior, right = self._patterns
    p = np.arange(a, a + self.window)
    wss = interior[p % self.hop]
    in_left = p < self.edge
    if in_left.any():
      wss = np.where(in_left, left[np.minimum(p, self.edge - 1)], wss)
    if padded_len is not None:
      in_right = p >= padded_len - self.edge
      if in_right.any():
        idx = np.clip(p - (padded_len - self.edge), 0, self.edge - 1)
        wss = np.where(in_right, right[idx], wss)
    return inverse_envelope(wss, self._scale)
