"""Chunked synthesis at bounded memory, and on-device PCM conversion
(counterpart of ``waveglow_tpu/inference/streaming.py``).

Every WaveGlow op is local in time. The upsampler reads
``UPSAMPLE_KERNEL / UPSAMPLE_STRIDE`` = 4 mel frames a sample; each flow's
WN stack reaches ``(kernel_size - 1) / 2 * (2^n_layers - 1)`` audio groups
to each side (the dilation sum), and the flows compose. So a chunk of
output depends only on a bounded neighbourhood of the mel and the noise.

:func:`stream_chunks` slides a mel window of a fixed size (the chunk plus
:func:`receptive_halo_frames` on each side; edge windows shift instead of
shrink) over the utterance, runs :func:`models.waveglow.infer` on each
window and keeps the chunk's samples. Its 96 WN layers run through the
kernel on the card like any synthesis. The mel goes to the device once and
each window is a slice of it there. Each window's noise comes from
:func:`models.waveglow.block_noise` at the window's absolute groups, so
overlapping windows, and a one-call synthesis, draw the same values at the
same positions: the pieces reassemble to the one-call waveform up to the
rounding of differently shaped matrix products. Activation memory is that
of one window, whatever the utterance's length.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch

from waveglow_tpu_torch.device import resolve_device, to_device
from waveglow_tpu_torch.dsp.mel import CLIP_VAL
from waveglow_tpu_torch.kernels.wn_layer import wn_layer_fused
from waveglow_tpu_torch.models.waveglow import (UPSAMPLE_KERNEL,
                                                UPSAMPLE_STRIDE,
                                                WaveGlowConfig, block_noise,
                                                infer)
from waveglow_tpu_torch.models.wn import LayerFn

Seeds = Union[int, Sequence[int]]


def pcm16_on_device(wav: torch.Tensor) -> torch.Tensor:
  """``convert_wav(clip(wav, -1, 1), int16)`` as tensor ops: scale by the
  int16 max, round half to even, cast."""
  return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


def receptive_halo_frames(config: WaveGlowConfig) -> int:
  """Mel frames one synthesized sample can depend on, per side: the flows'
  summed WN reach in groups, in frames rounded up, plus the upsampler's
  ``kernel / stride`` frames."""
  per_flow_groups = ((config.kernel_size - 1) // 2) * (2 ** config.n_layers - 1)
  halo_groups = config.n_flows * per_flow_groups
  upsample_frames = UPSAMPLE_KERNEL // UPSAMPLE_STRIDE
  return math.ceil(halo_groups / config.groups_per_frame) + upsample_frames


def infer_chunked(params, config: WaveGlowConfig, mel, **kwargs
                  ) -> torch.Tensor:
  """:func:`stream_chunks`' pieces concatenated: mel [B, n_mels, frames] ->
  waveform [B, frames * 256], equal to ``infer(params, config, mel,
  seed=seed)`` up to the rounding of differently shaped matrix products.
  Takes :func:`stream_chunks`' keyword arguments."""
  return torch.cat([piece for _, piece in
                    stream_chunks(params, config, mel, **kwargs)], dim=1)


def stream_chunks(params, config: WaveGlowConfig, mel, *,
                  sigma: float = 1.0, seed: Seeds = 0,
                  chunk_frames: int = 256,
                  halo_frames: Optional[int] = None, compute_dtype=None,
                  pcm16: bool = False, true_frames: Optional[int] = None,
                  layer: LayerFn = wn_layer_fused,
                  device: Optional[Union[str, torch.device]] = "cuda"
                  ) -> Iterator[Tuple[int, torch.Tensor]]:
  """An iterator of ``(start_sample, piece [B, piece_samples])`` in time
  order, each piece a device tensor as soon as its window is enqueued.

  ``mel`` [B, n_mels, frames] (numpy or tensor) moves to ``device`` once.
  ``seed``: one for all rows or one a row, as :func:`models.waveglow.infer`
  takes it. A window is ``chunk_frames + 2 * halo_frames`` frames; a mel no
  longer than that runs as one window, padded up to the window with the
  silence floor and masked when shorter, so kept samples are the unpadded
  call's. ``true_frames``: the real frame count when ``mel`` carries
  bucket-pad frames; each window masks WN residual rows past it.
  ``pcm16`` converts each piece to int16 on the device. ``layer`` is the WN
  layer body, as :func:`models.waveglow.infer` takes it. Arguments are
  checked, and the mel placed, when this is called, before the first
  window.
  """
  if chunk_frames < 1:
    raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
  device = resolve_device(device)
  mel = to_device(mel, device, torch.float32)
  seeds = torch.as_tensor(seed, dtype=torch.int64).reshape(-1)
  if seeds.numel() == 1:
    seeds = seeds.expand(mel.shape[0])
  if halo_frames is None:
    halo_frames = receptive_halo_frames(config)
  window = chunk_frames + 2 * halo_frames

  def run_window(mel_w: torch.Tensor, start: int,
                 true_frames: Optional[int]) -> torch.Tensor:
    gpf = config.groups_per_frame
    noise = block_noise(seeds, config, start * gpf, window * gpf, device)
    tf_w = (None if true_frames is None
            else min(max(true_frames - start, 0), window))
    wav = infer(params, config, mel_w, sigma=sigma, noise=noise,
                compute_dtype=compute_dtype, true_frames=tf_w, layer=layer,
                device=device)
    return pcm16_on_device(wav) if pcm16 else wav

  return _windows(run_window, mel, chunk_frames, halo_frames, window,
                  true_frames)


def _windows(run_window, mel: torch.Tensor, chunk_frames: int,
             halo_frames: int, window: int, true_frames: Optional[int]
             ) -> Iterator[Tuple[int, torch.Tensor]]:
  """:func:`stream_chunks`' windows over a mel already on the device."""
  total_frames = mel.shape[-1]
  if total_frames <= window:
    if total_frames < window:
      mel = torch.nn.functional.pad(mel, (0, window - total_frames),
                                    value=math.log(CLIP_VAL))
      if true_frames is None:
        true_frames = total_frames
    wav = run_window(mel, 0, true_frames)
    yield 0, wav[:, :total_frames * UPSAMPLE_STRIDE]
    return

  for s in range(0, total_frames, chunk_frames):
    e = min(s + chunk_frames, total_frames)
    a = max(0, min(s - halo_frames, total_frames - window))
    wav = run_window(mel[..., a:a + window], a, true_frames)
    lo = (s - a) * UPSAMPLE_STRIDE
    yield s * UPSAMPLE_STRIDE, wav[:, lo:lo + (e - s) * UPSAMPLE_STRIDE]
