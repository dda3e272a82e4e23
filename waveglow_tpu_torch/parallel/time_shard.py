"""Time-sharded synthesis of one batch of utterances over a ``time`` mesh
(counterpart of the ``time`` axis of ``waveglow_tpu/inference/serving.py::
infer_long``).

The F mel frames split into ``time`` contiguous spans, as even as possible
(the first ``F % time`` spans one frame longer; with F < time the last
devices get none and are skipped). Each device synthesizes its span plus
:func:`inference.streaming.receptive_halo_frames` of mel on each side
(clipped at the utterance's ends), with the position-keyed noise of its
window, and keeps the span's samples. Every WaveGlow op is local in time
and the halo covers the flows' summed reach, so the stitched waveform is
the unsharded call's: no collective is needed, where the JAX package
exchanges conv halos layer by layer through GSPMD. The work of every
device is enqueued before anything is waited for; the spans are stitched
on the first device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from waveglow_tpu_torch.device import to_device
from waveglow_tpu_torch.inference.streaming import receptive_halo_frames
from waveglow_tpu_torch.models.waveglow import (UPSAMPLE_STRIDE,
                                                WaveGlowConfig, block_noise,
                                                infer, params_device)


def time_spans(frames: int, n: int) -> List[Tuple[int, int]]:
  """``n`` contiguous ``(start, end)`` frame spans covering ``frames``,
  their lengths differing by at most one (longer first); spans past the
  end are empty (``start == end``)."""
  if frames < 1 or n < 1:
    raise ValueError(f"need frames >= 1 and n >= 1, got {frames}, {n}")
  base, extra = divmod(frames, n)
  spans, start = [], 0
  for k in range(n):
    end = start + base + (k < extra)
    spans.append((start, end))
    start = end
  return spans


def span_windows(frames: int, n: int, halo: int
                 ) -> List[Tuple[int, int, int, int]]:
  """``(start, end, lo, hi)`` of each non-empty span of :func:`time_spans`:
  the span's frames and the mel window ``[lo, hi)`` that synthesizes them,
  the span with ``halo`` frames a side clipped to ``[0, frames)``."""
  return [(s, e, max(0, s - halo), min(frames, e + halo))
          for s, e in time_spans(frames, n) if e > s]


def infer_time_sharded(params_by_device: Sequence, config: WaveGlowConfig,
                       mel, *, sigma: Union[float, np.ndarray,
                                            torch.Tensor] = 1.0,
                       seed: Union[int, Sequence[int]] = 0,
                       compute_dtype=None, true_frames=None,
                       noise: Optional[Sequence] = None) -> torch.Tensor:
  """mel [B, n_mels, F] -> waveform [B, F * 256] on the first device, equal
  bit for bit to ``models.waveglow.infer(params, config, mel, seed=seed,
  ...)`` on one device.

  ``params_by_device``: one params tree per ``time`` device, each on its
  device (``parallel.sharding.shard_params`` of a time mesh, rank 0), in
  mesh order. ``seed``: one for every row or one a row; ``sigma`` a float
  or one a row; ``true_frames`` (None, an int or one a row) masks WN
  residual rows past each row's real frames, as ``infer`` does.
  ``noise``: injected noise in ``infer``'s order ([B, F * 32, ch] each),
  cut to each window, in place of the seeds' noise."""
  mel_frames = int(mel.shape[-1])
  batch = int(mel.shape[0])
  halo = receptive_halo_frames(config)
  seeds = torch.as_tensor(seed, dtype=torch.int64).reshape(-1)
  if seeds.numel() == 1:
    seeds = seeds.expand(batch)
  if true_frames is not None:
    true_frames = torch.as_tensor(true_frames, dtype=torch.int64).reshape(-1)
  gpf = config.groups_per_frame
  pieces = []
  windows = span_windows(mel_frames, len(params_by_device), halo)
  for k, (start, end, lo, hi) in enumerate(windows):
    params = params_by_device[k]
    device = params_device(params)
    if noise is None:
      noise_w = block_noise(seeds, config, lo * gpf, (hi - lo) * gpf, device)
    else:
      noise_w = [n[:, lo * gpf:hi * gpf] for n in noise]
    tf_w = (None if true_frames is None
            else torch.clamp(true_frames - lo, 0, hi - lo).expand(batch))
    sig = (sigma if isinstance(sigma, (int, float))
           else to_device(sigma, device, torch.float32))
    wav = infer(params, config, to_device(mel[..., lo:hi], device,
                                          torch.float32),
                sigma=sig, noise=noise_w, compute_dtype=compute_dtype,
                true_frames=tf_w, device=device)
    pieces.append(wav[:, (start - lo) * UPSAMPLE_STRIDE:
                      (end - lo) * UPSAMPLE_STRIDE])
  first = params_device(params_by_device[0])
  return torch.cat([p.to(first) for p in pieces], dim=1)
