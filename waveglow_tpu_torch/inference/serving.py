"""Batched synthesis on one card (counterpart of
``waveglow_tpu/inference/serving.py``).

:class:`BatchSynthesizer` synthesizes same-length batches
(:meth:`~BatchSynthesizer.infer_batch`), mels of many lengths in length
buckets (:meth:`~BatchSynthesizer.infer_many`) and one long utterance in
windows of bounded memory (:meth:`~BatchSynthesizer.infer_chunked`). The
JAX class also shards over a device mesh (data, model and time axes); the
port has no mesh yet, so :meth:`~BatchSynthesizer.infer_long`, which needs
a time axis, raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.from_jax import params_from_numpy
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.device import resolve_device
from waveglow_tpu_torch.dsp.mel import CLIP_VAL
from waveglow_tpu_torch.hparams import overwrite_custom_hparams
from waveglow_tpu_torch.inference.streaming import infer_chunked
from waveglow_tpu_torch.inference.synthesizer import row_seeds
from waveglow_tpu_torch.models.waveglow import (UPSAMPLE_STRIDE,
                                                WaveGlowConfig, infer,
                                                params_for_compute)
from waveglow_tpu_torch.ops.conv import compute_dtype_from_name


class BatchSynthesizer:
  """Batched mel->wav synthesis on one device: the card by default (raises
  without one), the CPU with ``device="cpu"``."""

  def __init__(self, checkpoint: CheckpointWaveglow, *,
               custom_hparams: Optional[Dict[str, str]] = None,
               compute_dtype: Optional[str] = None,
               device: Optional[str] = "cuda"):
    self.device = resolve_device(device)
    hparams = overwrite_custom_hparams(checkpoint.get_hparams(),
                                       custom_hparams)
    if compute_dtype is not None:
      hparams.compute_dtype = compute_dtype
    self.hparams = hparams
    self.config = WaveGlowConfig.from_hparams(hparams)
    self._cdt = compute_dtype_from_name(hparams.compute_dtype)
    self.params = params_for_compute(
        params_from_numpy(checkpoint.state_dict, self.device), self._cdt)

  @torch.inference_mode()
  def _infer(self, mels: np.ndarray, sigma: float, seeds: List[int],
             true_frames: Optional[List[int]] = None) -> np.ndarray:
    wav = infer(self.params, self.config, mels, sigma=sigma, seed=seeds,
                compute_dtype=self._cdt, true_frames=true_frames,
                device=self.device)
    return wav.cpu().numpy()

  def infer_batch(self, mels: np.ndarray, *, sigma: float = 1.0,
                  seed: int = 0) -> np.ndarray:
    """[B, n_mels, frames] -> [B, T] waveforms; row b draws its noise from
    ``row_seeds(seed, B)[b]``."""
    mels = np.asarray(mels, dtype=np.float32)
    return self._infer(mels, sigma, row_seeds(seed, mels.shape[0]))

  def infer_many(self, mels: Sequence[np.ndarray], *, sigma: float = 1.0,
                 seed: int = 0, bucket_frames: int = 64,
                 max_batch: Optional[int] = None) -> List[np.ndarray]:
    """Mels of many lengths, [n_mels, frames_i] each -> [frames_i * 256]
    each, in order.

    Mels group into length buckets (frames rounded up to a multiple of
    ``bucket_frames``), pad to their bucket with the log-clamp silence
    floor ``log(1e-5)``, and each bucket runs as batched calls of at most
    ``max_batch`` rows (None: the whole bucket). Each row masks its WN
    residual rows past its own frame count (``true_frames``), so its kept
    samples equal an unpadded call's, and each waveform is trimmed to its
    mel's length. Request i draws its noise from ``row_seeds(seed, N)[i]``
    (position-keyed, ``models.waveglow.block_noise``): every row of every
    sub-batch gets distinct noise, and a row's samples do not depend on its
    neighbours beyond the rounding of differently shaped products.
    """
    if bucket_frames < 1:
      raise ValueError("bucket_frames must be >= 1")
    if max_batch is not None and max_batch < 1:
      raise ValueError(f"max_batch must be >= 1 or None, got {max_batch}")
    floor = float(np.log(CLIP_VAL))
    seeds = row_seeds(seed, len(mels))

    buckets: Dict[int, List[int]] = {}
    frames = []
    for i, mel in enumerate(mels):
      f = int(np.shape(mel)[-1])
      if f < 1:
        raise ValueError(f"mel {i} has no frames")
      frames.append(f)
      buckets.setdefault(-(-f // bucket_frames) * bucket_frames, []).append(i)

    out: List[Optional[np.ndarray]] = [None] * len(frames)
    for padded_f in sorted(buckets):
      idxs = buckets[padded_f]
      step = max_batch if max_batch is not None else len(idxs)
      for s in range(0, len(idxs), step):
        group = idxs[s:s + step]
        batch = np.full((len(group), np.shape(mels[group[0]])[0], padded_f),
                        floor, dtype=np.float32)
        for row, i in enumerate(group):
          batch[row, :, :frames[i]] = mels[i]
        wav = self._infer(batch, sigma, [seeds[i] for i in group],
                          [frames[i] for i in group])
        for row, i in enumerate(group):
          out[i] = wav[row, :frames[i] * UPSAMPLE_STRIDE]
    return out  # type: ignore[return-value]

  @torch.inference_mode()
  def infer_chunked(self, mel: np.ndarray, *, sigma: float = 1.0,
                    seed: int = 0, chunk_frames: int = 1024) -> np.ndarray:
    """One utterance [n_mels, frames] -> [T] at constant activation memory:
    mel windows with receptive-field halos slide over it
    (``inference.streaming``), equal to one-call synthesis up to the
    rounding of differently shaped products."""
    mel = np.asarray(mel, dtype=np.float32)[None]
    wav = infer_chunked(self.params, self.config, mel, sigma=sigma, seed=seed,
                        chunk_frames=chunk_frames, compute_dtype=self._cdt,
                        device=self.device)
    return wav[0].cpu().numpy()

  def infer_long(self, mel: np.ndarray, *, sigma: float = 1.0,
                 seed: int = 0) -> np.ndarray:
    """One long utterance, time-sharded over a mesh's ``time`` axis. The
    port has no device mesh yet, so this raises."""
    raise ValueError(
        "infer_long requires a mesh with a 'time' axis "
        "(make_time_mesh); use infer_chunked for single-chip "
        "constant-memory synthesis")
