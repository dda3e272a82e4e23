"""Batched synthesis on one card or over a device mesh (counterpart of
``waveglow_tpu/inference/serving.py``).

:class:`BatchSynthesizer` synthesizes same-length batches
(:meth:`~BatchSynthesizer.infer_batch`), mels of many lengths in length
buckets (:meth:`~BatchSynthesizer.infer_many`), one long utterance in
windows of bounded memory (:meth:`~BatchSynthesizer.infer_chunked`) and one
long utterance time-sharded over a mesh's ``time`` axis
(:meth:`~BatchSynthesizer.infer_long`). With ``mesh=``
(``parallel.mesh.make_mesh`` / ``make_time_mesh``) a ``data`` axis splits
batch rows over the devices, a ``model`` axis cuts the WN hidden channels
over them (``parallel.sharding``) and a ``time`` axis splits each
utterance's frames (``parallel.time_shard``); the placement rules are
``parallel.placement``'s.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.dsp.mel import CLIP_VAL
from waveglow_tpu_torch.hparams import overwrite_custom_hparams
from waveglow_tpu_torch.inference.streaming import infer_chunked
from waveglow_tpu_torch.inference.synthesizer import row_seeds
from waveglow_tpu_torch.models.waveglow import (UPSAMPLE_STRIDE,
                                                WaveGlowConfig,
                                                fuse_for_inference)
from waveglow_tpu_torch.ops.conv import compute_dtype_from_name
from waveglow_tpu_torch.parallel.mesh import TIME_AXIS, Mesh
from waveglow_tpu_torch.parallel.placement import Placement


class BatchSynthesizer:
  """Batched mel->wav synthesis on one device, the card by default (raises
  without one; the CPU with ``device="cpu"``), or over ``mesh``. Giving
  both ``device`` and ``mesh`` raises unless the device is the mesh's
  first."""

  def __init__(self, checkpoint: CheckpointWaveglow, *,
               custom_hparams: Optional[Dict[str, str]] = None,
               compute_dtype: Optional[str] = None,
               device: Optional[str] = None, mesh: Optional[Mesh] = None):
    self._place = Placement(mesh, device)
    self.device = self._place.device
    self.mesh = mesh
    hparams = overwrite_custom_hparams(checkpoint.get_hparams(),
                                       custom_hparams)
    if compute_dtype is not None:
      hparams.compute_dtype = compute_dtype
    self.hparams = hparams
    self.config = WaveGlowConfig.from_hparams(hparams)
    self._cdt = compute_dtype_from_name(hparams.compute_dtype)
    self._place.put(fuse_for_inference(checkpoint.state_dict), self._cdt)
    # the first group's params: a tree, or a tensor-parallel list of trees
    self.params = self._place.groups[0]

  @torch.inference_mode()
  def _infer(self, mels: np.ndarray, sigma: float, seeds: List[int],
             true_frames: Optional[List[int]] = None) -> np.ndarray:
    groups = self._place.synthesize(self.config, mels, sigma=sigma,
                                    seeds=seeds, compute_dtype=self._cdt,
                                    true_frames=true_frames)
    return np.concatenate([wav.cpu().numpy() for _, wav in groups], axis=0)

  def infer_batch(self, mels: np.ndarray, *, sigma: float = 1.0,
                  seed: int = 0) -> np.ndarray:
    """[B, n_mels, frames] -> [B, T] waveforms; row b draws its noise from
    ``row_seeds(seed, B)[b]``. With a data mesh, B must be a multiple of
    the data axis: each device synthesizes its slice of the rows."""
    mels = np.asarray(mels, dtype=np.float32)
    data = self._place.data
    if mels.shape[0] % data:
      raise ValueError(f"a batch of {mels.shape[0]} rows does not split "
                       f"over the {data} devices of the data axis")
    return self._infer(mels, sigma, row_seeds(seed, mels.shape[0]))

  def infer_many(self, mels: Sequence[np.ndarray], *, sigma: float = 1.0,
                 seed: int = 0, bucket_frames: int = 64,
                 max_batch: Optional[int] = None) -> List[np.ndarray]:
    """Mels of many lengths, [n_mels, frames_i] each -> [frames_i * 256]
    each, in order.

    Mels group into length buckets (frames rounded up to a multiple of
    ``bucket_frames``), pad to their bucket with the log-clamp silence
    floor ``log(1e-5)``, and each bucket runs as batched calls of at most
    ``max_batch`` rows (None: the whole bucket). With a data mesh each
    batch is padded to a multiple of the data axis by repeating its last
    row, and the repeats are dropped. Each row masks its WN
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
        rows = group + [group[-1]] * ((-len(group)) % self._place.data)
        batch = np.full((len(rows), np.shape(mels[group[0]])[0], padded_f),
                        floor, dtype=np.float32)
        for row, i in enumerate(rows):
          batch[row, :, :frames[i]] = mels[i]
        wav = self._infer(batch, sigma, [seeds[i] for i in rows],
                          [frames[i] for i in rows])
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
    """One long utterance [n_mels, frames] -> [T], time-sharded over the
    mesh's ``time`` axis (``parallel.time_shard``): bit for bit
    ``infer_batch(mel[None], seed=seed)[0]`` on one device, for any frame
    count. Raises without a time axis."""
    if self.mesh is None or TIME_AXIS not in self.mesh.axis_names:
      # callers reach for infer_long because one device cannot hold the
      # utterance; an unsharded fallback would run out of memory
      raise ValueError(
          "infer_long requires a mesh with a 'time' axis "
          "(make_time_mesh); use infer_chunked for single-chip "
          "constant-memory synthesis")
    mel = np.asarray(mel, dtype=np.float32)[None]
    return self._infer(mel, sigma, row_seeds(seed, 1))[0]
