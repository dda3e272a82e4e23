"""The Synthesizer: checkpoint -> mel->waveform runtime on the card
(counterpart of ``waveglow_tpu/inference/synthesizer.py``).

Construction loads the model from a checkpoint (with hparam overrides),
folds weight-norm, moves the weights onto the device once (the matrices in
the compute dtype) and captures the denoiser bias. ``infer`` returns raw and denoised waveforms with per-phase
durations; ``infer_serving`` runs synthesis, denoise, PCM16 and the masked
overamp max as one dispatch and fetches one buffer; ``infer_serving_many``
micro-batches requests with per-row seeds, sigmas, strengths and true
lengths. Every WN layer runs through the fused CUDA kernel on the card.

``compute_dtype='bfloat16'`` selects the fast path; the default float32 is
the parity mode (no TF32). The denoiser stays float32 in both.
"""

from __future__ import annotations

import datetime
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.from_jax import params_from_numpy
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.device import resolve_device
from waveglow_tpu_torch.dsp.mel import CLIP_VAL
from waveglow_tpu_torch.hparams import overwrite_custom_hparams
from waveglow_tpu_torch.inference.denoiser import Denoiser
from waveglow_tpu_torch.inference.streaming import pcm16_on_device
from waveglow_tpu_torch.models.waveglow import (UPSAMPLE_STRIDE,
                                                WaveGlowConfig,
                                                fuse_for_inference, infer,
                                                params_for_compute)

logger = logging.getLogger(__name__)


@dataclass
class InferenceResult:
  wav: np.ndarray
  wav_denoised: np.ndarray
  sampling_rate: int
  inference_duration_s: float
  denoising_duration_s: float
  was_overamplified: bool
  timepoint: datetime.datetime


@dataclass
class ServingResult:
  """Result of the single-fetch serving path: the denoised waveform only,
  float32 in [-1, 1] or int16 PCM (``pcm16=True``), converted on the
  device; overamplification is judged from an on-device max(|wav|)."""
  samples: np.ndarray
  sampling_rate: int
  duration_s: float
  was_overamplified: bool
  timepoint: datetime.datetime


def _per_request(value, n: int, name: str) -> np.ndarray:
  """Broadcast a scalar (or validate a length-n sequence) to float32 [n]."""
  arr = np.asarray(value, dtype=np.float32)
  if arr.ndim == 0:
    return np.full((n,), float(arr), dtype=np.float32)
  if arr.shape != (n,):
    raise ValueError(
        f"{name}: expected a scalar or {n} per-request values, got shape "
        f"{tuple(arr.shape)}")
  return arr


def _leaf_shapes(tree, prefix: str = "") -> Dict[str, tuple]:
  """'/'-joined leaf paths of a params tree -> leaf shapes."""
  if isinstance(tree, dict):
    items = tree.items()
  elif isinstance(tree, (list, tuple)):
    items = enumerate(tree)
  else:
    return {prefix: tuple(tree.shape)}
  out: Dict[str, tuple] = {}
  for k, v in items:
    out.update(_leaf_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
  return out


class Synthesizer:

  def __init__(self, checkpoint: CheckpointWaveglow, *,
               custom_hparams: Optional[Dict[str, str]] = None,
               compute_dtype: Optional[str] = None,
               device: Optional[str] = "cuda"):
    """``device``: ``"cuda"`` (the default, also for None) raises without a
    card; pass ``"cpu"`` to run the plain PyTorch path on the CPU."""
    self.device = resolve_device(device)
    hparams = overwrite_custom_hparams(checkpoint.get_hparams(),
                                       custom_hparams)
    if compute_dtype is not None:
      hparams.compute_dtype = compute_dtype
    if hparams.compute_dtype not in ("float32", "bfloat16"):
      raise ValueError(f"unsupported compute_dtype {hparams.compute_dtype!r}")
    self.hparams = hparams
    self.config = WaveGlowConfig.from_hparams(hparams)
    self._cdt = (torch.bfloat16 if hparams.compute_dtype == "bfloat16"
                 else None)
    params = params_from_numpy(checkpoint.state_dict, self.device)
    self.denoiser = Denoiser(params, self.config, hparams, self.device)
    self.params = params_for_compute(params, self._cdt)
    self.iteration = checkpoint.iteration

  def _sync(self) -> None:
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)

  def update_params(self, checkpoint: CheckpointWaveglow, *,
                    custom_hparams: Optional[Dict[str, str]] = None) -> int:
    """Swap in the weights of a same-architecture checkpoint (and recapture
    the denoiser bias). A different architecture, or a different audio/STFT
    contract, is rejected. Returns the new checkpoint's iteration."""
    hparams = overwrite_custom_hparams(checkpoint.get_hparams(),
                                       custom_hparams)
    new_config = WaveGlowConfig.from_hparams(hparams)
    if new_config != self.config:
      raise ValueError(
          f"checkpoint architecture {new_config} does not match the "
          f"serving model {self.config}; hot-swap is weights-only — "
          "restart to change architecture")
    audio_fields = ("sampling_rate", "filter_length", "hop_length",
                    "win_length", "window", "mel_fmin", "mel_fmax")
    mismatched = {f: (getattr(self.hparams, f), getattr(hparams, f))
                  for f in audio_fields
                  if getattr(hparams, f) != getattr(self.hparams, f)}
    if mismatched:
      raise ValueError(
          "checkpoint audio/STFT hparams do not match the serving model "
          f"(serving vs checkpoint): {mismatched}; hot-swap is "
          "weights-only — restart to change the audio pipeline")
    old_shapes = _leaf_shapes(self.params)
    new_shapes = _leaf_shapes(fuse_for_inference(checkpoint.state_dict))
    if new_shapes != old_shapes:
      bad = sorted(k for k in old_shapes.keys() | new_shapes.keys()
                   if old_shapes.get(k) != new_shapes.get(k))
      raise ValueError(f"params differ from the serving model at {bad}")
    new_params = params_from_numpy(checkpoint.state_dict, self.device)
    self.denoiser = Denoiser(new_params, self.config, self.hparams,
                             self.device)
    self.params = params_for_compute(new_params, self._cdt)
    self.iteration = checkpoint.iteration
    logger.info("Swapped weights to iteration %s", checkpoint.iteration)
    return checkpoint.iteration

  def _prepare_mel(self, mel, bucket_frames: Optional[int]):
    """Validate to [1, n_mels, frames]; bucket-pad with the log-clamp
    silence floor. Returns (numpy mel, true sample count)."""
    mel = np.asarray(mel, dtype=np.float32)
    if mel.ndim == 2:
      mel = mel[None]
    if mel.ndim != 3 or mel.shape[0] != 1 or (
        mel.shape[1] != self.config.n_mel_channels):
      raise ValueError(
          f"expected mel of shape [{self.config.n_mel_channels}, frames] "
          f"(or [1, {self.config.n_mel_channels}, frames]), got "
          f"{tuple(np.shape(mel))}")
    frames = mel.shape[-1]
    true_samples = frames * UPSAMPLE_STRIDE
    if bucket_frames is not None and bucket_frames > 0:
      padded = -(-frames // bucket_frames) * bucket_frames
      if padded != frames:
        mel = np.pad(mel, ((0, 0), (0, 0), (0, padded - frames)),
                     constant_values=float(np.log(CLIP_VAL)))
    return mel, true_samples

  def _to_device(self, mel: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(mel)).to(self.device)

  @torch.inference_mode()
  def infer(self, mel: np.ndarray, *, sigma: float = 1.0,
            denoiser_strength: float = 0.0005, seed: int = 0,
            noise: Optional[Sequence[np.ndarray]] = None,
            bucket_frames: Optional[int] = None) -> InferenceResult:
    """mel [n_mels, frames] (or [1, n_mels, frames]) -> InferenceResult.

    ``noise``: injected standard-normal tensors in the draw order of
    ``models.waveglow.infer_noise_shapes`` (parity harnesses); otherwise
    noise is drawn from ``seed``. ``bucket_frames`` pads the mel's frame
    count up to a multiple of it with the silence floor (ignored with
    injected noise) and trims the waveform back; kept samples equal the
    unpadded call's (position-keyed noise, masked WN residual rows).
    """
    timepoint = datetime.datetime.now()
    mel, true_samples = self._prepare_mel(
        mel, bucket_frames if noise is None else None)
    mel_t = self._to_device(mel)
    true_frames = None if noise is not None else true_samples // UPSAMPLE_STRIDE
    start = time.perf_counter()
    wav = infer(self.params, self.config, mel_t, sigma=sigma, noise=noise,
                seed=seed, compute_dtype=self._cdt, true_frames=true_frames,
                device=self.device)
    self._sync()
    inference_duration_s = time.perf_counter() - start

    denoising_duration_s = 0.0
    wav_denoised = wav
    if denoiser_strength > 0:
      start_dn = time.perf_counter()
      wav_denoised = self.denoiser(wav, denoiser_strength)
      self._sync()
      denoising_duration_s = time.perf_counter() - start_dn

    wav_np = wav[..., :true_samples].cpu().numpy().squeeze()
    wav_denoised_np = wav_denoised[..., :true_samples].cpu().numpy().squeeze()
    was_overamplified = bool(np.abs(wav_np).max() > 1.0)
    return InferenceResult(
        wav=wav_np, wav_denoised=wav_denoised_np,
        sampling_rate=self.hparams.sampling_rate,
        inference_duration_s=inference_duration_s,
        denoising_duration_s=denoising_duration_s,
        was_overamplified=was_overamplified, timepoint=timepoint)

  @torch.inference_mode()
  def _serve_rows(self, mel: np.ndarray, sigmas: np.ndarray,
                  seeds: Sequence[int], strengths: Optional[np.ndarray],
                  true_ns: np.ndarray, pcm16: bool):
    """Enqueue one fused serving batch: synthesis (per-row sigma, seed and
    true length), masked max|wav| per row, optional per-row-strength
    denoise, optional PCM16. Returns device tensors (samples, max_abs)."""
    true_t = torch.as_tensor(true_ns, dtype=torch.int64, device=self.device)
    wav = infer(self.params, self.config, self._to_device(mel),
                sigma=torch.as_tensor(sigmas, device=self.device),
                seed=list(seeds), compute_dtype=self._cdt,
                true_frames=true_t // UPSAMPLE_STRIDE, device=self.device)
    n = wav.shape[-1]
    mask = torch.arange(n, device=self.device)[None, :] < true_t[:, None]
    max_abs = torch.amax(wav.abs() * mask, dim=-1)
    out = wav
    if strengths is not None:
      strength = torch.as_tensor(strengths, device=self.device)
      dn = self.denoiser(wav, strength.reshape(-1, 1, 1))
      if dn.shape[-1] < n:  # the iSTFT is frame-aligned: restore the length
        dn = torch.nn.functional.pad(dn, (0, n - dn.shape[-1]))
      out = dn[..., :n]
    if pcm16:
      out = pcm16_on_device(out)
    return out, max_abs

  def infer_serving(self, mel: np.ndarray, *, sigma: float = 1.0,
                    denoiser_strength: float = 0.0005, seed: int = 0,
                    bucket_frames: Optional[int] = 64,
                    pcm16: bool = False) -> ServingResult:
    """Latency-lean mel -> denoised waveform: one dispatch, one fetch.
    ``samples`` equals :meth:`infer`'s ``wav_denoised`` (same bucketing);
    int16 mode applies ``round(clip(wav) * 32767)`` on the device."""
    return self.serving_finalize(self.serving_dispatch(
        mel, sigma=sigma, denoiser_strength=denoiser_strength, seed=seed,
        bucket_frames=bucket_frames, pcm16=pcm16))

  def serving_dispatch(self, mel: np.ndarray, *, sigma: float = 1.0,
                       denoiser_strength: float = 0.0005, seed: int = 0,
                       bucket_frames: Optional[int] = 64,
                       pcm16: bool = False):
    """Enqueue one :meth:`infer_serving` request on the device; fetch
    nothing. Returns a record for :meth:`serving_finalize`."""
    timepoint = datetime.datetime.now()
    mel, true_samples = self._prepare_mel(mel, bucket_frames)
    start = time.perf_counter()
    strengths = (np.float32([denoiser_strength]) if denoiser_strength > 0
                 else None)
    samples, max_abs = self._serve_rows(
        mel, np.float32([sigma]), [seed], strengths,
        np.int64([true_samples]), pcm16)
    return samples, max_abs, true_samples, start, timepoint

  def serving_finalize(self, dispatched) -> ServingResult:
    """Fetch a :meth:`serving_dispatch` record into a ServingResult."""
    samples_dev, max_abs_dev, true_samples, start, timepoint = dispatched
    samples = samples_dev[0, :true_samples].cpu().numpy()
    was_overamplified = bool(max_abs_dev.cpu().numpy()[0] > 1.0)
    return ServingResult(
        samples=samples, sampling_rate=self.hparams.sampling_rate,
        duration_s=time.perf_counter() - start,
        was_overamplified=was_overamplified, timepoint=timepoint)

  def infer_serving_many(self, mels: Sequence[np.ndarray], *, sigma=1.0,
                         denoiser_strength=0.0005,
                         seeds: Optional[Sequence[int]] = None,
                         bucket_frames: Optional[int] = 64,
                         pcm16: bool = False,
                         max_batch: int = 8) -> List[ServingResult]:
    """Micro-batched :meth:`infer_serving`: N requests, few dispatches.

    ``sigma`` and ``denoiser_strength`` take a scalar or one value per
    request. Requests group by padded length (and by whether they denoise),
    and each group splits into power-of-two sub-batches, largest first (5
    requests run as 4 + 1), so no batch row is padding. Row i draws its
    noise from ``seeds[i]`` alone, so its result does not depend on its
    neighbours and matches ``infer_serving(mels[i], seed=seeds[i])`` up to
    the rounding of differently shaped matrix products.
    """
    return self.serving_many_finalize(self.serving_many_dispatch(
        mels, sigma=sigma, denoiser_strength=denoiser_strength, seeds=seeds,
        bucket_frames=bucket_frames, pcm16=pcm16, max_batch=max_batch))

  def serving_many_dispatch(self, mels: Sequence[np.ndarray], *, sigma=1.0,
                            denoiser_strength=0.0005,
                            seeds: Optional[Sequence[int]] = None,
                            bucket_frames: Optional[int] = 64,
                            pcm16: bool = False, max_batch: int = 8):
    """Enqueue the micro-batches on the device; fetch nothing."""
    timepoint = datetime.datetime.now()
    n = len(mels)
    seeds = [0] * n if seeds is None else list(seeds)
    if len(seeds) != n:
      raise ValueError(f"{n} mels but {len(seeds)} seeds")
    if max_batch < 1:
      raise ValueError("max_batch must be >= 1")
    sigmas = _per_request(sigma, n, "sigma")
    strengths = _per_request(denoiser_strength, n, "denoiser_strength")
    prepared = [self._prepare_mel(m, bucket_frames) for m in mels]

    groups: Dict[tuple, List[int]] = {}
    for i, (mel, _) in enumerate(prepared):
      groups.setdefault((mel.shape[-1], bool(strengths[i] > 0)), []).append(i)

    start = time.perf_counter()
    pending = []
    for padded_f, denoise in sorted(groups):
      idxs = groups[(padded_f, denoise)]
      pos = 0
      while pos < len(idxs):
        b = 1
        while b * 2 <= min(len(idxs) - pos, max_batch):
          b *= 2
        rows = idxs[pos:pos + b]
        pos += b
        mel_batch = np.concatenate([prepared[i][0] for i in rows], axis=0)
        samples, max_abs = self._serve_rows(
            mel_batch, sigmas[rows], [seeds[i] for i in rows],
            strengths[rows] if denoise else None,
            np.asarray([prepared[i][1] for i in rows], dtype=np.int64),
            pcm16)
        pending.append((rows, samples, max_abs))
    return pending, prepared, n, start, timepoint

  def serving_many_finalize(self, dispatched) -> List[ServingResult]:
    """Fetch a :meth:`serving_many_dispatch` record into ServingResults."""
    pending, prepared, n, start, timepoint = dispatched
    out: List[Optional[ServingResult]] = [None] * n
    for rows, samples_dev, max_abs_dev in pending:
      samples = samples_dev.cpu().numpy()
      max_abs = max_abs_dev.cpu().numpy()
      duration_s = time.perf_counter() - start
      for row, i in enumerate(rows):
        out[i] = ServingResult(
            samples=samples[row, :prepared[i][1]],
            sampling_rate=self.hparams.sampling_rate,
            duration_s=duration_s,
            was_overamplified=bool(max_abs[row] > 1.0),
            timepoint=timepoint)
    return out  # type: ignore[return-value]
