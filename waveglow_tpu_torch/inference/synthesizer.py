"""The Synthesizer: checkpoint -> mel->waveform runtime on the card
(counterpart of ``waveglow_tpu/inference/synthesizer.py``).

Construction loads the model from a checkpoint (with hparam overrides),
folds weight-norm, moves the weights onto the device once (the matrices in
the compute dtype) and captures the denoiser bias. ``infer`` returns raw and
denoised waveforms with per-phase durations, in one call or in fixed mel
windows (``chunk_frames``); ``stream`` yields the waveform, raw or
denoised, piece by piece as its windows finish; ``infer_serving`` runs
synthesis, denoise, PCM16 and the masked overamp max as one dispatch and
fetches one buffer; ``infer_serving_many`` micro-batches requests with
per-row seeds, sigmas, strengths and true lengths. Every WN layer runs
through the fused CUDA kernel on the card.

``mesh=`` (``parallel.mesh``) serves over several devices with the JAX
synthesizer's placement rules (``parallel.placement``): a ``data`` axis
splits a batch's rows when they divide evenly (else the batch runs on the
first device), a ``model`` axis cuts every WN layer's hidden channels over
the ranks (the shard kernel), and a ``time`` axis splits every synthesis
over the devices in frame spans, stitched bit for bit. The denoiser,
PCM16 and the overamp max run on the device that holds each row group
(after the stitch on a time mesh); ``stream`` and chunked ``infer`` run on
the first group (through the ranks on a model mesh).

``compute_dtype='bfloat16'`` selects the fast path; the default float32 is
the parity mode (no TF32). The denoiser stays float32 in both.
"""

from __future__ import annotations

import datetime
import logging
import time
from dataclasses import dataclass
from typing import (Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.device import to_device
from waveglow_tpu_torch.dsp.mel import CLIP_VAL
from waveglow_tpu_torch.hparams import overwrite_custom_hparams
from waveglow_tpu_torch.inference.denoiser import Denoiser
from waveglow_tpu_torch.inference.stream_denoise import StreamingDenoiser
from waveglow_tpu_torch.inference.streaming import (infer_chunked,
                                                    pcm16_on_device,
                                                    stream_chunks)
from waveglow_tpu_torch.models.waveglow import (UPSAMPLE_STRIDE,
                                                WaveGlowConfig,
                                                fuse_for_inference)
from waveglow_tpu_torch.ops.conv import compute_dtype_from_name
from waveglow_tpu_torch.parallel.mesh import Mesh
from waveglow_tpu_torch.parallel.placement import Placement

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


class ServingDispatch(NamedTuple):
  """Serving work enqueued on the device: per dispatched batch (per row
  group of a batch on a data mesh), the request indices of its rows and
  host buffers of its samples and per-row max|wav|, filled by copies
  enqueued with it; ``event`` follows those copies (None on the CPU, where
  the buffers are ready)."""
  batches: List[Tuple[List[int], np.ndarray, np.ndarray]]
  true_samples: List[int]
  start: float
  timepoint: datetime.datetime
  event: Optional["torch.cuda.Event"]


class DeviceEvents:
  """Events recorded on several devices, waited for and queried as one."""

  def __init__(self, events: Sequence["torch.cuda.Event"]):
    self.events = list(events)

  def synchronize(self) -> None:
    for event in self.events:
      event.synchronize()

  def query(self) -> bool:
    return all(event.query() for event in self.events)


def enqueue_fetch(tensors: Sequence[torch.Tensor]
                  ) -> Tuple[List[np.ndarray], Optional["torch.cuda.Event"]]:
  """Device-to-host copies of ``tensors``, enqueued now behind the work that
  makes them, into pinned host buffers (``non_blocking``), and an event
  recorded after them on each device that holds one of them (one
  ``torch.cuda.Event``, or a :class:`DeviceEvents` over several devices).
  Waiting on the event waits for that work alone; a blocking ``.cpu()``
  made later is enqueued, and waits, behind whatever other threads
  enqueued in between. Read the arrays only after ``event.synchronize()``.
  CPU tensors are their own host arrays (event None)."""
  if not tensors or tensors[0].device.type != "cuda":
    return [t.numpy() for t in tensors], None
  host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
          for t in tensors]
  for dst, src in zip(host, tensors):
    dst.copy_(src, non_blocking=True)
  events = []
  for index in dict.fromkeys(t.device.index for t in tensors):
    with torch.cuda.device(index):
      events.append(torch.cuda.Event())
      events[-1].record()
  return ([h.numpy() for h in host],
          events[0] if len(events) == 1 else DeviceEvents(events))


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


def row_seeds(seed: int, batch: int) -> List[int]:
  """Noise seeds of a batch of ``batch`` utterances given one ``seed``: row
  b gets ``seed + b * 2**32`` (b in the seed's high 32 bits), so row 0 is
  the solo call's seed and every row draws distinct noise."""
  return [int(seed) + (b << 32) for b in range(batch)]


class Synthesizer:

  def __init__(self, checkpoint: CheckpointWaveglow, *,
               custom_hparams: Optional[Dict[str, str]] = None,
               compute_dtype: Optional[str] = None,
               device: Optional[str] = None, mesh: Optional[Mesh] = None):
    """``device``: ``"cuda"`` (the default, also for None) raises without a
    card; pass ``"cpu"`` to run the plain PyTorch path on the CPU.
    ``mesh``: serve over its devices (module docstring); ``device``, when
    also given, must be the mesh's first device."""
    self._place = Placement(mesh, device)
    self.device = self._place.device
    self.mesh = mesh
    hparams = overwrite_custom_hparams(checkpoint.get_hparams(),
                                       custom_hparams)
    if compute_dtype is not None:
      hparams.compute_dtype = compute_dtype
    self._cdt = compute_dtype_from_name(hparams.compute_dtype)
    self.hparams = hparams
    self.config = WaveGlowConfig.from_hparams(hparams)
    self._put(checkpoint)
    self.iteration = checkpoint.iteration

  def _put(self, checkpoint: CheckpointWaveglow) -> None:
    """Place the checkpoint's weights (sharded on a mesh) and capture the
    denoiser bias through the first group, copied to every group's
    device."""
    fused = fuse_for_inference(checkpoint.state_dict)
    self._shapes = _leaf_shapes(fused)
    f32 = self._place.put(fused, self._cdt)
    self.denoiser = Denoiser(f32[0], self.config, self.hparams, self.device)
    self._denoisers = {str(d): self.denoiser.to(d)
                       for d in self._place.devices}
    # the first group's params: a tree, or a tensor-parallel list of trees
    self.params = self._place.groups[0]

  def _sync(self) -> None:
    for device in self._place.all_devices():
      if device.type == "cuda":
        torch.cuda.synchronize(device)

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
    old_shapes = self._shapes
    new_shapes = _leaf_shapes(fuse_for_inference(checkpoint.state_dict))
    if new_shapes != old_shapes:
      bad = sorted(k for k in old_shapes.keys() | new_shapes.keys()
                   if old_shapes.get(k) != new_shapes.get(k))
      raise ValueError(f"params differ from the serving model at {bad}")
    self._put(checkpoint)  # re-shards on a mesh
    self.iteration = checkpoint.iteration
    logger.info("Swapped weights to iteration %s", checkpoint.iteration)
    return checkpoint.iteration

  def _prepare_mel(self, mel, bucket_frames: Optional[int]):
    """Validate to [B, n_mels, frames]; bucket-pad with the log-clamp
    silence floor. Returns (numpy mel, true sample count)."""
    mel = np.asarray(mel, dtype=np.float32)
    if mel.ndim == 2:
      mel = mel[None]
    if mel.ndim != 3 or mel.shape[1] != self.config.n_mel_channels:
      raise ValueError(
          f"expected mel of shape [{self.config.n_mel_channels}, frames] "
          f"(or [B, {self.config.n_mel_channels}, frames]), got "
          f"{tuple(np.shape(mel))}")
    frames = mel.shape[-1]
    true_samples = frames * UPSAMPLE_STRIDE
    if bucket_frames is not None and bucket_frames > 0:
      padded = -(-frames // bucket_frames) * bucket_frames
      if padded != frames:
        mel = np.pad(mel, ((0, 0), (0, 0), (0, padded - frames)),
                     constant_values=float(np.log(CLIP_VAL)))
    return mel, true_samples

  @staticmethod
  def _one_utterance(mel: np.ndarray, where: str) -> None:
    if mel.shape[0] != 1:
      raise ValueError(
          f"{where} takes one utterance, got a batch of {mel.shape[0]}; "
          "send a batch to infer_serving_many as one mel per request")

  def _to_device(self, mel: np.ndarray) -> torch.Tensor:
    return to_device(mel, self.device, torch.float32)

  @torch.inference_mode()
  def infer(self, mel: np.ndarray, *, sigma: float = 1.0,
            denoiser_strength: float = 0.0005, seed: int = 0,
            noise: Optional[Sequence[np.ndarray]] = None,
            chunk_frames: Optional[int] = None,
            bucket_frames: Optional[int] = None) -> InferenceResult:
    """mel [n_mels, frames] or [B, n_mels, frames] -> InferenceResult, whose
    waveforms are [T] for one utterance and [B, T] for B > 1.

    ``noise``: injected standard-normal tensors in the draw order of
    ``models.waveglow.infer_noise_shapes`` (parity harnesses); otherwise
    noise is drawn from ``seed``: row b of a batch from
    ``row_seeds(seed, B)[b]``, which is ``seed + b * 2**32``, so row b
    equals a solo call with that seed (up to the rounding of differently
    shaped matrix products). ``chunk_frames``: synthesize in mel windows of
    this many frames plus the receptive-field halo
    (``inference.streaming``), at the activation memory of one window; the
    samples equal the one-call path's up to that rounding.
    ``bucket_frames`` pads the mel's frame count up to a multiple of it
    with the silence floor (ignored with injected noise) and trims the
    waveform back; kept samples equal the unpadded call's (position-keyed
    noise, masked WN residual rows). It composes with ``chunk_frames``.
    """
    timepoint = datetime.datetime.now()
    mel, true_samples = self._prepare_mel(
        mel, bucket_frames if noise is None else None)
    seeds = row_seeds(seed, mel.shape[0])
    true_frames = true_samples // UPSAMPLE_STRIDE
    start = time.perf_counter()
    if chunk_frames is not None and noise is None:
      groups = [(slice(None), infer_chunked(
          self.params, self.config, self._to_device(mel), sigma=sigma,
          seed=seeds, chunk_frames=chunk_frames, compute_dtype=self._cdt,
          true_frames=true_frames if mel.shape[-1] != true_frames else None,
          device=self.device))]
    else:
      groups = self._place.synthesize(
          self.config, mel, sigma=sigma, seeds=seeds,
          compute_dtype=self._cdt, noise=noise,
          true_frames=None if noise is not None else true_frames)
    self._sync()
    inference_duration_s = time.perf_counter() - start

    denoising_duration_s = 0.0
    denoised = groups
    if denoiser_strength > 0:
      start_dn = time.perf_counter()
      denoised = [(rows, self._denoisers[str(wav.device)](
          wav, denoiser_strength)) for rows, wav in groups]
      self._sync()
      denoising_duration_s = time.perf_counter() - start_dn

    def host(parts):
      return np.concatenate([w[..., :true_samples].cpu().numpy()
                             for _, w in parts], axis=0).squeeze()

    wav_np, wav_denoised_np = host(groups), host(denoised)
    was_overamplified = bool(np.abs(wav_np).max() > 1.0)
    return InferenceResult(
        wav=wav_np, wav_denoised=wav_denoised_np,
        sampling_rate=self.hparams.sampling_rate,
        inference_duration_s=inference_duration_s,
        denoising_duration_s=denoising_duration_s,
        was_overamplified=was_overamplified, timepoint=timepoint)

  def stream(self, mel: np.ndarray, *, sigma: float = 1.0, seed: int = 0,
             chunk_frames: int = 256, pcm16: bool = False,
             denoiser_strength: float = 0.0
             ) -> Iterator[Tuple[int, np.ndarray]]:
    """An iterator of numpy ``(start_sample, piece)`` pairs of one
    utterance's waveform as its windows finish: playback can start after
    the first window (``inference.streaming.stream_chunks``). The raw
    pieces reassemble to ``infer(mel, seed=seed, chunk_frames=...)``'s
    ``wav``. ``pcm16`` converts pieces to int16 on the device.

    ``denoiser_strength > 0`` feeds the raw pieces to a
    :class:`StreamingDenoiser` with one denoise block a window, whose
    pieces reassemble to ``infer``'s ``wav_denoised`` trimmed to
    ``floor(T / hop) * hop`` samples; the denoised stream lags the raw one
    by less than ``filter_length`` samples. The mel is checked and placed
    on the device when this is called.
    """
    mel, _ = self._prepare_mel(mel, None)
    self._one_utterance(mel, "stream()")
    denoise = denoiser_strength > 0
    pieces = stream_chunks(
        self.params, self.config, self._to_device(mel), sigma=sigma,
        seed=seed, chunk_frames=chunk_frames, compute_dtype=self._cdt,
        pcm16=pcm16 and not denoise, device=self.device)
    if not denoise:
      return self._fetch_pieces(pieces)
    stft = self.denoiser.stft
    edge = stft.filter_length - stft.hop_length
    # one denoise block a synthesis window: block 0's window is clamped to
    # position 0 and needs block + 2 * edge - filter_length / 2 raw
    # samples, so the first denoised block is ready with the first piece
    block = max(stft.hop_length,
                (chunk_frames * UPSAMPLE_STRIDE - 2 * edge
                 + stft.filter_length // 2)
                // stft.hop_length * stft.hop_length)
    sd = StreamingDenoiser(self.denoiser, denoiser_strength,
                           block_samples=block, pcm16=pcm16)
    return self._denoise_pieces(pieces, sd)

  @torch.inference_mode()
  def _fetch_pieces(self, pieces) -> Iterator[Tuple[int, np.ndarray]]:
    for start, piece in pieces:
      yield start, piece[0].cpu().numpy()

  @torch.inference_mode()
  def _denoise_pieces(self, pieces, sd: StreamingDenoiser
                      ) -> Iterator[Tuple[int, np.ndarray]]:
    for _, piece in pieces:
      yield from sd.push(piece[0].cpu().numpy())
    yield from sd.flush()

  @torch.inference_mode()
  def _serve_rows(self, mel: np.ndarray, sigmas: np.ndarray,
                  seeds: Sequence[int], strengths: Optional[np.ndarray],
                  true_ns: np.ndarray, pcm16: bool):
    """Enqueue one fused serving batch: synthesis (per-row sigma, seed and
    true length), masked max|wav| per row, optional per-row-strength
    denoise, optional PCM16, each on the device that holds its rows.
    Returns ``(rows, samples, max_abs)`` device tensors per row group (one
    group off a data mesh). Nothing here waits for the device: the host
    inputs go over as non-blocking copies (``device.to_device``)."""
    out = []
    for rows, wav in self._place.synthesize(
        self.config, mel, sigma=sigmas, seeds=seeds, compute_dtype=self._cdt,
        true_frames=true_ns // UPSAMPLE_STRIDE):
      device = wav.device
      true_t = to_device(true_ns[rows], device, torch.int64)
      n = wav.shape[-1]
      mask = torch.arange(n, device=device)[None, :] < true_t[:, None]
      max_abs = torch.amax(wav.abs() * mask, dim=-1)
      samples = wav
      if strengths is not None:
        strength = to_device(strengths[rows], device, torch.float32)
        dn = self._denoisers[str(device)](wav, strength.reshape(-1, 1, 1))
        if dn.shape[-1] < n:  # the iSTFT is frame-aligned: restore the length
          dn = torch.nn.functional.pad(dn, (0, n - dn.shape[-1]))
        samples = dn[..., :n]
      if pcm16:
        samples = pcm16_on_device(samples)
      out.append((rows, samples, max_abs))
    return out

  def _dispatched(self, batches, true_samples: List[int], start: float,
                  timepoint: datetime.datetime) -> ServingDispatch:
    """The record of dispatched ``batches`` (each ``(request indices,
    samples, max_abs)`` on the device), their fetch enqueued now
    (:func:`enqueue_fetch`)."""
    host, event = enqueue_fetch([t for _, samples, max_abs in batches
                                 for t in (samples, max_abs)])
    return ServingDispatch(
        [(rows, host[2 * k], host[2 * k + 1])
         for k, (rows, _, _) in enumerate(batches)],
        true_samples, start, timepoint, event)

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
                       pcm16: bool = False) -> ServingDispatch:
    """Enqueue one :meth:`infer_serving` request and its fetch on the
    device; wait for nothing. Returns the record for
    :meth:`serving_finalize`."""
    timepoint = datetime.datetime.now()
    mel, true_samples = self._prepare_mel(mel, bucket_frames)
    self._one_utterance(mel, "infer_serving")
    start = time.perf_counter()
    strengths = (np.float32([denoiser_strength]) if denoiser_strength > 0
                 else None)
    batches = [([0], samples, max_abs) for _, samples, max_abs in
               self._serve_rows(mel, np.float32([sigma]), [seed], strengths,
                                np.int64([true_samples]), pcm16)]
    return self._dispatched(batches, [true_samples], start, timepoint)

  def serving_finalize(self, dispatched: ServingDispatch) -> ServingResult:
    """Wait for a :meth:`serving_dispatch` record's fetch; its
    ServingResult."""
    return self.serving_many_finalize(dispatched)[0]

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
                            pcm16: bool = False, max_batch: int = 8
                            ) -> ServingDispatch:
    """Enqueue the micro-batches and their fetch on the device; wait for
    nothing."""
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
    for mel, _ in prepared:
      self._one_utterance(mel, "each request of infer_serving_many")

    groups: Dict[tuple, List[int]] = {}
    for i, (mel, _) in enumerate(prepared):
      groups.setdefault((mel.shape[-1], bool(strengths[i] > 0)), []).append(i)

    start = time.perf_counter()
    batches = []
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
        for part, samples, max_abs in self._serve_rows(
            mel_batch, sigmas[rows], [seeds[i] for i in rows],
            strengths[rows] if denoise else None,
            np.asarray([prepared[i][1] for i in rows], dtype=np.int64),
            pcm16):
          batches.append((rows[part], samples, max_abs))
    return self._dispatched(batches, [true for _, true in prepared], start,
                            timepoint)

  def serving_many_finalize(self, dispatched: ServingDispatch
                            ) -> List[ServingResult]:
    """Wait for a dispatch record's fetch (its event alone); its
    ServingResults, in request order."""
    if dispatched.event is not None:
      dispatched.event.synchronize()
    duration_s = time.perf_counter() - dispatched.start
    out: List[Optional[ServingResult]] = [None] * len(dispatched.true_samples)
    for rows, samples, max_abs in dispatched.batches:
      for row, i in enumerate(rows):
        out[i] = ServingResult(
            samples=samples[row, :dispatched.true_samples[i]],
            sampling_rate=self.hparams.sampling_rate,
            duration_s=duration_s,
            was_overamplified=bool(max_abs[row] > 1.0),
            timepoint=dispatched.timepoint)
    return out  # type: ignore[return-value]
