"""HTTP serving daemon: mel->wav synthesis over the network on one card or
a device mesh (counterpart of ``waveglow_tpu/inference/server.py``).

:class:`SynthesisService` wraps a :class:`Synthesizer` whose weights stay
on the device across requests:

  * request mels are length-bucketed (``bucket_frames``) and masked per
    row, so padding changes no kept sample;
  * each request is one dispatch and one device-to-host fetch
    (``Synthesizer.serving_dispatch``): synthesis, denoise, int16 PCM and
    the overamp max run on the device, and only the waveform in the
    response's representation is copied back;
  * one lock serializes device work (the enqueue of a dispatch, a stream
    window, a reload); threads overlap parsing and response IO;
  * concurrent /synthesize traffic micro-batches (:class:`_MicroBatcher`):
    requests that arrive while the device is busy are drained as a group,
    bucketed by length and dispatched as power-of-two batches up to
    ``max_batch`` (default 8), while a finisher thread waits for the
    previous dispatch's fetch; a solo request keeps the batch-1 call;
  * admission control sheds load past ``max_queue`` requests in flight
    (HTTP 503 + Retry-After) and a mel over ``max_frames`` frames (HTTP
    413); /stats reports latency percentiles, in-flight depth, the shed
    count and a per-stage decomposition.

With ``mesh=`` the daemon is a sharded synthesis service
(``Synthesizer(mesh=)``): a ``data`` axis spreads micro-batch rows over the
devices, a ``model`` axis cuts the WN hidden channels over them, a ``time``
axis splits each request's frames; ``/healthz`` reports the mesh's shape
and ``/reload`` re-shards. Orbax reloads are not ported; a torch-format
reload needs ``allow_torch_reload``.

Endpoints (JSON errors, application/json):

  GET  /healthz               -> {"status": "ok", model/serving/mesh summary}
  GET  /stats                 -> counters, latency percentiles, per-stage
                              decomposition (stages_ms), in-flight
  GET  /metrics               -> the same in Prometheus text format
  POST /reload                body: JSON {"checkpoint": "<daemon-side
                              path>"}; weight hot-swap (same architecture
                              only; a torch .pt only with
                              allow_torch_reload)
  POST /synthesize            body: .npy mel [n_mels, frames] (float32)
  POST /synthesize-wav        body: .wav file (copy synthesis)
  POST /stream                body: .npy mel; response: PCM16 pieces
                              written as their windows finish, denoised
                              incrementally by default
                              (denoiser_strength=0 streams raw)

Query params for the POST endpoints: ``sigma`` (default 1.0),
``denoiser_strength`` (default 0.0005), ``seed`` (default 0), and
``format=wav|npy`` (synthesize* only; wav = int16 RIFF, npy = float32
samples). Responses carry ``X-Sampling-Rate``, ``X-Audio-Seconds`` and
``X-Overamplified``; streams carry ``X-PCM-Format: s16le``.

Run it on the card::

    service = SynthesisService(CheckpointWaveglow.load("model.npz"))
    serve_forever(service, "0.0.0.0", 8642)
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from scipy.io import wavfile

from waveglow_tpu_torch.checkpointing import (load_checkpoint_as,
                                              sniff_checkpoint_format)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.dsp.audio_io import convert_wav
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.inference.synthesizer import (ServingResult,
                                                      Synthesizer,
                                                      enqueue_fetch)
from waveglow_tpu_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 256 * 1024 * 1024


class ServerOverloadedError(RuntimeError):
  """Admission control rejected a request (handler -> 503): ``max_queue``
  requests are in flight, or the daemon is draining. Excess load gets an
  immediate 503 + Retry-After instead of an unbounded queue."""


class RequestTooLargeError(ValueError):
  """A request mel exceeds ``max_frames`` (handler -> 413). ``max_queue``
  bounds how many requests are admitted, this how big one is: without it
  one mel the size of ``MAX_BODY_BYTES`` is one unbounded dispatch under
  the device lock. Operators serving longer inputs raise it together with
  ``chunk_frames`` (windows of constant memory)."""


class _BatchRequest:
  """One queued synthesis request awaiting micro-batch dispatch.

  The t_* marks split its service time into the stages /stats reports
  (``stages_ms``): queue wait (enqueue -> its batch is taken), submit (host
  prep and enqueue under the device lock) and device+fetch (execution and
  the device-to-host copy, which the host cannot tell apart without a
  profiler)."""

  __slots__ = ("mel", "sigma", "strength", "seed", "pcm16", "done",
               "result", "error", "t_enqueue", "t_taken", "t_submitted",
               "t_done")

  def __init__(self, mel, sigma, strength, seed, pcm16):
    self.mel = mel
    self.sigma = sigma
    self.strength = strength
    self.seed = seed
    self.pcm16 = pcm16
    self.done = threading.Event()
    self.result = None
    self.error = None
    self.t_enqueue = time.perf_counter()
    self.t_taken = None
    self.t_submitted = None
    self.t_done = None


class _MicroBatcher:
  """Groups concurrent requests into batched device dispatches.

  A dispatcher thread takes the oldest queued request, waits up to
  ``batch_window_ms`` for companions (a batch also builds up while the
  device lock is held by the previous dispatch), drains the queue, groups
  by (bucket length, raw or denoised, pcm16) and dispatches each group
  through ``Synthesizer.serving_many_dispatch`` (sigma, strength and seed
  are per-row inputs, so requests with different parameters co-batch). A
  group of one takes ``serving_dispatch``, the exact batch-1 call. A
  finisher thread waits for each dispatch's own fetch and fans the results
  out, while the dispatcher enqueues the next batch.
  """

  def __init__(self, service: "SynthesisService", max_batch: int,
               batch_window_ms: float = 5.0):
    self._service = service
    self._max_batch = max_batch
    self._window_s = max(0.0, batch_window_ms) / 1e3
    self._q: "queue.SimpleQueue[Optional[_BatchRequest]]" = queue.SimpleQueue()
    self._finish_q: "queue.SimpleQueue" = queue.SimpleQueue()
    self._started = False
    self._start_lock = threading.Lock()
    self._threads: List[threading.Thread] = []

  def submit(self, mel, sigma, strength, seed, pcm16) -> ServingResult:
    """Enqueue one request and block until its result is ready."""
    with self._start_lock:
      if not self._started:
        self._threads = [
            threading.Thread(target=self._loop, daemon=True,
                             name="waveglow-microbatch"),
            threading.Thread(target=self._finish_loop, daemon=True,
                             name="waveglow-microbatch-finish")]
        for t in self._threads:
          t.start()
        self._started = True
    req = _BatchRequest(mel, sigma, strength, seed, pcm16)
    self._q.put(req)
    req.done.wait()
    if req.t_done is not None:  # error paths may leave marks unset
      self._service._record_stages(
          queue_wait=(req.t_taken - req.t_enqueue) * 1e3,
          submit=(req.t_submitted - req.t_taken) * 1e3,
          device_fetch=(req.t_done - req.t_submitted) * 1e3)
    if req.error is not None:
      raise req.error
    return req.result

  def close(self, timeout_s: Optional[float] = None) -> None:
    """Dispatch what is queued, stop both threads and wait for them (each
    up to ``timeout_s``). A daemon thread still running when the
    interpreter exits is stopped wherever it is; inside torch's
    deallocators that aborts the process."""
    with self._start_lock:
      if self._started:
        self._q.put(None)
    for t in self._threads:
      t.join(timeout_s)

  def _loop(self):
    while True:
      first = self._q.get()
      if first is None:
        self._finish_q.put(None)
        return
      batch = [first]
      # a rolling window: every arrival extends the deadline by window_s,
      # capped at 4 windows from the first arrival so latency stays
      # bounded; a full drain (4 * max_batch) dispatches at once
      t0 = time.monotonic()
      deadline = t0 + self._window_s
      cap = t0 + 4 * self._window_s
      while len(batch) < 4 * self._max_batch:
        try:
          remaining = min(deadline, cap) - time.monotonic()
          nxt = (self._q.get(timeout=remaining) if remaining > 0
                 else self._q.get_nowait())
        except queue.Empty:
          break
        if nxt is None:
          self._dispatch(batch)
          self._finish_q.put(None)
          return
        batch.append(nxt)
        deadline = time.monotonic() + self._window_s
      self._dispatch(batch)

  def _finish_loop(self):
    """Wait for each dispatched batch's fetch and fan its results out, off
    the dispatcher thread, which enqueues the next batch meanwhile."""
    synth = self._service.synth
    while True:
      item = self._finish_q.get()
      if item is None:
        return
      dispatched, reqs = item
      try:
        for r, res in zip(reqs, synth.serving_many_finalize(dispatched)):
          r.result = res
        now = time.perf_counter()
        for r in reqs:
          r.t_done = now
      except Exception as e:  # noqa: BLE001 -- fan the failure out
        for r in reqs:
          r.error = e
      finally:
        for r in reqs:
          r.done.set()

  def _bucket(self, frames: int) -> int:
    b = self._service.bucket_frames
    return -(-frames // b) * b if b else frames

  def _dispatch(self, batch: List[_BatchRequest]):
    # raw and denoised requests, and wav and npy ones (pcm16 selects which
    # buffer is fetched), dispatch apart; sigma, strength and seed are
    # per-row inputs
    now = time.perf_counter()
    for req in batch:
      req.t_taken = now
    groups: Dict[tuple, List[_BatchRequest]] = {}
    for req in batch:
      key = (self._bucket(req.mel.shape[-1]), req.strength > 0, req.pcm16)
      groups.setdefault(key, []).append(req)
    service = self._service
    for (_, _, pcm16), reqs in groups.items():
      if len(reqs) > 1:
        with service._stats_lock:
          service.stats["batches"] += 1
          service.stats["batched_requests"] += len(reqs)
      # the lock covers the enqueue only: the finisher waits for the fetch,
      # so the next batch is enqueued while this one runs
      try:
        with service._device_lock:
          if len(reqs) == 1:
            dispatched = service.synth.serving_dispatch(
                reqs[0].mel, sigma=reqs[0].sigma,
                denoiser_strength=reqs[0].strength, seed=reqs[0].seed,
                bucket_frames=service.bucket_frames or None, pcm16=pcm16)
          else:
            dispatched = service.synth.serving_many_dispatch(
                [r.mel for r in reqs], sigma=[r.sigma for r in reqs],
                denoiser_strength=[r.strength for r in reqs],
                seeds=[r.seed for r in reqs],
                bucket_frames=service.bucket_frames or None,
                pcm16=pcm16, max_batch=self._max_batch)
      except Exception as e:  # noqa: BLE001 -- fan the failure out
        for r in reqs:
          r.error = e
          r.done.set()
        continue
      submitted = time.perf_counter()
      for r in reqs:
        r.t_submitted = submitted
      self._finish_q.put((dispatched, reqs))


class SynthesisService:
  """Transport-agnostic serving core around one model on one device (the
  card by default, raises without one; the CPU with ``device="cpu"``) or
  on ``mesh`` (``parallel.mesh``)."""

  def __init__(self, checkpoint: CheckpointWaveglow, *,
               custom_hparams: Optional[Dict[str, str]] = None,
               bucket_frames: int = 64, chunk_frames: Optional[int] = None,
               sigma: float = 1.0, denoiser_strength: float = 0.0005,
               max_batch: int = 8, batch_window_ms: float = 5.0,
               max_queue: int = 64, max_frames: int = 8192,
               allow_torch_reload: bool = False,
               device: Optional[str] = None, mesh: Optional[Mesh] = None):
    self.synth = Synthesizer(checkpoint, custom_hparams=custom_hparams,
                             device=device, mesh=mesh)
    # kept for /reload: update_params must apply the same serve-time
    # overrides, or every hot-swap would read as an architecture change
    self.custom_hparams = custom_hparams
    self.mel_op = MelSTFT(self.synth.hparams, device=self.synth.device)
    self.bucket_frames = bucket_frames
    self.chunk_frames = chunk_frames
    self.default_sigma = sigma
    self.default_denoiser_strength = denoiser_strength
    # one device, one enqueue at a time
    self._device_lock = threading.Lock()
    self._stats_lock = threading.Lock()
    # max_batch=1 disables micro-batching; the chunked path serializes
    self.max_batch = max_batch
    self._batcher = (_MicroBatcher(self, max_batch, batch_window_ms)
                     if max_batch > 1 and not chunk_frames else None)
    # admission: at most max_queue synthesis requests in flight (queued and
    # executing, streams included), else 503; 0 disables shedding
    self.max_queue = max_queue
    # a mel over max_frames frames gets 413; 0 disables. 8192 frames is
    # about 95 s of audio at hop 256
    self.max_frames = max_frames
    # /reload of a torch-format path reaches torch.load (arbitrary pickle
    # code); off by default, for trusted networks only
    self.allow_torch_reload = allow_torch_reload
    self._inflight = 0
    self._inflight_lock = threading.Lock()
    self._draining = False
    # request wall latencies (s): a trimmed window for the /stats
    # percentiles, cumulative sum and count for the Prometheus summary
    self._latencies: List[float] = []
    self._latency_cap = 1024
    self._latency_total_n = 0
    self._latency_total_sum = 0.0
    # per-stage latency windows (ms): read/parse/service/serialize from the
    # HTTP handler, queue_wait/submit/device_fetch from the micro-batcher
    self._stages: Dict[str, List[float]] = {}
    self.started = time.time()
    self.stats = {"requests": 0, "errors": 0, "audio_seconds": 0.0,
                  "batched_requests": 0, "batches": 0, "rejected": 0,
                  "reloads": 0}

  # -- admission control -----------------------------------------------------

  def _admit(self):
    """Count one request in; raise ServerOverloadedError past max_queue."""
    with self._inflight_lock:
      self._reject_if_saturated()
      self._inflight += 1

  def check_capacity(self):
    """Early shed point for transports: raise ServerOverloadedError while
    saturated, before the caller buffers a request body it would throw
    away. Advisory: _admit() still enforces at dispatch."""
    with self._inflight_lock:
      self._reject_if_saturated()

  def _reject_if_saturated(self):
    # the caller holds _inflight_lock
    if self._draining:
      with self._stats_lock:
        self.stats["rejected"] += 1
      raise ServerOverloadedError("daemon is draining for shutdown")
    if self.max_queue and self._inflight >= self.max_queue:
      with self._stats_lock:
        self.stats["rejected"] += 1
      raise ServerOverloadedError(
          f"{self._inflight} requests in flight (max_queue="
          f"{self.max_queue}); retry later")

  def begin_drain(self) -> None:
    """Stop admitting synthesis work (503s) while in-flight requests
    finish: the graceful half of a SIGTERM shutdown."""
    with self._inflight_lock:
      self._draining = True

  def in_flight(self) -> int:
    with self._inflight_lock:
      return self._inflight

  def _release(self):
    with self._inflight_lock:
      self._inflight -= 1

  # -- core operations -------------------------------------------------------

  def synthesize_mel(self, mel: np.ndarray, *, sigma: Optional[float] = None,
                     denoiser_strength: Optional[float] = None,
                     seed: int = 0):
    """The InferenceResult of ``Synthesizer.infer`` (raw and denoised)."""
    mel = self._check_mel(mel)
    self._admit()
    try:
      t0 = time.perf_counter()
      with self._device_lock:
        result = self.synth.infer(
            mel, sigma=self.default_sigma if sigma is None else sigma,
            denoiser_strength=(self.default_denoiser_strength
                               if denoiser_strength is None
                               else denoiser_strength),
            seed=seed, bucket_frames=self.bucket_frames or None,
            chunk_frames=self.chunk_frames)
      self._count(result.wav.shape[-1] / self.sampling_rate,
                  time.perf_counter() - t0)
      return result
    finally:
      self._release()

  def synthesize_mel_packed(self, mel: np.ndarray, *,
                            sigma: Optional[float] = None,
                            denoiser_strength: Optional[float] = None,
                            seed: int = 0, pcm16: bool = False
                            ) -> ServingResult:
    """The request path: one dispatch, one fetch of exactly the
    representation the response needs (int16 PCM for format=wav, float32
    for format=npy), micro-batched with concurrent requests."""
    mel = self._check_mel(mel)
    sigma = self.default_sigma if sigma is None else sigma
    strength = (self.default_denoiser_strength if denoiser_strength is None
                else denoiser_strength)
    self._admit()
    try:
      t0 = time.perf_counter()
      out = self._synthesize_packed_admitted(mel, sigma, strength, seed,
                                             pcm16)
      self._count(out.samples.shape[0] / self.sampling_rate,
                  time.perf_counter() - t0)
      return out
    finally:
      self._release()

  def _synthesize_packed_admitted(self, mel, sigma, strength, seed, pcm16):
    if self._batcher is not None:
      return self._batcher.submit(mel, sigma, strength, seed, pcm16)
    with self._device_lock:
      if not self.chunk_frames:
        return self.synth.infer_serving(
            mel, sigma=sigma, denoiser_strength=strength, seed=seed,
            bucket_frames=self.bucket_frames or None, pcm16=pcm16)
      # constant memory: the chunked infer, converted on the host
      result = self.synth.infer(mel, sigma=sigma, denoiser_strength=strength,
                                seed=seed,
                                bucket_frames=self.bucket_frames or None,
                                chunk_frames=self.chunk_frames)
    wav = result.wav_denoised
    return ServingResult(
        samples=_pcm16(wav) if pcm16 else np.asarray(wav, np.float32),
        sampling_rate=result.sampling_rate,
        duration_s=result.inference_duration_s + result.denoising_duration_s,
        was_overamplified=result.was_overamplified,
        timepoint=result.timepoint)

  def synthesize_wav(self, wav: np.ndarray, **kw) -> ServingResult:
    """Copy synthesis: wav -> mel (on the device) -> wav."""
    (mel,), event = enqueue_fetch([self.mel_op.get_mel(wav)])
    if event is not None:
      event.synchronize()
    return self.synthesize_mel_packed(mel, **kw)

  def warmup(self, frames_list: Optional[List[int]] = None) -> Dict:
    """Run, once each, the calls a first traffic burst makes, so it does not
    pay cuBLAS and allocator set-up inside the device lock: for each entry
    of ``frames_list`` (mel frame counts; default one bucket of
    ``bucket_frames``) the solo call and every power-of-two micro-batch up
    to ``max_batch``, denoised and raw. Nothing is compiled.
    Returns {"programs": calls run, "seconds": wall}."""
    bucket = self.bucket_frames or 64
    frames_list = list(frames_list or [bucket])
    t0 = time.perf_counter()
    n = 0
    rng = np.random.default_rng(0)
    n_mels = self.synth.hparams.n_mel_channels
    with self._device_lock:
      for frames in frames_list:
        mel = rng.standard_normal((n_mels, frames)).astype(np.float32)
        for strength in (self.default_denoiser_strength, 0.0):
          self.synth.infer_serving(
              mel, denoiser_strength=strength,
              bucket_frames=self.bucket_frames or None)
          n += 1
          b = 2
          while b <= self.max_batch:
            self.synth.infer_serving_many(
                [mel] * b, denoiser_strength=strength,
                seeds=list(range(b)),
                bucket_frames=self.bucket_frames or None, max_batch=b)
            n += 1
            b *= 2
    seconds = round(time.perf_counter() - t0, 1)
    logger.info("Warmup ran %d serving calls in %.1f s", n, seconds)
    return {"programs": n, "seconds": seconds}

  def reload(self, checkpoint_path: str) -> Dict:
    """Hot-swap the weights from a checkpoint on the daemon's filesystem
    (``Synthesizer.update_params``: architecture changes are rejected).
    The swap runs under the device lock: requests dispatched before it
    finish on the old tensors (it builds new ones and mutates nothing),
    later ones use the new, and an open stream keeps the weights it began
    with.

    A torch-format path is refused, before anything is read, unless the
    service was built with ``allow_torch_reload``: the torch importer
    unpickles (``torch.load(weights_only=False)``, which NVIDIA's
    full-module files need), so a client-supplied path would run code for
    anyone who can reach the port and place a file. npz checkpoints carry
    no code and always reload; an orbax directory raises."""
    fmt = sniff_checkpoint_format(checkpoint_path)
    if fmt == "torch" and not self.allow_torch_reload:
      raise ValueError(
          "refusing to hot-swap a torch-format checkpoint: the torch "
          "importer deserializes arbitrary pickles. Convert it to the "
          "native format first (waveglow-tpu-torch download / export), or "
          "start the daemon with --allow-torch-reload on a trusted network")
    # load through the same sniff result: sniffing again inside the loader
    # would let a file swapped between the checks past the gate
    checkpoint = load_checkpoint_as(checkpoint_path, fmt)
    with self._device_lock:
      iteration = self.synth.update_params(
          checkpoint, custom_hparams=self.custom_hparams)
    with self._stats_lock:
      self.stats["reloads"] += 1
    return {"status": "reloaded", "iteration": int(iteration),
            "checkpoint": str(checkpoint_path)}

  def stream_mel(self, mel: np.ndarray, *, sigma: Optional[float] = None,
                 denoiser_strength: Optional[float] = None, seed: int = 0,
                 chunk_frames: Optional[int] = None, pcm16: bool = False):
    """Yield waveform pieces in time order as their windows finish
    (``Synthesizer.stream``), denoised incrementally by default; pass
    ``denoiser_strength=0`` for the raw waveform.

    The device lock is held per window, not for the whole utterance, so
    micro-batches interleave with a long stream instead of queueing behind
    it.
    """
    mel = self._check_mel(mel)
    self._admit()
    n = 0.0
    # served on normal exhaustion and on a client abort (GeneratorExit):
    # both delivered audio and count in requests/audio_seconds; a
    # synthesis error stays unserved (the transport counts it as an
    # error). Stream wall time is paced by the consuming client, so it
    # stays out of the latency window.
    served = False
    gen = None
    try:
      gen = self.synth.stream(
          mel, sigma=self.default_sigma if sigma is None else sigma,
          denoiser_strength=(self.default_denoiser_strength
                             if denoiser_strength is None
                             else denoiser_strength),
          seed=seed, chunk_frames=chunk_frames or self.chunk_frames or 128,
          pcm16=pcm16)
      while True:
        with self._device_lock:
          try:
            _, piece = next(gen)
          except StopIteration:
            break
        n += len(piece) / self.sampling_rate
        yield piece
      served = True
    except GeneratorExit:
      served = True
      raise
    finally:
      if gen is not None:
        gen.close()
      self._release()
      if served:
        self._count(n)

  # -- helpers ---------------------------------------------------------------

  @property
  def sampling_rate(self) -> int:
    return self.synth.hparams.sampling_rate

  def _check_mel(self, mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel)
    if mel.ndim == 3 and mel.shape[0] == 1:
      mel = mel[0]
    n_mels = self.synth.hparams.n_mel_channels
    if mel.ndim != 2 or mel.shape[0] != n_mels:
      raise ValueError(
          f"expected mel [{n_mels}, frames], got shape {tuple(mel.shape)}")
    if self.max_frames and mel.shape[1] > self.max_frames:
      with self._stats_lock:
        self.stats["rejected"] += 1
      raise RequestTooLargeError(
          f"mel has {mel.shape[1]} frames, over the admission limit "
          f"max_frames={self.max_frames} "
          f"(~{self.max_frames * 256 / self.sampling_rate:.0f} s of audio); "
          "raise max_frames (with chunk_frames to bound memory) to serve "
          "longer inputs")
    return mel.astype(np.float32)

  def _count(self, audio_seconds: float,
             latency_s: Optional[float] = None) -> None:
    with self._stats_lock:
      self.stats["requests"] += 1
      self.stats["audio_seconds"] += audio_seconds
      if latency_s is not None:
        self._latencies.append(latency_s)
        self._latency_total_n += 1
        self._latency_total_sum += latency_s
        if len(self._latencies) > self._latency_cap:
          # keep the newest half
          del self._latencies[:self._latency_cap // 2]

  def _record_stages(self, **stage_ms: float) -> None:
    """Record per-request stage durations (ms) into bounded windows."""
    with self._stats_lock:
      for name, v in stage_ms.items():
        w = self._stages.setdefault(name, [])
        w.append(float(v))
        if len(w) > self._latency_cap:
          del w[:self._latency_cap // 2]

  def health(self) -> Dict:
    hp = self.synth.hparams
    return {
        "status": "ok",
        "model": {"n_flows": hp.n_flows, "n_channels": hp.n_channels,
                  "n_layers": hp.n_layers, "n_mel_channels": hp.n_mel_channels,
                  "sampling_rate": hp.sampling_rate,
                  "hop_length": hp.hop_length,
                  "compute_dtype": hp.compute_dtype,
                  "iteration": int(self.synth.iteration)},
        "serving": {"bucket_frames": self.bucket_frames,
                    "chunk_frames": self.chunk_frames,
                    "max_batch": self.max_batch,
                    "max_queue": self.max_queue,
                    "max_frames": self.max_frames},
        "mesh": (dict(self.synth.mesh.shape) if self.synth.mesh is not None
                 else None),
    }

  def snapshot_stats(self) -> Dict:
    with self._stats_lock:
      out = dict(self.stats)
      lats = list(self._latencies)
      total_n, total_sum = self._latency_total_n, self._latency_total_sum
      stages = {k: list(v) for k, v in self._stages.items()}
    out["uptime_seconds"] = round(time.time() - self.started, 1)
    out["audio_seconds"] = round(out["audio_seconds"], 3)
    with self._inflight_lock:
      out["in_flight"] = self._inflight
    out["max_queue"] = self.max_queue
    if lats:
      q = np.quantile(lats, [0.5, 0.95, 0.99])
      out["latency_s"] = {
          "count": total_n, "sum": round(total_sum, 4),
          "window": len(lats), "mean": round(float(np.mean(lats)), 4),
          "p50": round(float(q[0]), 4), "p95": round(float(q[1]), 4),
          "p99": round(float(q[2]), 4)}
    if stages:
      out["stages_ms"] = {
          name: {"n": len(w), "mean": round(float(np.mean(w)), 2),
                 "p50": round(float(np.median(w)), 2),
                 "p95": round(float(np.quantile(w, 0.95)), 2)}
          for name, w in stages.items()}
    return out

  def prometheus_metrics(self) -> str:
    """/stats in Prometheus text exposition format (GET /metrics)."""
    s = self.snapshot_stats()
    lines = []

    def metric(name, mtype, value, help_text):
      lines.append(f"# HELP {name} {help_text}")
      lines.append(f"# TYPE {name} {mtype}")
      lines.append(f"{name} {value}")

    metric("waveglow_requests_total", "counter", s["requests"],
           "Completed synthesis requests")
    metric("waveglow_errors_total", "counter", s["errors"],
           "Requests answered with an error status")
    metric("waveglow_rejected_total", "counter", s["rejected"],
           "Requests shed by admission control (HTTP 503)")
    metric("waveglow_reloads_total", "counter", s["reloads"],
           "Checkpoint hot-swaps performed")
    metric("waveglow_batches_total", "counter", s["batches"],
           "Micro-batched device dispatches of more than one request")
    metric("waveglow_batched_requests_total", "counter",
           s["batched_requests"], "Requests served through micro-batches")
    metric("waveglow_audio_seconds_total", "counter",
           s["audio_seconds"], "Audio seconds synthesized")
    metric("waveglow_in_flight", "gauge", s["in_flight"],
           "Requests currently admitted (queued + executing)")
    metric("waveglow_uptime_seconds", "gauge", s["uptime_seconds"],
           "Seconds since daemon start")
    if "latency_s" in s:
      lat = s["latency_s"]
      lines.append("# HELP waveglow_request_latency_seconds "
                   "Request wall latency (quantiles over the newest "
                   f"{self._latency_cap} requests; sum/count cumulative)")
      lines.append("# TYPE waveglow_request_latency_seconds summary")
      for qt, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
        lines.append("waveglow_request_latency_seconds"
                     f'{{quantile="{qt}"}} {lat[key]}')
      lines.append(f"waveglow_request_latency_seconds_sum {lat['sum']}")
      lines.append(f"waveglow_request_latency_seconds_count {lat['count']}")
    if "stages_ms" in s:
      # windowed per-stage quantiles with no cumulative sum: a gauge
      lines.append("# HELP waveglow_request_stage_seconds Per-stage request "
                   "latency over the newest requests")
      lines.append("# TYPE waveglow_request_stage_seconds gauge")
      for stage, st in sorted(s["stages_ms"].items()):
        for qt, key in (("0.5", "p50"), ("0.95", "p95")):
          lines.append("waveglow_request_stage_seconds"
                       f'{{stage="{stage}",quantile="{qt}"}} '
                       f"{st[key] / 1e3:.6f}")
    return "\n".join(lines) + "\n"


def _pcm16(wav: np.ndarray) -> np.ndarray:
  """float -> int16 samples, clipped (``convert_wav`` alone wraps on
  |x| > 1); int16 input passes through."""
  wav = np.asarray(wav)
  if wav.dtype == np.int16:
    return wav
  return convert_wav(np.clip(wav, -1.0, 1.0), np.int16)


def _wav_bytes(wav: np.ndarray, sampling_rate: int) -> bytes:
  buf = io.BytesIO()
  wavfile.write(buf, sampling_rate, _pcm16(wav))
  return buf.getvalue()


def _npy_bytes(arr: np.ndarray) -> bytes:
  buf = io.BytesIO()
  np.save(buf, np.asarray(arr, dtype=np.float32), allow_pickle=False)
  return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
  # set by make_server
  service: SynthesisService = None
  protocol_version = "HTTP/1.1"

  # -- plumbing --------------------------------------------------------------

  def log_message(self, fmt, *args):  # to logging, not stderr
    logger.info("%s %s", self.address_string(), fmt % args)

  def _send_json(self, code: int, payload: Dict, *,
                 close: bool = False) -> None:
    """``close=True`` sends ``Connection: close``: required for an error
    sent before the request body was read, since a reused keep-alive
    connection would parse the next request from the leftover body."""
    body = json.dumps(payload).encode()
    self.send_response(code)
    self.send_header("Content-Type", "application/json")
    self.send_header("Content-Length", str(len(body)))
    if close:
      self.send_header("Connection", "close")
    self.end_headers()
    self.wfile.write(body)

  def _send_error_json(self, code: int, message: str, *,
                       close: bool = False) -> None:
    with self.service._stats_lock:
      self.service.stats["errors"] += 1
    self._send_json(code, {"error": message}, close=close)

  def _read_body(self) -> bytes:
    length = int(self.headers.get("Content-Length", 0))
    if length <= 0:
      raise ValueError("empty request body")
    if length > MAX_BODY_BYTES:
      raise ValueError(f"request body over {MAX_BODY_BYTES} bytes")
    return self.rfile.read(length)

  def _query(self):
    q = parse_qs(urlparse(self.path).query)

    def get(name, cast, default):
      if name not in q:
        return default
      return cast(q[name][0])

    return get

  # -- endpoints -------------------------------------------------------------

  def do_GET(self):
    route = urlparse(self.path).path
    if route == "/healthz":
      self._send_json(200, self.service.health())
    elif route == "/stats":
      self._send_json(200, self.service.snapshot_stats())
    elif route == "/metrics":
      body = self.service.prometheus_metrics().encode()
      self.send_response(200)
      self.send_header("Content-Type",
                       "text/plain; version=0.0.4; charset=utf-8")
      self.send_header("Content-Length", str(len(body)))
      self.end_headers()
      self.wfile.write(body)
    else:
      self._send_error_json(404, f"unknown path {route}")

  def do_POST(self):
    route = urlparse(self.path).path
    # until _read_body() returns, the body sits unread on the socket: an
    # error answered before then must close the keep-alive connection
    body_read = False
    try:
      get = self._query()
      sigma = get("sigma", float, None)
      strength = get("denoiser_strength", float, None)
      seed = get("seed", int, 0)
      fmt = get("format", str, "wav")
      if fmt not in ("wav", "npy"):
        raise ValueError(f"format must be wav or npy, got {fmt!r}")
      if route in ("/synthesize", "/synthesize-wav", "/stream"):
        # shed before buffering a body a saturated daemon would discard
        self.service.check_capacity()
      t_read = time.perf_counter()
      body = self._read_body()
      body_read = True
      t_parse = time.perf_counter()

      if route == "/reload":
        payload = json.loads(body)
        if not isinstance(payload, dict) or "checkpoint" not in payload:
          raise ValueError('body must be JSON {"checkpoint": "<path>"}')
        self._send_json(200, self.service.reload(payload["checkpoint"]))
        return

      pcm16 = fmt == "wav"  # converted on the device
      if route == "/synthesize":
        mel = np.load(io.BytesIO(body), allow_pickle=False)
        t_service = time.perf_counter()
        result = self.service.synthesize_mel_packed(
            mel, sigma=sigma, denoiser_strength=strength, seed=seed,
            pcm16=pcm16)
      elif route == "/synthesize-wav":
        rate, wav = wavfile.read(io.BytesIO(body))
        if rate != self.service.sampling_rate:
          raise ValueError(f"expected {self.service.sampling_rate} Hz wav, "
                           f"got {rate}")
        t_service = time.perf_counter()
        result = self.service.synthesize_wav(
            convert_wav(wav, np.float32),
            sigma=sigma, denoiser_strength=strength, seed=seed, pcm16=pcm16)
      elif route == "/stream":
        mel = np.load(io.BytesIO(body), allow_pickle=False)
        self._stream_response(mel, sigma=sigma, denoiser_strength=strength,
                              seed=seed,
                              chunk_frames=get("chunk_frames", int, None))
        return
      else:
        self._send_error_json(404, f"unknown path {route}")
        return
    except ServerOverloadedError as e:
      # counted in stats["rejected"] by admission, not in stats["errors"]
      body = json.dumps({"error": f"overloaded: {e}"}).encode()
      self.send_response(503)
      self.send_header("Content-Type", "application/json")
      self.send_header("Content-Length", str(len(body)))
      self.send_header("Retry-After", "1")
      if not body_read:
        self.send_header("Connection", "close")
      self.end_headers()
      self.wfile.write(body)
      return
    except RequestTooLargeError as e:
      # counted in stats["rejected"] by _check_mel; the body was read, so
      # keep-alive stays safe
      self._send_json(413, {"error": f"too large: {e}"})
      return
    except Exception as e:  # noqa: BLE001 -- client errors become 400s
      self._send_error_json(400, f"{type(e).__name__}: {e}",
                            close=not body_read)
      return

    wav = result.samples
    t_serialize = time.perf_counter()
    payload = (_wav_bytes(wav, self.service.sampling_rate) if fmt == "wav"
               else _npy_bytes(wav))
    # recorded before the response goes out: a client that has its answer
    # finds the request's stages in /stats
    self.service._record_stages(
        read=(t_parse - t_read) * 1e3, parse=(t_service - t_parse) * 1e3,
        service=(t_serialize - t_service) * 1e3,
        serialize=(time.perf_counter() - t_serialize) * 1e3)
    self.send_response(200)
    self.send_header("Content-Type", "audio/wav" if fmt == "wav"
                     else "application/octet-stream")
    self.send_header("Content-Length", str(len(payload)))
    self.send_header("X-Sampling-Rate", str(self.service.sampling_rate))
    self.send_header("X-Audio-Seconds",
                     f"{wav.shape[0] / self.service.sampling_rate:.3f}")
    self.send_header("X-Overamplified",
                     "true" if result.was_overamplified else "false")
    self.end_headers()
    self.wfile.write(payload)

  def _stream_response(self, mel, *, sigma, denoiser_strength, seed,
                       chunk_frames):
    """PCM16 pieces flushed as their windows finish."""
    pieces = self.service.stream_mel(mel, sigma=sigma,
                                     denoiser_strength=denoiser_strength,
                                     seed=seed, chunk_frames=chunk_frames,
                                     pcm16=True)
    first = next(pieces)  # raise (-> 400) before committing to a 200
    self.send_response(200)
    self.send_header("Content-Type", "application/octet-stream")
    self.send_header("X-Sampling-Rate", str(self.service.sampling_rate))
    self.send_header("X-PCM-Format", "s16le")
    # no Content-Length: the connection closes when the utterance ends
    self.send_header("Connection", "close")
    self.end_headers()
    try:
      for piece in _chain_first(first, pieces):
        self.wfile.write(_pcm16(piece).tobytes())
        self.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
      # the client hung up: closing the generator below stops the
      # remaining windows
      logger.info("stream client disconnected early")
    except Exception:  # noqa: BLE001 -- the 200 is committed: a status
      # line or JSON now would decode as PCM, so truncate the stream
      # (Connection: close ends it) and count the failure here
      logger.exception("stream failed mid-utterance; truncating response")
      with self.service._stats_lock:
        self.service.stats["errors"] += 1
    finally:
      pieces.close()
    self.close_connection = True


def _chain_first(first, rest):
  yield first
  yield from rest


def make_server(service: SynthesisService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
  """Bind a ready-to-run server (port 0 = ephemeral; see server_port)."""
  handler = type("BoundHandler", (_Handler,), {"service": service})
  return ThreadingHTTPServer((host, port), handler)


def serve_forever(service: SynthesisService, host: str, port: int, *,
                  warmup_frames: Optional[List[int]] = None,
                  drain_timeout_s: float = 30.0) -> None:
  """Run the daemon until interrupted.

  ``warmup_frames``: run the serving calls for these mel lengths before
  binding the port (:meth:`SynthesisService.warmup`). SIGTERM drains: new
  requests get 503s, in-flight ones finish (up to ``drain_timeout_s``),
  then the listener closes. On return the micro-batcher's and the drain's
  threads have ended and the previous SIGTERM handler is back.
  """
  import signal

  if warmup_frames:
    logger.info("Warming serving calls for frame counts %s ...",
                warmup_frames)
    service.warmup(warmup_frames)
  httpd = make_server(service, host, port)

  def _drain_then_stop():
    service.begin_drain()
    deadline = time.time() + drain_timeout_s
    while time.time() < deadline and service.in_flight() > 0:
      time.sleep(0.1)
    httpd.shutdown()

  drains: List[threading.Thread] = []

  def _on_sigterm(signum, frame):  # noqa: ARG001
    logger.info("SIGTERM: draining %d in-flight requests, then stopping",
                service.in_flight())
    drains.append(threading.Thread(target=_drain_then_stop, daemon=True,
                                   name="waveglow-drain"))
    drains[-1].start()

  previous = None
  try:
    previous = signal.signal(signal.SIGTERM, _on_sigterm)
  except ValueError:
    pass  # not the main thread: no signal hook
  device = service.synth.device
  logger.info("Serving on http://%s:%d (model on %s)", host,
              httpd.server_port,
              torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu")
  try:
    httpd.serve_forever()
  except KeyboardInterrupt:
    logger.info("Shutting down")
  finally:
    httpd.server_close()
    if service._batcher is not None:
      service._batcher.close(drain_timeout_s)
    for t in drains:
      t.join(drain_timeout_s)
    if previous is not None:
      signal.signal(signal.SIGTERM, previous)
