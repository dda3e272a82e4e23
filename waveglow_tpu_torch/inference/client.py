"""Python client for the port's HTTP synthesis daemon
(``waveglow_tpu_torch.inference.server``; counterpart of
``waveglow_tpu/inference/client.py``).

Stdlib only (urllib) plus numpy, so a TTS frontend can talk to a remote
vocoder without torch:

    client = SynthesisClient("http://gpu-host:8642")
    client.health()["status"]            # "ok"
    wav = client.synthesize(mel)         # np.float32 [samples]
    for piece in client.stream(mel):     # float32 pieces as synthesized
        play(piece)
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Iterator, Optional

import numpy as np

DEFAULT_TIMEOUT_S = 600.0
_STREAM_READ_BYTES = 64 * 1024
UPSAMPLE_STRIDE = 256  # audio samples a mel frame


class SynthesisClient:
  """Thin blocking client over one daemon base URL.

  The daemon sheds load with HTTP 503 + Retry-After once ``max_queue``
  requests are in flight; the client backs off and retries those up to
  ``retries_503`` times (0 disables: the HTTPError propagates).
  """

  def __init__(self, base_url: str, *, timeout_s: float = DEFAULT_TIMEOUT_S,
               retries_503: int = 2):
    self.base_url = base_url.rstrip("/")
    self.timeout_s = timeout_s
    self.retries_503 = retries_503
    self._hop_length: Optional[int] = None

  # -- queries ---------------------------------------------------------------

  def health(self) -> Dict:
    return self._get_json("/healthz")

  def stats(self) -> Dict:
    return self._get_json("/stats")

  def metrics(self) -> str:
    """Prometheus text exposition from GET /metrics."""
    with urllib.request.urlopen(self._url("/metrics"),
                                timeout=self.timeout_s) as resp:
      return resp.read().decode()

  def reload(self, checkpoint_path: str) -> Dict:
    """Hot-swap the daemon's weights from a checkpoint on its filesystem
    (same architecture only; POST /reload)."""
    body = json.dumps({"checkpoint": str(checkpoint_path)}).encode()
    with self._post(self._url("/reload"), body) as resp:
      return json.loads(resp.read())

  # -- synthesis -------------------------------------------------------------

  def synthesize(self, mel: np.ndarray, *, sigma: Optional[float] = None,
                 denoiser_strength: Optional[float] = None,
                 seed: int = 0) -> np.ndarray:
    """mel [n_mels, frames] -> float32 waveform [samples] (denoised)."""
    url = self._url("/synthesize", sigma=sigma,
                    denoiser_strength=denoiser_strength, seed=seed,
                    format="npy")
    with self._post(url, _npy_bytes(mel)) as resp:
      return np.load(io.BytesIO(resp.read()), allow_pickle=False)

  def synthesize_to_wav_bytes(self, mel: np.ndarray, *,
                              sigma: Optional[float] = None,
                              denoiser_strength: Optional[float] = None,
                              seed: int = 0) -> bytes:
    """mel -> int16 RIFF/WAV bytes, ready to write to a .wav file."""
    url = self._url("/synthesize", sigma=sigma,
                    denoiser_strength=denoiser_strength, seed=seed,
                    format="wav")
    with self._post(url, _npy_bytes(mel)) as resp:
      return resp.read()

  def copy_synthesize(self, wav_bytes: bytes, *,
                      sigma: Optional[float] = None,
                      denoiser_strength: Optional[float] = None,
                      seed: int = 0) -> np.ndarray:
    """.wav file bytes -> resynthesized float32 waveform."""
    url = self._url("/synthesize-wav", sigma=sigma,
                    denoiser_strength=denoiser_strength, seed=seed,
                    format="npy")
    with self._post(url, wav_bytes) as resp:
      return np.load(io.BytesIO(resp.read()), allow_pickle=False)

  def stream(self, mel: np.ndarray, *, sigma: Optional[float] = None,
             denoiser_strength: Optional[float] = None, seed: int = 0,
             chunk_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield float32 waveform pieces as the daemon synthesizes them.

    Pieces concatenate to the utterance (denoised with the daemon's default
    strength unless overridden; ``denoiser_strength=0`` streams raw). A
    daemon that fails mid-utterance can only truncate its committed 200,
    so the end of the body alone does not prove completion: this raises
    ``IOError`` if fewer samples arrive than the utterance has. A raw
    stream carries ``frames * 256`` samples; a denoised one
    ``floor(frames * 256 / hop) * hop``, with the STFT hop from the
    daemon's ``/healthz``. Where the strength is left to the daemon, the
    shorter count is the one checked.
    """
    samples = int(np.shape(mel)[-1]) * UPSAMPLE_STRIDE
    if denoiser_strength == 0:
      expected = samples
    else:
      hop = self._hop()
      expected = samples // hop * hop
    url = self._url("/stream", sigma=sigma,
                    denoiser_strength=denoiser_strength, seed=seed,
                    chunk_frames=chunk_frames)
    received = 0
    with self._post(url, _npy_bytes(mel)) as resp:
      pcm_format = resp.headers["X-PCM-Format"]
      if pcm_format != "s16le":
        raise IOError(f"stream in PCM format {pcm_format!r}, expected "
                      "'s16le'")
      carry = b""
      while True:
        # read1 returns as soon as any bytes are there; read(n) would wait
        # for n bytes and stall playback between pieces
        data = resp.read1(_STREAM_READ_BYTES)
        if not data:
          break
        carry += data
        usable = len(carry) - (len(carry) % 2)
        if usable:
          pcm = np.frombuffer(carry[:usable], dtype="<i2")
          carry = carry[usable:]
          received += pcm.shape[0]
          yield pcm.astype(np.float32) / 32768.0
    if received < expected:
      raise IOError(
          f"stream truncated: received {received} of {expected} samples "
          "(the daemon failed mid-utterance; see its log)")

  # -- plumbing --------------------------------------------------------------

  def _hop(self) -> int:
    if self._hop_length is None:
      self._hop_length = int(self.health()["model"]["hop_length"])
    return self._hop_length

  def _url(self, path: str, **params) -> str:
    q = {k: v for k, v in params.items() if v is not None}
    query = ("?" + urllib.parse.urlencode(q)) if q else ""
    return f"{self.base_url}{path}{query}"

  def _post(self, url: str, body: bytes):
    attempt = 0
    while True:
      req = urllib.request.Request(url, data=body, method="POST")
      try:
        return urllib.request.urlopen(req, timeout=self.timeout_s)
      except urllib.error.HTTPError as e:
        if e.code != 503 or attempt >= self.retries_503:
          raise
        delay = _retry_after_s(e)
        e.close()
        time.sleep(min(delay * (attempt + 1), 10.0))
        attempt += 1

  def _get_json(self, path: str) -> Dict:
    with urllib.request.urlopen(self._url(path),
                                timeout=self.timeout_s) as resp:
      return json.loads(resp.read())


def _retry_after_s(err: "urllib.error.HTTPError") -> float:
  try:
    return max(0.05, float(err.headers.get("Retry-After", 1.0)))
  except (TypeError, ValueError):
    return 1.0


def _npy_bytes(arr: np.ndarray) -> bytes:
  buf = io.BytesIO()
  np.save(buf, np.asarray(arr, dtype=np.float32), allow_pickle=False)
  return buf.getvalue()
