"""The port's HTTP daemon (``inference/server.py``) and client
(``inference/client.py``) on the CPU: every route through a daemon on an
ephemeral port, its status codes (400, 404, 413, 503), micro-batching, the
solo npy body against ``Synthesizer.infer_serving`` bit for bit, streams,
reload, Prometheus metrics, drain, the stage times, the client's
hop-based stream length check, and a contract test against the JAX
daemon on the same npz. Tiny config (5 flows, 3 layers, 32 channels),
every ``end`` conv randomised.

Every HTTP call, wait and join here carries its own timeout, and every
daemon started here is shut down.
"""

import concurrent.futures
import contextlib
import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tests.test_torch_serving import rand_mel, tiny_checkpoint
from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.inference import server as jax_server
from waveglow_tpu_torch.checkpointing import (load_checkpoint_as,
                                              sniff_checkpoint_format)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.inference import server
from waveglow_tpu_torch.inference.client import SynthesisClient
from waveglow_tpu_torch.inference.server import (ServerOverloadedError,
                                                 SynthesisService,
                                                 make_server)

BUCKET = 16
MAX_FRAMES = 64
TIMEOUT_S = 60


@contextlib.contextmanager
def running(service, make=make_server):
  """``service`` behind a daemon (``make``) on an ephemeral port; yields
  its URL and shuts everything down."""
  httpd = make(service, "127.0.0.1", 0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  try:
    yield f"http://127.0.0.1:{httpd.server_port}"
  finally:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=TIMEOUT_S)
    assert not thread.is_alive()
    batcher = getattr(service, "_batcher", None)
    if batcher is not None:
      batcher.close()


def new_service(**kwargs):
  kwargs.setdefault("bucket_frames", BUCKET)
  kwargs.setdefault("max_frames", MAX_FRAMES)
  return SynthesisService(tiny_checkpoint(seed=1), device="cpu", **kwargs)


@pytest.fixture(scope="module")
def service():
  return new_service()


@pytest.fixture(scope="module")
def base_url(service):
  with running(service) as url:
    yield url


@pytest.fixture
def client(base_url):
  return SynthesisClient(base_url, timeout_s=TIMEOUT_S)


def npy(arr):
  buf = io.BytesIO()
  np.save(buf, np.asarray(arr, np.float32), allow_pickle=False)
  return buf.getvalue()


def post(url, body):
  req = urllib.request.Request(url, data=body, method="POST")
  return urllib.request.urlopen(req, timeout=TIMEOUT_S)


def post_npy(url, mel):
  with post(url, npy(mel)) as r:
    return np.load(io.BytesIO(r.read()), allow_pickle=False)


def http_error(url, body=None):
  """The HTTPError of a request that must fail: (code, headers, JSON)."""
  with pytest.raises(urllib.error.HTTPError) as e:
    if body is None:
      urllib.request.urlopen(url, timeout=TIMEOUT_S)
    else:
      post(url, body)
  err = e.value
  payload = json.loads(err.read())
  err.close()
  return err.code, err.headers, payload


@contextlib.contextmanager
def saturated(service):
  """Pin the in-flight count at ``max_queue``: the daemon sheds."""
  with service._inflight_lock:
    service._inflight += service.max_queue
  try:
    yield
  finally:
    with service._inflight_lock:
      service._inflight -= service.max_queue


def wait_for(predicate, timeout=TIMEOUT_S):
  deadline = time.monotonic() + timeout
  while not predicate():
    assert time.monotonic() < deadline, "timed out"
    time.sleep(0.005)


# -- routes --------------------------------------------------------------------

def test_healthz_and_stats(client, service):
  health = client.health()
  assert health["status"] == "ok"
  assert health["model"]["n_flows"] == 5
  assert health["model"]["hop_length"] == 256
  assert health["serving"]["bucket_frames"] == BUCKET
  assert health["serving"]["max_frames"] == MAX_FRAMES
  assert health["mesh"] is None
  assert client.stats()["max_queue"] == service.max_queue


def test_solo_npy_body_equals_infer_serving(client, base_url, service):
  """An uncontended request takes the batch-1 call: its npy body equals
  ``infer_serving`` at the same shape and seed bit for bit; its wav body is
  the int16 PCM of the same call; the headers carry rate, length and the
  overamp flag."""
  mel = rand_mel(11, seed=5)
  got = client.synthesize(mel, seed=5)
  solo = service.synth.infer_serving(mel, seed=5, bucket_frames=BUCKET)
  assert got.dtype == np.float32 and got.shape == (11 * 256,)
  np.testing.assert_array_equal(got, solo.samples)
  with post(base_url + "/synthesize?seed=5", npy(mel)) as r:
    assert r.headers["Content-Type"] == "audio/wav"
    assert r.headers["X-Sampling-Rate"] == "22050"
    assert r.headers["X-Audio-Seconds"] == f"{11 * 256 / 22050:.3f}"
    assert r.headers["X-Overamplified"] == (
        "true" if solo.was_overamplified else "false")
    rate, wav = wavfile.read(io.BytesIO(r.read()))
  pcm = service.synth.infer_serving(mel, seed=5, bucket_frames=BUCKET,
                                    pcm16=True)
  assert rate == 22050
  np.testing.assert_array_equal(wav, pcm.samples)
  assert client.synthesize_to_wav_bytes(mel, seed=5)[:4] == b"RIFF"
  # the library path of the same request: raw and denoised waveforms
  classic = service.synthesize_mel(mel, seed=5)
  assert classic.wav.shape == (11 * 256,)
  np.testing.assert_allclose(got, classic.wav_denoised, atol=1e-6)


def test_copy_synthesis(client, service):
  rng = np.random.default_rng(23)
  audio = (0.2 * rng.standard_normal(4096) * 32767).astype(np.int16)
  buf = io.BytesIO()
  wavfile.write(buf, service.sampling_rate, audio)
  got = client.copy_synthesize(buf.getvalue(), seed=4)
  mel = service.mel_op.get_mel(audio.astype(np.float32) / 32768.0).numpy()
  direct = service.synth.infer_serving(mel, seed=4, bucket_frames=BUCKET)
  np.testing.assert_array_equal(got, direct.samples)


def test_stream_reassembles_raw_and_denoised(client, service):
  """The client's pieces (int16 over the wire) reassemble to
  ``Synthesizer.stream``'s int16 pieces, raw and denoised, bit for bit; a
  denoised stream is hop-trimmed."""
  mel = rand_mel(30, seed=24)
  for strength in (0.0, 0.01):
    got = np.concatenate(list(client.stream(
        mel, seed=24, chunk_frames=4, denoiser_strength=strength)))
    direct = np.concatenate([p for _, p in service.synth.stream(
        mel, seed=24, chunk_frames=4, pcm16=True,
        denoiser_strength=strength)])
    assert got.shape == direct.shape == (30 * 256,)
    np.testing.assert_array_equal(np.round(got * 32768.0), direct)


@pytest.mark.parametrize("path,body,code,message", [
    ("/synthesize", b"not an npy file", 400, "ValueError"),
    ("/synthesize", npy(np.zeros((3, 10))), 400, "expected mel [80, frames]"),
    ("/synthesize?format=mp3", npy(np.zeros((80, 4))), 400, "format"),
    ("/synthesize-wav", None, 400, "expected 22050 Hz wav"),
    ("/reload", b'{"nope": 1}', 400, "checkpoint"),
    ("/reload", b'{"checkpoint": "/no/such/ckpt.npz"}', 400,
     "FileNotFoundError"),
    ("/nope", b"x", 404, "unknown path"),
    ("/synthesize", npy(np.zeros((80, MAX_FRAMES + 1))), 413,
     f"max_frames={MAX_FRAMES}"),
])
def test_error_statuses(base_url, path, body, code, message):
  if body is None:  # a 16 kHz wav
    buf = io.BytesIO()
    wavfile.write(buf, 16000, np.zeros(1600, np.int16))
    body = buf.getvalue()
  got, _, payload = http_error(base_url + path, body)
  assert got == code
  assert message in payload["error"]


def test_unknown_get_is_404_and_counts_as_an_error(base_url, service):
  before = service.snapshot_stats()["errors"]
  code, _, _ = http_error(base_url + "/nope")
  assert code == 404
  assert service.snapshot_stats()["errors"] == before + 1


def test_oversize_is_shed_not_an_error(base_url, service):
  before = service.snapshot_stats()
  code, _, _ = http_error(base_url + "/stream",
                          npy(np.zeros((80, MAX_FRAMES + 1))))
  assert code == 413
  after = service.snapshot_stats()
  assert after["rejected"] == before["rejected"] + 1
  assert after["errors"] == before["errors"]
  assert after["in_flight"] == 0


# -- admission control ---------------------------------------------------------

def test_saturated_daemon_sheds_with_503_and_recovers(base_url, service):
  rejected = service.snapshot_stats()["rejected"]
  with saturated(service):
    code, headers, payload = http_error(
        base_url + "/synthesize?format=npy", npy(rand_mel(10)))
  assert code == 503 and headers["Retry-After"] == "1"
  assert "overloaded" in payload["error"]
  assert service.snapshot_stats()["rejected"] == rejected + 1
  assert post_npy(base_url + "/synthesize?format=npy",
                  rand_mel(10)).shape == (10 * 256,)


def test_two_concurrent_requests_at_max_queue_1(base_url, service):
  """With ``max_queue=1``, a second request while the first is in flight
  (held at the device lock) gets 503; the first completes and the daemon
  serves again."""
  client = SynthesisClient(base_url, timeout_s=TIMEOUT_S, retries_503=0)
  max_queue, service.max_queue = service.max_queue, 1
  pool = concurrent.futures.ThreadPoolExecutor(1)
  try:
    with service._device_lock:
      first = pool.submit(client.synthesize, rand_mel(10, seed=1), seed=1)
      wait_for(lambda: service.in_flight() == 1)
      with pytest.raises(urllib.error.HTTPError) as e:
        client.synthesize(rand_mel(10, seed=2), seed=2)
      assert e.value.code == 503
      e.value.close()
    assert first.result(timeout=TIMEOUT_S).shape == (10 * 256,)
    assert client.synthesize(rand_mel(10, seed=3), seed=3).shape == (
        10 * 256,)
  finally:
    service.max_queue = max_queue
    pool.shutdown(wait=False)
  assert service.in_flight() == 0


def test_client_retries_503(base_url, service):
  """The client backs off on 503 and succeeds once the daemon has room;
  with its retries spent the 503 propagates."""
  client = SynthesisClient(base_url, timeout_s=TIMEOUT_S, retries_503=3)
  with service._inflight_lock:
    service._inflight += service.max_queue

  def unsaturate():
    with service._inflight_lock:
      service._inflight -= service.max_queue

  timer = threading.Timer(0.3, unsaturate)
  timer.start()
  try:
    wav = client.synthesize(rand_mel(10, seed=63), seed=63)
  finally:
    timer.join(timeout=TIMEOUT_S)
  assert not timer.is_alive()
  assert wav.shape == (10 * 256,)
  with saturated(service):
    with pytest.raises(urllib.error.HTTPError) as e:
      SynthesisClient(base_url, timeout_s=TIMEOUT_S,
                      retries_503=0).synthesize(rand_mel(10))
  assert e.value.code == 503
  e.value.close()


def test_drain_sheds_new_work():
  svc = new_service(max_batch=1)
  mel = rand_mel(10)
  assert svc.synthesize_mel_packed(mel).samples.shape == (10 * 256,)
  svc.begin_drain()
  with pytest.raises(ServerOverloadedError, match="draining"):
    svc.synthesize_mel_packed(mel)
  with pytest.raises(ServerOverloadedError, match="draining"):
    next(svc.stream_mel(mel))
  assert svc.in_flight() == 0
  assert svc.snapshot_stats()["rejected"] == 2


# -- micro-batching ------------------------------------------------------------

def test_requests_behind_a_busy_device_batch_together(base_url, service):
  """Six requests queued behind the held device lock dispatch as
  micro-batches; each response matches its solo call within 1e-5 (the
  rounding of differently shaped products)."""
  before = service.snapshot_stats()
  mels = [rand_mel(f, seed=s) for s, f in enumerate((10, 12, 9, 16, 10, 11))]
  with concurrent.futures.ThreadPoolExecutor(6) as pool:
    with service._device_lock:
      futs = [pool.submit(post_npy,
                          base_url + f"/synthesize?seed={s}&format=npy", m)
              for s, m in enumerate(mels)]
      wait_for(lambda: service.in_flight() == 6)
    wavs = [f.result(timeout=TIMEOUT_S) for f in futs]
  after = service.snapshot_stats()
  assert after["batches"] > before["batches"]
  assert after["batched_requests"] - before["batched_requests"] >= 2
  for s, (mel, wav) in enumerate(zip(mels, wavs)):
    solo = service.synth.infer_serving(mel, seed=s, bucket_frames=BUCKET)
    np.testing.assert_allclose(wav, solo.samples, atol=1e-5)


def test_warmup_runs_each_batch_size():
  svc = new_service(max_batch=4)
  report = svc.warmup([10])
  assert report["programs"] == 6  # (solo + 2 + 4) x (denoised + raw)
  assert report["seconds"] >= 0


# -- streams -------------------------------------------------------------------

def test_synthesize_completes_while_a_stream_is_open(service):
  pieces = service.stream_mel(rand_mel(40, seed=50), seed=50, chunk_frames=4)
  first = next(pieces)
  out = {}
  t = threading.Thread(target=lambda: out.update(res=(
      service.synthesize_mel_packed(rand_mel(10, seed=51), seed=51))),
                       daemon=True)
  t.start()
  t.join(timeout=TIMEOUT_S)
  assert not t.is_alive(), "synthesize blocked behind an open stream"
  assert out["res"].samples.shape == (10 * 256,)
  assert len(first) + sum(len(p) for p in pieces) == 40 * 256


def test_disconnect_mid_stream_releases_the_device(base_url, service):
  host, port = base_url.replace("http://", "").split(":")
  conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT_S)
  conn.request("POST", "/stream?seed=40&chunk_frames=4",
               body=npy(rand_mel(40, seed=40)))
  resp = conn.getresponse()
  resp.read(512)
  conn.close()
  assert post_npy(base_url + "/synthesize?seed=41&format=npy",
                  rand_mel(10, seed=41)).shape == (10 * 256,)
  wait_for(lambda: service.in_flight() == 0)


def test_aborted_stream_counts_its_audio():
  svc = new_service()
  before = svc.snapshot_stats()
  gen = svc.stream_mel(rand_mel(40, seed=3), chunk_frames=4)
  piece = next(gen)
  gen.close()
  after = svc.snapshot_stats()
  assert after["requests"] == before["requests"] + 1
  assert after["audio_seconds"] == pytest.approx(
      before["audio_seconds"] + len(piece) / svc.sampling_rate, abs=1e-3)
  assert svc.in_flight() == 0


def test_failure_mid_stream_truncates_without_http_garbage():
  svc = new_service()
  real_stream = svc.synth.stream

  def broken_stream(*args, **kw):
    gen = real_stream(*args, **kw)
    yield next(gen)
    gen.close()
    raise RuntimeError("injected device failure")

  svc.synth.stream = broken_stream
  with running(svc) as url:
    with post(url + "/stream?seed=1&chunk_frames=4",
              npy(rand_mel(40, seed=1))) as r:
      assert r.status == 200
      body = r.read()
    assert 0 < len(body) < 40 * 256 * 2 and len(body) % 2 == 0
    assert b"HTTP/1.1" not in body and b"error" not in body
    stats = svc.snapshot_stats()
    assert stats["errors"] == 1 and stats["requests"] == 0
    assert svc.in_flight() == 0
    svc.synth.stream = real_stream
    assert post_npy(url + "/synthesize?format=npy",
                    rand_mel(10)).shape == (10 * 256,)


# -- the client's stream length check ------------------------------------------

class _FakeDaemon(BaseHTTPRequestHandler):
  """/healthz with a hop of 300 and /stream with ``samples`` int16 samples
  in ``pcm_format``."""
  protocol_version = "HTTP/1.0"
  samples = 0
  pcm_format = "s16le"

  def log_message(self, fmt, *args):
    pass

  def do_GET(self):
    body = json.dumps({"status": "ok", "model": {"hop_length": 300}}).encode()
    self.send_response(200)
    self.send_header("Content-Length", str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def do_POST(self):
    self.rfile.read(int(self.headers["Content-Length"]))
    self.send_response(200)
    self.send_header("X-PCM-Format", self.pcm_format)
    self.end_headers()
    self.wfile.write(np.zeros(self.samples, "<i2").tobytes())


@pytest.mark.parametrize("samples,strength,pcm_format,ok", [
    (2400, None, "s16le", True),    # floor(2560 / 300) * 300 samples
    (2399, None, "s16le", False),
    (2400, 0.01, "s16le", True),
    (2400, 0.0, "s16le", False),    # raw: 10 frames x 256 = 2560 samples
    (2560, 0.0, "s16le", True),
    (2560, 0.0, "f32le", False),
])
def test_client_checks_the_stream_length_against_the_hop(
    samples, strength, pcm_format, ok):
  handler = type("Fake", (_FakeDaemon,), {"samples": samples,
                                          "pcm_format": pcm_format})
  httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  try:
    client = SynthesisClient(f"http://127.0.0.1:{httpd.server_port}",
                             timeout_s=TIMEOUT_S)
    stream = client.stream(rand_mel(10), denoiser_strength=strength)
    if ok:
      assert sum(len(p) for p in stream) == samples
    else:
      with pytest.raises(IOError):
        list(stream)
  finally:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=TIMEOUT_S)


# -- keep-alive ----------------------------------------------------------------

def _conn(base_url):
  host, port = base_url.replace("http://", "").split(":")
  return http.client.HTTPConnection(host, int(port), timeout=TIMEOUT_S)


def test_early_errors_close_the_connection(base_url, service):
  """A 400 or 503 sent before the body was read closes the keep-alive
  connection; one sent after it keeps the connection usable."""
  for saturate, query, code in ((False, "?format=mp3", 400),
                                (True, "", 503)):
    conn = _conn(base_url)
    try:
      with saturated(service) if saturate else contextlib.nullcontext():
        conn.request("POST", "/synthesize" + query, body=npy(rand_mel(10)))
        r = conn.getresponse()
        assert r.status == code
        assert r.headers.get("Connection", "").lower() == "close"
        r.read()
    finally:
      conn.close()
  conn = _conn(base_url)
  try:
    for _ in range(2):
      conn.request("POST", "/synthesize", body=npy(np.zeros((3, 10))))
      r = conn.getresponse()
      assert r.status == 400
      assert "expected mel" in json.loads(r.read())["error"]
      assert r.headers.get("Connection", "").lower() != "close"
  finally:
    conn.close()


# -- reload --------------------------------------------------------------------

def test_reload_swaps_npz_weights_and_refuses_torch(client, service,
                                                    tmp_path):
  mel = rand_mel(10, seed=70)
  before = client.synthesize(mel, seed=70)
  other = tiny_checkpoint(seed=9, iteration=580123)
  other.save(tmp_path / "other.npz")
  tiny_checkpoint(seed=1).save(tmp_path / "orig.npz")
  try:
    out = client.reload(tmp_path / "other.npz")
    assert out["status"] == "reloaded" and out["iteration"] == 580123
    assert np.abs(client.synthesize(mel, seed=70) - before).max() > 1e-4
    assert client.health()["model"]["iteration"] == 580123
  finally:
    client.reload(tmp_path / "orig.npz")
  np.testing.assert_array_equal(client.synthesize(mel, seed=70), before)
  assert client.stats()["reloads"] >= 2

  pt = tmp_path / "weights.pt"
  torch.save({"not": "a checkpoint"}, str(pt))
  with pytest.raises(urllib.error.HTTPError) as e:
    client.reload(pt)
  assert e.value.code == 400
  # refused by the pickle gate before anything is read
  assert "refusing to hot-swap a torch-format checkpoint" in json.loads(
      e.value.read())["error"]
  e.value.close()
  wide = tiny_checkpoint(n_channels="16")
  wide.save(tmp_path / "wide.npz")
  with pytest.raises(urllib.error.HTTPError) as e:
    client.reload(tmp_path / "wide.npz")
  assert "architecture" in json.loads(e.value.read())["error"]
  e.value.close()
  np.testing.assert_array_equal(client.synthesize(mel, seed=70), before)


def test_reload_takes_an_orbax_directory(client, tmp_path):
  """An orbax directory reloads as its npz twin does (it holds no code):
  the same samples after either reload."""
  from waveglow_tpu_torch.checkpointing import orbax_store
  mel = rand_mel(10, seed=71)
  other = tiny_checkpoint(seed=9, iteration=580124)
  other.save(tmp_path / "other.npz")
  path = orbax_store.save_sharded(tmp_path, 580124, other.state_dict, None,
                                  other.get_hparams())
  tiny_checkpoint(seed=1).save(tmp_path / "orig.npz")
  try:
    out = client.reload(path)
    assert out["status"] == "reloaded" and out["iteration"] == 580124
    from_orbax = client.synthesize(mel, seed=71)
    client.reload(tmp_path / "other.npz")
    np.testing.assert_array_equal(client.synthesize(mel, seed=71),
                                  from_orbax)
  finally:
    client.reload(tmp_path / "orig.npz")


def test_reload_during_concurrent_requests(tmp_path):
  """Raw requests racing a hot-swap each return the old or the new
  model's samples; the daemon ends idle."""
  svc = new_service()
  mel = rand_mel(10, seed=80)
  kw = dict(seed=80, denoiser_strength=0.0)
  old = svc.synthesize_mel_packed(mel, **kw).samples
  tiny_checkpoint(seed=9).save(tmp_path / "new.npz")
  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    futs = [pool.submit(svc.synthesize_mel_packed, mel, **kw)
            for _ in range(6)]
    svc.reload(str(tmp_path / "new.npz"))
    futs += [pool.submit(svc.synthesize_mel_packed, mel, **kw)
             for _ in range(6)]
    outs = [f.result(timeout=TIMEOUT_S).samples for f in futs]
  svc._batcher.close()
  new = svc.synth.infer_serving(mel, bucket_frames=BUCKET, **kw).samples
  assert np.abs(old - new).max() > 1e-4
  for out in outs:
    assert (np.allclose(out, old, atol=1e-5)
            or np.allclose(out, new, atol=1e-5))
  assert svc.in_flight() == 0


def test_sniff_and_load_checkpoint_as(tmp_path):
  tiny_checkpoint(seed=2, iteration=12).save(tmp_path / "c.npz")
  torch.save({"w": torch.zeros(2)}, str(tmp_path / "zip.pt"))
  torch.save({"w": torch.zeros(2)}, str(tmp_path / "legacy.pt"),
             _use_new_zipfile_serialization=False)
  from waveglow_tpu_torch.checkpointing import orbax_store
  from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
  npz = tiny_checkpoint(seed=2, iteration=12)
  orbax_store.save_sharded(tmp_path, 12, npz.state_dict, None,
                           npz.get_hparams())
  (tmp_path / "12.orbax").rename(tmp_path / "ckpt.orbax")
  assert sniff_checkpoint_format(tmp_path / "c.npz") == "npz"
  assert sniff_checkpoint_format(tmp_path / "zip.pt") == "torch"
  assert sniff_checkpoint_format(tmp_path / "legacy.pt") == "torch"
  assert sniff_checkpoint_format(tmp_path / "ckpt.orbax") == "orbax"
  assert load_checkpoint_as(tmp_path / "c.npz", "npz").iteration == 12
  with pytest.raises(ValueError, match="unrecognized torch checkpoint"):
    load_checkpoint_as(tmp_path / "zip.pt", "torch")
  orbax = load_checkpoint_as(tmp_path / "ckpt.orbax", "orbax")
  assert orbax.iteration == 12 and orbax.hparams == npz.hparams
  for a, b in zip(tree_leaves(orbax.state_dict), tree_leaves(npz.state_dict)):
    np.testing.assert_array_equal(a, b)
  with pytest.raises(ValueError, match="unknown checkpoint format"):
    load_checkpoint_as(tmp_path / "c.npz", "exotic")
  with pytest.raises(KeyError):  # a swapped file fails as npz, unpickled
    load_checkpoint_as(tmp_path / "zip.pt", "npz")


# -- stats ---------------------------------------------------------------------

def test_stage_times_are_there_when_the_response_arrives(base_url, service):
  """The handler records its stages before it writes the response: the
  moment the body is in, /stats counts this request's stages."""
  def counts():
    stages = service.snapshot_stats().get("stages_ms", {})
    return {k: stages.get(k, {}).get("n", 0)
            for k in ("read", "parse", "service", "serialize",
                      "queue_wait", "submit", "device_fetch")}

  before = counts()
  post_npy(base_url + "/synthesize?seed=1&format=npy", rand_mel(10, seed=1))
  after = counts()
  assert all(after[k] == before[k] + 1 for k in after), (before, after)
  stages = service.snapshot_stats()["stages_ms"]
  assert all(stages[k]["mean"] >= 0 for k in after)


def test_metrics_prometheus_format(client):
  client.synthesize(rand_mel(10, seed=71), seed=71)
  text = client.metrics()
  assert "# TYPE waveglow_requests_total counter" in text
  assert "# TYPE waveglow_request_latency_seconds summary" in text
  assert "# TYPE waveglow_request_stage_seconds gauge" in text
  assert 'waveglow_request_stage_seconds{stage="service",quantile="0.5"}' \
      in text
  values = dict(line.rsplit(" ", 1) for line in text.splitlines()
                if line and not line.startswith("#") and "{" not in line)
  assert float(values["waveglow_requests_total"]) >= 1
  assert float(values["waveglow_audio_seconds_total"]) > 0
  assert float(values["waveglow_in_flight"]) == 0
  stats = client.stats()
  assert 0 < stats["latency_s"]["p50"] <= stats["latency_s"]["p99"]


def test_chunked_daemon_matches_infer_serving(service):
  svc = new_service(chunk_frames=4)
  assert svc._batcher is None
  with running(svc) as url:
    got = post_npy(url + "/synthesize?seed=9&format=npy", rand_mel(30, seed=9))
  ref = service.synth.infer_serving(rand_mel(30, seed=9), seed=9,
                                    bucket_frames=BUCKET).samples
  np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


# -- the contract against the JAX daemon ---------------------------------------

def _exchange(url):
  """What a client can observe of a daemon: /healthz and /stats keys after
  one request, metric names, a /synthesize response's headers and the
  status codes of the error paths."""
  seen = {}
  with urllib.request.urlopen(url + "/healthz", timeout=TIMEOUT_S) as r:
    health = json.loads(r.read())
  seen["healthz"] = {k: sorted(v) if isinstance(v, dict) else v is None
                     for k, v in health.items()}
  with post(url + "/synthesize?seed=3", npy(rand_mel(10, seed=3))) as r:
    r.read()
    seen["headers"] = sorted(k for k in r.headers if k.startswith("X-"))
    seen["type"] = r.headers["Content-Type"]
  with post(url + "/synthesize?seed=3&format=npy",
            npy(rand_mel(10, seed=3))) as r:
    r.read()
    seen["npy_type"] = r.headers["Content-Type"]
  with urllib.request.urlopen(url + "/stats", timeout=TIMEOUT_S) as r:
    stats = json.loads(r.read())
  seen["stats"] = sorted(stats)
  seen["latency"] = sorted(stats["latency_s"])
  seen["stages"] = {k: sorted(v) for k, v in stats["stages_ms"].items()}
  with urllib.request.urlopen(url + "/metrics", timeout=TIMEOUT_S) as r:
    seen["metrics_type"] = r.headers["Content-Type"]
    text = r.read().decode()
  seen["metrics"] = sorted({line.split()[2] for line in text.splitlines()
                            if line.startswith("# TYPE")})
  seen["codes"] = [
      http_error(url + "/synthesize", b"garbage")[0],
      http_error(url + "/nope")[0],
      http_error(url + "/synthesize", npy(np.zeros((80, MAX_FRAMES + 1))))[0],
      http_error(url + "/reload", b'{"nope": 1}')[0]]
  return seen


def test_contract_matches_the_jax_daemon(tmp_path):
  """The JAX and the port daemons on one npz (max_batch=1: solo requests):
  the same /healthz and /stats keys (the port's model block adds
  ``hop_length``, which its client reads), metric names, headers and
  status codes, and a 503 from each when saturated."""
  tiny_checkpoint(seed=1).save(tmp_path / "c.npz")
  port = SynthesisService(CheckpointWaveglow.load(tmp_path / "c.npz"),
                          bucket_frames=BUCKET, max_frames=MAX_FRAMES,
                          max_batch=1, device="cpu")
  jax = jax_server.SynthesisService(JaxCkpt.load(tmp_path / "c.npz"),
                                    bucket_frames=BUCKET,
                                    max_frames=MAX_FRAMES, max_batch=1)
  seen = {}
  for name, svc, make in (("port", port, make_server),
                          ("jax", jax, jax_server.make_server)):
    with running(svc, make) as url:
      seen[name] = _exchange(url)
      with saturated(svc):
        seen[name]["saturated"] = http_error(
            url + "/synthesize", npy(rand_mel(10)))[0]
  assert seen["port"]["healthz"]["model"] == sorted(
      seen["jax"]["healthz"]["model"] + ["hop_length"])
  del seen["port"]["healthz"]["model"], seen["jax"]["healthz"]["model"]
  assert seen["port"] == seen["jax"]
  assert seen["port"]["codes"] == [400, 404, 413, 400]
  assert seen["port"]["saturated"] == 503
  assert set(seen["port"]["stages"]) == {"read", "parse", "service",
                                         "serialize"}
  assert server.MAX_BODY_BYTES == jax_server.MAX_BODY_BYTES
