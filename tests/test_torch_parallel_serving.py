"""Sharded serving in the port, on the CPU: ``BatchSynthesizer``,
``Synthesizer`` and the HTTP daemon with ``mesh=`` over ``["cpu"] * n``,
against the port's unsharded classes, mirroring the JAX package's mesh
tests (``tests/test_serving.py::TestBatchSynthesizer``,
``test_mesh_row_padding``, ``tests/test_server.py::TestMeshServing`` and
its data-mesh ``serve`` test).

Bounds: the data axis bit for bit by row group (each group runs the
unsharded program on its rows), the time axis bit for bit (spans with
halos), the model axis at 1e-5 of max |wav| (the res/skip product summed
over the ranks in another order). Tiny config (5 flows, 3 layers, 32
channels), every ``end`` conv randomised. Every HTTP call, wait and join
carries its own timeout.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_server import TIMEOUT_S, post, post_npy, running
from tests.test_torch_serving import tiny_checkpoint
from waveglow_tpu_torch.cli import main as cli_main
from waveglow_tpu_torch.inference import server
from waveglow_tpu_torch.inference.client import SynthesisClient
from waveglow_tpu_torch.inference.serving import BatchSynthesizer
from waveglow_tpu_torch.inference.server import SynthesisService
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models.waveglow import infer_noise_shapes
from waveglow_tpu_torch.parallel import mesh as mesh_lib

BUCKET = 16
TP_TOL_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def cpu_mesh(data=1, model=1):
  return mesh_lib.make_mesh(data, model, devices=["cpu"] * (data * model))


def time_mesh(n):
  return mesh_lib.make_time_mesh(n, devices=["cpu"] * n)


def rand_mels(batch, frames, seed=0):
  return np.random.default_rng(seed).standard_normal(
      (batch, 80, frames)).astype(np.float32)


@pytest.fixture(scope="module")
def ckpt():
  return tiny_checkpoint(seed=1)


@pytest.fixture(scope="module")
def plain_batch(ckpt):
  return BatchSynthesizer(ckpt, device="cpu")


@pytest.fixture(scope="module")
def plain_synth(ckpt):
  return Synthesizer(ckpt, device="cpu")


def close(got, ref, rel=TP_TOL_REL):
  scale = np.abs(ref).max()
  assert scale > 0.1
  assert np.abs(got - ref).max() <= rel * scale


# -- BatchSynthesizer -------------------------------------------------------------

@pytest.mark.parametrize("data", [2, 4])
def test_data_mesh_rows_equal_unsharded_row_groups(ckpt, plain_batch, data):
  """Each device's rows bit for bit an unsharded call on those rows (the
  row seeds of the whole batch), and the batch close to the unsharded
  4-row call."""
  mels = rand_mels(4, 12, seed=data)
  sharded = BatchSynthesizer(ckpt, mesh=cpu_mesh(data))
  got = sharded.infer_batch(mels, seed=3)
  seeds = [3 + (b << 32) for b in range(4)]
  n = 4 // data
  for g in range(data):
    rows = slice(g * n, (g + 1) * n)
    ref = plain_batch._infer(mels[rows], 1.0, seeds[rows])
    np.testing.assert_array_equal(got[rows], ref)
  close(got, plain_batch.infer_batch(mels, seed=3))
  with pytest.raises(ValueError, match="does not split"):
    sharded.infer_batch(rand_mels(data + 1, 12), seed=3)


def test_mesh_row_padding(ckpt, plain_batch):
  """3 utterances on a 4-way data mesh: the bucket batch is padded to 4
  rows by repeating the last, the repeat dropped; every row as the
  unsharded ``infer_many`` gives it."""
  sharded = BatchSynthesizer(ckpt, mesh=cpu_mesh(4))
  mels = [rand_mels(1, f, seed=f)[0] for f in (12, 9, 11)]
  outs = sharded.infer_many(mels, seed=2, bucket_frames=4)
  refs = plain_batch.infer_many(mels, seed=2, bucket_frames=4)
  assert [len(o) for o in outs] == [12 * 256, 9 * 256, 11 * 256]
  for out, ref in zip(outs, refs):
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 2)])
def test_model_mesh_batch_matches_unsharded(ckpt, plain_batch, data, model):
  mels = rand_mels(2, 12, seed=model)
  tp = BatchSynthesizer(ckpt, mesh=cpu_mesh(data, model))
  assert isinstance(tp.params, list) and len(tp.params) == model
  w = tp.params[0]["flows"][0]["wn"]["in_layers"][0]["w"]
  assert w.shape[-1] == 32 // model       # the WN channels really are cut
  close(tp.infer_batch(mels, seed=5), plain_batch.infer_batch(mels, seed=5))


@pytest.mark.parametrize("frames,n", [(40, 4), (37, 4), (3, 4)])
def test_infer_long_is_the_unsharded_call(ckpt, plain_batch, frames, n):
  mel = rand_mels(1, frames, seed=frames)[0]
  got = BatchSynthesizer(ckpt, mesh=time_mesh(n)).infer_long(mel, seed=7)
  np.testing.assert_array_equal(
      got, plain_batch.infer_batch(mel[None], seed=7)[0])
  with pytest.raises(ValueError, match="'time' axis"):
    BatchSynthesizer(ckpt, mesh=cpu_mesh(2)).infer_long(mel)


def test_device_and_mesh_must_agree(ckpt):
  BatchSynthesizer(ckpt, device="cpu", mesh=cpu_mesh(2))
  with pytest.raises(ValueError, match="first device"):
    BatchSynthesizer(ckpt, device="cuda", mesh=cpu_mesh(2))


# -- Synthesizer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_synths(ckpt):
  return {"data": Synthesizer(ckpt, mesh=cpu_mesh(2)),
          "model": Synthesizer(ckpt, mesh=cpu_mesh(1, 4)),
          "data_model": Synthesizer(ckpt, mesh=cpu_mesh(2, 2)),
          "time": Synthesizer(ckpt, mesh=time_mesh(4))}


def test_synthesizer_data_mesh_serving_many(mesh_synths, plain_synth):
  """4 requests of one bucket run as one 4-row micro-batch split over 2
  devices: each row group bit for bit the unsharded 2-row call."""
  synth = mesh_synths["data"]
  mels = [rand_mels(1, 12, seed=i)[0] for i in range(4)]
  seeds = [10, 11, 12, 13]
  got = synth.infer_serving_many(mels, seeds=seeds, bucket_frames=BUCKET,
                                 max_batch=4)
  for g in range(2):
    refs = plain_synth.infer_serving_many(
        mels[2 * g:2 * g + 2], seeds=seeds[2 * g:2 * g + 2],
        bucket_frames=BUCKET, max_batch=2)
    for res, ref in zip(got[2 * g:2 * g + 2], refs):
      np.testing.assert_array_equal(res.samples, ref.samples)
      assert res.was_overamplified == ref.was_overamplified
  # a solo request does not divide over the data axis: the first device
  solo = synth.infer_serving(mels[0], seed=3, bucket_frames=BUCKET)
  np.testing.assert_array_equal(
      solo.samples,
      plain_synth.infer_serving(mels[0], seed=3,
                                bucket_frames=BUCKET).samples)


@pytest.mark.parametrize("which", ["model", "data_model"])
def test_synthesizer_model_mesh_paths(mesh_synths, plain_synth, which,
                                     monkeypatch):
  """The serving path, a micro-batch, the classic ``infer`` (raw and
  denoised) and ``stream`` through the tensor-parallel stack: close to the
  unsharded Synthesizer, every WN layer through the shard layer (its plain
  version on the CPU), none through the full layer."""
  calls = {"shard": 0, "full": 0}

  def counted(name, fn):
    def wrapper(*args, **kwargs):
      calls[name] += 1
      return fn(*args, **kwargs)
    return wrapper

  monkeypatch.setattr(kl, "wn_layer_shard_plain",
                      counted("shard", kl.wn_layer_shard_plain))
  monkeypatch.setattr(kl, "wn_layer_plain", counted("full", kl.wn_layer_plain))
  synth = mesh_synths[which]
  mel = rand_mels(1, 14, seed=8)[0]
  got = synth.infer_serving(mel, seed=8, bucket_frames=BUCKET, pcm16=False)
  model = synth.mesh.size("model")
  assert calls == {"shard": 5 * 3 * model, "full": 0}
  close(got.samples, plain_synth.infer_serving(
      mel, seed=8, bucket_frames=BUCKET).samples)
  mels = [rand_mels(1, 12, seed=i)[0] for i in range(4)]
  for res, ref in zip(
      synth.infer_serving_many(mels, seeds=[1, 2, 3, 4],
                               bucket_frames=BUCKET),
      plain_synth.infer_serving_many(mels, seeds=[1, 2, 3, 4],
                                     bucket_frames=BUCKET)):
    close(res.samples, ref.samples)
  res = synth.infer(mel, seed=8)
  ref = plain_synth.infer(mel, seed=8)
  close(res.wav, ref.wav)
  close(res.wav_denoised, ref.wav_denoised)
  got = np.concatenate([p for _, p in synth.stream(mel, seed=8,
                                                   chunk_frames=4)])
  ref = np.concatenate([p for _, p in plain_synth.stream(mel, seed=8,
                                                         chunk_frames=4)])
  close(got, ref)


def test_synthesizer_time_mesh_is_bit_for_bit(mesh_synths, plain_synth):
  synth = mesh_synths["time"]
  mel = rand_mels(1, 37, seed=9)[0]
  res = synth.infer(mel, seed=4)
  ref = plain_synth.infer(mel, seed=4)
  np.testing.assert_array_equal(res.wav, ref.wav)
  np.testing.assert_array_equal(res.wav_denoised, ref.wav_denoised)
  got = synth.infer_serving(mel, seed=4, bucket_frames=BUCKET, pcm16=True)
  np.testing.assert_array_equal(
      got.samples, plain_synth.infer_serving(mel, seed=4,
                                             bucket_frames=BUCKET,
                                             pcm16=True).samples)
  noise = [np.random.default_rng(1).standard_normal(s).astype(np.float32)
           for s in infer_noise_shapes(synth.config, 1, 37 * 32)]
  np.testing.assert_array_equal(synth.infer(mel, noise=noise).wav,
                                plain_synth.infer(mel, noise=noise).wav)


def test_update_params_reshards(ckpt, mesh_synths):
  synth = mesh_synths["data_model"]
  mel = rand_mels(1, 12, seed=2)[0]
  before = synth.infer_serving(mel, seed=1, bucket_frames=BUCKET).samples
  other = tiny_checkpoint(seed=9, iteration=900)
  try:
    assert synth.update_params(other) == 900
    assert all(len(group) == 2 for group in synth._place.groups)
    after = synth.infer_serving(mel, seed=1, bucket_frames=BUCKET).samples
    close(after, Synthesizer(other, device="cpu").infer_serving(
        mel, seed=1, bucket_frames=BUCKET).samples)
    assert np.abs(after - before).max() > 1e-3
  finally:
    synth.update_params(ckpt)


# -- the daemon over HTTP ------------------------------------------------------------

def test_mesh_daemon_health_bodies_and_reload(ckpt, plain_synth, tmp_path):
  """A (2, 2) daemon on 127.0.0.1: ``/healthz`` reads the mesh, solo
  bodies equal the in-process mesh Synthesizer's, a burst micro-batches,
  and ``/reload`` re-shards the new weights."""
  svc = SynthesisService(ckpt, bucket_frames=BUCKET, max_batch=4,
                         batch_window_ms=50.0, mesh=cpu_mesh(2, 2))
  path = tmp_path / "other.npz"
  tiny_checkpoint(seed=9, iteration=4242).save(path)
  try:
    with running(svc) as url:
      client = SynthesisClient(url, timeout_s=TIMEOUT_S)
      assert client.health()["mesh"] == {"data": 2, "model": 2}
      mel = rand_mels(1, 12, seed=4)[0]
      wav = post_npy(url + "/synthesize?seed=4&format=npy", mel)
      np.testing.assert_array_equal(wav, svc.synth.infer_serving(
          mel, seed=4, bucket_frames=BUCKET).samples)
      close(wav, plain_synth.infer_serving(mel, seed=4,
                                           bucket_frames=BUCKET).samples)
      status, body = post_reload(url, path)
      assert status == 200 and body["iteration"] == 4242
      assert all(len(g) == 2 for g in svc.synth._place.groups)
      wav2 = post_npy(url + "/synthesize?seed=4&format=npy", mel)
      assert np.abs(wav2 - wav).max() > 1e-3   # the new weights show
  finally:
    svc._batcher.close()


def post_reload(url, path):
  import json
  with post(url + "/reload", json.dumps({"checkpoint": str(path)}).encode()
            ) as r:
    return r.status, json.loads(r.read())


def test_time_mesh_daemon(ckpt, plain_synth):
  svc = SynthesisService(ckpt, bucket_frames=BUCKET, max_batch=1,
                         mesh=time_mesh(4))
  with running(svc) as url:
    client = SynthesisClient(url, timeout_s=TIMEOUT_S)
    assert client.health()["mesh"] == {"time": 4}
    mel = rand_mels(1, 45, seed=6)[0]
    wav = post_npy(url + "/synthesize?seed=6&format=npy", mel)
    np.testing.assert_array_equal(wav, plain_synth.infer_serving(
        mel, seed=6, bucket_frames=BUCKET).samples)


def test_serve_command_builds_a_mesh_service(tmp_path, monkeypatch):
  calls = []
  monkeypatch.setattr(server, "serve_forever",
                      lambda service, host, port, **kw: calls.append(service))
  path = tmp_path / "t.npz"
  tiny_checkpoint().save(path)
  log = tmp_path / "log.txt"
  try:
    assert cli_main.run(["serve", str(path), "--device", "cpu",
                         "--mesh-data", "2", "--mesh-model", "2",
                         "--log", str(log)]) == 0
    service, = calls
    assert service.health()["mesh"] == {"data": 2, "model": 2}
    assert cli_main.run(["serve", str(path), "--device", "cpu",
                         "--mesh-time", "2", "--mesh-model", "2",
                         "--log", str(log)]) == 1
    assert "mutually exclusive" in log.read_text()
  finally:
    for service in calls:
      if service._batcher is not None:
        service._batcher.close()
