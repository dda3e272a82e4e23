"""The port's chunked synthesis (``inference/streaming.py``) and
``Synthesizer.infer(chunk_frames=)`` / ``Synthesizer.stream``: the halo
against the JAX package's, one window against the JAX ``infer`` on the same
inputs, and the streamed pieces against the port's one-call synthesis.
Tiny config (4 flows, 2 layers, 32 channels: a 5-frame halo), every ``end``
conv randomised."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.inference import streaming as jax_streaming
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu_torch.checkpointing.from_jax import params_from_numpy
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.inference import streaming
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.kernels.wn_layer import wn_layer_fused
from waveglow_tpu_torch.models import waveglow as port_model

CFG = dict(n_flows=4, n_layers=2, n_channels=32)
CHUNK = 4                        # window = 4 + 2 * 5 = 14 frames
# Streamed against one-call, relative to max |wav|: f32 differs only by the
# rounding of matrix products of other shapes; in bf16 such a difference
# can flip the rounding of a bf16 value, which the 4 flows amplify.
STREAM_TOL = {"f32": 1e-5, "bf16": 1e-3}
DTYPES = {"f32": None, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch, as the training files pin: the suite
  runs its files in parallel worker processes."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def tiny_params(seed=0):
  """Numpy params of the tiny config with every ``end`` conv randomised."""
  params = port_model.init_params(port_model.WaveGlowConfig(**CFG), seed=seed)
  rng = np.random.default_rng(seed + 100)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.2).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.05).astype(np.float32)
  return params


@pytest.fixture(scope="module")
def model():
  params = tiny_params()
  pparams = params_from_numpy(params, "cpu")
  return params, port_model.WaveGlowConfig(**CFG), {
      "f32": pparams,
      "bf16": port_model.params_for_compute(pparams, torch.bfloat16)}


def rand_mel(frames, seed=0, batch=1):
  return np.random.default_rng(seed).standard_normal(
      (batch, 80, frames)).astype(np.float32)


def one_call(model, mel, mode, seed, **kwargs):
  _, cfg, params = model
  return port_model.infer(params[mode], cfg, mel, seed=seed,
                          compute_dtype=DTYPES[mode], device="cpu",
                          **kwargs).numpy()


def streamed(model, mel, mode, seed, **kwargs):
  _, cfg, params = model
  kwargs.setdefault("chunk_frames", CHUNK)
  pieces = list(streaming.stream_chunks(
      params[mode], cfg, mel, seed=seed, compute_dtype=DTYPES[mode],
      device="cpu", **kwargs))
  pos = 0
  for start, piece in pieces:   # contiguous, in order
    assert start == pos
    pos += piece.shape[-1]
  return torch.cat([p for _, p in pieces], dim=1).numpy(), len(pieces)


@pytest.mark.parametrize("overrides", [
    {}, {"n_flows": "4", "n_layers": "2"},
    {"n_flows": "6", "n_layers": "5", "n_group": "4"}],
    ids=["default", "4x2", "6x5-group4"])
def test_receptive_halo_matches_jax(overrides):
  from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
  jcfg = jax_model.WaveGlowConfig.from_hparams(
      jax_overwrite(JaxHParams(), overrides))
  pcfg = port_model.WaveGlowConfig.from_hparams(
      overwrite_custom_hparams(HParams(), overrides))
  got = streaming.receptive_halo_frames(pcfg)
  assert got == jax_streaming.receptive_halo_frames(jcfg)
  if not overrides:
    assert got == 100  # 12 flows x 8 layers: a 456-frame window at chunk 256


@pytest.mark.parametrize("start,true_frames", [(7, None), (16, 27)],
                         ids=["interior", "masked-tail"])
def test_one_window_matches_jax(model, start, true_frames):
  """A window's synthesis as ``stream_chunks`` runs it (the mel slice, the
  window's position-keyed noise, ``clip(true_frames - start, 0, window)``)
  through the port's ``infer`` and the JAX ``infer`` on the same inputs."""
  params, cfg, pparams = model
  window = CHUNK + 2 * streaming.receptive_halo_frames(cfg)
  mel = rand_mel(30, seed=1)
  if true_frames is not None:
    mel[..., true_frames:] = np.log(1e-5)
  mel_w = mel[..., start:start + window]
  noise = [n.numpy() for n in port_model.block_noise(
      3, cfg, start * 32, window * 32, torch.device("cpu"))]
  tf_w = (None if true_frames is None
          else int(np.clip(true_frames - start, 0, window)))
  out = port_model.infer(pparams["f32"], cfg, mel_w, sigma=0.9, noise=noise,
                         true_frames=tf_w, device="cpu").numpy()
  jcfg = jax_model.WaveGlowConfig(**CFG)
  ref = np.asarray(jax_model.infer(
      jax_model.fuse_for_inference(params), jcfg, jnp.asarray(mel_w),
      sigma=0.9, noise=[jnp.asarray(n) for n in noise], true_frames=tf_w))
  assert out.shape == ref.shape == (1, window * 256)
  assert np.abs(ref).max() > 0.1  # the couplings are not the identity
  np.testing.assert_allclose(out, ref, atol=2e-4)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("frames,windows", [(9, 1), (14, 1), (31, 8)],
                         ids=["short", "one-window", "ragged"])
def test_stream_matches_one_call(model, mode, frames, windows):
  """Shorter than a window (padded and masked), exactly a window, and 8
  windows whose last chunk is 3 frames: the pieces reassemble to the
  one-call synthesis with the same seed."""
  mel = rand_mel(frames, seed=frames)
  ref = one_call(model, mel, mode, seed=5)
  out, n_pieces = streamed(model, mel, mode, seed=5)
  assert n_pieces == windows
  assert out.shape == ref.shape == (1, frames * 256)
  assert np.abs(out - ref).max() <= STREAM_TOL[mode] * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_bucket_padded_stream_keeps_unpadded_samples(model, mode):
  mel = rand_mel(27, seed=2)
  padded = np.concatenate(
      [mel, np.full((1, 80, 5), np.log(1e-5), np.float32)], axis=-1)
  ref = one_call(model, mel, mode, seed=6)
  out, _ = streamed(model, padded, mode, seed=6, true_frames=27)
  assert out.shape == (1, 32 * 256)
  kept = out[:, :27 * 256]
  assert np.abs(kept - ref).max() <= STREAM_TOL[mode] * np.abs(ref).max()
  unmasked, _ = streamed(model, padded, mode, seed=6)
  assert np.abs(unmasked[:, :27 * 256] - ref).max() > (
      STREAM_TOL[mode] * np.abs(ref).max())  # the mask matters


def test_rows_keep_their_seeds(model):
  mel = rand_mel(20, seed=3, batch=2)
  ref = one_call(model, mel, "f32", seed=[4, 9])
  out, _ = streamed(model, mel, "f32", seed=[4, 9])
  np.testing.assert_allclose(out, ref, atol=STREAM_TOL["f32"] * np.abs(
      ref).max())
  assert not np.allclose(out[0], out[1])


def test_halo_too_small_diverges(model):
  """With a 1-frame halo the windows miss context: the comparison above
  can see a wrong window."""
  mel = rand_mel(31, seed=4)
  ref = one_call(model, mel, "f32", seed=7)
  bad, _ = streamed(model, mel, "f32", seed=7, halo_frames=1)
  assert np.abs(bad - ref).max() > 1e-2 * np.abs(ref).max()


def test_each_window_runs_every_layer_once(model):
  _, cfg, params = model
  calls = []

  def counting_layer(*args, **kwargs):
    calls.append(args[0].shape[1])
    return wn_layer_fused(*args, **kwargs)

  mel = rand_mel(31, seed=5)
  pieces = list(streaming.stream_chunks(params["f32"], cfg, mel,
                                        chunk_frames=CHUNK,
                                        layer=counting_layer, device="cpu"))
  assert len(pieces) == 8
  assert len(calls) == 8 * cfg.n_flows * cfg.n_layers
  assert set(calls) == {14 * 32}  # every window has the same shape


def test_pcm16_pieces_equal_the_host_conversion(model):
  _, cfg, params = model
  mel = rand_mel(20, seed=6)
  kwargs = dict(chunk_frames=CHUNK, seed=1, sigma=3.0, device="cpu")
  floats = list(streaming.stream_chunks(params["f32"], cfg, mel, **kwargs))
  pcm = list(streaming.stream_chunks(params["f32"], cfg, mel, pcm16=True,
                                     **kwargs))
  assert [s for s, _ in pcm] == [s for s, _ in floats]
  wav = torch.cat([p for _, p in floats], dim=1).numpy()
  got = torch.cat([p for _, p in pcm], dim=1).numpy()
  assert got.dtype == np.int16
  assert np.abs(wav).max() > 1.0  # some samples clip
  np.testing.assert_array_equal(
      got, np.round(np.clip(wav, -1, 1) * 32767.0).astype(np.int16))


def test_chunk_frames_below_one_raises(model):
  _, cfg, params = model
  with pytest.raises(ValueError, match="chunk_frames"):
    streaming.stream_chunks(params["f32"], cfg, rand_mel(5), chunk_frames=0,
                            device="cpu")


# -- the Synthesizer ---------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
  hp = overwrite_custom_hparams(HParams(), {k: str(v) for k, v in CFG.items()})
  path = tmp_path_factory.mktemp("ckpt") / "1.npz"
  CheckpointWaveglow.from_params(tiny_params(seed=1), hp,
                                 iteration=1).save(path)
  return Synthesizer(CheckpointWaveglow.load(path), device="cpu")


def test_infer_chunked_equals_one_call(synth):
  mel = rand_mel(30, seed=7)[0]
  ref = synth.infer(mel, seed=2, denoiser_strength=0.01)
  out = synth.infer(mel, seed=2, denoiser_strength=0.01, chunk_frames=CHUNK)
  assert out.wav.shape == ref.wav.shape == (30 * 256,)
  scale = np.abs(ref.wav).max()
  assert np.abs(out.wav - ref.wav).max() <= STREAM_TOL["f32"] * scale
  assert np.abs(out.wav_denoised - ref.wav_denoised).max() <= (
      STREAM_TOL["f32"] * scale)


def test_infer_chunked_composes_with_buckets(synth):
  mel = rand_mel(27, seed=8)[0]
  ref = synth.infer(mel, seed=3, denoiser_strength=0.0).wav
  out = synth.infer(mel, seed=3, denoiser_strength=0.0, chunk_frames=CHUNK,
                    bucket_frames=16).wav
  assert out.shape == ref.shape == (27 * 256,)
  assert np.abs(out - ref).max() <= STREAM_TOL["f32"] * np.abs(ref).max()


@pytest.mark.parametrize("pcm16", [False, True])
def test_stream_reassembles_to_chunked_infer(synth, pcm16):
  mel = rand_mel(30, seed=9)[0]
  ref = synth.infer(mel, seed=4, denoiser_strength=0.0,
                    chunk_frames=CHUNK).wav
  pieces = list(synth.stream(mel, seed=4, chunk_frames=CHUNK, pcm16=pcm16))
  assert len(pieces) == 8
  assert all(isinstance(p, np.ndarray) and p.ndim == 1 for _, p in pieces)
  out = np.concatenate([p for _, p in pieces])
  if pcm16:
    ref = np.round(np.clip(ref, -1, 1) * 32767.0).astype(np.int16)
  np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("frames", [1, 9, 30])
def test_denoised_stream_reassembles_to_wav_denoised(synth, frames):
  """One window (the denoiser's one-shot fallback; one frame is shorter
  than half an STFT window) and 8 windows (one denoise block a window):
  the pieces reassemble to ``wav_denoised`` trimmed to the frame-aligned
  length."""
  mel = rand_mel(frames, seed=10)[0]
  ref = synth.infer(mel, seed=5, denoiser_strength=0.01).wav_denoised
  out = np.concatenate([p for _, p in synth.stream(
      mel, seed=5, chunk_frames=CHUNK, denoiser_strength=0.01)])
  assert out.shape == ref.shape == (frames * 256,)
  assert np.abs(out - ref).max() <= STREAM_TOL["f32"] * np.abs(ref).max()
  raw = synth.infer(mel, seed=5, denoiser_strength=0.0).wav
  assert np.abs(out - raw).max() > 1e-4  # the denoiser acted


def test_stream_takes_one_utterance(synth):
  with pytest.raises(ValueError, match="one utterance"):
    synth.stream(rand_mel(10, batch=2))
