"""The port's Synthesizer and npz checkpoints against the JAX package's:
checkpoint interchange both ways, injected-noise synthesis and denoising,
the serving paths, hot swap and the device rule. Tiny config, every ``end``
conv randomised."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.inference.synthesizer import Synthesizer as JaxSynth
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import infer_noise_shapes
from waveglow_tpu.models.waveglow import init_params as jax_init
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.checkpointing.store import flatten_tree
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.models.waveglow import infer as port_infer

TINY = {"n_flows": "5", "n_layers": "3", "n_channels": "32"}


def tiny_jax_checkpoint(seed=0, iteration=500, **overrides):
  hp = jax_overwrite(JaxHParams(), {**TINY, **overrides})
  params = jax_init(JaxConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 100)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.1).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.1).astype(np.float32)
  return JaxCkpt(state_dict=params, optimizer=[np.arange(3.0)],
                 learning_rate=hp.learning_rate, iteration=iteration,
                 hparams=asdict(hp))


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
  path = tmp_path_factory.mktemp("ckpt") / "500.npz"
  tiny_jax_checkpoint().save(path)
  return path


@pytest.fixture(scope="module")
def synth(ckpt_path):
  return Synthesizer(CheckpointWaveglow.load(ckpt_path), device="cpu")


def rand_mel(frames, seed=0):
  return np.random.default_rng(seed).standard_normal(
      (80, frames)).astype(np.float32)


def assert_trees_equal(a, b):
  fa, fb = flatten_tree(a), flatten_tree(b)
  assert fa.keys() == fb.keys()
  for k in fa:
    np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_checkpoints_interchange(ckpt_path, tmp_path):
  jax_ck = JaxCkpt.load(ckpt_path)
  port_ck = CheckpointWaveglow.load(ckpt_path)
  assert_trees_equal(port_ck.state_dict, jax_ck.state_dict)
  assert port_ck.hparams == jax_ck.hparams
  assert port_ck.iteration == 500
  np.testing.assert_array_equal(port_ck.optimizer[0], np.arange(3.0))
  assert port_ck.get_hparams().n_flows == 5

  port_ck.save(tmp_path / "600.npz")
  back = JaxCkpt.load(tmp_path / "600.npz")
  assert_trees_equal(back.state_dict, jax_ck.state_dict)
  assert back.hparams == jax_ck.hparams
  assert back.learning_rate == jax_ck.learning_rate
  np.testing.assert_array_equal(back.optimizer[0], np.arange(3.0))


def test_infer_matches_jax_synthesizer(ckpt_path, synth):
  jax_synth = JaxSynth(JaxCkpt.load(ckpt_path))
  # the denoiser's bias capture (sigma 0, 88 zero frames) first
  ref_bias = np.asarray(jax_synth.denoiser.bias_spec)
  bias = synth.denoiser.bias_spec.numpy()
  assert bias.shape == ref_bias.shape == (1, 513, 1)
  np.testing.assert_allclose(bias, ref_bias, atol=1e-4 * np.abs(ref_bias).max())

  mel = rand_mel(7, seed=1)
  rng = np.random.default_rng(2)
  noise = [rng.standard_normal(s).astype(np.float32)
           for s in infer_noise_shapes(JaxConfig.from_hparams(
               jax_synth.hparams), 1, 7 * 32)]
  ref = jax_synth.infer(mel, noise=noise, denoiser_strength=0.05)
  out = synth.infer(mel, noise=noise, denoiser_strength=0.05)
  assert out.wav.shape == ref.wav.shape == (7 * 256,)
  assert out.sampling_rate == ref.sampling_rate
  np.testing.assert_allclose(out.wav, ref.wav, atol=2e-4)
  np.testing.assert_allclose(out.wav_denoised, ref.wav_denoised, atol=2e-4)
  assert not np.allclose(out.wav, out.wav_denoised)  # the denoiser acted
  assert out.was_overamplified == ref.was_overamplified


def test_bf16_synthesizer(ckpt_path, synth):
  """bf16 serving synthesizes in bf16 (from weights stored once in bf16)
  and denoises with the f32 model's bias, as the JAX Synthesizer does."""
  fast = Synthesizer(CheckpointWaveglow.load(ckpt_path),
                     compute_dtype="bfloat16", device="cpu")
  np.testing.assert_array_equal(fast.denoiser.bias_spec.numpy(),
                                synth.denoiser.bias_spec.numpy())
  wn = fast.params["flows"][0]["wn"]
  assert wn["in_layers"][0]["w"].dtype == torch.bfloat16
  mel = rand_mel(6, seed=6)
  rng = np.random.default_rng(3)
  noise = [rng.standard_normal(s).astype(np.float32)
           for s in infer_noise_shapes(JaxConfig.from_hparams(
               jax_overwrite(JaxHParams(), TINY)), 1, 6 * 32)]
  out = fast.infer(mel, noise=noise, denoiser_strength=0.0).wav
  ref = port_infer(synth.params, synth.config, mel[None], noise=noise,
                   compute_dtype=torch.bfloat16, device="cpu")[0].numpy()
  np.testing.assert_array_equal(out, ref)
  full = synth.infer(mel, noise=noise, denoiser_strength=0.0).wav
  assert np.abs(out - full).max() > 1e-4 * np.abs(full).max()


def test_serving_equals_infer_and_pcm16(synth):
  mel = rand_mel(5, seed=3)
  base = synth.infer(mel, seed=4, bucket_frames=4)
  f32 = synth.infer_serving(mel, seed=4, bucket_frames=4)
  pcm = synth.infer_serving(mel, seed=4, bucket_frames=4, pcm16=True)
  assert f32.samples.shape == pcm.samples.shape == (5 * 256,)
  np.testing.assert_allclose(f32.samples, base.wav_denoised, atol=1e-6)
  assert pcm.samples.dtype == np.int16
  np.testing.assert_array_equal(
      pcm.samples,
      np.round(np.clip(f32.samples, -1, 1) * 32767.0).astype(np.int16))
  assert f32.was_overamplified == base.was_overamplified


def test_serving_many_rows_match_solo_calls(synth):
  """Rows of a micro-batch (per-row seed, sigma, strength, true length)
  match the solo calls; batched and solo products may round differently,
  bound 1e-5."""
  mels = [rand_mel(f, seed=f) for f in (6, 5, 6, 3, 6)]
  seeds = [1, 2, 3, 4, 5]
  sigmas = [1.0, 0.7, 0.9, 1.0, 0.5]
  strengths = [0.01, 0.0, 0.02, 0.01, 0.01]
  many = synth.infer_serving_many(mels, seeds=seeds, sigma=sigmas,
                                  denoiser_strength=strengths,
                                  bucket_frames=4, max_batch=2)
  for mel, s, g, k, res in zip(mels, seeds, sigmas, strengths, many):
    solo = synth.infer_serving(mel, seed=s, sigma=g, denoiser_strength=k,
                               bucket_frames=4)
    assert res.samples.shape == solo.samples.shape == (mel.shape[-1] * 256,)
    np.testing.assert_allclose(res.samples, solo.samples, atol=1e-5)
  with pytest.raises(ValueError, match="seeds"):
    synth.infer_serving_many(mels, seeds=[1])


def test_update_params(ckpt_path, synth, tmp_path):
  mel = rand_mel(4, seed=5)
  before = synth.infer(mel, seed=1).wav
  other = tiny_jax_checkpoint(seed=9, iteration=900)
  other.save(tmp_path / "900.npz")
  wider = tiny_jax_checkpoint(n_channels="64")
  wider.save(tmp_path / "wide.npz")
  with pytest.raises(ValueError, match="architecture"):
    synth.update_params(CheckpointWaveglow.load(tmp_path / "wide.npz"))
  try:
    assert synth.update_params(
        CheckpointWaveglow.load(tmp_path / "900.npz")) == 900
    assert not np.array_equal(synth.infer(mel, seed=1).wav, before)
  finally:
    synth.update_params(CheckpointWaveglow.load(ckpt_path))
  np.testing.assert_array_equal(synth.infer(mel, seed=1).wav, before)


def test_entry_points_default_to_the_card(ckpt_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  ck = CheckpointWaveglow.load(ckpt_path)
  for device in (None, "cuda"):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      Synthesizer(ck, device=device)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    Synthesizer(ck)
