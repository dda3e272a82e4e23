"""The port's batched synthesis (``inference/serving.py``) and
``MelSTFT.get_mel``: ``BatchSynthesizer.infer_many`` against the port's
masked ``infer`` at the same row seeds, its order, trimming and input
checks; the masked ``infer`` on a padded batch of three lengths against the
JAX package's ``infer(noise=, true_frames=)``; ``get_mel`` against the JAX
one. Tiny config (5 flows, 3 layers, 32 channels), every ``end`` conv
randomised."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveglow_tpu.dsp.mel import MelSTFT as JaxMelSTFT
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu_torch.checkpointing.from_jax import params_from_numpy
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.dsp.audio_io import wav_to_float32
from waveglow_tpu_torch.dsp.mel import CLIP_VAL, MelSTFT
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.inference.serving import BatchSynthesizer
from waveglow_tpu_torch.inference.synthesizer import row_seeds
from waveglow_tpu_torch.models.waveglow import (WaveGlowConfig, infer,
                                                infer_noise_shapes,
                                                init_params)

TINY = {"n_flows": "5", "n_layers": "3", "n_channels": "32"}
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "audio.wav"


def tiny_checkpoint(seed=0, iteration=100, end_scale=0.1, **overrides):
  """A port checkpoint of the tiny config (or ``overrides`` of it) with
  every ``end`` conv randomised; the JAX package loads its npz."""
  hp = overwrite_custom_hparams(HParams(), {**TINY, **overrides})
  params = init_params(WaveGlowConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 100)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * end_scale).astype(
        np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * end_scale).astype(
        np.float32)
  return CheckpointWaveglow.from_params(params, hp, iteration=iteration)


@pytest.fixture(scope="module")
def ckpt():
  return tiny_checkpoint()


@pytest.fixture(scope="module")
def batch_synth(ckpt):
  return BatchSynthesizer(ckpt, device="cpu")


def rand_mel(frames, seed=0):
  return np.random.default_rng(seed).standard_normal(
      (80, frames)).astype(np.float32)


def masked_infer(synth, mels, seeds, true_frames):
  with torch.inference_mode():
    return infer(synth.params, synth.config, mels, seed=seeds,
                 true_frames=true_frames, device="cpu").numpy()


def test_infer_many_is_bucket_exact(batch_synth):
  """Each row equals the port's masked ``infer`` of its bucket batch at the
  same row seeds, bit for bit, and the unpadded solo call with its row
  seed, bit for bit (the masked pad rows change no kept sample)."""
  lengths = [10, 33, 10, 17, 5]
  mels = [rand_mel(f, seed=f + i) for i, f in enumerate(lengths)]
  outs = batch_synth.infer_many(mels, seed=7, bucket_frames=16)
  seeds = row_seeds(7, len(mels))
  floor = float(np.log(CLIP_VAL))
  for bucket, idxs in ((16, [0, 2, 4]), (32, [3]), (48, [1])):
    batch = np.full((len(idxs), 80, bucket), floor, np.float32)
    for row, i in enumerate(idxs):
      batch[row, :, :lengths[i]] = mels[i]
    ref = masked_infer(batch_synth, batch, [seeds[i] for i in idxs],
                       [lengths[i] for i in idxs])
    for row, i in enumerate(idxs):
      np.testing.assert_array_equal(outs[i], ref[row, :lengths[i] * 256])
  for i, mel in enumerate(mels):
    solo = masked_infer(batch_synth, mel[None], [seeds[i]], None)[0]
    np.testing.assert_array_equal(outs[i], solo)


def test_infer_many_keeps_order_and_trims(batch_synth):
  lengths = [10, 33, 10, 64, 17]
  mels = [rand_mel(f, seed=f) for f in lengths]
  outs = batch_synth.infer_many(mels, seed=0, bucket_frames=16)
  assert [o.shape for o in outs] == [(f * 256,) for f in lengths]
  assert all(np.isfinite(o).all() for o in outs)
  for a, b in zip(outs, batch_synth.infer_many(mels, seed=0,
                                               bucket_frames=16)):
    np.testing.assert_array_equal(a, b)
  # reversed input order, reversed rows: request i keeps row seed i
  back = batch_synth.infer_many(mels[::-1], seed=0, bucket_frames=16)
  seeds = row_seeds(0, len(mels))
  for j, out in enumerate(back):
    i = len(mels) - 1 - j
    solo = masked_infer(batch_synth, mels[i][None], [seeds[j]], None)[0]
    np.testing.assert_array_equal(out, solo)


def test_max_batch_sub_groups_draw_distinct_noise(batch_synth):
  """Five copies of one mel at max_batch=2 (sub-groups of 2, 2 and 1):
  every output differs from every other, and each equals the solo call at
  its request's row seed."""
  mel = rand_mel(12, seed=3)
  outs = batch_synth.infer_many([mel] * 5, seed=4, bucket_frames=4,
                                max_batch=2)
  for a in range(5):
    for b in range(a + 1, 5):
      assert np.abs(outs[a] - outs[b]).max() > 1e-3, (a, b)
  for i, seed in enumerate(row_seeds(4, 5)):
    solo = masked_infer(batch_synth, mel[None], [seed], None)[0]
    np.testing.assert_allclose(outs[i], solo, atol=1e-5)


@pytest.mark.parametrize("kwargs,match", [
    ({"bucket_frames": 0}, "bucket_frames"),
    ({"max_batch": 0}, "max_batch"),
    ({"max_batch": -1}, "max_batch"),
])
def test_infer_many_rejects_bad_arguments(batch_synth, kwargs, match):
  with pytest.raises(ValueError, match=match):
    batch_synth.infer_many([rand_mel(4)], **kwargs)


def test_infer_many_rejects_an_empty_mel(batch_synth):
  with pytest.raises(ValueError, match="mel 1 has no frames"):
    batch_synth.infer_many([rand_mel(4), np.zeros((80, 0), np.float32)])


def test_infer_batch_and_chunked(batch_synth):
  """infer_batch row b is the solo call at row seed b; infer_chunked
  matches one-call synthesis (windows of 4 frames plus the halo)."""
  mels = np.stack([rand_mel(9, seed=s) for s in range(3)])
  wav = batch_synth.infer_batch(mels, seed=5)
  assert wav.shape == (3, 9 * 256)
  for b, seed in enumerate(row_seeds(5, 3)):
    solo = masked_infer(batch_synth, mels[b:b + 1], [seed], None)[0]
    np.testing.assert_allclose(wav[b], solo, atol=1e-5)
  long_mel = rand_mel(70, seed=8)
  chunked = batch_synth.infer_chunked(long_mel, seed=2, chunk_frames=4)
  one = masked_infer(batch_synth, long_mel[None], [2], None)[0]
  assert chunked.shape == one.shape == (70 * 256,)
  np.testing.assert_allclose(chunked, one, atol=1e-5 * np.abs(one).max())


def test_infer_long_raises_without_a_time_mesh(batch_synth):
  with pytest.raises(ValueError, match="'time' axis"):
    batch_synth.infer_long(rand_mel(8))


def test_masked_infer_matches_jax_with_injected_noise(ckpt):
  """Three rows of 7, 5 and 3 frames padded to 8 with the silence floor:
  the port's masked ``infer`` and the JAX ``infer(noise=, true_frames=)``
  on the same params and noise, atol 2e-4 (the synthesizer tests')."""
  hp = overwrite_custom_hparams(HParams(), TINY)
  config = WaveGlowConfig.from_hparams(hp)
  lengths = [7, 5, 3]
  mels = np.full((3, 80, 8), float(np.log(CLIP_VAL)), np.float32)
  for row, f in enumerate(lengths):
    mels[row, :, :f] = rand_mel(f, seed=20 + row)
  rng = np.random.default_rng(21)
  noise = [rng.standard_normal(s).astype(np.float32)
           for s in infer_noise_shapes(config, 3, 8 * 32)]
  with torch.inference_mode():
    got = infer(params_from_numpy(ckpt.state_dict, "cpu"), config, mels,
                noise=noise, true_frames=lengths, device="cpu").numpy()
  jax_config = jax_model.WaveGlowConfig.from_hparams(
      jax_overwrite(JaxHParams(), TINY))
  ref = np.asarray(jax_model.infer(
      jax_model.fuse_for_inference(ckpt.state_dict), jax_config,
      jnp.asarray(mels), noise=[jnp.asarray(n) for n in noise],
      true_frames=jnp.asarray(lengths, jnp.int32)))
  assert got.shape == ref.shape == (3, 8 * 256)
  np.testing.assert_allclose(got, ref, atol=2e-4)
  unmasked = np.asarray(jax_model.infer(
      jax_model.fuse_for_inference(ckpt.state_dict), jax_config,
      jnp.asarray(mels), noise=[jnp.asarray(n) for n in noise]))
  assert np.abs(unmasked[2, :3 * 256] - ref[2, :3 * 256]).max() > 1e-3


def test_get_mel_matches_jax():
  """The whole fixture (9.6 s, 826 frames): log-mel within 5e-3 absolute,
  the mel itself within 2e-6. The DFT and mel products sum in another
  order; near the 1e-5 clamp the log turns that absolute rounding into a
  relative one (2.6e-3 at worst on this file)."""
  wav, _ = wav_to_float32(FIXTURE)
  ref = np.asarray(JaxMelSTFT(JaxHParams()).get_mel(wav))
  got = MelSTFT(HParams(), device="cpu").get_mel(wav).numpy()
  assert got.shape == ref.shape == (80, 826)
  np.testing.assert_allclose(got, ref, atol=5e-3)
  np.testing.assert_allclose(np.exp(got), np.exp(ref), atol=2e-6)
  assert ref.max() - ref.min() > 5
