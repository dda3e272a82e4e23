"""The port's synthesis (``models.waveglow.infer``) against the JAX package's
on shared weights and injected noise, bucket exactness, and the port's
position-keyed noise. Tiny config: 5 flows (one early-noise emission at
flow 4), 3 layers, 64 channels; every ``end`` conv randomised."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu_torch.checkpointing.from_jax import params_from_numpy
from waveglow_tpu_torch.kernels.wn_layer import wn_layer_plain
from waveglow_tpu_torch.models import waveglow as port_model

CFG = dict(n_flows=5, n_layers=3, n_channels=64)


def infer_cpu(*args, **kwargs):
  return port_model.infer(*args, device="cpu", **kwargs)


def randomize_end(params, seed):
  rng = np.random.default_rng(seed)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.1).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.1).astype(np.float32)
  return params


@pytest.fixture(scope="module")
def model():
  jcfg = jax_model.WaveGlowConfig(**CFG)
  pcfg = port_model.WaveGlowConfig(**CFG)
  params = randomize_end(jax_model.init_params(jcfg, seed=0), seed=1)
  return (jcfg, jax_model.fuse_for_inference(params), pcfg,
          params_from_numpy(params, "cpu"))


def mel_and_noise(cfg, frames, seed=0):
  rng = np.random.default_rng(seed)
  mel = rng.standard_normal((1, 80, frames)).astype(np.float32)
  shapes = jax_model.infer_noise_shapes(cfg, 1, frames * 32)
  noise = [rng.standard_normal(s).astype(np.float32) for s in shapes]
  return mel, noise


def test_init_and_noise_shapes_match_jax(model):
  jcfg, _, pcfg, _ = model
  assert pcfg.flow_channel_counts() == jcfg.flow_channel_counts()
  assert (port_model.infer_noise_shapes(pcfg, 2, 64)
          == jax_model.infer_noise_shapes(jcfg, 2, 64))
  a = jax_model.init_params(jcfg, seed=3)
  b = port_model.init_params(pcfg, seed=3)
  np.testing.assert_array_equal(a["flows"][4]["wn"]["in_layers"][2]["v"],
                                b["flows"][4]["wn"]["in_layers"][2]["v"])
  np.testing.assert_array_equal(a["upsample"]["w"], b["upsample"]["w"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_infer_f32_matches_jax(model, use_pallas):
  jcfg, jparams, pcfg, pparams = model
  mel, noise = mel_and_noise(jcfg, 6)
  ref = np.asarray(jax_model.infer(
      jparams, jcfg, jnp.asarray(mel), sigma=0.8,
      noise=[jnp.asarray(n) for n in noise], use_pallas=use_pallas))
  out = infer_cpu(pparams, pcfg, torch.from_numpy(mel), sigma=0.8,
                  noise=noise).numpy()
  assert out.shape == ref.shape == (1, 6 * 256)
  assert np.abs(ref).max() > 0.1  # the couplings are not the identity
  np.testing.assert_allclose(out, ref, atol=2e-4)


def test_infer_bf16_matches_jax(model):
  """bf16 differs from JAX's XLA body by where intermediates round to bf16
  (the port keeps pre, the gate and rs in f32); bound 5e-2 of the waveform
  scale."""
  jcfg, jparams, pcfg, pparams = model
  mel, noise = mel_and_noise(jcfg, 6, seed=1)
  ref = np.asarray(jax_model.infer(
      jparams, jcfg, jnp.asarray(mel), noise=[jnp.asarray(n) for n in noise],
      compute_dtype=jnp.bfloat16))
  out = infer_cpu(pparams, pcfg, torch.from_numpy(mel), noise=noise,
                  compute_dtype=torch.bfloat16).numpy()
  assert np.abs(out - ref).max() <= 5e-2 * np.abs(ref).max()


def test_bf16_weights_stored_once(model):
  """``params_for_compute`` stores the matrices in bf16 once: synthesis from
  them equals synthesis from f32 params cast on every call, every layer
  call gets what the kernel takes on the card (f32 x and biases, bf16 cond
  and weights), and the result is not the f32 one."""
  _, _, pcfg, pparams = model
  mel, noise = mel_and_noise(pcfg, 4, seed=5)
  bf16, f32 = torch.bfloat16, torch.float32
  stored = port_model.params_for_compute(pparams, bf16)
  assert port_model.params_for_compute(pparams, None) is pparams
  assert stored["flows"][0]["wn"]["in_layers"][0]["w"].dtype == bf16
  assert stored["flows"][0]["wn"]["in_layers"][0]["b"].dtype == f32
  seen = []

  def spy(x, cond, w_in, b_in, w_rs, b_rs, *args, **kwargs):
    seen.append(tuple(a.dtype for a in (x, cond, w_in, b_in, w_rs, b_rs)))
    return wn_layer_plain(x, cond, w_in, b_in, w_rs, b_rs, *args, **kwargs)

  out = infer_cpu(stored, pcfg, torch.from_numpy(mel), noise=noise,
                  compute_dtype=bf16, layer=spy).numpy()
  assert seen == [(f32, bf16, bf16, f32, bf16, f32)] * (
      pcfg.n_flows * pcfg.n_layers)
  per_call = infer_cpu(pparams, pcfg, torch.from_numpy(mel), noise=noise,
                       compute_dtype=bf16).numpy()
  np.testing.assert_array_equal(out, per_call)
  full = infer_cpu(pparams, pcfg, torch.from_numpy(mel), noise=noise).numpy()
  assert np.abs(out - full).max() > 1e-4 * np.abs(full).max()


def test_kernel_wrapper_and_plain_layer_agree_on_cpu(model):
  _, _, pcfg, pparams = model
  mel, noise = mel_and_noise(pcfg, 4, seed=2)
  a = infer_cpu(pparams, pcfg, torch.from_numpy(mel), noise=noise)
  b = infer_cpu(pparams, pcfg, torch.from_numpy(mel), noise=noise,
                layer=wn_layer_plain)
  np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_bucket_padded_kept_samples_bit_equal(model, dtype):
  """A mel padded with silence frames plus ``true_frames`` gives kept
  samples equal to the unpadded call: the noise is position-keyed and WN
  residual rows past the true length are zeroed."""
  _, _, pcfg, pparams = model
  mel, _ = mel_and_noise(pcfg, 5, seed=3)
  padded = np.concatenate(
      [mel, np.full((1, 80, 3), np.log(1e-5), np.float32)], axis=-1)
  ref = infer_cpu(pparams, pcfg, torch.from_numpy(mel), seed=11,
                  compute_dtype=dtype).numpy()
  out = infer_cpu(pparams, pcfg, torch.from_numpy(padded), seed=11,
                  compute_dtype=dtype, true_frames=5).numpy()
  np.testing.assert_array_equal(out[:, :5 * 256], ref)
  unmasked = infer_cpu(pparams, pcfg, torch.from_numpy(padded),
                       seed=11, compute_dtype=dtype).numpy()
  assert not np.array_equal(unmasked[:, :5 * 256], ref)  # the mask matters


def test_per_row_true_frames_and_seeds(model):
  """A micro-batch with per-row seeds, sigmas and true lengths equals each
  row run alone."""
  _, _, pcfg, pparams = model
  mel, _ = mel_and_noise(pcfg, 6, seed=4)
  mel2 = np.concatenate([mel, mel[..., ::-1]], axis=0).copy()
  batch = infer_cpu(pparams, pcfg, torch.from_numpy(mel2),
                    seed=[5, 9], sigma=torch.tensor([1.0, 0.5]),
                    true_frames=torch.tensor([6, 4])).numpy()
  for row, (seed, sigma, tf) in enumerate([(5, 1.0, 6), (9, 0.5, 4)]):
    solo = infer_cpu(pparams, pcfg, torch.from_numpy(mel2[row:row + 1]),
                     seed=seed, sigma=sigma, true_frames=tf).numpy()
    np.testing.assert_allclose(batch[row], solo[0], atol=1e-5)


def test_block_noise_is_position_keyed():
  cfg = port_model.WaveGlowConfig(**CFG)
  full = port_model.block_noise([7, 8], cfg, 0, 96, torch.device("cpu"))
  window = port_model.block_noise([7, 8], cfg, 32, 40, torch.device("cpu"))
  solo = port_model.block_noise(8, cfg, 0, 96, torch.device("cpu"))
  assert [tuple(z.shape) for z in full] == [(2, 96, 6), (2, 96, 2)]
  for f, w, s in zip(full, window, solo):
    np.testing.assert_array_equal(f[:, 32:72].numpy(), w.numpy())
    np.testing.assert_array_equal(f[1:].numpy(), s.numpy())
  # distinct seeds and tensors draw distinct values; the values are
  # standard normal
  assert not torch.equal(full[0][0], full[0][1])
  assert not torch.equal(full[0][0, :, :2], full[1][0])
  big = port_model.block_noise(3, cfg, 0, 20000, torch.device("cpu"))[0]
  assert abs(big.mean().item()) < 0.02 and abs(big.std().item() - 1) < 0.02


def test_infer_defaults_to_the_card(model, monkeypatch):
  _, _, pcfg, pparams = model
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  mel, noise = mel_and_noise(pcfg, 2)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    port_model.infer(pparams, pcfg, torch.from_numpy(mel), noise=noise)
