"""The port's ops (conv, inv1x1, weight-norm fold, STFT) against the JAX
package's, on the same numpy inputs, float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveglow_tpu.dsp import stft as jax_stft
from waveglow_tpu.models import weightnorm as jax_weightnorm
from waveglow_tpu.ops import conv as jax_conv
from waveglow_tpu.ops import inv1x1 as jax_inv1x1
from waveglow_tpu_torch.dsp import stft as port_stft
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.models import weightnorm as port_weightnorm
from waveglow_tpu_torch.ops import conv as port_conv
from waveglow_tpu_torch.ops import inv1x1 as port_inv1x1

RNG = np.random.default_rng(0)


def rand(*shape):
  return RNG.standard_normal(shape).astype(np.float32)


def t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def test_conv1x1():
  x, w, b = rand(2, 30, 12), rand(12, 20), rand(20)
  ref = jax_conv.conv1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
  out = port_conv.conv1x1(t(x), t(w), t(b))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_conv1x1_bf16_f32_out():
  x, w, b = rand(2, 30, 12), rand(12, 20), rand(20)
  ref = jax_conv.conv1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         compute_dtype=jnp.bfloat16, out_dtype=jnp.float32)
  out = port_conv.conv1x1(t(x), t(w), t(b), compute_dtype=torch.bfloat16,
                          out_dtype=torch.float32)
  assert out.dtype == torch.float32
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("offset", [-7, -1, 0, 3, 40])
def test_shift_time(offset):
  x = rand(2, 25, 4)
  ref = jax_conv.shift_time(jnp.asarray(x), offset) if abs(offset) < 25 \
      else jnp.zeros_like(x)
  np.testing.assert_array_equal(port_conv.shift_time(t(x), offset).numpy(),
                                np.asarray(ref))


def dilated_pair(k, dilation, t_len, seed):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((2, t_len, 6)).astype(np.float32)
  w = (rng.standard_normal((k, 6, 5)) / np.sqrt(6 * k)).astype(np.float32)
  b = rng.standard_normal(5).astype(np.float32)
  return x, w, b


# T: just past the farthest tap (half * d + 1, under the conv's full reach
# (K - 1) * d wherever that exceeds it), and longer than the reach
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dilation", [1, 2, 7])
@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_dilated_conv_matches_jax(k, dilation, long, bf16):
  """f32: 1e-5; bf16 operands and result: 2e-2 of max|ref| (the sum of K
  bf16 products, rounded at other points)."""
  t_len = 40 if long else (k // 2) * dilation + 1
  x, w, b = dilated_pair(k, dilation, t_len, seed=k * 10 + dilation)
  cdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
  ref = np.asarray(jax_conv.dilated_conv(
      jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=dilation,
      compute_dtype=cdt[0]).astype(jnp.float32))
  out = port_conv.dilated_conv(t(x), t(w), t(b), dilation=dilation,
                               compute_dtype=cdt[1])
  assert out.shape == (2, t_len, 5)
  assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
  bound = 2e-2 * np.abs(ref).max() if bf16 else 1e-5
  np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=bound)


@pytest.mark.parametrize("k,dilation,t_len", [(3, 7, 3), (5, 4, 6),
                                              (3, 1, 1)])
def test_dilated_conv_taps_past_both_ends_read_zeros(k, dilation, t_len):
  """Taps farther than T away read zeros, as torch ``Conv1d(padding=d *
  (K-1) // 2)`` pads (the JAX function needs T >= (K//2) * d): 1e-5."""
  x, w, b = dilated_pair(k, dilation, t_len, seed=3)
  ref = torch.nn.functional.conv1d(
      t(x).transpose(1, 2), t(w).permute(2, 1, 0), t(b),
      padding=dilation * (k - 1) // 2, dilation=dilation).transpose(1, 2)
  out = port_conv.dilated_conv(t(x), t(w), t(b), dilation=dilation)
  torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_dilated_conv_bf16_f32_out():
  x, w, b = dilated_pair(3, 2, 30, seed=4)
  ref = jax_conv.dilated_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              dilation=2, compute_dtype=jnp.bfloat16,
                              out_dtype=jnp.float32)
  out = port_conv.dilated_conv(t(x), t(w), t(b), dilation=2,
                               compute_dtype=torch.bfloat16,
                               out_dtype=torch.float32)
  assert out.dtype == torch.float32
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("k", [2, 4])
def test_dilated_conv_refuses_even_kernels(k):
  """An even K has no centred tap: a ValueError (the JAX function's bare
  assert vanishes under ``python -O``)."""
  x, w, _ = dilated_pair(k, 1, 10, seed=5)
  with pytest.raises(ValueError, match="odd"):
    port_conv.dilated_conv(t(x), t(w))


def test_conv_transpose1d():
  x, w, b = rand(2, 5, 6), rand(6, 32, 3), rand(3)
  ref = jax_conv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), stride=8)
  out = port_conv.conv_transpose1d(t(x), t(w), t(b), stride=8)
  assert out.shape == (2, (5 - 1) * 8 + 32, 3)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
  # torch's own ConvTranspose1d agrees (weight [Cin, Cout, K])
  ref_t = torch.nn.functional.conv_transpose1d(
      t(x).transpose(1, 2), t(w).permute(0, 2, 1), t(b), stride=8)
  np.testing.assert_allclose(out.numpy(), ref_t.transpose(1, 2).numpy(),
                             atol=1e-5)


def test_inv1x1_reverse():
  w = port_inv1x1.init_orthonormal(np.random.default_rng(3), 8)
  np.testing.assert_array_equal(
      w, jax_inv1x1.init_orthonormal(np.random.default_rng(3), 8))
  w_inv = port_inv1x1.inverse_matrix(w)
  np.testing.assert_array_equal(w_inv, jax_inv1x1.inverse_matrix(w))
  z = rand(2, 17, 8)
  ref = jax_inv1x1.reverse(jnp.asarray(z), jnp.asarray(w_inv))
  out = port_inv1x1.reverse(t(z), t(w_inv))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("shape,out_ndim", [((3, 16, 2, 16), 2),
                                            ((16, 32), 1)])
def test_weightnorm_fuse(shape, out_ndim):
  conv = jax_weightnorm.init_weightnorm(rand(*shape), out_ndim)
  conv["g"] = conv["g"] * 1.7
  conv["b"] = rand(*shape[-out_ndim:])
  ref = jax_weightnorm.fuse(conv)
  out = port_weightnorm.fuse(conv)
  assert out.keys() == ref.keys()
  for k in ref:
    np.testing.assert_array_equal(out[k], ref[k])


@pytest.mark.parametrize("make", [MelSTFT, port_stft.STFT],
                         ids=["MelSTFT", "STFT"])
def test_mel_and_stft_default_to_the_card(make):
  """With no device they go to the card, and raise naming device='cpu'
  where there is none."""
  if torch.cuda.is_available():
    assert make().device.type == "cuda"
  else:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      make()


def test_stft_transform_and_inverse():
  audio = rand(2, 4096) * 0.3
  ref_op = jax_stft.STFT(1024, 256, 1024, "hann")
  op = port_stft.STFT(1024, 256, 1024, "hann", device="cpu")
  mag_r, ph_r = ref_op.transform(jnp.asarray(audio))
  mag, ph = op.transform(t(audio))
  np.testing.assert_allclose(mag.numpy(), np.asarray(mag_r), atol=2e-4)
  # phase is ill-conditioned where the magnitude vanishes: compare the
  # complex spectrum instead
  np.testing.assert_allclose((mag * torch.cos(ph)).numpy(),
                             np.asarray(mag_r * jnp.cos(ph_r)), atol=2e-4)
  inv_r = ref_op.inverse(mag_r, ph_r)
  inv = op.inverse(mag, ph)
  assert inv.shape == inv_r.shape == (2, 4096)
  np.testing.assert_allclose(inv.numpy(), np.asarray(inv_r), atol=1e-4)
  np.testing.assert_allclose(inv.numpy(), audio, atol=1e-4)  # round trip


def test_window_sumsquare_matches():
  np.testing.assert_array_equal(
      port_stft.window_sumsquare_np("hann", 9, 256, 1024, 1024),
      jax_stft.window_sumsquare_np("hann", 9, 256, 1024, 1024))


def test_inverse_envelope_cache_is_bounded():
  """Forty distinct frame counts keep at most ``ENV_CACHE_SIZE`` envelopes
  on the device, and a reused STFT inverts as a fresh one does."""
  op = port_stft.STFT(1024, 256, 1024, "hann", device="cpu")
  for n_frames in range(3, 43):
    spec = t(np.abs(rand(1, 513, n_frames)))
    phase = t(rand(1, 513, n_frames))
    out = op.inverse(spec, phase)
    assert len(op._inv_env) <= port_stft.ENV_CACHE_SIZE
    fresh = port_stft.STFT(1024, 256, 1024, "hann", device="cpu")
    assert torch.equal(out, fresh.inverse(spec, phase))
  assert len(op._inv_env) == port_stft.ENV_CACHE_SIZE
  assert list(op._inv_env) == list(range(43 - port_stft.ENV_CACHE_SIZE, 43))


def test_overlap_add_matches_jax():
  frames = rand(2, 7, 1024)
  np.testing.assert_array_equal(
      port_stft.overlap_add(t(frames), 256).numpy(),
      np.asarray(jax_stft.overlap_add(jnp.asarray(frames), 256)))
  with pytest.raises(ValueError, match="multiple of the hop"):
    port_stft.overlap_add(t(rand(1, 3, 1000)), 256)


@pytest.mark.parametrize("n", [1, 2, 256, 512, 513, 3000])
def test_reflect_pad_matches_numpy(n):
  audio = rand(2, n)
  np.testing.assert_array_equal(
      port_stft.reflect_pad(t(audio), 512).numpy(),
      np.pad(audio, ((0, 0), (512, 512)), mode="reflect"))


def test_stft_of_audio_shorter_than_half_a_window():
  """256 samples (one mel frame): the reflect pad repeats, as the JAX
  package's ``jnp.pad`` does."""
  audio = rand(1, 256) * 0.3
  ref_op = jax_stft.STFT(1024, 256, 1024, "hann")
  op = port_stft.STFT(1024, 256, 1024, "hann", device="cpu")
  mag_r, ph_r = ref_op.transform(jnp.asarray(audio))
  mag, ph = op.transform(t(audio))
  np.testing.assert_allclose(mag.numpy(), np.asarray(mag_r), atol=2e-4)
  inv = op.inverse(mag, ph)
  assert inv.shape == (1, 256)
  np.testing.assert_allclose(inv.numpy(), np.asarray(
      ref_op.inverse(mag_r, ph_r)), atol=1e-4)
