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


def test_stft_transform_and_inverse():
  audio = rand(2, 4096) * 0.3
  ref_op = jax_stft.STFT(1024, 256, 1024, "hann")
  op = port_stft.STFT(1024, 256, 1024, "hann")
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
