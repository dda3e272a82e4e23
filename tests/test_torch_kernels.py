"""The port's WN layer (plain version, and the kernel wrapper on CPU tensors)
against the JAX package: its Pallas kernel in interpret mode (f32, and bf16 with
bf16 operands), and its XLA layer body. Same numpy inputs to both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveglow_tpu.kernels.wn_layer import wn_layer_fused as jax_layer
from waveglow_tpu.models import wn as jax_wn
from waveglow_tpu.models.waveglow import fuse_for_inference as jax_fuse
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models import wn as port_wn
from waveglow_tpu_torch.models.waveglow import params_to_torch


def make_inputs(batch=2, t=300, c=128, last=False, seed=0):
  """The inputs of tests/test_kernels.py::make_inputs, as numpy."""
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((batch, t, c)).astype(np.float32) * 0.1
  cond = rng.standard_normal((batch, t, 2, c)).astype(np.float32) * 0.1
  w_in = rng.standard_normal((3, c, 2 * c)).astype(np.float32) * 0.05
  b_in = rng.standard_normal((2, c)).astype(np.float32) * 0.05
  rs_out = c if last else 2 * c
  w_rs = rng.standard_normal((c, rs_out)).astype(np.float32) * 0.05
  b_rs = rng.standard_normal((rs_out,)).astype(np.float32) * 0.05
  return x, cond, w_in, b_in, w_rs, b_rs


def run_jax(inputs, dilation, **kw):
  out = jax_layer(*[jnp.asarray(a) for a in inputs], dilation=dilation,
                  tile=128, interpret=True, **kw)
  return [np.asarray(o) for o in out]


LAYERS = {"plain": kl.wn_layer_plain, "fused_cpu": kl.wn_layer_fused}


def run_port(layer, inputs, dilation, **kw):
  out = LAYERS[layer](*[torch.from_numpy(a) for a in inputs], dilation, **kw)
  return [o.numpy() for o in out]


@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("dilation,t,last", [
    (1, 300, False), (4, 300, False), (64, 300, False),  # dilations
    (2, 256, True),                                      # last layer
    (8, 200, False),                                     # T not a tile multiple
    (2, 301, False), (2, 13, False),                     # T not a multiple of 8
])
def test_layer_matches_pallas_interpret(layer, dilation, t, last):
  inputs = make_inputs(t=t, c=128, last=last)
  x_j, s_j = run_jax(inputs, dilation)
  x_p, s_p = run_port(layer, inputs, dilation)
  np.testing.assert_allclose(x_p, x_j, atol=1e-5)
  np.testing.assert_allclose(s_p, s_j, atol=1e-5)


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_skip_accumulator_and_per_row_valid_t(layer):
  """In-place skip accumulation, and per-row valid_t against the JAX
  kernel's static int, row by row."""
  t, valid = 256, [200, 256]
  x, cond, w_in, b_in, w_rs, b_rs = make_inputs(t=t, c=128)
  mask = (np.arange(t)[None, :] < np.array(valid)[:, None])[..., None]
  x = (x * mask).astype(np.float32)
  acc = np.random.default_rng(7).standard_normal((2, t, 128)).astype(
      np.float32)
  acc_t = torch.from_numpy(acc.copy())
  x_p, s_p = run_port(layer, (x, cond, w_in, b_in, w_rs, b_rs), 8,
                      valid_t=torch.tensor(valid, dtype=torch.int32),
                      skip_acc=acc_t)
  assert np.shares_memory(s_p, acc_t.numpy())  # accumulated in place
  for row, v in enumerate(valid):
    sl = slice(row, row + 1)
    x_j, s_j = run_jax((x[sl], cond[sl], w_in, b_in, w_rs, b_rs), 8,
                       skip_acc=jnp.asarray(acc[sl]), valid_t=v)
    np.testing.assert_allclose(x_p[sl], x_j, atol=1e-5)
    np.testing.assert_allclose(s_p[sl], s_j, atol=1e-5)
    assert not x_p[row, v:].any()


def bf16_round(a):
  return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("dilation,t,last", [
    (1, 300, False), (64, 300, False), (2, 256, True), (2, 13, False)])
def test_layer_bf16_matches_pallas_interpret(layer, dilation, t, last):
  """bf16 against the Pallas body, whose rounding points the port shares:
  bf16 product operands (taps, weights, cond, acts), f32 accumulation, f32
  gate. JAX gets bf16 x (its x' comes back rounded to bf16), the port the
  same values in f32. Left over: the K-sum order, and an act whose f32
  value lands on the other side of a bf16 rounding boundary (one bf16 ulp
  of an act, times a weight). So every element is within 2e-4 (x' also
  within its own bf16 rounding, 2^-8 relative), and at most 1% of elements
  differ by more than 1e-5; a port that kept acts in f32 differs by more
  than 1e-5 almost everywhere."""
  x, cond, w_in, b_in, w_rs, b_rs = make_inputs(t=t, c=128, last=last)
  x, cond, w_in, w_rs = (bf16_round(a) for a in (x, cond, w_in, w_rs))
  acc = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
  bf16 = jnp.bfloat16
  x_j, s_j = jax_layer(
      jnp.asarray(x, bf16), jnp.asarray(cond, bf16), jnp.asarray(w_in, bf16),
      jnp.asarray(b_in), jnp.asarray(w_rs, bf16), jnp.asarray(b_rs),
      dilation=dilation, tile=128, interpret=True, skip_acc=jnp.asarray(acc))
  x_j = np.asarray(x_j.astype(jnp.float32))
  s_j = np.asarray(s_j)

  def to_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)

  x_p, s_p = LAYERS[layer](
      torch.from_numpy(x), to_bf16(cond), to_bf16(w_in), torch.from_numpy(b_in),
      to_bf16(w_rs), torch.from_numpy(b_rs), dilation,
      skip_acc=torch.from_numpy(acc.copy()), compute_dtype=torch.bfloat16)
  assert x_p.dtype == s_p.dtype == torch.float32
  skip_err = np.abs(s_p.numpy() - s_j)
  x_err = np.abs(x_p.numpy() - x_j) - 2.0 ** -8 * np.abs(x_j)
  for err in (skip_err, x_err):
    assert err.max() <= 2e-4, err.max()
    assert (err > 1e-5).mean() <= 0.01, (err > 1e-5).mean()


def wn_fixture(c=32, n_layers=3, n_half=2, seed=0):
  rng = np.random.default_rng(seed)
  params = jax_wn.init_wn_params(rng, n_in_channels=n_half,
                                 n_mel_channels=40, n_layers=n_layers,
                                 n_channels=c, kernel_size=3)
  # randomise the zero-initialised end conv (else the stack's output is 0)
  params["end"]["w"] = rng.standard_normal(params["end"]["w"].shape).astype(
      np.float32) * 0.1
  params["end"]["b"] = rng.standard_normal(params["end"]["b"].shape).astype(
      np.float32) * 0.1
  fused = jax_fuse({"upsample": {}, "flows": [
      {"inv1x1": {"w": np.eye(2 * n_half, dtype=np.float32)},
       "wn": params}]})["flows"][0]["wn"]
  audio0 = rng.standard_normal((2, 150, n_half)).astype(np.float32)
  spect = rng.standard_normal((2, 150, 40)).astype(np.float32)
  return fused, audio0, spect


@pytest.mark.parametrize("valid", [None, [150, 97]])
def test_wn_stack_f32_matches_jax_xla_body(valid):
  fused, audio0, spect = wn_fixture()
  ref = np.asarray(jax_wn.wn_forward(
      fused, jnp.asarray(audio0), jnp.asarray(spect), 32, 3, 3,
      valid_t=None if valid is None else jnp.asarray(valid)))
  out = port_wn.wn_forward(
      params_to_torch(fused, torch.device("cpu")), torch.from_numpy(audio0),
      torch.from_numpy(spect), 32, 3, 3,
      valid_t=None if valid is None else torch.tensor(valid,
                                                      dtype=torch.int32))
  np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_wn_stack_bf16_matches_jax_xla_body():
  """bf16 against the XLA body the JAX Synthesizer runs: the port keeps pre,
  the gate and rs in f32 where that body rounds them to bf16 (the port's
  rounding points are the Pallas body's, held tightly above), so the two
  differ by those roundings; bound 3e-2 of the output scale."""
  fused, audio0, spect = wn_fixture(seed=1)
  ref = np.asarray(jax_wn.wn_forward(
      fused, jnp.asarray(audio0), jnp.asarray(spect), 32, 3, 3,
      compute_dtype=jnp.bfloat16))
  out = port_wn.wn_forward(
      params_to_torch(fused, torch.device("cpu")), torch.from_numpy(audio0),
      torch.from_numpy(spect), 32, 3, 3,
      compute_dtype=torch.bfloat16).numpy()
  assert out.dtype == np.float32
  err = np.abs(out - ref).max()
  assert err <= 3e-2 * np.abs(ref).max(), err
  # bf16 really ran: it differs from the f32 stack, within the same bound
  f32 = port_wn.wn_forward(
      params_to_torch(fused, torch.device("cpu")), torch.from_numpy(audio0),
      torch.from_numpy(spect), 32, 3, 3).numpy()
  assert 0 < np.abs(out - f32).max() <= 3e-2 * np.abs(f32).max()

