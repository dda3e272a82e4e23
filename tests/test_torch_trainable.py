"""The port's differentiable path against the JAX package: the trainable WN
layer's six gradients (against JAX's custom VJP, its Pallas forward run in
interpret mode, and against torch autograd through the plain layer),
weight-norm, the invertible 1x1 and the training-direction model forward.
Same numpy inputs to both packages; every tolerance is stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveglow_tpu.kernels.wn_layer import wn_layer_trainable as jax_trainable
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu.models import weightnorm as jax_weightnorm
from waveglow_tpu.ops import inv1x1 as jax_inv1x1
from waveglow_tpu_torch.checkpointing.from_jax import (
    trainable_params_from_numpy, tree_leaves)
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models import waveglow as port_model
from waveglow_tpu_torch.models import weightnorm as port_weightnorm
from waveglow_tpu_torch.ops import inv1x1 as port_inv1x1

NAMES = ("x", "cond", "w_in", "b_in", "w_rs", "b_rs")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch: the suite runs its files in parallel
  worker processes, and torch's default of one thread per core
  oversubscribes the cores (the port's test files ran about twice as slow
  under that load)."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def layer_inputs(batch=2, t=256, c=128, last=False, seed=3):
  """The inputs of tests/test_kernels.py::make_inputs, plus output
  cotangents, as numpy."""
  rng = np.random.default_rng(seed)
  rs_out = c if last else 2 * c
  inputs = (rng.standard_normal((batch, t, c)).astype(np.float32) * 0.1,
            rng.standard_normal((batch, t, 2, c)).astype(np.float32) * 0.1,
            rng.standard_normal((3, c, 2 * c)).astype(np.float32) * 0.05,
            rng.standard_normal((2, c)).astype(np.float32) * 0.05,
            rng.standard_normal((c, rs_out)).astype(np.float32) * 0.05,
            rng.standard_normal((rs_out,)).astype(np.float32) * 0.05)
  cot = (rng.standard_normal((batch, t, c)).astype(np.float32),
         rng.standard_normal((batch, t, c)).astype(np.float32))
  return inputs, cot


def jax_grads(inputs, cot, dilation, valid_t=None):
  def loss(*args):
    x_n, skip = jax_trainable(*args, dilation, 128, valid_t)
    return jnp.sum(x_n * cot[0]) + jnp.sum(skip * cot[1])
  grads = jax.grad(loss, argnums=tuple(range(6)))(
      *[jnp.asarray(a) for a in inputs])
  return [np.asarray(g) for g in grads]


def port_grads(layer, inputs, cot, dilation, valid_t=None,
               compute_dtype=None):
  args = [torch.tensor(a, requires_grad=True) for a in inputs]
  if compute_dtype is not None:
    # the kernel's calling convention: cond and weights in the compute dtype
    args = [a.detach().to(compute_dtype).requires_grad_() if i in (1, 2, 4)
            else a for i, a in enumerate(args)]
  outs = layer(*args, dilation, valid_t=valid_t, compute_dtype=compute_dtype)
  grads = torch.autograd.grad(outs, args, [torch.from_numpy(g) for g in cot])
  return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("dilation,t,last", [
    (1, 256, False), (8, 256, False), (64, 256, True),  # dilations, last layer
    (2, 301, False),                                    # T not a multiple of 8
])
def test_trainable_grads_match_jax_and_plain_autograd(dilation, t, last):
  """All six gradients within 1e-4 abs of JAX's custom VJP (Pallas forward
  in interpret mode) and of torch autograd through ``wn_layer_plain``:
  the adjoints are the same closed forms in f32, summed in other orders."""
  inputs, cot = layer_inputs(t=t, last=last)
  ref = jax_grads(inputs, cot, dilation)
  got = port_grads(kl.wn_layer_trainable, inputs, cot, dilation)
  plain = port_grads(kl.wn_layer_plain, inputs, cot, dilation)
  for name, g, r, p in zip(NAMES, got, ref, plain):
    assert g.shape == r.shape, name
    np.testing.assert_allclose(g, r, atol=1e-4, err_msg=f"{name} vs JAX")
    np.testing.assert_allclose(g, p, atol=1e-4, err_msg=f"{name} vs plain")


def test_trainable_per_row_valid_t():
  """A per-row int32 ``valid_t`` against JAX's static int, row by row:
  per-row gradients equal JAX's for that row, weight gradients the sum of
  JAX's per-row ones (1e-4 abs); no gradient reaches x' rows past it."""
  t, valid = 256, [200, 256]
  inputs, cot = layer_inputs(t=t, seed=5)
  mask = (np.arange(t)[None, :] < np.array(valid)[:, None])[..., None]
  inputs = ((inputs[0] * mask).astype(np.float32),) + inputs[1:]
  valid_t = torch.tensor(valid, dtype=torch.int32)
  got = port_grads(kl.wn_layer_trainable, inputs, cot, 8, valid_t=valid_t)
  plain = port_grads(kl.wn_layer_plain, inputs, cot, 8, valid_t=valid_t)
  weight_sums = [0.0] * 6
  for row, v in enumerate(valid):
    sl = slice(row, row + 1)
    row_inputs = (inputs[0][sl], inputs[1][sl]) + inputs[2:]
    ref = jax_grads(row_inputs, (cot[0][sl], cot[1][sl]), 8, valid_t=v)
    for i in (0, 1):
      np.testing.assert_allclose(got[i][sl], ref[i], atol=1e-4,
                                 err_msg=NAMES[i])
    for i in range(2, 6):
      weight_sums[i] = weight_sums[i] + ref[i]
  for i in range(2, 6):
    np.testing.assert_allclose(got[i], weight_sums[i], atol=1e-4,
                               err_msg=NAMES[i])
  for name, g, p in zip(NAMES, got, plain):
    np.testing.assert_allclose(g, p, atol=1e-4, err_msg=f"{name} vs plain")
  # with cotangent only on x' past valid_t, nothing flows back
  zero_cot = (cot[0] * ~mask, np.zeros_like(cot[1]))
  grads = port_grads(kl.wn_layer_trainable, inputs, zero_cot, 8,
                     valid_t=valid_t)
  assert all(not g.any() for g in grads)


def test_trainable_bf16_matches_plain_autograd():
  """bf16 (cond and weights bf16, as the kernel takes them): the backward
  recomputes in f32 from the bf16-rounded taps, where autograd through the
  plain layer differentiates its bf16-rounded acts as well, so dw_rs
  differs by bf16 rounding of the acts (2^-8 relative). Each gradient
  within 1e-2 of its own max |value|; each gradient keeps its input's
  dtype."""
  inputs, cot = layer_inputs(t=256, seed=6)
  cdt = torch.bfloat16
  got = port_grads(kl.wn_layer_trainable, inputs, cot, 4, compute_dtype=cdt)
  plain = port_grads(kl.wn_layer_plain, inputs, cot, 4, compute_dtype=cdt)
  for name, g, p in zip(NAMES, got, plain):
    err = np.abs(g - p).max()
    assert err <= 1e-2 * np.abs(p).max(), (name, err)
  args = [torch.tensor(a, requires_grad=True) for a in inputs]
  args[2] = args[2].detach().to(cdt).requires_grad_()
  x_n, skip = kl.wn_layer_trainable(*args, 4, compute_dtype=cdt)
  (x_n.sum() + skip.sum()).backward()
  assert args[2].grad.dtype == cdt and args[0].grad.dtype == torch.float32


def test_trainable_forward_is_the_fused_layer():
  inputs, _ = layer_inputs(t=256, seed=4)
  args = [torch.from_numpy(a) for a in inputs]
  for got, ref in zip(kl.wn_layer_trainable(*args, 4),
                      kl.wn_layer_fused(*args, 4)):
    assert torch.equal(got, ref)


@pytest.mark.parametrize("w_shape,out_ndim", [((3, 16, 2, 8), 2),
                                              ((40, 3, 2, 8), 3),
                                              ((5, 8), 1)])
def test_weightnorm_materialize_and_grads(w_shape, out_ndim):
  """g * v / ||v|| over the leading axes and its (g, v) gradients against
  JAX (1e-6 abs: float32 with unit-scale values)."""
  rng = np.random.default_rng(0)
  v = rng.standard_normal(w_shape).astype(np.float32)
  g = rng.standard_normal(w_shape[-out_ndim:]).astype(np.float32)
  probe = rng.standard_normal(w_shape).astype(np.float32)

  def jax_fn(g_, v_):
    return jnp.sum(jax_weightnorm.materialize({"g": g_, "v": v_}) * probe)
  ref = np.asarray(jax_weightnorm.materialize({"g": g, "v": v}))
  ref_g, ref_v = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(g),
                                                  jnp.asarray(v))
  gt, vt = (torch.tensor(a, requires_grad=True) for a in (g, v))
  w = port_weightnorm.materialize({"g": gt, "v": vt})
  np.testing.assert_allclose(w.detach().numpy(), ref, atol=1e-6)
  (w * torch.from_numpy(probe)).sum().backward()
  np.testing.assert_allclose(gt.grad.numpy(), np.asarray(ref_g), atol=1e-5)
  np.testing.assert_allclose(vt.grad.numpy(), np.asarray(ref_v), atol=1e-5)


@pytest.mark.parametrize("channels", [8, 6, 4])
def test_inv1x1_forward_and_logdet(channels):
  """z @ W.T and B*T*log|det W| (and their gradient in W) against JAX,
  1e-5 relative: f32 products over a few channels and an 8x8 LU."""
  rng = np.random.default_rng(channels)
  w = jax_inv1x1.init_orthonormal(rng, channels)
  w = (w + 0.1 * rng.standard_normal(w.shape)).astype(np.float32)
  z = rng.standard_normal((2, 50, channels)).astype(np.float32)
  out_j, logdet_j = jax_inv1x1.forward(jnp.asarray(z), jnp.asarray(w))
  grad_j = jax.grad(lambda w_: jnp.sum(jax_inv1x1.forward(
      jnp.asarray(z), w_)[0] ** 2) + jax_inv1x1.forward(
          jnp.asarray(z), w_)[1])(jnp.asarray(w))
  wt = torch.tensor(w, requires_grad=True)
  out_p, logdet_p = port_inv1x1.forward(torch.from_numpy(z), wt)
  np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                             rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(logdet_p.item(), float(logdet_j), rtol=1e-5)
  ((out_p ** 2).sum() + logdet_p).backward()
  np.testing.assert_allclose(wt.grad.numpy(), np.asarray(grad_j), rtol=1e-5,
                             atol=1e-3)


# -- the training-direction model -------------------------------------------

def tiny_model(seed=0):
  """4 flows with an early output every 2 (channel counts 8, 8, 6, 6), 3
  layers x 64 channels, the zero-initialised ``end`` convs randomised (a
  zero end makes every coupling the identity and hides the WN stack)."""
  config = port_model.WaveGlowConfig(n_flows=4, n_early_every=2,
                                     n_layers=3, n_channels=64)
  jcfg = jax_model.WaveGlowConfig(n_flows=4, n_early_every=2, n_layers=3,
                                  n_channels=64)
  params = jax_model.init_params(jcfg, seed=seed)
  rng = np.random.default_rng(seed + 1)
  for flow in params["flows"]:
    for k in ("w", "b"):
      flow["wn"]["end"][k] = (rng.standard_normal(
          flow["wn"]["end"][k].shape) * 0.05).astype(np.float32)
  audio = rng.uniform(-0.5, 0.5, (2, 2048)).astype(np.float32)
  mel = rng.uniform(-6.0, 0.0, (2, 80, 9)).astype(np.float32)
  return config, jcfg, params, mel, audio


def run_port_forward(params, config, mel, audio, **kw):
  tparams = trainable_params_from_numpy(params, "cpu")
  z, log_s, log_det = port_model.forward(
      tparams, config, torch.from_numpy(mel), torch.from_numpy(audio), **kw)
  return (z.detach().numpy(), [s.detach().numpy() for s in log_s],
          [d.item() for d in log_det])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_f32_matches_jax(use_pallas):
  """z, log_s and log_det_w against JAX ``forward`` through its XLA route
  and its Pallas route (interpret mode): 1e-4 abs on z and log_s (f32,
  K=3C sums in other orders through 4 flows). log_det_w is B*T = 512 times
  log|det W| of an orthonormal W, about 0 up to the f32 LU's rounding:
  1e-3 abs (512 x 2e-6)."""
  config, jcfg, params, mel, audio = tiny_model()
  z_j, log_s_j, log_det_j = jax_model.forward(
      params, jcfg, jnp.asarray(mel), jnp.asarray(audio),
      use_pallas=use_pallas)
  z_p, log_s_p, log_det_p = run_port_forward(params, config, mel, audio)
  assert z_p.shape == (2, 256, 8)
  np.testing.assert_allclose(z_p, np.asarray(z_j), atol=1e-4)
  assert len(log_s_p) == len(log_s_j) == 4
  for a, b in zip(log_s_p, log_s_j):
    np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
  np.testing.assert_allclose(log_det_p, [float(d) for d in log_det_j],
                             atol=1e-3)
  assert np.abs(np.concatenate([s.ravel() for s in log_s_p])).max() > 1e-3


def test_forward_bf16_matches_jax_xla_route_loosely():
  """bf16 against JAX's XLA route only: that route rounds pre and the gate
  to bf16 where the port keeps them f32 (its rounding points are the
  Pallas body's), and the JAX Pallas route keeps x in bf16 where the port
  keeps it f32. Bound: 5e-2 of max |ref| on z and on each log_s; and bf16
  really ran (it differs from the port's f32)."""
  config, jcfg, params, mel, audio = tiny_model(seed=2)
  z_j, log_s_j, _ = jax_model.forward(
      params, jcfg, jnp.asarray(mel), jnp.asarray(audio),
      compute_dtype=jnp.bfloat16)
  z_p, log_s_p, _ = run_port_forward(params, config, mel, audio,
                                     compute_dtype=torch.bfloat16)
  z_j = np.asarray(z_j, dtype=np.float32)
  assert np.abs(z_p - z_j).max() <= 5e-2 * np.abs(z_j).max()
  for a, b in zip(log_s_p, log_s_j):
    b = np.asarray(b, dtype=np.float32)
    assert np.abs(a - b).max() <= 5e-2 * np.abs(b).max()
  z_f32, _, _ = run_port_forward(params, config, mel, audio)
  assert np.abs(z_p - z_f32).max() > 0


def test_tree_leaves_follow_jax_order():
  _, _, params, _, _ = tiny_model()
  ours = tree_leaves(params)
  theirs = jax.tree_util.tree_leaves(params)
  assert len(ours) == len(theirs)
  assert all(a is b for a, b in zip(ours, theirs))
