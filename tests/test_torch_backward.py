"""The trainable WN layer's backward (``wn_layer_backward``), the plain
version and CPU route of the bf16 backward kernels, against the JAX
package and against closed forms written here: its bf16 rounding points,
its f32 path kept as it was, and None cotangents. Same numpy inputs to
both packages; every tolerance is stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveglow_tpu.kernels.wn_layer import wn_layer_trainable as jax_trainable
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.ops.conv import shift_time

NAMES = ("x", "cond", "w_in", "b_in", "w_rs", "b_rs")
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch (the suite runs files in parallel
  workers; see tests/test_torch_trainable.py)."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def dyadic_inputs(batch, t, c, last, seed, k=3):
  """Inputs, as numpy f32 (``k`` taps), whose products and sums before each bf16
  rounding point are exact in f32 in any order: small integers over powers
  of two (x, cond and the cotangents need at most 7 significant bits, so
  bf16 holds them exactly). Then the port and the closed form see the same
  gates and dacts bit for bit, and only tanh, sigmoid and exp can differ
  (by an ulp), so a bf16 rounding of an act or a dgate can flip between
  them only where one lies within an ulp of a rounding boundary."""
  rng = np.random.default_rng(seed)
  rs = c if last else 2 * c

  def ints(lo, shape, scale):
    return (rng.integers(-lo, lo + 1, shape) / scale).astype(np.float32)

  inputs = (ints(32, (batch, t, c), 64), ints(64, (batch, t, 2, c), 128),
            ints(16, (k, c, 2 * c), 256), ints(16, (2, c), 128),
            ints(16, (c, rs), 256), ints(16, (rs,), 128))
  cot = (ints(32, (batch, t, c), 16), ints(32, (batch, t, c), 16))
  return inputs, cot


def port_backward(inputs, cot, dilation, valid_t=None, compute_dtype=None,
                  drop=None):
  """wn_layer_backward on torch tensors, cond and weights in the compute
  dtype as the kernel takes them; the cotangent ``drop`` passed as None."""
  args = [torch.from_numpy(a) for a in inputs]
  if compute_dtype is not None:
    args = [a.to(compute_dtype) if i in (1, 2, 4) else a
            for i, a in enumerate(args)]
  cots = [None if i == drop else torch.from_numpy(g)
          for i, g in enumerate(cot)]
  if isinstance(valid_t, list):
    valid_t = torch.tensor(valid_t, dtype=torch.int32)
  grads = kl.wn_layer_backward(tuple(args), *cots, dilation, valid_t,
                               compute_dtype)
  for g, a in zip(grads, args):
    assert g.dtype == a.dtype and g.shape == a.shape
  return [g.float().numpy() for g in grads]


def jax_shift(v, off):
  """y[t] = v[t + off] along axis 1, zero outside (written here, not the
  JAX package's shift_time)."""
  t = v.shape[1]
  if off == 0:
    return v
  if abs(off) >= t:
    return jnp.zeros_like(v)
  if off > 0:
    return jnp.pad(v[:, off:], ((0, 0), (0, off), (0, 0)))
  return jnp.pad(v[:, :t + off], ((0, 0), (-off, 0), (0, 0)))


def closed_form_bf16(inputs, cot, dilation, valid):
  """The backward at the bf16 rounding points of wn_layer_backward, in JAX
  ops, over K taps (w_in [K, C, 2C]): taps bf16, shifted by (k - K//2)*d;
  gates, t, s, acts f32; drs, acts and dgates rounded to bf16 where they
  enter a product, f32 accumulation; dcond bf16(dgates); bias grads from
  the f32 dgates and drs; dw_in, dw_rs summed in f32 then rounded to bf16;
  dx f32, the taps' adjoint shifted by -(k - K//2)*d."""
  x, cond, w_in, b_in, w_rs, _ = (jnp.asarray(a) for a in inputs)
  batch, t, c = x.shape
  k_taps = w_in.shape[0]
  half = k_taps // 2
  last = w_rs.shape[-1] == c

  def bf(v):
    return v.astype(jnp.bfloat16).astype(jnp.float32)

  def dot(spec, a, b):
    return jnp.einsum(spec, a, b, precision=HIGHEST)

  w_in = bf(w_in).reshape(k_taps * c, 2 * c)
  w_rs = bf(w_rs)
  taps = jnp.concatenate([jax_shift(bf(x), (k - half) * dilation)
                          for k in range(k_taps)], axis=-1)
  gates = (dot("btk,km->btm", taps, w_in) + b_in.reshape(-1)
           + bf(cond).reshape(batch, t, 2 * c))
  t_act = jnp.tanh(gates[..., :c])
  s_act = jax.nn.sigmoid(gates[..., c:])
  acts = t_act * s_act
  dx_next, dskip = (jnp.asarray(g) for g in cot)
  if valid is not None:
    keep = (np.arange(t)[None, :] < np.asarray(valid)[:, None])[..., None]
    dx_next = jnp.where(keep, dx_next, 0.0)
  drs = dskip if last else jnp.concatenate([dx_next, dskip], axis=-1)
  dacts = dot("btk,ck->btc", bf(drs), w_rs)
  dgates = jnp.concatenate([dacts * s_act * (1.0 - t_act * t_act),
                            dacts * t_act * s_act * (1.0 - s_act)], axis=-1)
  g_w = dot("btm,km->btk", bf(dgates), w_in)
  dx = dx_next
  for k in range(k_taps):
    dx = dx + jax_shift(g_w[..., k * c:(k + 1) * c], -(k - half) * dilation)
  grads = (dx, bf(dgates),
           bf(dot("btk,btm->km", taps, bf(dgates))),
           dgates.sum((0, 1)),
           bf(dot("btc,btk->ck", bf(acts), bf(drs))),
           drs.sum((0, 1)))
  return [np.asarray(g).reshape(np.shape(a)) for g, a in zip(grads, inputs)]


@pytest.mark.parametrize("dilation,t,last,valid", [
    (1, 40, False, None),
    (4, 37, False, [37, 28]),      # per-row valid_t
    (16, 37, True, [34, 37]),      # last layer, a halo past both ends
])
def test_bf16_rounding_points_match_a_closed_form(dilation, t, last, valid):
  """wn_layer_backward(compute_dtype=bf16) against the closed form above
  (JAX ops, bf16 roundings via jnp.bfloat16 at exactly the listed points),
  each gradient within 1e-5 of its max |value|: the products before every
  rounding are exact (dyadic_inputs), the f32 sums after it differ in order
  only (about 1e-7). Leaving out any one rounding point moves a gradient by
  about 2^-8 of its scale."""
  inputs, cot = dyadic_inputs(2, t, 8, last, seed=dilation)
  got = port_backward(inputs, cot, dilation, valid_t=valid,
                      compute_dtype=torch.bfloat16)
  ref = closed_form_bf16(inputs, cot, dilation, valid)
  for name, g, r in zip(NAMES, got, ref):
    scale = np.abs(r).max()
    assert scale > 0, name
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * scale, err_msg=name)


def test_bf16_rounding_points_are_not_the_f32_path():
  """The bf16 rounding points move every gradient but db_in and db_rs (f32
  sums of f32 values) away from f32 products, by more than twice the 1e-5
  of the closed-form test: that test can tell a missing rounding point
  (dx moves least, 5.8e-5: the cotangent it passes through dominates it)."""
  inputs, cot = dyadic_inputs(2, 40, 8, False, seed=7)
  bf16 = port_backward(inputs, cot, 2, compute_dtype=torch.bfloat16)
  rounded = [a.astype(jnp.bfloat16).astype(np.float32) if i in (1, 2, 4)
             else a for i, a in enumerate(inputs)]
  f32 = port_backward(rounded, cot, 2)
  for name, a, b in zip(NAMES, bf16, f32):
    gap = np.abs(a - b).max() / np.abs(b).max()
    if name in ("b_in", "b_rs"):
      assert gap < 1e-5, name
    else:
      assert gap > 2e-5, (name, gap)


def jax_grads(inputs, cot, dilation, valid_t=None):
  """JAX's custom-VJP wn_layer_trainable (Pallas forward in interpret mode,
  the XLA backward with f32 products), with cond and the weights in bf16."""
  args = [jnp.asarray(a, dtype=jnp.bfloat16) if i in (1, 2, 4)
          else jnp.asarray(a) for i, a in enumerate(inputs)]

  def loss(*a):
    x_n, skip = jax_trainable(*a, dilation, 128, valid_t)
    return (jnp.sum(x_n.astype(jnp.float32) * cot[0])
            + jnp.sum(skip.astype(jnp.float32) * cot[1]))
  grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
  return [np.asarray(g, dtype=np.float32) for g in grads]


def random_inputs(batch, t, c, last, seed):
  """The scales of tests/test_torch_trainable.py::layer_inputs."""
  rng = np.random.default_rng(seed)
  rs = c if last else 2 * c
  inputs = (rng.standard_normal((batch, t, c)).astype(np.float32) * 0.1,
            rng.standard_normal((batch, t, 2, c)).astype(np.float32) * 0.1,
            rng.standard_normal((3, c, 2 * c)).astype(np.float32) * 0.05,
            rng.standard_normal((2, c)).astype(np.float32) * 0.05,
            rng.standard_normal((c, rs)).astype(np.float32) * 0.05,
            rng.standard_normal((rs,)).astype(np.float32) * 0.05)
  cot = (rng.standard_normal((batch, t, c)).astype(np.float32),
         rng.standard_normal((batch, t, c)).astype(np.float32))
  return inputs, cot


@pytest.mark.parametrize("dilation,t,last,valid_t", [
    (1, 128, False, None), (16, 150, True, None), (4, 301, False, 281)])
def test_bf16_backward_matches_jax(dilation, t, last, valid_t):
  """wn_layer_backward(compute_dtype=bf16) against JAX's wn_layer_trainable
  (f32 products on f32 taps; cond and the weights bf16 in both), each
  gradient within 1e-2 of its max |value|. The port's bf16 product
  operands (taps, drs, acts, dgates) are each 2^-9 relative, and dcond,
  dw_in and dw_rs are bf16 in both; the readings were at most 6.2e-3 of the
  scale (dcond), 5.5e-3 (dw_in), 5.3e-3 (dw_rs), 1.7e-3 (db_in)."""
  inputs, cot = random_inputs(2, t, 64, last, seed=dilation)
  got = port_backward(inputs, cot, dilation,
                      valid_t=None if valid_t is None else [valid_t] * 2,
                      compute_dtype=torch.bfloat16)
  ref = jax_grads(inputs, cot, dilation, valid_t)
  for name, g, r in zip(NAMES, got, ref):
    assert g.shape == r.shape, name
    assert np.abs(g - r).max() <= 1e-2 * np.abs(r).max(), name


def backward_f32_before(saved, dx_next, dskip, dilation, valid_t=None):
  """wn_layer_backward's f32 path as it stood before the bf16 rounding
  points were added, kept here so the f32 path can be held to it."""
  x, cond, w_in, b_in, w_rs, b_rs = saved
  batch, t, c = x.shape
  f32 = torch.float32
  last = w_rs.numel() == c * c
  n_rs = c if last else 2 * c
  xm = x.float()
  taps = torch.cat([shift_time(xm, (tap - 1) * dilation) for tap in range(3)],
                   dim=-1).reshape(-1, 3 * c)
  w_in_f = w_in.to(f32).reshape(3 * c, 2 * c)
  gates = (torch.matmul(taps, w_in_f) + b_in.to(f32).reshape(-1)
           + cond.to(f32).reshape(-1, 2 * c))
  t_act = torch.tanh(gates[:, :c])
  s_act = torch.sigmoid(gates[:, c:])
  acts = t_act * s_act

  def cotangent(g):
    if g is None:
      return torch.zeros((batch * t, c), dtype=f32, device=x.device)
    return g.to(f32).reshape(-1, c)

  dx_next, dskip = cotangent(dx_next), cotangent(dskip)
  if valid_t is not None:
    valid = torch.as_tensor(valid_t).reshape(-1, 1)
    keep = (torch.arange(t)[None, :] < valid)[..., None]
    dx_next = torch.where(keep.reshape(-1, 1), dx_next, torch.zeros(()))
  drs = dskip if last else torch.cat([dx_next, dskip], dim=-1)
  w_rs_f = w_rs.to(f32).reshape(c, n_rs)
  dacts = torch.matmul(drs, w_rs_f.T)
  dw_rs = torch.matmul(acts.T, drs)
  db_rs = drs.sum(0)
  dgates = torch.cat([dacts * s_act * (1.0 - t_act * t_act),
                      dacts * t_act * s_act * (1.0 - s_act)], dim=-1)
  db_in = dgates.sum(0)
  dw_in = torch.matmul(taps.T, dgates)
  g_w = torch.matmul(dgates, w_in_f.T).reshape(batch, t, 3 * c)
  dx = dx_next.reshape(batch, t, c)
  for tap in range(3):
    dx = dx + shift_time(g_w[..., tap * c:(tap + 1) * c], -(tap - 1) * dilation)

  def like(g, ref):
    return g.reshape(ref.shape).to(ref.dtype)

  return (like(dx, x), like(dgates, cond), like(dw_in, w_in),
          like(db_in, b_in), like(dw_rs, w_rs), like(db_rs, b_rs))


@pytest.mark.parametrize("dilation,last,valid,drop", [
    (1, False, None, None), (8, False, [100, 61], None),
    (32, True, [77, 100], None), (2, False, None, 0), (2, True, None, 1)])
def test_f32_path_is_bitwise_what_it_was(dilation, last, valid, drop):
  """compute_dtype=None gives the bits of the f32 formula before the bf16
  rounding points (same ops in the same order)."""
  inputs, cot = random_inputs(2, 100, 32, last, seed=dilation)
  saved = tuple(torch.from_numpy(a) for a in inputs)
  cots = [None if i == drop else torch.from_numpy(g)
          for i, g in enumerate(cot)]
  valid_t = None if valid is None else torch.tensor(valid, dtype=torch.int32)
  got = kl.wn_layer_backward(saved, *cots, dilation, valid_t)
  ref = backward_f32_before(saved, *cots, dilation, valid_t)
  for name, g, r in zip(NAMES, got, ref):
    assert torch.equal(g, r), name


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("drop,last", [(0, False), (1, False), (1, True)])
def test_none_cotangent_is_zero(compute_dtype, drop, last):
  """A None dx_next or dskip gives the gradients of a zero cotangent, in
  wn_layer_backward and through WNLayerTrainable's backward on the CPU."""
  inputs, cot = random_inputs(2, 60, 16, last, seed=drop)
  zeroed = tuple(np.zeros_like(g) if i == drop else g
                 for i, g in enumerate(cot))
  got = port_backward(inputs, cot, 4, compute_dtype=compute_dtype, drop=drop)
  ref = port_backward(inputs, zeroed, 4, compute_dtype=compute_dtype)
  for name, g, r in zip(NAMES, got, ref):
    np.testing.assert_array_equal(g, r, err_msg=name)
  # through autograd: an output that takes no part in the loss reaches the
  # backward as None (materialize_grads is off)
  args = [torch.tensor(a, requires_grad=True) for a in inputs]
  if compute_dtype is not None:
    args = [a.detach().to(compute_dtype).requires_grad_() if i in (1, 2, 4)
            else a for i, a in enumerate(args)]
  outs = kl.wn_layer_trainable(*args, 4, compute_dtype=compute_dtype)
  keep = 1 - drop
  (outs[keep] * torch.from_numpy(cot[keep])).sum().backward()
  for name, a, r in zip(NAMES, args, ref):
    np.testing.assert_array_equal(a.grad.float().numpy(), r, err_msg=name)
