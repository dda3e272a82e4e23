"""The port at the widths its kernels are built for beside 256: C = 128 and
C = 512 (the WaveGlow paper's width), against the JAX package on the CPU.
The layer forward (the JAX Pallas kernel in interpret mode), the backward
(JAX's ``_wn_layer_trainable_bwd``), the shard partials of every (C, C')
pair summed against the full layer, a tiny 512-channel model's synthesis,
and a 128-channel ``.pt`` through the port's importer. Also the width
admission: which widths are built, and the refusal of any other. Same
numpy inputs to both packages; every tolerance is stated in its test."""

import functools
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveglow_tpu.checkpointing import import_torch as jax_import
from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.inference.synthesizer import Synthesizer as JaxSynth
from waveglow_tpu.kernels.wn_layer import _wn_layer_trainable_bwd
from waveglow_tpu.kernels.wn_layer import wn_layer_fused as jax_layer
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import infer_noise_shapes
from waveglow_tpu.models.waveglow import init_params as jax_init
from waveglow_tpu_torch.checkpointing import export_torch, import_torch
from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.kernels import wn_layer as kl

NAMES = ("x", "cond", "w_in", "b_in", "w_rs", "b_rs")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch: the suite runs its files in parallel
  worker processes."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


# -- admission -------------------------------------------------------------

def test_kernel_widths_name_the_built_set():
  assert kl.kernel_widths() == (128, 256, 512)
  assert kl.shard_pairs() == ((128, 64), (128, 32), (128, 16),
                              (256, 128), (256, 64), (256, 32),
                              (512, 256), (512, 128), (512, 64))
  for c in (128, 256, 512):
    kl.check_width(c)
    for model in kl.SHARD_MODELS:
      kl.check_width(c, c // model)


@pytest.mark.parametrize("c,cp,named", [
    (384, None, "(128, 256, 512)"),
    (64, None, "(128, 256, 512)"),
    (1024, None, "(128, 256, 512)"),
    (256, 24, "(256, 128)"),
    (384, 192, "(512, 64)"),
    (512, 512, "(512, 256)"),
])
def test_other_widths_raise_naming_the_set(c, cp, named):
  with pytest.raises(ValueError) as err:
    kl.check_width(c, cp)
  assert named in str(err.value) and f"C = {c}" in str(err.value)


# -- the layer -------------------------------------------------------------

def layer_inputs(c, last, t, seed, batch=2):
  """numpy inputs at the model's scales: pre-activations and rs of order
  0.1-1 at every width (weights scaled by fan-in)."""
  rng = np.random.default_rng(seed)
  rs = c if last else 2 * c

  def rand(*shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)

  return (rand(batch, t, c, scale=0.3), rand(batch, t, 2, c, scale=0.3),
          rand(3, c, 2 * c, scale=(3 * c) ** -0.5), rand(2, c, scale=0.05),
          rand(c, rs, scale=c ** -0.5), rand(rs, scale=0.05))


def bf16_round(a):
  return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("last", [False, True], ids=["layer", "last"])
@pytest.mark.parametrize("dilation,t", [(1, 40), (4, 37)])
@pytest.mark.parametrize("c", [128, 512])
def test_layer_matches_pallas_interpret(c, dilation, t, last, mode):
  """``wn_layer_plain`` against the JAX Pallas kernel in interpret mode.
  f32: 2e-5 abs (x' and skip of order 1; the K sums, 3C deep, in another
  order). bf16: the rounding points of tests/test_torch_kernels.py's bf16
  test (JAX's x' comes back rounded to bf16, so 2^-8 of |x'| is allowed
  there); every element within 4e-4 and at most 2% of them over 2e-5 (an
  act on the other side of a bf16 rounding boundary moves an output by a
  bf16 ulp of the act times a weight; 512 channels hold more of them)."""
  x, cond, w_in, b_in, w_rs, b_rs = layer_inputs(c, last, t, seed=c + t)
  acc = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
  if mode == "f32":
    x_j, s_j = jax_layer(*map(jnp.asarray, (x, cond, w_in, b_in, w_rs, b_rs)),
                         dilation=dilation, tile=128, interpret=True,
                         skip_acc=jnp.asarray(acc))
    x_p, s_p = kl.wn_layer_plain(
        *map(torch.from_numpy, (x, cond, w_in, b_in, w_rs, b_rs)), dilation,
        skip_acc=torch.from_numpy(acc.copy()))
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), atol=2e-5)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), atol=2e-5)
    return
  x, cond, w_in, w_rs = (bf16_round(a) for a in (x, cond, w_in, w_rs))
  bf16 = jnp.bfloat16
  x_j, s_j = jax_layer(
      jnp.asarray(x, bf16), jnp.asarray(cond, bf16), jnp.asarray(w_in, bf16),
      jnp.asarray(b_in), jnp.asarray(w_rs, bf16), jnp.asarray(b_rs),
      dilation=dilation, tile=128, interpret=True, skip_acc=jnp.asarray(acc))
  x_j = np.asarray(x_j.astype(jnp.float32))
  s_j = np.asarray(s_j)

  def to_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)

  x_p, s_p = kl.wn_layer_plain(
      torch.from_numpy(x), to_bf16(cond), to_bf16(w_in), torch.from_numpy(b_in),
      to_bf16(w_rs), torch.from_numpy(b_rs), dilation,
      skip_acc=torch.from_numpy(acc.copy()), compute_dtype=torch.bfloat16)
  skip_err = np.abs(s_p.numpy() - s_j)
  x_err = np.abs(x_p.numpy() - x_j) - 2.0 ** -8 * np.abs(x_j)
  for err in (skip_err, x_err):
    assert err.max() <= 4e-4, err.max()
    assert (err > 2e-5).mean() <= 0.02, (err > 2e-5).mean()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("c,dilation,last", [
    (128, 1, False), (128, 4, True), (512, 1, False), (512, 4, True)])
def test_backward_matches_jax(c, dilation, last, mode):
  """``wn_layer_backward`` against JAX's ``_wn_layer_trainable_bwd`` (its
  XLA backward, f32 products) on the same saved inputs and cotangents. f32:
  each gradient within 1e-5 of its max |value| (the same closed forms,
  summed in other orders). bf16 (cond and the weights bf16 in both; the
  port's product operands rounded to bf16, as the bf16 kernel's are): each
  within 1e-2 of its max |value|, the bound of
  tests/test_torch_backward.py's bf16 test."""
  t = 37
  inputs = layer_inputs(c, last, t, seed=3 * c + dilation)
  rng = np.random.default_rng(c)
  cot = (rng.standard_normal((2, t, c)).astype(np.float32),
         rng.standard_normal((2, t, c)).astype(np.float32))
  cdt = torch.bfloat16 if mode == "bf16" else None
  jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
  residuals = tuple(jnp.asarray(a, jdt) if i in (1, 2, 4) else jnp.asarray(a)
                    for i, a in enumerate(inputs))
  ref = _wn_layer_trainable_bwd(dilation, 128, None, residuals,
                                tuple(map(jnp.asarray, cot)))
  saved = tuple(torch.from_numpy(a).to(cdt) if cdt is not None
                and i in (1, 2, 4) else torch.from_numpy(a)
                for i, a in enumerate(inputs))
  got = kl.wn_layer_backward(saved, *map(torch.from_numpy, cot), dilation,
                             None, cdt)
  bound = 1e-2 if mode == "bf16" else 1e-5
  for name, g, r in zip(NAMES, got, ref):
    r = np.asarray(r, dtype=np.float32)
    g = g.float().numpy()
    assert g.shape == r.shape, name
    assert np.abs(g - r).max() <= bound * np.abs(r).max(), name


@functools.lru_cache(maxsize=None)
def jax_full_layer(c, last):
  """JAX's layer (Pallas, interpret mode) on layer_inputs(c, last, 40):
  its res/skip without b_rs, [B, T, n_rs]."""
  x, cond, w_in, b_in, w_rs, b_rs = layer_inputs(c, last, 40, seed=11)
  x_j, s_j = jax_layer(*map(jnp.asarray, (x, cond, w_in, b_in, w_rs, b_rs)),
                       dilation=4, tile=128, interpret=True)
  x_j, s_j = np.asarray(x_j), np.asarray(s_j)
  rs = s_j if last else np.concatenate([x_j - x, s_j], axis=-1)
  return rs - b_rs


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("last", [False, True], ids=["layer", "last"])
@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_shard_partials_sum_to_the_layer(c, cp, last, mode):
  """Every (C, C') pair: the model = C / C' ranks' ``wn_layer_shard``
  partials (the plain version on CPU tensors), summed in rank order. f32:
  against JAX's full layer (Pallas, interpret mode) minus b_rs, 2e-5 abs
  (the K sum of the res/skip product split over the ranks). bf16: against
  the port's full plain layer in bf16, at the kernel bound (2e-2 of max
  |ref|: an f32 ulp can flip an act's bf16 rounding)."""
  x, cond, w_in, b_in, w_rs, b_rs = layer_inputs(c, last, 40, seed=11)
  cdt = torch.bfloat16 if mode == "bf16" else None
  model = c // cp
  total = 0
  for rank in range(model):
    cols = slice(rank * cp, (rank + 1) * cp)
    w_in_s = w_in.reshape(3, c, 2, c)[..., cols].reshape(3, c, 2 * cp)
    part = kl.wn_layer_shard(
        torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(
            cond[..., cols].reshape(2, 40, 2 * cp))),
        torch.from_numpy(np.ascontiguousarray(w_in_s)),
        torch.from_numpy(np.ascontiguousarray(b_in[:, cols].reshape(-1))),
        torch.from_numpy(np.ascontiguousarray(w_rs[cols])), 4,
        compute_dtype=cdt)
    total = total + part
  total = total.numpy()
  if mode == "f32":
    np.testing.assert_allclose(total, jax_full_layer(c, last), atol=2e-5)
    return
  x_n, skip = kl.wn_layer_plain(
      *map(torch.from_numpy, (x, cond, w_in, b_in, w_rs, b_rs)), 4,
      compute_dtype=cdt)
  full = (skip if last else torch.cat([x_n - torch.from_numpy(x), skip],
                                      dim=-1)).numpy() - b_rs
  assert np.abs(total - full).max() <= 2e-2 * np.abs(full).max()


# -- a model at C = 512, and a .pt at C = 128 ---------------------------------

def tiny_checkpoint(channels, seed=0):
  """A JAX param tree of 2 flows x 2 layers at ``channels``, every ``end``
  conv randomised (a zero end makes each coupling the identity)."""
  hp = jax_overwrite(JaxHParams(), {"n_flows": "2", "n_layers": "2",
                                    "n_channels": str(channels)})
  params = jax_init(JaxConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 100)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.1).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.1).astype(np.float32)
  return JaxCkpt(state_dict=params, optimizer=None,
                 learning_rate=hp.learning_rate, iteration=7,
                 hparams=asdict(hp))


def test_synthesis_at_512_channels_matches_jax(tmp_path):
  """``Synthesizer(device="cpu")`` on a 2-flow, 2-layer, 512-channel
  checkpoint written by the JAX package, against the JAX Synthesizer on
  the same mel and injected noise: the waveform and the denoised one within
  2e-4 abs (tests/test_torch_synthesizer.py's bound)."""
  path = tmp_path / "7.npz"
  tiny_checkpoint(512).save(path)
  jax_synth = JaxSynth(JaxCkpt.load(path))
  synth = Synthesizer(CheckpointWaveglow.load(path), device="cpu")
  assert synth.config.n_channels == 512
  mel = np.random.default_rng(1).standard_normal((80, 7)).astype(np.float32)
  rng = np.random.default_rng(2)
  noise = [rng.standard_normal(s).astype(np.float32)
           for s in infer_noise_shapes(JaxConfig.from_hparams(
               jax_synth.hparams), 1, 7 * 32)]
  ref = jax_synth.infer(mel, noise=noise, denoiser_strength=0.05)
  out = synth.infer(mel, noise=noise, denoiser_strength=0.05)
  assert out.wav.shape == ref.wav.shape == (7 * 256,)
  np.testing.assert_allclose(out.wav, ref.wav, atol=2e-4)
  np.testing.assert_allclose(out.wav_denoised, ref.wav_denoised, atol=2e-4)


def test_pt_at_128_channels_round_trips_through_the_importer(tmp_path):
  """A 128-channel checkpoint exported as a reference ``.pt`` and read back
  by the port's importer: the params bit for bit, the width read off the
  shapes, and the same checkpoint as the JAX importer reads."""
  jax_ckpt = tiny_checkpoint(128, seed=4)
  npz = tmp_path / "7.npz"
  jax_ckpt.save(npz)
  port_ckpt = CheckpointWaveglow.load(npz)
  pt = tmp_path / "7.pt"
  export_torch.export_torch_checkpoint(port_ckpt, pt)
  back = import_torch.load_torch_checkpoint(pt)
  assert back.get_hparams().n_channels == 128
  for a, b in zip(tree_leaves(back.state_dict),
                  tree_leaves(port_ckpt.state_dict)):
    np.testing.assert_array_equal(a, b)
  ref = jax_import.load_torch_checkpoint(pt)
  for a, b in zip(tree_leaves(back.state_dict), tree_leaves(ref.state_dict)):
    np.testing.assert_array_equal(a, b)
  assert back.hparams == ref.hparams
