"""A model mesh at every shape the JAX package shards: any odd
``kernel_size`` and any C' = C / model, which on the card run through the
shape-generic rank kernels (``csrc/wn_layer_any.cu`` in partial mode,
``csrc/wn_layer_bwd_any.cu`` at a rank's gate width) and here through their
plain versions. Against the JAX package on the same numpy weights, noise
and batch: a rank's share of a layer summed over the ranks, the WN stack
and synthesis on a model mesh (the JAX package's GSPMD path on its virtual
CPU devices), one mesh train step; and the trainable shard's gradients by
``gradcheck``. Tiny configs (at most 3 flows, 3 layers, 30 channels);
every ``end`` conv randomised; ``valid_t`` cut at a random row."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_parallel_training import TINY as TRAIN_TINY
from test_torch_parallel_training import (jax_mesh_step, mesh_step, port_hp,
                                          tiny_model)
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu.models import wn as jax_wn
from waveglow_tpu.parallel import mesh as jax_mesh
from waveglow_tpu.parallel import sharding as jax_sharding
from waveglow_tpu_torch.checkpointing import orbax_store
from waveglow_tpu_torch.checkpointing.from_jax import (
    params_to_numpy, trainable_params_from_numpy, tree_leaves,
    tree_unflatten)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.hparams import HParams
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models import waveglow as pm
from waveglow_tpu_torch.models.wn import wn_forward_tp
from waveglow_tpu_torch.parallel import mesh as mesh_lib
from waveglow_tpu_torch.parallel.sharding import (gather_trainable_params,
                                                  rank_trees_to_numpy,
                                                  shard_params,
                                                  shard_trainable_params)
from waveglow_tpu_torch.training import step

# kernel_size 5 at a width whose halves split into odd rank widths: C' = 15
# on a model = 2 mesh, 10 on model = 3.
TINY = dict(n_flows=2, n_layers=3, n_channels=30, kernel_size=5)
CFG = pm.WaveGlowConfig(**TINY)
MESHES = [(1, 2), (2, 2), (1, 3)]
# The WN stack and synthesis on a model mesh against the JAX package's
# GSPMD path, relative to max |ref|: the same f32 function, the K*C deep
# conv and the res/skip product summed in other orders (over taps, and
# over ranks).
TP_TOL_REL = 1e-5
# A rank's partials summed, plus b_rs and the residual, against the whole
# layer: f32 relative to max |ref|; bf16 the same operands rounded at the
# same points, the products summed in another order.
SUM_TOL_REL = {"f32": 1e-5, "bf16": 1e-5}
SEED = 11


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch: the suite runs its files in parallel
  worker processes."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def randomize_end(params, seed):
  rng = np.random.default_rng(seed)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.1).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.1).astype(np.float32)
  return params


def cpu_mesh(data, model):
  return mesh_lib.make_mesh(data, model, devices=["cpu"] * (data * model))


# -- a rank's share of a layer -------------------------------------------------

def rank_slices(cond, w_in, b_in, w_rs, model, rank):
  """Rank ``rank``'s slices of a whole layer's (cond [B, T, 2, C], w_in [K,
  C, 2, C], b_in [2, C], w_rs [C, n_rs]) as ``parallel.sharding`` cuts
  them: the gate pair's halves kept together."""
  c = w_rs.shape[0]
  cp = c // model
  cols = slice(rank * cp, (rank + 1) * cp)
  return (cond[..., cols].reshape(*cond.shape[:2], 2 * cp),
          w_in[..., cols].reshape(w_in.shape[0], c, 2 * cp),
          b_in[:, cols].reshape(-1), w_rs[cols])


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c,model", [(30, 2), (30, 3)])
@pytest.mark.parametrize("k", [1, 5, 7])
def test_shard_partials_sum_to_the_layer(k, c, model, last, mode):
  """Every rank's ``wn_layer_shard_plain`` partial (the shard wrapper's CPU
  route, at K taps, an odd C' = 15 at model = 2), summed over the ranks in
  rank order, plus b_rs and the residual and the row mask, is
  ``wn_layer_plain``'s output: f32, and at the bf16 rounding points."""
  rng = np.random.default_rng(k * 100 + c + model)
  batch, t, d = 2, 41, 3
  n_rs = c if last else 2 * c
  cdt = torch.bfloat16 if mode == "bf16" else None

  def r(*shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))

  x, cond = r(batch, t, c, scale=0.5), r(batch, t, 2, c, scale=0.5)
  w_in = r(k, c, 2, c, scale=(k * c) ** -0.5)
  b_in, w_rs, b_rs = r(2, c, scale=0.2), r(c, n_rs, scale=c ** -0.5), r(n_rs)
  valid = torch.tensor([t, int(rng.integers(1, t))], dtype=torch.int32)
  total = None
  for rank in range(model):
    part = kl.wn_layer_shard(x, *rank_slices(cond, w_in, b_in, w_rs, model,
                                             rank), d, compute_dtype=cdt)
    assert part.shape == (batch, t, n_rs) and part.dtype == torch.float32
    total = part if total is None else total + part
  rs = total + b_rs
  keep = torch.arange(t)[None, :, None] < valid[:, None, None]
  x_next = x if last else x + rs[..., :c]
  x_next = torch.where(keep, x_next, torch.zeros(()))
  skip = rs if last else rs[..., c:]
  want = kl.wn_layer_plain(x, cond.reshape(batch, t, 2 * c),
                           w_in.reshape(k, c, 2 * c), b_in.reshape(-1), w_rs,
                           b_rs, d, valid_t=valid, compute_dtype=cdt)
  for got, ref in zip((x_next, skip), want):
    scale = ref.abs().max().item()
    assert scale > 0.1
    assert (got - ref).abs().max().item() <= SUM_TOL_REL[mode] * scale


def test_shard_plain_takes_the_taps_from_w_in():
  """``wn_layer_shard_plain`` derives K from w_in_s ([K, C, 2C'] or [K*C,
  2C']) and centres the taps on t: a K = 5 share whose outer taps are zero
  is the K = 3 share of its inner taps, the K = 3 share the one the
  specialised kernels compute."""
  rng = np.random.default_rng(2)
  c, cp, t = 8, 3, 19

  def rand(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

  x, cond, b_in, w_rs = rand(1, t, c), rand(1, t, 2 * cp), rand(2 * cp), rand(
      cp, 2 * c)
  w3 = rand(3, c, 2 * cp)
  w5 = torch.cat([torch.zeros(1, c, 2 * cp), w3, torch.zeros(1, c, 2 * cp)])
  want = kl.wn_layer_shard_plain(x, cond, w3, b_in, w_rs, 2)
  for w in (w5, w5.reshape(5 * c, 2 * cp)):
    got = kl.wn_layer_shard_plain(x, cond, w, b_in, w_rs, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# -- the WN stack and synthesis on a model mesh --------------------------------

@pytest.fixture(scope="module")
def params():
  """The tiny model's numpy params (JAX init, ``end`` randomised)."""
  return randomize_end(jax_model.init_params(
      jax_model.WaveGlowConfig(**TINY), seed=SEED), seed=SEED + 1)


@pytest.fixture(scope="module")
def fused(params):
  return jax_model.fuse_for_inference(params)


@pytest.mark.parametrize("data,model", MESHES)
def test_wn_stack_and_synthesis_on_a_model_mesh_match_jax(params, fused, data,
                                                          model):
  """At kernel_size 5 and C' = 30 / model: the port's ``wn_forward_tp``
  over one model group, its ``infer`` over the group and
  ``Synthesizer(mesh=...)`` against the JAX package's ``wn_forward`` and
  ``infer`` jitted on ``shard_params`` of the same (data, model) mesh of
  its virtual CPU devices (GSPMD), the same numpy inputs and noise."""
  rng = np.random.default_rng(data * 10 + model)
  jmesh = jax_mesh.make_mesh(data=data, model=model)
  jparams = jax_sharding.shard_params(fused, jmesh)
  grid = shard_params(fused, cpu_mesh(data, model))
  assert len(grid) == data and len(grid[0]) == model

  batch, t, n_mel = 2, 37, CFG.n_mel_channels * CFG.n_group
  n_half = CFG.n_group // 2
  audio = rng.standard_normal((batch, t, n_half)).astype(np.float32)
  spect = rng.standard_normal((batch, t, n_mel)).astype(np.float32)
  valid = np.array([t, int(rng.integers(1, t))], np.int32)
  c, layers, k = CFG.n_channels, CFG.n_layers, CFG.kernel_size
  ref = np.asarray(jax.jit(
      lambda p, a, s, v: jax_wn.wn_forward(p, a, s, c, layers, k,
                                           valid_t=v))(
          jparams["flows"][0]["wn"], jnp.asarray(audio), jnp.asarray(spect),
          jnp.asarray(valid)))
  group = grid[-1]
  out = wn_forward_tp([g["flows"][0]["wn"] for g in group],
                      torch.from_numpy(audio),
                      [torch.from_numpy(spect)] * model, c, layers, k,
                      valid_ts=[torch.from_numpy(valid)] * model).numpy()
  assert out.shape == ref.shape and np.abs(ref).max() > 0.1
  assert np.abs(out - ref).max() <= TP_TOL_REL * np.abs(ref).max()

  frames = 9
  mel = rng.standard_normal((batch, 80, frames)).astype(np.float32)
  noise = [rng.standard_normal(s).astype(np.float32)
           for s in pm.infer_noise_shapes(CFG, batch, frames * 32)]
  jcfg = jax_model.WaveGlowConfig(**TINY)
  wav_ref = np.asarray(jax.jit(
      lambda p, m, n: jax_model.infer(p, jcfg, m, sigma=0.8, noise=n))(
          jparams, jnp.asarray(mel), [jnp.asarray(n) for n in noise]))
  scale = np.abs(wav_ref).max()
  assert scale > 0.1
  wav = pm.infer(group, CFG, mel, sigma=0.8, noise=noise,
                 device="cpu").numpy()
  assert np.abs(wav - wav_ref).max() <= TP_TOL_REL * scale
  ckpt = CheckpointWaveglow.from_params(params, HParams(**TINY), iteration=1)
  synth = Synthesizer(ckpt, mesh=cpu_mesh(data, model))
  got = synth.infer(mel, sigma=0.8, noise=noise, denoiser_strength=0.0).wav
  assert np.abs(got - wav_ref).max() <= TP_TOL_REL * scale


def test_shard_params_cut_odd_widths_and_five_taps(fused):
  """``shard_params`` at kernel_size 5 and C' = 15: each rank's in_layer
  [5, 30, 2, 15], cond [M, L, 2, 15] and res_skip [15, 2, 30] (last [15,
  30]) are its slices, and the ranks' slices concatenate to the whole."""
  group = shard_params(fused, cpu_mesh(1, 2))[0]
  wn = fused["flows"][1]["wn"]
  for i in range(CFG.n_layers):
    ws = [g["flows"][1]["wn"]["in_layers"][i]["w"].numpy() for g in group]
    assert ws[0].shape == (5, 30, 2, 15)
    np.testing.assert_array_equal(np.concatenate(ws, -1),
                                  wn["in_layers"][i]["w"])
    rs = [g["flows"][1]["wn"]["res_skip"][i]["w"].numpy() for g in group]
    assert rs[0].shape[0] == 15
    np.testing.assert_array_equal(np.concatenate(rs, 0),
                                  wn["res_skip"][i]["w"])
  conds = [g["flows"][1]["wn"]["cond"]["w"].numpy() for g in group]
  np.testing.assert_array_equal(np.concatenate(conds, -1), wn["cond"]["w"])


def test_trainable_placement_and_orbax_round_trip_at_odd_widths(tmp_path):
  """At kernel_size 5 and C = 30: ``shard_trainable_params`` on a (1, 2)
  mesh (C' = 15) and ``gather_trainable_params`` give the tree back bit for
  bit; the group's orbax save (``save_sharded``) restores whole
  (``restore_host``) and onto (1, 2) and (1, 3) meshes (``restore_sharded``,
  C' = 15 and 10) as ``shard_trainable_params`` cuts it, the Adam state
  with it."""
  custom = {"kernel_size": "5", "n_channels": "30"}
  params, _ = tiny_model(**custom)
  leaves = tree_leaves(params)
  rng = np.random.default_rng(7)
  opt = ([np.asarray(3, np.int32)]
         + [(rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
            for x in leaves]
         + [np.abs(rng.standard_normal(x.shape) * 1e-6).astype(np.float32)
            for x in leaves])
  mesh = cpu_mesh(1, 2)
  group = shard_trainable_params(params, mesh)[0]
  assert group[1]["flows"][0]["wn"]["in_layers"][0]["v"].shape == (
      5, 30, 2, 15)
  for a, b in zip(tree_leaves(gather_trainable_params(group)), leaves):
    np.testing.assert_array_equal(a, b)

  def rank_slices(values, m):
    return [tree_leaves(t) for t in rank_trees_to_numpy(
        shard_trainable_params(tree_unflatten(params, list(values)),
                               cpu_mesh(1, m))[0])]

  n = len(leaves)
  rank_opt = [[opt[0]] + mu + nu for mu, nu in zip(
      rank_slices(opt[1:1 + n], 2), rank_slices(opt[1 + n:], 2))]
  path = orbax_store.save_sharded(tmp_path, 6, rank_trees_to_numpy(group),
                                  rank_opt, port_hp(**custom))
  whole = orbax_store.restore_host(path)
  for a, b in zip(tree_leaves(whole.state_dict), leaves):
    np.testing.assert_array_equal(a, b)
  for a, b in zip(whole.optimizer, opt):
    np.testing.assert_array_equal(a, b)
  for m in (2, 3):
    got, got_opt, meta = orbax_store.restore_sharded(path, cpu_mesh(1, m))
    assert meta["iteration"] == 6 and len(got) == m
    for g, w in zip(got, rank_slices(leaves, m)):
      for a, b in zip(tree_leaves(g), w):
        np.testing.assert_array_equal(a, b)
    for g, mu, nu in zip(got_opt, rank_slices(opt[1:1 + n], m),
                         rank_slices(opt[1 + n:], m)):
      assert int(g[0]) == 3
      for a, b in zip(g[1:], mu + nu):
        np.testing.assert_array_equal(a, b)


# -- training on a model mesh --------------------------------------------------

def test_mesh_step_at_kernel_size_5_matches_jax_and_unsharded():
  """One train step on a (1, 2) mesh at kernel_size 5 and C' = 15: the loss
  within 1e-5 relative and the params within 1e-5 absolute of the JAX
  package's step on the same mesh of its virtual CPU devices and of the
  port's unsharded step (tests/test_torch_parallel_training.py's bounds:
  one Adam step moves a param about lr)."""
  custom = {"kernel_size": "5", "n_channels": "30"}
  params, audio = tiny_model(**custom)
  jhp = jax_overwrite(JaxHParams(), dict(TRAIN_TINY, **custom))
  jax_loss, jax_params = jax_mesh_step(params, audio, 1, 2, jhp)
  (loss,), replicas, _ = mesh_step(params, audio, 1, 2, **custom)
  got = tree_leaves(gather_trainable_params(replicas[0]))
  assert loss == pytest.approx(jax_loss, rel=1e-5)
  for a, b in zip(got, jax_params):
    np.testing.assert_allclose(a, b, atol=1e-5)

  hp = port_hp(**custom)
  ref = trainable_params_from_numpy(params, "cpu")
  opt = step.make_optimizer(ref, hp.learning_rate)
  ref_loss = step.make_train_step(pm.WaveGlowConfig.from_hparams(hp), hp,
                                  MelSTFT(hp, "cpu"), opt)(
                                      ref, torch.from_numpy(audio))
  assert loss == pytest.approx(float(ref_loss), rel=1e-5)
  for a, b in zip(got, tree_leaves(params_to_numpy(ref))):
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("last", [False, True])
def test_trainable_shard_gradcheck_at_five_taps_and_odd_width(last):
  """f64 ``gradcheck`` of the trainable shard (its CPU route: the plain
  forward and ``wn_layer_shard_backward`` over K taps) at K = 5, C = 6,
  C' = 3, d = 2."""
  rng = np.random.default_rng(4 + last)
  batch, t, c, cp, k = 1, 9, 6, 3, 5
  n_rs = c if last else 2 * c

  def r(*shape):
    return torch.from_numpy(rng.standard_normal(shape) * 0.5).requires_grad_()

  args = (r(batch, t, c), r(batch, t, 2 * cp), r(k * c, 2 * cp), r(2 * cp),
          r(cp, n_rs))
  assert torch.autograd.gradcheck(
      lambda *a: kl.wn_layer_shard_trainable(*a, 2), args, eps=1e-6,
      atol=1e-5)
