"""Training on a (data, model) mesh in the port, against the JAX package and
the port's unsharded training: the trainable shard's backward, the
conjugate pair of model-axis sums, the row-parallel weight norm, the
process-sharded data pipeline, the mesh train step (against JAX's step on
its 8 virtual CPU devices) and ``train()`` on logical meshes of the CPU
(``["cpu"] * n``), with saves, resumes and checkpoints that cross between
mesh and no mesh. Same numpy inputs to both packages; every tolerance is
stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from waveglow_tpu.dsp.mel import MelSTFT as JaxMel
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import init_params
from waveglow_tpu.parallel import mesh as jax_mesh
from waveglow_tpu.parallel import sharding as jax_sharding
from waveglow_tpu.training import data as jax_data
from waveglow_tpu.training import step as jax_step
from waveglow_tpu_torch.checkpointing.from_jax import (
    params_to_numpy, trainable_params_from_numpy, tree_leaves)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, forward
from waveglow_tpu_torch.models.weightnorm import (materialize,
                                                  materialize_row_parallel)
from waveglow_tpu_torch.parallel import mesh as pmesh
from waveglow_tpu_torch.parallel.sharding import (distinct_leaves,
                                                  gather_trainable_params,
                                                  shard_trainable_params)
from waveglow_tpu_torch.training import data, step
from waveglow_tpu_torch.training.loop import train
from waveglow_tpu_torch.training.loss import waveglow_loss
from test_torch_training import to_jax_entries, write_speech_dataset

TINY = {"n_flows": "2", "n_layers": "2", "n_channels": "32",
        "segment_length": "2048", "batch_size": "4"}
LOOP = dict(TINY, iters_per_checkpoint="2", epochs_per_checkpoint="0",
            seed="1234")
MESHES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch (the suite runs files in parallel)."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def tiny_model(seed=0, **custom):
  """JAX-initialised params of TINY with every zero-initialised ``end``
  conv randomised (a zero end hides the WN stacks from the loss), and a
  batch of audio."""
  hp = jax_overwrite(JaxHParams(), dict(TINY, **custom))
  params = init_params(JaxConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 1)
  for flow in params["flows"]:
    for k in ("w", "b"):
      flow["wn"]["end"][k] = (rng.standard_normal(
          flow["wn"]["end"][k].shape) * 0.05).astype(np.float32)
  audio = rng.uniform(-0.5, 0.5, (hp.batch_size, 2048)).astype(np.float32)
  return params, audio


def port_hp(**custom):
  return overwrite_custom_hparams(HParams(), dict(TINY, **custom))


def cpu_mesh(data_, model):
  return pmesh.make_mesh(data_, model, devices=["cpu"] * (data_ * model))


# -- the trainable shard --------------------------------------------------------

def shard_inputs(c, model, rank, last, seed=0, batch=2, t=37, dtype=None):
  """Full-layer inputs and rank ``rank``'s slices of them (the layout of
  ``parallel.sharding``), and a cotangent of the rank's partial."""
  rng = np.random.default_rng(seed)
  n_rs = c if last else 2 * c

  def r(*shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))

  x, cond = r(batch, t, c), r(batch, t, 2, c)
  w_in, b_in = r(3, c, 2, c, scale=c ** -0.5), r(2, c, scale=0.3)
  w_rs, g = r(c, n_rs, scale=c ** -0.5), r(batch, t, n_rs)
  cp = c // model
  cut = slice(rank * cp, (rank + 1) * cp)
  wdt = dtype or torch.float32
  saved = (x, cond[..., cut].reshape(batch, t, 2 * cp).to(wdt),
           w_in[..., cut].reshape(3 * c, 2 * cp).to(wdt),
           b_in[:, cut].reshape(-1).contiguous(), w_rs[cut].to(wdt))
  full = (x, cond.reshape(batch, t, 2 * c).to(wdt),
          w_in.reshape(3 * c, 2 * c).to(wdt), b_in.reshape(-1),
          w_rs.to(wdt), torch.zeros(n_rs))
  return saved, full, g


def of_scale(got, want):
  return float((got.float() - want.float()).abs().max()
               / want.float().abs().max())


MODES = {"f32": None, "bf16": torch.bfloat16}


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("model", [2, 4])
def test_shard_backward_matches_autograd(model, last, mode):
  """wn_layer_shard_backward against autograd through wn_layer_shard_plain
  at the same compute dtype: f32 within 1e-5 of each gradient's scale
  (summation order only); bf16 within 2e-2 of scale (the backward rounds
  g and dgates to bf16 where they enter a product, autograd does not)."""
  cdt = MODES[mode]
  tol = 1e-5 if cdt is None else 2e-2
  saved, _, g = shard_inputs(32, model, 1, last, dtype=cdt)
  got = kl.wn_layer_shard_backward(saved, g, 2, cdt)
  leaves = [v.clone().requires_grad_(v.is_floating_point()) for v in saved]
  out = kl.wn_layer_shard_plain(*leaves, 2, compute_dtype=cdt)
  want = torch.autograd.grad(out, leaves, g)
  for a, b in zip(got, want):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert of_scale(a, b) <= tol


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("model", [2, 4])
def test_shard_backward_ranks_make_the_full_layer(model, last, mode):
  """The ranks' dx summed (plus the residual's cotangent), and their other
  gradients concatenated, against wn_layer_backward of the whole layer at
  the same rounding points: f32 within 1e-5 of scale; bf16 within 2e-2 of
  scale (the ranks' dx sum in another order)."""
  cdt = MODES[mode]
  tol = 1e-5 if cdt is None else 2e-2
  c, batch, t = 32, 2, 37
  grads = [kl.wn_layer_shard_backward(*shard_inputs(c, model, r, last,
                                                    dtype=cdt)[::2], 2, cdt)
           for r in range(model)]
  _, full, g = shard_inputs(c, model, 0, last, dtype=cdt)
  dx_next = None if last else g[..., :c]
  dskip = g if last else g[..., c:]
  want = kl.wn_layer_backward(full, dx_next, dskip, 2, None, cdt)
  dx = sum(r[0] for r in grads)
  if not last:
    dx = dx + g[..., :c]

  def cat(i, shape):
    return torch.cat([r[i].reshape(shape) for r in grads], dim=-1)

  assert of_scale(dx, want[0]) <= tol
  assert of_scale(cat(1, (batch, t, 2, -1)).reshape(batch, t, 2 * c),
                  want[1]) <= tol
  assert of_scale(cat(2, (3 * c, 2, -1)).reshape(3 * c, 2 * c),
                  want[2]) <= tol
  assert of_scale(cat(3, (2, -1)).reshape(-1), want[3]) <= tol
  assert of_scale(torch.cat([r[4] for r in grads], 0), want[4]) <= tol


@pytest.mark.parametrize("last", [False, True])
def test_shard_trainable_gradcheck(last):
  """WNLayerShardTrainable's backward against finite differences in f64 at
  a tiny shape (C = 8, C' = 4, B = 1, T = 6, d = 2)."""
  rng = np.random.default_rng(3)
  n_rs = 8 if last else 16

  def r(*shape):
    return torch.from_numpy(rng.standard_normal(shape) * 0.5).requires_grad_()

  args = (r(1, 6, 8), r(1, 6, 8), r(24, 8), r(8), r(4, n_rs))
  assert torch.autograd.gradcheck(
      lambda *a: kl.wn_layer_shard_trainable(*a, 2), args)


def test_shard_backward_without_cotangent():
  saved, _, _ = shard_inputs(32, 2, 0, False)
  grads = kl.wn_layer_shard_backward(saved, None, 1)
  assert all(float(v.abs().max()) == 0 for v in grads)


# -- the conjugate pair ------------------------------------------------------------

def test_reduce_from_model_ranks_sums_in_rank_order():
  """The forward is the left-to-right sum of the partials, bit for bit (the
  order reduce_partials takes), and copy_to_model_ranks gives every rank
  the same bits of it."""
  rng = np.random.default_rng(0)
  parts = [torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)
                            * 10.0 ** k) for k in range(4)]
  total = pmesh.reduce_from_model_ranks(parts)
  want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
  assert torch.equal(total, want)
  assert torch.equal(total, pmesh.reduce_partials(parts)[0])
  copies = pmesh.copy_to_model_ranks(total, ["cpu"] * 4)
  assert all(torch.equal(c, want) for c in copies)


def test_copy_to_model_ranks_backward_is_the_rank_order_sum():
  """The gradient of a tensor every rank reads is the ranks' cotangents
  summed in rank order, bit for bit; reduce_from_model_ranks hands its
  cotangent to every partial unchanged."""
  rng = np.random.default_rng(1)
  x = torch.zeros(6, requires_grad=True)
  cots = [torch.from_numpy(rng.standard_normal(6).astype(np.float32)
                           * 10.0 ** k) for k in range(3)]
  copies = pmesh.copy_to_model_ranks(x, ["cpu"] * 3)
  torch.autograd.backward(copies, cots)
  assert torch.equal(x.grad, (cots[0] + cots[1]) + cots[2])
  parts = [torch.zeros(6, requires_grad=True) for _ in range(3)]
  total = pmesh.reduce_from_model_ranks(parts)
  total.backward(cots[0])
  assert all(torch.equal(p.grad, cots[0]) for p in parts)


def test_replicated_leaves_get_the_whole_gradient():
  """On a model = 2 mesh every replicated leaf (start, end, upsample,
  inv1x1, res_skip's g and b) is held once and its gradient is the
  unsharded one (1e-5 of its scale), not one rank's half; the cut leaves'
  slices are the unsharded gradient's."""
  params, audio = tiny_model()
  hp = port_hp(remat="false")
  config = WaveGlowConfig.from_hparams(hp)
  mel_op = MelSTFT(hp, "cpu")
  audio_t = torch.from_numpy(audio)

  def loss_of(p):
    z, log_s, log_det = forward(p, config, mel_op.mel_spectrogram(audio_t),
                                audio_t)
    return waveglow_loss(z, log_s, log_det, hp.sigma)

  ref = trainable_params_from_numpy(params, "cpu")
  loss_of(ref).backward()
  group = shard_trainable_params(params, cpu_mesh(1, 2))[0]
  loss_of(group).backward()
  grads = gather_trainable_params(_grad_trees(group))
  for got, leaf in zip(tree_leaves(grads), tree_leaves(ref)):
    want = leaf.grad.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
  wn = [tree["flows"][0]["wn"] for tree in group]
  for get in (lambda w: w["res_skip"][0]["g"], lambda w: w["res_skip"][0]["b"],
              lambda w: w["start"]["v"], lambda w: w["end"]["w"]):
    assert get(wn[0]) is get(wn[1])
  assert group[0]["upsample"]["w"] is group[1]["upsample"]["w"]


def _grad_trees(group):
  """The rank trees with each leaf's gradient in its place."""
  def swap(tree):
    if isinstance(tree, dict):
      return {k: swap(v) for k, v in tree.items()}
    if isinstance(tree, list):
      return [swap(v) for v in tree]
    return tree.grad
  return [swap(tree) for tree in group]


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("model", [2, 4])
def test_res_skip_weight_norm_on_a_model_mesh(model, last):
  """The row-parallel res_skip's weights, each rank's slice normed over the
  cut axis through the ranks' reduced sums of squares, concatenate to
  materialize of the whole conv (1e-6 relative: the sum of squares in
  another order); materialize of a slice alone does not."""
  rng = np.random.default_rng(model)
  shape = (32, 32) if last else (32, 2, 32)
  v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
  g = torch.from_numpy(rng.uniform(0.5, 2, shape[1:]).astype(np.float32))
  whole = materialize({"g": g, "v": v})
  cp = 32 // model
  convs = [{"g": g, "v": v[r * cp:(r + 1) * cp]} for r in range(model)]
  got = torch.cat(materialize_row_parallel(convs), 0)
  np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                             atol=1e-7)
  alone = materialize(convs[0])
  assert not np.allclose(alone.numpy(), whole[:cp].numpy(), rtol=1e-2)


@pytest.mark.parametrize("model", [2, 4])
def test_shard_trainable_params_round_trip(model):
  """gather_trainable_params inverts shard_trainable_params bit for bit;
  every data replica has tensors of its own; a replicated leaf is one
  tensor on the group's first device, a cut leaf a slice on its rank's."""
  params, _ = tiny_model()
  replicas = shard_trainable_params(params, cpu_mesh(2, model))
  for group in replicas:
    for a, b in zip(tree_leaves(gather_trainable_params(group)),
                    tree_leaves(params)):
      np.testing.assert_array_equal(a, b)
  ids = [set(map(id, distinct_leaves(g))) for g in replicas]
  assert not ids[0] & ids[1]
  wn = [tree["flows"][0]["wn"] for tree in replicas[0]]
  assert all(w["start"]["v"] is wn[0]["start"]["v"] for w in wn)
  assert wn[1]["in_layers"][0]["v"].shape[-1] == 32 // model
  assert wn[1]["res_skip"][0]["v"].shape[0] == 32 // model


# -- the data pipeline -----------------------------------------------------------

@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (0, 3), (1, 3),
                                         (2, 3)])
def test_process_shards_crop_as_jax(tmp_path, index, count):
  """SegmentDataset(process_index, process_count) and
  BatchLoader(num_batches=): the entries, crops and batches of JAX's, bit
  for bit, at two epochs and from a mid-epoch start."""
  entries = write_speech_dataset(tmp_path, n=7, length=5000, seed=2)
  custom = {"segment_length": "2048", "seed": "77"}
  ours = data.SegmentDataset(entries, overwrite_custom_hparams(
      HParams(), custom), index, count)
  theirs = jax_data.SegmentDataset(to_jax_entries(entries),
                                   jax_overwrite(JaxHParams(), custom),
                                   index, count, use_native=False)
  assert [e.basename for e in ours.entries] == [
      e.basename for e in theirs.entries]
  loader = data.BatchLoader(ours, 1, num_batches=2)
  jloader = jax_data.BatchLoader(theirs, 1, num_batches=2)
  assert len(loader) == len(jloader) == 2
  for epoch in (0, 3):
    np.testing.assert_array_equal(ours.batch(range(len(ours)), epoch),
                                  theirs.batch(range(len(theirs)), epoch))
    batches = list(loader.epoch(epoch, start_batch=1))
    assert len(batches) == 1
    for a, b in zip(batches, jloader.epoch(epoch, 1)):
      np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("count", [2, 3])
def test_processes_rows_make_the_one_process_batch(tmp_path, count):
  """The union of the processes' rows at step b is the one-process step-b
  batch, row for row (process p holds rows p, p + count, ...)."""
  entries = write_speech_dataset(tmp_path, n=6, length=5000, seed=3)
  hp = overwrite_custom_hparams(HParams(), {"segment_length": "2048"})
  whole = data.SegmentDataset(entries, hp)
  shards = [data.SegmentDataset(entries, hp, p, count) for p in range(count)]
  for b in range(6 // count):
    rows = np.concatenate([s.batch([b], 1) for s in shards])
    np.testing.assert_array_equal(
        rows, whole.batch(range(b * count, (b + 1) * count), 1))


# -- the mesh train step -----------------------------------------------------------

def jax_mesh_step(params, audio, data_, model, hp):
  """One JAX train step on make_mesh(data, model) of its virtual CPU
  devices, params placed by shard_params and the batch by batch_pspec."""
  config = JaxConfig.from_hparams(hp)
  optimizer = jax_step.make_optimizer(hp.learning_rate)
  mesh = jax_mesh.make_mesh(data=data_, model=model)
  placed = jax_sharding.shard_params(params, mesh)
  batch = jax.device_put(jnp.asarray(audio),
                         NamedSharding(mesh, jax_sharding.batch_pspec()))
  state, loss = jax_step.make_train_step(config, hp, JaxMel(hp), optimizer)(
      jax_step.init_state(placed, optimizer), batch)
  return float(loss), [np.asarray(v) for v in
                       jax.tree_util.tree_leaves(state["params"])]


def mesh_step(params, audio, data_, model, steps=1, **custom):
  hp = port_hp(**custom)
  replicas = shard_trainable_params(params, cpu_mesh(data_, model))
  optimizers = [step.make_optimizer(distinct_leaves(g), hp.learning_rate)
                for g in replicas]
  train_step = step.make_mesh_train_step(WaveGlowConfig.from_hparams(hp), hp,
                                         replicas, optimizers)
  losses = [float(train_step(torch.from_numpy(audio))) for _ in range(steps)]
  return losses, replicas, optimizers


@pytest.mark.parametrize("data_,model", MESHES)
def test_mesh_step_matches_jax_and_unsharded(data_, model):
  """One mesh step: the loss within 1e-5 relative and the params within
  1e-5 absolute of JAX's step on the same (data, model) mesh (the bounds
  of tests/test_distributed.py: one Adam step moves a param about lr, and
  summation order may flip it where a grad is near zero), and of the
  port's unsharded step."""
  params, audio = tiny_model()
  jhp = jax_overwrite(JaxHParams(), TINY)
  jax_loss, jax_params = jax_mesh_step(params, audio, data_, model, jhp)
  (loss,), replicas, _ = mesh_step(params, audio, data_, model)
  got = tree_leaves(gather_trainable_params(replicas[0]))
  assert loss == pytest.approx(jax_loss, rel=1e-5)
  for a, b in zip(got, jax_params):
    np.testing.assert_allclose(a, b, atol=1e-5)

  hp = port_hp()
  ref = trainable_params_from_numpy(params, "cpu")
  opt = step.make_optimizer(ref, hp.learning_rate)
  ref_loss = step.make_train_step(WaveGlowConfig.from_hparams(hp), hp,
                                  MelSTFT(hp, "cpu"), opt)(
                                      ref, torch.from_numpy(audio))
  assert loss == pytest.approx(float(ref_loss), rel=1e-5)
  for a, b in zip(got, tree_leaves(params_to_numpy(ref))):
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_data_replicas_stay_identical():
  """Three steps on a (2, 2) mesh: both data replicas' params and Adam
  moments are the same bits (their gradients are summed in one order and
  handed to both)."""
  params, audio = tiny_model()
  losses, replicas, optimizers = mesh_step(params, audio, 2, 2, steps=3)
  assert all(np.isfinite(losses))
  for a, b in zip(tree_leaves(gather_trainable_params(replicas[0])),
                  tree_leaves(gather_trainable_params(replicas[1]))):
    np.testing.assert_array_equal(a, b)
  for a, b in zip(step.adam_state_to_optax_group(optimizers[0], replicas[0]),
                  step.adam_state_to_optax_group(optimizers[1], replicas[1])):
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", [1, 2])
def test_adam_state_round_trips_in_optax_layout(model):
  """A group's Adam state gathered in optax's layout, scattered into a
  fresh group and gathered again, bit for bit; on model = 1 it is
  adam_state_to_optax of the unsharded tree."""
  params, audio = tiny_model()
  _, replicas, optimizers = mesh_step(params, audio, 1, model)
  leaves = step.adam_state_to_optax_group(optimizers[0], replicas[0])
  assert int(leaves[0]) == 1
  assert len(leaves) == 1 + 2 * len(tree_leaves(params))
  fresh = shard_trainable_params(params, cpu_mesh(1, model))[0]
  opt = step.make_optimizer(distinct_leaves(fresh), 1e-4)
  step.adam_state_from_optax_group(opt, fresh, leaves)
  for a, b in zip(step.adam_state_to_optax_group(opt, fresh), leaves):
    np.testing.assert_array_equal(a, b)


def test_batch_must_split_over_the_data_axis(tmp_path):
  """A global batch that does not divide over the data replicas raises, as
  the JAX loop does."""
  entries = write_speech_dataset(tmp_path / "d", n=4)
  with pytest.raises(ValueError, match="divisible by the data axis"):
    train(dict(LOOP, batch_size="3", mesh_data="2"), None, entries, entries,
          tmp_path / "ck", max_iterations=1, device="cpu",
          mesh_devices=["cpu"] * 2)


def test_mesh_without_cards_raises(tmp_path):
  """Without mesh_devices a mesh needs that many cards; the CPU has none."""
  entries = write_speech_dataset(tmp_path / "d", n=4)
  with pytest.raises(ValueError, match="needs 2 CUDA devices"):
    train(dict(LOOP, mesh_model="2"), None, entries, entries,
          tmp_path / "ck", max_iterations=1, device="cpu")


# -- train() on logical meshes -------------------------------------------------------

def assert_same_state(a, b):
  for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
    np.testing.assert_array_equal(x, y)
  for x, y in zip(a["opt_state"], b["opt_state"]):
    np.testing.assert_array_equal(x, y)


def test_train_on_a_model_mesh_saves_and_resumes(tmp_path):
  """train() with mesh_model = 2 on ["cpu"] * 2: a save at step 2, then a
  resume to step 4, bit for bit the straight 4-step run; the step-2
  checkpoint (gathered) resumes in unsharded train() within 1e-5 of the
  mesh run's params (two Adam steps whose grads differ in summation order:
  the bound of tests/test_distributed.py); an unsharded checkpoint resumes
  on the mesh the same way."""
  entries = write_speech_dataset(tmp_path / "d", n=4)
  mesh = dict(LOOP, mesh_model="2", batch_size="2")
  straight = train(mesh, None, entries, entries, tmp_path / "ck",
                   max_iterations=4, device="cpu", mesh_devices=["cpu"] * 2)
  assert straight["step"] == 4
  assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
      "1.npz", "2.npz", "4.npz"]
  ckpt = CheckpointWaveglow.load(tmp_path / "ck" / "2.npz")
  resumed = train(None, None, entries, entries, tmp_path / "ck2",
                  checkpoint=ckpt, max_iterations=4, device="cpu",
                  mesh_devices=["cpu"] * 2)
  assert_same_state(resumed, straight)

  flat = train({"mesh_model": "1"}, None, entries, entries, tmp_path / "ck3",
               checkpoint=ckpt, max_iterations=4, device="cpu")
  assert flat["step"] == 4
  for a, b in zip(tree_leaves(flat["params"]),
                  tree_leaves(straight["params"])):
    np.testing.assert_allclose(a, b, atol=1e-5)
  flat_ckpt = CheckpointWaveglow.load(tmp_path / "ck3" / "4.npz")
  assert flat_ckpt.get_hparams().mesh_model == 1
  back = train({"mesh_model": "2"}, None, entries, entries, tmp_path / "ck4",
               checkpoint=CheckpointWaveglow.load(tmp_path / "ck3" / "4.npz"),
               max_iterations=5, device="cpu", mesh_devices=["cpu"] * 2)
  again = train(None, None, entries, entries, tmp_path / "ck5",
                checkpoint=flat_ckpt, max_iterations=5, device="cpu")
  for a, b in zip(tree_leaves(back["params"]), tree_leaves(again["params"])):
    np.testing.assert_allclose(a, b, atol=1e-5)
