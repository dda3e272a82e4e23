"""The port's device meshes, tensor-parallel placement, the shard layer's
plain version, the tensor-parallel WN stack and time-sharded synthesis
(``waveglow_tpu_torch/parallel/``), on the CPU: meshes list ``"cpu"`` once
per shard, so every sharded path runs here, one shard after another.

References: the port's unsharded ``infer`` (time sharding bit for bit,
the model axis at 1e-5 of max |wav|), the JAX package's ``infer`` on
``shard_params`` of a (2, 4) mesh and its ``infer_long`` on an 8-way time
mesh, both on the 8 virtual CPU devices of ``tests/conftest.py``, at atol
2e-4 (the synthesizer tests' bound: the same f32 model summed in other
orders). Tiny config (5 flows, 3 layers, 32 channels), every ``end`` conv
randomised; inputs and noise from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_serving import TINY, tiny_checkpoint
from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.inference.serving import BatchSynthesizer as JaxBatch
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu.parallel import mesh as jax_mesh
from waveglow_tpu.parallel import sharding as jax_sharding
from waveglow_tpu_torch.cli.main import build_parser
from waveglow_tpu_torch.cli.serve_cmd import build_mesh
from waveglow_tpu_torch.inference.serving import BatchSynthesizer
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models import waveglow as pm
from waveglow_tpu_torch.models.wn import wn_forward, wn_forward_tp
from waveglow_tpu_torch.parallel import mesh as mesh_lib
from waveglow_tpu_torch.parallel.sharding import param_specs, shard_params
from waveglow_tpu_torch.parallel.time_shard import (infer_time_sharded,
                                                    span_windows, time_spans)

CFG = pm.WaveGlowConfig(n_flows=5, n_layers=3, n_channels=32)
CPU = torch.device("cpu")
# The model axis against the unsharded model, relative to max |wav|: the
# res/skip product is summed over the ranks in another order.
TP_TOL_REL = 1e-5
JAX_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fused():
  return pm.fuse_for_inference(tiny_checkpoint(seed=3).state_dict)


@pytest.fixture(scope="module")
def unsharded(fused):
  return pm.params_to_torch(fused, CPU)


def cpu_mesh(data=1, model=1):
  return mesh_lib.make_mesh(data, model, devices=["cpu"] * (data * model))


def rand_mel(frames, batch=1, seed=0):
  return np.random.default_rng(seed).standard_normal(
      (batch, 80, frames)).astype(np.float32)


def rand_noise(frames, batch=1, seed=0):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal(s).astype(np.float32)
          for s in pm.infer_noise_shapes(CFG, batch, frames * 32)]


# -- meshes ---------------------------------------------------------------------

@pytest.mark.parametrize("data,model", [(2, 1), (1, 4), (2, 2), (4, 2)])
def test_make_mesh_shape_and_axis_order(data, model):
  devices = [f"cpu:{i}" for i in range(data * model + 1)]
  mesh = mesh_lib.make_mesh(data, model, devices=devices)
  assert dict(mesh.shape) == {"data": data, "model": model}
  assert mesh.axis_names == ("data", "model")
  # the model axis is the minor one: a model group is consecutive devices
  for i in range(data):
    assert [str(d) for d in mesh.devices[i]] == devices[i * model:
                                                        (i + 1) * model]
  assert mesh.first_device == torch.device("cpu:0")


def test_make_time_mesh_and_repeated_devices():
  mesh = mesh_lib.make_time_mesh(4, devices=["cpu"] * 4)
  assert dict(mesh.shape) == {"time": 4}
  assert mesh.size("data") == 1 and mesh.size("time") == 4
  assert list(mesh.devices) == [CPU] * 4


@pytest.mark.parametrize("build,match", [
    (lambda: mesh_lib.make_mesh(2, 1), r"needs 2 CUDA devices \(cards\), "
                                       r"have 0"),
    (lambda: mesh_lib.make_time_mesh(4), r"needs 4 CUDA devices"),
    (lambda: mesh_lib.make_mesh(2, 2, devices=["cpu"] * 3),
     "needs 4 devices, have 3"),
    (lambda: mesh_lib.make_mesh(0, 1), "must be >= 1"),
], ids=["data-no-card", "time-no-card", "too-few-listed", "zero"])
def test_mesh_refusals(monkeypatch, build, match):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(ValueError, match=match):
    build()


# -- placement ------------------------------------------------------------------

def test_param_specs_cover_every_leaf_and_match_jax(fused):
  specs = param_specs(fused)
  jax_specs = jax_sharding.param_pspecs(fused)
  leaves = jax.tree_util.tree_leaves(fused)
  flat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
      x, tuple))
  jax_flat = jax.tree_util.tree_leaves(
      jax_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
  assert len(flat) == len(leaves) == len(jax_flat)
  assert jax.tree_util.tree_structure(fused) == jax.tree_util.tree_structure(
      specs, is_leaf=lambda x: isinstance(x, tuple))
  for ours, theirs in zip(flat, jax_flat):
    assert ours == tuple(theirs)


@pytest.mark.parametrize("model", [2, 4])
def test_shard_params_slices_every_leaf(fused, model):
  grid = shard_params(fused, cpu_mesh(2, model))
  assert len(grid) == 2 and all(len(row) == model for row in grid)
  c, cp = 32, 32 // model
  specs = param_specs(fused)
  for rank in range(model):
    tree = grid[1][rank]
    flat = jax.tree_util.tree_leaves(tree)
    for leaf, ref, spec in zip(
        flat, jax.tree_util.tree_leaves(fused),
        jax.tree_util.tree_leaves(specs,
                                  is_leaf=lambda x: isinstance(x, tuple))):
      assert leaf.is_contiguous() and leaf.dtype == torch.float32
      if "model" not in spec:
        np.testing.assert_array_equal(leaf.numpy(), ref)
        continue
      dim = spec.index("model")
      assert leaf.shape[dim] == ref.shape[dim] // model
      part = np.take(ref, range(rank * leaf.shape[dim],
                                (rank + 1) * leaf.shape[dim]), axis=dim)
      np.testing.assert_array_equal(leaf.numpy(), part)
    wn = tree["flows"][0]["wn"]
    m = wn["cond"]["w"].shape[0]
    assert tuple(wn["in_layers"][0]["w"].shape) == (3, c, 2, cp)
    assert tuple(wn["in_layers"][0]["b"].shape) == (2, cp)
    assert tuple(wn["cond"]["w"].shape) == (m, 3, 2, cp)
    assert tuple(wn["cond"]["b"].shape) == (3, 2, cp)
    assert tuple(wn["res_skip"][0]["w"].shape) == (cp, 2, c)
    assert tuple(wn["res_skip"][-1]["w"].shape) == (cp, c)
    assert tuple(wn["res_skip"][0]["b"].shape) == (2, c)
  # one device listed twice holds each (leaf, rank) once
  assert grid[0][1]["flows"][0]["wn"]["cond"]["w"] is (
      grid[1][1]["flows"][0]["wn"]["cond"]["w"])


# -- the shard layer and the tensor-parallel stack -------------------------------

def layer_inputs(c, last, seed=0, batch=2, t=40):
  rng = np.random.default_rng(seed)

  def rand(*shape, scale):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))

  rs = c if last else 2 * c
  return (rand(batch, t, c, scale=0.5), rand(batch, t, 2, c, scale=0.5),
          rand(3, c, 2, c, scale=(3 * c) ** -0.5), rand(2, c, scale=0.1),
          rand(c, rs // c, c, scale=c ** -0.5) if not last
          else rand(c, c, scale=c ** -0.5), rand(rs, scale=0.1))


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_shard_plain_partials_sum_to_the_layer(model, last, mode):
  """The ranks' partials of ``wn_layer_shard_plain``, summed, plus b_rs:
  the full plain layer's res/skip, at 1e-5 (f32; the K sums split over
  ranks) and at the bf16 kernel bound (2e-2 of max |ref|: an f32 ulp can
  flip an act's bf16 rounding)."""
  c, cdt = 32, (torch.bfloat16 if mode == "bf16" else None)
  x, cond, w_in, b_in, w_rs, b_rs = layer_inputs(c, last, seed=model)
  cp = c // model
  total = 0
  for r in range(model):
    cols = slice(r * cp, (r + 1) * cp)
    total = total + kl.wn_layer_shard(
        x, cond[..., cols].reshape(2, 40, 2 * cp),
        w_in[..., cols].reshape(3, c, 2 * cp), b_in[:, cols].reshape(-1),
        w_rs[cols].reshape(cp, -1), 4, compute_dtype=cdt)
  x_next, skip = kl.wn_layer_plain(x, cond, w_in, b_in, w_rs, b_rs, 4,
                                   compute_dtype=cdt)
  full = skip if last else torch.cat([x_next - x, skip], dim=-1)
  scale = full.abs().max().item()
  bound = 1e-5 if mode == "f32" else 2e-2 * scale
  assert (total + b_rs.reshape(-1) - full).abs().max().item() <= bound


def test_reduce_gives_every_rank_the_same_bits(fused):
  """One layer over 4 ranks: the partials summed in rank order, the same
  bits on every rank (``reduce_partials``), so the ranks' residual streams
  after the layer are equal bit for bit."""
  grid = shard_params(fused, cpu_mesh(1, 4))
  shards = [tree["flows"][0]["wn"] for tree in grid[0]]
  rng = np.random.default_rng(5)
  x = torch.from_numpy(rng.standard_normal((2, 30, 32)).astype(np.float32))
  cond = torch.from_numpy(rng.standard_normal((2, 30, 2, 32)).astype(
      np.float32))
  partials = []
  for r, shard in enumerate(shards):
    partials.append(kl.wn_layer_shard(
        x, cond[..., r * 8:(r + 1) * 8].reshape(2, 30, 16),
        shard["in_layers"][0]["w"].reshape(3, 32, 16),
        shard["in_layers"][0]["b"].reshape(-1),
        shard["res_skip"][0]["w"].reshape(8, -1), 1))
  sums = mesh_lib.reduce_partials(partials)
  assert len(sums) == 4
  assert torch.equal(sums[0], ((partials[0] + partials[1]) + partials[2])
                     + partials[3])
  residuals = [x + (total + shard["res_skip"][0]["b"].reshape(-1))[..., :32]
               for total, shard in zip(sums, shards)]
  for res in residuals[1:]:
    assert torch.equal(res, residuals[0])


@pytest.mark.parametrize("model", [2, 4])
def test_wn_forward_tp_matches_wn_forward(fused, unsharded, model):
  grid = shard_params(fused, cpu_mesh(1, model))
  rng = np.random.default_rng(model)
  audio0 = torch.from_numpy(rng.standard_normal((2, 48, 4)).astype(
      np.float32))
  spect = torch.from_numpy(rng.standard_normal((2, 48, 640)).astype(
      np.float32))
  valid = torch.tensor([48, 30], dtype=torch.int32)
  ref = wn_forward(unsharded["flows"][0]["wn"], audio0, spect, 32, 3, 3,
                   valid_t=valid)
  out = wn_forward_tp([t["flows"][0]["wn"] for t in grid[0]], audio0,
                      [spect] * model, 32, 3, 3, valid_ts=[valid] * model)
  scale = ref.abs().max().item()
  assert scale > 0.1
  assert (out - ref).abs().max().item() <= TP_TOL_REL * scale


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 4)])
def test_infer_on_a_model_mesh_matches_jax_tp(fused, unsharded, data, model):
  """The port's ``infer`` over a tensor-parallel group against the JAX
  ``infer`` on ``shard_params`` of a (2, 4) mesh, the same injected noise,
  and against the port's unsharded ``infer``."""
  mel = rand_mel(12, batch=2, seed=model)
  noise = rand_noise(12, batch=2, seed=model)
  grid = shard_params(fused, cpu_mesh(data, model))
  out = pm.infer(grid[-1], CFG, mel, sigma=0.8, noise=noise,
                 true_frames=[12, 9], device="cpu").numpy()
  ref = pm.infer(unsharded, CFG, mel, sigma=0.8, noise=noise,
                 true_frames=[12, 9], device="cpu").numpy()
  scale = np.abs(ref).max()
  assert scale > 0.1
  assert np.abs(out - ref).max() <= TP_TOL_REL * scale
  jmesh = jax_mesh.make_mesh(data=2, model=4)
  jparams = jax_sharding.shard_params(fused, jmesh)
  jref = np.asarray(jax.jit(lambda p, m, n: jax_model.infer(
      p, jax_model.WaveGlowConfig(**{k: int(v) for k, v in TINY.items()}),
      m, sigma=0.8, noise=n, true_frames=jnp.asarray([12, 9])))(
          jparams, jnp.asarray(mel), [jnp.asarray(n) for n in noise]))
  np.testing.assert_allclose(out, jref, atol=JAX_ATOL)


# -- time sharding ----------------------------------------------------------------

@pytest.mark.parametrize("frames,n", [(1, 4), (3, 4), (37, 4), (40, 8),
                                      (41, 8), (8, 2), (9, 2)])
def test_time_spans_cover_the_frames(frames, n):
  spans = time_spans(frames, n)
  assert len(spans) == n and spans[0][0] == 0 and spans[-1][1] == frames
  lengths = [e - s for s, e in spans]
  assert all(a >= b for a, b in zip(lengths, lengths[1:]))
  assert max(lengths) - min(lengths) <= 1
  for (_, e), (s, _) in zip(spans, spans[1:]):
    assert e == s
  windows = span_windows(frames, n, halo=5)
  assert len(windows) == min(frames, n)     # empty spans are skipped
  for s, e, lo, hi in windows:
    assert lo == max(0, s - 5) and hi == min(frames, e + 5)


def time_params(unsharded, fused, n):
  return [row[0] for row in shard_params(
      fused, mesh_lib.make_time_mesh(n, devices=["cpu"] * n))]


@pytest.mark.parametrize("frames,n", [(1, 4), (3, 4), (37, 4), (32, 2),
                                      (37, 2), (64, 8), (61, 8)])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_time_sharded_equals_one_call_bit_for_bit(fused, unsharded, frames,
                                                  n, mode):
  """Spans that do and do not divide evenly, fewer frames than devices
  (C2: ``frames < time`` leaves devices idle): the stitched waveform is the
  unsharded call's, every bit."""
  cdt = torch.bfloat16 if mode == "bf16" else None
  params = [pm.params_for_compute(p, cdt)
            for p in time_params(unsharded, fused, n)]
  mel = rand_mel(frames, batch=2, seed=frames)
  seeds = [11, 12]
  ref = pm.infer(pm.params_for_compute(unsharded, cdt), CFG, mel, seed=seeds,
                 compute_dtype=cdt, device="cpu")
  out = infer_time_sharded(params, CFG, mel, seed=seeds, compute_dtype=cdt)
  assert out.shape == ref.shape == (2, frames * 256)
  assert torch.equal(out, ref)


def test_time_sharded_masks_and_takes_noise(fused, unsharded):
  mel = rand_mel(37, batch=2, seed=4)
  noise = rand_noise(37, batch=2, seed=4)
  params = time_params(unsharded, fused, 4)
  ref = pm.infer(unsharded, CFG, mel, sigma=0.7, noise=noise,
                 true_frames=[37, 20], device="cpu")
  out = infer_time_sharded(params, CFG, mel, sigma=0.7, noise=noise,
                           true_frames=[37, 20])
  assert torch.equal(out, ref)


def test_infer_long_matches_jax_infer_long(tmp_path):
  """``infer_long`` on an 8-way time mesh against the JAX package's on its
  8 virtual devices, at sigma 0 (both RNGs drop out). The JAX mesh takes
  only a frame count that 8 divides (C2); uneven counts are held to the
  port's one call above."""
  ckpt = tiny_checkpoint(seed=6)
  ckpt.save(tmp_path / "t.npz")
  mel = rand_mel(64, seed=6)[0]
  port = BatchSynthesizer(ckpt, mesh=mesh_lib.make_time_mesh(
      8, devices=["cpu"] * 8)).infer_long(mel, sigma=0.0, seed=3)
  one = BatchSynthesizer(ckpt, device="cpu").infer_batch(mel[None], sigma=0.0,
                                                         seed=3)[0]
  np.testing.assert_array_equal(port, one)
  ref = JaxBatch(JaxCkpt.load(tmp_path / "t.npz"),
                 mesh=jax_mesh.make_time_mesh(8)).infer_long(mel, sigma=0.0,
                                                             seed=3)
  assert port.shape == ref.shape == (64 * 256,)
  assert np.abs(ref).max() > 0.1
  np.testing.assert_allclose(port, ref, atol=JAX_ATOL)


# -- the serve command's mesh -------------------------------------------------------

def test_serve_mesh_flags_build_the_mesh(tmp_path, monkeypatch):
  path = tmp_path / "t.npz"
  tiny_checkpoint().save(path)
  parser = build_parser()

  def ns(*flags, device="cpu"):
    return parser.parse_args(["serve", str(path), "--device", device, *flags])

  assert build_mesh(ns()) is None
  mesh = build_mesh(ns("--mesh-data", "2", "--mesh-model", "2"))
  assert dict(mesh.shape) == {"data": 2, "model": 2}
  assert list(mesh.devices.flat) == [CPU] * 4
  mesh = build_mesh(ns("--mesh-time", "4"))
  assert dict(mesh.shape) == {"time": 4}
  with pytest.raises(ValueError, match="mutually exclusive"):
    build_mesh(ns("--mesh-time", "4", "--mesh-data", "2"))
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(ValueError, match=r"needs 2 CUDA devices \(cards\)"):
    build_mesh(ns("--mesh-data", "2", device="cuda"))
