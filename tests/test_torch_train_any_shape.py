"""The port's training at every shape the JAX package trains: any odd
``kernel_size`` and any even ``n_channels``, which on the card run through
the shape-generic kernels (``csrc/wn_layer_any.cu`` forward,
``csrc/wn_layer_bwd_any.cu`` bf16 backward) and here through their plain
versions. Against the JAX package on the same numpy weights and batches:
the WN stack's gradients (``jax.vjp`` of the JAX XLA body), one train step,
the bf16 backward's rounding points over K taps (a closed form in JAX
ops), ``train()``'s save and resume in both stores and the ``train``
command's checkpoint. Tiny configs (at most 3 flows, 3 layers, C <= 50);
every ``end`` conv randomised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.dsp.mel import MelSTFT as JaxMel
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu.models import wn as jax_wn
from waveglow_tpu.training import loop as jax_loop
from waveglow_tpu.training import step as jax_step
from waveglow_tpu_torch.checkpointing import (get_last_checkpoint_any,
                                              load_checkpoint_lazy)
from waveglow_tpu_torch.checkpointing.from_jax import (
    trainable_params_from_numpy, tree_leaves)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.cli import main as cli
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models import wn as port_wn
from waveglow_tpu_torch.models.waveglow import WaveGlowConfig
from waveglow_tpu_torch.training import step
from waveglow_tpu_torch.training.loop import train

from test_torch_backward import closed_form_bf16, dyadic_inputs
from test_torch_training import (assert_states_close, to_jax_entries,
                                 write_speech_dataset)

NAMES = ("x", "cond", "w_in", "b_in", "w_rs", "b_rs")
# The two tiny models of tests/test_torch_any_shape.py: kernel_size 5 at a
# built-in width, and a width no specialised kernel is built for; trained
# as tests/test_torch_training.py's STEP_HPARAMS trains.
CONFIGS = {"k5": {"n_flows": "3", "n_layers": "3", "n_channels": "32",
                  "kernel_size": "5"},
           "c48": {"n_flows": "3", "n_layers": "3", "n_channels": "48"}}
STEP = {"segment_length": "2048", "batch_size": "2", "remat": "false"}
# train() with saves: tests/test_torch_training.py's LOOP_HPARAMS at K = 5.
LOOP = {"n_flows": "2", "n_layers": "2", "n_channels": "32",
        "kernel_size": "5", "segment_length": "2048", "batch_size": "2",
        "epochs_per_checkpoint": "0", "seed": "1234"}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch: the suite runs its files in parallel
  worker processes."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def randomize_end(wn, rng, scale=0.1):
  """A WN stack's ``end`` conv drawn from ``rng`` (its zero init hides the
  stack from every output)."""
  for k in ("w", "b"):
    wn["end"][k] = (rng.standard_normal(wn["end"][k].shape)
                    * scale).astype(np.float32)


# -- the WN stack ---------------------------------------------------------------

@pytest.mark.parametrize("c,k", [(32, 5), (48, 3), (50, 3), (40, 7), (32, 1)])
def test_wn_forward_train_grads_match_jax_vjp(c, k):
  """``wn_forward_train``'s gradients with respect to every leaf, the audio
  and the conditioning (autograd through ``wn_layer_trainable``, its CPU
  route: the plain forward and ``wn_layer_backward`` over K taps) against
  ``jax.vjp`` of the JAX package's XLA body ``wn_forward`` on the same
  weight-norm leaves, f32, 3 layers (dilations 1, 2, 4): each within 1e-5
  of its max |value| (the K*C deep conv is one im2col product there, K
  products here; sums in other orders)."""
  rng = np.random.default_rng(10 * c + k)
  n_half, n_mel, layers, batch, t = 4, 16, 3, 2, 40
  params = port_wn.init_wn_params(rng, n_half, n_mel, layers, c, k)
  randomize_end(params, rng)
  audio = rng.standard_normal((batch, t, n_half)).astype(np.float32)
  spect = rng.standard_normal((batch, t, n_mel)).astype(np.float32)
  cot = rng.standard_normal((batch, t, 2 * n_half)).astype(np.float32)

  @jax.jit
  def jax_vjp(p, a, s, ct):
    out, vjp = jax.vjp(
        lambda p, a, s: jax_wn.wn_forward(p, a, s, c, layers, k), p, a, s)
    return out, vjp(ct)

  out, (ref_params, ref_audio, ref_spect) = jax_vjp(
      params, jnp.asarray(audio), jnp.asarray(spect), jnp.asarray(cot))
  refs = [*jax.tree_util.tree_leaves(ref_params), ref_audio, ref_spect]

  tparams = trainable_params_from_numpy(params, "cpu")
  a = torch.tensor(audio, requires_grad=True)
  s = torch.tensor(spect, requires_grad=True)
  got = port_wn.wn_forward_train(tparams, a, s, c, layers, k)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                             rtol=0, atol=1e-5 * np.abs(out).max())
  (got * torch.from_numpy(cot)).sum().backward()
  grads = [p.grad for p in tree_leaves(tparams)] + [a.grad, s.grad]
  assert len(grads) == len(refs)
  for n, (g, r) in enumerate(zip(grads, refs)):
    r = np.asarray(r)
    assert g.shape == r.shape, n
    scale = np.abs(r).max()
    assert scale > 0, n  # every leaf reaches the output
    np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * scale,
                               err_msg=f"leaf {n}")


# -- one train step -------------------------------------------------------------

def step_model(custom, seed=0):
  """Params of ``custom`` with every ``end`` randomised, and audio."""
  hp = jax_overwrite(JaxHParams(), custom)
  params = jax_model.init_params(jax_model.WaveGlowConfig.from_hparams(hp),
                                 seed=seed)
  rng = np.random.default_rng(seed + 1)
  for flow in params["flows"]:
    randomize_end(flow["wn"], rng, 0.05)
  audio = rng.uniform(-0.5, 0.5, (2, 2048)).astype(np.float32)
  return params, audio


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_jax(name):
  """Loss, every leaf's gradient, the params and the Adam state after one
  step against JAX ``make_train_step`` (its XLA route, f32), at the bounds
  of ``tests/test_torch_training.py::test_train_step_matches_jax``: loss
  1e-5 relative; grads 1e-6 abs plus 1e-4 relative; params 2e-6 abs; Adam
  moments 1e-8 abs plus 1e-4 relative. JAX's grads are read from its Adam
  state (optax's first step stores ``mu = (1 - b1) * grad``)."""
  custom = dict(CONFIGS[name], **STEP)
  params, audio = step_model(custom)
  hp = jax_overwrite(JaxHParams(), custom)
  optimizer = jax_step.make_optimizer(hp.learning_rate)
  state, ref_loss = jax_step.make_train_step(
      jax_model.WaveGlowConfig.from_hparams(hp), hp, JaxMel(hp), optimizer)(
          jax_step.init_state(params, optimizer), jnp.asarray(audio))
  ref_opt = jax.tree_util.tree_leaves(state["opt_state"])

  php = overwrite_custom_hparams(HParams(), custom)
  tparams = trainable_params_from_numpy(params, "cpu")
  opt = step.make_optimizer(tparams, php.learning_rate)
  loss = float(step.make_train_step(WaveGlowConfig.from_hparams(php), php,
                                    MelSTFT(php, device="cpu"), opt)(
                                        tparams, torch.from_numpy(audio)))
  leaves = tree_leaves(tparams)
  grads = [p.grad.numpy() for p in leaves]
  adam = step.adam_state_to_optax(opt, tparams)
  ref_grads = [np.asarray(m) / (1 - 0.9) for m in ref_opt[1:1 + len(grads)]]

  assert loss == pytest.approx(float(ref_loss), rel=1e-5)
  assert len(ref_opt) == len(adam) == 1 + 2 * len(grads)
  for n, (g, r) in enumerate(zip(grads, ref_grads)):
    np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-4, err_msg=str(n))
  for p, r in zip(leaves, jax.tree_util.tree_leaves(state["params"])):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), atol=2e-6)
  assert int(adam[0]) == int(ref_opt[0]) == 1
  for a, b in zip(adam[1:], ref_opt[1:]):
    np.testing.assert_allclose(a, np.asarray(b), atol=1e-8, rtol=1e-4)


# -- the bf16 rounding points over K taps -------------------------------------------

@pytest.mark.parametrize("k,dilation,t,last,valid", [
    (1, 1, 40, False, None),
    (5, 4, 37, False, [37, 28]),     # per-row valid_t
    (7, 16, 37, True, [34, 37]),     # last layer; taps past both ends
])
def test_bf16_rounding_points_match_a_closed_form_at_k_taps(k, dilation, t,
                                                            last, valid):
  """wn_layer_backward(compute_dtype=bf16) at K taps against
  ``tests/test_torch_backward.py``'s closed form in JAX ops over K taps,
  each gradient within 1e-5 of its max |value| (the products before every
  rounding are exact, the f32 sums after it differ in order only), as that
  file holds it at 3 taps."""
  inputs, cot = dyadic_inputs(2, t, 8, last, seed=k + dilation, k=k)
  args = [torch.from_numpy(a) for a in inputs]
  args = [a.to(torch.bfloat16) if i in (1, 2, 4) else a
          for i, a in enumerate(args)]
  valid_t = None if valid is None else torch.tensor(valid, dtype=torch.int32)
  got = kl.wn_layer_backward(tuple(args), *map(torch.from_numpy, cot),
                             dilation, valid_t, torch.bfloat16)
  ref = closed_form_bf16(inputs, cot, dilation, valid)
  for name, g, a, r in zip(NAMES, got, args, ref):
    assert g.dtype == a.dtype and g.shape == a.shape, name
    scale = np.abs(r).max()
    assert scale > 0, name
    np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                               atol=1e-5 * scale, err_msg=name)


def test_backward_takes_its_taps_from_w_in():
  """A K = 5 layer whose outer taps are zero has the K = 3 layer's
  gradients of its inner taps, and zero-tap rows' gradients are the outer
  taps' own; the K = 3 call is unchanged by the generalisation (the
  shard's backward calls it at 3 taps)."""
  inputs, cot = dyadic_inputs(2, 30, 6, False, seed=3)
  saved3 = tuple(torch.from_numpy(a) for a in inputs)
  w5 = torch.cat([torch.zeros(1, 6, 12), saved3[2], torch.zeros(1, 6, 12)])
  saved5 = saved3[:2] + (w5,) + saved3[3:]
  cots = [torch.from_numpy(g) for g in cot]
  g3 = kl.wn_layer_backward(saved3, *cots, 2)
  g5 = kl.wn_layer_backward(saved5, *cots, 2)
  for name, a, b in zip(NAMES, g3, g5):
    if name == "w_in":
      b = b[1:4]
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6,
                               err_msg=name)


# -- train(): save and resume in both stores, and the command ------------------------

@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_train_resume_at_kernel_size_5_equals_straight_run(tmp_path, backend):
  """``train()`` at kernel_size 5: 3 steps with a save at 2, and a resume
  from that save (npz, or an async orbax directory) to step 3, give the
  straight run's params and Adam state bit for bit."""
  custom = dict(LOOP, iters_per_checkpoint="2", checkpoint_backend=backend,
                checkpoint_async=str(backend == "orbax").lower())
  entries = write_speech_dataset(tmp_path / "data")
  straight = train(custom, None, entries, entries, tmp_path / "ck",
                   max_iterations=3, device="cpu")
  saved = load_checkpoint_lazy(
      tmp_path / "ck" / ("2.npz" if backend == "npz" else "2.orbax"))
  resumed = train(None, None, entries, entries, tmp_path / "ck2",
                  checkpoint=saved, max_iterations=3, device="cpu")
  assert resumed["step"] == straight["step"] == 3
  assert resumed["params"]["flows"][0]["wn"]["in_layers"][0]["v"].shape == (
      5, 32, 2, 32)
  for a, b in zip(tree_leaves(resumed["params"]),
                  tree_leaves(straight["params"])):
    np.testing.assert_array_equal(a, b)
  for a, b in zip(resumed["opt_state"], straight["opt_state"]):
    np.testing.assert_array_equal(a, b)


def test_train_command_at_kernel_size_5_writes_a_checkpoint_jax_resumes(
    tmp_path):
  """``train --custom-hparams kernel_size=5,...`` writes checkpoints that
  the JAX package loads with kernel_size 5 and its params; the JAX
  ``train()`` resumed from the first takes the step the port took from it
  (params and Adam state within ``assert_states_close``'s bounds)."""
  entries = write_speech_dataset(tmp_path / "train")
  write_speech_dataset(tmp_path / "val", n=2, seed=1)
  custom = ",".join(f"{k}={v}" for k, v in dict(
      LOOP, iters_per_checkpoint="1", epochs="1").items())
  assert cli.run(["train", str(tmp_path / "train"), str(tmp_path / "val"),
                  str(tmp_path / "ck"), "--custom-hparams", custom,
                  "--device", "cpu", "--log", str(tmp_path / "log")]) == 0
  last, it = get_last_checkpoint_any(tmp_path / "ck")
  assert it == 2
  theirs = JaxCkpt.load(tmp_path / "ck" / "1.npz")
  assert theirs.get_hparams().kernel_size == 5
  ours = CheckpointWaveglow.load(tmp_path / "ck" / "1.npz")
  for a, b in zip(jax.tree_util.tree_leaves(theirs.state_dict),
                  tree_leaves(ours.state_dict)):
    np.testing.assert_array_equal(np.asarray(a), b)

  jax_entries = to_jax_entries(entries)
  ref = jax_loop.train(None, None, jax_entries, jax_entries,
                       tmp_path / "jax2", checkpoint=theirs,
                       max_iterations=2)
  port = train(None, None, entries, entries, tmp_path / "port2",
               checkpoint=ours, max_iterations=2, device="cpu")
  assert_states_close(port, ref)
  for a, b in zip(tree_leaves(port["params"]),
                  tree_leaves(CheckpointWaveglow.load(last).state_dict)):
    np.testing.assert_array_equal(a, b)
