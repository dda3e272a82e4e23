"""The training step: on-device mel, NLL, backward, Adam (counterpart of
``waveglow_tpu/training/step.py``).

Params are a tree of float32 leaf tensors (weight-norm kept as ``(g, v)``);
the optimizer is ``torch.optim.Adam`` over its leaves in ``jax.tree_util``'s
order. :func:`adam_state_to_optax` and :func:`adam_state_from_optax` carry
the Adam state to and from optax's positional layout (``count``, then the
``mu`` leaves, then the ``nu`` leaves), so either package resumes the
other's checkpoint.

:func:`make_mesh_train_step` is the step on a (data, model) mesh, one
process or several: each data replica (a model group,
``parallel.sharding.shard_trainable_params``) takes its rows of the batch,
and the replicas' gradients are summed in global data-rank order (in the
process, then across processes in process order) and divided by their
count, so every replica's Adam sees the same bits.
:func:`adam_state_to_optax_group` and :func:`adam_state_from_optax_group`
gather and scatter a group's Adam state in optax's layout, so a checkpoint
saved on a mesh resumes on no mesh and the other way round.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.hparams import HParams
from waveglow_tpu_torch.kernels.wn_layer import wn_layer_trainable
from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, forward
from waveglow_tpu_torch.models.wn import LayerFn
from waveglow_tpu_torch.ops.conv import compute_dtype_from_name
from waveglow_tpu_torch.parallel.mesh import (all_reduce_ordered,
                                              process_count)
from waveglow_tpu_torch.parallel.sharding import (distinct_leaves,
                                                  gather_tree,
                                                  shard_leaf_pairs)
from waveglow_tpu_torch.training.loss import waveglow_loss


def make_optimizer(params: Dict, learning_rate: float) -> torch.optim.Adam:
  """Adam with b1 0.9, b2 0.999, eps 1e-8 over the leaves of ``params``
  (optax.adam's update: ``lr * mu_hat / (sqrt(nu_hat) + eps)``)."""
  return torch.optim.Adam(tree_leaves(params), lr=learning_rate,
                          betas=(0.9, 0.999), eps=1e-8)


def adam_state_to_optax(optimizer: torch.optim.Adam,
                        params: Dict) -> List[np.ndarray]:
  """Adam state as optax's leaves: int32 ``count``, then ``mu`` and ``nu``
  per param leaf in ``jax.tree_util`` order (zeros before the first
  step)."""
  leaves = tree_leaves(params)
  states = [optimizer.state.get(p, {}) for p in leaves]
  count = int(states[0]["step"]) if states[0] else 0

  def moment(p, state, key):
    if not state:
      return np.zeros(tuple(p.shape), np.float32)
    return state[key].detach().to("cpu", torch.float32).numpy()

  return ([np.asarray(count, dtype=np.int32)]
          + [moment(p, s, "exp_avg") for p, s in zip(leaves, states)]
          + [moment(p, s, "exp_avg_sq") for p, s in zip(leaves, states)])


def adam_state_from_optax(optimizer: torch.optim.Adam, params: Dict,
                          opt_leaves: List[np.ndarray]) -> None:
  """Load optax's positional Adam leaves (see :func:`adam_state_to_optax`)
  into ``optimizer``; raises ``ValueError`` when they do not fit
  ``params``."""
  leaves = tree_leaves(params)
  n = len(leaves)
  if len(opt_leaves) != 1 + 2 * n:
    raise ValueError(f"optimizer state has {len(opt_leaves)} leaves, "
                     f"expected {1 + 2 * n} (count, mu, nu) for {n} params")
  count = int(np.asarray(opt_leaves[0]))
  for i, p in enumerate(leaves):
    mu, nu = (np.asarray(opt_leaves[1 + j * n + i], np.float32)
              for j in (0, 1))
    if mu.shape != tuple(p.shape) or nu.shape != tuple(p.shape):
      raise ValueError(f"optimizer leaf {i}: shape {mu.shape}, param "
                       f"{tuple(p.shape)}")
    if count == 0:
      continue
    optimizer.state[p] = {
        "step": torch.tensor(float(count), dtype=torch.float32),
        "exp_avg": torch.tensor(mu, device=p.device),
        "exp_avg_sq": torch.tensor(nu, device=p.device)}


def make_loss_fn(config: WaveGlowConfig, hp: HParams, mel_op: MelSTFT,
                 layer: LayerFn = wn_layer_trainable) -> Callable:
  """``loss_fn(params, audio [B, segment]) -> scalar NLL``, the mel computed
  on the audio's device."""
  cdt = compute_dtype_from_name(hp.compute_dtype)

  def loss_fn(params: Dict, audio: torch.Tensor) -> torch.Tensor:
    mel = mel_op.mel_spectrogram(audio)
    z, log_s_list, log_det_w_list = forward(
        params, config, mel, audio, compute_dtype=cdt, remat=hp.remat,
        remat_scope=hp.remat_scope, layer=layer)
    return waveglow_loss(z, log_s_list, log_det_w_list, hp.sigma)

  return loss_fn


def compute_grads(loss_fn: Callable, params: Dict, audio: torch.Tensor,
                  grad_accum: int = 1) -> torch.Tensor:
  """Fill every leaf's ``.grad`` with d loss / d leaf and return the loss
  (detached). ``params`` is a tree or a model group's rank trees (a leaf
  they share counts once). With ``grad_accum`` > 1 the batch splits into
  that many micro-batches, and the loss and grads are their means."""
  if audio.shape[0] % grad_accum:
    raise ValueError(f"batch size {audio.shape[0]} is not divisible by "
                     f"grad_accum={grad_accum}")
  leaves = distinct_leaves(params)
  for p in leaves:
    p.grad = None
  total = None
  for micro in audio.reshape(grad_accum, -1, *audio.shape[1:]):
    loss = loss_fn(params, micro)
    loss.backward()
    total = loss.detach() if total is None else total + loss.detach()
  if grad_accum > 1:
    for p in leaves:
      p.grad.div_(grad_accum)
    total = total / grad_accum
  return total


def make_train_step(config: WaveGlowConfig, hp: HParams, mel_op: MelSTFT,
                    optimizer: torch.optim.Adam) -> Callable:
  """``step(params, audio [B, segment]) -> loss``: value, backward (over
  ``hp.grad_accum`` micro-batches) and one Adam update of ``params`` in
  place."""
  loss_fn = make_loss_fn(config, hp, mel_op)

  def step(params: Dict, audio: torch.Tensor) -> torch.Tensor:
    loss = compute_grads(loss_fn, params, audio, hp.grad_accum)
    optimizer.step()
    return loss

  return step


def adam_state_to_optax_group(optimizer: torch.optim.Adam,
                              group: List[Dict]) -> List[np.ndarray]:
  """:func:`adam_state_to_optax` of a model group's optimizer (over
  ``distinct_leaves(group)``): the moments of the whole tree, each
  gathered from the ranks' slices, in optax's layout."""
  states = [optimizer.state.get(p, {}) for p in distinct_leaves(group)]
  count = int(states[0]["step"]) if states[0] else 0

  def moment(key):
    def value(p):
      state = optimizer.state.get(p, {})
      if not state:
        return np.zeros(tuple(p.shape), np.float32)
      return state[key].detach().to("cpu", torch.float32).numpy()
    return value

  return ([np.asarray(count, dtype=np.int32)]
          + gather_tree(group, moment("exp_avg"))
          + gather_tree(group, moment("exp_avg_sq")))


def adam_state_from_optax_group(optimizer: torch.optim.Adam,
                                group: List[Dict],
                                opt_leaves: List[np.ndarray]) -> None:
  """Load optax's Adam leaves of a whole tree into a model group's
  optimizer: each rank's leaves take their slices."""
  n = len(tree_leaves(group[0]))
  if len(opt_leaves) != 1 + 2 * n:
    raise ValueError(f"optimizer state has {len(opt_leaves)} leaves, "
                     f"expected {1 + 2 * n} (count, mu, nu) for {n} params")
  mu = shard_leaf_pairs(list(opt_leaves[1:1 + n]), group)
  nu = shard_leaf_pairs(list(opt_leaves[1 + n:]), group)
  adam_state_from_optax(optimizer, [p for p, _ in mu],
                        [opt_leaves[0]] + [m for _, m in mu]
                        + [v for _, v in nu])


def _group_device(group: List[Dict]) -> torch.device:
  return tree_leaves(group[0])[0].device


def sync_replica_grads(replicas: List[List[Dict]],
                       losses: List[torch.Tensor]) -> torch.Tensor:
  """Make every data replica's gradient the mean over all replicas of all
  processes, with the same bits on each: the sums run in global data-rank
  order (this process's replicas in order, then the processes' sums in
  process order through ``all_reduce_ordered``), then divide by the
  replica count. Returns the mean of the replicas' losses (each replica
  holds an equal share of the rows, so it is the global batch's loss)."""
  leaves = [distinct_leaves(group) for group in replicas]
  dev0 = _group_device(replicas[0])
  sums = []
  for j, p0 in enumerate(leaves[0]):
    total = p0.grad
    for rep in leaves[1:]:
      total = total + rep[j].grad.to(total.device)
    sums.append(total)
  loss = losses[0].to(dev0)
  for other in losses[1:]:
    loss = loss + other.to(dev0)
  count = len(replicas) * process_count()
  if process_count() > 1:
    flat = all_reduce_ordered(torch.cat(
        [loss.reshape(1).float()] + [s.reshape(-1).to(dev0) for s in sums]))
    loss, offset = flat[0], 1
    for j, s in enumerate(sums):
      sums[j] = flat[offset:offset + s.numel()].reshape(s.shape).to(s.device)
      offset += s.numel()
  means = [s / count for s in sums]
  for i, rep in enumerate(leaves):
    for p, mean in zip(rep, means):
      p.grad = mean if i == 0 else mean.to(p.device, copy=True)
  return loss / count


def make_mesh_train_step(config: WaveGlowConfig, hp: HParams,
                         replicas: List[List[Dict]],
                         optimizers: List[torch.optim.Adam]) -> Callable:
  """``step(audio [local B, segment]) -> loss`` on a (data, model) mesh:
  data replica i (``replicas[i]``, a model group on its devices, with
  ``optimizers[i]``) takes rows [i*B/D, (i+1)*B/D) of this process's
  batch; each computes its loss and gradients (``hp.grad_accum``
  micro-batches), the gradients are averaged over every replica of every
  process (:func:`sync_replica_grads`), and each replica's Adam steps.
  Returns the global batch's loss, the same on every process."""
  fns = []
  for group in replicas:
    mel_op = MelSTFT(hp, _group_device(group))
    loss_fn = make_loss_fn(config, hp, mel_op)
    fns.append((loss_fn, group if len(group) > 1 else group[0]))

  def step(audio: torch.Tensor) -> torch.Tensor:
    if audio.shape[0] % len(replicas):
      raise ValueError(f"a batch of {audio.shape[0]} rows does not split "
                       f"over {len(replicas)} data replicas")
    rows = audio.shape[0] // len(replicas)
    losses = [compute_grads(loss_fn, params,
                            audio[i * rows:(i + 1) * rows].to(
                                _group_device(replicas[i])),
                            hp.grad_accum)
              for i, (loss_fn, params) in enumerate(fns)]
    loss = sync_replica_grads(replicas, losses)
    for optimizer in optimizers:
      optimizer.step()
    return loss

  return step


def make_eval_loss(config: WaveGlowConfig, hp: HParams,
                   mel_op: MelSTFT) -> Callable:
  """Validation loss ``eval_loss(params, audio) -> scalar`` under
  ``torch.no_grad()`` (no remat: nothing is kept for a backward)."""
  loss_fn = make_loss_fn(config, dataclasses.replace(hp, remat=False),
                         mel_op)

  def eval_loss(params: Dict, audio: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
      return loss_fn(params, audio)

  return eval_loss
