"""Export the port's params to a reference-compatible torch checkpoint
(counterpart of ``waveglow_tpu/checkpointing/export_torch.py``).

The inverse of :mod:`waveglow_tpu_torch.checkpointing.import_torch`: writes
the reference ``Checkpoint`` dict ``{state_dict, optimizer, learning_rate,
iteration, hparams}`` whose state dict uses torch's weight-norm
parametrization naming (``parametrizations.weight.original0/1``), so the
reference's ``load_state_dict`` takes it directly.

Layouts: a 1x1 conv's ``[Cin, *out]`` becomes torch's ``[Cout, Cin, 1]``;
a k-tap conv's ``[K, Cin, *out]`` becomes ``[Cout, Cin, K]``; the
upsampler's ``[Cin, K, Cout]`` becomes ``[Cin, Cout, K]``.

The optimizer state is optax's positional Adam layout (an int32 ``count``,
then the ``mu`` leaves, then the ``nu`` leaves, each in ``jax.tree_util``
order: :func:`~waveglow_tpu_torch.training.step.adam_state_to_optax`),
read without optax: the moments are unflattened against the params tree
and go through the same layout transforms as the weights.
"""

from __future__ import annotations

from dataclasses import asdict
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.from_jax import (tree_leaves,
                                                       tree_unflatten)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.hparams import hparams_from_dict

# The hparams the reference knows; the rest are this project's own.
REFERENCE_HPARAMS = frozenset({
    "filter_length", "hop_length", "win_length", "window",
    "n_mel_channels", "sampling_rate", "mel_fmin", "mel_fmax",
    "epochs", "iters_per_checkpoint", "epochs_per_checkpoint", "seed",
    "cache_wavs", "cudnn_enabled", "cudnn_benchmark",
    "segment_length", "n_flows", "n_group", "n_early_every",
    "n_early_size", "n_layers", "n_channels", "kernel_size",
    "learning_rate", "sigma", "batch_size",
})


def _t(arr) -> torch.Tensor:
  return torch.from_numpy(np.ascontiguousarray(np.asarray(arr,
                                                          dtype=np.float32)))


def _conv_to_torch(conv: Dict, sd: Dict, prefix: str, kernel_axis: bool
                   ) -> None:
  """Write one conv dict into ``sd`` in torch naming and layout."""
  def to_torch_w(w) -> np.ndarray:
    w = np.asarray(w)
    if kernel_axis:
      k, cin = w.shape[0], w.shape[1]
      return w.reshape(k, cin, -1).transpose(2, 1, 0)   # [Cout, Cin, K]
    return w.reshape(w.shape[0], -1).T[:, :, None]      # [Cout, Cin, 1]

  if "v" in conv:
    g = np.asarray(conv["g"]).reshape(-1)
    sd[f"{prefix}.parametrizations.weight.original0"] = _t(g[:, None, None])
    sd[f"{prefix}.parametrizations.weight.original1"] = _t(
        to_torch_w(conv["v"]))
  else:
    sd[f"{prefix}.weight"] = _t(to_torch_w(conv["w"]))
  if "b" in conv:
    sd[f"{prefix}.bias"] = _t(np.asarray(conv["b"]).reshape(-1))


def params_to_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
  """Params tree -> torch state dict in the reference model's naming."""
  sd: Dict[str, torch.Tensor] = {}
  up_w = np.asarray(params["upsample"]["w"])               # [Cin, K, Cout]
  sd["upsample.weight"] = _t(up_w.transpose(0, 2, 1))      # [Cin, Cout, K]
  sd["upsample.bias"] = _t(params["upsample"]["b"])
  for k, flow in enumerate(params["flows"]):
    w = np.asarray(flow["inv1x1"]["w"])
    sd[f"convinv.{k}.conv.weight"] = _t(w[:, :, None])
    wn = flow["wn"]
    _conv_to_torch(wn["start"], sd, f"WN.{k}.start", kernel_axis=False)
    _conv_to_torch(wn["cond"], sd, f"WN.{k}.cond_layer", kernel_axis=False)
    for i, conv in enumerate(wn["in_layers"]):
      _conv_to_torch(conv, sd, f"WN.{k}.in_layers.{i}", kernel_axis=True)
    for i, conv in enumerate(wn["res_skip"]):
      _conv_to_torch(conv, sd, f"WN.{k}.res_skip_layers.{i}",
                     kernel_axis=False)
    _conv_to_torch(wn["end"], sd, f"WN.{k}.end", kernel_axis=False)
  return sd


WEIGHT_SUFFIXES = (".weight", ".weight_v",
                   ".parametrizations.weight.original1")


def count_flows_and_layers(sd: Dict):
  """(n_flows, n_layers) of a torch WaveGlow state dict, from its keys."""
  n_flows = 0
  while f"convinv.{n_flows}.conv.weight" in sd:
    n_flows += 1
  n_layers = 0
  while any(f"WN.0.in_layers.{n_layers}{s}" in sd for s in WEIGHT_SUFFIXES):
    n_layers += 1
  return n_flows, n_layers


def reference_parameter_order(sd: Dict) -> List[str]:
  """State-dict keys in the reference model's ``parameters()`` order.

  torch indexes optimizer state by parameter position, which follows
  module registration: ``upsample``, then each ``WN.k`` (``in_layers``,
  ``res_skip_layers``, ``start``, ``end``, ``cond_layer``), then each
  ``convinv.k``. Within a weight-normed conv the bias leads, then ``g``
  and ``v`` (both the parametrization and the legacy hook remove
  ``weight`` before registering them); a plain conv keeps ``weight`` then
  ``bias``. Raises ``AssertionError`` when ``sd`` holds other keys.
  """
  def conv_keys(prefix):
    keys = []
    for g, v in ((".parametrizations.weight.original0",
                  ".parametrizations.weight.original1"),
                 (".weight_g", ".weight_v")):
      if f"{prefix}{g}" in sd:
        if f"{prefix}.bias" in sd:
          keys.append(f"{prefix}.bias")
        return keys + [f"{prefix}{g}", f"{prefix}{v}"]
    return [f"{prefix}{s}" for s in (".weight", ".bias")
            if f"{prefix}{s}" in sd]

  n_flows, n_layers = count_flows_and_layers(sd)
  order = ["upsample.weight", "upsample.bias"]
  for k in range(n_flows):
    for i in range(n_layers):
      order += conv_keys(f"WN.{k}.in_layers.{i}")
    for i in range(n_layers):
      order += conv_keys(f"WN.{k}.res_skip_layers.{i}")
    for name in ("start", "end", "cond_layer"):
      order += conv_keys(f"WN.{k}.{name}")
  order += [f"convinv.{k}.conv.weight" for k in range(n_flows)]

  assert set(order) == set(sd.keys()), (
      sorted(set(sd.keys()) - set(order)), sorted(set(order) - set(sd.keys())))
  return order


def opt_leaves_to_torch_adam(opt_leaves: List[np.ndarray], params: Dict,
                             learning_rate: float) -> Dict:
  """optax's positional Adam leaves -> a torch ``optim.Adam.state_dict()``
  keyed by the reference model's parameter positions (the inverse of
  ``import_torch.torch_adam_to_opt_leaves``). Raises ``ValueError`` when
  the leaves do not fit ``params``."""
  n = len(tree_leaves(params))
  if len(opt_leaves) != 1 + 2 * n:
    raise ValueError(f"optimizer state has {len(opt_leaves)} leaves, "
                     f"expected {1 + 2 * n} (count, mu, nu) for {n} params")
  leaves = [np.asarray(x) for x in opt_leaves]
  step = float(leaves[0])
  avg_sd = params_to_state_dict(tree_unflatten(params, leaves[1:1 + n]))
  avg_sq_sd = params_to_state_dict(tree_unflatten(params, leaves[1 + n:]))
  names = reference_parameter_order(params_to_state_dict(params))
  state = {i: {"step": torch.tensor(step), "exp_avg": avg_sd[name],
               "exp_avg_sq": avg_sq_sd[name]}
           for i, name in enumerate(names)}
  return {
      "state": state,
      "param_groups": [{
          "params": list(range(len(names))),
          "lr": float(learning_rate),
          "betas": (0.9, 0.999),
          "eps": 1e-8,
          "weight_decay": 0,
          "amsgrad": False,
          "maximize": False,
      }],
  }


def export_torch_checkpoint(checkpoint: CheckpointWaveglow,
                            path: Union[str, Path]) -> None:
  """Write a reference-loadable ``.pt`` checkpoint file."""
  hp, _ = hparams_from_dict(checkpoint.hparams)
  hparams_dict = {k: v for k, v in asdict(hp).items()
                  if k in REFERENCE_HPARAMS}
  # None, not {}: the reference's load_optimizer starts afresh on None but
  # would fail in load_state_dict on an empty dict
  optimizer = (None if checkpoint.optimizer is None else
               opt_leaves_to_torch_adam(checkpoint.optimizer,
                                        checkpoint.state_dict,
                                        checkpoint.learning_rate))
  torch.save({
      "state_dict": params_to_state_dict(checkpoint.state_dict),
      "optimizer": optimizer,
      "learning_rate": checkpoint.learning_rate,
      "iteration": checkpoint.iteration,
      "hparams": hparams_dict,
  }, str(path))
