"""Tensor-parallel placement of the WaveGlow params, fused for serving and
trainable for training (counterpart of ``waveglow_tpu/parallel/sharding.py``).

The Megatron split over the WN hidden channels C:

  * ``in_layers`` and ``cond`` are column-parallel: their outputs are cut
    on the trailing C, and the gate-pair axis keeps each rank's tanh and
    sigmoid halves together;
  * ``res_skip`` is row-parallel: its contraction runs over the leading,
    cut C, so each rank holds a partial res/skip sum, reduced once a layer
    (``parallel.mesh.reduce_partials``) before the residual add;
  * ``start``, ``end``, ``inv1x1`` and ``upsample`` are small and
    replicated, and every spec is replicated over the ``data`` axis.

A spec is a tuple with one entry per dimension of its leaf: ``MODEL_AXIS``
where the leaf is cut over the model ranks, None elsewhere; ``()`` is
replicated, as ``PartitionSpec()`` is. A weight-normed conv ``{g, v, b}``
cuts ``v`` as the fused ``w`` and ``g`` as its output (the bias's spec), so
a row-parallel ``res_skip`` keeps ``g`` whole: its norm sums over the cut
axis (``models.weightnorm.materialize_row_parallel``).

Training holds a model group as one tree a rank (:func:`shard_trainable_params`):
each rank's tree has its own slices of the cut leaves, and every
replicated leaf is held once, on rank 0's device, the same tensor in every
rank's tree, so it has one gradient (the sum of the ranks' shares, through
``parallel.mesh.copy_to_model_ranks``). :func:`gather_trainable_params`
is the inverse; :func:`shard_leaf_pairs` pairs a full tree's slices with a
group's leaves (the Adam state's scatter).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.from_jax import (tree_leaves,
                                                      tree_unflatten)
from waveglow_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

Spec = Tuple


def _conv_specs(conv: Dict, w_spec: Spec, b_spec: Spec) -> Dict:
  return {k: (w_spec if k in ("w", "v") else b_spec) for k in conv}


def wn_specs(wn: Dict) -> Dict:
  """Spec tree of one fused WN params dict."""
  rep = ()
  n_layers = len(wn["in_layers"])
  return {
      "start": _conv_specs(wn["start"], rep, rep),
      # [M, L, 2, C'] and [L, 2, C']
      "cond": _conv_specs(wn["cond"], (None, None, None, MODEL_AXIS),
                          (None, None, MODEL_AXIS)),
      # [K, C, 2, C'] and [2, C']
      "in_layers": [_conv_specs(c, (None, None, None, MODEL_AXIS),
                                (None, MODEL_AXIS))
                    for c in wn["in_layers"]],
      # [C', 2, C] (last [C', C]); the bias is added once, after the reduce
      "res_skip": [_conv_specs(c, (MODEL_AXIS, None, None)
                               if i < n_layers - 1 else (MODEL_AXIS, None),
                               rep)
                   for i, c in enumerate(wn["res_skip"])],
      "end": _conv_specs(wn["end"], rep, rep),
  }


def param_specs(params: Dict) -> Dict:
  """Spec tree of a fused or trainable WaveGlow params tree (every leaf has
  one)."""
  return {
      "upsample": {k: () for k in params["upsample"]},
      "flows": [{"inv1x1": {k: () for k in flow["inv1x1"]},
                 "wn": wn_specs(flow["wn"])}
                for flow in params["flows"]],
  }


def _slice(leaf, spec: Spec, rank: int, model: int):
  if MODEL_AXIS not in spec:
    return leaf
  dim = spec.index(MODEL_AXIS)
  size = leaf.shape[dim]
  if size % model:
    raise ValueError(f"a dimension of {size} does not split over "
                     f"{model} model ranks")
  part = size // model
  index = [slice(None)] * leaf.ndim
  index[dim] = slice(rank * part, (rank + 1) * part)
  return leaf[tuple(index)]


def shard_params(params: Dict, mesh: Mesh) -> List[List[Dict]]:
  """Place a fused params tree (numpy or tensor leaves) on ``mesh`` per
  :func:`param_specs`: ``out[i][r]`` is the tree of data index ``i`` and
  model rank ``r`` on ``mesh.devices[i, r]`` (a mesh without a model axis
  has one rank). Cut leaves are real f32 slices, contiguous, not views of
  the whole; replicated leaves are whole. Identical placements share their
  tensors: a mesh that lists one device more than once holds each distinct
  (leaf, rank) once on it."""
  specs = param_specs(params)
  grid = mesh.devices.reshape(mesh.devices.shape[0], -1)
  model = grid.shape[1]
  placed: Dict[tuple, torch.Tensor] = {}

  def place(leaf, spec, rank, device):
    if MODEL_AXIS not in spec:
      rank = 0
    key = (id(leaf), rank, str(device))
    if key not in placed:
      host = np.ascontiguousarray(_slice(np.asarray(
          leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf,
          dtype=np.float32), spec, rank, model))
      placed[key] = torch.as_tensor(host, device=device)
    return placed[key]

  def build(tree, spec, rank, device):
    if isinstance(tree, dict):
      return {k: build(tree[k], spec[k], rank, device) for k in tree}
    if isinstance(tree, (list, tuple)):
      return [build(t, s, rank, device) for t, s in zip(tree, spec)]
    return place(tree, spec, rank, device)

  return [[build(params, specs, r, grid[i, r]) for r in range(model)]
          for i in range(grid.shape[0])]


def shard_trainable_params(params: Dict, mesh: Mesh) -> List[List[Dict]]:
  """Place a trainable params tree (numpy leaves, weight-norm as ``(g,
  v)``) on ``mesh`` for training: ``out[i][r]`` is the tree of data replica
  ``i`` and model rank ``r``, of float32 leaf tensors that require grad.
  Cut leaves are rank r's slice on ``mesh.devices[i, r]``; each replicated
  leaf is one tensor on ``mesh.devices[i, 0]``, shared by the replica's
  rank trees. Every data replica has tensors of its own (its own Adam
  state), even where two replicas share a device."""
  specs = param_specs(params)
  grid = mesh.devices.reshape(mesh.devices.shape[0], -1)
  model = grid.shape[1]

  def leaf(host, device):
    return torch.tensor(np.ascontiguousarray(host, dtype=np.float32),
                        device=device, requires_grad=True)

  out = []
  for i in range(grid.shape[0]):
    held: Dict[int, torch.Tensor] = {}

    def build(tree, spec, rank):
      if isinstance(tree, dict):
        return {k: build(tree[k], spec[k], rank) for k in tree}
      if isinstance(tree, (list, tuple)):
        return [build(t, s, rank) for t, s in zip(tree, spec)]
      if MODEL_AXIS in spec:
        return leaf(_slice(np.asarray(tree), spec, rank, model),
                    grid[i, rank])
      if id(tree) not in held:
        held[id(tree)] = leaf(np.asarray(tree), grid[i, 0])
      return held[id(tree)]

    out.append([build(params, specs, r) for r in range(model)])
  return out


def distinct_leaves(trees) -> List[torch.Tensor]:
  """The distinct leaf tensors of a tree or of a model group's rank trees,
  in ``tree_leaves`` order, each once (a replicated leaf is shared by the
  rank trees)."""
  seen, out = set(), []
  for leaf in tree_leaves(trees):
    if id(leaf) not in seen:
      seen.add(id(leaf))
      out.append(leaf)
  return out


def _walk(spec, *trees) -> Iterator[tuple]:
  """(spec, leaf of each tree) over trees of one structure, in
  ``tree_leaves`` order."""
  first = trees[0]
  if isinstance(first, dict):
    for k in sorted(first):
      yield from _walk(spec[k], *[t[k] for t in trees])
  elif isinstance(first, (list, tuple)):
    for i in range(len(first)):
      yield from _walk(spec[i], *[t[i] for t in trees])
  else:
    yield (spec,) + tuple(trees)


def gather_tree(group: List[Dict], value: Callable) -> List[np.ndarray]:
  """The leaves, in ``tree_leaves`` order, of the full tree that a model
  group's rank trees hold: ``value(tensor)`` (a numpy array) of each rank's
  slice joined along its cut axis, or of the replicated leaf."""
  out = []
  for spec, *leaves in _walk(param_specs(group[0]), *group):
    if MODEL_AXIS in spec:
      out.append(np.concatenate([value(v) for v in leaves],
                                axis=spec.index(MODEL_AXIS)))
    else:
      out.append(value(leaves[0]))
  return out


def gather_trainable_params(group: List[Dict]) -> Dict:
  """A model group's rank trees (:func:`shard_trainable_params`) as one
  numpy tree in the JAX layout: the inverse of the placement."""
  return tree_unflatten(group[0], gather_tree(
      group, lambda v: v.detach().to("cpu", torch.float32).numpy()))


def shard_leaf_pairs(full_leaves: List[np.ndarray], group: List[Dict]
                     ) -> List[Tuple[torch.Tensor, np.ndarray]]:
  """(leaf tensor, its slice of the matching full leaf) for each distinct
  leaf of a model group, in :func:`distinct_leaves` order; ``full_leaves``
  are a full tree's leaves in ``tree_leaves`` order (optax's order)."""
  model = len(group)
  pairs: Dict[int, tuple] = {}
  for rank, tree in enumerate(group):
    for (spec, leaf), full in zip(_walk(param_specs(tree), tree),
                                  full_leaves):
      pairs.setdefault(id(leaf), (leaf, _slice(full, spec, rank, model)))
  return [pairs[id(leaf)] for leaf in distinct_leaves(group)]
