"""Tensor-parallel placement of the fused WaveGlow params (counterpart of
``waveglow_tpu/parallel/sharding.py``).

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
replicated, as ``PartitionSpec()`` is.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from waveglow_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

Spec = Tuple


def _conv_specs(conv: Dict, w_spec: Spec, b_spec: Spec) -> Dict:
  return {k: (w_spec if k == "w" else b_spec) for k in conv}


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
  """Spec tree of a fused WaveGlow params tree (every leaf has one)."""
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
