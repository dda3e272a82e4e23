"""Params of the JAX package, as numpy, into the port and back.

Both packages share one parameter layout, so this is a fold (weight-norm and
1x1 inverses, on the host in numpy, for synthesis) or a plain move (trainable
``(g, v)`` leaves, for training) onto the device — no layout transform
exists. :func:`tree_leaves` lists leaves in ``jax.tree_util``'s order
(dict keys sorted, lists in order), the order optax lays its state out in;
:func:`tree_unflatten` puts such a list back into a tree's shape.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from waveglow_tpu_torch.models.waveglow import (fuse_for_inference,
                                                params_to_torch)


def params_from_numpy(tree: Dict, device, dtype: torch.dtype = torch.float32
                      ) -> Dict:
  """JAX params pytree of numpy arrays, trainable ``(g, v)`` or fused ->
  the port's fused params: the same nested dicts/lists of ``dtype`` tensors
  on ``device``."""
  return params_to_torch(fuse_for_inference(tree), torch.device(device),
                         dtype)


def trainable_params_from_numpy(tree: Dict, device) -> Dict:
  """Params pytree of numpy arrays -> the same tree of float32 leaf tensors
  on ``device`` that require grad. Weight-norm stays as ``(g, v)``. The
  tensors are copies: training updates them in place."""
  if isinstance(tree, dict):
    return {k: trainable_params_from_numpy(v, device) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [trainable_params_from_numpy(v, device) for v in tree]
  return torch.tensor(np.asarray(tree), dtype=torch.float32,
                      device=torch.device(device), requires_grad=True)


def params_to_numpy(tree: Any) -> Any:
  """Tree of tensors -> the same tree of float32 numpy arrays on the host."""
  if isinstance(tree, dict):
    return {k: params_to_numpy(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [params_to_numpy(v) for v in tree]
  return tree.detach().to("cpu", torch.float32).numpy()


def tree_leaves(tree: Any) -> List[Any]:
  """Leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted,
  lists and tuples in order."""
  if isinstance(tree, dict):
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
  if isinstance(tree, (list, tuple)):
    return [leaf for v in tree for leaf in tree_leaves(v)]
  return [tree]


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
  """A tree shaped like ``tree`` whose leaves are ``leaves``, taken in
  :func:`tree_leaves` order (the inverse of ``tree_leaves``); raises
  ``ValueError`` when the counts differ."""
  it = iter(leaves)

  def build(node):
    if isinstance(node, dict):
      built = {k: build(node[k]) for k in sorted(node)}
      return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
      return type(node)(build(v) for v in node)
    return next(it)

  n = len(tree_leaves(tree))
  if len(leaves) != n:
    raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
  return build(tree)
