"""Weight-norm ``w = g * v / ||v||`` (counterpart of
``waveglow_tpu/models/weightnorm.py``): ``materialize`` differentiably on
torch tensors (training), ``fuse`` folded once on the host (inference).

A weight-normed conv is a dict ``{"g", "v", "b"}``; a fused conv is
``{"w", "b"}``. Norms are per output channel, i.e. over the LEADING
``v.ndim - g.ndim`` axes (the layouts keep output channels trailing).

``materialize_row_parallel`` is the norm of a conv whose leading axis is cut
over model ranks (the row-parallel ``res_skip``): the norm sums over the cut
axis, so the ranks' partial sums of squares are reduced first. The
column-parallel convs cut an output axis and norm over uncut axes, so
``materialize`` of each rank's slice is already right for them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from waveglow_tpu_torch.parallel.mesh import (copy_to_model_ranks,
                                              reduce_from_model_ranks)


def materialize(conv: Dict) -> torch.Tensor:
  """Effective weight of a (possibly weight-normed) conv of torch tensors,
  differentiable in ``g`` and ``v``."""
  if "w" in conv:
    return conv["w"]
  v, g = conv["v"], conv["g"]
  dims = tuple(range(v.dim() - g.dim()))
  norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
  return g * v / norm


def materialize_row_parallel(convs: Sequence[Dict]) -> List[torch.Tensor]:
  """Effective weights of a weight-normed conv cut over model ranks on its
  leading (contraction) axis: ``convs[r]`` holds rank r's ``v`` slice on its
  device and the whole ``g`` (one tensor, held on rank 0's device). Each
  rank's partial sum of squares is summed in rank order
  (``reduce_from_model_ranks``), and the norm and ``g`` reach every rank
  through ``copy_to_model_ranks``; the slices of ``g * v / ||v||`` concatenate
  to :func:`materialize` of the whole conv. Differentiable in ``g`` and
  every ``v``."""
  g = convs[0]["g"]
  devices = [c["v"].device for c in convs]
  dims = tuple(range(convs[0]["v"].dim() - g.dim()))
  sumsq = reduce_from_model_ranks(
      [torch.sum(c["v"] * c["v"], dim=dims, keepdim=True) for c in convs])
  norms = copy_to_model_ranks(torch.sqrt(sumsq), devices)
  gains = copy_to_model_ranks(g, devices)
  return [g_r * c["v"] / norm for c, g_r, norm in zip(convs, gains, norms)]


def fuse(conv: Dict) -> Dict:
  """Fold weight-norm into a plain float32 weight (float64 on the host)."""
  if "w" in conv:
    return {k: np.asarray(v, dtype=np.float32) for k, v in conv.items()}
  v = np.asarray(conv["v"], dtype=np.float64)
  g = np.asarray(conv["g"], dtype=np.float64)
  axes = tuple(range(v.ndim - g.ndim))
  norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))
  out = {"w": (g * v / norm).astype(np.float32)}
  if "b" in conv:
    out["b"] = np.asarray(conv["b"], dtype=np.float32)
  return out


def init_weightnorm(w: np.ndarray, out_ndim: int = 1) -> Dict[str, np.ndarray]:
  """Wrap a plain weight as (g, v) with g = ||v|| so w is unchanged."""
  axes = tuple(range(w.ndim - out_ndim))
  norm = np.sqrt(np.sum(np.square(w), axis=axes))
  return {"g": norm.astype(np.float32), "v": w.astype(np.float32)}
