"""Weight-norm ``w = g * v / ||v||`` (counterpart of
``waveglow_tpu/models/weightnorm.py``): ``materialize`` differentiably on
torch tensors (training), ``fuse`` folded once on the host (inference).

A weight-normed conv is a dict ``{"g", "v", "b"}``; a fused conv is
``{"w", "b"}``. Norms are per output channel, i.e. over the LEADING
``v.ndim - g.ndim`` axes (the layouts keep output channels trailing).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def materialize(conv: Dict) -> torch.Tensor:
  """Effective weight of a (possibly weight-normed) conv of torch tensors,
  differentiable in ``g`` and ``v``."""
  if "w" in conv:
    return conv["w"]
  v, g = conv["v"], conv["g"]
  dims = tuple(range(v.dim() - g.dim()))
  norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
  return g * v / norm


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
