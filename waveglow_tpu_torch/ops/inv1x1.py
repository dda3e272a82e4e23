"""Invertible 1x1 convolution, synthesis direction (counterpart of
``waveglow_tpu/ops/inv1x1.py``).

The "conv" is a ``[B*T, C] @ [C, C]`` matmul over the tiny group channel
axis; the inverse is computed once on the host when weights are fused.
"""

from __future__ import annotations

import numpy as np
import torch


def init_orthonormal(rng: np.random.Generator, channels: int) -> np.ndarray:
  """QR of a Gaussian with determinant forced to +1; ``y = x @ W.T``."""
  w, _ = np.linalg.qr(rng.standard_normal((channels, channels)))
  if np.linalg.det(w) < 0:
    w[:, 0] = -w[:, 0]
  return w.astype(np.float32)


def inverse_matrix(w: np.ndarray) -> np.ndarray:
  """Dense inverse, computed once on the host in float32."""
  return np.linalg.inv(np.asarray(w, dtype=np.float32)).astype(np.float32)


def reverse(z: torch.Tensor, w_inverse: torch.Tensor) -> torch.Tensor:
  """Apply the precomputed inverse: [B, T, C] @ inv(W).T, in float32."""
  return torch.matmul(z.float(), w_inverse.float().T)
