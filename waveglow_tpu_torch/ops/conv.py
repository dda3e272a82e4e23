"""Convolutions as matmuls, channels-last (counterpart of
``waveglow_tpu/ops/conv.py``).

Weight layouts are the JAX package's: 1x1 ``w[Cin, Cout]``, conv-transpose
``w[Cin, K, Cout]``. These products stay ``torch.matmul`` (cuBLAS on the
card), as the JAX package left them to XLA.

Precision policy:
  * ``compute_dtype=None`` (parity mode): float32 operands and results. On
    the card this must not run in TF32; ``device.resolve_device`` turns both
    TF32 switches off.
  * ``compute_dtype=torch.bfloat16`` (fast mode): bf16 operands and, unless
    ``out_dtype=torch.float32`` is asked for, a bf16 result. An f32 result
    from bf16 operands is the f32 product of the bf16-rounded operands, the
    same numbers a bf16 product accumulated in f32 gives.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _mm(x: torch.Tensor, w: torch.Tensor, compute_dtype,
        out_dtype=None) -> torch.Tensor:
  if compute_dtype is None:
    return torch.matmul(x.float(), w.float())
  x = x.to(compute_dtype)
  w = w.to(compute_dtype)
  if out_dtype is not None and out_dtype != compute_dtype:
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))
  return torch.matmul(x, w)


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None, compute_dtype=None,
            out_dtype=None) -> torch.Tensor:
  """Pointwise conv: [..., Cin] @ [Cin, Cout] (+ bias)."""
  y = _mm(x, w, compute_dtype, out_dtype)
  if b is not None:
    y = y + b.to(y.dtype)
  return y


def shift_time(x: torch.Tensor, offset: int) -> torch.Tensor:
  """Zero-padded shift along the time axis (axis 1 of [B, T, C]).

  ``offset > 0`` yields ``y[t] = x[t + offset]``; ``offset < 0`` yields
  ``y[t] = x[t - |offset|]``.
  """
  if offset == 0:
    return x
  t = x.shape[1]
  if abs(offset) >= t:
    return torch.zeros_like(x)
  if offset > 0:
    return F.pad(x[:, offset:, :], (0, 0, 0, offset))
  return F.pad(x[:, :t + offset, :], (0, 0, -offset, 0))


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 256,
                     compute_dtype=None, out_dtype=None) -> torch.Tensor:
  """Transposed conv: [B, T, Cin] x [Cin, K, Cout] -> [B, (T-1)*stride + K, Cout].

  torch ``ConvTranspose1d(padding=0)`` semantics as ONE matmul: output
  stride-group g depends only on input frames g-ratio+1 .. g
  (``ratio = K / stride``), so the ratio shifted views concatenated on the
  channel axis meet a [ratio*Cin, stride*Cout] repack of the kernel.
  """
  cin, k, cout = w.shape
  if k % stride:
    raise ValueError("kernel length must be a multiple of stride")
  ratio = k // stride
  batch, t, _ = x.shape
  xp = F.pad(x, (0, 0, 0, ratio - 1))
  xcat = torch.cat([shift_time(xp, -j) for j in range(ratio)], dim=-1)
  # w2[j*Cin + ci, p*Cout + co] = w[ci, j*stride + p, co]
  w2 = w.reshape(cin, ratio, stride, cout).permute(1, 0, 2, 3).reshape(
      ratio * cin, stride * cout)
  y = _mm(xcat.reshape(batch * (t + ratio - 1), ratio * cin), w2,
          compute_dtype, out_dtype)
  y = y.reshape(batch, (t + ratio - 1) * stride, cout)
  if b is not None:
    y = y + b.to(y.dtype)
  return y
