"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default ``"cuda"`` raises when no card is present instead of silently
running the (slow, kernel-free) CPU path.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
  """``None`` or a CUDA device -> that CUDA device (raises without a card);
  ``"cpu"`` -> the CPU. On CUDA, f32 parity mode must not run in TF32, so
  both TF32 switches are turned off here."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(
          "no CUDA device is available; pass device='cpu' to run the "
          "plain PyTorch path on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  elif dev.type != "cpu":
    raise ValueError(f"unsupported device {dev}")
  return dev


def to_device(value, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """``torch.as_tensor(value, dtype, device)`` without a wait: host data
  bound for a CUDA device is copied into pinned memory and from there with
  ``non_blocking=True``. A blocking host-to-device copy synchronises the
  stream, so the host would wait for all work enqueued before it; this
  copy waits for nothing and lands in stream order. Device tensors are
  only moved or cast. A host tensor whose elements share memory (an
  ``expand``) is made contiguous first: pinning refuses it."""
  if isinstance(value, torch.Tensor) and value.device.type != "cpu":
    return value.to(device=device, dtype=dtype)
  if isinstance(value, np.ndarray):
    value = np.ascontiguousarray(value)
  host = torch.as_tensor(value, dtype=dtype)
  if device.type != "cuda":
    return host
  return host.contiguous().pin_memory().to(device, non_blocking=True)
