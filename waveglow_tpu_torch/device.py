"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default ``"cuda"`` raises when no card is present instead of silently
running the (slow, kernel-free) CPU path.
"""

from __future__ import annotations

from typing import Optional, Union

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
