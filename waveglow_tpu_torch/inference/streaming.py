"""On-device PCM conversion (counterpart of
``waveglow_tpu/inference/streaming.py::pcm16_on_device``; chunked streaming
synthesis is not ported yet)."""

import torch


def pcm16_on_device(wav: torch.Tensor) -> torch.Tensor:
  """``convert_wav(clip(wav, -1, 1), int16)`` as tensor ops: scale by the
  int16 max, round half to even, cast."""
  return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
