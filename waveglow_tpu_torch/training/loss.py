"""WaveGlow negative log-likelihood (counterpart of
``waveglow_tpu/training/loss.py``).

``loss = sum(z^2)/(2 sigma^2) - sum_k sum(log_s_k) - sum_k log_det_W_k``,
normalised by the element count of z.
"""

from __future__ import annotations

from typing import Sequence

import torch


def waveglow_loss(z: torch.Tensor, log_s_list: Sequence[torch.Tensor],
                  log_det_w_list: Sequence[torch.Tensor],
                  sigma: float = 1.0) -> torch.Tensor:
  log_s_total = sum(torch.sum(s) for s in log_s_list)
  log_det_w_total = sum(log_det_w_list)
  loss = (torch.sum(z * z) / (2 * sigma * sigma)
          - log_s_total - log_det_w_total)
  return loss / z.numel()
