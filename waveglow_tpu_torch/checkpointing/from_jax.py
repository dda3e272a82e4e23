"""Params of the JAX package, as numpy, into the port.

Both packages share one parameter layout, so this is a fold (weight-norm and
1x1 inverses, on the host in numpy) and a move onto the device — no layout
transform exists.
"""

from __future__ import annotations

from typing import Dict

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
