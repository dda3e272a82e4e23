"""The WN stack of one coupling, inference direction (counterpart of
``waveglow_tpu/models/wn.py``).

Parameter layout is the JAX package's (channels-last, explicit gate and
res/skip pair axes), so one checkpoint feeds both:

  start:     w [n_half, C]            b [C]
  in_layers: w [K, C, 2, C]           b [2, C]     (pair 0 = tanh, 1 = sigmoid)
  cond:      w [n_mels*n_group, L, 2, C]  b [L, 2, C]
  res_skip:  w [C, 2, C]              b [2, C]     (pair 0 = residual, 1 = skip)
  last res_skip: w [C, C]             b [C]
  end:       w [C, 2*n_half]          b [2*n_half]

Every layer body runs through the fused WN-layer kernel wrapper (CUDA kernel
on the card, plain torch on the CPU); the per-layer conditioning product
stays ``torch.matmul``. The residual stream and the skip sum are float32 in
both modes; the skip sum is accumulated inside the kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from waveglow_tpu_torch.kernels.wn_layer import wn_layer_fused
from waveglow_tpu_torch.models.weightnorm import init_weightnorm
from waveglow_tpu_torch.ops.conv import _mm, conv1x1


def init_wn_params(rng: np.random.Generator, n_in_channels: int,
                   n_mel_channels: int, n_layers: int, n_channels: int,
                   kernel_size: int, weight_norm: bool = True) -> Dict:
  """Random numpy init drawn in the JAX package's order (same seed, same
  weights). ``end`` is zero, so couplings start as the identity."""
  if kernel_size % 2 != 1 or n_channels % 2 != 0:
    raise ValueError("kernel_size must be odd and n_channels even")

  def uniform(shape, fan_in):
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)

  def conv_init(w_shape, fan_in, out_ndim):
    w = uniform(w_shape, fan_in)
    conv = init_weightnorm(w, out_ndim) if weight_norm else {"w": w}
    conv["b"] = uniform(w_shape[-out_ndim:], fan_in)
    return conv

  c = n_channels
  return {
      "start": conv_init((n_in_channels, c), n_in_channels, 1),
      "cond": conv_init((n_mel_channels, n_layers, 2, c), n_mel_channels, 3),
      "in_layers": [
          conv_init((kernel_size, c, 2, c), c * kernel_size, 2)
          for _ in range(n_layers)
      ],
      "res_skip": [
          conv_init((c, 2, c), c, 2) if i < n_layers - 1
          else conv_init((c, c), c, 1)
          for i in range(n_layers)
      ],
      "end": {
          "w": np.zeros((c, 2 * n_in_channels), dtype=np.float32),
          "b": np.zeros((2 * n_in_channels,), dtype=np.float32),
      },
  }


LayerFn = Callable[..., tuple]


def wn_forward(params: Dict, audio0: torch.Tensor, spect: torch.Tensor,
               n_channels: int, n_layers: int, kernel_size: int,
               compute_dtype=None, valid_t: Optional[torch.Tensor] = None,
               layer: LayerFn = wn_layer_fused) -> torch.Tensor:
  """[B, T, n_half] x [B, T, n_mels*n_group] -> [B, T, 2*n_half] = (b, log_s).

  ``params`` are fused (``{"w", "b"}`` leaves, torch tensors); the layer
  weights go to ``layer`` as stored, so on the card their dtype must be the
  compute dtype (``models.waveglow.params_for_compute``). ``valid_t``
  (None or an int32 [B] tensor) is each row's true time length when the
  caller padded T: residual rows at or past it are zero after the start conv
  and after every layer, so the dilated taps read them as the zero "same"
  padding of an unpadded call. ``layer`` is the layer body (the kernel
  wrapper; ``wn_layer_plain`` runs the same model without the kernel).
  """
  if kernel_size != 3:
    raise ValueError("the fused WN layer implements kernel_size 3 only")
  c = n_channels
  batch, t, _ = audio0.shape
  x = conv1x1(audio0, params["start"]["w"], params["start"]["b"],
              compute_dtype=compute_dtype, out_dtype=torch.float32)
  if valid_t is not None:
    keep = (torch.arange(t, device=x.device)[None, :]
            < valid_t.reshape(-1, 1))[..., None]
    x = torch.where(keep, x, torch.zeros((), device=x.device))
  w_cond = params["cond"]["w"]                  # [M, L, 2, C]
  b_cond = params["cond"]["b"]                  # [L, 2, C]
  skip_acc = torch.zeros((batch, t, c), dtype=torch.float32, device=x.device)
  for i in range(n_layers):
    in_layer = params["in_layers"][i]
    res_skip = params["res_skip"][i]
    # per-layer conditioning: a contiguous [B, T, 2C] buffer in the
    # compute dtype, bias added in that dtype (as the XLA body does)
    cond_i = _mm(spect, w_cond[:, i].reshape(-1, 2 * c), compute_dtype)
    cond_i = cond_i + b_cond[i].reshape(-1).to(cond_i.dtype)
    x, skip_acc = layer(
        x, cond_i, in_layer["w"].reshape(3, c, 2 * c), in_layer["b"].reshape(-1),
        res_skip["w"].reshape(c, -1), res_skip["b"].reshape(-1),
        2 ** i, valid_t=valid_t, skip_acc=skip_acc,
        compute_dtype=compute_dtype)
  return conv1x1(skip_acc, params["end"]["w"], params["end"]["b"],
                 compute_dtype=compute_dtype, out_dtype=torch.float32)
