"""The WN stack of one coupling (counterpart of ``waveglow_tpu/models/wn.py``):
``wn_forward`` over fused weights (synthesis), ``wn_forward_train`` over
trainable weight-norm leaves (training).

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
both modes; in synthesis the skip sum is accumulated inside the kernel, in
training outside it.

``wn_forward_tp`` is the stack on a ``model`` mesh axis (the JAX package's
tensor-parallel contract, ``waveglow_tpu/models/wn.py``): each rank holds a
slice of the gate channels (``parallel.sharding``), runs its share of each
layer through the shard kernel, and the ranks' partial res/skip sums are
reduced once a layer. ``wn_forward_train_tp`` is its differentiable
counterpart for training, through the trainable shard.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from waveglow_tpu_torch.kernels.wn_layer import (wn_layer_fused,
                                                 wn_layer_shard,
                                                 wn_layer_shard_trainable,
                                                 wn_layer_trainable)
from waveglow_tpu_torch.models.weightnorm import (init_weightnorm, materialize,
                                                  materialize_row_parallel)
from waveglow_tpu_torch.ops.conv import _mm, conv1x1
from waveglow_tpu_torch.parallel.mesh import (copy_to_model_ranks,
                                              reduce_from_model_ranks,
                                              reduce_partials)


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


def _row_keep(valid_t: torch.Tensor, t: int) -> torch.Tensor:
  return (torch.arange(t, device=valid_t.device)[None, :]
          < valid_t.reshape(-1, 1))[..., None]


def wn_forward_tp(shards: Sequence[Dict], audio0: torch.Tensor,
                  spects: Sequence[torch.Tensor], n_channels: int,
                  n_layers: int, kernel_size: int, compute_dtype=None,
                  valid_ts: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
  """:func:`wn_forward` over a tensor-parallel group: the same output, the
  WN hidden channels cut over the ranks.

  ``shards``: one fused WN params dict per model rank
  (``parallel.sharding.shard_params``), rank r's on its device;
  ``spects`` and ``valid_ts``: the conditioning [B, T, n_mels*n_group]
  and the per-row valid lengths, one copy on each rank's device; ``audio0``
  on rank 0's device, where the start and end convs and the skip sum run.
  Per layer each rank computes its slice of the conditioning product
  ([B, T, 2C'], its own GEMM) and its partial through the shard kernel
  (:func:`kernels.wn_layer.wn_layer_shard`); the partials are
  summed in rank order and every rank gets the same bits
  (``parallel.mesh.reduce_partials``); then b_rs, the residual add and the
  ``valid_t`` row mask run on each rank (the same bits on each) and the
  skip is added to the sum once. The work of every rank is enqueued
  before any is waited for.
  """
  if kernel_size != 3:
    raise ValueError("the fused WN layer implements kernel_size 3 only")
  c = n_channels
  batch, t, _ = audio0.shape
  x = conv1x1(audio0, shards[0]["start"]["w"], shards[0]["start"]["b"],
              compute_dtype=compute_dtype, out_dtype=torch.float32)
  if valid_ts is not None:
    x = torch.where(_row_keep(valid_ts[0], t), x,
                    torch.zeros((), device=x.device))
  xs = [x if s.device == x.device else x.to(s.device) for s in spects]
  skip_acc = torch.zeros((batch, t, c), dtype=torch.float32, device=x.device)
  for i in range(n_layers):
    last = i == n_layers - 1
    partials = []
    for shard, x_r, spect in zip(shards, xs, spects):
      w_cond = shard["cond"]["w"]               # [M, L, 2, C']
      cp = w_cond.shape[-1]
      cond_i = _mm(spect, w_cond[:, i].reshape(-1, 2 * cp), compute_dtype)
      cond_i = cond_i + shard["cond"]["b"][i].reshape(-1).to(cond_i.dtype)
      in_layer = shard["in_layers"][i]
      partials.append(wn_layer_shard(
          x_r, cond_i, in_layer["w"].reshape(3, c, 2 * cp),
          in_layer["b"].reshape(-1), shard["res_skip"][i]["w"].reshape(cp, -1),
          2 ** i, compute_dtype=compute_dtype))
    sums = reduce_partials(partials)
    rs = [total + shard["res_skip"][i]["b"].reshape(-1).float()
          for total, shard in zip(sums, shards)]
    skip_acc = skip_acc + (rs[0] if last else rs[0][..., c:])
    if not last:
      xs = [x_r + rs_r[..., :c] for x_r, rs_r in zip(xs, rs)]
      if valid_ts is not None:
        xs = [torch.where(_row_keep(v, t), x_r,
                          torch.zeros((), device=x_r.device))
              for x_r, v in zip(xs, valid_ts)]
  return conv1x1(skip_acc, shards[0]["end"]["w"], shards[0]["end"]["b"],
                 compute_dtype=compute_dtype, out_dtype=torch.float32)


def wn_forward_train(params: Dict, audio0: torch.Tensor, spect: torch.Tensor,
                     n_channels: int, n_layers: int, kernel_size: int,
                     compute_dtype=None,
                     layer: LayerFn = wn_layer_trainable) -> torch.Tensor:
  """Differentiable WN stack over trainable leaves (``{"g", "v", "b"}``
  convs; the counterpart of the JAX package's ``_wn_forward_pallas``).

  Weights are materialised from (g, v) per call and cast to the compute
  dtype; the per-layer cond GEMM stays ``torch.matmul``; each layer runs
  through ``layer`` (:func:`wn_layer_trainable`: the kernel forward and its
  torch backward; ``wn_layer_plain`` is the plain autograd counterpart);
  the skip sum is added in f32 outside the kernel. The residual stream
  stays f32 in both modes, because the kernel takes f32 x: that matches
  the JAX XLA route (``wn_forward``), while the JAX Pallas route keeps x in
  the compute dtype.
  """
  if kernel_size != 3:
    raise ValueError("the fused WN layer implements kernel_size 3 only")
  dtype = compute_dtype or torch.float32
  c = n_channels
  x = conv1x1(audio0, materialize(params["start"]), params["start"]["b"],
              compute_dtype=compute_dtype, out_dtype=torch.float32)
  spect = spect.to(dtype)
  w_cond = materialize(params["cond"])          # [M, L, 2, C]
  b_cond = params["cond"]["b"]                  # [L, 2, C]
  output = None
  for i in range(n_layers):
    in_layer = params["in_layers"][i]
    res_skip = params["res_skip"][i]
    w_in = materialize(in_layer).reshape(3, c, 2 * c).to(dtype)
    w_rs = materialize(res_skip).reshape(c, -1).to(dtype)
    cond_i = _mm(spect, w_cond[:, i].reshape(-1, 2 * c), compute_dtype)
    cond_i = cond_i + b_cond[i].reshape(-1).to(cond_i.dtype)
    x, skip = layer(x, cond_i, w_in, in_layer["b"].float().reshape(-1), w_rs,
                    res_skip["b"].float().reshape(-1), 2 ** i,
                    compute_dtype=compute_dtype)
    output = skip if output is None else output + skip
  return conv1x1(output, params["end"]["w"], params["end"]["b"],
                 compute_dtype=compute_dtype, out_dtype=torch.float32)


def wn_forward_train_tp(shards: Sequence[Dict], audio0: torch.Tensor,
                        spect: torch.Tensor, n_channels: int, n_layers: int,
                        kernel_size: int, compute_dtype=None
                        ) -> torch.Tensor:
  """:func:`wn_forward_train` over a model group: the differentiable
  counterpart of :func:`wn_forward_tp`, built from the same parts.

  ``shards``: one trainable WN params dict per model rank
  (``parallel.sharding.shard_trainable_params``: rank r's slices on its
  device, the replicated leaves held once on rank 0's); ``audio0`` and
  ``spect`` on rank 0's device. The residual stream and the skip sum are
  held once, on rank 0's device, in f32. Per layer the stream and the
  conditioning enter every rank through ``copy_to_model_ranks``; each rank
  runs its slice of the conditioning product (``torch.matmul``) and its
  share of the layer through :func:`wn_layer_shard_trainable` (the shard
  kernel and its backward); the partials are summed in rank order
  (``reduce_from_model_ranks``), then b_rs, the residual and the skip are
  added once. The ``res_skip`` weight norm sums over the cut axis
  (``materialize_row_parallel``). So every gradient sum across ranks runs
  in rank order: the partial dx's and d(spect)'s in ``copy_to_model_ranks``'
  backward, the replicated ``res_skip`` ``g``'s in the norm's.
  """
  if kernel_size != 3:
    raise ValueError("the fused WN layer implements kernel_size 3 only")
  dtype = compute_dtype or torch.float32
  c = n_channels
  head = shards[0]
  devices = [s["in_layers"][0]["v"].device for s in shards]
  x = conv1x1(audio0, materialize(head["start"]), head["start"]["b"],
              compute_dtype=compute_dtype, out_dtype=torch.float32)
  spects = copy_to_model_ranks(spect.to(dtype), devices)
  w_conds = [materialize(s["cond"]) for s in shards]      # [M, L, 2, C']
  output = None
  for i in range(n_layers):
    last = i == n_layers - 1
    w_rss = materialize_row_parallel([s["res_skip"][i] for s in shards])
    xs = copy_to_model_ranks(x, devices)
    partials = []
    for shard, x_r, spect_r, w_cond, w_rs in zip(shards, xs, spects, w_conds,
                                                 w_rss):
      cp = w_cond.shape[-1]
      cond_i = _mm(spect_r, w_cond[:, i].reshape(-1, 2 * cp), compute_dtype)
      cond_i = cond_i + shard["cond"]["b"][i].reshape(-1).to(cond_i.dtype)
      in_layer = shard["in_layers"][i]
      partials.append(wn_layer_shard_trainable(
          x_r, cond_i, materialize(in_layer).reshape(3 * c, 2 * cp).to(dtype),
          in_layer["b"].float().reshape(-1),
          w_rs.reshape(cp, -1).to(dtype), 2 ** i,
          compute_dtype=compute_dtype))
    rs = (reduce_from_model_ranks(partials)
          + head["res_skip"][i]["b"].float().reshape(-1))
    skip = rs if last else rs[..., c:]
    if not last:
      x = x + rs[..., :c]
    output = skip if output is None else output + skip
  return conv1x1(output, head["end"]["w"], head["end"]["b"],
                 compute_dtype=compute_dtype, out_dtype=torch.float32)
