"""WaveGlow: upsample, unfold, 12 flows, early outputs (counterpart of
``waveglow_tpu/models/waveglow.py``). :func:`forward` is the training
direction over trainable leaves; :func:`infer` is synthesis over fused ones.

Tensors are channels-last ``[B, T_groups, C]``. Host-side functions
(:func:`init_params`, :func:`fuse_for_inference`) work on numpy pytrees in
the JAX package's layout; :func:`params_to_torch` moves a fused tree onto a
device. Synthesis noise is either injected (``noise=[...]``, the parity
tests) or drawn by :func:`block_noise`, keyed by position so a bucket-padded
call draws the same values at kept positions as an unpadded one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from waveglow_tpu_torch.device import resolve_device, to_device
from waveglow_tpu_torch.hparams import HParams
from waveglow_tpu_torch.kernels.wn_layer import (wn_layer_fused,
                                                 wn_layer_trainable)
from waveglow_tpu_torch.models import weightnorm
from waveglow_tpu_torch.models.wn import (LayerFn, init_wn_params, wn_forward,
                                          wn_forward_tp, wn_forward_train,
                                          wn_forward_train_tp)
from waveglow_tpu_torch.ops import inv1x1
from waveglow_tpu_torch.ops.conv import conv_transpose1d

UPSAMPLE_KERNEL = 1024
UPSAMPLE_STRIDE = 256


@dataclass(frozen=True)
class WaveGlowConfig:
  """Static model architecture derived from HParams."""
  n_mel_channels: int = 80
  n_flows: int = 12
  n_group: int = 8
  n_early_every: int = 4
  n_early_size: int = 2
  n_layers: int = 8
  n_channels: int = 256
  kernel_size: int = 3

  @classmethod
  def from_hparams(cls, hp: HParams) -> "WaveGlowConfig":
    return cls(n_mel_channels=hp.n_mel_channels, n_flows=hp.n_flows,
               n_group=hp.n_group, n_early_every=hp.n_early_every,
               n_early_size=hp.n_early_size, n_layers=hp.n_layers,
               n_channels=hp.n_channels, kernel_size=hp.kernel_size)

  def flow_channel_counts(self) -> List[int]:
    """Audio channel count entering each flow."""
    counts = []
    n_remaining = self.n_group
    for k in range(self.n_flows):
      if k % self.n_early_every == 0 and k > 0:
        n_remaining -= self.n_early_size
      counts.append(n_remaining)
    return counts

  @property
  def n_remaining_channels(self) -> int:
    return self.flow_channel_counts()[-1]

  @property
  def groups_per_frame(self) -> int:
    return UPSAMPLE_STRIDE // self.n_group


def init_params(config: WaveGlowConfig, seed: int = 1234,
                weight_norm: bool = True) -> Dict:
  """Random parameter pytree (numpy float32 leaves), drawn in the JAX
  package's order: the same seed gives the same weights in both."""
  rng = np.random.default_rng(seed)
  cin = config.n_mel_channels

  def uniform(shape, fan_in):
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)

  params = {
      "upsample": {
          "w": uniform((cin, UPSAMPLE_KERNEL, cin), cin * UPSAMPLE_KERNEL),
          "b": uniform((cin,), cin * UPSAMPLE_KERNEL),
      },
      "flows": [],
  }
  for channels in config.flow_channel_counts():
    params["flows"].append({
        "inv1x1": {"w": inv1x1.init_orthonormal(rng, channels)},
        "wn": init_wn_params(
            rng, n_in_channels=channels // 2,
            n_mel_channels=config.n_mel_channels * config.n_group,
            n_layers=config.n_layers, n_channels=config.n_channels,
            kernel_size=config.kernel_size, weight_norm=weight_norm),
    })
  return params


def fuse_for_inference(params: Dict) -> Dict:
  """Host-side fold of weight-norm (g, v) -> w and of each 1x1 inverse.

  Takes a trainable or an already-fused numpy tree; returns a fused numpy
  tree (idempotent).
  """
  fused = {"upsample": {k: np.asarray(v, dtype=np.float32)
                        for k, v in params["upsample"].items()},
           "flows": []}
  for flow in params["flows"]:
    w = np.asarray(flow["inv1x1"]["w"], dtype=np.float32)
    wn = flow["wn"]
    fused["flows"].append({
        "inv1x1": {"w": w, "w_inv": inv1x1.inverse_matrix(w)},
        "wn": {
            "start": weightnorm.fuse(wn["start"]),
            "cond": weightnorm.fuse(wn["cond"]),
            "in_layers": [weightnorm.fuse(c) for c in wn["in_layers"]],
            "res_skip": [weightnorm.fuse(c) for c in wn["res_skip"]],
            "end": {k: np.asarray(v, dtype=np.float32)
                    for k, v in wn["end"].items()},
        },
    })
  return fused


def params_to_torch(tree, device: torch.device,
                    dtype: torch.dtype = torch.float32):
  """numpy pytree -> the same nested dicts/lists of ``dtype`` tensors."""
  if isinstance(tree, dict):
    return {k: params_to_torch(v, device, dtype) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [params_to_torch(v, device, dtype) for v in tree]
  return torch.as_tensor(np.asarray(tree), dtype=dtype, device=device)


def params_for_compute(params: Dict, compute_dtype=None) -> Dict:
  """Fused torch params with every weight that only meets the compute dtype
  stored in it once: the upsample kernel and, per flow, the WN stack's
  start, cond, in-layer, res/skip and end matrices and the cond bias (added
  in the compute dtype). The layer biases the kernel adds in f32 and the 1x1
  inverses stay f32. Parity mode (``None``) returns ``params`` itself.

  On the card :func:`infer` in bf16 needs params made by this: the kernel
  takes its weights in the compute dtype and raises on any other."""
  if compute_dtype is None:
    return params

  def cast(conv, keys=("w",)):
    return {k: v.to(compute_dtype) if k in keys else v
            for k, v in conv.items()}

  flows = []
  for flow in params["flows"]:
    wn = flow["wn"]
    flows.append({"inv1x1": flow["inv1x1"], "wn": {
        "start": cast(wn["start"]),
        "cond": cast(wn["cond"], ("w", "b")),
        "in_layers": [cast(conv) for conv in wn["in_layers"]],
        "res_skip": [cast(conv) for conv in wn["res_skip"]],
        "end": cast(wn["end"]),
    }})
  return {"upsample": cast(params["upsample"]), "flows": flows}


def params_device(params) -> torch.device:
  """The device of a fused params tree, or of rank 0's tree of a
  tensor-parallel group (a list of trees, ``parallel.sharding``)."""
  if isinstance(params, (list, tuple)):
    params = params[0]
  return params["upsample"]["w"].device


def upsample_mel(params: Dict, spect: torch.Tensor,
                 compute_dtype=None) -> torch.Tensor:
  """[B, n_mels, frames] -> [B, T_samples, n_mels] via transposed conv."""
  return conv_transpose1d(spect.transpose(1, 2), params["upsample"]["w"],
                          params["upsample"]["b"], stride=UPSAMPLE_STRIDE,
                          compute_dtype=compute_dtype)


def unfold_groups(upsampled: torch.Tensor, n_group: int) -> torch.Tensor:
  """[B, T, n_mels] -> [B, T/n_group, n_mels*n_group], channel index
  ``mel_channel * n_group + offset`` (the reference's unfold order)."""
  batch, t, n_mels = upsampled.shape
  grouped = upsampled.reshape(batch, t // n_group, n_group, n_mels)
  return grouped.permute(0, 1, 3, 2).reshape(batch, t // n_group,
                                             n_mels * n_group)


def forward(params: Union[Dict, Sequence[Dict]], config: WaveGlowConfig,
            spect: torch.Tensor, audio: torch.Tensor, compute_dtype=None,
            remat: bool = False, remat_scope: str = "flow",
            layer: LayerFn = wn_layer_trainable
            ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
  """Training-direction flow over trainable leaves (``params`` from
  ``checkpointing.from_jax.trainable_params_from_numpy``), or over a model
  group: a list of rank trees (``parallel.sharding.shard_trainable_params``),
  whose WN stacks run through ``models.wn.wn_forward_train_tp`` and the rest
  on rank 0's device (its replicated leaves; ``layer`` is then unused).

  ``spect`` [B, n_mels, frames] is upsampled, trimmed to the audio length
  and unfolded; ``audio`` [B, T] (T a multiple of n_group) runs through the
  flows, each an invertible 1x1 mix then the affine coupling
  ``exp(log_s) * a1 + b``; every ``n_early_every`` flows ``n_early_size``
  channels go to z. ``remat`` recomputes in the backward either each whole
  flow step (``remat_scope="flow"``) or only its WN stack (``"wn"``),
  through ``torch.utils.checkpoint``. The JAX package's ``scan_flows`` only
  changes how its program is traced, not its numbers, so it has no
  counterpart here. Returns ``(z [B, T/n_group, n_group], log_s_list,
  log_det_w_list)``.
  """
  if remat_scope not in ("flow", "wn"):
    raise ValueError(f"remat_scope must be 'flow' or 'wn', got {remat_scope!r}")
  group = isinstance(params, (list, tuple))
  head = params[0] if group else params
  batch, t_audio = audio.shape
  up = upsample_mel(head, spect, compute_dtype)
  if up.shape[1] < t_audio:
    raise ValueError(f"upsampled mel ({up.shape[1]} samples) is shorter than "
                     f"the audio ({t_audio})")
  spect_g = unfold_groups(up[:, :t_audio, :], config.n_group)
  audio_g = audio.float().reshape(batch, t_audio // config.n_group,
                                  config.n_group)

  def wn_call(wn_params, audio_0):
    if group:
      return wn_forward_train_tp(wn_params, audio_0, spect_g,
                                 config.n_channels, config.n_layers,
                                 config.kernel_size,
                                 compute_dtype=compute_dtype)
    return wn_forward_train(wn_params, audio_0, spect_g, config.n_channels,
                            config.n_layers, config.kernel_size,
                            compute_dtype=compute_dtype, layer=layer)

  def flow_step(flow, audio_g, channels):
    # a model group's flow is its ranks' flow dicts
    wn_params = [f["wn"] for f in flow] if group else flow["wn"]
    inv = flow[0]["inv1x1"] if group else flow["inv1x1"]
    audio_g, log_det_w = inv1x1.forward(audio_g, inv["w"])
    n_half = channels // 2
    audio_0 = audio_g[..., :n_half]
    audio_1 = audio_g[..., n_half:]
    if remat and remat_scope == "wn":
      wn_out = checkpoint(wn_call, wn_params, audio_0, use_reentrant=False,
                          preserve_rng_state=False)
    else:
      wn_out = wn_call(wn_params, audio_0)
    b = wn_out[..., :n_half]
    log_s = wn_out[..., n_half:]
    audio_1 = torch.exp(log_s) * audio_1 + b
    return torch.cat([audio_0, audio_1], dim=-1), log_s, log_det_w

  output_chunks: List[torch.Tensor] = []
  log_s_list: List[torch.Tensor] = []
  log_det_w_list: List[torch.Tensor] = []
  for k, channels in enumerate(config.flow_channel_counts()):
    if k % config.n_early_every == 0 and k > 0:
      output_chunks.append(audio_g[..., :config.n_early_size])
      audio_g = audio_g[..., config.n_early_size:]
    flow = ([p["flows"][k] for p in params] if group
            else params["flows"][k])
    if remat and remat_scope == "flow":
      audio_g, log_s, log_det_w = checkpoint(
          flow_step, flow, audio_g, channels, use_reentrant=False,
          preserve_rng_state=False)
    else:
      audio_g, log_s, log_det_w = flow_step(flow, audio_g, channels)
    log_s_list.append(log_s)
    log_det_w_list.append(log_det_w)
  output_chunks.append(audio_g)
  return torch.cat(output_chunks, dim=-1), log_s_list, log_det_w_list


def infer_noise_shapes(config: WaveGlowConfig, batch: int,
                       n_groups: int) -> List[Tuple[int, int, int]]:
  """Shapes of the noise tensors :func:`infer` consumes, in draw order: the
  main z first, then one early-noise block per emitting flow as the
  reversed loop passes it (k descending)."""
  shapes = [(batch, n_groups, config.n_remaining_channels)]
  for k in reversed(range(config.n_flows)):
    if k % config.n_early_every == 0 and k > 0:
      shapes.append((batch, n_groups, config.n_early_size))
  return shapes


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
  """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow:
  the constant is split in 16-bit halves so no product exceeds 2^48."""
  lo, hi = c & 0xFFFF, c >> 16
  return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
  """A 32-bit integer mixer (xorshift-multiply, 'lowbias32') on int64
  tensors holding values in [0, 2^32); exact on every device."""
  x = x ^ (x >> 16)
  x = _mul32(x, 0x7FEB352D)
  x = x ^ (x >> 15)
  x = _mul32(x, 0x846CA68B)
  return x ^ (x >> 16)


def block_noise(seeds: Union[int, Sequence[int], torch.Tensor],
                config: WaveGlowConfig, start_group: int, n_groups: int,
                device: torch.device) -> List[torch.Tensor]:
  """Position-keyed standard-normal synthesis noise for audio groups
  [start_group, start_group + n_groups), one row per seed.

  Each value is a function of (row seed, noise-tensor index, absolute
  group, channel) only: an integer hash gives two uniforms, Box-Muller turns
  them into a normal. A window or a bucket-padded call therefore draws the
  same values at the same positions, and a row's noise does not depend on
  what it is batched with.
  """
  seeds = to_device(seeds, device, torch.int64).reshape(-1)
  batch = seeds.numel()
  seed_key = _hash32(_hash32(seeds & _MASK32) ^ ((seeds >> 32) & _MASK32))
  groups = torch.arange(start_group, start_group + n_groups,
                        dtype=torch.int64, device=device)
  noise = []
  for i, (_, _, ch) in enumerate(infer_noise_shapes(config, batch,
                                                    n_groups)):
    chans = torch.arange(ch, dtype=torch.int64, device=device)
    key = _hash32(seed_key ^ i)[:, None, None]                     # [B,1,1]
    key = _hash32(key ^ (groups & _MASK32)[None, :, None])         # [B,G,1]
    key = _hash32(key ^ chans[None, None, :])                      # [B,G,ch]
    u1 = (_hash32(key ^ 0x68E31DA4).double() + 1.0) / 4294967296.0  # (0, 1]
    u2 = _hash32(key ^ 0xB5297A4D).double() / 4294967296.0          # [0, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    noise.append(z.float())
  return noise


def infer(params, config: WaveGlowConfig, spect: torch.Tensor,
          sigma: Union[float, torch.Tensor] = 1.0,
          noise: Optional[Sequence[torch.Tensor]] = None,
          seed: Union[int, Sequence[int]] = 0, compute_dtype=None,
          true_frames=None, layer: LayerFn = wn_layer_fused,
          device: Optional[Union[str, torch.device]] = "cuda"
          ) -> torch.Tensor:
  """Synthesis: mel [B, n_mels, frames] -> waveform [B, frames * 256].

  Runs on ``device``: the card by default (raises without one), the CPU
  only when asked (``device="cpu"``). ``params`` are fused torch tensors on
  that device, in bf16 mode made by :func:`params_for_compute`; ``spect``
  (numpy or tensor) is moved there. ``noise``: the
  injected standard-normal tensors of :func:`infer_noise_shapes`; without
  it :func:`block_noise` draws them from ``seed`` (one per row, or one for
  all rows). ``sigma`` scales every noise tensor (a float or a per-row [B]
  tensor). ``true_frames`` (int or per-row [B]): the count of real frames
  when the mel carries bucket-pad frames; WN residual rows past it are
  zeroed, so kept samples equal the unpadded call's.

  ``params`` may also be a tensor-parallel group: a list of model ranks'
  trees (``parallel.sharding.shard_params``), rank 0's on ``device``. Then
  every WN stack runs :func:`models.wn.wn_forward_tp` over the ranks
  (``layer`` is not used) and everything else runs on rank 0's device.
  """
  device = resolve_device(device)
  shards = None
  if isinstance(params, (list, tuple)):
    shards, params = params, params[0]
  spect = to_device(spect, device, torch.float32)
  up = upsample_mel(params, spect, compute_dtype)
  up = up[:, :-(UPSAMPLE_KERNEL - UPSAMPLE_STRIDE), :]
  batch = up.shape[0]
  n_groups = up.shape[1] // config.n_group
  spect_g = unfold_groups(up[:, :n_groups * config.n_group, :],
                          config.n_group)

  shapes = infer_noise_shapes(config, batch, n_groups)
  if noise is None:
    seeds = torch.as_tensor(seed, dtype=torch.int64).reshape(-1)
    if seeds.numel() == 1:
      seeds = seeds.expand(batch)
    noise = block_noise(seeds, config, 0, n_groups, device)
  else:
    if len(noise) != len(shapes):
      raise ValueError(f"expected {len(shapes)} noise tensors, got "
                       f"{len(noise)}")
    for n, s in zip(noise, shapes):
      if tuple(n.shape) != s:
        raise ValueError(f"noise shape {tuple(n.shape)} != expected {s}")
    noise = [torch.as_tensor(n, dtype=torch.float32, device=device)
             for n in noise]
  sigma = to_device(sigma, device, torch.float32)
  if sigma.ndim:
    sigma = sigma.reshape(-1, 1, 1)

  valid_t = None
  if true_frames is not None:
    frames = to_device(true_frames, device, torch.int32)
    valid_t = (frames.reshape(-1) * config.groups_per_frame).expand(
        batch).contiguous()

  if shards is not None:
    devices = [params_device(shard) for shard in shards]
    spects = [spect_g if d == device else spect_g.to(d) for d in devices]
    valid_ts = (None if valid_t is None else
                [valid_t if d == device else valid_t.to(d) for d in devices])

  audio_g = sigma * noise[0]
  noise_idx = 1
  channel_counts = config.flow_channel_counts()
  for k in reversed(range(config.n_flows)):
    flow = params["flows"][k]
    n_half = channel_counts[k] // 2
    audio_0 = audio_g[..., :n_half]
    audio_1 = audio_g[..., n_half:]
    if shards is None:
      wn_out = wn_forward(flow["wn"], audio_0, spect_g, config.n_channels,
                          config.n_layers, config.kernel_size,
                          compute_dtype=compute_dtype, valid_t=valid_t,
                          layer=layer)
    else:
      wn_out = wn_forward_tp([shard["flows"][k]["wn"] for shard in shards],
                             audio_0, spects, config.n_channels,
                             config.n_layers, config.kernel_size,
                             compute_dtype=compute_dtype, valid_ts=valid_ts)
    b = wn_out[..., :n_half]
    s = wn_out[..., n_half:]
    audio_1 = (audio_1 - b) * torch.exp(-s)
    audio_g = inv1x1.reverse(torch.cat([audio_0, audio_1], dim=-1),
                             flow["inv1x1"]["w_inv"])
    if k % config.n_early_every == 0 and k > 0:
      audio_g = torch.cat([sigma * noise[noise_idx], audio_g], dim=-1)
      noise_idx += 1
  return audio_g.reshape(batch, n_groups * config.n_group)
