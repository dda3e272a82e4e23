"""Where a synthesizer's weights live and where each row of a batch runs:
one device, or a :class:`parallel.mesh.Mesh` (counterpart of the JAX
synthesizers' ``_put_params`` / ``_put_mel`` and their mesh rules).

  * no mesh: one params tree on one device, every row there;
  * a ``data`` axis: a replica (or a tensor-parallel group) per data index;
    a batch whose rows divide evenly splits into one contiguous row group
    per index, any other batch runs whole on the first (the JAX package
    replicates such a batch);
  * a ``model`` axis: each replica is a tensor-parallel group, a list of
    the model ranks' trees (``models.waveglow.infer`` runs its WN stacks
    through ``models.wn.wn_forward_tp``);
  * a ``time`` axis: a replica per time device, and every batch runs
    through ``parallel.time_shard.infer_time_sharded``, stitched on the
    first device.

The work of every group is enqueued before anything is waited for.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from waveglow_tpu_torch.device import resolve_device, to_device
from waveglow_tpu_torch.models.waveglow import (WaveGlowConfig, infer,
                                                params_device,
                                                params_for_compute,
                                                params_to_torch)
from waveglow_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                              TIME_AXIS, Mesh)
from waveglow_tpu_torch.parallel.sharding import shard_params
from waveglow_tpu_torch.parallel.time_shard import infer_time_sharded

Rows = slice


def _same_device(a: torch.device, b: torch.device) -> bool:
  return a.type == b.type and (a.index or 0) == (b.index or 0)


def _rows(value, rows: Rows):
  """Rows ``rows`` of a per-row value; a scalar or None as it is."""
  if value is None or np.ndim(value) == 0:
    return value
  return value[rows]


class Placement:
  """The devices of a synthesizer and its params on them.

  ``device`` and ``mesh``: with no mesh the synthesizer runs on ``device``
  (None means the card); with a mesh on its devices, and ``device``, when
  given, must be the mesh's first device. Raises without a card when a
  CUDA device is named."""

  def __init__(self, mesh: Optional[Mesh],
               device: Optional[Union[str, torch.device]]):
    if mesh is None:
      self.device = resolve_device(device)
    else:
      first = mesh.first_device
      if device is not None and not _same_device(torch.device(device),
                                                 first):
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{first}; pass one of them")
      for dev in mesh.devices.flat:
        resolve_device(dev)
      self.device = resolve_device(first)
    self.mesh = mesh
    self.data = mesh.size(DATA_AXIS) if mesh is not None else 1
    self.model = mesh.size(MODEL_AXIS) if mesh is not None else 1
    self.time = mesh.size(TIME_AXIS) if mesh is not None else 1
    self.groups: List = []

  def put(self, fused: Dict, compute_dtype) -> List:
    """Place a fused numpy params tree: sets ``groups`` (per data or time
    index: a tree, or a tensor-parallel list of trees, in the compute
    dtype) and returns the same groups in f32 (for the denoiser's bias)."""
    if self.mesh is None:
      f32 = [params_to_torch(fused, self.device)]
    else:
      grid = shard_params(fused, self.mesh)
      f32 = [row if self.model > 1 else row[0] for row in grid]

    def cast(group):
      if isinstance(group, list):
        return [params_for_compute(tree, compute_dtype) for tree in group]
      return params_for_compute(group, compute_dtype)

    self.groups = [cast(g) for g in f32]
    return f32

  @property
  def devices(self) -> List[torch.device]:
    """The first device of each group, in order."""
    return [params_device(g) for g in self.groups]

  def all_devices(self) -> List[torch.device]:
    """Every distinct device of the placement."""
    seen: Dict[str, torch.device] = {}
    devices = ([self.device] if self.mesh is None
               else list(self.mesh.devices.flat))
    for dev in devices:
      seen.setdefault(str(dev), dev)
    return list(seen.values())

  def row_groups(self, batch: int) -> List[Tuple[Rows, int]]:
    """(rows, group index) of each group a batch of ``batch`` rows runs
    as: one per data index when ``batch`` divides evenly, else all rows on
    group 0."""
    if self.data > 1 and batch % self.data == 0:
      n = batch // self.data
      return [(slice(i * n, (i + 1) * n), i) for i in range(self.data)]
    return [(slice(0, batch), 0)]

  def synthesize(self, config: WaveGlowConfig, mel, *, sigma=1.0,
                 seeds: Sequence[int], compute_dtype=None,
                 true_frames=None, noise=None
                 ) -> List[Tuple[Rows, torch.Tensor]]:
    """Enqueue ``models.waveglow.infer`` of mel [B, n_mels, F] (numpy or a
    tensor) on the placement; returns ``(rows, waveform)`` per group, each
    waveform on its group's first device. ``sigma``, ``true_frames``: a
    scalar or one a row; ``seeds`` one a row; ``noise``: injected noise in
    ``infer``'s order, [B, groups, ch] each."""
    batch = int(mel.shape[0])
    seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
    if self.time > 1:
      wav = infer_time_sharded(self.groups, config, mel, sigma=sigma,
                               seed=seeds, compute_dtype=compute_dtype,
                               true_frames=true_frames, noise=noise)
      return [(slice(0, batch), wav)]
    out = []
    for rows, g in self.row_groups(batch):
      params = self.groups[g]
      device = params_device(params)
      sig = _rows(sigma, rows)
      if sig is not None and np.ndim(sig):
        sig = to_device(sig, device, torch.float32)
      wav = infer(params, config, to_device(mel[rows], device, torch.float32),
                  sigma=sig,
                  noise=None if noise is None else [n[rows] for n in noise],
                  seed=seeds[rows].tolist(), compute_dtype=compute_dtype,
                  true_frames=_rows(true_frames, rows), device=device)
      out.append((rows, wav))
    return out
