"""Device meshes for sharded serving, and the reduce of the model axis
(counterpart of ``waveglow_tpu/parallel/mesh.py``).

A :class:`Mesh` is a grid of ``torch.device``s with named axes, as a
``jax.sharding.Mesh`` is a grid of JAX devices:

  data  - batch rows (each device synthesizes its rows)
  model - WN hidden-channel tensor parallelism (``parallel/sharding.py``)
  time  - an utterance's frames, split into spans
          (``parallel/time_shard.py``)

One process drives every device of the mesh: the port places tensors and
enqueues each device's work itself, where the JAX package commits named
shardings and lets GSPMD partition its programs. The grid is the devices in
order, the model axis the minor one; there is no interconnect topology to
map (``_topology_grid`` of the JAX package is the TPU's ICI/DCN layout).
Multi-process training meshes (``initialize_multihost``) are not here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIME_AXIS = "time"

DeviceLike = Union[str, torch.device]


class Mesh:
  """A grid of devices with named axes.

  ``devices`` is a numpy object array of ``torch.device``s, one axis per
  name in ``axis_names``; ``shape`` maps each name to its size in axis
  order, so ``dict(mesh.shape)`` reads ``{"data": 2, "model": 2}`` as the
  JAX mesh's does.
  """

  def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
    if devices.ndim != len(axis_names):
      raise ValueError(f"a {devices.ndim}-d device grid for axes "
                       f"{axis_names}")
    self.devices = devices
    self.axis_names = tuple(axis_names)

  @property
  def shape(self) -> Dict[str, int]:
    return dict(zip(self.axis_names, self.devices.shape))

  def size(self, axis: str) -> int:
    """The size of ``axis``, 1 when the mesh has no such axis."""
    return self.shape.get(axis, 1)

  @property
  def first_device(self) -> torch.device:
    return self.devices.flat[0]

  def __repr__(self) -> str:
    return f"Mesh({self.shape}, {list(self.devices.flat)})"


def _devices(n: int, devices: Optional[Sequence[DeviceLike]], what: str
             ) -> List[torch.device]:
  if devices is None:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = [torch.device("cuda", i) for i in range(count)]
    if n > len(devices):
      raise ValueError(f"{what} needs {n} CUDA devices (cards), have "
                       f"{len(devices)}")
  devices = [torch.device(d) for d in devices]
  if n > len(devices):
    raise ValueError(f"{what} needs {n} devices, have {len(devices)}")
  return devices[:n]


def make_mesh(data: int = 1, model: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
  """A (data, model) mesh over ``cuda:0 .. cuda:n-1`` (``n = data *
  model``), or over the first n of ``devices``; raises ``ValueError``
  naming the count when there are fewer. The model axis is the minor one:
  a model group is n consecutive devices.

  ``devices`` may list one device more than once. The tests and
  ``chip_smoke.py`` run every sharded path that way on one device (``["cpu"]
  * n``, ``["cuda:0"] * n``): each shard then runs after the other, so such
  a mesh checks the numbers and gives no parallel speed.
  """
  if data < 1 or model < 1:
    raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                     f"model={model}")
  grid = _devices(data * model, devices, f"mesh {data}x{model}")
  return Mesh(np.array(grid, dtype=object).reshape(data, model),
              (DATA_AXIS, MODEL_AXIS))


def make_time_mesh(time: int = 1,
                   devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
  """A 1-d ``time`` mesh over ``cuda:0 .. cuda:time-1`` or the first
  ``time`` of ``devices`` (which may repeat a device, as in
  :func:`make_mesh`)."""
  if time < 1:
    raise ValueError(f"time mesh size must be >= 1, got {time}")
  grid = _devices(time, devices, "time mesh")
  return Mesh(np.array(grid, dtype=object), (TIME_AXIS,))


def reduce_partials(partials: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  """All-reduce of the model ranks' partial sums: summed in rank order on
  rank 0's device, then copied to each rank's device. Every rank gets the
  same bits, so the replicated residual streams never drift apart. A rank
  on rank 0's device gets the sum itself (no copy)."""
  total = partials[0]
  for p in partials[1:]:
    total = total + p.to(total.device)
  return [total if p.device == total.device else total.to(p.device)
          for p in partials]
