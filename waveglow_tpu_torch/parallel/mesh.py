"""Device meshes, the sums of the model axis, and the process group of
multi-process training (counterpart of ``waveglow_tpu/parallel/mesh.py``).

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

Every sum across model ranks runs in rank order, so every rank gets the
same bits whatever devices they sit on: :func:`reduce_partials` for
serving, and for training the Megatron conjugate pair of autograd
Functions, :func:`copy_to_model_ranks` (forward: the broadcast of a
tensor held once; backward: the rank-order sum of the ranks' cotangents)
and :func:`reduce_from_model_ranks` (forward: the rank-order sum of the
ranks' partials, held once; backward: the broadcast of its cotangent).
Autograd's own accumulation across device branches has no fixed order.

Multi-process training joins a ``torch.distributed`` process group
(:func:`initialize_multihost`, with the address, world size and rank
given: no cluster discovery); each process drives its own (data, model)
mesh and :func:`all_reduce_ordered` sums the processes' gradients in
process order.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

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


class _CopyToModelRanks(torch.autograd.Function):
  """Forward: ``x`` (held once) on each rank's device; backward: the ranks'
  cotangents summed in rank order on ``x``'s device."""

  @staticmethod
  def forward(ctx, x, *devices):
    ctx.set_materialize_grads(False)
    ctx.source = x.device
    return tuple(x.view_as(x) if d == x.device else x.to(d) for d in devices)

  @staticmethod
  def backward(ctx, *grads):
    total = None
    for g in grads:
      if g is not None:
        g = g.to(ctx.source)
        total = g if total is None else total + g
    return (total,) + (None,) * len(grads)


class _ReduceFromModelRanks(torch.autograd.Function):
  """Forward: the partials summed in rank order on the first rank's device
  (:func:`reduce_partials`), held once; backward: its cotangent on each
  rank's device."""

  @staticmethod
  def forward(ctx, *partials):
    ctx.set_materialize_grads(False)
    ctx.devices = [p.device for p in partials]
    return reduce_partials(partials)[0]

  @staticmethod
  def backward(ctx, g):
    if g is None:
      return (None,) * len(ctx.devices)
    return tuple(g if d == g.device else g.to(d) for d in ctx.devices)


def copy_to_model_ranks(x: torch.Tensor, devices: Sequence[torch.device]
                        ) -> Tuple[torch.Tensor, ...]:
  """A tensor every model rank reads, held once (on rank 0's device), as one
  tensor on each rank's device; differentiable: the gradient of ``x`` is the
  sum of the ranks' cotangents, taken in rank order. A rank on ``x``'s
  device gets a view of ``x``, not a copy."""
  return _CopyToModelRanks.apply(x, *[torch.device(d) for d in devices])


def reduce_from_model_ranks(partials: Sequence[torch.Tensor]) -> torch.Tensor:
  """The model ranks' partial sums summed in rank order on the first rank's
  device (held once; :func:`copy_to_model_ranks` takes it back to the
  ranks); differentiable: each partial's gradient is the sum's."""
  return _ReduceFromModelRanks.apply(*partials)


# seconds a collective may wait for the other processes before it fails
PROCESS_GROUP_TIMEOUT_S = 600


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = PROCESS_GROUP_TIMEOUT_S) -> None:
  """Join the multi-process group of a training run: a no-op for one
  process (``num_processes`` None or 1), and when this process already
  joined a group of that size and rank.

  ``coordinator_address`` is ``host:port`` of process 0 (a ``tcp://`` init
  method), and ``process_id`` this process's rank; nothing is discovered.
  ``backend`` defaults to ``nccl`` on a host with CUDA and ``gloo``
  without; processes that share one card need ``gloo`` (NCCL will not put
  two ranks on one device). ``timeout_s`` bounds every collective.
  """
  if num_processes is None or num_processes <= 1:
    return
  if coordinator_address is None or process_id is None:
    raise ValueError("a multi-process run needs --coordinator-address and "
                     "--process-id beside --num-processes")
  if not 0 <= process_id < num_processes:
    raise ValueError(f"process id {process_id} is outside [0, "
                     f"{num_processes})")
  if dist.is_initialized():
    if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                    process_id):
      raise ValueError(
          f"this process already joined a group as rank "
          f"{dist.get_rank()} of {dist.get_world_size()}, not "
          f"{process_id} of {num_processes}")
    return
  if backend is None:
    backend = "nccl" if torch.cuda.is_available() else "gloo"
  dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                          world_size=num_processes, rank=process_id,
                          timeout=datetime.timedelta(seconds=timeout_s))


def process_index() -> int:
  """This process's rank in the training group (0 without one)."""
  return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
  """The processes of the training group (1 without one)."""
  return dist.get_world_size() if dist.is_initialized() else 1


# What all_reduce_ordered has cost this process, summed over its calls:
# the calls, their wall milliseconds, the milliseconds of host staging (gloo
# with a CUDA buffer; 0 otherwise) and the bytes reduced.
REDUCE_STATS: Dict[str, float] = {"calls": 0, "ms": 0.0, "staged_ms": 0.0,
                                  "bytes": 0}


def all_reduce_ordered(flat: torch.Tensor) -> torch.Tensor:
  """Every process's ``flat`` (a 1-d f32 buffer) summed in process order:
  gathered, then added rank by rank, so every process gets the same bits
  (an NCCL or gloo all-reduce promises no order). With ``gloo`` a CUDA
  buffer goes through the host; :data:`REDUCE_STATS` keeps what that
  cost.
  Returns the sum on ``flat``'s device; ``flat`` itself without a group."""
  count = process_count()
  if count == 1:
    return flat
  if flat.is_cuda:
    torch.cuda.synchronize(flat.device)  # time the reduce, not the backward
  start = time.perf_counter()
  stage = dist.get_backend() == "gloo" and flat.device.type != "cpu"
  staged_s = 0.0
  src = flat
  if stage:
    src = flat.cpu()
    staged_s += time.perf_counter() - start
  parts = [torch.empty_like(src) for _ in range(count)]
  dist.all_gather(parts, src)
  total = parts[0]
  for part in parts[1:]:
    total = total + part
  if stage:
    back = time.perf_counter()
    total = total.to(flat.device)
    staged_s += time.perf_counter() - back
  REDUCE_STATS["calls"] += 1
  REDUCE_STATS["ms"] += (time.perf_counter() - start) * 1e3
  REDUCE_STATS["staged_ms"] += staged_s * 1e3
  REDUCE_STATS["bytes"] += flat.numel() * 4
  return total
