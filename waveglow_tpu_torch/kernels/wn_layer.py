"""Fused WN layer, forward and bf16 backward: CUDA kernel wrappers and
their plain PyTorch versions.

Replaces ``waveglow_tpu/kernels/wn_layer.py::_wn_layer_fused`` (Pallas, TPU).
The forward kernels are in ``csrc/wn_layer.cu``: f32 FMAs on the CUDA cores
for f32 (parity) and wgmma on the tensor cores for bf16; the bf16
backward's kernels (the whole layer's and a model rank's) are in
``csrc/wn_layer_bwd.cu``. The note at the top of each says what bounds it
on an H100 and how it is laid out. All are compiled with nvcc for
``sm_90a`` at first use into one library in ``waveglow_tpu_torch/build/``
(keyed by a hash of the sources and flags) and bound with ctypes.

Math of one layer, channels-last (``C`` channels, dilation ``d``):

  pre  = sum_tap x[t + (tap-1)*d] @ w_in[tap]        (zero "same" padding)
  acts = tanh(pre[:C] + b_in[:C] + cond[:C]) * sigmoid(pre[C:] + b_in[C:] + cond[C:])
  rs   = acts @ w_rs + b_rs
  x'   = x + rs[:C], skip = rs[C:]                   (last layer: x' = x, skip = rs)

x' rows ``>= valid_t[b]`` are zeroed (bucket padding), and with ``skip_acc``
the skip is added into that buffer in place and the buffer returned.

``wn_layer_fused`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; on a CUDA tensor it launches the kernel or raises, never falls
back. ``LAUNCHES`` counts kernel launches. Every kernel is built for the
widths ``kernel_widths()`` (C = 128, 256, 512; the shard kernel for
``shard_pairs()``), and ``check_width`` refuses any other on the card.

``wn_layer_shard`` is one model rank's share of a layer on a ``model``
mesh axis (``csrc/wn_layer_shard.cu``, and in bf16 at C = 512 the C = 512
layer's kernels of ``csrc/wn_layer.cu``, built into the same library): the
same conv, gate and res/skip product over C' = C / model of the gate
channels, giving the rank's partial res/skip sum without b_rs and the
residual, which ``models.wn.wn_forward_tp`` adds after the ranks' reduce.
It runs ``wn_layer_shard_plain`` for CPU tensors and the kernel, or
raises, for CUDA tensors; ``SHARD_LAUNCHES`` counts its launches.

``wn_layer_trainable`` is the differentiable layer (counterpart of the JAX
package's custom-VJP ``wn_layer_trainable``): its forward is
``wn_layer_fused`` without ``skip_acc`` (the kernel on the card). Its
backward computes the closed-form adjoints of ``_wn_layer_trainable_bwd``,
recomputing taps, gates and acts: in bf16 on the card by the five kernels
of ``csrc/wn_layer_bwd.cu`` (``wn_layer_backward_fused``, counted in
``BWD_LAUNCHES``), in f32 on the card by torch ops (``wn_layer_backward``,
the designated parity-mode route: its products must stay true f32), and on
the CPU by ``wn_layer_backward``, which is also the bf16 kernel's yardstick.

``wn_layer_shard_trainable`` is the differentiable shard, for training on a
``model`` mesh axis: its forward is ``wn_layer_shard``; its backward gives
the rank's adjoints and its partial dx, in bf16 on the card by the four
kernels of ``csrc/wn_layer_bwd.cu`` (``wn_layer_shard_backward_fused``,
counted in ``SHARD_BWD_LAUNCHES``), otherwise by torch ops
(``wn_layer_shard_backward``, the CPU path, the f32 route and the kernel's
yardstick).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from waveglow_tpu_torch.ops.conv import dilated_conv, shift_time

LAUNCHES = 0
BWD_LAUNCHES = 0
SHARD_LAUNCHES = 0
SHARD_BWD_LAUNCHES = 0

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "wn_layer.cu", CSRC / "wn_layer_bwd.cu",
           CSRC / "wn_layer_shard.cu")
# Included by the sources: the f32 ring and tile (the forward, the shard
# and, for its cp.async helpers, the backward) and the wgmma helpers (the
# forward's bf16 kernels and the backward).
HEADERS = (CSRC / "f32_ring.cuh", CSRC / "sm90_wgmma.cuh")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The widths C every kernel is built for (the template instances of
# csrc/*.cu: the forward, the bf16 backward and the shard kernel).
_WIDTHS = (128, 256, 512)
# The shard kernel holds C' = C / model gate channels, model in this set.
SHARD_MODELS = (2, 4, 8)

_LIB = None
# nvcc/ptxas output and seconds of a build this process ran; empty and None
# when it loaded a library an earlier process built
BUILD_LOG = ""
BUILD_SECONDS = None

ValidT = Optional[Union[int, torch.Tensor]]


def kernel_widths() -> Tuple[int, ...]:
  """The widths C the kernels are built for."""
  return _WIDTHS


def shard_pairs() -> Tuple[Tuple[int, int], ...]:
  """The (C, C') pairs the shard kernel is built for: C' = C / model."""
  return tuple((c, c // m) for c in _WIDTHS for m in SHARD_MODELS)


def check_width(c: int, cp: Optional[int] = None) -> None:
  """Raise ``ValueError`` naming the built set unless the kernels are built
  for width ``c`` (and, with ``cp``, the shard kernel for ``cp`` gate
  channels a rank)."""
  if cp is None and c not in _WIDTHS:
    raise ValueError(f"the kernels are built for C in {_WIDTHS}, got C = {c}")
  if cp is not None and (c, cp) not in shard_pairs():
    raise ValueError(
        f"the shard kernel is built for (C, C') in {list(shard_pairs())} "
        f"(C' = C / model, model in {SHARD_MODELS}), got C = {c}, C' = {cp}")


def wn_layer_plain(x: torch.Tensor, cond: torch.Tensor, w_in: torch.Tensor,
                   b_in: torch.Tensor, w_rs: torch.Tensor, b_rs: torch.Tensor,
                   dilation: int, valid_t: ValidT = None,
                   skip_acc: Optional[torch.Tensor] = None,
                   compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
  """The layer in plain torch ops: the CPU path and the kernel's yardstick.

  Shapes: x [B, T, C] f32; cond [B, T, 2, C] or [B, T, 2C]; w_in [3, C, 2C]
  (or [3, C, 2, C]); b_in [2C]; w_rs [C, 2C] / [C, 2, C] or [C, C] (last
  layer); b_rs to match. ``valid_t``: None, an int, or a [B] tensor.

  ``compute_dtype=torch.bfloat16`` rounds every product operand to bf16
  (the taps of x, the weights, cond and the gated acts) and accumulates
  every product in f32; pre, the gate, rs and the residual stay f32. These
  are the rounding points of the Pallas body; the XLA layer body rounds
  pre, the gate and rs to bf16 as well.
  """
  batch, t, c = x.shape
  f32 = torch.float32

  def operand(v):
    return v.float() if compute_dtype is None else v.to(compute_dtype).float()

  xm = operand(x)
  pre = dilated_conv(xm, operand(w_in).reshape(3, c, 2 * c),
                     dilation=dilation)
  gates = (pre + b_in.reshape(-1).to(f32)
           + operand(cond).reshape(batch, t, 2 * c))
  acts = torch.tanh(gates[..., :c]) * torch.sigmoid(gates[..., c:])
  acts = operand(acts)
  w_rs = operand(w_rs).reshape(c, -1)
  rs = torch.matmul(acts, w_rs) + b_rs.reshape(-1).to(f32)
  if w_rs.shape[-1] == c:
    x_next, skip = x.to(f32), rs
  else:
    x_next, skip = x.to(f32) + rs[..., :c], rs[..., c:]
  keep = _row_mask(valid_t, t, x.device)
  if keep is not None:
    x_next = torch.where(keep, x_next, torch.zeros((), device=x.device))
  if skip_acc is not None:
    skip = skip_acc.add_(skip)
  return x_next, skip


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  default = Path("/usr/local/cuda/bin/nvcc")
  if default.is_file():
    return str(default)
  raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                     + ", ".join(s.name for s in SOURCES))


def build_library() -> Path:
  """Compile ``csrc/*.cu`` into one shared library (once per hash of the
  sources and flags): one nvcc per source, all started together, then one
  link. Returns the library's path; raises with nvcc's output on failure."""
  global BUILD_LOG, BUILD_SECONDS
  digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for src in SOURCES + HEADERS:
    digest.update(src.read_bytes())
  lib = BUILD_DIR / f"wn_layer_{digest.hexdigest()[:16]}.so"
  if lib.is_file():
    return lib
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    start = time.perf_counter()
    nvcc = _nvcc()
    objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    for src, proc, log in zip(SOURCES, procs, logs):
      if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    out = Path(tmp) / "lib.so"
    link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS, "-o", str(out),
                           *map(str, objs)], capture_output=True, text=True,
                          check=False)
    if link.returncode != 0:
      raise RuntimeError(f"nvcc failed to link {lib.name}:\n{link.stderr}")
    BUILD_SECONDS = time.perf_counter() - start
    BUILD_LOG = "".join(logs)
    os.replace(out, lib)  # atomic: concurrent builds race harmlessly
  return lib


_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# The argument types of each C entry point of the library; each returns a
# cudaError_t (0 on success) as an int.
SIGNATURES = {
    "wn_layer_forward": [_P] * 10 + [_I] * 7 + [_P],
    "wn_layer_backward_bf16": [_P] * 19 + [_I] * 7 + [_P],
    "wn_layer_shard_forward": [_P] * 6 + [_I] * 7 + [_P],
    "wn_layer_shard_wide_forward": [_P] * 7 + [_I] * 5 + [_P],
    "wn_layer_shard_backward_bf16": [_P] * 16 + [_I] * 8 + [_P],
    "wn_layer_kernel_info": [_I] * 3 + [_IP] * 4,
    "wn_layer_f32_rest_kernel_info": [_I] + [_IP] * 4,
    "wn_layer_shard_kernel_info": [_I] * 4 + [_IP] * 4,
    "wn_layer_bwd_kernel_info": [_I] * 4 + [_IP] * 4,
    "wn_layer_wide_kernel_info": [_I] * 3 + [_IP] * 4,
    "wn_layer_bwd_tile_rows": [_I] * 2,
    "wn_layer_bwd_weight_tiles": [_I] * 3,
    "wn_layer_f32_schedule": [_I] * 4 + [_IP] * 4,
    "wn_layer_shard_f32_schedule": [_I] * 5 + [_IP] * 6,
    "wn_layer_wide_schedule": [_I] * 4 + [_IP] * 4,
}


def load_library(path) -> ctypes.CDLL:
  """Load a build of ``csrc/`` and declare the types of each entry point
  of :data:`SIGNATURES` that it holds (a build of one source holds only
  that source's)."""
  lib = ctypes.CDLL(str(path))
  for name, argtypes in SIGNATURES.items():
    fn = getattr(lib, name, None)
    if fn is not None:
      fn.argtypes, fn.restype = argtypes, ctypes.c_int
  return lib


def _library():
  global _LIB
  if _LIB is None:
    _LIB = load_library(build_library())
  return _LIB


def _info(fn, *args) -> dict:
  vals = [ctypes.c_int() for _ in range(4)]
  err = fn(*args, *[ctypes.byref(v) for v in vals])
  if err != 0:
    raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
  keys = ("registers", "local_bytes", "static_smem_bytes",
          "dynamic_smem_bytes")
  return dict(zip(keys, (v.value for v in vals)))


def kernel_info(channels: int, bf16: bool, last: bool) -> dict:
  """What the loaded build of one forward kernel variant (width
  ``channels``) uses, from the CUDA runtime (cudaFuncGetAttributes):
  registers and local (spill) bytes per thread, static shared bytes, and
  the dynamic shared bytes its launcher passes."""
  check_width(channels)
  return _info(_library().wn_layer_kernel_info, channels, int(bf16),
               int(last))


def f32_rest_kernel_info(last: bool) -> dict:
  """:func:`kernel_info` for the f32 forward's rest kernel at C = 512
  (``wn_layer_kernel_f32_rest``; ``kernel_info(512, False, last)`` is its
  tiles kernel's)."""
  return _info(_library().wn_layer_f32_rest_kernel_info, int(last))


def shard_kernel_info(channels: int, cp: int, bf16: bool,
                      last: bool) -> dict:
  """:func:`kernel_info` for the shard kernel at width ``channels``
  holding ``cp`` gate channels (a pair of :func:`shard_pairs`); in bf16 at
  C = 512, the res/skip kernel of :func:`wide_kernel_info`, which ends a
  rank's call there."""
  check_width(channels, cp)
  if bf16 and channels == WIDE_C:
    return wide_kernel_info("rs", last, cp)
  return _info(_library().wn_layer_shard_kernel_info, channels, cp,
               int(bf16), int(last))


# The bf16 forward at C = 512, the whole layer's and a model rank's: its
# three kernels (``csrc/wn_layer.cu``), by their index in its C interface,
# and the rows of a unit of the gate and res/skip kernels (Wide::kTile).
WIDE_C = 512
WIDE_KERNELS = ("gate", "rs", "round")
WIDE_TILE_ROWS = 128


def wide_kernel_info(kernel: str, last: bool = False,
                     cp: int = WIDE_C) -> dict:
  """:func:`kernel_info` for one of ``WIDE_KERNELS`` of the bf16 forward at
  C = 512, the layer's (``cp`` = 512) or a rank's holding ``cp`` gate
  channels (``last`` picks the res/skip kernel's variant)."""
  check_width(WIDE_C, None if cp == WIDE_C else cp)
  return _info(_library().wn_layer_wide_kernel_info,
               WIDE_KERNELS.index(kernel), cp, int(last))


def wide_passes(last: bool, cp: int = WIDE_C) -> dict:
  """Passes of a 128-row tile in the C = 512 gate kernel at ``cp`` gate
  channels (the layer's 512 or a rank's C'; min(cp, 128) channels each)
  and in its res/skip kernel (256 of the n_rs columns each)."""
  return {"gate": cp // min(cp, 128),
          "rs": (WIDE_C if last else 2 * WIDE_C) // 256}


def wide_grid(batch: int, t: int, last: bool, slots: int,
              cp: int = WIDE_C) -> dict:
  """The grid of the bf16 forward at C = 512 (``cp`` gate channels: the
  layer's 512 or a rank's C') for ``batch`` x ``t`` rows on a device
  holding ``slots`` of its blocks at once, as its launcher picks it: the
  flat B*T rows in ``tiles`` of WIDE_TILE_ROWS (the last one short); a
  unit is (tile, pass), unit u = tile * passes + pass; each kernel runs
  min(units, slots) blocks, block b taking units b, b + blocks, ...
  (:func:`block_units`)."""
  tiles = -(-batch * t // WIDE_TILE_ROWS)
  out = {"slots": slots, "tiles": tiles}
  for kernel, passes in wide_passes(last, cp).items():
    out[f"{kernel}_units"] = tiles * passes
    out[f"{kernel}_blocks"] = min(tiles * passes, slots)
  return out


def block_units(units: int, blocks: int, block: int) -> range:
  """The units block ``block`` of a persistent C = 512 kernel walks."""
  return range(block, units, blocks)


def wide_schedule(batch: int, t: int, last: bool = False,
                  cp: int = WIDE_C) -> dict:
  """:func:`wide_grid` as the loaded library computes it on the current
  card (slots from the occupancy API)."""
  vals = [ctypes.c_int() for _ in range(4)]
  err = _library().wn_layer_wide_schedule(cp, batch, t, int(last),
                                          *[ctypes.byref(v) for v in vals])
  if err != 0:
    raise RuntimeError(f"the C = 512 schedule failed: cudaError {err}")
  slots, tiles, gate_blocks, rs_blocks = (v.value for v in vals)
  return {"slots": slots, "tiles": tiles, "gate_blocks": gate_blocks,
          "rs_blocks": rs_blocks}


def wide_scratch(batch: int, t: int, cp: int, bf16: bool) -> dict:
  """The scratch of the C = 512 forward as one allocation: in bf16 (the
  layer's, ``cp`` = 512, or a rank's holding ``cp`` gate channels) the
  rounded x [B*T, C] and the acts [B*T, cp], bf16, the gate kernel's
  operand and output; in f32 (the layer's) the acts [B*T, C] f32, which
  the kernel writes and reads back. Byte ``offsets`` (each 256-byte
  aligned), ``sizes`` and the total ``bytes``."""
  rows = batch * t
  sizes = ({"x_bf": rows * WIDE_C * 2, "acts": rows * cp * 2} if bf16
           else {"acts": rows * WIDE_C * 4})
  offsets, end = {}, 0
  for name, size in sizes.items():
    offsets[name] = end
    end += -(-size // 256) * 256
  return {"offsets": offsets, "sizes": sizes, "bytes": end}


# Time rows of one tile of the f32 kernel at C <= 256 (kTileRows in
# csrc/wn_layer.cu), of the C = 512 tiles kernel's (F32Tiles::kTileRows)
# and rest kernel's (F32Rest::kTileRows), the most rows of a block's rest
# at C = 512 (kF32RestRows), and the quantum a block's rows are a multiple
# of (kRowQuantum).
F32_TILE_ROWS = 48
F32_WIDE_TILE_ROWS = 96
F32_REST_TILE_ROWS = 16
F32_REST_ROWS = 48
F32_ROW_QUANTUM = 16


def f32_tiles(n: int, channels: int = 256) -> list:
  """The tiles of an f32 forward block holding ``n`` flat rows at width
  ``channels``, as (first row, rows, tile rows of the layout), in the
  order they run (csrc/wn_layer.cu). C <= 256: tiles of F32_TILE_ROWS,
  the last one short. C = 512: wn_layer_kernel_f32_tiles' tiles of
  F32_WIDE_TILE_ROWS, the last one short when over F32_REST_ROWS rows are
  left (f32_wide_tiles), else those rows as wn_layer_kernel_f32_rest's
  tiles of F32_REST_TILE_ROWS x all 512 channels (8 warps a tile;
  f32_wide_rest)."""
  if channels != WIDE_C:
    size = F32_TILE_ROWS
    return [(r, min(size, n - r), size) for r in range(0, n, size)]
  size, rest = F32_WIDE_TILE_ROWS, n % F32_WIDE_TILE_ROWS
  main = n // size + (rest > F32_REST_ROWS)
  out = [(k * size, min(size, n - k * size), size) for k in range(main)]
  if 0 < rest <= F32_REST_ROWS:
    out += [(r, min(F32_REST_TILE_ROWS, n - r), F32_REST_TILE_ROWS)
            for r in range(main * size, n, F32_REST_TILE_ROWS)]
  return out


def f32_grid(batch: int, t: int, slots: int) -> dict:
  """The f32 forward kernel's grid for ``batch`` x ``t`` rows on a device
  holding ``slots`` of its blocks at once, as its launcher picks it (one
  wave): block b takes the flat rows [b * rows_per_block, (b + 1) *
  rows_per_block) of the B*T rows, an equal share rounded up to
  F32_ROW_QUANTUM (the last block's short), in the tiles of
  :func:`f32_tiles`. At C = 512 a block writes the acts of its own rows to
  the scratch and reads them back; no other block touches them."""
  rows = batch * t
  per_block = -(-(-(-rows // slots)) // F32_ROW_QUANTUM) * F32_ROW_QUANTUM
  return {"rows_per_block": per_block, "blocks": -(-rows // per_block)}


def f32_rest_launched(batch: int, t: int, slots: int) -> bool:
  """Whether the f32 forward at C = 512 launches its rest kernel for
  ``batch`` x ``t`` rows on a device holding ``slots`` of its blocks: when
  a block (every one but the last holds rows_per_block rows) has a rest
  of F32_REST_ROWS rows or fewer past its 96-row tiles."""
  grid = f32_grid(batch, t, slots)
  last = batch * t - (grid["blocks"] - 1) * grid["rows_per_block"]
  return any(size == F32_REST_TILE_ROWS
             for n in (grid["rows_per_block"], last)
             for _, _, size in f32_tiles(n, WIDE_C))


def f32_schedule(batch: int, t: int, last: bool = False,
                 channels: int = 256, cp: Optional[int] = None) -> dict:
  """The grid of the f32 kernel at width ``channels`` (with ``cp``, of the
  f32 shard kernel at (``channels``, ``cp``)) for ``batch`` x ``t`` rows,
  as its launcher picks it: one wave of blocks (SMs x blocks an SM, from
  the occupancy API), each taking ``rows_per_block`` of the B*T rows in
  tiles, the last of them short. The shard kernel's grid also names its
  ``tile_rows`` and the ``quantum`` its rows a block are a multiple of;
  the forward's tiles are ``F32_TILE_ROWS``."""
  check_width(channels, cp)
  lib = _library()
  if cp is None:
    vals = [ctypes.c_int() for _ in range(4)]
    err = lib.wn_layer_f32_schedule(channels, batch, t, int(last),
                                    *[ctypes.byref(v) for v in vals])
  else:
    vals = [ctypes.c_int() for _ in range(6)]
    err = lib.wn_layer_shard_f32_schedule(channels, cp, batch, t, int(last),
                                          *[ctypes.byref(v) for v in vals])
  if err != 0:
    raise RuntimeError(f"the f32 schedule of (C={channels}, C'={cp}) "
                       f"failed: cudaError {err}")
  sms, per_sm, blocks, rows_per_block, *tile = (v.value for v in vals)
  grid = {"sms": sms, "blocks_per_sm": per_sm, "blocks": blocks,
          "rows_per_block": rows_per_block}
  if tile:
    grid.update(tile_rows=tile[0], quantum=tile[1])
  tile_rows = grid.get("tile_rows", F32_TILE_ROWS)
  return {**grid, "tiles_per_block": -(-rows_per_block // tile_rows),
          "waves": blocks / (sms * per_sm)}


# The bf16 backward's kernels (``csrc/wn_layer_bwd.cu``), by their index in
# its C interface; the whole layer launches "prep" first, then the other
# four in this order; a rank's backward has no "prep". ``last`` picks the
# variant of "rows" and "prep".
BWD_KERNELS = ("rows", "dx", "weights", "reduce", "prep")
SHARD_BWD_KERNELS = BWD_KERNELS[:4]


def bwd_kernel_info(kernel: str, last: bool = False,
                    channels: int = 256) -> dict:
  """:func:`kernel_info` for one kernel of ``BWD_KERNELS`` of the whole
  layer's bf16 backward at width ``channels``."""
  check_width(channels)
  return _info(_library().wn_layer_bwd_kernel_info, channels, channels,
               BWD_KERNELS.index(kernel), int(last))


def shard_bwd_kernel_info(kernel: str, channels: int, cp: int,
                          last: bool = False) -> dict:
  """:func:`kernel_info` for one kernel of ``SHARD_BWD_KERNELS`` of the
  bf16 shard backward at the pair (``channels``, ``cp``)."""
  check_width(channels, cp)
  return _info(_library().wn_layer_bwd_kernel_info, channels, cp,
               SHARD_BWD_KERNELS.index(kernel), int(last))


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
  """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor on
  ``device`` holding ``shape`` (any view of it: [2, C] for [2C] and so on,
  with the leading dims of [B, T, ...] tensors kept)."""
  if t.device != device:
    raise ValueError(f"{name}: on {t.device}, expected {device}")
  if t.dtype != dtype:
    raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
  numel = 1
  for n in shape:
    numel *= n
  lead = tuple(shape[:2]) if len(shape) == 3 else ()
  if t.numel() != numel or tuple(t.shape[:len(lead)]) != lead:
    raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name}: must be contiguous")
  if t.data_ptr() % 16:
    raise ValueError(f"{name}: must be 16-byte aligned")


def wn_layer_fused(x: torch.Tensor, cond: torch.Tensor, w_in: torch.Tensor,
                   b_in: torch.Tensor, w_rs: torch.Tensor, b_rs: torch.Tensor,
                   dilation: int, valid_t: ValidT = None,
                   skip_acc: Optional[torch.Tensor] = None,
                   compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
  """One fused WN layer; same contract as :func:`wn_layer_plain`.

  CPU tensors run :func:`wn_layer_plain`. CUDA tensors launch the kernel,
  which takes: x f32 [B, T, C] with C in ``kernel_widths()`` (another
  width raises, naming them); cond, w_in, w_rs in
  ``compute_dtype`` (f32 when None); b_in, b_rs and skip_acc f32; valid_t
  None or an int32 [B] CUDA tensor. Anything else raises.
  """
  global LAUNCHES
  if x.device.type == "cpu":
    return wn_layer_plain(x, cond, w_in, b_in, w_rs, b_rs, dilation,
                          valid_t=valid_t, skip_acc=skip_acc,
                          compute_dtype=compute_dtype)
  if x.device.type != "cuda":
    raise ValueError(f"unsupported device {x.device}")
  dev = x.device
  if x.dim() != 3:
    raise ValueError(f"x: expected [B, T, C], got {tuple(x.shape)}")
  batch, t, c = x.shape
  check_width(c)
  last = w_rs.numel() == c * c
  n_rs = c if last else 2 * c
  wdt = compute_dtype or torch.float32
  if wdt not in (torch.float32, torch.bfloat16):
    raise ValueError(f"unsupported compute dtype {wdt}")
  _check("x", x, torch.float32, (batch, t, c), dev)
  _check("cond", cond, wdt, (batch, t, 2 * c), dev)
  _check("w_in", w_in, wdt, (3 * c, 2 * c), dev)
  _check("b_in", b_in, torch.float32, (2 * c,), dev)
  _check("w_rs", w_rs, wdt, (c * n_rs,), dev)
  _check("b_rs", b_rs, torch.float32, (n_rs,), dev)
  if valid_t is not None:
    if not isinstance(valid_t, torch.Tensor):
      raise ValueError("valid_t must be an int32 [B] tensor on the card")
    _check("valid_t", valid_t, torch.int32, (batch,), dev)
  if skip_acc is not None:
    _check("skip_acc", skip_acc, torch.float32, (batch, t, c), dev)
    skip = skip_acc
  else:
    skip = torch.empty((batch, t, c), dtype=torch.float32, device=dev)
  x_out = torch.empty_like(x)
  # C = 512: the acts, and in bf16 the rounded x (wide_scratch)
  scratch = (torch.empty(wide_scratch(batch, t, c, wdt == torch.bfloat16)[
      "bytes"], dtype=torch.uint8, device=dev) if c == WIDE_C else None)

  lib = _library()
  with torch.cuda.device(dev):  # the launcher reads the current device
    err = lib.wn_layer_forward(
        x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
        w_rs.data_ptr(), b_rs.data_ptr(),
        valid_t.data_ptr() if valid_t is not None else None,
        x_out.data_ptr(), skip.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        int(skip_acc is not None), batch, t, c, int(dilation),
        int(wdt == torch.bfloat16), int(last),
        torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"wn_layer kernel launch failed: cudaError {err}")
  LAUNCHES += 1
  return x_out, skip


def wn_layer_shard_plain(x: torch.Tensor, cond_s: torch.Tensor,
                         w_in_s: torch.Tensor, b_in_s: torch.Tensor,
                         w_rs_s: torch.Tensor, dilation: int,
                         compute_dtype=None) -> torch.Tensor:
  """One model rank's share of a layer in plain torch ops: the CPU path and
  the shard kernel's yardstick.

  x [B, T, C] f32 (every input channel); cond_s [B, T, 2C'] (bias added);
  w_in_s [3, C, 2C'] (or [3, C, 2, C']), tanh columns of the rank's C'
  channels then sigmoid columns; b_in_s [2C']; w_rs_s [C', 2C] or [C', C]
  (last layer). Returns the f32 partial ``acts @ w_rs_s`` [B, T, 2C] (or
  [B, T, C]): no ``b_rs``, no residual, no row mask; summed over the ranks
  it is the full layer's ``rs - b_rs``. ``compute_dtype=torch.bfloat16``
  rounds the same operands as :func:`wn_layer_plain` does. f64 inputs stay
  f64 (``torch.autograd.gradcheck``).
  """
  batch, t, c = x.shape
  cp = b_in_s.numel() // 2
  wide = _wide(x)

  def operand(v):
    return v.to(wide) if compute_dtype is None else v.to(compute_dtype).float()

  xm = operand(x)
  w_in_s = operand(w_in_s).reshape(3, c, 2 * cp)
  pre = None
  for tap in range(3):
    term = torch.matmul(shift_time(xm, (tap - 1) * dilation), w_in_s[tap])
    pre = term if pre is None else pre + term
  gates = (pre + b_in_s.reshape(-1).to(wide)
           + operand(cond_s).reshape(batch, t, 2 * cp))
  acts = operand(torch.tanh(gates[..., :cp]) * torch.sigmoid(gates[..., cp:]))
  return torch.matmul(acts, operand(w_rs_s).reshape(cp, -1))


def _wide(x: torch.Tensor) -> torch.dtype:
  """The plain shard's working dtype: f64 for f64 x, else f32."""
  return torch.float64 if x.dtype == torch.float64 else torch.float32


def wn_layer_shard(x: torch.Tensor, cond_s: torch.Tensor,
                   w_in_s: torch.Tensor, b_in_s: torch.Tensor,
                   w_rs_s: torch.Tensor, dilation: int,
                   compute_dtype=None) -> torch.Tensor:
  """One model rank's share of a layer; same contract as
  :func:`wn_layer_shard_plain`.

  CPU tensors run :func:`wn_layer_shard_plain`. CUDA tensors launch the
  shard kernel (``csrc/wn_layer_shard.cu``: FFMA in f32, tensor cores in
  bf16; in bf16 at C = 512 the C = 512 layer's three wgmma kernels of
  ``csrc/wn_layer.cu`` at gate width C'), which takes: x f32 [B, T, C];
  cond_s, w_in_s, w_rs_s in ``compute_dtype`` (f32 when None); b_in_s
  f32; (C, C') one of ``shard_pairs()``. Anything else raises; it never
  falls back to the plain version. ``SHARD_LAUNCHES`` counts the calls
  that launched.
  """
  global SHARD_LAUNCHES
  if x.device.type == "cpu":
    return wn_layer_shard_plain(x, cond_s, w_in_s, b_in_s, w_rs_s, dilation,
                                compute_dtype=compute_dtype)
  if x.device.type != "cuda":
    raise ValueError(f"unsupported device {x.device}")
  dev = x.device
  if x.dim() != 3:
    raise ValueError(f"x: expected [B, T, C], got {tuple(x.shape)}")
  batch, t, c = x.shape
  cp = b_in_s.numel() // 2
  check_width(c, cp)
  last = w_rs_s.numel() == cp * c
  n_rs = c if last else 2 * c
  wdt = compute_dtype or torch.float32
  if wdt not in (torch.float32, torch.bfloat16):
    raise ValueError(f"unsupported compute dtype {wdt}")
  _check("x", x, torch.float32, (batch, t, c), dev)
  _check("cond_s", cond_s, wdt, (batch, t, 2 * cp), dev)
  _check("w_in_s", w_in_s, wdt, (3 * c, 2 * cp), dev)
  _check("b_in_s", b_in_s, torch.float32, (2 * cp,), dev)
  _check("w_rs_s", w_rs_s, wdt, (cp * n_rs,), dev)
  out = torch.empty((batch, t, n_rs), dtype=torch.float32, device=dev)
  lib = _library()
  with torch.cuda.device(dev):  # the launch goes to this device's stream
    stream = torch.cuda.current_stream(dev).cuda_stream
    if c == WIDE_C and wdt == torch.bfloat16:
      # the C = 512 layer's three kernels at gate width C'
      # (csrc/wn_layer.cu), with their operand and acts (wide_scratch)
      scratch = torch.empty(wide_scratch(batch, t, cp, True)["bytes"],
                            dtype=torch.uint8, device=dev)
      err = lib.wn_layer_shard_wide_forward(
          x.data_ptr(), cond_s.data_ptr(), w_in_s.data_ptr(),
          b_in_s.data_ptr(), w_rs_s.data_ptr(), out.data_ptr(),
          scratch.data_ptr(), batch, t, cp, int(dilation), int(last), stream)
    else:
      err = lib.wn_layer_shard_forward(
          x.data_ptr(), cond_s.data_ptr(), w_in_s.data_ptr(),
          b_in_s.data_ptr(), w_rs_s.data_ptr(), out.data_ptr(), batch, t, c,
          cp, int(dilation), int(wdt == torch.bfloat16), int(last), stream)
  if err != 0:
    raise RuntimeError(f"wn_layer shard kernel launch failed: cudaError {err}")
  SHARD_LAUNCHES += 1
  return out


def _row_mask(valid_t: ValidT, t: int,
              device: torch.device) -> Optional[torch.Tensor]:
  """[B, T, 1] bool, True at rows < valid_t (None when nothing is masked)."""
  if valid_t is None:
    return None
  valid = torch.as_tensor(valid_t, device=device).reshape(-1, 1)
  return (torch.arange(t, device=device)[None, :] < valid)[..., None]


def wn_layer_backward(saved: Tuple[torch.Tensor, ...],
                      dx_next: Optional[torch.Tensor],
                      dskip: Optional[torch.Tensor], dilation: int,
                      valid_t: ValidT = None, compute_dtype=None
                      ) -> Tuple[torch.Tensor, ...]:
  """Gradients of (x, cond, w_in, b_in, w_rs, b_rs) of one layer, from the
  saved inputs and the output cotangents (None means zero); the torch-ops
  counterpart of ``_wn_layer_trainable_bwd``, and the yardstick of the bf16
  backward kernel (:func:`wn_layer_backward_fused`).

  Taps, gates and acts are recomputed in f32 from the inputs, and each
  gradient is cast to its input's dtype and shape. With
  ``compute_dtype=None`` every product runs in f32 on f32 operands.

  With ``compute_dtype=torch.bfloat16`` these are the rounding points (the
  kernel's): the taps of x are rounded to bf16 (as the forward's are), and
  w_in, w_rs are bf16 already; gates accumulate in f32, then b_in and cond
  are added in f32; t_act, s_act and acts stay f32. The product operands
  acts, drs (masked dx_next | dskip, or dskip on the last layer) and dgates
  are each rounded to bf16 where they enter a product, and every product
  accumulates in f32. The gate adjoint is f32; dcond is bf16(dgates), cond's
  dtype. db_in and db_rs sum the f32 dgates and drs, not their roundings;
  dx is the masked dx_next plus the shifted taps' adjoint in f32; dw_in and
  dw_rs are summed in f32, then cast to the weights' dtype. bf16 operands
  are faithful to the JAX package: none of its backward's dots passes
  ``precision=``, and on its chip such an f32 dot runs as one bf16 pass with
  f32 accumulation.
  """
  x, cond, w_in, b_in, w_rs, b_rs = saved
  batch, t, c = x.shape
  last = w_rs.numel() == c * c

  def cotangent(g):
    if g is None:
      return torch.zeros((batch * t, c), dtype=torch.float32, device=x.device)
    return g.to(torch.float32).reshape(-1, c)

  dx_next, dskip = cotangent(dx_next), cotangent(dskip)
  keep = _row_mask(valid_t, t, x.device)
  if keep is not None:
    # the forward zeroes x' rows >= valid_t: no gradient flows back there
    dx_next = torch.where(keep.reshape(-1, 1), dx_next,
                          torch.zeros((), device=x.device))
  drs = dskip if last else torch.cat([dx_next, dskip], dim=-1)  # [R, n_rs]
  grads = _backward(saved[:5], drs, dx_next.reshape(batch, t, c), dilation,
                    compute_dtype)
  return grads + (drs.sum(0).reshape(b_rs.shape).to(b_rs.dtype),)


def _backward(saved: Tuple[torch.Tensor, ...], drs: torch.Tensor,
              dx: Optional[torch.Tensor], dilation: int, compute_dtype
              ) -> Tuple[torch.Tensor, ...]:
  """Gradients of (x, cond, w_in, b_in, w_rs) of a layer holding C' = b_in's
  half of the gate channels (C' = C for the whole layer), given drs [R,
  n_rs], the cotangent of its res/skip product, at the rounding points of
  :func:`wn_layer_backward`; the taps' adjoint is added onto ``dx`` (None:
  onto nothing) in tap order."""
  x, cond, w_in, b_in, w_rs = saved
  batch, t, c = x.shape
  cp = b_in.numel() // 2
  n_rs = w_rs.numel() // cp
  f32 = _wide(x)
  if compute_dtype is None:
    def operand(v):
      return v
  else:
    def operand(v):
      return v.to(compute_dtype).float()
  xm = x.to(f32) if compute_dtype is None else x.to(compute_dtype).float()
  taps = torch.cat([shift_time(xm, (tap - 1) * dilation) for tap in range(3)],
                   dim=-1).reshape(-1, 3 * c)                    # [R, 3C]
  w_in_f = w_in.to(f32).reshape(3 * c, 2 * cp)
  gates = (torch.matmul(taps, w_in_f) + b_in.to(f32).reshape(-1)
           + cond.to(f32).reshape(-1, 2 * cp))                   # [R, 2C']
  t_act = torch.tanh(gates[:, :cp])
  s_act = torch.sigmoid(gates[:, cp:])
  acts = t_act * s_act
  w_rs_f = w_rs.to(f32).reshape(cp, n_rs)
  drs_op = operand(drs)
  dacts = torch.matmul(drs_op, w_rs_f.T)
  dw_rs = torch.matmul(operand(acts).T, drs_op)
  dgates = torch.cat([dacts * s_act * (1.0 - t_act * t_act),
                      dacts * t_act * s_act * (1.0 - s_act)], dim=-1)
  db_in = dgates.sum(0)
  dgates_op = operand(dgates)
  dw_in = torch.matmul(taps.T, dgates_op)
  # adjoint of the 3-tap dilated conv: shift_time's adjoint is shift_time
  # with the negated offset
  g_w = torch.matmul(dgates_op, w_in_f.T).reshape(batch, t, 3 * c)
  for tap in range(3):
    term = shift_time(g_w[..., tap * c:(tap + 1) * c], -(tap - 1) * dilation)
    dx = term if dx is None else dx + term

  def like(g, ref):
    return g.reshape(ref.shape).to(ref.dtype)

  return (like(dx, x), like(dgates, cond), like(dw_in, w_in),
          like(db_in, b_in), like(dw_rs, w_rs))


def wn_layer_backward_fused(saved: Tuple[torch.Tensor, ...],
                            dx_next: Optional[torch.Tensor],
                            dskip: Optional[torch.Tensor], dilation: int,
                            valid_t: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, ...]:
  """:func:`wn_layer_backward` with ``compute_dtype=torch.bfloat16`` on the
  card: the five kernels of ``csrc/wn_layer_bwd.cu`` for the whole layer
  (one call, counted once in ``BWD_LAUNCHES``). Inputs as
  :func:`wn_layer_fused` takes them in bf16 (x, b_in, b_rs f32; cond, w_in,
  w_rs bf16; C in ``kernel_widths()``; valid_t None or an int32 [B] tensor
  on the card); the cotangents f32 [B, T, C] or None (zero, never
  materialised). Anything else raises."""
  global BWD_LAUNCHES
  x, cond, w_in, b_in, w_rs, b_rs = saved
  if x.device.type != "cuda":
    raise ValueError(f"the backward kernel needs CUDA tensors, got {x.device}")
  if x.dim() != 3:
    raise ValueError(f"x: expected [B, T, C], got {tuple(x.shape)}")
  dev = x.device
  batch, t, c = x.shape
  check_width(c)
  last = w_rs.numel() == c * c
  n_rs = c if last else 2 * c
  bf16 = torch.bfloat16
  _check("x", x, torch.float32, (batch, t, c), dev)
  _check("cond", cond, bf16, (batch, t, 2 * c), dev)
  _check("w_in", w_in, bf16, (3 * c, 2 * c), dev)
  _check("b_in", b_in, torch.float32, (2 * c,), dev)
  _check("w_rs", w_rs, bf16, (c * n_rs,), dev)
  _check("b_rs", b_rs, torch.float32, (n_rs,), dev)
  if valid_t is not None:
    if not isinstance(valid_t, torch.Tensor):
      raise ValueError("valid_t must be an int32 [B] tensor on the card")
    _check("valid_t", valid_t, torch.int32, (batch,), dev)
  cots = []
  for name, g in (("dx_next", dx_next), ("dskip", dskip)):
    if g is not None:
      g = g.contiguous()  # autograd may hand an expanded view
      _check(name, g, torch.float32, (batch, t, c), dev)
    cots.append(g)

  def ptr(v):
    return v.data_ptr() if v is not None else None

  lib = _library()
  plan = _bwd_plan(batch, t, c, c, last, dev)
  # each gradient has its input's shape and dtype
  dx, dcond, dw_in, db_in, dw_rs, db_rs = (torch.empty_like(v) for v in saved)
  scratch = torch.empty(plan["bytes"], dtype=torch.uint8, device=dev)
  at = {k: scratch.data_ptr() + off for k, off in plan["offsets"].items()}
  with torch.cuda.device(dev):  # the launcher reads the current device
    err = lib.wn_layer_backward_bf16(
        x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
        w_rs.data_ptr(), ptr(cots[0]), ptr(cots[1]), ptr(valid_t),
        dx.data_ptr(), dcond.data_ptr(), dw_in.data_ptr(), db_in.data_ptr(),
        dw_rs.data_ptr(), db_rs.data_ptr(), at["acts"], at["x_bf"],
        at["g_bf"], at["part_bias"], at["ws"], batch, t, c, int(dilation),
        int(last), plan["n_splits_t"], plan["split_rows"],
        torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"wn_layer backward kernels failed to launch: "
                       f"cudaError {err}")
  BWD_LAUNCHES += 1
  return dx, dcond, dw_in, db_in, dw_rs, db_rs


class WNLayerTrainable(torch.autograd.Function):
  """Forward: :func:`wn_layer_fused` without ``skip_acc``; backward:
  :func:`wn_layer_backward_fused` for bf16 on the card, else
  :func:`wn_layer_backward`. Saves the six inputs, as the JAX custom VJP
  does (nothing of the kernel's intermediates)."""

  @staticmethod
  def forward(ctx, x, cond, w_in, b_in, w_rs, b_rs, dilation, valid_t,
              compute_dtype):
    ctx.set_materialize_grads(False)
    ctx.dilation = dilation
    ctx.valid_t = valid_t
    ctx.compute_dtype = compute_dtype
    ctx.save_for_backward(x, cond, w_in, b_in, w_rs, b_rs)
    return wn_layer_fused(x, cond, w_in, b_in, w_rs, b_rs, dilation,
                          valid_t=valid_t, compute_dtype=compute_dtype)

  @staticmethod
  def backward(ctx, dx_next, dskip):
    saved = ctx.saved_tensors
    if saved[0].device.type == "cuda" and ctx.compute_dtype is not None:
      grads = wn_layer_backward_fused(saved, dx_next, dskip, ctx.dilation,
                                      ctx.valid_t)
    else:
      # CPU tensors, and f32 on the card (parity mode's torch-ops route)
      grads = wn_layer_backward(saved, dx_next, dskip, ctx.dilation,
                                ctx.valid_t, ctx.compute_dtype)
    return grads + (None, None, None)


def wn_layer_trainable(x: torch.Tensor, cond: torch.Tensor,
                       w_in: torch.Tensor, b_in: torch.Tensor,
                       w_rs: torch.Tensor, b_rs: torch.Tensor, dilation: int,
                       valid_t: ValidT = None, compute_dtype=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Differentiable fused WN layer: ``(x', skip)`` as
  :func:`wn_layer_fused` without ``skip_acc``, with gradients for all six
  tensor inputs. On CUDA tensors the forward is the kernel (inputs as
  ``wn_layer_fused`` takes them, or it raises); on CPU tensors the plain
  version. Its plain counterpart is ``torch.autograd`` through
  :func:`wn_layer_plain`."""
  return WNLayerTrainable.apply(x, cond, w_in, b_in, w_rs, b_rs, dilation,
                                valid_t, compute_dtype)


def wn_layer_shard_backward(saved: Tuple[torch.Tensor, ...],
                            g: Optional[torch.Tensor], dilation: int,
                            compute_dtype=None) -> Tuple[torch.Tensor, ...]:
  """Gradients of (x, cond_s, w_in_s, b_in_s, w_rs_s) of one model rank's
  share of a layer (:func:`wn_layer_shard`), from its saved inputs and
  ``g`` [B, T, n_rs], the cotangent of its partial (None means zero): the
  CPU path, the f32 route on the card (the designated parity-mode route, as
  :func:`wn_layer_backward` is for the full layer) and the yardstick of the
  bf16 kernel (:func:`wn_layer_shard_backward_fused`).

  The arithmetic and the rounding points are :func:`wn_layer_backward`'s
  over the rank's C' gate channels, with ``g`` in the place of drs: taps,
  gates and acts recomputed in f32; with ``compute_dtype=torch.bfloat16``
  the taps of x, g, acts and dgates rounded to bf16 where they enter a
  product. dx is the rank's partial, the taps' adjoint over its C'
  channels: the ranks' dx summed, plus the residual's cotangent, is the
  full layer's dx; the ranks' other gradients concatenate to the full
  layer's. b_rs, the residual and the row mask are outside (autograd).
  """
  x, _, _, b_in_s, w_rs_s = saved
  cp = b_in_s.numel() // 2
  n_rs = w_rs_s.numel() // cp
  if g is None:
    g = torch.zeros((*x.shape[:2], n_rs), dtype=_wide(x), device=x.device)
  return _backward(saved, g.to(_wide(x)).reshape(-1, n_rs), None, dilation,
                   compute_dtype)


# K rows of a chunk of the bf16 backward's weights kernel: its row ranges
# are multiples of this.
BWD_CHUNK_ROWS = 64


def bwd_splits(batch: int, t: int, tiles: int, sms: int) -> Tuple[int, int]:
  """``(n_splits_t, split_rows)`` of the bf16 backward's weights kernel
  (the whole layer's and a rank's):
  each of the ``batch`` rows' ``t`` time rows is cut into ``n_splits_t``
  ranges of ``split_rows`` (a multiple of ``BWD_CHUNK_ROWS``; the last
  range short), one block for each of the kernel's ``tiles`` output tiles
  and each range. The cut is the fewest ranges whose blocks fill at least
  one wave of ``sms`` blocks and keep the last wave at least 85% full; else
  (no such cut within 4 waves) the cut with the fullest last wave, at least
  one wave where the rows allow it. More ranges mean more f32 partials for
  the reduce kernel to read."""
  chunks = -(-t // BWD_CHUNK_ROWS)
  best = None
  for want in range(1, chunks + 1):
    split_rows = -(-chunks // want) * BWD_CHUNK_ROWS
    n_splits = -(-t // split_rows)
    if best is not None and n_splits == best[1]:
      continue
    blocks = tiles * batch * n_splits
    waves = -(-blocks // sms)
    if waves > 4 and best is not None:
      break
    fill = blocks / (waves * sms)
    key = (blocks >= sms, fill)
    if best is None or key > best[0]:
      best = (key, n_splits, split_rows)
    if blocks >= sms and fill >= 0.85:
      break
  return best[1], best[2]


def bwd_scratch(batch: int, t: int, c: int, cp: int, last: bool,
                n_splits_t: int, tile_rows: int) -> dict:
  """The bf16 backward's scratch as one allocation, of a rank holding
  ``cp`` gate channels or of the whole layer (``cp == c``): byte
  ``offsets`` (each 256-byte aligned) of the bf16 acts [B*T, C'], x [B*T,
  C] and g [B*T, n_rs] (the weights kernel's operands; the whole layer's g
  is drs), the f32 column sums of each tile of ``tile_rows`` rows [B *
  ceil(T / tile_rows), 2C'] (the whole layer's rows also hold drs's n_rs
  sums) and the weights kernel's f32 partials [B * n_splits_t, 3C * 2C' +
  C' * n_rs], and the total ``bytes``."""
  rows, n_rs = batch * t, c if last else 2 * c
  bias_cols = 2 * cp + (n_rs if cp == c else 0)
  sizes = {"acts": rows * cp * 2, "x_bf": rows * c * 2,
           "g_bf": rows * n_rs * 2,
           "part_bias": batch * -(-t // tile_rows) * bias_cols * 4,
           "ws": batch * n_splits_t * (3 * c * 2 * cp + cp * n_rs) * 4}
  offsets, end = {}, 0
  for name, size in sizes.items():
    offsets[name] = end
    end += -(-size // 256) * 256
  return {"offsets": offsets, "sizes": sizes, "bytes": end}


@functools.lru_cache(maxsize=None)
def _bwd_plan(batch: int, t: int, c: int, cp: int, last: bool,
              dev: torch.device) -> dict:
  """The bf16 backward's launch plan at one shape and card (a rank holding
  ``cp`` gate channels, or the whole layer at ``cp == c``): the weights
  kernel's split and the scratch layout, read from the library once."""
  lib = _library()
  n_splits_t, split_rows = bwd_splits(
      batch, t, lib.wn_layer_bwd_weight_tiles(c, cp, int(last)),
      torch.cuda.get_device_properties(dev).multi_processor_count)
  return {"n_splits_t": n_splits_t, "split_rows": split_rows,
          **bwd_scratch(batch, t, c, cp, last, n_splits_t,
                        lib.wn_layer_bwd_tile_rows(c, cp))}


def wn_layer_shard_backward_fused(saved: Tuple[torch.Tensor, ...],
                                  g: Optional[torch.Tensor], dilation: int
                                  ) -> Tuple[torch.Tensor, ...]:
  """:func:`wn_layer_shard_backward` with ``compute_dtype=torch.bfloat16``
  on the card: the four kernels of ``csrc/wn_layer_bwd.cu`` for a rank (one
  call, counted once in ``SHARD_BWD_LAUNCHES``). Inputs as
  :func:`wn_layer_shard` takes them in bf16 (x, b_in_s f32; cond_s, w_in_s,
  w_rs_s bf16; (C, C') one of ``shard_pairs()``); g f32 [B, T, n_rs] or
  None (zero: every gradient is zero and nothing is launched). Anything
  else raises; it never falls back to the plain version."""
  global SHARD_BWD_LAUNCHES
  x, cond_s, w_in_s, b_in_s, w_rs_s = saved
  if x.device.type != "cuda":
    raise ValueError(f"the shard backward kernel needs CUDA tensors, got "
                     f"{x.device}")
  if x.dim() != 3:
    raise ValueError(f"x: expected [B, T, C], got {tuple(x.shape)}")
  dev = x.device
  batch, t, c = x.shape
  cp = b_in_s.numel() // 2
  check_width(c, cp)
  last = w_rs_s.numel() == cp * c
  n_rs = c if last else 2 * c
  bf16 = torch.bfloat16
  _check("x", x, torch.float32, (batch, t, c), dev)
  _check("cond_s", cond_s, bf16, (batch, t, 2 * cp), dev)
  _check("w_in_s", w_in_s, bf16, (3 * c, 2 * cp), dev)
  _check("b_in_s", b_in_s, torch.float32, (2 * cp,), dev)
  _check("w_rs_s", w_rs_s, bf16, (cp * n_rs,), dev)
  if g is None:
    return tuple(torch.zeros_like(v) for v in saved)
  g = g.contiguous()  # autograd may hand an expanded view
  _check("g", g, torch.float32, (batch, t, n_rs), dev)

  lib = _library()
  plan = _bwd_plan(batch, t, c, cp, last, dev)
  # each gradient has its input's shape and dtype
  dx, dcond, dw_in, db_in, dw_rs = (torch.empty_like(v) for v in saved)
  scratch = torch.empty(plan["bytes"], dtype=torch.uint8, device=dev)
  at = {k: scratch.data_ptr() + off for k, off in plan["offsets"].items()}
  with torch.cuda.device(dev):  # the launcher reads the current device
    err = lib.wn_layer_shard_backward_bf16(
        x.data_ptr(), cond_s.data_ptr(), w_in_s.data_ptr(),
        b_in_s.data_ptr(), w_rs_s.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dcond.data_ptr(), dw_in.data_ptr(), db_in.data_ptr(),
        dw_rs.data_ptr(), at["acts"], at["x_bf"], at["g_bf"],
        at["part_bias"], at["ws"], batch, t, c, cp, int(dilation),
        int(last), plan["n_splits_t"], plan["split_rows"],
        torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"wn_layer shard backward kernels failed to launch: "
                       f"cudaError {err}")
  SHARD_BWD_LAUNCHES += 1
  return dx, dcond, dw_in, db_in, dw_rs


class WNLayerShardTrainable(torch.autograd.Function):
  """Forward: :func:`wn_layer_shard` (the shard kernel on the card); backward:
  :func:`wn_layer_shard_backward_fused` for bf16 on the card, else
  :func:`wn_layer_shard_backward`. Saves the five inputs, as
  :class:`WNLayerTrainable` does (nothing of the kernel's intermediates)."""

  @staticmethod
  def forward(ctx, x, cond_s, w_in_s, b_in_s, w_rs_s, dilation,
              compute_dtype):
    ctx.set_materialize_grads(False)
    ctx.dilation = dilation
    ctx.compute_dtype = compute_dtype
    ctx.save_for_backward(x, cond_s, w_in_s, b_in_s, w_rs_s)
    return wn_layer_shard(x, cond_s, w_in_s, b_in_s, w_rs_s, dilation,
                          compute_dtype=compute_dtype)

  @staticmethod
  def backward(ctx, g):
    saved = ctx.saved_tensors
    if saved[0].device.type == "cuda" and ctx.compute_dtype is not None:
      grads = wn_layer_shard_backward_fused(saved, g, ctx.dilation)
    else:
      # CPU tensors, and f32 on the card (parity mode's torch-ops route)
      grads = wn_layer_shard_backward(saved, g, ctx.dilation,
                                      ctx.compute_dtype)
    return grads + (None, None)


def wn_layer_shard_trainable(x: torch.Tensor, cond_s: torch.Tensor,
                             w_in_s: torch.Tensor, b_in_s: torch.Tensor,
                             w_rs_s: torch.Tensor, dilation: int,
                             compute_dtype=None) -> torch.Tensor:
  """Differentiable :func:`wn_layer_shard`: the rank's f32 partial res/skip
  sum, with gradients for its five tensor inputs. On CUDA tensors the
  forward is the shard kernel (inputs as ``wn_layer_shard`` takes them, or
  it raises); on CPU tensors the plain version. Its plain counterpart is
  ``torch.autograd`` through :func:`wn_layer_shard_plain`."""
  return WNLayerShardTrainable.apply(x, cond_s, w_in_s, b_in_s, w_rs_s,
                                     dilation, compute_dtype)
