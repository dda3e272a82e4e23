"""Fused WN layer, forward and bf16 backward: CUDA kernel wrappers and
their plain PyTorch versions.

Replaces ``waveglow_tpu/kernels/wn_layer.py::_wn_layer_fused`` (Pallas, TPU).
The forward kernels are in ``csrc/wn_layer.cu``: f32 FMAs on the CUDA cores
for f32 (parity) and wgmma on the tensor cores for bf16; the bf16
backward's kernels (the whole layer's and a model rank's) are in
``csrc/wn_layer_bwd.cu``; the shape-generic forward and bf16 backward in
``csrc/wn_layer_any.cu`` and ``csrc/wn_layer_bwd_any.cu``. The note at the
top of each says what bounds it
on an H100 and how it is laid out. All are compiled with nvcc for
``sm_90a`` at first use into one library in ``waveglow_tpu_torch/build/``
(keyed by a hash of the sources and flags) and bound with ctypes.

Math of one layer, channels-last (``C`` channels, ``K`` taps, dilation
``d``):

  pre  = sum_k x[t + (k - K//2)*d] @ w_in[k]         (zero "same" padding)
  acts = tanh(pre[:C] + b_in[:C] + cond[:C]) * sigmoid(pre[C:] + b_in[C:] + cond[C:])
  rs   = acts @ w_rs + b_rs
  x'   = x + rs[:C], skip = rs[C:]                   (last layer: x' = x, skip = rs)

x' rows ``>= valid_t[b]`` are zeroed (bucket padding), and with ``skip_acc``
the skip is added into that buffer in place and the buffer returned.

``wn_layer_fused`` runs the plain version for CPU tensors and a kernel for
CUDA tensors; on a CUDA tensor it launches a kernel or raises, never falls
back. At K = 3 and the widths ``kernel_widths()`` (C = 128, 256, 512) it
launches the specialised kernels of ``csrc/wn_layer.cu`` (counted in
``LAUNCHES``), at every other shape (any even C up to ``ANY_MAX_C``, any
odd K) the shape-generic kernel of ``csrc/wn_layer_any.cu`` through
``wn_layer_any`` (counted in ``ANY_LAUNCHES``); ``specialised`` is the
choice. The specialised backward and the shard kernels are built for the
widths ``kernel_widths()`` at K = 3 (the shard kernels for
``shard_pairs()``), and ``check_width`` refuses any other when they are
called directly; the shape-generic backward takes every shape the generic
forward takes.

``wn_layer_shard`` is one model rank's share of a layer on a ``model``
mesh axis: the same conv, gate and res/skip product over C' = C / model
of the gate channels, giving the rank's partial res/skip sum without b_rs
and the residual, which ``models.wn.wn_forward_tp`` adds after the ranks'
reduce. At K = 3 and a pair of ``shard_pairs()`` (``shard_specialised``)
it launches the specialised rank kernels (in f32 ``csrc/wn_layer_shard.cu``;
in bf16 the wgmma kernels of ``csrc/wn_layer.cu``: below C = 512 the one
rank kernel, at (256, 128) and C = 512 a gate and a res/skip kernel, at
C = 512 after its rounding of x; counted in ``SHARD_LAUNCHES``), at every
other shape (any odd K, any even C up to ``ANY_MAX_C``, any C') the
shape-generic kernels of ``csrc/wn_layer_any.cu`` in partial mode through
``wn_layer_shard_any`` (counted in ``ANY_SHARD_LAUNCHES``). It runs
``wn_layer_shard_plain`` for CPU tensors and a kernel, or raises, for
CUDA tensors.

``wn_layer_trainable`` is the differentiable layer (counterpart of the JAX
package's custom-VJP ``wn_layer_trainable``): its forward is
``wn_layer_fused`` without ``skip_acc`` (the kernel on the card), so it
takes every shape the forward takes: any odd K and any even C up to
``ANY_MAX_C``. Its backward computes the closed-form adjoints of
``_wn_layer_trainable_bwd`` over K taps, recomputing taps, gates and acts:
in bf16 on the card by the five kernels of ``csrc/wn_layer_bwd.cu``
(``wn_layer_backward_fused``, counted in ``BWD_LAUNCHES``) where
``specialised`` holds and by the six of ``csrc/wn_layer_bwd_any.cu``
(``wn_layer_backward_any``, counted in ``ANY_BWD_LAUNCHES``) at every other
shape; in f32 on the card by torch ops (``wn_layer_backward``, the
designated parity-mode route: its products must stay true f32), and on the
CPU by ``wn_layer_backward``, which is also both bf16 backwards' yardstick.

``wn_layer_shard_trainable`` is the differentiable shard, for training on a
``model`` mesh axis: its forward is ``wn_layer_shard``; its backward gives
the rank's adjoints and its partial dx, in bf16 on the card by the four
kernels of ``csrc/wn_layer_bwd.cu`` (``wn_layer_shard_backward_fused``,
counted in ``SHARD_BWD_LAUNCHES``) where ``shard_specialised`` holds and
by those of ``csrc/wn_layer_bwd_any.cu`` at the rank's gate width
(``wn_layer_shard_backward_any``, counted in ``ANY_SHARD_BWD_LAUNCHES``)
at every other shape, otherwise by torch ops (``wn_layer_shard_backward``,
the CPU path, the f32 route and both kernels' yardstick).
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
ANY_LAUNCHES = 0
ANY_BWD_LAUNCHES = 0
ANY_SHARD_LAUNCHES = 0
ANY_SHARD_BWD_LAUNCHES = 0

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "wn_layer.cu", CSRC / "wn_layer_bwd.cu",
           CSRC / "wn_layer_shard.cu", CSRC / "wn_layer_any.cu",
           CSRC / "wn_layer_bwd_any.cu")
# Included by the sources: the f32 ring and tile (the forward, the shard
# and, for its cp.async helpers and its shared-memory opt-in, both backwards
# and the shape-generic forward) and the wgmma helpers (the bf16 kernels of
# both forwards and both backwards).
HEADERS = (CSRC / "f32_ring.cuh", CSRC / "sm90_wgmma.cuh")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The widths C every kernel is built for (the template instances of
# csrc/*.cu: the forward, the bf16 backward and the shard kernel).
_WIDTHS = (128, 256, 512)
# The shard kernel holds C' = C / model gate channels, model in this set.
SHARD_MODELS = (2, 4, 8)
# The widest C of the shape-generic forward (csrc/wn_layer_any.cu), by
# compute dtype: the caps of its first design, whose 64-row tile kept the
# acts of every channel in shared memory. The present design has no such
# cap; the caps keep the set of widths the generic path is held to.
ANY_MAX_C = {torch.float32: 704, torch.bfloat16: 1280}

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


def specialised(c: int, k: int) -> bool:
  """Whether a forward at width ``c`` and ``k`` taps runs the specialised
  kernels of ``csrc/wn_layer.cu`` (K = 3 at a width of ``kernel_widths()``)
  rather than the shape-generic one of ``csrc/wn_layer_any.cu``."""
  return k == 3 and c in _WIDTHS


def shard_specialised(c: int, cp: int, k: int) -> bool:
  """Whether a model rank's share at width ``c``, ``cp`` gate channels and
  ``k`` taps runs the specialised rank kernels (``csrc/wn_layer_shard.cu``
  in f32, the wgmma kernels of ``csrc/wn_layer.cu`` in bf16, the rank's
  backward of ``csrc/wn_layer_bwd.cu``: K = 3 at a pair of
  ``shard_pairs()``) rather than the shape-generic ones of
  ``csrc/wn_layer_any.cu`` and ``csrc/wn_layer_bwd_any.cu``."""
  return k == 3 and (c, cp) in shard_pairs()


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

  Shapes: x [B, T, C] f32; cond [B, T, 2, C] or [B, T, 2C]; w_in [K, C, 2C]
  (or [K, C, 2, C], or [K*C, 2C]) for any odd K; b_in [2C]; w_rs [C, 2C] /
  [C, 2, C] or [C, C] (last layer); b_rs to match. ``valid_t``: None, an
  int, or a [B] tensor.

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
  pre = dilated_conv(xm, operand(w_in).reshape(-1, c, 2 * c),
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
    "wn_layer_shard_forward": [_P] * 6 + [_I] * 6 + [_P],
    "wn_layer_shard_wide_forward": [_P] * 7 + [_I] * 6 + [_P],
    "wn_layer_shard_backward_bf16": [_P] * 16 + [_I] * 8 + [_P],
    "wn_layer_kernel_info": [_I] * 3 + [_IP] * 4,
    "wn_layer_f32_rest_kernel_info": [_I] + [_IP] * 4,
    "wn_layer_shard_kernel_info": [_I] * 3 + [_IP] * 4,
    "wn_layer_bwd_kernel_info": [_I] * 4 + [_IP] * 4,
    "wn_layer_wide_kernel_info": [_I] * 4 + [_IP] * 4,
    "wn_layer_bwd_tile_rows": [_I] * 2,
    "wn_layer_bwd_weight_tiles": [_I] * 3,
    "wn_layer_f32_schedule": [_I] * 4 + [_IP] * 4,
    "wn_layer_shard_f32_schedule": [_I] * 5 + [_IP] * 6,
    "wn_layer_wide_schedule": [_I] * 5 + [_IP] * 4,
    "wn_layer_any_forward": [_P] * 13 + [_I] * 8 + [_P],
    "wn_layer_any_kernel_info": [_I] * 4 + [_IP] * 4,
    "wn_layer_any_schedule": [_I] * 5 + [_IP] * 3,
    "wn_layer_any_max_channels": [_I],
    "wn_layer_backward_any_bf16": [_P] * 22 + [_I] * 9 + [_P],
    "wn_layer_bwd_any_kernel_info": [_I] * 2 + [_IP] * 4,
    "wn_layer_bwd_any_weight_tiles": [_I] * 3,
    "wn_layer_shard_any_forward": [_P] * 10 + [_I] * 8 + [_P],
    "wn_layer_shard_any_schedule": [_I] * 6 + [_IP] * 4,
    "wn_layer_shard_any_kernel_info": [_I] * 5 + [_IP] * 4,
    "wn_layer_shard_backward_any_bf16": [_P] * 19 + [_I] * 10 + [_P],
    "wn_layer_shard_bwd_any_kernel_info": [_I] * 3 + [_IP] * 4,
    "wn_layer_shard_bwd_any_weight_tiles": [_I] * 4,
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


# The shape-generic forward's kernels (``csrc/wn_layer_any.cu``), by their
# index in its C interface: "layer" ends a call (the f32 layer kernel, or
# the bf16 res/skip kernel; ``last`` picks its variant), "gate" is the bf16
# gate kernel and "prep" writes the padded operands (:func:`any_kernels`).
ANY_FWD_KERNELS = ("layer", "gate", "prep")


def any_kernel_info(bf16: bool, last: bool, channels: int = 256,
                    kernel: str = "layer", cp: Optional[int] = None) -> dict:
  """:func:`kernel_info` for one kernel of ``ANY_FWD_KERNELS`` of the
  shape-generic forward (``csrc/wn_layer_any.cu``) in one mode (f32 has no
  "gate"), its dynamic shared bytes those its launcher passes at width
  ``channels``; with ``cp``, of a model rank's call holding ``cp`` gate
  channels (its "layer" kernel the partial-mode instance)."""
  if cp is None:
    return _info(_library().wn_layer_any_kernel_info, channels, int(bf16),
                 ANY_FWD_KERNELS.index(kernel), int(last))
  return _info(_library().wn_layer_shard_any_kernel_info, channels, cp,
               int(bf16), ANY_FWD_KERNELS.index(kernel), int(last))


# The shape-generic bf16 backward's kernels (``csrc/wn_layer_bwd_any.cu``),
# by their index in its C interface; a call launches them in the order of
# :func:`any_bwd_kernels`.
ANY_BWD_KERNELS = ("rows", "dx", "weights", "reduce", "prep", "pad")


def any_bwd_kernel_info(kernel: str, channels: int = 256,
                        cp: Optional[int] = None) -> dict:
  """:func:`kernel_info` for one kernel of ``ANY_BWD_KERNELS`` of the
  shape-generic bf16 backward, its dynamic shared bytes those its launcher
  passes at width ``channels`` (the dx and weights kernels' rings hold
  tiles :func:`any_bwd_dx_tile` and :func:`any_bwd_n_tile` wide); with
  ``cp``, at a model rank's ``cp`` gate channels (the same kernels)."""
  if cp is None:
    return _info(_library().wn_layer_bwd_any_kernel_info,
                 ANY_BWD_KERNELS.index(kernel), channels)
  return _info(_library().wn_layer_shard_bwd_any_kernel_info,
               ANY_BWD_KERNELS.index(kernel), channels, cp)


def f32_rest_kernel_info(last: bool) -> dict:
  """:func:`kernel_info` for the f32 forward's rest kernel at C = 512
  (``wn_layer_kernel_f32_rest``; ``kernel_info(512, False, last)`` is its
  tiles kernel's)."""
  return _info(_library().wn_layer_f32_rest_kernel_info, int(last))


def shard_kernel_info(channels: int, cp: int, bf16: bool,
                      last: bool) -> dict:
  """:func:`kernel_info` for the shard kernel at width ``channels``
  holding ``cp`` gate channels (a pair of :func:`shard_pairs`); in bf16,
  the kernel of :func:`wide_kernel_info` that ends a rank's call (the rank
  kernel, or the res/skip kernel)."""
  check_width(channels, cp)
  if bf16:
    return wide_kernel_info(wide_kernels(channels, cp)[-1], last, cp,
                            channels)
  return _info(_library().wn_layer_shard_kernel_info, channels, cp,
               int(last))


# The bf16 gate and res/skip kernels of ``csrc/wn_layer.cu``: the C = 512
# layer's and every model rank's share in bf16. ``WIDE_KERNELS`` by their
# index in its C interface: at C = 512 x is rounded once ("round"), then
# the gate and res/skip kernels run; a rank below C = 512 runs one kernel
# ("rank": the gate on the f32 x, then the res/skip product from its
# shared memory) where w_rs_s fits there (:func:`rank_fused`), else (at
# (256, 128)) the gate kernel on the f32 x and the res/skip kernel.
# WIDE_TILE_ROWS: the rows of a unit of these kernels (Wide::kTile).
WIDE_C = 512
WIDE_KERNELS = ("gate", "rs", "round", "rank")
WIDE_TILE_ROWS = 128


def rank_fused(channels: int, cp: int) -> bool:
  """Whether a rank's bf16 share at (``channels``, ``cp``) is the one rank
  kernel: below C = 512, where w_rs_s [C', 2C] bf16 fits beside the gate's
  two A slots, four weight stages and two f32 A chunks in the 232,448
  bytes of shared memory a block may use (RankGate::kFused)."""
  if channels == WIDE_C:
    return False
  gate = 2 * 128 * 64 * 2 + 4 * 64 * max(64, 2 * cp) * 2 + 2 * 128 * 64 * 4
  return gate + cp * 2 * channels * 2 <= 232_448


def wide_kernels(channels: int = WIDE_C,
                 cp: Optional[int] = None) -> Tuple[str, ...]:
  """The kernels of ``WIDE_KERNELS`` a bf16 call at width ``channels`` (a
  rank's with ``cp`` gate channels) launches, in order."""
  if channels == WIDE_C:
    return ("round", "gate", "rs")
  return ("rank",) if rank_fused(channels, cp) else ("gate", "rs")


def _check_wide(channels: int, cp: int) -> None:
  check_width(channels, None if cp == channels == WIDE_C else cp)


def wide_kernel_info(kernel: str, last: bool = False, cp: int = WIDE_C,
                     channels: int = WIDE_C) -> dict:
  """:func:`kernel_info` for one of :func:`wide_kernels` of the bf16
  forward at width ``channels``: the C = 512 layer's (``cp`` = 512) or a
  rank's holding ``cp`` gate channels (``last`` picks the res/skip
  kernel's variant)."""
  _check_wide(channels, cp)
  if kernel not in wide_kernels(channels, cp):
    raise ValueError(f"no {kernel} kernel at C = {channels}, C' = {cp}")
  return _info(_library().wn_layer_wide_kernel_info, channels,
               WIDE_KERNELS.index(kernel), cp, int(last))


def wide_passes(last: bool, cp: int = WIDE_C,
                channels: int = WIDE_C) -> dict:
  """Passes of a 128-row tile in each kernel at width ``channels`` and
  ``cp`` gate channels (the C = 512 layer's 512 or a rank's C'): the gate
  kernel's of min(cp, 128) channels each (one pass of every channel
  below C = 512), the res/skip kernel's of 256 of the n_rs columns each;
  the rank kernel's one (its res/skip passes run inside a unit)."""
  if rank_fused(channels, cp):
    return {"rank": 1}
  return {"gate": cp // min(cp, 128),
          "rs": (channels if last else 2 * channels) // 256}


def wide_grid(batch: int, t: int, last: bool, slots: int,
              cp: int = WIDE_C, channels: int = WIDE_C) -> dict:
  """The grid of the bf16 gate and res/skip kernels (width
  ``channels``, ``cp`` gate channels: the C = 512 layer's 512 or a rank's
  C') for ``batch`` x ``t`` rows on a device holding ``slots`` of their
  blocks at once, as the launcher picks it: the flat B*T rows in
  ``tiles`` of WIDE_TILE_ROWS (the last one short); a unit is (tile,
  pass), unit u = tile * passes + pass; each kernel runs min(units, slots)
  blocks, block b taking units b, b + blocks, ... (:func:`block_units`)."""
  tiles = -(-batch * t // WIDE_TILE_ROWS)
  out = {"slots": slots, "tiles": tiles}
  for kernel, passes in wide_passes(last, cp, channels).items():
    out[f"{kernel}_units"] = tiles * passes
    out[f"{kernel}_blocks"] = min(tiles * passes, slots)
  return out


def block_units(units: int, blocks: int, block: int) -> range:
  """The units block ``block`` of a persistent gate or res/skip kernel
  walks."""
  return range(block, units, blocks)


def wide_schedule(batch: int, t: int, last: bool = False, cp: int = WIDE_C,
                  channels: int = WIDE_C) -> dict:
  """:func:`wide_grid` as the loaded library computes it on the current
  card (slots from the occupancy API)."""
  _check_wide(channels, cp)
  vals = [ctypes.c_int() for _ in range(4)]
  err = _library().wn_layer_wide_schedule(channels, cp, batch, t, int(last),
                                          *[ctypes.byref(v) for v in vals])
  if err != 0:
    raise RuntimeError(f"the schedule of (C={channels}, C'={cp}) failed: "
                       f"cudaError {err}")
  slots, tiles, *blocks = (v.value for v in vals)
  products = [k for k in wide_kernels(channels, cp) if k != "round"]
  return {"slots": slots, "tiles": tiles,
          **{f"{k}_blocks": n for k, n in zip(products, blocks)}}


def wide_scratch(batch: int, t: int, cp: int, bf16: bool,
                 channels: int = WIDE_C) -> dict:
  """The scratch of the bf16 gate and res/skip kernels, or of the f32
  layer at C = 512, as one allocation: in bf16 at C = 512 (the layer's,
  ``cp`` = 512, or a rank's holding ``cp`` gate channels) the rounded x
  [B*T, C] and the acts [B*T, cp], bf16, the gate kernel's operand and
  output; in bf16 at (256, 128) the acts alone (its gate kernel reads the
  f32 x); none where the rank kernel runs (its acts stay in shared
  memory); in f32 (the C = 512 layer's) the acts [B*T, C] f32, which the
  kernel writes and reads back. Byte ``offsets`` (each 256-byte aligned),
  ``sizes`` and the total ``bytes``."""
  rows = batch * t
  if not bf16:
    sizes = {"acts": rows * WIDE_C * 4}
  elif channels == WIDE_C:
    sizes = {"x_bf": rows * WIDE_C * 2, "acts": rows * cp * 2}
  elif rank_fused(channels, cp):
    sizes = {}
  else:
    sizes = {"acts": rows * cp * 2}
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


def _layer_operands(x, cond, w_in, b_in, w_rs, b_rs, valid_t, skip_acc,
                    wdt, k: int):
  """Check a forward kernel's operands on x's card (x [B, T, C] f32; cond,
  w_in [K, C, 2C] and w_rs in ``wdt``; b_in, b_rs and skip_acc f32; valid_t
  None or an int32 [B] tensor) and allocate its outputs: ``(last, x_out,
  skip)``, skip being skip_acc when given."""
  batch, t, c = x.shape
  dev = x.device
  last = w_rs.numel() == c * c
  n_rs = c if last else 2 * c
  _check("x", x, torch.float32, (batch, t, c), dev)
  _check("cond", cond, wdt, (batch, t, 2 * c), dev)
  _check("w_in", w_in, wdt, (k * c, 2 * c), dev)
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
  return last, torch.empty_like(x), skip


def wn_layer_fused(x: torch.Tensor, cond: torch.Tensor, w_in: torch.Tensor,
                   b_in: torch.Tensor, w_rs: torch.Tensor, b_rs: torch.Tensor,
                   dilation: int, valid_t: ValidT = None,
                   skip_acc: Optional[torch.Tensor] = None,
                   compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
  """One fused WN layer; same contract as :func:`wn_layer_plain`.

  CPU tensors run :func:`wn_layer_plain`. CUDA tensors launch a kernel: at
  K = 3 and C in ``kernel_widths()`` (:func:`specialised`) those of
  ``csrc/wn_layer.cu``, which take x f32 [B, T, C]; cond, w_in, w_rs in
  ``compute_dtype`` (f32 when None); b_in, b_rs and skip_acc f32; valid_t
  None or an int32 [B] CUDA tensor. Every other shape goes to
  :func:`wn_layer_any`. Anything else raises.
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
  if not specialised(c, w_in.numel() // max(2 * c * c, 1)):
    return wn_layer_any(x, cond, w_in, b_in, w_rs, b_rs, dilation,
                        valid_t=valid_t, skip_acc=skip_acc,
                        compute_dtype=compute_dtype)
  wdt = compute_dtype or torch.float32
  if wdt not in (torch.float32, torch.bfloat16):
    raise ValueError(f"unsupported compute dtype {wdt}")
  last, x_out, skip = _layer_operands(x, cond, w_in, b_in, w_rs, b_rs,
                                      valid_t, skip_acc, wdt, 3)
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


# The shape-generic forward's plan (csrc/wn_layer_any.cu): operands padded
# to Cp = C rounded up to ANY_PAD channels (and a model rank's C' gate
# channels to Gp, likewise); channels in passes of ANY_PASS
# (the last one ANY_PAD when Cp is not a multiple of ANY_PASS): the gate's
# over Gp, the res/skip product's over Cp; the bf16
# gate and res/skip kernels' units of ANY_TILE_ROWS flat rows (AnyWide::
# kTile); the f32 layer kernel's tiles of ANY_F32_TILE_ROWS (AnyF32::
# kTileRows; twice that, in passes of ANY_PAD channels, at Gp = ANY_PAD:
# any_f32_two)
# over a block's share of the rows, a multiple of F32_ROW_QUANTUM, the
# whole layer's last tile of ANY_REST_ROWS rows or fewer running its passes
# at once where there are ANY_REST_PASSES of them (AnyF32::kRestRows,
# kRestPasses).
ANY_PAD = 64
ANY_PASS = 128
ANY_TILE_ROWS = 128
ANY_F32_TILE_ROWS = 96
ANY_REST_ROWS = 16
ANY_REST_PASSES = 2


def any_cp(c: int) -> int:
  """Cp: the width ``c`` rounded up to ANY_PAD channels."""
  return -(-c // ANY_PAD) * ANY_PAD


def any_passes(c: int) -> int:
  """Passes of ANY_PASS channels (the last one ANY_PAD when Cp is not a
  multiple of ANY_PASS) of both generic designs at width ``c``."""
  return -(-any_cp(c) // ANY_PASS)


def any_f32_two(c: int, cp: Optional[int] = None) -> bool:
  """Whether an f32 generic call at width ``c`` (a rank's: ``cp`` gate
  channels) runs the instance with tiles of twice ANY_F32_TILE_ROWS and
  passes of ANY_PAD channels: at Gp = ANY_PAD (Gp: C' or C rounded up)."""
  return any_cp(c if cp is None else cp) == ANY_PAD


def any_f32_tiles(n: int, c: int, cp: Optional[int] = None) -> list:
  """The tiles of an f32 generic block holding ``n`` flat rows at width
  ``c`` (a rank's ``cp`` gate channels; None: the whole layer), as (first
  row, rows, passes run at once), in the order they run: tiles of
  ANY_F32_TILE_ROWS (twice that where :func:`any_f32_two`; the last one
  short), their passes one after another, except, in the whole layer, a
  last tile of ANY_REST_ROWS rows or fewer at ANY_REST_PASSES passes,
  which runs them at once (a "rest tile"; a rank's gate and res/skip
  product have two passes each only at C' = C, and its instance takes
  none)."""
  size = ANY_F32_TILE_ROWS * (2 if any_f32_two(c, cp) else 1)
  passes = any_passes(c)
  out = [(r, min(size, n - r), 1) for r in range(0, n, size)]
  first, rows, _ = out[-1]
  if cp is None and passes == ANY_REST_PASSES and rows <= ANY_REST_ROWS:
    out[-1] = (first, rows, passes)
  return out


def any_kernels(bf16: bool, c: int, cp: Optional[int] = None
                ) -> Tuple[str, ...]:
  """The kernels a generic forward call at width ``c`` (a rank's ``cp``
  gate channels) launches, in order: "prep" (in bf16 always: x rounded
  once; in f32 where C or C' is not a multiple of ANY_PAD), then "gate"
  and "layer" (the res/skip kernel) in bf16, or "layer" (the whole layer,
  or the rank's share) in f32."""
  if bf16:
    return ("prep", "gate", "layer")
  pad = c % ANY_PAD or (cp is not None and cp % ANY_PAD)
  return (("prep",) if pad else ()) + ("layer",)


def any_grid(batch: int, t: int, c: int, bf16: bool, slots: int,
             cp: Optional[int] = None) -> dict:
  """The grid of a generic forward call for ``batch`` x ``t`` rows at width
  ``c`` (a rank's: ``cp`` gate channels) on a device holding ``slots``
  blocks of its product kernels at once, as the launcher picks it. bf16:
  the flat B*T rows in ``tiles`` of ANY_TILE_ROWS (the last one short); a
  unit is (tile, pass), unit u = tile * passes + pass; the res/skip kernel
  runs min(units, slots) blocks over its ``passes`` of the Cp output
  channels, the gate kernel min(gate_units, slots) over its
  ``gate_passes`` of the Gp gate channels, block b taking units b, b +
  blocks, ... (:func:`block_units`). f32: one wave, block b taking the flat
  rows [b * rows_per_block, (b + 1) * rows_per_block), an equal share
  rounded up to F32_ROW_QUANTUM, in the tiles of :func:`any_f32_tiles`;
  where :func:`any_f32_two` its passes are ANY_PAD channels."""
  gate = c if cp is None else cp
  rows, passes, gate_passes = batch * t, any_passes(c), any_passes(gate)
  if not bf16 and any_f32_two(c, cp):
    passes = any_cp(c) // ANY_PAD
  out = {"slots": slots, "cp": any_cp(c), "passes": passes}
  if cp is not None:
    out.update(gp=any_cp(cp), gate_passes=gate_passes)
  if bf16:
    tiles = -(-rows // ANY_TILE_ROWS)
    if cp is not None:
      out.update(gate_units=tiles * gate_passes,
                 gate_blocks=min(tiles * gate_passes, slots))
    return {**out, "tiles": tiles, "units": tiles * passes,
            "blocks": min(tiles * passes, slots),
            "rows_per_block": ANY_TILE_ROWS}
  per = -(-(-(-rows // slots)) // F32_ROW_QUANTUM) * F32_ROW_QUANTUM
  tiles = any_f32_tiles(per, c, cp)
  return {**out, "rows_per_block": per, "blocks": -(-rows // per),
          "tiles_per_block": len(tiles), "rest_tile": tiles[-1][2] > 1}


def any_schedule(batch: int, t: int, c: int, bf16: bool,
                 last: bool = False, cp: Optional[int] = None) -> dict:
  """:func:`any_grid`'s slots, blocks and rows a block as the loaded
  library computes them on the current card (slots from the occupancy
  API); with ``cp``, a rank's, its gate kernel's blocks apart."""
  lib = _library()
  if cp is None:
    vals = [ctypes.c_int() for _ in range(3)]
    err = lib.wn_layer_any_schedule(c, batch, t, int(bf16), int(last),
                                    *[ctypes.byref(v) for v in vals])
  else:
    vals = [ctypes.c_int() for _ in range(4)]
    err = lib.wn_layer_shard_any_schedule(c, cp, batch, t, int(bf16),
                                          int(last),
                                          *[ctypes.byref(v) for v in vals])
  if err != 0:
    raise RuntimeError(f"the generic schedule of C={c}, C'={cp} failed: "
                       f"cudaError {err}")
  if cp is None:
    slots, blocks, per = (v.value for v in vals)
    return {"slots": slots, "blocks": blocks, "rows_per_block": per}
  slots, gate_blocks, blocks, per = (v.value for v in vals)
  return {"slots": slots, "gate_blocks": gate_blocks, "blocks": blocks,
          "rows_per_block": per}


def any_scratch(batch: int, t: int, c: int, k: int, last: bool,
                bf16: bool, cp: Optional[int] = None) -> dict:
  """The generic forward's scratch as one allocation, in the compute
  dtype's element (bf16, or f32): the acts [R, Gp] (Gp: a rank's ``cp``
  gate channels, else C, rounded up to ANY_PAD), which the gate writes
  and the res/skip product reads; x_p [R, Cp] (the taps' operand: x
  rounded in bf16, x padded in f32) in bf16 or where C is not a multiple
  of ANY_PAD; and where C or C' is not, the padded weights w_in_p [K*Cp,
  2Gp] and w_rs_p [Gp, n_rsp] (n_rsp = 2Cp, the last layer's Cp). Byte
  ``offsets`` (each 256-byte aligned), ``sizes`` and the total ``bytes``.
  R = B*T."""
  gate = c if cp is None else cp
  cpad, gp, rows, size = any_cp(c), any_cp(gate), batch * t, 2 if bf16 else 4
  pad_x = cpad != c
  sizes = {"acts": rows * gp * size}
  if bf16 or pad_x:
    sizes["x_p"] = rows * cpad * size
  if pad_x or gp != gate:
    sizes["w_in_p"] = k * cpad * 2 * gp * size
    sizes["w_rs_p"] = gp * (cpad if last else 2 * cpad) * size
  offsets, end = {}, 0
  for name, n in sizes.items():
    offsets[name] = end
    end += -(-n // 256) * 256
  return {"offsets": offsets, "sizes": sizes, "bytes": end}


def wn_layer_any(x: torch.Tensor, cond: torch.Tensor, w_in: torch.Tensor,
                 b_in: torch.Tensor, w_rs: torch.Tensor, b_rs: torch.Tensor,
                 dilation: int, valid_t: ValidT = None,
                 skip_acc: Optional[torch.Tensor] = None,
                 compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
  """One fused WN layer at any shape, through the shape-generic kernels of
  ``csrc/wn_layer_any.cu``; same contract as :func:`wn_layer_plain`.

  CPU tensors run :func:`wn_layer_plain`. CUDA tensors launch the kernels
  of :func:`any_kernels`, which take: x f32 [B, T, C] with C even and at
  most ``ANY_MAX_C[compute dtype]``; w_in [K, C, 2C] (any view of it) for
  any odd K; cond, w_in, w_rs in ``compute_dtype`` (f32 when None); b_in,
  b_rs and skip_acc f32; valid_t None or an int32 [B] CUDA tensor. Anything
  else raises. The scratch (:func:`any_scratch`) is allocated here.
  :func:`wn_layer_fused` calls it at every shape but the specialised
  kernels'; called directly it runs those too. ``ANY_LAUNCHES`` counts its
  calls, one a call whatever the kernels it launches.
  """
  global ANY_LAUNCHES
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
  wdt = compute_dtype or torch.float32
  if wdt not in ANY_MAX_C:
    raise ValueError(f"unsupported compute dtype {wdt}")
  if c % 2 or not 0 < c <= ANY_MAX_C[wdt]:
    raise ValueError(f"the shape-generic kernel takes an even C of at most "
                     f"{ANY_MAX_C[wdt]} in {wdt}, got C = {c}")
  k = w_in.numel() // (2 * c * c)
  if k % 2 != 1 or w_in.numel() != k * c * 2 * c:
    raise ValueError(f"w_in: {tuple(w_in.shape)} is not [K, {c}, {2 * c}] "
                     "for an odd K")
  if dilation < 0:
    raise ValueError(f"dilation must be >= 0, got {dilation}")
  if batch * t >= 2 ** 31:
    raise ValueError(f"the kernels take B*T < 2**31 rows, got {batch * t}")
  last, x_out, skip = _layer_operands(x, cond, w_in, b_in, w_rs, b_rs,
                                      valid_t, skip_acc, wdt, k)
  bf16 = wdt == torch.bfloat16
  plan = any_scratch(batch, t, c, k, last, bf16)
  scratch = torch.empty(plan["bytes"], dtype=torch.uint8, device=dev)

  def part(name):
    off = plan["offsets"].get(name)
    return None if off is None else scratch.data_ptr() + off

  lib = _library()
  with torch.cuda.device(dev):  # the launcher reads the current device
    err = lib.wn_layer_any_forward(
        x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
        w_rs.data_ptr(), b_rs.data_ptr(),
        valid_t.data_ptr() if valid_t is not None else None,
        x_out.data_ptr(), skip.data_ptr(), part("acts"), part("x_p"),
        part("w_in_p"), part("w_rs_p"), int(skip_acc is not None), batch,
        t, c, k, int(dilation), int(bf16), int(last),
        torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"wn_layer_any kernel launch failed: cudaError {err}")
  ANY_LAUNCHES += 1
  return x_out, skip


def wn_layer_shard_plain(x: torch.Tensor, cond_s: torch.Tensor,
                         w_in_s: torch.Tensor, b_in_s: torch.Tensor,
                         w_rs_s: torch.Tensor, dilation: int,
                         compute_dtype=None) -> torch.Tensor:
  """One model rank's share of a layer in plain torch ops: the CPU path and
  the shard kernel's yardstick.

  x [B, T, C] f32 (every input channel); cond_s [B, T, 2C'] (bias added);
  w_in_s [K, C, 2C'] (or [K, C, 2, C'], or [K*C, 2C']) for any odd K, tanh
  columns of the rank's C' channels then sigmoid columns; b_in_s [2C'];
  w_rs_s [C', 2C] or [C', C] (last layer). Returns the f32 partial ``acts
  @ w_rs_s`` [B, T, 2C] (or [B, T, C]): no ``b_rs``, no residual, no row
  mask; summed over the ranks it is the full layer's ``rs - b_rs``.
  ``compute_dtype=torch.bfloat16`` rounds the same operands as
  :func:`wn_layer_plain` does. f64 inputs stay f64
  (``torch.autograd.gradcheck``).
  """
  batch, t, c = x.shape
  cp = b_in_s.numel() // 2
  k = w_in_s.numel() // (c * 2 * cp)
  wide = _wide(x)

  def operand(v):
    return v.to(wide) if compute_dtype is None else v.to(compute_dtype).float()

  xm = operand(x)
  w_in_s = operand(w_in_s).reshape(k, c, 2 * cp)
  pre = None
  for tap in range(k):
    term = torch.matmul(shift_time(xm, (tap - k // 2) * dilation),
                        w_in_s[tap])
    pre = term if pre is None else pre + term
  gates = (pre + b_in_s.reshape(-1).to(wide)
           + operand(cond_s).reshape(batch, t, 2 * cp))
  acts = operand(torch.tanh(gates[..., :cp]) * torch.sigmoid(gates[..., cp:]))
  return torch.matmul(acts, operand(w_rs_s).reshape(cp, -1))


def _wide(x: torch.Tensor) -> torch.dtype:
  """The plain shard's working dtype: f64 for f64 x, else f32."""
  return torch.float64 if x.dtype == torch.float64 else torch.float32


def _shard_shape(x: torch.Tensor, w_in_s: torch.Tensor,
                 b_in_s: torch.Tensor) -> Tuple[int, int, int]:
  """(C, C', K) of a rank's share on the card: x [B, T, C] on a CUDA
  device, b_in_s [2C'], w_in_s [K*C, 2C'] (any view); raises on any
  other device or rank of x."""
  if x.device.type != "cuda":
    raise ValueError(f"the shard kernels need CUDA tensors, got {x.device}")
  if x.dim() != 3:
    raise ValueError(f"x: expected [B, T, C], got {tuple(x.shape)}")
  c, cp = x.shape[-1], b_in_s.numel() // 2
  return c, cp, w_in_s.numel() // max(c * 2 * cp, 1)


def _check_shard_any(c: int, cp: int, k: int, w_in_s: torch.Tensor,
                     wdt) -> None:
  """Raise ``ValueError`` unless the generic rank kernels take the shape:
  C even and at most ``ANY_MAX_C[wdt]``, 1 <= C' <= C, w_in_s [K*C, 2C']
  for an odd K."""
  if wdt not in ANY_MAX_C:
    raise ValueError(f"unsupported compute dtype {wdt}")
  if c % 2 or not 0 < c <= ANY_MAX_C[wdt]:
    raise ValueError(f"the shape-generic rank kernels take an even C of at "
                     f"most {ANY_MAX_C[wdt]} in {wdt}, got C = {c}")
  if not 0 < cp <= c:
    raise ValueError(f"a rank holds 1 to C = {c} gate channels, got "
                     f"C' = {cp}")
  if k % 2 != 1 or w_in_s.numel() != k * c * 2 * cp:
    raise ValueError(f"w_in_s: {tuple(w_in_s.shape)} is not [K*{c}, "
                     f"{2 * cp}] for an odd K")


def wn_layer_shard(x: torch.Tensor, cond_s: torch.Tensor,
                   w_in_s: torch.Tensor, b_in_s: torch.Tensor,
                   w_rs_s: torch.Tensor, dilation: int,
                   compute_dtype=None) -> torch.Tensor:
  """One model rank's share of a layer; same contract as
  :func:`wn_layer_shard_plain`.

  CPU tensors run :func:`wn_layer_shard_plain`. CUDA tensors launch a
  kernel: at K = 3 and a pair of ``shard_pairs()``
  (:func:`shard_specialised`) the specialised shard kernels (in f32 the
  FFMA kernel of ``csrc/wn_layer_shard.cu``; in bf16 the wgmma kernels of
  ``csrc/wn_layer.cu`` at gate width C', :func:`wide_kernels`), which
  take: x f32 [B, T, C]; cond_s, w_in_s [3*C, 2C'], w_rs_s in
  ``compute_dtype`` (f32 when None); b_in_s f32. Every other shape goes
  to :func:`wn_layer_shard_any`. Anything else raises; it never falls
  back to the plain version. ``SHARD_LAUNCHES`` counts the calls that
  launched the specialised kernels.
  """
  global SHARD_LAUNCHES
  if x.device.type == "cpu":
    return wn_layer_shard_plain(x, cond_s, w_in_s, b_in_s, w_rs_s, dilation,
                                compute_dtype=compute_dtype)
  c, cp, k = _shard_shape(x, w_in_s, b_in_s)
  if not shard_specialised(c, cp, k):
    return wn_layer_shard_any(x, cond_s, w_in_s, b_in_s, w_rs_s, dilation,
                              compute_dtype=compute_dtype)
  dev = x.device
  batch, t, _ = x.shape
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
    if wdt == torch.bfloat16:
      # csrc/wn_layer.cu: the rank kernel, or the gate and res/skip
      # kernels at gate width C' with the acts between them (at C = 512
      # after the rounding of x; wide_scratch)
      nbytes = wide_scratch(batch, t, cp, True, c)["bytes"]
      scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
                 if nbytes else None)
      err = lib.wn_layer_shard_wide_forward(
          x.data_ptr(), cond_s.data_ptr(), w_in_s.data_ptr(),
          b_in_s.data_ptr(), w_rs_s.data_ptr(), out.data_ptr(),
          scratch.data_ptr() if scratch is not None else None, batch, t, c,
          cp, int(dilation), int(last), stream)
    else:
      err = lib.wn_layer_shard_forward(
          x.data_ptr(), cond_s.data_ptr(), w_in_s.data_ptr(),
          b_in_s.data_ptr(), w_rs_s.data_ptr(), out.data_ptr(), batch, t, c,
          cp, int(dilation), int(last), stream)
  if err != 0:
    raise RuntimeError(f"wn_layer shard kernel launch failed: cudaError {err}")
  SHARD_LAUNCHES += 1
  return out


def wn_layer_shard_any(x: torch.Tensor, cond_s: torch.Tensor,
                       w_in_s: torch.Tensor, b_in_s: torch.Tensor,
                       w_rs_s: torch.Tensor, dilation: int,
                       compute_dtype=None) -> torch.Tensor:
  """One model rank's share of a layer at any shape, through the
  shape-generic kernels of ``csrc/wn_layer_any.cu`` in partial mode; same
  contract as :func:`wn_layer_shard_plain`.

  CPU tensors run :func:`wn_layer_shard_plain`. CUDA tensors launch the
  kernels of :func:`any_kernels` at the rank's gate width, which take: x
  f32 [B, T, C] with C even and at most ``ANY_MAX_C[compute dtype]``;
  1 <= C' <= C gate channels; w_in_s [K*C, 2C'] (any view) for any odd K;
  cond_s, w_in_s, w_rs_s in ``compute_dtype`` (f32 when None); b_in_s f32.
  Anything else raises; it never falls back to the plain version. The
  scratch (:func:`any_scratch` at ``cp``) is allocated here.
  :func:`wn_layer_shard` calls it at every shape but the specialised
  kernels'; called directly it runs those too. ``ANY_SHARD_LAUNCHES``
  counts its calls, one a call whatever the kernels it launches.
  """
  global ANY_SHARD_LAUNCHES
  if x.device.type == "cpu":
    return wn_layer_shard_plain(x, cond_s, w_in_s, b_in_s, w_rs_s, dilation,
                                compute_dtype=compute_dtype)
  c, cp, k = _shard_shape(x, w_in_s, b_in_s)
  wdt = compute_dtype or torch.float32
  _check_shard_any(c, cp, k, w_in_s, wdt)
  if dilation < 0:
    raise ValueError(f"dilation must be >= 0, got {dilation}")
  batch, t, _ = x.shape
  if batch * t >= 2 ** 31:
    raise ValueError(f"the kernels take B*T < 2**31 rows, got {batch * t}")
  dev = x.device
  last = w_rs_s.numel() == cp * c
  n_rs = c if last else 2 * c
  _check("x", x, torch.float32, (batch, t, c), dev)
  _check("cond_s", cond_s, wdt, (batch, t, 2 * cp), dev)
  _check("w_in_s", w_in_s, wdt, (k * c, 2 * cp), dev)
  _check("b_in_s", b_in_s, torch.float32, (2 * cp,), dev)
  _check("w_rs_s", w_rs_s, wdt, (cp * n_rs,), dev)
  bf16 = wdt == torch.bfloat16
  out = torch.empty((batch, t, n_rs), dtype=torch.float32, device=dev)
  plan = any_scratch(batch, t, c, k, last, bf16, cp)
  scratch = torch.empty(plan["bytes"], dtype=torch.uint8, device=dev)

  def part(name):
    off = plan["offsets"].get(name)
    return None if off is None else scratch.data_ptr() + off

  lib = _library()
  with torch.cuda.device(dev):  # the launcher reads the current device
    err = lib.wn_layer_shard_any_forward(
        x.data_ptr(), cond_s.data_ptr(), w_in_s.data_ptr(),
        b_in_s.data_ptr(), w_rs_s.data_ptr(), out.data_ptr(), part("acts"),
        part("x_p"), part("w_in_p"), part("w_rs_p"), batch, t, c, cp, k,
        int(dilation), int(bf16), int(last),
        torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"wn_layer_shard_any kernel launch failed: "
                       f"cudaError {err}")
  ANY_SHARD_LAUNCHES += 1
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
  """Gradients of (x, cond, w_in, b_in, w_rs, b_rs) of one layer (w_in [K,
  C, 2C] for any odd K, or any view of it), from the saved inputs and the
  output cotangents (None means zero); the torch-ops counterpart of
  ``_wn_layer_trainable_bwd``, and the yardstick of the bf16 backward
  kernels (:func:`wn_layer_backward_fused`, :func:`wn_layer_backward_any`).

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
  :func:`wn_layer_backward`; K, the taps, is w_in's [K*C, 2C'] rows over C;
  the taps' adjoint is added onto ``dx`` (None: onto nothing) in tap
  order."""
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
  k_taps = w_in.numel() // (c * 2 * cp)
  half = k_taps // 2
  xm = x.to(f32) if compute_dtype is None else x.to(compute_dtype).float()
  taps = torch.cat([shift_time(xm, (tap - half) * dilation)
                    for tap in range(k_taps)],
                   dim=-1).reshape(-1, k_taps * c)               # [R, KC]
  w_in_f = w_in.to(f32).reshape(k_taps * c, 2 * cp)
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
  # adjoint of the K-tap dilated conv: shift_time's adjoint is shift_time
  # with the negated offset
  g_w = torch.matmul(dgates_op, w_in_f.T).reshape(batch, t, k_taps * c)
  for tap in range(k_taps):
    term = shift_time(g_w[..., tap * c:(tap + 1) * c],
                      -(tap - half) * dilation)
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
  x, cond, w_in, b_in, w_rs, _ = saved
  _check_bwd_x(x)
  check_width(x.shape[-1])
  last, cots = _bwd_operands(saved, dx_next, dskip, valid_t, 3)
  dev = x.device
  batch, t, c = x.shape
  lib = _library()
  plan = _bwd_plan(batch, t, c, c, last, dev)
  # each gradient has its input's shape and dtype
  dx, dcond, dw_in, db_in, dw_rs, db_rs = (torch.empty_like(v) for v in saved)
  scratch = torch.empty(plan["bytes"], dtype=torch.uint8, device=dev)
  at = {k: scratch.data_ptr() + off for k, off in plan["offsets"].items()}
  with torch.cuda.device(dev):  # the launcher reads the current device
    err = lib.wn_layer_backward_bf16(
        x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
        w_rs.data_ptr(), _ptr(cots[0]), _ptr(cots[1]), _ptr(valid_t),
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


def _ptr(v: Optional[torch.Tensor]):
  return v.data_ptr() if v is not None else None


def _check_bwd_x(x: torch.Tensor) -> None:
  """Raise unless x, a whole-layer backward's first saved input, is a
  [B, T, C] CUDA tensor."""
  if x.device.type != "cuda":
    raise ValueError(f"the backward kernel needs CUDA tensors, got {x.device}")
  if x.dim() != 3:
    raise ValueError(f"x: expected [B, T, C], got {tuple(x.shape)}")


def _bwd_operands(saved: Tuple[torch.Tensor, ...],
                  dx_next: Optional[torch.Tensor],
                  dskip: Optional[torch.Tensor], valid_t, k: int):
  """Check a whole-layer bf16 backward's operands on x's card (x, b_in,
  b_rs f32; cond, w_in [K*C, 2C] at ``k`` taps, w_rs bf16; valid_t None or
  an int32 [B] tensor; the cotangents f32 [B, T, C] or None): ``(last,
  [dx_next, dskip])``, each cotangent contiguous."""
  x, cond, w_in, b_in, w_rs, b_rs = saved
  dev = x.device
  batch, t, c = x.shape
  last = w_rs.numel() == c * c
  n_rs = c if last else 2 * c
  bf16 = torch.bfloat16
  _check("x", x, torch.float32, (batch, t, c), dev)
  _check("cond", cond, bf16, (batch, t, 2 * c), dev)
  _check("w_in", w_in, bf16, (k * c, 2 * c), dev)
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
  return last, cots


# Time rows of a tile of the shape-generic backward's prep, rows and dx
# kernels, and M of a weights tile (kTile in csrc/wn_layer_bwd_any.cu); the
# channels of a rows kernel's pass (kPass): Cp / ANY_BWD_PASS passes a tile.
ANY_BWD_TILE_ROWS = 128
ANY_BWD_PASS = 64


def any_bwd_kernels(c: int, cp: Optional[int] = None) -> Tuple[str, ...]:
  """The kernels a generic backward call at width ``c`` (a rank's: ``cp``
  gate channels) launches, in order: "pad" where C or C' is not a
  multiple of ANY_PAD (elsewhere the weights and dcond are read as they
  lie), then "prep", "rows", "dx", "weights", "reduce"."""
  pad = c % ANY_PAD or (cp is not None and cp % ANY_PAD)
  return (("pad",) if pad else ()) + (
      "prep", "rows", "dx", "weights", "reduce")


def any_bwd_n_tile(c: int) -> int:
  """N of the generic backward's weights tiles at width ``c``: the widest
  of 256, 192, 128 and 64 that divides Cp (n_tile in
  csrc/wn_layer_bwd_any.cu)."""
  cp = any_cp(c)
  return next(n for n in (256, 192, 128, 64) if cp % n == 0)


def any_bwd_dx_tile(c: int) -> int:
  """N of the generic backward's dx tiles at width ``c``: the widest of
  192, 128 and 64 that divides Cp (dx_tile in csrc/wn_layer_bwd_any.cu)."""
  cp = any_cp(c)
  return next(n for n in (192, 128, 64) if cp % n == 0)


def any_bwd_weight_tiles(c: int, k: int, last: bool,
                         cp: Optional[int] = None) -> int:
  """The output tiles of the generic backward's weights kernel, as the
  library's ``wn_layer_bwd_any_weight_tiles`` (a rank's:
  ``wn_layer_shard_bwd_any_weight_tiles``) counts them: dw_in_p [K*Cp,
  2Gp] in tiles of ANY_BWD_TILE_ROWS rows (the last one short where K*Cp
  is an odd number of 64s) x :func:`any_bwd_n_tile` (of Gp) columns, then
  dw_rs_p^T [n_rsp, Gp] likewise (n_rsp = 2Cp, the last layer's Cp; Gp a
  rank's ``cp`` gate channels, else C, rounded up to ANY_PAD)."""
  cpad = any_cp(c)
  gp = any_cp(c if cp is None else cp)
  n = any_bwd_n_tile(gp)
  n_rsp = cpad if last else 2 * cpad
  m = ANY_BWD_TILE_ROWS
  return -(-k * cpad // m) * (2 * gp // n) + -(-n_rsp // m) * (gp // n)


def any_bwd_splits(batch: int, t: int, tiles: int,
                   sms: int) -> Tuple[int, int, int]:
  """``(split_batches, n_splits_t, split_rows)`` of the generic backward's
  weights kernel: its ranges are runs of ``split_batches`` whole batch rows
  (``n_splits_t`` = 1, ``split_rows`` T rounded up to BWD_CHUNK_ROWS) or,
  at ``split_batches`` = 1, each batch row cut into ``n_splits_t`` ranges of
  ``split_rows`` rows (:func:`_row_cuts`), one block for each of the
  kernel's ``tiles`` output tiles and each range, and one slot of f32
  partials a range. :func:`_fill_waves` picks among them, the runs of whole
  batch rows first; where no run of several whole batch rows fills a wave,
  the cut is :func:`bwd_splits`' own."""
  whole = -(-t // BWD_CHUNK_ROWS) * BWD_CHUNK_ROWS
  runs = sorted({-(-batch // g) for g in range(1, batch + 1)}, reverse=True)
  cuts = [(-(-batch // per), (per, 1, whole)) for per in runs]
  cuts += [(batch * n, (1, n, rows)) for n, rows in _row_cuts(t)[1:]]
  return _fill_waves(cuts, tiles, sms)


def any_bwd_ranges(batch: int, split_batches: int, n_splits_t: int) -> int:
  """The weights kernel's ranges, and so the workspace's slots, of a cut."""
  return -(-batch // split_batches) * n_splits_t


def any_bwd_scratch(batch: int, t: int, c: int, k: int, last: bool,
                    ranges: int, cp: Optional[int] = None) -> dict:
  """The shape-generic backward's scratch as one allocation: byte
  ``offsets`` (each 256-byte aligned), ``sizes`` and the total ``bytes`` of
  its operands in layouts padded to Cp = C rounded up to 64 channels and
  Gp (a rank's ``cp`` gate channels, else C) likewise, zero past C and C':
  bf16 x_p [R, Cp], g_p (drs) [R, n_rsp] and acts_p [R, Gp]; the f32
  column sums of each 128-row tile, part_bias [B*tiles, 2Gp + n_rsp]
  (dgates', then drs'); the weights kernel's f32 partials ws [ranges,
  K*Cp*2Gp + Gp*n_rsp], a slot a range of its cut (:func:`any_bwd_splits`);
  where C or C' is not a multiple of 64 the padded w_in_p [K*Cp, 2Gp] and
  w_rs_p [Gp, n_rsp], and where C' is not the dgates dg_p [R, 2Gp]
  (elsewhere the kernels read w_in, w_rs and dcond as they lie). R = B*T;
  n_rsp = 2Cp, the last layer's Cp."""
  gate = c if cp is None else cp
  cpad, gp = any_cp(c), any_cp(gate)
  n_rsp = cpad if last else 2 * cpad
  rows = batch * t
  tiles = batch * -(-t // ANY_BWD_TILE_ROWS)
  sizes = {"x_p": rows * cpad * 2, "g_p": rows * n_rsp * 2,
           "acts_p": rows * gp * 2, "part_bias": tiles * (2 * gp + n_rsp) * 4,
           "ws": ranges * (k * cpad * 2 * gp + gp * n_rsp) * 4}
  if cpad != c or gp != gate:
    sizes.update(w_in_p=k * cpad * 2 * gp * 2, w_rs_p=gp * n_rsp * 2)
  if gp != gate:
    sizes.update(dg_p=rows * 2 * gp * 2)
  offsets, end = {}, 0
  for name, size in sizes.items():
    offsets[name] = end
    end += -(-size // 256) * 256
  return {"offsets": offsets, "sizes": sizes, "bytes": end}


@functools.lru_cache(maxsize=None)
def _any_bwd_plan(batch: int, t: int, c: int, k: int, last: bool,
                  dev: torch.device, cp: Optional[int] = None) -> dict:
  """The shape-generic backward's launch plan at one shape and card (a
  rank's at ``cp`` gate channels): the weights kernel's cut
  (:func:`any_bwd_splits` over its output tiles, read from the library)
  and the scratch layout."""
  lib = _library()
  tiles = (lib.wn_layer_bwd_any_weight_tiles(c, k, int(last)) if cp is None
           else lib.wn_layer_shard_bwd_any_weight_tiles(c, cp, k, int(last)))
  split_batches, n_splits_t, split_rows = any_bwd_splits(
      batch, t, tiles,
      torch.cuda.get_device_properties(dev).multi_processor_count)
  ranges = any_bwd_ranges(batch, split_batches, n_splits_t)
  return {"split_batches": split_batches, "n_splits_t": n_splits_t,
          "split_rows": split_rows, "ranges": ranges,
          **any_bwd_scratch(batch, t, c, k, last, ranges, cp)}


def wn_layer_backward_any(saved: Tuple[torch.Tensor, ...],
                          dx_next: Optional[torch.Tensor],
                          dskip: Optional[torch.Tensor], dilation: int,
                          valid_t: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, ...]:
  """:func:`wn_layer_backward` with ``compute_dtype=torch.bfloat16`` on the
  card at any shape, through the kernels of ``csrc/wn_layer_bwd_any.cu``
  (:func:`any_bwd_kernels`; one call, counted once in
  ``ANY_BWD_LAUNCHES``). Inputs as :func:`wn_layer_any` takes them in bf16
  (x, b_in, b_rs f32; cond, w_in [K, C, 2C] or any view of it, w_rs bf16;
  C even and at most ``ANY_MAX_C[torch.bfloat16]``, K odd; valid_t None or
  an int32 [B] tensor on the card); the
  cotangents f32 [B, T, C] or None (zero, never materialised). Anything
  else raises; it never falls back to the plain version.
  :class:`WNLayerTrainable` calls it at every shape but the specialised
  kernels' (:func:`specialised`); called directly it runs those too."""
  global ANY_BWD_LAUNCHES
  x, cond, w_in, b_in, w_rs, _ = saved
  _check_bwd_x(x)
  dev = x.device
  batch, t, c = x.shape
  cap = ANY_MAX_C[torch.bfloat16]
  if c % 2 or not 0 < c <= cap:
    raise ValueError(f"the shape-generic backward takes an even C of at "
                     f"most {cap} (the generic forward's cap in bf16), got "
                     f"C = {c}")
  k = w_in.numel() // (2 * c * c)
  if k % 2 != 1 or w_in.numel() != k * c * 2 * c:
    raise ValueError(f"w_in: {tuple(w_in.shape)} is not [K, {c}, {2 * c}] "
                     "for an odd K")
  if dilation < 0:
    raise ValueError(f"dilation must be >= 0, got {dilation}")
  if batch > 65535:
    raise ValueError(f"the kernels' grids take B <= 65535, got {batch}")
  last, cots = _bwd_operands(saved, dx_next, dskip, valid_t, k)
  lib = _library()
  plan = _any_bwd_plan(batch, t, c, k, last, dev)
  # each gradient has its input's shape and dtype
  dx, dcond, dw_in, db_in, dw_rs, db_rs = (torch.empty_like(v) for v in saved)
  scratch = torch.empty(plan["bytes"], dtype=torch.uint8, device=dev)
  at = {n: scratch.data_ptr() + off for n, off in plan["offsets"].items()}
  with torch.cuda.device(dev):  # the launcher reads the current device
    err = lib.wn_layer_backward_any_bf16(
        x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
        w_rs.data_ptr(), _ptr(cots[0]), _ptr(cots[1]), _ptr(valid_t),
        dx.data_ptr(), dcond.data_ptr(), dw_in.data_ptr(), db_in.data_ptr(),
        dw_rs.data_ptr(), db_rs.data_ptr(), at["x_p"], at["g_p"],
        at.get("w_in_p"), at.get("w_rs_p"), at["acts_p"], at.get("dg_p"),
        at["part_bias"], at["ws"], batch, t, c, k, int(dilation), int(last),
        plan["n_splits_t"], plan["split_rows"], plan["split_batches"],
        torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"wn_layer_backward_any kernels failed to launch: "
                       f"cudaError {err}")
  ANY_BWD_LAUNCHES += 1
  return dx, dcond, dw_in, db_in, dw_rs, db_rs


class WNLayerTrainable(torch.autograd.Function):
  """Forward: :func:`wn_layer_fused` without ``skip_acc``; backward, in
  bf16 on the card: :func:`wn_layer_backward_fused` where
  :func:`specialised` holds, else :func:`wn_layer_backward_any`; in f32 on
  the card and on the CPU: :func:`wn_layer_backward`. Saves the six inputs,
  as the JAX custom VJP does (nothing of the kernel's intermediates)."""

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
      c = saved[0].shape[-1]
      kernels = (wn_layer_backward_fused
                 if specialised(c, saved[2].numel() // (2 * c * c))
                 else wn_layer_backward_any)
      grads = kernels(saved, dx_next, dskip, ctx.dilation, ctx.valid_t)
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
  ``wn_layer_fused`` takes them: every shape the shape-generic kernels
  take, any odd K and any even C up to ``ANY_MAX_C``, and beyond those caps
  it raises, naming them); on CPU tensors the plain version. Its plain
  counterpart is ``torch.autograd`` through :func:`wn_layer_plain`."""
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


def _row_cuts(t: int) -> list:
  """``(n_splits_t, split_rows)`` of each cut of a batch row's ``t`` rows
  into ranges of a multiple of ``BWD_CHUNK_ROWS`` rows (the last range
  short), in increasing number of ranges."""
  chunks = -(-t // BWD_CHUNK_ROWS)
  out = []
  for want in range(1, chunks + 1):
    split_rows = -(-chunks // want) * BWD_CHUNK_ROWS
    n_splits = -(-t // split_rows)
    if not out or out[-1][0] != n_splits:
      out.append((n_splits, split_rows))
  return out


def _fill_waves(cuts: list, tiles: int, sms: int):
  """The cut a weights kernel of ``tiles`` output tiles takes among
  ``cuts``, (ranges, cut) pairs in increasing number of ranges, one block
  for each tile and range: the fewest ranges whose blocks fill at least one
  wave of ``sms`` blocks and keep the last wave at least 85% full; else
  (no such cut within 4 waves) the cut with the fullest last wave, at least
  one wave where the rows allow it. More ranges mean more f32 partials for
  the reduce kernel to read."""
  best = None
  for ranges, cut in cuts:
    blocks = tiles * ranges
    waves = -(-blocks // sms)
    if waves > 4 and best is not None:
      break
    fill = blocks / (waves * sms)
    key = (blocks >= sms, fill)
    if best is None or key > best[0]:
      best = (key, cut)
    if blocks >= sms and fill >= 0.85:
      break
  return best[1]


def bwd_splits(batch: int, t: int, tiles: int, sms: int) -> Tuple[int, int]:
  """``(n_splits_t, split_rows)`` of the bf16 backward's weights kernel
  (the whole layer's and a rank's): each of the ``batch`` rows' ``t`` time
  rows is cut into ``n_splits_t`` ranges of ``split_rows`` (a multiple of
  ``BWD_CHUNK_ROWS``; the last range short), as :func:`_fill_waves` picks
  among :func:`_row_cuts`."""
  return _fill_waves([(batch * n, (n, rows)) for n, rows in _row_cuts(t)],
                     tiles, sms)


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


def wn_layer_shard_backward_any(saved: Tuple[torch.Tensor, ...],
                                g: Optional[torch.Tensor], dilation: int
                                ) -> Tuple[torch.Tensor, ...]:
  """:func:`wn_layer_shard_backward` with ``compute_dtype=torch.bfloat16``
  on the card at any shape: the kernels of ``csrc/wn_layer_bwd_any.cu`` at
  the rank's gate width (:func:`any_bwd_kernels`; one call, counted once in
  ``ANY_SHARD_BWD_LAUNCHES``). Inputs as :func:`wn_layer_shard_any` takes
  them in bf16 (x, b_in_s f32; cond_s, w_in_s [K*C, 2C'], w_rs_s bf16; C
  even and at most ``ANY_MAX_C[torch.bfloat16]``, 1 <= C' <= C, K odd); g
  f32 [B, T, n_rs] or None (zero: every gradient is zero and nothing is
  launched). Anything else raises; it never falls back to the plain
  version. :class:`WNLayerShardTrainable` calls it at every shape but the
  specialised kernels' (:func:`shard_specialised`); called directly it
  runs those too."""
  global ANY_SHARD_BWD_LAUNCHES
  x, cond_s, w_in_s, b_in_s, w_rs_s = saved
  c, cp, k = _shard_shape(x, w_in_s, b_in_s)
  bf16 = torch.bfloat16
  _check_shard_any(c, cp, k, w_in_s, bf16)
  if dilation < 0:
    raise ValueError(f"dilation must be >= 0, got {dilation}")
  dev = x.device
  batch, t, _ = x.shape
  if batch > 65535:
    raise ValueError(f"the kernels' grids take B <= 65535, got {batch}")
  last = w_rs_s.numel() == cp * c
  n_rs = c if last else 2 * c
  _check("x", x, torch.float32, (batch, t, c), dev)
  _check("cond_s", cond_s, bf16, (batch, t, 2 * cp), dev)
  _check("w_in_s", w_in_s, bf16, (k * c, 2 * cp), dev)
  _check("b_in_s", b_in_s, torch.float32, (2 * cp,), dev)
  _check("w_rs_s", w_rs_s, bf16, (cp * n_rs,), dev)
  if g is None:
    return tuple(torch.zeros_like(v) for v in saved)
  g = g.contiguous()  # autograd may hand an expanded view
  _check("g", g, torch.float32, (batch, t, n_rs), dev)

  lib = _library()
  plan = _any_bwd_plan(batch, t, c, k, last, dev, cp)
  # each gradient has its input's shape and dtype
  dx, dcond, dw_in, db_in, dw_rs = (torch.empty_like(v) for v in saved)
  scratch = torch.empty(plan["bytes"], dtype=torch.uint8, device=dev)
  at = {n: scratch.data_ptr() + off for n, off in plan["offsets"].items()}
  with torch.cuda.device(dev):  # the launcher reads the current device
    err = lib.wn_layer_shard_backward_any_bf16(
        x.data_ptr(), cond_s.data_ptr(), w_in_s.data_ptr(),
        b_in_s.data_ptr(), w_rs_s.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dcond.data_ptr(), dw_in.data_ptr(), db_in.data_ptr(),
        dw_rs.data_ptr(), at["x_p"], at["g_p"], at.get("w_in_p"),
        at.get("w_rs_p"), at["acts_p"], at.get("dg_p"), at["part_bias"],
        at["ws"], batch, t, c, cp, k, int(dilation), int(last),
        plan["n_splits_t"], plan["split_rows"], plan["split_batches"],
        torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"wn_layer_shard_backward_any kernels failed to "
                       f"launch: cudaError {err}")
  ANY_SHARD_BWD_LAUNCHES += 1
  return dx, dcond, dw_in, db_in, dw_rs


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
  """Forward: :func:`wn_layer_shard` (the shard kernels on the card);
  backward, in bf16 on the card: :func:`wn_layer_shard_backward_fused`
  where :func:`shard_specialised` holds, else
  :func:`wn_layer_shard_backward_any`; otherwise
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
      kernels = (wn_layer_shard_backward_fused
                 if shard_specialised(*_shard_shape(saved[0], saved[2],
                                                    saved[3]))
                 else wn_layer_shard_backward_any)
      grads = kernels(saved, g, ctx.dilation)
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
  forward is the shard kernels (inputs as ``wn_layer_shard`` takes them:
  any odd K, any even C up to ``ANY_MAX_C`` and 1 <= C' <= C; else it
  raises); on CPU tensors the plain version. Its plain counterpart is
  ``torch.autograd`` through :func:`wn_layer_shard_plain`."""
  return WNLayerShardTrainable.apply(x, cond_s, w_in_s, b_in_s, w_rs_s,
                                     dilation, compute_dtype)
