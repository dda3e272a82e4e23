"""Fused WN layer forward: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``waveglow_tpu/kernels/wn_layer.py::_wn_layer_fused`` (Pallas, TPU).
The kernel is ``csrc/wn_layer.cu`` (see the note at its top for what bounds
it on an H100 and how it is laid out), compiled with nvcc for ``sm_90a`` at
first use into ``waveglow_tpu_torch/build/`` (keyed by a hash of the source
and flags) and bound with ctypes.

Math of one layer, channels-last (``C`` channels, dilation ``d``):

  pre  = sum_tap x[t + (tap-1)*d] @ w_in[tap]        (zero "same" padding)
  acts = tanh(pre[:C] + b_in[:C] + cond[:C]) * sigmoid(pre[C:] + b_in[C:] + cond[C:])
  rs   = acts @ w_rs + b_rs
  x'   = x + rs[:C], skip = rs[C:]                   (last layer: x' = x, skip = rs)

x' rows ``>= valid_t[b]`` are zeroed (bucket padding), and with ``skip_acc``
the skip is added into that buffer in place and the buffer returned.

``wn_layer_fused`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; on a CUDA tensor it launches the kernel or raises, never falls
back. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from waveglow_tpu_torch.ops.conv import shift_time

LAUNCHES = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "wn_layer.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CHANNELS = 256  # the width the kernel is built for

_LIB = None
# nvcc/ptxas output and seconds of a build this process ran; empty and None
# when it loaded a library an earlier process built
BUILD_LOG = ""
BUILD_SECONDS = None

ValidT = Optional[Union[int, torch.Tensor]]


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
  w_in = operand(w_in).reshape(3, c, 2 * c)
  pre = None
  for tap in range(3):
    term = torch.matmul(shift_time(xm, (tap - 1) * dilation), w_in[tap])
    pre = term if pre is None else pre + term
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
  if valid_t is not None:
    valid = torch.as_tensor(valid_t, device=x.device).reshape(-1, 1)
    keep = (torch.arange(t, device=x.device)[None, :] < valid)[..., None]
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
                     f"{SOURCE.name}")


def build_library() -> Path:
  """Compile ``csrc/wn_layer.cu`` (once per source/flags hash); returns the
  path of the shared library. Raises with nvcc's output on failure."""
  global BUILD_LOG, BUILD_SECONDS
  src = SOURCE.read_bytes()
  key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
  lib = BUILD_DIR / f"wn_layer_{key}.so"
  if lib.is_file():
    return lib
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
  os.close(fd)
  try:
    start = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{proc.stderr}")
    BUILD_SECONDS = time.perf_counter() - start
    BUILD_LOG = proc.stdout + proc.stderr
    os.replace(tmp, lib)  # atomic: concurrent builders race harmlessly
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return lib


def _library():
  global _LIB
  if _LIB is None:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.wn_layer_forward
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    info = lib.wn_layer_kernel_info
    info.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
    info.restype = ctypes.c_int
    _LIB = lib
  return _LIB


def kernel_info(bf16: bool, last: bool) -> dict:
  """What the loaded build of one kernel variant uses, from the CUDA runtime
  (cudaFuncGetAttributes): registers and local (spill) bytes per thread,
  static shared bytes, and the dynamic shared bytes its launcher passes."""
  vals = [ctypes.c_int() for _ in range(4)]
  err = _library().wn_layer_kernel_info(int(bf16), int(last),
                                        *[ctypes.byref(v) for v in vals])
  if err != 0:
    raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
  keys = ("registers", "local_bytes", "static_smem_bytes",
          "dynamic_smem_bytes")
  return dict(zip(keys, (v.value for v in vals)))


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
  which takes: x f32 [B, T, C] with C = 256; cond, w_in, w_rs in
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
  if c != CHANNELS:
    raise ValueError(f"kernel supports C = {CHANNELS}, got {c}")
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

  lib = _library()
  err = lib.wn_layer_forward(
      x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
      w_rs.data_ptr(), b_rs.data_ptr(),
      valid_t.data_ptr() if valid_t is not None else None,
      x_out.data_ptr(), skip.data_ptr(),
      int(skip_acc is not None), batch, t, c, int(dilation),
      int(wdt == torch.bfloat16), int(last),
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"wn_layer kernel launch failed: cudaError {err}")
  LAUNCHES += 1
  return x_out, skip
