"""The host's C++ libraries, bound with ctypes: the wav loader (counterpart
of ``waveglow_tpu/native/``; its source, ``wavloader.cpp`` here, is the
port's own copy) and the zstd frame decoder of the orbax checkpoint store
(``zstd.cpp``, which the JAX package has no counterpart of: there
TensorStore decodes).

``load_segments_batch`` decodes a batch of PCM16, PCM32 or IEEE-float mono
wavs in parallel and writes each file's crop into one
``[batch, segment_length]`` float32 array, bit for bit the Python decoder's
samples; ``wav_info`` reads a file's length and rate from its header alone;
``decode_wav`` decodes one whole file. ``training.data.SegmentDataset``
reads its batches through it unless it is given ``use_native=False``.

Each library is built with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
at first use into ``waveglow_tpu_torch/build/``, named by a hash of its
source and the flags, under a temporary name of the process and thread and
then renamed, so that processes that build at once (a multi-process
``train``) do not race.
Unlike the JAX package, which falls back to Python when g++ is missing, a
missing compiler or a failed build raises ``RuntimeError`` with g++'s
output: only ``use_native=False`` chooses the Python decoder. The zstd
decoder has no fallback at all.

``zstd_decompress`` decodes every frame of a buffer (RFC 8878: raw, RLE and
compressed blocks, Huffman and FSE tables, skippable frames, the XXH64
content checksum when a frame carries one) and raises ``ValueError`` on a
corrupt frame, never returning part of the data.

``BATCHES`` counts the batches ``load_segments_batch`` has decoded, so a
caller can show that a run read its data through the loader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "wavloader.cpp"
ZSTD_SOURCE = SOURCE.with_name("zstd.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

BATCHES = 0

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ZSTD_LIB: Optional[ctypes.CDLL] = None


def _compiler(source: Path) -> str:
  found = shutil.which(CXX)
  if found is None:
    hint = (" (pass use_native=False to SegmentDataset to decode in Python)"
            if source == SOURCE else "")
    raise RuntimeError(f"C++ compiler {CXX!r} not found: it is needed to "
                       f"build {source.name}{hint}")
  return found


def build_library(source: Optional[Path] = None) -> Path:
  """Compile ``source`` (``wavloader.cpp`` by default; once per hash of the
  source and flags) and return the library's path; raises ``RuntimeError``
  with g++'s output on failure, leaving nothing in the build directory."""
  source = SOURCE if source is None else source
  digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
  digest.update(source.read_bytes())
  lib = BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"
  if lib.is_file():
    return lib
  cxx = _compiler(source)
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = lib.with_name(
      f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
  try:
    proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300,
                          check=False)
    if proc.returncode != 0:
      raise RuntimeError(f"{CXX} failed to build {source}:\n"
                         f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds race harmlessly
  finally:
    tmp.unlink(missing_ok=True)
  return lib


def get_lib() -> ctypes.CDLL:
  """The loaded library, built at first use."""
  global _LIB
  with _LOCK:
    if _LIB is None:
      lib = ctypes.CDLL(str(build_library()))
      lib.wav_read_f32.restype = ctypes.c_long
      lib.wav_read_f32.argtypes = [
          ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
          ctypes.POINTER(ctypes.c_int)]
      lib.wav_info.restype = ctypes.c_long
      lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
      lib.batch_segments.restype = ctypes.c_int
      lib.batch_segments.argtypes = [
          ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
          ctypes.c_int, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
          ctypes.c_int]
      _LIB = lib
    return _LIB


def wav_info(path) -> Tuple[int, int]:
  """(sample count, sampling rate) from the wav's header, no data decode;
  the count is clamped to the bytes the file holds. Raises ``ValueError``
  for a file it cannot read or does not support."""
  sr = ctypes.c_int(0)
  n = get_lib().wav_info(str(path).encode(), ctypes.byref(sr))
  if n < 0:
    raise ValueError(f"native header probe failed for {path}")
  return int(n), sr.value


def decode_wav(path) -> Tuple[np.ndarray, int]:
  """(float32 samples in [-1, 1], sampling rate) of a mono wav; raises
  ``ValueError`` on failure."""
  lib = get_lib()
  sr = ctypes.c_int(0)
  path_b = str(path).encode()
  n = lib.wav_info(path_b, ctypes.byref(sr))
  if n < 0:
    # the header probe reads the first 64 KiB only: a data chunk behind
    # more metadata than that needs the full decode to be counted
    n = lib.wav_read_f32(path_b, None, 0, ctypes.byref(sr))
  if n < 0:
    raise ValueError(f"native decode failed for {path}")
  out = np.empty(n, dtype=np.float32)
  got = lib.wav_read_f32(
      path_b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
      ctypes.byref(sr))
  if got != n:
    raise ValueError(f"{path} changed during read ({got} != {n} samples)")
  return out, sr.value


def load_segments_batch(paths: Sequence, offsets: Sequence[int],
                        segment_length: int,
                        n_threads: int = 0) -> np.ndarray:
  """Decode and crop a batch in parallel: ``[len(paths), segment_length]``
  float32. ``offsets[i]`` is file i's crop start; a negative one takes the
  file from its start and zero-pads the tail, as does a file shorter than
  its crop. ``n_threads`` <= 0: one a file, at most one a core. Raises
  ``ValueError`` naming the first file that fails."""
  global BATCHES
  lib = get_lib()
  n = len(paths)
  if len(offsets) != n:
    raise ValueError(f"{n} paths but {len(offsets)} offsets")
  if n_threads <= 0:
    n_threads = min(n, os.cpu_count() or 1)
  out = np.empty((n, segment_length), dtype=np.float32)
  c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
  c_offsets = (ctypes.c_long * n)(*[int(o) for o in offsets])
  rc = lib.batch_segments(
      c_paths, c_offsets, n, segment_length,
      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
  if rc != 0:
    raise ValueError(f"native decode failed for {paths[rc - 1]}")
  with _LOCK:
    BATCHES += 1
  return out


def get_zstd_lib() -> ctypes.CDLL:
  """The zstd decoder's library, built at first use."""
  global _ZSTD_LIB
  with _LOCK:
    if _ZSTD_LIB is None:
      lib = ctypes.CDLL(str(build_library(ZSTD_SOURCE)))
      lib.zstd_decompress_into.restype = ctypes.c_longlong
      lib.zstd_decompress_into.argtypes = [
          ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
          ctypes.c_char_p, ctypes.c_size_t]
      lib.zstd_decompress_alloc.restype = ctypes.c_void_p
      lib.zstd_decompress_alloc.argtypes = [
          ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_longlong),
          ctypes.c_char_p, ctypes.c_size_t]
      lib.zstd_copy_free.restype = None
      lib.zstd_copy_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
      lib.crc32c.restype = ctypes.c_uint
      lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
      _ZSTD_LIB = lib
    return _ZSTD_LIB


def _address(buf: np.ndarray) -> int:
  return buf.ctypes.data if buf.size else 0


def zstd_decompress(data, out: Optional[np.ndarray] = None) -> np.ndarray:
  """Decode every zstd frame of ``data`` (bytes-like) into a uint8 array.

  With ``out`` (a C-contiguous array of any dtype) the frames decode
  straight into its bytes, which they must fill exactly; else into a new
  array of the decoded size. Raises ``ValueError`` with the decoder's
  message on a corrupt or truncated frame."""
  lib = get_zstd_lib()
  src = np.frombuffer(data, dtype=np.uint8)
  err = ctypes.create_string_buffer(256)
  if out is not None:
    if not out.flags.c_contiguous:
      raise ValueError("zstd_decompress: out must be C-contiguous")
    dst = out.reshape(-1).view(np.uint8)
    got = lib.zstd_decompress_into(_address(src), src.size, _address(dst),
                                   dst.size, err, len(err))
    if got < 0:
      raise ValueError(f"zstd: {err.value.decode()}")
    if got != dst.size:
      raise ValueError(f"zstd: decoded {got} bytes, expected {dst.size}")
    return dst
  size = ctypes.c_longlong(0)
  handle = lib.zstd_decompress_alloc(_address(src), src.size,
                                     ctypes.byref(size), err, len(err))
  if not handle:
    raise ValueError(f"zstd: {err.value.decode()}")
  result = np.empty(size.value, dtype=np.uint8)
  lib.zstd_copy_free(handle, _address(result))
  return result


def crc32c(data) -> int:
  """The CRC-32C (Castagnoli) of ``data``: the checksum that ends every
  OCDBT manifest and node."""
  src = np.frombuffer(data, dtype=np.uint8)
  return int(get_zstd_lib().crc32c(_address(src), src.size))
