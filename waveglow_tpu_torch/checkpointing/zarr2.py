"""zarr v2 arrays in a key-value store, as TensorStore writes them for orbax.

An array ``name`` is a ``name/.zarray`` JSON (shape, chunk shape, dtype,
fill value, order, compressor) and one value a chunk, ``name/0.0...``: the
chunk's index along each dimension joined by the dimension separator
(``"0"`` for a scalar). A chunk holds the chunk shape's elements in C order
(an edge chunk is padded to the full chunk shape), zstd-compressed when the
compressor says so. A missing chunk reads as the fill value (orbax writes
every chunk: ``store_array_data_equal_to_fill_value``).

Dtypes are numpy's little-endian strings (``<f4``, ``<i4``, ...) and
``"bfloat16"``, which numpy lacks: such an array reads and writes as a
``torch.bfloat16`` tensor.

:func:`read_array` reads chunk by chunk into one preallocated array, only
the chunks that overlap the region asked for; :func:`array_values` gives
the values that store an array, chunked as asked (a sharded leaf's chunks
are its shards), for :mod:`.ocdbt` to write.
"""

from __future__ import annotations

import itertools
import json
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from waveglow_tpu_torch import native
from waveglow_tpu_torch.checkpointing import zstd_frames

BFLOAT16 = "bfloat16"
ZARRAY = ".zarray"


class ZarrayMeta:
  """A parsed ``.zarray``."""

  def __init__(self, raw: bytes, name: str):
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
      raise ValueError(f"{name}: not a zarr v2 array")
    self.name = name
    self.shape = tuple(meta["shape"])
    self.chunks = tuple(meta["chunks"])
    if len(self.chunks) != len(self.shape):
      raise ValueError(f"{name}: chunks {self.chunks} do not match shape "
                       f"{self.shape}")
    self.dtype_str = meta["dtype"]
    self.bf16 = self.dtype_str == BFLOAT16
    self.dtype = np.dtype("<u2" if self.bf16 else self.dtype_str)
    if meta.get("order", "C") != "C":
      raise ValueError(f"{name}: order {meta['order']!r} is not supported")
    if meta.get("filters"):
      raise ValueError(f"{name}: zarr filters are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
      raise ValueError(f"{name}: compressor {compressor!r} is not supported")
    self.zstd = compressor is not None
    self.separator = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    self.fill = 0 if fill is None else fill

  def chunk_key(self, index: Sequence[int]) -> str:
    return f"{self.name}/" + (self.separator.join(str(i) for i in index)
                              if index else "0")


def dtype_str(array) -> str:
  if isinstance(array, torch.Tensor):
    if array.dtype != torch.bfloat16:
      raise TypeError("only bfloat16 tensors are stored as tensors")
    return BFLOAT16
  return np.asarray(array).dtype.newbyteorder("<").str


def c_order(array: np.ndarray) -> np.ndarray:
  """``array`` in C order, a 0-d array kept 0-d (``np.ascontiguousarray``
  makes it 1-d)."""
  return array if array.flags.c_contiguous else np.ascontiguousarray(array)


def _host_bytes(array) -> np.ndarray:
  """A C-contiguous numpy array of ``array``'s bytes (bf16 as uint16)."""
  if isinstance(array, torch.Tensor):
    array = array.detach().cpu().contiguous().view(torch.int16).numpy()
  return c_order(np.asarray(array))


def zarray_json(shape: Sequence[int], chunks: Sequence[int],
                dtype: str) -> bytes:
  """The ``.zarray`` TensorStore writes for orbax's zarr v2 arrays (keys
  sorted, no spaces; ``{"id": "zstd"}`` gains its default level 1)."""
  return json.dumps({
      "chunks": list(chunks),
      "compressor": {"id": "zstd", "level": 1},
      "dimension_separator": ".",
      "dtype": dtype,
      "fill_value": None,
      "filters": None,
      "order": "C",
      "shape": list(shape),
      "zarr_format": 2,
  }, sort_keys=True, separators=(",", ":")).encode()


def array_values(name: str, shape: Sequence[int], chunks: Sequence[int],
                 dtype: str, pieces: Dict[Tuple[int, ...], object]
                 ) -> Dict[bytes, object]:
  """The key-value pairs that store chunks ``pieces`` (chunk index ->
  array of the chunk shape) of an array: the ``.zarray`` (always) and one
  value a chunk, a zstd frame of raw blocks (as a list of byte pieces, see
  ``zstd_frames.raw_frame_parts``)."""
  raw = zarray_json(shape, chunks, dtype)
  meta = ZarrayMeta(raw, name)
  out: Dict[bytes, object] = {f"{name}/{ZARRAY}".encode(): raw}
  for index, piece in pieces.items():
    host = _host_bytes(piece)
    if tuple(host.shape) != tuple(chunks):
      raise ValueError(f"{name}: chunk {index} has shape {host.shape}, "
                       f"expected {tuple(chunks)}")
    data = memoryview(host.reshape(-1)).cast("B")
    out[meta.chunk_key(index).encode()] = list(
        zstd_frames.raw_frame_parts(data))
  return out


def _chunk_ranges(meta: ZarrayMeta, region: Tuple[slice, ...]
                  ) -> Iterator[Tuple[int, ...]]:
  spans = []
  for (start, stop), c in zip(((s.start, s.stop) for s in region),
                              meta.chunks):
    spans.append(range(start // c, -(-stop // c)) if stop > start else
                  range(0))
  return itertools.product(*spans)


def read_array(get: Callable[[str], Optional[bytes]], name: str,
               region: Optional[Sequence[slice]] = None):
  """Read array ``name`` (or the box ``region``, one ``slice(start, stop)``
  a dimension) through ``get(key) -> bytes or None``: a numpy array, or a
  ``torch.bfloat16`` tensor for a bfloat16 array. Only the chunks that
  overlap the region are read; each decodes straight into the result where
  the result's slice of it is contiguous."""
  raw = get(f"{name}/{ZARRAY}")
  if raw is None:
    raise KeyError(f"no zarr array {name!r}")
  meta = ZarrayMeta(raw, name)
  if region is None:
    region = tuple(slice(0, n) for n in meta.shape)
  region = tuple(slice(s.start or 0, n if s.stop is None else s.stop)
                 for s, n in zip(region, meta.shape))
  if len(region) != len(meta.shape) or any(
      not 0 <= s.start <= s.stop <= n for s, n in zip(region, meta.shape)):
    raise ValueError(f"{name}: region {region} outside shape {meta.shape}")
  out = np.empty(tuple(s.stop - s.start for s in region), meta.dtype)
  for index in _chunk_ranges(meta, region):
    lo = [i * c for i, c in zip(index, meta.chunks)]
    src, dst = [], []
    for s, l, c in zip(region, lo, meta.chunks):
      a, b = max(s.start, l), min(s.stop, l + c)
      src.append(slice(a - l, b - l))
      dst.append(slice(a - s.start, b - s.start))
    src, dst = tuple(src), tuple(dst)
    data = get(meta.chunk_key(index))
    view = out[dst] if dst else out
    whole = all(x.stop - x.start == c for x, c in zip(src, meta.chunks))
    if data is None:
      view[...] = meta.fill
    elif whole and view.flags.c_contiguous:
      _decode_chunk(meta, data, view)
    else:
      chunk = np.empty(meta.chunks, meta.dtype)
      _decode_chunk(meta, data, chunk)
      view[...] = chunk[src]
  if meta.bf16:
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
  return out


def _decode_chunk(meta: ZarrayMeta, data: bytes, out: np.ndarray) -> None:
  if meta.zstd:
    native.zstd_decompress(data, out)
    return
  flat = out.reshape(-1).view(np.uint8)
  if len(data) != flat.size:
    raise ValueError(f"{meta.name}: chunk of {len(data)} bytes, expected "
                     f"{flat.size}")
  flat[:] = np.frombuffer(data, np.uint8)


def shape_of(get: Callable[[str], Optional[bytes]], name: str) -> List[int]:
  raw = get(f"{name}/{ZARRAY}")
  if raw is None:
    raise KeyError(f"no zarr array {name!r}")
  return list(ZarrayMeta(raw, name).shape)
