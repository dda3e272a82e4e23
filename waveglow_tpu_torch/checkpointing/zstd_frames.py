"""The zstd frames the orbax checkpoint store writes (RFC 8878).

:func:`compress_raw` writes the port's own frames: a valid zstd frame made
of raw (stored) blocks, with the content size in its header and no
checksum. Any zstd decoder reads it, so the port declares the codec orbax
declares (``{"id": "zstd"}``) and writes the bytes as they are: a
checkpoint of random-looking floats shrinks little under zstd, and the port
needs no compressor. Reading goes through ``native.zstd_decompress``, which
decodes every frame TensorStore writes.
"""

from __future__ import annotations

import struct
from typing import Iterator

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024


def frame_header(size: int) -> bytes:
  """A single-segment frame header stating a content size of ``size``."""
  if size < 256:
    return struct.pack("<IBB", MAGIC, 0x20, size)
  if size < 65536 + 256:
    return struct.pack("<IBH", MAGIC, 0x60, size - 256)
  if size < 1 << 32:
    return struct.pack("<IBI", MAGIC, 0xA0, size)
  return struct.pack("<IBQ", MAGIC, 0xE0, size)


def raw_frame_parts(data) -> Iterator[bytes]:
  """The pieces of :func:`compress_raw`'s frame, in order, without joining
  them (block payloads are views of ``data``)."""
  view = memoryview(data).cast("B")
  size = len(view)
  yield frame_header(size)
  if size == 0:
    yield (1).to_bytes(3, "little")  # one empty last raw block
    return
  for start in range(0, size, BLOCK_MAX):
    n = min(BLOCK_MAX, size - start)
    last = start + n == size
    yield ((n << 3) | int(last)).to_bytes(3, "little")
    yield view[start:start + n]


def compress_raw(data) -> bytes:
  """A zstd frame of raw blocks (each at most 128 KiB) holding ``data``."""
  return b"".join(raw_frame_parts(data))
