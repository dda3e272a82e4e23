"""PNG files with ``zlib`` and ``struct`` alone: 8-bit RGB and RGBA,
not interlaced. The writer stores every row unfiltered; the reader undoes
all five filter types (None, Sub, Up, Average, Paeth), so it reads what
libpng-based writers produce with adaptive filtering."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: 2 truecolour (RGB), 6 truecolour with alpha
_CHANNELS = {2: 3, 6: 4}
_COLOUR_TYPE = {3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
  return (struct.pack(">I", len(data)) + kind + data
          + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: Union[str, Path], image: np.ndarray) -> None:
  """Write a uint8 ``[H, W, 3]`` (RGB) or ``[H, W, 4]`` (RGBA) image."""
  image = np.asarray(image)
  if (image.dtype != np.uint8 or image.ndim != 3
      or image.shape[2] not in _COLOUR_TYPE or 0 in image.shape[:2]):
    raise ValueError(f"write_png takes a non-empty uint8 [H, W, 3 or 4] "
                     f"image, got {image.dtype} {image.shape}")
  height, width, channels = image.shape
  header = struct.pack(">IIBBBBB", width, height, 8,
                       _COLOUR_TYPE[channels], 0, 0, 0)
  rows = np.zeros((height, 1 + width * channels), np.uint8)  # filter 0
  rows[:, 1:] = image.reshape(height, -1)
  with open(path, "wb") as f:
    f.write(SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
  p = a + b - c
  pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
  if pa <= pb and pa <= pc:
    return a
  return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
  out = np.zeros((height, stride), np.uint8)
  prev = np.zeros(stride, np.uint8)
  for y in range(height):
    start = y * (stride + 1)
    kind = raw[start]
    line = np.frombuffer(raw, np.uint8, stride, start + 1)
    if kind == 0:
      cur = line.copy()
    elif kind == 1:     # Sub: running sums mod 256 over each channel
      cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64)
             % 256).astype(np.uint8).reshape(-1)
    elif kind == 2:     # Up
      cur = line + prev
    elif kind in (3, 4):  # Average, Paeth: each byte needs the one before
      cur_b = bytearray(line.tobytes())
      up = prev.tobytes()
      for i in range(stride):
        left = cur_b[i - bpp] if i >= bpp else 0
        if kind == 3:
          pred = (left + up[i]) >> 1
        else:
          pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
        cur_b[i] = (cur_b[i] + pred) & 0xFF
      cur = np.frombuffer(bytes(cur_b), np.uint8)
    else:
      raise ValueError(f"PNG row {y}: unknown filter type {kind}")
    out[y] = cur
    prev = cur
  return out


def read_png(path: Union[str, Path]) -> np.ndarray:
  """A PNG file's pixels as uint8 ``[H, W, 3]`` (RGB) or ``[H, W, 4]``
  (RGBA). Other bit depths, colour types and interlaced files raise
  ``ValueError``."""
  data = Path(path).read_bytes()
  if data[:8] != SIGNATURE:
    raise ValueError(f"{path}: not a PNG file")
  pos, header, idat = 8, None, []
  while pos + 8 <= len(data):
    length, kind = struct.unpack(">I4s", data[pos:pos + 8])
    body = data[pos + 8:pos + 8 + length]
    if len(body) != length:
      raise ValueError(f"{path}: truncated {kind!r} chunk")
    if kind == b"IHDR":
      header = struct.unpack(">IIBBBBB", body)
    elif kind == b"IDAT":
      idat.append(body)
    elif kind == b"IEND":
      break
    pos += 12 + length
  if header is None or not idat:
    raise ValueError(f"{path}: no IHDR or IDAT chunk")
  width, height, depth, colour, _, _, interlace = header
  if depth != 8 or colour not in _CHANNELS or interlace != 0:
    raise ValueError(
        f"{path}: only 8-bit RGB or RGBA PNGs without interlacing are "
        f"read (bit depth {depth}, colour type {colour}, interlace "
        f"{interlace})")
  channels = _CHANNELS[colour]
  stride = width * channels
  raw = zlib.decompress(b"".join(idat))
  if len(raw) != height * (stride + 1):
    raise ValueError(f"{path}: {len(raw)} bytes of image data, expected "
                     f"{height * (stride + 1)}")
  return _unfilter(raw, height, stride, channels).reshape(
      height, width, channels)
