"""Mel-spectrogram renders and image stacking for validation reports (the
port's counterpart of ``waveglow_tpu/eval/plots.py``), in numpy alone.

The JAX package draws with matplotlib, which the machines with the card
do not have. The raw render here keeps matplotlib's geometry for
``imshow(mel, aspect="auto", origin="lower", interpolation="none")`` after
``tight_layout`` at 100 dpi: a canvas of ``int(16 * F / 1000 * 100)`` x 500
pixels for F frames, white margins of 15 px, a 0.8 pt black spine on a
pixel centre with a grey fringe on either side, and inside it the data
min-max normalised through matplotlib's 256-entry viridis table, sampled
at pixel centres (column j of the box shows frame
``floor((j + 0.5) * F / ceil(box width))``, rows likewise from the
bottom). The labeled render is the raw render with a viridis colour bar on
the right and **no text**: there are no tick labels, axis labels or title,
because the card's machine has no font rasterizer. No metric is computed
from it.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from waveglow_tpu_torch.eval.png import write_png

DPI = 100
# tight_layout's padding: 1.08 x the 10 pt font, at 100 dpi
MARGIN_PX = 15
# the spine's line width (its caps project by half of it)
SPINE_PT = 0.8
# matplotlib's colorbar: aspect 20, a gap between it and the axes
COLORBAR_ASPECT = 20
COLORBAR_GAP_PX = 10

# matplotlib's viridis colormap, ``viridis(range(256), bytes=True)[:, :3]``
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
), np.uint8).reshape(256, 3)


def colormap_indices(mel: np.ndarray) -> np.ndarray:
  """Viridis table indices of ``mel`` after min-max normalisation, as
  matplotlib's ``Normalize`` and colormap compute them (in the data's float
  width; a constant input maps to 0)."""
  x = np.array(mel, dtype=np.float32 if mel.dtype == np.float32
               else np.float64)
  lo, hi = float(x.min()), float(x.max())
  if hi > lo:
    x -= lo
    x /= hi - lo
  else:
    x[...] = 0
  x *= 256
  x[x == 256] = 255
  return np.clip(x, 0, 255).astype(int)


def _coverage(lo: float, hi: float, n: int) -> np.ndarray:
  """How much of each pixel [p, p + 1) of ``n`` the span [lo, hi] covers,
  in 256ths."""
  p = np.arange(n)
  return np.rint(np.clip(np.minimum(p + 1, hi) - np.maximum(p, lo), 0, 1)
                 * 256).astype(np.int64)


def _stroke(canvas: np.ndarray, x_lo: float, x_hi: float, y_lo: float,
            y_hi: float) -> None:
  """Blend black over ``canvas`` by each pixel's coverage of the rectangle,
  in 256ths (the rasterizer's resolution)."""
  rows = slice(max(math.floor(y_lo), 0), math.ceil(y_hi))
  cols = slice(max(math.floor(x_lo), 0), math.ceil(x_hi))
  cover = (np.outer(_coverage(y_lo, y_hi, canvas.shape[0])[rows],
                    _coverage(x_lo, x_hi, canvas.shape[1])[cols]) + 128) >> 8
  region = canvas[rows, cols]
  region[...] = (region * (256 - cover[..., None]) >> 8).astype(np.uint8)


def _row_indices(n_out: int, n_src: int) -> np.ndarray:
  """Nearest source row of each output row's centre: the coordinate in
  1/256 pixel (the resampler's fixed point), then truncated."""
  return np.rint((np.arange(n_out) + 0.5) * n_src / n_out * 256
                 ).astype(np.int64) >> 8


def _column_indices(n_out: int, n_src: int) -> np.ndarray:
  """Nearest source column of each output pixel along a row, as the
  resampler walks it: the coordinates of the row's two ends in 1/256 pixel,
  and between them integer steps that spread the remainder evenly (Agg's
  ``dda2_line_interpolator``), then truncated."""
  x1 = round(0.5 * n_src / n_out * 256)
  x2 = round((0.5 + n_out) * n_src / n_out * 256)
  step, rem = divmod(x2 - x1, n_out)
  if rem == 0:
    step, rem = step - 1, n_out
  j = np.arange(n_out, dtype=np.int64)
  carries = -(-(j + 1) * rem // n_out) - 1
  return (x1 + j * step + carries) >> 8


def _draw_box(canvas: np.ndarray, rgb: np.ndarray, x0: int, x1: float,
              y0: int, y1: int) -> None:
  """Nearest-sample ``rgb`` [rows, cols, 3] (row 0 at the bottom) into the
  box from column ``x0`` to ``x1`` and from canvas row ``y0`` to ``y1``,
  then stroke the box's spine on pixel centres."""
  rows, cols = rgb.shape[:2]
  out_w = math.ceil(x1 - x0)
  src_c = _column_indices(out_w, cols)
  src_r = _row_indices(y1 - y0, rows)
  canvas[y0:y1, x0:x0 + out_w] = rgb[src_r[::-1]][:, src_c]
  left, right = x0 + 0.5, math.floor(x1 + 0.5) + 0.5
  top, bottom = y0 + 0.5, y1 + 0.5
  half = SPINE_PT / 72 * DPI / 2
  for x in (left, right):
    _stroke(canvas, x - half, x + half, top - half, bottom + half)
  for y in (bottom, top):
    _stroke(canvas, left - half, right + half, y - half, y + half)


def plot_melspec_np(mel: np.ndarray, mel_dim_x: int = 16,
                    mel_dim_y: int = 5, factor: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray]:
  """[n_mels, frames] -> (raw RGB render, labeled RGB render), uint8
  ``[mel_dim_y * factor * 100, int(mel_dim_x * factor * frames / 1000 *
  100)]``; a render narrower than its margins and one pixel of data (under
  20 frames at the defaults) is widened to that."""
  mel = np.asarray(mel)
  if mel.ndim != 2 or 0 in mel.shape:
    raise ValueError(f"expected a [n_mels, frames] mel, got {mel.shape}")
  width_f = max(mel_dim_x * factor * mel.shape[1] / 1000 * DPI,
                2 * MARGIN_PX + 1)
  height = mel_dim_y * factor * DPI
  width = int(width_f)
  x1 = width_f - MARGIN_PX
  rgb = VIRIDIS[colormap_indices(mel)]
  y0, y1 = MARGIN_PX, height - MARGIN_PX
  raw = np.full((height, width, 3), 255, np.uint8)
  _draw_box(raw, rgb, MARGIN_PX, x1, y0, y1)

  labeled = np.full((height, width, 3), 255, np.uint8)
  bar_w = (y1 - y0) // COLORBAR_ASPECT
  mel_x1 = x1 - bar_w - COLORBAR_GAP_PX
  if mel_x1 - MARGIN_PX < 1:   # too narrow for a bar: the raw render
    labeled[...] = raw
  else:
    _draw_box(labeled, rgb, MARGIN_PX, mel_x1, y0, y1)
    _draw_box(labeled, VIRIDIS[:, None], math.floor(x1 - bar_w), x1, y0, y1)
  return raw, labeled


def make_same_width_by_filling_white(images: List[np.ndarray]
                                     ) -> List[np.ndarray]:
  """Right-pad RGB images with white so all have the maximum width."""
  max_width = max(img.shape[1] for img in images)
  result = []
  for img in images:
    pad = max_width - img.shape[1]
    if pad > 0:
      img = np.pad(img, ((0, 0), (0, pad), (0, 0)), constant_values=255)
    result.append(img)
  return result


def stack_images_vertically(images: List[np.ndarray]) -> np.ndarray:
  """Stack RGB images top-to-bottom, right-padded with white to one width."""
  return np.concatenate(make_same_width_by_filling_white(images), axis=0)


def save_image(path: Union[str, Path], image: np.ndarray) -> None:
  """Write a uint8 RGB or RGBA image as a PNG file."""
  write_png(path, image)
