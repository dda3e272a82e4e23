"""Audio-quality metrics on the host (the port's own copy of
``waveglow_tpu/eval/metrics.py``): MCD with and without DTW, the cosine mel
distance and SSIM, in numpy and scipy.

  * MCD: DCT-II cepstral coefficients 1..K of the log-mel spectrogram,
    frame-wise euclidean distance scaled by 10*sqrt(2)/ln(10), averaged over
    (optionally DTW-aligned) frames;
  * DTW: exact O(N*M) dynamic programming;
  * cosine mel distance: 1 - mean per-channel cosine distance with zero-pad
    to equal length;
  * SSIM: the Wang et al. formula with a 7x7 uniform window, K1=0.01,
    K2=0.03 and the sample covariance.

Shape mismatches raise ``ValueError`` (a bare ``assert`` vanishes under
``python -O``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple, Union

import numpy as np
from scipy.fft import dct
from scipy.ndimage import uniform_filter
from scipy.spatial.distance import cosine as _cosine_dist

from waveglow_tpu_torch.eval.png import read_png

MCD_NO_OF_COEFFS_PER_FRAME = 16


# -- DTW ----------------------------------------------------------------------

def dtw(a: np.ndarray, b: np.ndarray) -> Tuple[float, List[Tuple[int, int]]]:
  """Exact DTW between frame sequences a [N, D], b [M, D].

  Returns (total euclidean path cost, alignment path as (i, j) pairs).
  """
  n, m = len(a), len(b)
  if n == 0 or m == 0:
    raise ValueError(
        f"dtw requires non-empty frame sequences, got lengths {n} and {m}")
  dist = np.sqrt(
      np.maximum(
          (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * a @ b.T, 0.0))
  cost = np.full((n + 1, m + 1), np.inf)
  cost[0, 0] = 0.0
  for i in range(1, n + 1):
    row = dist[i - 1]
    prev = cost[i - 1]
    cur = cost[i]
    cur[0] = np.inf
    # cost[i, j] = dist + min(cost[i-1, j], cost[i, j-1], cost[i-1, j-1])
    for j in range(1, m + 1):
      cur[j] = row[j - 1] + min(prev[j], cur[j - 1], prev[j - 1])

  path = []
  i, j = n, m
  while i > 0 or j > 0:
    path.append((i - 1, j - 1))
    if i == 0:
      j -= 1
    elif j == 0:
      i -= 1
    else:
      moves = ((cost[i - 1, j - 1], i - 1, j - 1),
               (cost[i - 1, j], i - 1, j),
               (cost[i, j - 1], i, j - 1))
      _, i, j = min(moves)
  path.reverse()
  return float(cost[n, m]), path


def align_mels_with_dtw(mel_1: np.ndarray, mel_2: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, float,
                                   List[int], List[int]]:
  """DTW-align two [n_mels, frames] spectrograms along time."""
  a, b = mel_1.T, mel_2.T
  total_dist, path = dtw(a, b)
  path_1 = [p[0] for p in path]
  path_2 = [p[1] for p in path]
  return a[path_1].T, b[path_2].T, total_dist, path_1, path_2


def get_msd(dist: float, total_frame_number: int) -> float:
  return dist / total_frame_number


# -- MCD ----------------------------------------------------------------------

_MCD_SCALE = 10.0 * np.sqrt(2.0) / np.log(10.0)


def mel_to_mfccs(mel: np.ndarray,
                 n_coeffs: int = MCD_NO_OF_COEFFS_PER_FRAME) -> np.ndarray:
  """Cepstral coefficients 1..n_coeffs from a log-mel [n_mels, frames]."""
  cepstral = dct(mel, type=2, axis=0, norm=None)
  return cepstral[1:1 + n_coeffs, :]


def get_metrics_mels(mel_1: np.ndarray, mel_2: np.ndarray, *,
                     n_mfcc: int = MCD_NO_OF_COEFFS_PER_FRAME,
                     take_log: bool = False,
                     use_dtw: bool = True) -> Tuple[float, float, int]:
  """(MCD, penalty, aligned frame count) between two mel spectrograms.

  ``take_log`` applies log to raw mels (the port's mels are already
  log-compressed); ``use_dtw`` aligns first, otherwise the shorter is
  zero-padded to equal length. Penalty is the share of stretched frames:
  1 - (n1 + n2) / (2 * aligned_frames).
  """
  if take_log:
    mel_1 = np.log(np.maximum(mel_1, 1e-10))
    mel_2 = np.log(np.maximum(mel_2, 1e-10))
  mfcc_1 = mel_to_mfccs(mel_1, n_mfcc)
  mfcc_2 = mel_to_mfccs(mel_2, n_mfcc)

  n1, n2 = mfcc_1.shape[1], mfcc_2.shape[1]
  if use_dtw:
    a1, a2, _, path_1, _ = align_mels_with_dtw(mfcc_1, mfcc_2)
    frames = len(path_1)
  else:
    frames = max(n1, n2)
    a1 = np.pad(mfcc_1, ((0, 0), (0, frames - n1)))
    a2 = np.pad(mfcc_2, ((0, 0), (0, frames - n2)))

  dists = np.sqrt(np.sum((a1 - a2) ** 2, axis=0))
  mcd = float(_MCD_SCALE * np.mean(dists))
  penalty = float(1.0 - (n1 + n2) / (2.0 * frames))
  return mcd, penalty, frames


# -- cosine mel distance --------------------------------------------------------

def make_same_dim(a: np.ndarray, b: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
  """Zero-pad the narrower of two [channels, frames] arrays to the other's
  frame count; their channel counts must agree."""
  if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
    raise ValueError(f"make_same_dim needs two [channels, frames] arrays "
                     f"with equal channels, got {a.shape} and {b.shape}")
  diff = abs(a.shape[1] - b.shape[1])
  if diff > 0:
    pad = np.zeros((a.shape[0], diff))
    if a.shape[1] < b.shape[1]:
      a = np.concatenate((a, pad), axis=1)
    else:
      b = np.concatenate((b, pad), axis=1)
  return a, b


def cosine_dist_mels(a: np.ndarray, b: np.ndarray) -> float:
  """1 - mean per-channel cosine distance; NaN channels count as distance 1."""
  a, b = make_same_dim(a, b)
  scores = []
  for ch in range(a.shape[0]):
    score = _cosine_dist(a[ch], b[ch])
    scores.append(1.0 if np.isnan(score) else score)
  return float(1.0 - np.mean(scores))


# -- SSIM -----------------------------------------------------------------------

def structural_similarity(im1: np.ndarray, im2: np.ndarray,
                          data_range: float = 255.0,
                          win_size: int = 7) -> float:
  """Mean SSIM with a uniform win_size x win_size window (2D grayscale)."""
  im1 = im1.astype(np.float64)
  im2 = im2.astype(np.float64)
  k1, k2 = 0.01, 0.03
  c1 = (k1 * data_range) ** 2
  c2 = (k2 * data_range) ** 2
  # sample ("unbiased") covariance normalization
  np_ = win_size ** im1.ndim
  cov_norm = np_ / (np_ - 1)

  mu1 = uniform_filter(im1, win_size)
  mu2 = uniform_filter(im2, win_size)
  mu11 = uniform_filter(im1 * im1, win_size)
  mu22 = uniform_filter(im2 * im2, win_size)
  mu12 = uniform_filter(im1 * im2, win_size)

  var1 = cov_norm * (mu11 - mu1 * mu1)
  var2 = cov_norm * (mu22 - mu2 * mu2)
  cov = cov_norm * (mu12 - mu1 * mu2)

  ssim_map = (((2 * mu1 * mu2 + c1) * (2 * cov + c2))
              / ((mu1 ** 2 + mu2 ** 2 + c1) * (var1 + var2 + c2)))
  pad = (win_size - 1) // 2
  return float(ssim_map[pad:-pad or None, pad:-pad or None].mean())


def calculate_structural_similarity(path_a: Union[str, Path],
                                    path_b: Union[str, Path]
                                    ) -> Tuple[float, np.ndarray]:
  """SSIM between two PNG files (8-bit RGB or RGBA; alpha is dropped),
  read as their stored bytes."""
  img_a = read_png(path_a)[..., :3]
  img_b = read_png(path_b)[..., :3]
  return calculate_structural_similarity_np(img_a, img_b)


def calculate_structural_similarity_np(img_a: np.ndarray,
                                       img_b: np.ndarray
                                       ) -> Tuple[float, np.ndarray]:
  """SSIM between two same-size images (RGB: the mean over channels), and
  their absolute-difference image."""
  if img_a.shape != img_b.shape:
    raise ValueError(f"SSIM needs images of one shape, got {img_a.shape} "
                     f"and {img_b.shape}")
  if img_a.ndim == 3:
    score = float(np.mean([
        structural_similarity(img_a[..., c], img_b[..., c])
        for c in range(img_a.shape[-1])]))
  else:
    score = structural_similarity(img_a, img_b)
  return score, abs_diff_image(img_a, img_b)


def abs_diff_image(img_a: np.ndarray, img_b: np.ndarray) -> np.ndarray:
  """|a - b| of two uint8 images of one shape, as uint8."""
  return np.abs(img_a.astype(np.int16) - img_b.astype(np.int16)).astype(
      np.uint8)
