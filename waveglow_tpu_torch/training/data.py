"""Host data pipeline (the port's own copy of ``waveglow_tpu/training/data.py``):
dataset discovery, deterministic segment crops and a prefetching batch
loader.

The host only decodes wavs and crops fixed-length segments; the mel runs on
the device inside the train step. A batch is decoded and cropped by the C++
loader of ``waveglow_tpu_torch.native`` (a thread pool), or in Python with
``use_native=False``; both give the same bits. Crops are a function of
(seed, epoch, index) alone, so a resumed run regenerates the exact
remaining batches of its epoch, and the crops equal the JAX package's for
the same seed, epoch and index. Entries are every ``*.wav`` under a folder,
recursively.
"""

from __future__ import annotations

import logging
import queue
import threading
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from waveglow_tpu_torch import native
from waveglow_tpu_torch.dsp import audio_io
from waveglow_tpu_torch.hparams import HParams

logger = logging.getLogger(__name__)


@dataclass
class Entry:
  stem: str
  basename: str
  wav_absolute_path: Path


Entries = List[Entry]


def load_dataset(folder: Path) -> Entries:
  """Recursive ``*.wav`` walk -> entries (sorted for determinism)."""
  return [Entry(stem=p.stem, basename=p.name, wav_absolute_path=p.absolute())
          for p in sorted(Path(folder).rglob("*.wav"))]


class SegmentDataset:
  """Deterministic segment sampler over a wav dataset.

  Entries are shuffled once with the experiment seed; each (epoch, index)
  crop offset comes from a counter-based RNG, so any iteration is
  reproducible in isolation. A process of a multi-process run takes the
  round-robin shard ``order[process_index::process_count]``, and crops are
  keyed by an entry's global position in the shuffled order, so the union
  of the processes' step-b rows is the one-process step-b batch, cropped
  alike.

  Without ``cache_wavs`` a batch goes through the native loader, its crop
  offsets computed from each file's header (``_length``). If the loader
  refuses a file (a format it does not decode, such as 24-bit PCM), the
  dataset logs one warning and decodes in Python for the rest of the run,
  as the JAX package's does; ``use_native=False`` decodes in Python from
  the start.
  """

  def __init__(self, entries: Entries, hparams: HParams,
               process_index: int = 0, process_count: int = 1,
               use_native: bool = True):
    order = list(entries)
    np.random.RandomState(hparams.seed).shuffle(order)
    self.entries = order[process_index::process_count]
    self._global_index = list(range(process_index, len(order),
                                    process_count))
    self.segment_length = hparams.segment_length
    self.seed = hparams.seed
    self.sampling_rate = hparams.sampling_rate
    self._cache: Optional[Dict[int, np.ndarray]] = (
        {} if hparams.cache_wavs else None)
    self._lengths: Dict[int, int] = {}
    self._use_native = use_native

  def __len__(self) -> int:
    return len(self.entries)

  def _load(self, index: int) -> np.ndarray:
    if self._cache is not None and index in self._cache:
      return self._cache[index]
    path = self.entries[index].wav_absolute_path
    wav, sr = audio_io.wav_to_float32(path)
    if sr != self.sampling_rate:
      raise ValueError(f"{path}: sampling rate {sr} != {self.sampling_rate}")
    if self._cache is not None:
      self._cache[index] = wav
    self._lengths[index] = len(wav)
    return wav

  def _length(self, index: int) -> int:
    """Entry ``index``'s sample count from its header; its sampling rate
    is checked here, since the native batch never reads it again."""
    if index not in self._lengths:
      path = self.entries[index].wav_absolute_path
      frames, sr = _wav_header(path)
      if sr != self.sampling_rate:
        raise ValueError(
            f"{path}: sampling rate {sr} != {self.sampling_rate}")
      self._lengths[index] = frames
    return self._lengths[index]

  def crop_offset(self, index: int, epoch: int, length: int) -> int:
    """Deterministic crop start; -1 means the file is shorter (zero-pad)."""
    if length < self.segment_length:
      return -1
    crop_rng = np.random.default_rng(
        np.random.SeedSequence([self.seed, epoch, self._global_index[index]]))
    return int(crop_rng.integers(0, length - self.segment_length + 1))

  def segment(self, index: int, epoch: int) -> np.ndarray:
    wav = self._load(index)
    offset = self.crop_offset(index, epoch, len(wav))
    if offset < 0:
      return np.pad(wav, (0, self.segment_length - len(wav)))
    return wav[offset:offset + self.segment_length]

  def batch(self, indices, epoch: int) -> np.ndarray:
    """[len(indices), segment_length] float32 batch of segments."""
    if self._use_native and self._cache is None:
      paths = [self.entries[i].wav_absolute_path for i in indices]
      # outside the try: a wrong sampling rate aborts with its own message
      offsets = [self.crop_offset(i, epoch, self._length(i))
                 for i in indices]
      try:
        return native.load_segments_batch(paths, offsets,
                                          self.segment_length)
      except ValueError as e:
        # latched: retrying natively would decode every later batch twice
        logger.warning("native wav decode failed (%s); using the Python "
                       "loader for the rest of this run", e)
        self._use_native = False
    return np.stack([self.segment(i, epoch) for i in indices]).astype(
        np.float32)


def _wav_header(path) -> Tuple[int, int]:
  """(sample count, sampling rate) from a wav's header, no data decode.

  stdlib ``wave`` reads PCM headers but not IEEE-float ones (``wave.Error:
  unknown format: 3``); the native header probe reads those, and a full
  decode is the last resort (a data chunk past the probe's 64 KiB)."""
  try:
    with wave.open(str(path), "rb") as f:
      return f.getnframes(), f.getframerate()
  except (wave.Error, EOFError):
    pass
  try:
    return native.wav_info(path)
  except ValueError:
    pass
  wav, sr = audio_io.wav_to_float32(path)
  return len(wav), sr


class BatchLoader:
  """Iterates [B, segment_length] float32 batches for one epoch, decoded by
  a background thread ``prefetch`` batches ahead. ``num_batches`` overrides
  the natural count: a multi-process run passes one count to every process,
  so each runs the same number of steps even where the shards differ in
  size by one."""

  def __init__(self, dataset: SegmentDataset, batch_size: int,
               drop_last: bool = True, prefetch: int = 2,
               num_batches: Optional[int] = None):
    self.dataset = dataset
    self.batch_size = batch_size
    self.drop_last = drop_last
    self.prefetch = prefetch
    self.num_batches = num_batches

  def __len__(self) -> int:
    if self.num_batches is not None:
      return self.num_batches
    n = len(self.dataset)
    if self.drop_last:
      return n // self.batch_size
    return (n + self.batch_size - 1) // self.batch_size

  def _batches(self, epoch: int, start_batch: int) -> Iterator[np.ndarray]:
    n = len(self.dataset)
    for b in range(start_batch, len(self)):
      lo = b * self.batch_size
      yield self.dataset.batch(range(lo, min(lo + self.batch_size, n)), epoch)

  def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[np.ndarray]:
    """Background-prefetched batch iterator for one epoch.

    A producer-side exception is re-raised in the consumer, and abandoning
    the iterator early unblocks and joins the producer thread.
    """
    q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
    sentinel = object()
    stop = threading.Event()
    error: List[BaseException] = []

    def _put(item) -> bool:
      """Bounded put that aborts when the consumer is gone."""
      while not stop.is_set():
        try:
          q.put(item, timeout=0.1)
          return True
        except queue.Full:
          continue
      return False

    def producer():
      try:
        for batch in self._batches(epoch, start_batch):
          if not _put(batch):
            return
      except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
        error.append(e)
      finally:
        _put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
      while True:
        item = q.get()
        if item is sentinel:
          break
        yield item
      if error:
        raise error[0]
    finally:
      stop.set()
      thread.join()
