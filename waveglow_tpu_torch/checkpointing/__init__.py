"""Checkpoint formats: the sniff by content and a loader that takes its
result (counterpart of ``waveglow_tpu/checkpointing/__init__.py``).

The port reads the native npz store only; the reference's torch ``.pt``
formats and orbax directories have no importer here yet, and loading one
raises before anything is deserialized.
"""

import zipfile
from pathlib import Path
from typing import Union

from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow


def sniff_checkpoint_format(path: Union[str, Path]) -> str:
  """A checkpoint's on-disk format by content: ``"orbax"`` (a directory),
  ``"npz"`` (the native single-file store) or ``"torch"`` (any
  reference-era format, a pickle).

  npz files and torch ``.pt`` files since torch 1.6 are both zip archives
  (``PK`` magic); a torch archive carries a ``data.pkl`` member, an npz
  only ``.npy`` arrays. The serving daemon's ``/reload`` must know whether
  a path is a pickle before it loads anything.
  """
  path = Path(path)
  if path.is_dir():
    return "orbax"
  with open(path, "rb") as f:
    magic = f.read(2)
  if magic != b"PK":
    return "torch"  # a legacy torch pickle stream
  try:
    with zipfile.ZipFile(path) as z:
      names = z.namelist()
  except zipfile.BadZipFile:
    return "torch"
  if any(n == "data.pkl" or n.endswith("/data.pkl") for n in names):
    return "torch"
  return "npz"


def load_checkpoint_as(path: Union[str, Path], fmt: str) -> CheckpointWaveglow:
  """Load a checkpoint as the format :func:`sniff_checkpoint_format` gave.
  Callers that gate on the sniffed format load through the same result:
  sniffing again here would let a file swapped between the two reads past
  the gate. A swapped file under ``"npz"`` fails safely
  (``np.load(allow_pickle=False)``). ``"torch"`` and ``"orbax"`` raise
  ``ValueError``: their importers are not ported yet, and no pickle is
  ever opened."""
  if fmt == "npz":
    return CheckpointWaveglow.load(path)
  if fmt == "torch":
    raise ValueError(
        f"{path}: a torch-format checkpoint; the port has no torch importer "
        "yet (checkpointing/import_torch.py is not ported) and never "
        "deserializes pickles. Convert it to the native npz format first")
  if fmt == "orbax":
    raise ValueError(
        f"{path}: an orbax checkpoint directory; the port has no orbax "
        "importer yet (checkpointing/orbax_store.py is not ported). Convert "
        "it to the native npz format first")
  raise ValueError(f"unknown checkpoint format {fmt!r}")
