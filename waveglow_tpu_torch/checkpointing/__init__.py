"""Checkpoint formats and loaders (counterpart of
``waveglow_tpu/checkpointing/__init__.py``): the sniff by content, loaders
that take its result, and directory helpers over both save formats.

The port reads the native npz store, the orbax directories the JAX
package's orbax backend writes (:mod:`.orbax_store`, with its own OCDBT,
zarr and zstd code: no orbax, TensorStore or jax) and every reference-era
torch ``.pt`` form (:mod:`.import_torch`).
"""

import zipfile
from pathlib import Path
from typing import List, Tuple, Union

from waveglow_tpu_torch.checkpointing.orbax_store import (
    OrbaxCheckpointRef, checkpoint_path, get_all_orbax_iterations,
    is_orbax_checkpoint, load_checkpoint_ref, restore_host)
from waveglow_tpu_torch.checkpointing.store import (
    CheckpointWaveglow, get_all_checkpoint_iterations)


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
  Callers that gate on the sniffed format (the serving daemon's ``/reload``
  pickle gate) load through the same result: sniffing again here would let
  a file swapped between the two reads past the gate. A swapped file under
  ``"npz"`` fails safely (``np.load(allow_pickle=False)``). ``"orbax"``
  raises ``ValueError``."""
  if fmt == "npz":
    return CheckpointWaveglow.load(path)
  if fmt == "torch":
    from waveglow_tpu_torch.checkpointing.import_torch import \
        load_torch_checkpoint
    return load_torch_checkpoint(path)
  if fmt == "orbax":
    return restore_host(Path(path))
  raise ValueError(f"unknown checkpoint format {fmt!r}")


def load_checkpoint_any(path: Union[str, Path]) -> CheckpointWaveglow:
  """Load a checkpoint of any format the port reads (npz, orbax directory,
  torch ``.pt``), detected by content (:func:`sniff_checkpoint_format`)."""
  return load_checkpoint_as(path, sniff_checkpoint_format(path))


def load_checkpoint_lazy(
    path: Union[str, Path]) -> Union[CheckpointWaveglow, OrbaxCheckpointRef]:
  """:func:`load_checkpoint_any`, but an orbax directory opens by
  reference (its metadata only): ``train()`` then reads its tensors, on a
  mesh each model rank only its slices. npz and torch are single files and
  load eagerly."""
  path = Path(path)
  if path.is_dir():
    return load_checkpoint_ref(path)
  return load_checkpoint_any(path)


def get_all_iterations_any(checkpoints_dir: Union[str, Path]) -> List[int]:
  """Every checkpoint iteration in a directory: ``<it>.npz`` files and
  ``<it>.orbax`` directories."""
  return sorted(set(get_all_checkpoint_iterations(Path(checkpoints_dir)))
                | set(get_all_orbax_iterations(checkpoints_dir)))


def get_checkpoint_any(checkpoints_dir: Union[str, Path],
                       iteration: int) -> Path:
  """The checkpoint at ``iteration`` in either format (npz when both
  exist)."""
  npz = Path(checkpoints_dir) / f"{iteration}.npz"
  if npz.is_file():
    return npz
  orbax = checkpoint_path(checkpoints_dir, iteration)
  if is_orbax_checkpoint(orbax):
    return orbax
  raise FileNotFoundError(
      f"Checkpoint with iteration {iteration} not found in {checkpoints_dir}")


def get_last_checkpoint_any(
    checkpoints_dir: Union[str, Path]) -> Tuple[Path, int]:
  """The newest checkpoint of a directory, in either format."""
  its = get_all_iterations_any(checkpoints_dir)
  if not its:
    raise FileNotFoundError(f"No checkpoint found in {checkpoints_dir}")
  last = max(its)
  return get_checkpoint_any(checkpoints_dir, last), last
