"""npz checkpoint store, without jax (counterpart of
``waveglow_tpu/checkpointing/store.py``).

Same file format as the JAX package, so each reads the other's saves: the
params pytree (nested dicts/lists of numpy arrays) is flattened to
``'/'``-joined ``params/`` keys, optimizer leaves ride positionally under
``__opt__/<i>`` (passed through as numpy, untouched), and the metadata
(learning rate, iteration, hparams) is a JSON entry ``__meta__``. Saves are
atomic (tmp file + rename). The directory helpers list and pick saves
by iteration.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from waveglow_tpu_torch.hparams import HParams, hparams_from_dict

CKPT_EXT = ".npz"
_META_KEY = "__meta__"
_OPT_PREFIX = "__opt__/"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
  """Flatten nested dicts/lists of arrays into '/'-joined keys."""
  flat: Dict[str, np.ndarray] = {}
  if isinstance(tree, dict):
    for k, v in tree.items():
      flat.update(flatten_tree(v, f"{prefix}{k}/"))
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      flat.update(flatten_tree(v, f"{prefix}{i}/"))
  else:
    flat[prefix[:-1]] = np.asarray(tree)
  return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
  """Inverse of :func:`flatten_tree` (a level whose keys are exactly
  ``0..n-1`` becomes a list)."""
  root: Dict = {}
  for key, value in flat.items():
    parts = key.split("/")
    node = root
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = value

  def build(node):
    if not isinstance(node, dict):
      return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys) and (
        {int(k) for k in keys} == set(range(len(keys)))):
      return [build(node[str(i)]) for i in range(len(keys))]
    return {k: build(v) for k, v in node.items()}

  return build(root)


@dataclass
class CheckpointWaveglow:
  """Checkpoint container: params pytree (numpy leaves) plus metadata."""
  state_dict: Dict                       # params pytree
  optimizer: Optional[List[np.ndarray]]  # optimizer leaves (positional)
  learning_rate: float
  iteration: int
  hparams: Dict

  def get_hparams(self) -> HParams:
    hp, ignored = hparams_from_dict(self.hparams)
    if ignored:
      logging.getLogger(__name__).warning(
          "Ignored checkpoint hparams unknown to this version: %s", ignored)
    return hp

  @classmethod
  def from_params(cls, params: Dict, hparams: HParams,
                  iteration: int = 0) -> "CheckpointWaveglow":
    """A checkpoint of host (numpy) params with no optimizer state."""
    return cls(state_dict=params, optimizer=None,
               learning_rate=hparams.learning_rate, iteration=iteration,
               hparams=asdict(hparams))

  def save(self, path: Union[str, Path]) -> None:
    path = Path(path)
    arrays = {f"params/{k}": v
              for k, v in flatten_tree(self.state_dict).items()}
    if self.optimizer is not None:
      for i, leaf in enumerate(self.optimizer):
        arrays[f"{_OPT_PREFIX}{i}"] = np.asarray(leaf)
    meta = json.dumps({
        "learning_rate": self.learning_rate,
        "iteration": self.iteration,
        "hparams": self.hparams,
        "format_version": 1,
    })
    arrays[_META_KEY] = np.frombuffer(meta.encode("utf-8"), dtype=np.uint8)

    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    os.close(fd)
    try:
      with open(tmp, "wb") as f:
        np.savez(f, **arrays)
      os.replace(tmp, path)
    finally:
      if os.path.exists(tmp):
        os.remove(tmp)

  @classmethod
  def load(cls, path: Union[str, Path]) -> "CheckpointWaveglow":
    path = Path(path)
    if not path.is_file():
      raise FileNotFoundError(f"checkpoint not found: {path}")
    with np.load(path, allow_pickle=False) as data:
      meta = json.loads(bytes(data[_META_KEY].tobytes()).decode("utf-8"))
      params_flat = {}
      opt_leaves: Dict[int, np.ndarray] = {}
      for key in data.files:
        if key == _META_KEY:
          continue
        if key.startswith(_OPT_PREFIX):
          opt_leaves[int(key[len(_OPT_PREFIX):])] = data[key]
        elif key.startswith("params/"):
          params_flat[key[len("params/"):]] = data[key]
    optimizer = ([opt_leaves[i] for i in range(len(opt_leaves))]
                 if opt_leaves else None)
    return cls(state_dict=unflatten_tree(params_flat), optimizer=optimizer,
               learning_rate=meta["learning_rate"],
               iteration=meta["iteration"], hparams=meta["hparams"])


# -- checkpoint directories ---------------------------------------------------
# One ``<iteration>.npz`` file per save; the JAX package's orbax backend
# writes ``<iteration>.orbax`` directories beside them. The port reads no
# orbax checkpoint, but it lists them, so a directory whose newest save is
# an orbax one is never mistaken for one that ends at an older npz.

ORBAX_SUFFIX = ".orbax"
_ORBAX_STATE_ITEM = "state"


def get_checkpoint_filename(iteration: int) -> str:
  return f"{iteration}{CKPT_EXT}"


def get_all_checkpoint_iterations(checkpoint_dir: Path) -> List[int]:
  checkpoint_dir = Path(checkpoint_dir)
  if not checkpoint_dir.is_dir():
    return []
  return sorted(int(p.stem) for p in checkpoint_dir.iterdir()
                if p.suffix == CKPT_EXT and p.stem.isdigit())


def get_last_checkpoint(checkpoint_dir: Path) -> Tuple[Path, int]:
  its = get_all_checkpoint_iterations(checkpoint_dir)
  if not its:
    raise FileNotFoundError(f"No checkpoint found in {checkpoint_dir}")
  last = max(its)
  return Path(checkpoint_dir) / get_checkpoint_filename(last), last


def get_checkpoint(checkpoint_dir: Path, iteration: int) -> Path:
  path = Path(checkpoint_dir) / get_checkpoint_filename(iteration)
  if not path.is_file():
    raise FileNotFoundError(
        f"Checkpoint with iteration {iteration} not found in {checkpoint_dir}")
  return path


def get_custom_or_last_checkpoint(
    checkpoint_dir: Path, custom_iteration: Optional[int]) -> Tuple[Path, int]:
  if custom_iteration is not None:
    return get_checkpoint(checkpoint_dir, custom_iteration), custom_iteration
  return get_last_checkpoint(checkpoint_dir)


def filter_checkpoints(iterations: List[int], select: Optional[int] = None,
                       min_it: Optional[int] = None,
                       max_it: Optional[int] = None) -> List[int]:
  """Iterations in ``[min_it, max_it]`` (defaults 0 and the largest) that
  are multiples of ``select`` (0 or None keeps all)."""
  select = select or 0
  min_it = min_it or 0
  if max_it is None and iterations:
    max_it = max(iterations)
  result = [it for it in iterations
            if min_it <= it <= (max_it if max_it is not None else it)]
  if select > 0:
    result = [it for it in result if it % select == 0]
  return result


def orbax_checkpoint_path(checkpoints_dir: Union[str, Path],
                          iteration: int) -> Path:
  """Where the JAX package's orbax backend saves ``iteration`` (resolved,
  as orbax requires absolute paths)."""
  return Path(checkpoints_dir).resolve() / f"{iteration}{ORBAX_SUFFIX}"


def is_orbax_checkpoint(path: Union[str, Path]) -> bool:
  """An orbax checkpoint is a directory holding its ``state`` item."""
  path = Path(path)
  return path.is_dir() and (path / _ORBAX_STATE_ITEM).exists()


def get_all_orbax_iterations(checkpoints_dir: Union[str, Path]) -> List[int]:
  checkpoints_dir = Path(checkpoints_dir)
  if not checkpoints_dir.is_dir():
    return []
  return sorted(int(p.stem) for p in checkpoints_dir.iterdir()
                if p.suffix == ORBAX_SUFFIX and p.stem.isdigit()
                and is_orbax_checkpoint(p))
