"""The orbax checkpoint store, without orbax, TensorStore or jax
(counterpart of ``waveglow_tpu/checkpointing/orbax_store.py``).

Reads and writes the directories the JAX package's orbax backend writes:
one checkpoint is ``<checkpoints_dir>/<iteration>.orbax`` holding the
composite orbax saves for ``{state: StandardSave({"params", "opt"}),
meta: JsonSave}``:

* ``_CHECKPOINT_METADATA``: the item handlers and timestamps (JSON);
* ``meta/metadata``: ``{learning_rate, iteration, hparams,
  format_version}`` (JSON);
* ``state/_METADATA``: the tree metadata (each leaf's key path and value
  type), ``use_ocdbt: true``, ``use_zarr3: false``;
* ``state/``: an OCDBT database (:mod:`.ocdbt`) whose keys are zarr v2
  arrays (:mod:`.zarr2`), one a leaf, named by the leaf's key path joined
  with ``.`` (``params.flows.0.wn.start.v``, ``opt.3``); the root database
  there points into the per-process databases ``state/ocdbt.process_<i>/``,
  which hold the data.

The payload is the npz store's: the params tree, optax's Adam state as
positional leaves (``opt.<i>``), and the metadata. :func:`restore_host`
gives the port's :class:`CheckpointWaveglow` of it.

Saves are atomic, as orbax's are: everything is written into
``<iteration>.orbax.orbax-checkpoint-tmp``, ``_CHECKPOINT_METADATA`` last,
and the directory is renamed into place. A directory without a ``state``
item, or under a temporary name, is not a checkpoint. The port writes each
leaf as a numpy leaf of orbax's (``value_type: np.ndarray``: no sharding
file), its chunks zstd frames of raw blocks (valid zstd that any reader
decodes; the port has no compressor), nodes and manifests likewise.

On a model group (``params`` a list of per-rank trees, as
:func:`waveglow_tpu_torch.parallel.sharding.shard_trainable_params` cuts
them) a leaf cut over the model ranks is one zarr array whose chunks are
the ranks' slices, and a replicated leaf is written once. In a
multi-process run every process writes its share of the chunks into
``ocdbt.process_<rank>`` and process 0, past a barrier, writes the root
database and commits. :func:`restore_sharded` reads each model rank's
slices back, each rank only the chunks that overlap its slice.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from waveglow_tpu_torch.checkpointing import ocdbt, zarr2
from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.hparams import HParams, hparams_from_dict
from waveglow_tpu_torch.parallel.mesh import (MODEL_AXIS, Mesh,
                                              process_count, process_index)

logger = logging.getLogger(__name__)

ORBAX_SUFFIX = ".orbax"
TMP_SUFFIX = ".orbax-checkpoint-tmp"
PROCESS_PREFIX = "ocdbt.process_"
_STATE_ITEM = "state"
_META_ITEM = "meta"
_TREE_METADATA = "_METADATA"
_CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_HANDLERS = {
    _META_ITEM: "orbax.checkpoint._src.handlers.json_checkpoint_handler."
                "JsonCheckpointHandler",
    _STATE_ITEM: "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                 "StandardCheckpointHandler",
}
_DICT_KEY, _SEQUENCE_KEY = 2, 1  # orbax's key_type values


def checkpoint_path(checkpoints_dir: Union[str, Path],
                    iteration: int) -> Path:
  return Path(checkpoints_dir).resolve() / f"{iteration}{ORBAX_SUFFIX}"


def is_orbax_checkpoint(path: Union[str, Path]) -> bool:
  """An orbax checkpoint is a committed directory holding its ``state``
  item (a save in progress has a temporary name)."""
  path = Path(path)
  return (path.is_dir() and (path / _STATE_ITEM).exists()
          and TMP_SUFFIX not in path.name)


def get_all_orbax_iterations(checkpoints_dir: Union[str, Path]) -> List[int]:
  checkpoints_dir = Path(checkpoints_dir)
  if not checkpoints_dir.is_dir():
    return []
  return sorted(int(p.stem) for p in checkpoints_dir.iterdir()
                if p.suffix == ORBAX_SUFFIX and p.stem.isdigit()
                and is_orbax_checkpoint(p))


# -- the leaves of a save ---------------------------------------------------

KeyPath = Tuple[Tuple[str, int], ...]


@dataclass
class _Leaf:
  """One array of a save: its key path, global shape, chunk shape, dtype
  and the chunks this save holds (chunk index -> host array)."""
  path: KeyPath
  shape: Tuple[int, ...]
  chunks: Tuple[int, ...]
  dtype: str
  pieces: Dict[Tuple[int, ...], object]

  @property
  def name(self) -> str:
    return ".".join(k for k, _ in self.path)


def _host(leaf, copy: bool = False):
  """``leaf`` in host memory (a bfloat16 tensor stays a tensor); with
  ``copy`` in memory of its own, which no later update of the caller's
  arrays or tensors reaches (a CPU tensor's ``numpy()`` shares its
  storage)."""
  if isinstance(leaf, torch.Tensor):
    host = leaf.detach().to("cpu", copy=copy).contiguous()
    return host if host.dtype == torch.bfloat16 else host.numpy()
  leaf = np.asarray(leaf)
  return np.array(leaf, order="C") if copy else zarr2.c_order(leaf)


def _key_paths(tree, prefix: KeyPath = ()) -> List[Tuple[KeyPath, object]]:
  """(key path, leaf) in ``tree_leaves`` order."""
  if isinstance(tree, dict):
    return [item for k in sorted(tree)
            for item in _key_paths(tree[k], prefix + ((str(k), _DICT_KEY),))]
  if isinstance(tree, (list, tuple)):
    return [item for i, v in enumerate(tree)
            for item in _key_paths(v, prefix + ((str(i), _SEQUENCE_KEY),))]
  return [(prefix, tree)]


def _whole_leaf(path: KeyPath, leaf, copy: bool) -> _Leaf:
  host = _host(leaf, copy)
  shape = tuple(host.shape)
  return _Leaf(path, shape, shape, zarr2.dtype_str(host),
               {(0,) * len(shape): host})


def _rank_leaf(path: KeyPath, spec, rank_leaves: Sequence,
               copy: bool) -> _Leaf:
  """A leaf of a model group: one chunk a rank along the cut axis, or the
  rank 0 copy of a replicated leaf."""
  if MODEL_AXIS not in spec or len(rank_leaves) == 1:
    return _whole_leaf(path, rank_leaves[0], copy)
  dim = spec.index(MODEL_AXIS)
  hosts = [_host(x, copy) for x in rank_leaves]
  chunks = tuple(hosts[0].shape)
  shape = tuple(n * len(hosts) if d == dim else n
                for d, n in enumerate(chunks))
  pieces = {}
  for rank, host in enumerate(hosts):
    index = [0] * len(chunks)
    index[dim] = rank
    pieces[tuple(index)] = host
  return _Leaf(path, shape, chunks, zarr2.dtype_str(hosts[0]), pieces)


def _plan(params, opt_state, copy: bool = False) -> List[_Leaf]:
  """The leaves of ``{"params": params, "opt": opt_state}`` in host memory
  (of their own with ``copy``). ``params`` is a tree, or a model group's
  list of rank trees (then ``opt_state`` is a list of each rank's
  optax-layout leaves)."""
  opt_state = list(opt_state) if opt_state is not None else []
  if isinstance(params, dict):
    return ([_whole_leaf((("params", _DICT_KEY),) + p, x, copy)
             for p, x in _key_paths(params)]
            + [_whole_leaf((("opt", _DICT_KEY), (str(i), _SEQUENCE_KEY)), x,
                           copy)
               for i, x in enumerate(opt_state)])
  from waveglow_tpu_torch.parallel.sharding import leaf_specs
  ranks = list(params)
  specs = leaf_specs(ranks[0])
  paths = [p for p, _ in _key_paths(ranks[0])]
  columns = list(zip(*[tree_leaves(t) for t in ranks]))
  leaves = [_rank_leaf((("params", _DICT_KEY),) + p, s, c, copy)
            for p, s, c in zip(paths, specs, columns)]
  if opt_state:
    n = len(specs)
    opt_columns = list(zip(*opt_state))
    if len(opt_columns) != 1 + 2 * n:
      raise ValueError(f"optimizer state has {len(opt_columns)} leaves a "
                       f"rank, expected {1 + 2 * n}")
    opt_specs = [()] + specs + specs
    leaves += [_rank_leaf((("opt", _DICT_KEY), (str(i), _SEQUENCE_KEY)),
                          s, c, copy)
               for i, (s, c) in enumerate(zip(opt_specs, opt_columns))]
  return leaves


def _meta(iteration: int, hparams: HParams) -> Dict:
  return {"learning_rate": hparams.learning_rate, "iteration": iteration,
          "hparams": asdict(hparams), "format_version": 1}


def _tree_metadata(leaves: Sequence[_Leaf]) -> Dict:
  return {
      "tree_metadata": {
          str(tuple(k for k, _ in leaf.path)): {
              "key_metadata": [{"key": k, "key_type": t}
                               for k, t in leaf.path],
              "value_metadata": {"value_type": "np.ndarray",
                                 "skip_deserialize": False},
          } for leaf in leaves},
      "use_ocdbt": True,
      "use_zarr3": False,
      "store_array_data_equal_to_fill_value": True,
      "custom_metadata": None,
  }


# -- writing ------------------------------------------------------------------

def _write_json(path: Path, obj) -> None:
  path.parent.mkdir(parents=True, exist_ok=True)
  with open(path, "w") as f:
    json.dump(obj, f)
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: Path) -> None:
  fd = os.open(path, os.O_RDONLY)
  try:
    os.fsync(fd)
  finally:
    os.close(fd)


def _agree(ok: bool) -> bool:
  """True when every process of the group says ``ok``: a barrier that
  also carries a failure, so no process waits on one whose write failed."""
  if process_count() == 1:
    return ok
  device = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
  flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=device)
  dist.all_reduce(flag, op=dist.ReduceOp.MIN)
  return bool(flag.item())


class _Save:
  """One save's stages: ``begin`` (process 0 makes the temporary
  directory, all wait), ``write`` (this process's share of the chunks)
  and ``commit`` (all agree, process 0 writes the root database and the
  metadata and renames, all wait)."""

  def __init__(self, checkpoints_dir, iteration: int, params, opt_state,
               hparams: HParams, copy: bool = False):
    self.path = checkpoint_path(checkpoints_dir, iteration)
    self.tmp = self.path.with_name(self.path.name + TMP_SUFFIX)
    self.rank, self.n_procs = process_index(), process_count()
    self.meta = _meta(iteration, hparams)
    self.init_ns = time.time_ns()
    self.leaves = _plan(params, opt_state, copy)  # the host copy

  def begin(self) -> None:
    ok = True
    if self.rank == 0:
      try:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.tmp.exists():
          shutil.rmtree(self.tmp)  # a save that died before its commit
        (self.tmp / _STATE_ITEM).mkdir(parents=True)
      except OSError:
        if self.n_procs == 1:
          raise
        ok = False
    if not _agree(ok):
      raise RuntimeError(f"process 0 could not create {self.tmp}")

  def write(self) -> None:
    """Write this process's chunks (round robin over every leaf's chunks;
    a leaf's ``.zarray`` goes with its first chunk) into its own
    database."""
    values: Dict[bytes, object] = {}
    j = 0
    for leaf in self.leaves:
      for index in sorted(leaf.pieces):
        if j % self.n_procs == self.rank:
          kv = zarr2.array_values(leaf.name, leaf.shape, leaf.chunks,
                                  leaf.dtype, {index: leaf.pieces[index]})
          zarray = f"{leaf.name}/{zarr2.ZARRAY}".encode()
          if index != min(leaf.pieces):
            del kv[zarray]
          values.update(kv)
        j += 1
    if values:
      ocdbt.write_database(
          self.tmp / _STATE_ITEM / f"{PROCESS_PREFIX}{self.rank}", values)

  def commit(self, ok: bool = True) -> Path:
    if not _agree(ok):
      raise RuntimeError(f"a process failed to write its share of "
                         f"{self.path}")
    committed = True
    if self.rank == 0:
      try:
        self._commit_root()
      except Exception:
        if self.n_procs == 1:
          raise
        committed = False
        logger.exception("committing %s failed", self.path)
    # nobody reads the checkpoint before it is committed
    if not _agree(committed):
      raise RuntimeError(f"process 0 could not commit {self.path}")
    return self.path

  def _commit_root(self) -> None:
    """Process 0: the root database over every process's, the metadata
    (``_CHECKPOINT_METADATA`` last) and the rename into place."""
    state = self.tmp / _STATE_ITEM
    entries: Dict[bytes, ocdbt.Value] = {}
    for p in range(self.n_procs):
      db = state / f"{PROCESS_PREFIX}{p}"
      if not db.is_dir():
        continue
      reader = ocdbt.Reader(db)
      for key in reader.keys():
        value = reader.stored(key)
        entries[key] = (value if isinstance(value, bytes) else
                        ocdbt.ValueRef(f"{db.name}/{value.path}",
                                       value.offset, value.length))
    ocdbt.write_root_database(state, entries)
    _write_json(state / _TREE_METADATA, _tree_metadata(self.leaves))
    _write_json(self.tmp / _META_ITEM / "metadata", self.meta)
    _write_json(self.tmp / _CHECKPOINT_METADATA, {
        "item_handlers": _HANDLERS, "metrics": {},
        "performance_metrics": {}, "init_timestamp_nsecs": self.init_ns,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
    if self.path.exists():
      shutil.rmtree(self.path)  # orbax's force=True
    os.rename(self.tmp, self.path)
    _fsync_dir(self.path.parent)


def save_sharded(checkpoints_dir: Union[str, Path], iteration: int,
                 params, opt_state, hparams: HParams) -> Path:
  """Save a train state as ``<checkpoints_dir>/<iteration>.orbax``.

  ``params`` is a params tree (numpy or tensor leaves) and ``opt_state``
  optax's Adam leaves, or a model group: a list of per-rank trees
  (the ranks' slices of each cut leaf) and a list of per-rank optax leaves.
  COLLECTIVE in a multi-process run: every process calls it at the same
  point, each writes its share of the chunks."""
  save = _Save(checkpoints_dir, iteration, params, opt_state, hparams)
  save.begin()
  ok = True
  try:
    save.write()
  except Exception:
    if process_count() == 1:
      raise
    ok = False
    logger.exception("writing this process's share of %s failed", save.path)
  return save.commit(ok)


class AsyncSaver:
  """Saves whose disk write runs on one background thread.

  ``save`` copies the state into host memory of its own before it
  returns (the caller may update its tensors and arrays at once) and
  starts the write; the next ``save``,
  ``wait()`` and ``close()`` wait for it and raise a failed write there.
  With one process the whole save, commit included, runs in the
  background; in a multi-process run the commit (a collective) runs in
  the next ``wait()``, which every process calls at the same point."""

  def __init__(self):
    self._thread: Optional[threading.Thread] = None
    self._error: Optional[BaseException] = None
    self._pending: Optional[_Save] = None

  def save(self, checkpoints_dir: Union[str, Path], iteration: int,
           params, opt_state, hparams: HParams) -> Path:
    self.wait()
    save = _Save(checkpoints_dir, iteration, params, opt_state, hparams,
                 copy=True)
    save.begin()
    self._pending = save
    self._error = None
    single = save.n_procs == 1

    def run():
      try:
        save.write()
        if single:
          save.commit()
      except BaseException as e:  # re-raised by wait()
        self._error = e

    self._thread = threading.Thread(target=run, name="orbax-save",
                                    daemon=True)
    self._thread.start()
    return save.path

  def wait(self) -> None:
    """Wait for the write in flight; raise its error."""
    if self._thread is not None:
      self._thread.join()
      self._thread = None
    save, self._pending = self._pending, None
    error, self._error = self._error, None
    if save is not None and save.n_procs > 1:
      if error is not None:
        logger.error("writing this process's share of %s failed: %s",
                     save.path, error)
      save.commit(error is None)
    if error is not None:
      raise error

  def close(self) -> None:
    self.wait()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


# -- reading ------------------------------------------------------------------

def _check(path: Union[str, Path]) -> Path:
  path = Path(path).resolve()
  if not is_orbax_checkpoint(path):
    raise ValueError(f"not an orbax checkpoint: {path}")
  return path


def read_meta(path: Union[str, Path]) -> Dict:
  """Read only the JSON metadata item: no tensor bytes are touched."""
  return json.loads((_check(path) / _META_ITEM / "metadata").read_text())


@dataclass
class OrbaxCheckpointRef:
  """A checkpoint by reference: its metadata is loaded, its tensors are
  not (``train()`` restores them with :func:`restore_sharded` on a mesh,
  :func:`restore_host` without one)."""
  path: Path
  learning_rate: float
  iteration: int
  hparams: Dict

  def get_hparams(self) -> HParams:
    hp, ignored = hparams_from_dict(self.hparams)
    if ignored:
      logger.warning("Ignored checkpoint hparams unknown to this version: "
                     "%s", ignored)
    return hp


def load_checkpoint_ref(path: Union[str, Path]) -> OrbaxCheckpointRef:
  """Metadata-only open of an orbax checkpoint."""
  path = _check(path)
  meta = read_meta(path)
  return OrbaxCheckpointRef(path=path, learning_rate=meta["learning_rate"],
                            iteration=meta["iteration"],
                            hparams=meta["hparams"])


class _StateReader:
  """The ``state`` item: its tree metadata and its OCDBT database (the
  layout the JAX package's store writes: zarr v2 in OCDBT)."""

  def __init__(self, path: Path):
    self.dir = path / _STATE_ITEM
    meta = json.loads((self.dir / _TREE_METADATA).read_text())
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
      raise ValueError(f"{self.dir}: only zarr v2 arrays in OCDBT are "
                       "supported (use_ocdbt true, use_zarr3 false)")
    self.paths: List[KeyPath] = [
        tuple((k["key"], k["key_type"]) for k in entry["key_metadata"])
        for entry in meta["tree_metadata"].values()]
    self.db = ocdbt.Reader(self.dir)

  def get(self, key: str) -> Optional[bytes]:
    k = key.encode()
    return self.db.get(k) if k in self.db else None

  def read(self, path: KeyPath, region=None):
    return zarr2.read_array(self.get, ".".join(k for k, _ in path), region)


def _tree(items: Sequence[Tuple[KeyPath, object]]):
  """Nested dicts and lists from (key path, leaf) pairs."""
  root: Dict = {}
  kinds: Dict[int, int] = {}
  for path, leaf in items:
    node = root
    for depth, (key, kind) in enumerate(path):
      kinds[id(node)] = kind
      if depth == len(path) - 1:
        node[key] = leaf
      else:
        node = node.setdefault(key, {})

  def build(node):
    if not isinstance(node, dict):
      return node
    if kinds.get(id(node)) == _SEQUENCE_KEY:
      return [build(node[str(i)]) for i in range(len(node))]
    return {k: build(v) for k, v in node.items()}

  return build(root)


def _split(items):
  params = [(p[1:], x) for p, x in items if p[0][0] == "params"]
  opt = sorted(((int(p[1][0]), x) for p, x in items if p[0][0] == "opt"),
               key=lambda t: t[0])
  return params, [x for _, x in opt]


def restore_host(path: Union[str, Path]) -> CheckpointWaveglow:
  """Restore a checkpoint into the port's checkpoint container: the
  params tree and the positional optimizer leaves as numpy arrays (a
  bfloat16 leaf as a ``torch.bfloat16`` tensor), with the saved dtypes
  and shapes."""
  path = _check(path)
  reader = _StateReader(path)
  meta = read_meta(path)
  params, opt = _split([(p, reader.read(p)) for p in reader.paths])
  return CheckpointWaveglow(state_dict=_tree(params), optimizer=opt or None,
                            learning_rate=meta["learning_rate"],
                            iteration=meta["iteration"],
                            hparams=meta["hparams"])


def _rank_region(shape: Sequence[int], spec, rank: int, model: int):
  if MODEL_AXIS not in spec or model == 1:
    return None
  dim = spec.index(MODEL_AXIS)
  if shape[dim] % model:
    raise ValueError(f"a dimension of {shape[dim]} does not split over "
                     f"{model} model ranks")
  part = shape[dim] // model
  return tuple(slice(rank * part, (rank + 1) * part) if d == dim else
               slice(0, n) for d, n in enumerate(shape))


def restore_sharded(path: Union[str, Path], mesh: Mesh
                    ) -> Tuple[List[Dict], Optional[List[List]], Dict]:
  """Restore a checkpoint onto ``mesh``'s model ranks, in the layout of
  ``parallel.sharding.shard_trainable_params``: ``(rank_params, rank_opt,
  meta)``, where ``rank_params[r]`` is rank r's params tree (its slice of
  each cut leaf, the replicated leaves whole and shared by the rank trees)
  and ``rank_opt[r]`` its optax-layout Adam leaves (None without an
  optimizer state). Each rank reads only the chunks its slices overlap.
  The trees feed ``parallel.sharding.place_trainable_params``."""
  from waveglow_tpu_torch.parallel.sharding import leaf_specs
  path = _check(path)
  reader = _StateReader(path)
  meta = read_meta(path)
  model = mesh.devices.reshape(mesh.devices.shape[0], -1).shape[1]
  skeleton = _tree([(p[1:], None) for p in reader.paths
                    if p[0][0] == "params"])
  specs = leaf_specs(skeleton)
  param_paths = [(("params", _DICT_KEY),) + p for p, _ in
                 _key_paths(skeleton)]
  opt_paths = sorted((p for p in reader.paths if p[0][0] == "opt"),
                     key=lambda p: int(p[1][0]))
  if opt_paths and len(opt_paths) != 1 + 2 * len(specs):
    raise ValueError(f"{path}: {len(opt_paths)} optimizer leaves, expected "
                     f"{1 + 2 * len(specs)}")

  def read_ranks(paths, specs_of_paths):
    columns = []
    for p, spec in zip(paths, specs_of_paths):
      shape = zarr2.shape_of(reader.get, ".".join(k for k, _ in p))
      if MODEL_AXIS not in spec or model == 1:
        whole = reader.read(p)
        columns.append([whole] * model)
      else:
        columns.append([reader.read(p, _rank_region(shape, spec, r, model))
                        for r in range(model)])
    return [list(c) for c in zip(*columns)] if columns else [[]] * model

  rank_leaves = read_ranks(param_paths, specs)
  from waveglow_tpu_torch.checkpointing.from_jax import tree_unflatten
  rank_params = [tree_unflatten(skeleton, leaves) for leaves in rank_leaves]
  rank_opt = (read_ranks(opt_paths, [()] + specs + specs) if opt_paths
              else None)
  return rank_params, rank_opt, meta
