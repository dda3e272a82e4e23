"""The port's orbax checkpoint store against the real libraries: its zstd
decoder against ``zstandard``, its OCDBT databases against TensorStore's
OCDBT kvstore (each reads what the other writes), and its checkpoints
against the JAX package's orbax store (each restores what the other
saves, bit for bit); then ``train()`` with ``checkpoint_backend="orbax"``
and ``checkpoint_async``, a model = 2 mesh's sharded save and restore,
a torn directory and failed writes.

None of the port's modules imports orbax, TensorStore, ``zstandard`` or
jax (``tests/test_torch_imports.py``); the tests use them as references.
Inputs are seeded numpy draws; models are tiny (2 flows of 2 layers, 32
channels, ``end`` convs randomised).
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from waveglow_tpu.checkpointing import orbax_store as jax_orbax
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import init_params
from waveglow_tpu.parallel import mesh as jax_mesh
from waveglow_tpu.parallel.sharding import shard_params as jax_shard_params
from waveglow_tpu.training import loop as jax_loop
from waveglow_tpu.training.step import make_optimizer as jax_optimizer
from waveglow_tpu_torch import native
from waveglow_tpu_torch.checkpointing import (get_all_iterations_any,
                                              get_last_checkpoint_any,
                                              load_checkpoint_any,
                                              load_checkpoint_lazy, ocdbt,
                                              orbax_store, zarr2, zstd_frames)
from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.checkpointing.store import (CheckpointWaveglow,
                                                    flatten_tree)
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.parallel.mesh import make_mesh
from waveglow_tpu_torch.parallel.sharding import (place_trainable_params,
                                                  rank_trees_to_numpy,
                                                  shard_trainable_params)
from waveglow_tpu_torch.training.loop import train
from tests.test_torch_training import (LOOP_HPARAMS, assert_states_close,
                                       to_jax_entries, write_speech_dataset)

FIXTURE = Path(__file__).parent / "data" / "orbax_tiny"
TINY = {"n_flows": "2", "n_layers": "2", "n_channels": "32",
        "segment_length": "2048", "batch_size": "2"}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def tiny_state(seed=0):
  """(params, optax leaves, port hparams): a tiny model with random ``end``
  convs and a nonzero Adam state (count 5)."""
  hp = jax_overwrite(JaxHParams(), TINY)
  params = init_params(JaxConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 1)
  for flow in params["flows"]:
    for k in ("w", "b"):
      flow["wn"]["end"][k] = (rng.standard_normal(
          flow["wn"]["end"][k].shape) * 0.05).astype(np.float32)
  leaves = tree_leaves(params)
  opt = ([np.asarray(5, np.int32)]
         + [(rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
            for x in leaves]
         + [np.abs(rng.standard_normal(x.shape) * 1e-6).astype(np.float32)
            for x in leaves])
  return params, opt, overwrite_custom_hparams(HParams(), TINY)


def assert_same_checkpoint(a, b):
  """Equal trees, optimizer leaves and metadata: same dtypes, shapes, bits."""
  fa, fb = flatten_tree(a.state_dict), flatten_tree(b.state_dict)
  assert set(fa) == set(fb)
  for k in fa:
    x, y = np.asarray(fa[k]), np.asarray(fb[k])
    assert x.dtype == y.dtype and x.shape == y.shape, k
    assert x.tobytes() == y.tobytes(), k
  assert (a.optimizer is None) == (b.optimizer is None)
  for x, y in zip(a.optimizer or [], b.optimizer or []):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert x.tobytes() == y.tobytes()
  assert len(a.optimizer or []) == len(b.optimizer or [])
  assert (a.iteration, a.learning_rate, a.hparams) == (
      b.iteration, b.learning_rate, b.hparams)


# -- zstd ---------------------------------------------------------------------

def zstd_content(size, seed=0):
  """Seeded bytes that exercise every block kind: f32 noise (Huffman
  literals), a repeated phrase (matches, repeat offsets) and zero runs."""
  rng = np.random.default_rng(seed)
  parts = [(rng.standard_normal(size // 8 + 1) * 0.02).astype(np.float32)
           .tobytes(),
           b"".join(b"waveglow flow %d layer %d " % (i % 12, i % 7)
                    for i in range(size // 20 + 1)),
           bytes(size // 8 + 1),
           rng.integers(0, 6, size // 4 + 1, dtype=np.uint8).tobytes()]
  return b"".join(parts)[:size]


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "xxh64"])
@pytest.mark.parametrize("size", [0, 1, 777, 70_001, 1_000_000])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_decoder_equals_zstandard(level, size, checksum):
  data = zstd_content(size, seed=size + level)
  frame = zstandard.ZstdCompressor(level=level,
                                   write_checksum=checksum).compress(data)
  assert native.zstd_decompress(frame).tobytes() == data
  out = np.empty(size, np.uint8)
  native.zstd_decompress(frame, out)
  assert out.tobytes() == data


@pytest.mark.parametrize("level", [1, 3])
def test_zstd_decoder_eight_megabytes(level):
  data = zstd_content(8 << 20, seed=level)
  frame = zstandard.ZstdCompressor(level=level,
                                   write_checksum=True).compress(data)
  assert native.zstd_decompress(frame).tobytes() == data


def test_zstd_streams_frames_and_skippable_frames():
  """A streamed frame (no content size, as TensorStore writes them), a
  skippable frame and a second frame in one buffer decode as one."""
  a, b = zstd_content(300_000, 1), zstd_content(5_000, 2)
  comp = zstandard.ZstdCompressor(level=3, write_content_size=False)
  stream = comp.compressobj()
  first = stream.compress(a) + stream.flush()
  skip = (0x184D2A53).to_bytes(4, "little") + (6).to_bytes(4, "little") + (
      b"ignore")
  second = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(b)
  assert native.zstd_decompress(first + skip + second).tobytes() == a + b
  assert native.crc32c(b"123456789") == 0xE3069283


def corruptions(frame):
  frame = bytearray(frame)
  flipped = bytearray(frame)
  flipped[len(frame) // 2] ^= 0x20
  return {
      "flipped": bytes(flipped),
      "checksum": bytes(frame[:-1] + bytes([frame[-1] ^ 1])),
      "truncated": bytes(frame[:-9]),
      "magic": b"\x29" + bytes(frame[1:]),
      "trailing": bytes(frame) + b"\x01\x02\x03",
      "empty": b"",
  }


@pytest.mark.parametrize("kind", ["flipped", "checksum", "truncated",
                                  "magic", "trailing", "empty"])
def test_zstd_raises_on_a_corrupt_frame(kind):
  """A corrupt frame raises ``ValueError``; nothing is returned, and a
  caller's buffer is never said to be filled."""
  data = zstd_content(200_000, 3)
  frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
  bad = corruptions(frame)[kind]
  with pytest.raises(ValueError, match="zstd"):
    native.zstd_decompress(bad)
  with pytest.raises(ValueError, match="zstd"):
    native.zstd_decompress(bad, np.empty(len(data), np.uint8))


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65_791, 65_792, 131_072,
                                  131_073, 400_000])
def test_raw_frames_read_by_zstandard(size):
  data = zstd_content(size, 7)
  frame = zstd_frames.compress_raw(data)
  blocks = max(1, -(-size // zstd_frames.BLOCK_MAX))
  assert len(frame) == len(zstd_frames.frame_header(size)) + 3 * blocks + size
  params = zstandard.get_frame_parameters(frame)
  assert params.content_size == size and not params.has_checksum
  assert zstandard.ZstdDecompressor().decompress(frame) == data
  assert native.zstd_decompress(frame).tobytes() == data


def test_zstd_library_without_a_compiler_raises(tmp_path, monkeypatch):
  monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(native, "_ZSTD_LIB", None)
  monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
  with pytest.raises(RuntimeError, match="zstd.cpp"):
    native.zstd_decompress(zstd_frames.compress_raw(b"abc"))
  assert not (tmp_path / "build").exists()


# -- OCDBT --------------------------------------------------------------------

def ocdbt_spec(db, config=None):
  """TensorStore's spec of the OCDBT kvstore at ``db`` (from its URL form),
  with ``config`` when given."""
  spec = ts.KvStore.Spec(f"file://{db}/|ocdbt:").to_json()
  if config is not None:
    spec["config"] = config
  return spec


def tensorstore_items(db):
  kv = ts.KvStore.open(ocdbt_spec(db)).result()
  return {k: bytes(kv.read(k).result().value) for k in kv.list().result()}


def random_values(n, seed):
  rng = np.random.default_rng(seed)
  return {(b"leaf.%03d/" % i) + (b"0.0" if i % 3 else b".zarray"):
          rng.integers(0, 256, int(rng.integers(0, 3000)), np.uint8).tobytes()
          for i in range(n)}


@pytest.mark.parametrize("zstd_level", [0, None], ids=["zstd", "raw"])
@pytest.mark.parametrize("node_bytes", [100_000_000, 400],
                         ids=["one-leaf", "tree"])
def test_port_ocdbt_read_by_tensorstore(tmp_path, node_bytes, zstd_level):
  values = random_values(80, seed=node_bytes % 7)
  config = ocdbt.Config(max_decoded_node_bytes=node_bytes,
                        zstd_level=zstd_level)
  ocdbt.write_database(tmp_path / "db", values, config)
  reader = ocdbt.Reader(tmp_path / "db")
  assert (reader.version.height == 0) == (node_bytes > 1_000_000)
  assert tensorstore_items(tmp_path / "db") == values
  assert {k: reader.get(k) for k in reader.keys()} == values


@pytest.mark.parametrize("config", [
    {},
    {"compression": None, "max_decoded_node_bytes": 300},
    {"compression": {"id": "zstd", "level": 9},
     "max_decoded_node_bytes": 500, "max_inline_value_bytes": 64},
], ids=["default", "raw-small-nodes", "zstd9-small-nodes"])
def test_tensorstore_ocdbt_read_by_port(tmp_path, config):
  values = random_values(60, seed=3)
  kv = ts.KvStore.open(ocdbt_spec(tmp_path, config)).result()
  with ts.Transaction() as txn:
    for k, v in values.items():
      kv.with_transaction(txn)[k] = v
  kv["late"] = b"a second version"  # the newest version is read
  values[b"late"] = b"a second version"
  reader = ocdbt.Reader(tmp_path)
  assert {k: reader.get(k) for k in reader.keys()} == values


def test_ocdbt_checks_the_crc(tmp_path):
  ocdbt.write_database(tmp_path, {b"a": b"x" * 2000})
  manifest = tmp_path / ocdbt.MANIFEST_NAME
  data = bytearray(manifest.read_bytes())
  data[20] ^= 1
  manifest.write_bytes(bytes(data))
  with pytest.raises(ValueError, match="CRC-32C"):
    ocdbt.Reader(tmp_path)


# -- zarr ---------------------------------------------------------------------

def test_zarr_region_reads_only_overlapping_chunks():
  rng = np.random.default_rng(0)
  full = rng.standard_normal((6, 8)).astype(np.float32)
  pieces = {(i, j): full[i * 3:(i + 1) * 3, j * 4:(j + 1) * 4]
            for i in range(2) for j in range(2) if (i, j) != (1, 1)}
  store = {k.decode(): (b"".join(bytes(p) for p in v) if isinstance(v, list)
                        else bytes(v))
           for k, v in zarr2.array_values("w", (6, 8), (3, 4), "<f4",
                                          pieces).items()}
  asked = []

  def get(key):
    asked.append(key)
    return store.get(key)

  want = full.copy()
  want[3:, 4:] = 0  # a missing chunk reads as the fill value
  np.testing.assert_array_equal(zarr2.read_array(get, "w"), want)
  asked.clear()
  np.testing.assert_array_equal(
      zarr2.read_array(get, "w", (slice(0, 3), slice(2, 6))), full[:3, 2:6])
  assert sorted(asked) == ["w/.zarray", "w/0.0", "w/0.1"]
  bf16 = torch.randn(3, 5).to(torch.bfloat16)
  store = {k.decode(): b"".join(bytes(p) for p in v) if isinstance(v, list)
           else bytes(v) for k, v in zarr2.array_values(
               "b", (3, 5), (3, 5), "bfloat16", {(0, 0): bf16}).items()}
  assert json.loads(store["b/.zarray"])["dtype"] == "bfloat16"
  assert torch.equal(zarr2.read_array(store.get, "b"), bf16)


# -- checkpoints across the packages ------------------------------------------

def test_restore_host_of_a_jax_save_equals_jax_restore(tmp_path):
  """A checkpoint the JAX package's orbax store saves (jax.Array params
  and optimizer leaves, zstd by TensorStore) restores through the port
  equal to the JAX ``restore_host``, bit for bit."""
  params, opt, _ = tiny_state(seed=1)
  hp = jax_overwrite(JaxHParams(), TINY)
  jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
  opt_state = jax_optimizer(hp.learning_rate).init(jparams)
  treedef = jax.tree_util.tree_structure(opt_state)
  opt_state = jax.tree_util.tree_unflatten(
      treedef, [jax.numpy.asarray(x) for x in opt])
  path = jax_orbax.save_sharded(tmp_path, 9, jparams, opt_state, hp)
  assert_same_checkpoint(orbax_store.restore_host(path),
                         jax_orbax.restore_host(path))
  ref = orbax_store.load_checkpoint_ref(path)
  assert ref.iteration == 9 and ref.get_hparams().n_channels == 32
  assert orbax_store.read_meta(path)["format_version"] == 1


def test_fixture_equals_jax_restore_and_its_numpy_copy():
  """The committed fixture (``tests/data/make_orbax_tiny.py``): the port
  reads it equal to the JAX ``restore_host`` and to its npz copy."""
  path = FIXTURE / "7.orbax"
  port = orbax_store.restore_host(path)
  assert_same_checkpoint(port, jax_orbax.restore_host(path))
  assert_same_checkpoint(port, CheckpointWaveglow.load(FIXTURE / "7.npz"))
  size = sum(p.stat().st_size for p in path.rglob("*") if p.is_file())
  assert size < 200_000


def test_port_save_restored_by_jax(tmp_path):
  """The port's save restores through the JAX ``restore_host`` equal to
  the state saved, and the port reads its own save back the same."""
  params, opt, hp = tiny_state(seed=2)
  path = orbax_store.save_sharded(tmp_path, 4, params, opt, hp)
  assert path == (tmp_path / "4.orbax").resolve()
  mine = CheckpointWaveglow(state_dict=params, optimizer=opt,
                            learning_rate=hp.learning_rate, iteration=4,
                            hparams=json.loads(json.dumps(
                                orbax_store.read_meta(path)["hparams"])))
  assert_same_checkpoint(jax_orbax.restore_host(path), mine)
  assert_same_checkpoint(orbax_store.restore_host(path), mine)
  assert sorted(p.name for p in path.iterdir()) == [
      "_CHECKPOINT_METADATA", "meta", "state"]
  state = path / "state"
  assert (state / "ocdbt.process_0" / "manifest.ocdbt").is_file()
  keys = tensorstore_items(state)
  reader = ocdbt.Reader(state)
  assert set(keys) == set(reader.keys())
  assert all(keys[k] == reader.get(k) for k in keys)


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_save_restored_by_jax_and_restore_sharded(tmp_path, model):
  """A model group's save (each cut leaf's chunks are the ranks' slices):
  the JAX ``restore_host`` reads the whole state, the JAX
  ``restore_sharded`` places it on a (1, model) mesh, and the port's
  ``restore_sharded`` gives each rank its slices (reading only its
  chunks) at either model size."""
  params, opt, hp = tiny_state(seed=3)
  mesh = make_mesh(1, model, devices=["cpu"] * model)
  n = len(tree_leaves(params))

  def rank_slices(leaves):
    """Each rank's slices of a params-shaped tree of ``leaves``."""
    return [tree_leaves(t) for t in rank_trees_to_numpy(
        shard_trainable_params(_like(params, leaves), mesh)[0])]

  ranks = rank_trees_to_numpy(shard_trainable_params(params, mesh)[0])
  rank_opt = [[opt[0]] + mu + nu for mu, nu in zip(
      rank_slices(opt[1:1 + n]), rank_slices(opt[1 + n:]))]
  full_opt = list(opt)
  path = orbax_store.save_sharded(tmp_path, 6, ranks, rank_opt, hp)
  whole = CheckpointWaveglow(state_dict=params, optimizer=full_opt,
                             learning_rate=hp.learning_rate, iteration=6,
                             hparams=orbax_store.read_meta(path)["hparams"])
  assert_same_checkpoint(jax_orbax.restore_host(path), whole)
  assert_same_checkpoint(orbax_store.restore_host(path), whole)
  zarray = ocdbt.Reader(path / "state").get(
      b"params.flows.0.wn.in_layers.0.v/.zarray")
  assert json.loads(zarray)["chunks"][-1] == 32 // model

  for other in (model, 2 if model == 4 else 4, 1):
    got, got_opt, meta = orbax_store.restore_sharded(
        path, make_mesh(1, other, devices=["cpu"] * other))
    want = rank_trees_to_numpy(shard_trainable_params(
        params, make_mesh(1, other, devices=["cpu"] * other))[0])
    assert meta["iteration"] == 6 and len(got) == other
    for g, w in zip(got, want):
      for a, b in zip(tree_leaves(g), tree_leaves(w)):
        np.testing.assert_array_equal(a, b)
    assert len(got_opt) == other and int(got_opt[0][0]) == 5

  jax_template = jax_shard_params(params, jax_mesh.make_mesh(data=1,
                                                             model=model))
  r_params, r_opt, meta = jax_orbax.restore_sharded(
      path, jax_template, jax_optimizer(hp.learning_rate))
  assert meta["iteration"] == 6
  for a, b in zip(jax.tree_util.tree_leaves(r_params), tree_leaves(params)):
    np.testing.assert_array_equal(np.asarray(a), b)
  for a, b in zip(jax.tree_util.tree_leaves(r_opt), full_opt):
    np.testing.assert_array_equal(np.asarray(a), b)


def _like(params, leaves):
  """A tree shaped like ``params`` holding ``leaves``."""
  from waveglow_tpu_torch.checkpointing.from_jax import tree_unflatten
  return tree_unflatten(params, list(leaves))


# -- train() ------------------------------------------------------------------

ORBAX_LOOP = dict(LOOP_HPARAMS, iters_per_checkpoint="2",
                  checkpoint_backend="orbax", checkpoint_async="true")


def test_train_orbax_async_resumes_to_the_straight_run(tmp_path):
  """``train()`` with the orbax backend and async saves: 4 straight steps
  (saves at 1, 2 and 4, each whole when train() returns), and a resume
  from the lazily opened ``2.orbax`` to step 4, equal to the straight run
  bit for bit; the JAX ``train()`` resumed from the port's ``2.orbax``
  matches within ``assert_states_close``'s bounds."""
  entries = write_speech_dataset(tmp_path / "data")
  straight = train(ORBAX_LOOP, None, entries, entries, tmp_path / "ck",
                   max_iterations=4, device="cpu")
  assert get_all_iterations_any(tmp_path / "ck") == [1, 2, 4]
  last, it = get_last_checkpoint_any(tmp_path / "ck")
  assert it == 4 and last.name == "4.orbax"
  saved = orbax_store.restore_host(last)
  for a, b in zip(tree_leaves(saved.state_dict),
                  tree_leaves(straight["params"])):
    np.testing.assert_array_equal(a, b)
  assert saved.get_hparams().checkpoint_async is True

  ref = load_checkpoint_lazy(tmp_path / "ck" / "2.orbax")
  assert isinstance(ref, orbax_store.OrbaxCheckpointRef)
  resumed = train(None, None, entries, entries, tmp_path / "ck2",
                  checkpoint=ref, max_iterations=4, device="cpu")
  assert resumed["step"] == 4
  for a, b in zip(tree_leaves(resumed["params"]),
                  tree_leaves(straight["params"])):
    np.testing.assert_array_equal(a, b)
  for a, b in zip(resumed["opt_state"], straight["opt_state"]):
    np.testing.assert_array_equal(a, b)

  jax_entries = to_jax_entries(entries)
  jax_resumed = jax_loop.train(
      None, None, jax_entries, jax_entries, tmp_path / "jax",
      checkpoint=jax_orbax.load_checkpoint_ref(tmp_path / "ck" / "2.orbax"),
      max_iterations=4)
  assert_states_close(resumed, jax_resumed)
  assert jax_orbax.restore_host(tmp_path / "jax" / "4.orbax").iteration == 4


def test_model2_mesh_saves_shards_and_resumes(tmp_path):
  """On a (1, 2) logical mesh the orbax save writes each cut leaf as the
  ranks' two chunks; resumed on the mesh (``restore_sharded``) and without
  one (``restore_host``), the two runs agree."""
  entries = write_speech_dataset(tmp_path / "data")
  custom = dict(ORBAX_LOOP, mesh_model="2", checkpoint_async="false")
  first = train(custom, None, entries, entries, tmp_path / "ck",
                max_iterations=2, device="cpu", mesh_devices=["cpu"] * 2)
  path = tmp_path / "ck" / "2.orbax"
  reader = ocdbt.Reader(path / "state")
  assert b"params.flows.0.wn.in_layers.0.v/0.0.0.1" in reader
  for a, b in zip(tree_leaves(orbax_store.restore_host(path).state_dict),
                  tree_leaves(first["params"])):
    np.testing.assert_array_equal(a, b)
  on_mesh = train({"mesh_model": "2"}, None, entries, entries,
                  tmp_path / "m", checkpoint=load_checkpoint_lazy(path),
                  max_iterations=4, device="cpu", mesh_devices=["cpu"] * 2)
  flat = train({"mesh_model": "1"}, None, entries, entries, tmp_path / "u",
               checkpoint=load_checkpoint_lazy(path), max_iterations=4,
               device="cpu")
  for a, b in zip(tree_leaves(on_mesh["params"]), tree_leaves(flat["params"])):
    np.testing.assert_allclose(a, b, atol=1e-6)
  placed = place_trainable_params(
      orbax_store.restore_sharded(path, make_mesh(1, 2, ["cpu"] * 2))[0],
      make_mesh(1, 2, ["cpu"] * 2))
  assert placed[0][0]["flows"][0]["wn"]["start"]["v"] is \
      placed[0][1]["flows"][0]["wn"]["start"]["v"]


def test_torn_and_temporary_directories_are_not_checkpoints(tmp_path):
  params, opt, hp = tiny_state()
  orbax_store.save_sharded(tmp_path, 100, params, opt, hp)
  torn = tmp_path / "200.orbax"
  (torn / "meta").mkdir(parents=True)  # no state item
  tmp = tmp_path / f"300.orbax{orbax_store.TMP_SUFFIX}"
  (tmp / "state").mkdir(parents=True)  # a save that died before its commit
  assert orbax_store.get_all_orbax_iterations(tmp_path) == [100]
  assert get_all_iterations_any(tmp_path) == [100]
  assert jax_orbax.get_all_orbax_iterations(tmp_path) == [100]
  path, it = get_last_checkpoint_any(tmp_path)
  assert it == 100 and load_checkpoint_any(path).iteration == 100
  with pytest.raises(ValueError, match="not an orbax checkpoint"):
    orbax_store.restore_host(torn)


def test_async_failure_surfaces_and_the_last_good_save_survives(tmp_path):
  """The checkpoints folder turns into a file after a good save: the next
  async save raises (at ``wait`` at the latest), and the good save still
  restores and is still found."""
  params, opt, hp = tiny_state()
  ckpts = tmp_path / "ckpts"
  saver = orbax_store.AsyncSaver()
  good = saver.save(ckpts, 1, params, opt, hp)
  saver.wait()
  assert orbax_store.is_orbax_checkpoint(good)
  moved = tmp_path / "moved"
  shutil.move(ckpts, moved)
  ckpts.write_text("not a directory")
  with pytest.raises(OSError):
    saver.save(ckpts, 2, params, opt, hp)
    saver.wait()
  saver.close()  # nothing in flight: returns
  back = orbax_store.restore_host(moved / "1.orbax")
  assert back.iteration == 1
  for a, b in zip(tree_leaves(back.state_dict), tree_leaves(params)):
    np.testing.assert_array_equal(a, b)
  assert get_last_checkpoint_any(moved)[1] == 1


def test_a_failed_write_in_the_background_raises_at_wait(tmp_path,
                                                        monkeypatch):
  params, opt, hp = tiny_state()

  def broken(*args, **kwargs):
    raise OSError("disk full")

  monkeypatch.setattr(ocdbt, "write_database", broken)
  with orbax_store.AsyncSaver() as saver:
    path = saver.save(tmp_path, 3, params, opt, hp)
    with pytest.raises(OSError, match="disk full"):
      saver.wait()
  assert not orbax_store.is_orbax_checkpoint(path)
  assert orbax_store.get_all_orbax_iterations(tmp_path) == []


def test_train_raises_a_failed_async_write(tmp_path, monkeypatch):
  """The disk breaks between two scheduled async saves (every write after
  the first fails): ``train()`` raises the failure, and the earlier
  checkpoint still restores and is the newest one found."""
  entries = write_speech_dataset(tmp_path / "data")
  ckpt_dir = tmp_path / "ckpts"
  real_write = ocdbt.write_database
  writes = []

  def breaking(*args, **kwargs):
    writes.append(args[0])
    if len(writes) > 1:
      raise OSError("disk broke")
    return real_write(*args, **kwargs)

  monkeypatch.setattr(ocdbt, "write_database", breaking)
  custom = dict(ORBAX_LOOP, iters_per_checkpoint="1")
  with pytest.raises(OSError, match="disk broke"):
    train(custom, None, entries, entries, ckpt_dir, max_iterations=6,
          device="cpu")
  assert len(writes) == 2  # the failure surfaced at the next save
  good = ckpt_dir / "1.orbax"
  assert orbax_store.restore_host(good).iteration == 1
  assert get_last_checkpoint_any(ckpt_dir) == (good.resolve(), 1)


MULTI_WORKER = """
import sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, {repo!r})
from waveglow_tpu_torch.checkpointing import orbax_store
from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, init_params
from waveglow_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from waveglow_tpu_torch.parallel.sharding import (rank_trees_to_numpy,
                                                  shard_trainable_params)

rank, port, out = sys.argv[1:4]
initialize_multihost(f"127.0.0.1:{{port}}", 2, int(rank), backend="gloo",
                     timeout_s=120)
hp = overwrite_custom_hparams(HParams(), {tiny!r})
params = init_params(WaveGlowConfig.from_hparams(hp), seed=4)
opt = [np.asarray(2, np.int32)] + [np.full_like(x, 0.5) for x in
                                   tree_leaves(params)] * 2
mesh = make_mesh(1, 2, devices=["cpu"] * 2)
ranks = rank_trees_to_numpy(shard_trainable_params(params, mesh)[0])
rank_opt = [[opt[0]] + [np.full_like(x, 0.5) for x in tree_leaves(t)] * 2
            for t in ranks]
orbax_store.save_sharded(out, 1, ranks, rank_opt, hp)
saver = orbax_store.AsyncSaver()
saver.save(out, 2, params, opt, hp)
saver.wait()
dist.barrier()
dist.destroy_process_group()  # no peer leaves while another still talks
print("RESULT ok")
"""


def test_two_processes_write_their_shares(tmp_path):
  """Two processes (gloo on the CPU) save one model = 2 state, sync and
  async: each writes its share of the chunks into its own
  ``ocdbt.process_<rank>`` database, process 0 the root database past the
  barrier, and both the port and the JAX package read the whole state
  back."""
  import socket
  import subprocess
  import sys
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
  script = tmp_path / "worker.py"
  script.write_text(MULTI_WORKER.format(
      repo=str(Path(__file__).resolve().parents[1]), tiny=TINY))
  procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port),
                             str(tmp_path / "ck")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
           for r in range(2)]
  try:
    outs = [p.communicate(timeout=240) for p in procs]
  finally:
    for p in procs:
      p.kill()
  for p, (out, err) in zip(procs, outs):
    assert p.returncode == 0 and "RESULT ok" in out, err[-3000:]
  hp = overwrite_custom_hparams(HParams(), TINY)
  from waveglow_tpu_torch.models.waveglow import (WaveGlowConfig as Config,
                                                  init_params as port_init)
  params = port_init(Config.from_hparams(hp), seed=4)
  for it in (1, 2):
    path = tmp_path / "ck" / f"{it}.orbax"
    for reader in (orbax_store.restore_host, jax_orbax.restore_host):
      back = reader(path)
      assert back.iteration == it
      for a, b in zip(tree_leaves(back.state_dict), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
      assert int(np.asarray(back.optimizer[0])) == 2
      assert all(np.all(np.asarray(x) == 0.5) for x in back.optimizer[1:])
    dbs = sorted(p.name for p in (path / "state").iterdir()
                 if p.name.startswith(orbax_store.PROCESS_PREFIX))
    assert dbs == ["ocdbt.process_0", "ocdbt.process_1"]
    shares = [len(ocdbt.Reader(path / "state" / db).keys()) for db in dbs]
    assert min(shares) > 0
    assert sum(shares) == len(ocdbt.Reader(path / "state").keys())


def test_cli_reads_an_orbax_checkpoint_like_its_npz_twin(tmp_path):
  """``validate`` over a folder holding an orbax checkpoint and
  ``synthesize`` from its directory write the same files, byte for byte,
  as over the npz of the same state."""
  from dataclasses import asdict
  from tests.test_torch_cli_train import write_noise_dataset
  from waveglow_tpu_torch.cli import main as cli
  params, opt, hp = tiny_state(seed=6)
  orbax_store.save_sharded(tmp_path / "orbax", 3, params, opt, hp)
  CheckpointWaveglow(params, opt, hp.learning_rate, 3, asdict(hp)).save(
      tmp_path / "npz" / "3.npz")
  write_noise_dataset(tmp_path / "val", n=1, seed=2)
  (tmp_path / "mels").mkdir()
  np.save(tmp_path / "mels" / "a.npy", np.random.default_rng(0).uniform(
      -11, 1, (80, 30)).astype(np.float32))
  checkpoints = {"orbax": tmp_path / "orbax" / "3.orbax",
                 "npz": tmp_path / "npz" / "3.npz"}
  for name, ckpt in checkpoints.items():
    log = ["--device", "cpu", "--log", str(tmp_path / "cli.log")]
    assert cli.run(["validate", str(ckpt.parent), str(tmp_path / f"v_{name}"),
                    str(tmp_path / "val"), "--full-run", "--custom-seed",
                    "5", *log]) == 0
    assert cli.run(["synthesize", str(ckpt), str(tmp_path / "mels"), "-out",
                    str(tmp_path / f"s_{name}"), "--custom-seed", "5",
                    *log]) == 0
  for folder in ("v_{}/3/utt0/inferred_denoised.wav", "s_{}/a.wav"):
    a = (tmp_path / folder.format("orbax")).read_bytes()
    assert a == (tmp_path / folder.format("npz")).read_bytes()
