"""An OCDBT key-value database, read and written without TensorStore.

OCDBT ("optionally cooperative distributed B+tree") is the key-value
layout orbax checkpoints keep their arrays in. A database is a directory:

* ``manifest.ocdbt``: the config and the version tree. With the
  ``"single"`` manifest kind, the newest versions sit inline in the
  manifest; each names its B-tree's root node.
* ``d/<hex>``: data files holding B-tree nodes and values stored out of
  line. A node refers to a data file by a path relative to the database
  (``base_path`` + ``relative_path``), so the root database of an orbax
  checkpoint points into ``ocdbt.process_<i>/d/``.

Every manifest and node is framed the same way: a big-endian 32-bit magic,
the whole length as a little-endian u64, the format version and the
compression as varints, the payload (zstd-compressed when the config says
so) and a little-endian CRC-32C of all the bytes before it. Integers in
payloads are LEB128 varints unless stated; lists are stored column by
column; keys are prefix-compressed against the key before them. Leaf
entries hold their value inline or as (data file, offset, length);
interior entries hold a child's first key, the length of the prefix all
keys below it share (which the child's keys omit) and the child's node
reference and statistics.

:class:`Reader` opens the newest version and lists and reads keys.
:func:`write_database` writes one version: values larger than the config's
``max_inline_value_bytes`` go into one data file with the nodes after
them, in one leaf or, when ``max_decoded_node_bytes`` needs it, a tree of
nodes; payloads are zstd frames of raw blocks where the config says zstd.
:func:`write_root_database` writes a database whose out-of-line values
stay where other databases put them (orbax's per-process layout).
"""

from __future__ import annotations

import os
import struct
import time
import uuid as uuid_lib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from waveglow_tpu_torch import native
from waveglow_tpu_torch.checkpointing import zstd_frames

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
MANIFEST_NAME = "manifest.ocdbt"
DATA_DIR = "d"
_NO_OFFSET = (1 << 64) - 1  # the root reference of an empty tree


@dataclass
class Config:
  """A database's config (the manifest's first field). The defaults are
  the settings orbax gives every database it writes."""
  uuid: bytes = field(default_factory=lambda: uuid_lib.uuid4().bytes)
  manifest_kind: int = 0            # 0: "single", 1: "numbered"
  max_inline_value_bytes: int = 1024
  max_decoded_node_bytes: int = 100_000_000
  version_tree_arity_log2: int = 4
  zstd_level: Optional[int] = 0     # None: no compression


@dataclass(frozen=True)
class ValueRef:
  """A value stored out of line: ``length`` bytes at ``offset`` of the
  data file at ``path`` (relative to the database directory)."""
  path: str
  offset: int
  length: int


Value = Union[bytes, ValueRef]


# -- encoding primitives -------------------------------------------------------

class _Cursor:

  def __init__(self, data: bytes, what: str):
    self.data = data
    self.pos = 0
    self.what = what

  def fail(self, msg: str):
    raise ValueError(f"OCDBT {self.what}: {msg}")

  def varint(self) -> int:
    result = shift = 0
    while True:
      if self.pos >= len(self.data):
        self.fail("truncated varint")
      b = self.data[self.pos]
      self.pos += 1
      result |= (b & 0x7F) << shift
      if b < 0x80:
        return result
      shift += 7
      if shift > 63:
        self.fail("varint too long")

  def varints(self, n: int) -> List[int]:
    return [self.varint() for _ in range(n)]

  def take(self, n: int) -> bytes:
    if self.pos + n > len(self.data):
      self.fail("truncated payload")
    out = self.data[self.pos:self.pos + n]
    self.pos += n
    return out

  def u8(self) -> int:
    return self.take(1)[0]


def _varint(value: int) -> bytes:
  out = bytearray()
  while True:
    b = value & 0x7F
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
  return b"".join(_varint(v) for v in values)


def _unframe(data: bytes, magic: int, what: str) -> bytes:
  """Check a manifest's or node's framing and checksum; its payload."""
  if len(data) < 18:
    raise ValueError(f"OCDBT {what}: {len(data)} bytes is too short")
  got_magic, length = struct.unpack_from(">I", data)[0], \
      struct.unpack_from("<Q", data, 4)[0]
  if got_magic != magic:
    raise ValueError(f"OCDBT {what}: magic {got_magic:#010x}, "
                     f"expected {magic:#010x}")
  if length != len(data):
    raise ValueError(f"OCDBT {what}: header says {length} bytes, "
                     f"have {len(data)}")
  crc = struct.unpack_from("<I", data, len(data) - 4)[0]
  if native.crc32c(memoryview(data)[:-4]) != crc:
    raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
  cur = _Cursor(data, what)
  cur.pos = 12
  version = cur.varint()
  if version != FORMAT_VERSION:
    cur.fail(f"format version {version} is not supported")
  compression = cur.varint()
  body = data[cur.pos:-4]
  if compression == 0:
    return bytes(body)
  if compression == 1:
    return native.zstd_decompress(body).tobytes()
  cur.fail(f"unknown compression format {compression}")


def _frame(payload: bytes, magic: int, zstd: bool) -> bytes:
  body = zstd_frames.compress_raw(payload) if zstd else payload
  head = struct.pack(">I", magic) + struct.pack(
      "<Q", 12 + 2 + len(body) + 4) + _varint(FORMAT_VERSION) + _varint(
          1 if zstd else 0)
  framed = head + body
  return framed + struct.pack("<I", native.crc32c(framed))


def _read_data_file_table(cur: _Cursor) -> List[str]:
  n = cur.varint()
  prefix = [0] + cur.varints(n - 1) if n else []
  suffix = cur.varints(n)
  base = cur.varints(n)
  paths, prev = [], b""
  for i in range(n):
    if prefix[i] > len(prev):
      cur.fail("data file path prefix longer than the path before it")
    full = prev[:prefix[i]] + cur.take(suffix[i])
    if base[i] > len(full):
      cur.fail("data file base path longer than the path")
    paths.append(full.decode())
    prev = full
  return paths


def _common_prefix(a: bytes, b: bytes) -> int:
  n = min(len(a), len(b))
  i = 0
  while i < n and a[i] == b[i]:
    i += 1
  return i


def _data_file_table(paths: Sequence[str]) -> bytes:
  """``paths`` as a table; each splits into a base path (up to and with
  its last ``/`` before ``d/``) and a path relative to it."""
  encoded = [p.encode() for p in paths]
  prefix, suffix, base = [], [], []
  prev = b""
  for i, p in enumerate(encoded):
    common = _common_prefix(prev, p) if i else 0
    prefix.append(common)
    suffix.append(len(p) - common)
    cut = p.rfind(b"/" + DATA_DIR.encode() + b"/")
    base.append(cut + 1 if cut >= 0 else 0)
    prev = p
  return (_varint(len(encoded)) + _varints(prefix[1:]) + _varints(suffix)
          + _varints(base) + b"".join(
              p[c:] for p, c in zip(encoded, prefix)))


def _keys_column(keys: Sequence[bytes]) -> Tuple[bytes, bytes]:
  """(prefix and suffix lengths, suffix bytes) of a sorted key list."""
  prefix, suffix, tails = [], [], []
  prev = b""
  for i, k in enumerate(keys):
    common = _common_prefix(prev, k) if i else 0
    prefix.append(common)
    suffix.append(len(k) - common)
    tails.append(k[common:])
    prev = k
  return _varints(prefix[1:]) + _varints(suffix), b"".join(tails)


# -- manifest ------------------------------------------------------------------

@dataclass
class Version:
  generation: int
  height: int
  root: Optional[ValueRef]  # None: the empty tree
  num_keys: int
  num_tree_bytes: int
  num_indirect_value_bytes: int
  commit_time: int


def _read_manifest(path: Path) -> Tuple[Config, List[Version]]:
  cur = _Cursor(_unframe(path.read_bytes(), MANIFEST_MAGIC, str(path)),
                str(path))
  config = Config(uuid=cur.take(16))
  config.manifest_kind = cur.varint()
  config.max_inline_value_bytes = cur.varint()
  config.max_decoded_node_bytes = cur.varint()
  config.version_tree_arity_log2 = cur.u8()
  method = cur.varint()
  if method == 0:
    config.zstd_level = None
  elif method == 1:
    config.zstd_level = struct.unpack("<i", cur.take(4))[0]
  else:
    cur.fail(f"unknown compression method {method}")
  if config.manifest_kind != 0:
    cur.fail("only the single-file manifest kind is supported")
  files = _read_data_file_table(cur)
  n = cur.varint()
  gens = cur.varints(n)
  heights = [cur.u8() for _ in range(n)]
  file_ids = cur.varints(n)
  offsets = cur.varints(n)
  lengths = cur.varints(n)
  num_keys = cur.varints(n)
  tree_bytes = cur.varints(n)
  indirect = cur.varints(n)
  times = [struct.unpack("<Q", cur.take(8))[0] for _ in range(n)]
  versions = []
  for i in range(n):
    if file_ids[i] >= len(files):
      cur.fail("version names a data file the table lacks")
    root = (None if offsets[i] == _NO_OFFSET else
            ValueRef(files[file_ids[i]], offsets[i], lengths[i]))
    versions.append(Version(gens[i], heights[i], root, num_keys[i],
                            tree_bytes[i], indirect[i], times[i]))
  # version tree nodes (older versions) follow; the newest is always inline
  return config, versions


def _manifest(config: Config, version: Version) -> bytes:
  root = version.root
  files = [root.path] if root is not None else [""]
  body = bytearray(config.uuid)
  body += _varint(config.manifest_kind)
  body += _varint(config.max_inline_value_bytes)
  body += _varint(config.max_decoded_node_bytes)
  body += bytes([config.version_tree_arity_log2])
  if config.zstd_level is None:
    body += _varint(0)
  else:
    body += _varint(1) + struct.pack("<i", config.zstd_level)
  body += _data_file_table(files)
  body += _varint(1) + _varint(version.generation) + bytes([version.height])
  body += _varint(0)
  body += _varint(root.offset if root else _NO_OFFSET)
  body += _varint(root.length if root else _NO_OFFSET)
  body += _varints([version.num_keys, version.num_tree_bytes,
                    version.num_indirect_value_bytes])
  body += struct.pack("<Q", version.commit_time)
  body += _varint(0)  # no version tree nodes
  return _frame(bytes(body), MANIFEST_MAGIC, config.zstd_level is not None)


# -- nodes ---------------------------------------------------------------------

@dataclass
class _Child:
  first_key: bytes          # full keys
  last_key: bytes
  prefix: bytes             # the full prefix every key below shares
  ref: ValueRef
  height: int
  num_keys: int
  tree_bytes: int
  indirect_bytes: int


def _decode_node(data: bytes, what: str, base: bytes):
  """A node's (height, entries): a leaf's entries are ``(full key, Value)``,
  an interior node's ``(full key, prefix, ValueRef)``; ``base`` is the
  prefix its keys omit."""
  cur = _Cursor(_unframe(data, NODE_MAGIC, what), what)
  height = cur.u8()
  files = _read_data_file_table(cur)
  n = cur.varint()
  prefix = [0] + cur.varints(n - 1) if n else []
  suffix = cur.varints(n)
  if height == 0:
    keys = _read_keys(cur, prefix, suffix)
    lengths = cur.varints(n)
    kinds = [cur.u8() for _ in range(n)]
    n_indirect = sum(1 for k in kinds if k == 1)
    if any(k > 1 for k in kinds):
      cur.fail("unknown value kind")
    file_ids = cur.varints(n_indirect)
    offsets = cur.varints(n_indirect)
    entries = []
    j = 0
    for i in range(n):
      if kinds[i] == 0:
        value: Value = cur.take(lengths[i])
      else:
        if file_ids[j] >= len(files):
          cur.fail("value names a data file the table lacks")
        value = ValueRef(files[file_ids[j]], offsets[j], lengths[i])
        j += 1
      entries.append((base + keys[i], value))
    return height, entries
  common = cur.varints(n)
  keys = _read_keys(cur, prefix, suffix)
  file_ids = cur.varints(n)
  offsets = cur.varints(n)
  lengths = cur.varints(n)
  cur.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
  entries = []
  for i in range(n):
    if common[i] > len(keys[i]) or file_ids[i] >= len(files):
      cur.fail("bad interior entry")
    entries.append((base + keys[i], base + keys[i][:common[i]],
                    ValueRef(files[file_ids[i]], offsets[i], lengths[i])))
  return height, entries


def _read_keys(cur: _Cursor, prefix: List[int], suffix: List[int]):
  keys, prev = [], b""
  for p, s in zip(prefix, suffix):
    if p > len(prev):
      cur.fail("key prefix longer than the key before it")
    prev = prev[:p] + cur.take(s)
    keys.append(prev)
  return keys


def _leaf_payload(base: bytes, entries: Sequence[Tuple[bytes, Value]]) -> bytes:
  files = sorted({v.path for _, v in entries if isinstance(v, ValueRef)})
  index = {p: i for i, p in enumerate(files)}
  keys = [k[len(base):] for k, _ in entries]
  lens, tails = _keys_column(keys)
  indirect = [v for _, v in entries if isinstance(v, ValueRef)]
  return b"".join([
      b"\x00", _data_file_table(files), _varint(len(entries)), lens, tails,
      _varints(len(v) if isinstance(v, bytes) else v.length
               for _, v in entries),
      bytes(0 if isinstance(v, bytes) else 1 for _, v in entries),
      _varints(index[v.path] for v in indirect),
      _varints(v.offset for v in indirect),
      b"".join(v for _, v in entries if isinstance(v, bytes))])


def _interior_payload(base: bytes, children: Sequence[_Child]) -> bytes:
  files = sorted({c.ref.path for c in children})
  index = {p: i for i, p in enumerate(files)}
  keys = [c.first_key[len(base):] for c in children]
  lens, tails = _keys_column(keys)
  return b"".join([
      bytes([children[0].height + 1]), _data_file_table(files),
      _varint(len(children)), lens,
      _varints(len(c.prefix) - len(base) for c in children), tails,
      _varints(index[c.ref.path] for c in children),
      _varints(c.ref.offset for c in children),
      _varints(c.ref.length for c in children),
      _varints(c.num_keys for c in children),
      _varints(c.tree_bytes for c in children),
      _varints(c.indirect_bytes for c in children)])


def _entry_bytes(key: bytes, value: Value) -> int:
  """An upper bound of an entry's share of a leaf's decoded payload."""
  return len(key) + 24 + (len(value) if isinstance(value, bytes) else 0)


class _DataFile:
  """A new data file ``d/<hex>`` of a database, written front to back."""

  def __init__(self, db: Path):
    name = f"{DATA_DIR}/{uuid_lib.uuid4().hex}"
    self.rel = name
    (db / DATA_DIR).mkdir(parents=True, exist_ok=True)
    self.f = open(db / name, "wb")
    self.offset = 0

  def write(self, parts: Iterable) -> ValueRef:
    start = self.offset
    for part in parts:
      self.f.write(part)
      self.offset += len(part)
    return ValueRef(self.rel, start, self.offset - start)

  def close(self):
    self.f.flush()
    os.fsync(self.f.fileno())
    self.f.close()


def _groups(items: Sequence, sizes: Sequence[int], budget: int,
            least: int) -> List[List]:
  """Split ``items`` in order into runs whose sizes sum to at most
  ``budget`` (a run holds at least ``least`` items where it can)."""
  groups: List[List] = [[]]
  size = 0
  for item, need in zip(items, sizes):
    if len(groups[-1]) >= least and size + need > budget:
      groups.append([])
      size = 0
    groups[-1].append(item)
    size += need
  return groups


def _write_tree(data: _DataFile, entries: Sequence[Tuple[bytes, Value]],
                config: Config) -> Tuple[int, Optional[_Child]]:
  """Write ``entries`` (sorted) as a B-tree: one leaf while the payload
  fits ``max_decoded_node_bytes``, else leaves under interior nodes. A
  node's keys omit the prefix its parent's entry says its subtree shares
  (the root's omit nothing). Returns (height, root), or (0, None)."""
  if not entries:
    return 0, None
  zstd = config.zstd_level is not None
  budget = config.max_decoded_node_bytes
  groups = _groups(entries, [_entry_bytes(k, v) for k, v in entries],
                   budget, 1)
  level: List[_Child] = []
  height = 0
  while True:
    top = len(groups) == 1
    nxt = []
    for group in groups:
      if height == 0:
        first, last = group[0][0], group[-1][0]
      else:
        first, last = group[0].first_key, group[-1].last_key
      prefix = b"" if top else first[:_common_prefix(first, last)]
      payload = (_leaf_payload(prefix, group) if height == 0 else
                 _interior_payload(prefix, group))
      ref = data.write([_frame(payload, NODE_MAGIC, zstd)])
      if height == 0:
        stats = (len(group), ref.length,
                 sum(v.length for _, v in group if isinstance(v, ValueRef)))
      else:
        stats = (sum(c.num_keys for c in group),
                 ref.length + sum(c.tree_bytes for c in group),
                 sum(c.indirect_bytes for c in group))
      nxt.append(_Child(first, last, prefix, ref, height, *stats))
    level = nxt
    if top:
      return height, level[0]
    groups = _groups(level, [len(c.first_key) + 48 for c in level], budget,
                     2)
    height += 1


def _commit(db: Path, config: Config, height: int,
            root: Optional[_Child]) -> None:
  version = Version(
      generation=1, height=height, root=root.ref if root else None,
      num_keys=root.num_keys if root else 0,
      num_tree_bytes=root.tree_bytes if root else 0,
      num_indirect_value_bytes=root.indirect_bytes if root else 0,
      commit_time=time.time_ns())
  tmp = db / f"{MANIFEST_NAME}.{os.getpid()}.tmp"
  with open(tmp, "wb") as f:
    f.write(_manifest(config, version))
    f.flush()
    os.fsync(f.fileno())
  os.replace(tmp, db / MANIFEST_NAME)


def write_database(db: Union[str, Path], values: Dict[bytes, object],
                   config: Optional[Config] = None) -> Dict[bytes, Value]:
  """Write a new database at ``db`` holding ``values`` (each bytes-like, or
  a list of bytes-like pieces written one after another); values longer
  than ``config.max_inline_value_bytes`` go into one data file, the nodes
  after them. Returns each key's entry as stored (inline bytes or a
  :class:`ValueRef`), for :func:`write_root_database`."""
  db = Path(db)
  config = config or Config()
  db.mkdir(parents=True, exist_ok=True)
  data = _DataFile(db)
  try:
    entries: List[Tuple[bytes, Value]] = []
    for key in sorted(values):
      parts = values[key]
      if not isinstance(parts, list):
        parts = [parts]
      if sum(len(p) for p in parts) > config.max_inline_value_bytes:
        entries.append((key, data.write(parts)))
      else:
        entries.append((key, b"".join(bytes(p) for p in parts)))
    height, root = _write_tree(data, entries, config)
  finally:
    data.close()
  _commit(db, config, height, root)
  return dict(entries)


def write_root_database(db: Union[str, Path],
                        entries: Dict[bytes, Value],
                        config: Optional[Config] = None) -> None:
  """Write a database at ``db`` whose entries are given as stored:
  inline bytes, or :class:`ValueRef` into data files that already exist
  (paths relative to ``db``, such as ``ocdbt.process_0/d/<hex>``). Only
  its nodes and manifest are new."""
  db = Path(db)
  config = config or Config()
  db.mkdir(parents=True, exist_ok=True)
  data = _DataFile(db)
  try:
    height, root = _write_tree(data, sorted(entries.items()), config)
  finally:
    data.close()
  _commit(db, config, height, root)


class Reader:
  """The newest version of the database at ``db``: its keys (sorted
  bytes), and each key's value, read from its node or its data file."""

  def __init__(self, db: Union[str, Path]):
    self.db = Path(db)
    manifest = self.db / MANIFEST_NAME
    if not manifest.is_file():
      raise FileNotFoundError(f"no OCDBT manifest at {manifest}")
    self.config, versions = _read_manifest(manifest)
    if not versions:
      raise ValueError(f"OCDBT {manifest}: no version")
    self.version = max(versions, key=lambda v: v.generation)
    self.entries: Dict[bytes, Value] = {}
    if self.version.root is not None:
      self._walk(self.version.root, b"", self.version.height)
    if len(self.entries) != self.version.num_keys:
      raise ValueError(f"OCDBT {self.db}: {len(self.entries)} keys, the "
                       f"manifest says {self.version.num_keys}")

  def _read_ref(self, ref: ValueRef) -> bytes:
    path = self.db / ref.path
    with open(path, "rb") as f:
      data = os.pread(f.fileno(), ref.length, ref.offset)
    if len(data) != ref.length:
      raise ValueError(f"OCDBT {path}: {ref.length} bytes at {ref.offset} "
                       f"wanted, {len(data)} there")
    return data

  def _walk(self, ref: ValueRef, base: bytes, height: int) -> None:
    got, entries = _decode_node(self._read_ref(ref),
                                f"{self.db / ref.path}@{ref.offset}", base)
    if got != height:
      raise ValueError(f"OCDBT {self.db}: node height {got}, expected "
                       f"{height}")
    if height == 0:
      self.entries.update(entries)
      return
    for _, prefix, child in entries:
      self._walk(child, prefix, height - 1)

  def keys(self) -> List[bytes]:
    return sorted(self.entries)

  def __contains__(self, key: bytes) -> bool:
    return key in self.entries

  def stored(self, key: bytes) -> Value:
    """The entry as stored: inline bytes or a :class:`ValueRef`."""
    return self.entries[key]

  def get(self, key: bytes) -> bytes:
    value = self.entries[key]
    return value if isinstance(value, bytes) else self._read_ref(value)
