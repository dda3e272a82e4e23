"""Time the port's orbax restore of a full-width checkpoint that the JAX
package's orbax store wrote, on the CPU.

The state is the port's default model (``HParams()``: 12 flows of 8 WN
layers at 256 channels) with Adam: params from the JAX package's
``init_params`` (numpy), every end conv drawn, Adam's count 1000 and its
moments drawn from a seeded numpy generator, so no leaf compresses away.
The JAX package writes it through orbax and TensorStore (zstd-compressed
zarr chunks and OCDBT nodes). The port's ``restore_host`` reads it and
must equal the JAX package's ``restore_host`` bit for bit; the JAX read is
the reference and is not timed. The port then saves the same state (its
raw zstd frames) and reads that back, so the two reads show what decoding
TensorStore's compressed frames costs over copying raw ones. The reads
alternate (compressed, raw, compressed, raw, ...), warm in the file cache;
the zstd library is built before the first.

Run from the repository root with the JAX package installed (about 5 GB
of host memory, a few minutes):

    python scripts/orbax_full_width_restore.py [--repeats 3]

Prints one JSON line: bytes on disk, the timed reads and the port's save.
"""

import argparse
import json
import os
import platform
import shutil
import sys
import time
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
jax.config.update("jax_platforms", "cpu")

from waveglow_tpu.checkpointing import orbax_store as jax_store  # noqa: E402
from waveglow_tpu.hparams import HParams  # noqa: E402
from waveglow_tpu.models.waveglow import WaveGlowConfig, init_params  # noqa
from waveglow_tpu.training.step import make_optimizer  # noqa: E402
from waveglow_tpu_torch import native  # noqa: E402
from waveglow_tpu_torch.checkpointing import orbax_store  # noqa: E402
from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves  # noqa

ITERATION = 1000


def full_width_state(seed: int):
  """(params, optax Adam state) of ``HParams()``'s model, every leaf drawn."""
  hp = HParams()
  params = init_params(WaveGlowConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 1)
  for flow in params["flows"]:
    for k in ("w", "b"):
      end = flow["wn"]["end"]
      end[k] = (rng.standard_normal(end[k].shape) * 0.05).astype(np.float32)
  params = jax.tree_util.tree_map(jax.numpy.asarray, params)
  leaves, treedef = jax.tree_util.tree_flatten(
      make_optimizer(hp.learning_rate).init(params))
  n = (len(leaves) - 1) // 2
  drawn = [np.asarray(ITERATION, np.int32)]
  for i, x in enumerate(leaves[1:]):
    z = rng.standard_normal(x.shape).astype(np.float32)
    drawn.append(z * np.float32(1e-3) if i < n
                 else np.abs(z) * np.float32(1e-6))
  return hp, params, jax.tree_util.tree_unflatten(
      treedef, [jax.numpy.asarray(x) for x in drawn])


def disk_bytes(path: Path) -> int:
  return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def leaves_of(ckpt):
  return tree_leaves(ckpt.state_dict) + list(ckpt.optimizer)


def assert_equal(got, want, what: str) -> None:
  a, b = leaves_of(got), leaves_of(want)
  if len(a) != len(b) or any(
      x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y)
      for x, y in zip(a, b)):
    raise SystemExit(f"{what}: not bit for bit the JAX package's read")
  if (got.iteration, got.learning_rate) != (want.iteration,
                                            want.learning_rate):
    raise SystemExit(f"{what}: metadata differs")


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--repeats", type=int, default=3)
  parser.add_argument("--dir", default=str(ROOT / "build" /
                                           "orbax_full_width"))
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args()
  out = Path(args.dir)
  shutil.rmtree(out, ignore_errors=True)
  jax_dir, port_dir = out / "jax", out / "port"

  hp, params, opt_state = full_width_state(args.seed)
  array_bytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(
      (params, opt_state)))
  jax_path = jax_store.save_sharded(jax_dir, ITERATION, params, opt_state, hp)
  del params, opt_state
  want = jax_store.restore_host(jax_path)

  t = time.perf_counter()
  native.get_zstd_lib()
  build_s = time.perf_counter() - t
  got = orbax_store.restore_host(jax_path)
  assert_equal(got, want, "the port's read of the JAX save")
  t = time.perf_counter()
  port_path = orbax_store.save_sharded(
      port_dir, ITERATION, got.state_dict, got.optimizer, got.get_hparams())
  port_save_s = time.perf_counter() - t
  del got
  assert_equal(orbax_store.restore_host(port_path), want,
               "the port's read of its own save")

  reads = {"jax_written": [], "port_written": []}
  for _ in range(args.repeats):
    for key, path in (("jax_written", jax_path), ("port_written", port_path)):
      t = time.perf_counter()
      ckpt = orbax_store.restore_host(path)
      reads[key].append(time.perf_counter() - t)
      assert_equal(ckpt, want, key)
      del ckpt
  result = {
      "host": f"{platform.processor() or platform.machine()}, "
              f"{os.cpu_count()} cpus",
      "leaves": len(leaves_of(want)),
      "array_bytes": array_bytes,
      "jax_written_disk_bytes": disk_bytes(jax_path),
      "port_written_disk_bytes": disk_bytes(port_path),
      "zstd_build_s": build_s,
      "restore_s": reads,
      "port_save_s": port_save_s,
      "bit_for_bit": True,
  }
  shutil.rmtree(out, ignore_errors=True)
  print(json.dumps(result))


if __name__ == "__main__":
  main()
