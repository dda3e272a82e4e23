"""Regenerate ``tests/data/orbax_tiny/``: a checkpoint that the JAX
package's orbax store writes (through orbax and TensorStore, so its zarr
chunks and OCDBT nodes are zstd-compressed by the zstd library), and its
plain-numpy copy ``7.npz`` in the npz store's format.

The model is tiny (1 flow of 2 WN layers, 8 channels, 1 mel channel, so
the upsample kernel is 1 x 1 x 1024) and its Adam state is nonzero
(count 7, mu and nu drawn from a seeded numpy generator), so every leaf
holds bytes that do not compress away.

Run from the repository root with the JAX package installed:

    python tests/data/make_orbax_tiny.py
"""

import shutil
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
jax.config.update("jax_platforms", "cpu")

from waveglow_tpu.checkpointing import orbax_store  # noqa: E402
from waveglow_tpu.checkpointing.store import CheckpointWaveglow  # noqa: E402
from waveglow_tpu.hparams import HParams, overwrite_custom_hparams  # noqa
from waveglow_tpu.models.waveglow import WaveGlowConfig, init_params  # noqa
from waveglow_tpu.training.step import make_optimizer  # noqa: E402

OUT = Path(__file__).resolve().parent / "orbax_tiny"
ITERATION = 7
HPARAMS = {"n_flows": "1", "n_layers": "2", "n_channels": "8",
           "n_mel_channels": "1", "segment_length": "2048",
           "batch_size": "2"}


def main():
  hp = overwrite_custom_hparams(HParams(), HPARAMS)
  params = init_params(WaveGlowConfig.from_hparams(hp), seed=3)
  rng = np.random.default_rng(5)
  for flow in params["flows"]:  # a zero end conv is no test of the bytes
    for k in ("w", "b"):
      flow["wn"]["end"][k] = (rng.standard_normal(
          flow["wn"]["end"][k].shape) * 0.05).astype(np.float32)
  params = jax.tree_util.tree_map(jax.numpy.asarray, params)
  opt_state = make_optimizer(hp.learning_rate).init(params)
  leaves, treedef = jax.tree_util.tree_flatten(opt_state)
  drawn = [np.asarray(ITERATION, np.int32)] + [
      (rng.standard_normal(x.shape) * (1e-3 if i < (len(leaves) - 1) // 2
                                       else 1e-6)).astype(np.float32)
      if i % 2 == 0 else np.abs(rng.standard_normal(x.shape) * 1e-6
                                ).astype(np.float32)
      for i, x in enumerate(leaves[1:])]
  opt_state = jax.tree_util.tree_unflatten(
      treedef, [jax.numpy.asarray(x) for x in drawn])
  shutil.rmtree(OUT, ignore_errors=True)
  orbax_store.save_sharded(OUT, ITERATION, params, opt_state, hp)
  CheckpointWaveglow.from_state(params, opt_state, hp, ITERATION).save(
      OUT / f"{ITERATION}.npz")
  size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
  print(f"wrote {OUT} ({size} bytes)")


if __name__ == "__main__":
  main()
