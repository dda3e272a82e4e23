"""Hyperparameter dataclasses (a copy of ``waveglow_tpu/hparams.py``).

The port keeps its own copy so it imports nothing of the JAX package, and
keeps every field — TPU-only ones included — so a checkpoint's hparam dict
written by either package loads here with the same values and round-trips
unchanged. ``hparams_from_dict`` drops unknown keys (lenient load).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple


@dataclass
class STFTHParams:
  filter_length: int = 1024
  hop_length: int = 256
  win_length: int = 1024
  window: str = "hann"


@dataclass
class TSTFTHParams(STFTHParams):
  n_mel_channels: int = 80
  sampling_rate: int = 22050
  mel_fmin: float = 0.0
  mel_fmax: float = 8000.0


@dataclass
class ExperimentHParams:
  epochs: int = 100000
  iters_per_checkpoint: int = 2000
  epochs_per_checkpoint: int = 1
  seed: int = 1234
  cache_wavs: bool = False
  # Retained for checkpoint-format compatibility with the reference; both are
  # CUDA-only concepts and no-ops on TPU (reference hparams.py:14-16).
  cudnn_enabled: bool = True
  cudnn_benchmark: bool = False


@dataclass
class ModelHParams:
  segment_length: int = 16000
  n_mel_channels: int = 80
  n_flows: int = 12
  n_group: int = 8
  n_early_every: int = 4
  n_early_size: int = 2

  # WN config
  n_layers: int = 8
  n_channels: int = 256
  kernel_size: int = 3


@dataclass
class OptimizerHParams:
  learning_rate: float = 1e-4
  sigma: float = 1.0
  batch_size: int = 1


@dataclass
class TpuHParams:
  """TPU-specific knobs with no reference counterpart."""
  # Matmul compute dtype: "float32" (parity) or "bfloat16" (speed).
  compute_dtype: str = "float32"
  # Device mesh axis sizes for training: data-parallel x model(tensor)-parallel.
  mesh_data: int = 1
  mesh_model: int = 1
  # Number of gradient-accumulation micro-steps per optimizer step.
  grad_accum: int = 1
  # Rematerialize WN blocks in the backward pass (measured FASTER on v5e:
  # recomputing beats storing/reloading the scan residuals).
  remat: bool = True
  # Remat granularity: "flow" checkpoints the whole flow step, "wn" only
  # the WN body (keeps coupling/1x1 residuals, recomputes just the stack).
  remat_scope: str = "flow"
  # Trace one flow body per same-shape group (lax.scan) instead of
  # unrolling all flows: identical numerics, ~4x faster XLA compiles. The
  # JAX package's tracing choice only; kept for checkpoint compatibility,
  # no effect in the port (which traces nothing).
  scan_flows: bool = True
  # Route WN layers through the fused Pallas kernel in the JAX package's
  # TRAINING step. Kept for checkpoint compatibility; the port always runs
  # every WN layer through its CUDA kernel.
  use_pallas: bool = False
  # Checkpoint save backend: "npz" (reference-parity single file; sharded
  # states are all-gathered to host first) or "orbax" (per-shard distributed
  # writes — save cost scales with LOCAL shard bytes; the pod-scale choice).
  checkpoint_backend: str = "npz"
  # With the orbax backend: overlap the checkpoint disk write with training
  # (device-to-host fetch stays synchronous, the TensorStore write runs in
  # background threads). The write is barriered before the next save and at
  # the end of training.
  checkpoint_async: bool = False


@dataclass
class HParams(ExperimentHParams, TSTFTHParams, ModelHParams, OptimizerHParams,
              TpuHParams):
  pass


def _coerce(value: str, target_type) -> object:
  if target_type is bool:
    if value in ("True", "true", "1"):
      return True
    if value in ("False", "false", "0"):
      return False
    raise ValueError(f"cannot parse bool from {value!r}")
  return target_type(value)


def parse_custom_hparams(custom: Optional[str]) -> Dict[str, str]:
  """Parse a ``"k=v,k2=v2"`` override string into a dict."""
  if not custom:
    return {}
  result: Dict[str, str] = {}
  for pair in custom.split(","):
    pair = pair.strip()
    if not pair:
      continue
    if "=" not in pair:
      raise ValueError(f"invalid hparam override {pair!r}; expected k=v")
    key, value = pair.split("=", 1)
    result[key.strip()] = value.strip()
  return result


def overwrite_custom_hparams(hparams: HParams,
                             custom: Optional[Dict[str, str]]) -> HParams:
  """Apply string overrides with type coercion; unknown keys are an error.

  Mirrors reference utils.py:48-90 semantics.
  """
  if not custom:
    return hparams
  field_types = {f.name: f.type for f in fields(hparams)}
  py_types = {f.name: type(getattr(hparams, f.name)) for f in fields(hparams)}
  updates = {}
  for key, value in custom.items():
    if key not in field_types:
      raise ValueError(f"unknown hparam {key!r}")
    updates[key] = _coerce(value, py_types[key]) if isinstance(value, str) else value
  return dataclasses.replace(hparams, **updates)


def hparams_from_dict(d: Dict, cls=HParams) -> Tuple[HParams, List[str]]:
  """Build hparams from a dict, leniently ignoring unknown keys.

  Returns (hparams, ignored_keys). Mirrors reference checkpoint.py:22-28 /
  utils.py get_dataclass_from_dict so that reference checkpoints (whose hparam
  dicts lack the TPU-only fields or carry extra ones) load cleanly.
  """
  known = {f.name for f in fields(cls)}
  used = {k: v for k, v in d.items() if k in known}
  ignored = sorted(k for k in d if k not in known)
  return cls(**used), ignored
