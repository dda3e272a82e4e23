"""Import torch WaveGlow checkpoints into the port's params tree
(counterpart of ``waveglow_tpu/checkpointing/import_torch.py``).

Reads every on-disk form the reference's ecosystem produces:
  1. the reference ``Checkpoint`` dict ``{state_dict, optimizer,
     learning_rate, iteration, hparams}``, its state dict in torch's
     parametrization naming (``...parametrizations.weight.original0/1``);
  2. legacy weight-norm naming (``weight_g``/``weight_v``), as in
     NVIDIA-trained state dicts;
  3. NVIDIA's raw checkpoint ``{"model": ..., "iteration": ...}`` (the
     published LJS files), whose ``model`` is a pickled ``nn.Module`` of a
     ``glow`` module (resolved through a stand-in, :func:`_install_glow_shim`)
     or a state dict; the architecture is read off the weights' shapes.
Convs stored fused (after ``remove_weightnorm``) import as plain weights.

The params come out as numpy in the JAX package's layout, which is the
port's, so a converted file is the npz the JAX package writes. Torch packs
the gate's channels as ``[tanh C; sigmoid C]`` and the cond layer
layer-major; both become explicit axes by reshape.

A torch Adam state maps onto optax's positional layout (int32 ``count``,
then ``mu`` and ``nu`` in ``jax.tree_util`` order), each moment through its
own weight's layout transform, so training resumes with the reference's
momentum (:func:`~waveglow_tpu_torch.training.step.adam_state_from_optax`).
A missing or mismatched state gives ``None`` (the optimizer restarts), as
the reference's warm start does.

``torch.load(weights_only=False)`` executes pickle code: NVIDIA's
full-module files need it. Load only files you trust; the serving daemon
refuses them on ``/reload`` unless told otherwise.
"""

from __future__ import annotations

import logging
import sys
import types
from dataclasses import asdict
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.export_torch import (
    WEIGHT_SUFFIXES, count_flows_and_layers, reference_parameter_order)
from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.hparams import HParams, hparams_from_dict

logger = logging.getLogger(__name__)

NVIDIA_ITERATION = 580000


def _t(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy().astype(np.float32)
  return np.asarray(x, dtype=np.float32)


def _get_conv(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
  """One conv's torch-layout arrays in whichever naming ``sd`` uses:
  ``{"g", "v"}`` (parametrization or legacy) or ``{"w"}`` (fused), plus
  ``"b"`` when it has a bias."""
  out: Dict[str, np.ndarray] = {}
  for g, v in ((".parametrizations.weight.original0",
                ".parametrizations.weight.original1"),
               (".weight_g", ".weight_v")):
    if f"{prefix}{g}" in sd:
      out["g"] = _t(sd[f"{prefix}{g}"])
      out["v"] = _t(sd[f"{prefix}{v}"])
      break
  else:
    if f"{prefix}.weight" not in sd:
      raise KeyError(f"no weight found for conv {prefix!r}")
    out["w"] = _t(sd[f"{prefix}.weight"])
  if f"{prefix}.bias" in sd:
    out["b"] = _t(sd[f"{prefix}.bias"])
  return out


def _map_1x1(conv: Dict, out_reshape=None) -> Dict[str, np.ndarray]:
  """torch ``[Cout, Cin, 1]`` -> ``[Cin, Cout]`` (Cout split to
  ``out_reshape`` when given)."""
  result: Dict[str, np.ndarray] = {}
  for key in ("w", "v"):
    if key in conv:
      w = conv[key][:, :, 0].T
      if out_reshape is not None:
        w = w.reshape(w.shape[0], *out_reshape)
      result[key] = np.ascontiguousarray(w)
  for key in ("g", "b"):
    if key in conv:
      arr = conv[key].reshape(-1)
      if out_reshape is not None:
        arr = arr.reshape(*out_reshape)
      result[key] = np.ascontiguousarray(arr)
  return result


def _map_ktap(conv: Dict, out_reshape) -> Dict[str, np.ndarray]:
  """torch ``[Cout, Cin, K]`` -> ``[K, Cin, *out_reshape]``."""
  result: Dict[str, np.ndarray] = {}
  for key in ("w", "v"):
    if key in conv:
      w = conv[key].transpose(2, 1, 0)
      result[key] = np.ascontiguousarray(
          w.reshape(w.shape[0], w.shape[1], *out_reshape))
  for key in ("g", "b"):
    if key in conv:
      result[key] = np.ascontiguousarray(conv[key].reshape(*out_reshape))
  return result


def state_dict_to_params(sd: Dict, hparams: HParams) -> Dict:
  """A torch WaveGlow state dict -> the params tree (numpy)."""
  c = hparams.n_channels
  n_layers = hparams.n_layers
  up_w = _t(sd["upsample.weight"])                        # [Cin, Cout, K]
  params: Dict = {
      "upsample": {"w": np.ascontiguousarray(up_w.transpose(0, 2, 1)),
                   "b": _t(sd["upsample.bias"])},
      "flows": [],
  }
  for k in range(hparams.n_flows):
    inv_w = _t(sd[f"convinv.{k}.conv.weight"])[:, :, 0]
    pre = f"WN.{k}"
    wn = {
        "start": _map_1x1(_get_conv(sd, f"{pre}.start")),
        "cond": _map_1x1(_get_conv(sd, f"{pre}.cond_layer"),
                         out_reshape=(n_layers, 2, c)),
        "in_layers": [_map_ktap(_get_conv(sd, f"{pre}.in_layers.{i}"),
                                out_reshape=(2, c))
                      for i in range(n_layers)],
        "res_skip": [
            _map_1x1(_get_conv(sd, f"{pre}.res_skip_layers.{i}"),
                     out_reshape=(2, c) if i < n_layers - 1 else None)
            for i in range(n_layers)],
        "end": _map_1x1(_get_conv(sd, f"{pre}.end")),
    }
    params["flows"].append({"inv1x1": {"w": inv_w}, "wn": wn})
  return params


def torch_adam_to_opt_leaves(opt_sd: Dict, torch_sd: Dict,
                             hparams: HParams) -> Optional[List[np.ndarray]]:
  """A torch ``optim.Adam.state_dict()`` -> optax's positional Adam leaves
  ``[int32 count] + mu leaves + nu leaves``.

  torch keys its state by each tensor's position in ``model.parameters()``
  (:func:`reference_parameter_order`); every pairing is shape-checked.
  Returns ``None``, with the reason logged, when the state is absent,
  partial or does not fit the state dict: the optimizer then restarts.
  """
  state = opt_sd.get("state") if isinstance(opt_sd, dict) else None
  groups = opt_sd.get("param_groups") if isinstance(opt_sd, dict) else None
  if not state or not groups:
    logger.info("torch checkpoint has no Adam state; optimizer restarts")
    return None
  order = [i for g in groups for i in g.get("params", ())]
  try:
    names = reference_parameter_order(dict(torch_sd))
  except AssertionError:
    logger.warning("state dict keys do not match the reference WaveGlow "
                   "parameter layout; optimizer restarts")
    return None
  if len(order) != len(names):
    logger.warning(
        "torch optimizer covers %d params but the state dict has %d "
        "tensors; optimizer restarts", len(order), len(names))
    return None

  avg_sd: Dict[str, np.ndarray] = {}
  avg_sq_sd: Dict[str, np.ndarray] = {}
  step = 0
  for idx, name in zip(order, names):
    st = state.get(idx)
    if st is None or "exp_avg" not in st or "exp_avg_sq" not in st:
      logger.warning("torch Adam state missing for param %d (%s); "
                     "optimizer restarts", idx, name)
      return None
    avg, avg_sq = _t(st["exp_avg"]), _t(st["exp_avg_sq"])
    want = tuple(torch_sd[name].shape)
    if avg.shape != want or avg_sq.shape != want:
      logger.warning("torch Adam moment shape %s != param %s shape %s; "
                     "optimizer restarts", avg.shape, name, want)
      return None
    avg_sd[name], avg_sq_sd[name] = avg, avg_sq
    step = max(step, int(float(_t(st["step"]).reshape(-1)[0]))
               if "step" in st else 0)

  mu = tree_leaves(state_dict_to_params(avg_sd, hparams))
  nu = tree_leaves(state_dict_to_params(avg_sq_sd, hparams))
  return [np.asarray(step, np.int32)] + mu + nu


def _install_glow_shim() -> None:
  """Register a stand-in ``glow`` module, so NVIDIA's pickled full-module
  checkpoints (classes ``glow.WaveGlow``, ``glow.WN``,
  ``glow.Invertible1x1Conv``) unpickle; an existing ``glow`` is kept."""
  if "glow" in sys.modules:
    return
  shim = types.ModuleType("glow")
  for name in ("WaveGlow", "WN", "Invertible1x1Conv"):
    setattr(shim, name, type(name, (torch.nn.Module,), {"__module__": "glow"}))
  sys.modules["glow"] = shim


def derive_hparams_from_state_dict(sd: Dict) -> HParams:
  """The architecture read off a torch state dict's shapes (flows, layers,
  channels, kernel size, mel bands, early-output schedule); the training
  fields are the WaveGlow paper's constants."""
  def shape_of(prefix: str):
    for suffix in WEIGHT_SUFFIXES:
      if prefix + suffix in sd:
        return tuple(sd[prefix + suffix].shape)
    raise KeyError(f"no weight found for {prefix}")

  n_flows, n_layers = count_flows_and_layers(sd)
  in0 = shape_of("WN.0.in_layers.0")                     # [2C, C, K]
  convinv_ch = [tuple(sd[f"convinv.{k}.conv.weight"].shape)[0]
                for k in range(n_flows)]
  n_early_every, n_early_size = 0, 0
  for k in range(1, n_flows):
    if convinv_ch[k] != convinv_ch[k - 1]:
      n_early_every = k
      n_early_size = convinv_ch[k - 1] - convinv_ch[k]
      break
  if n_early_every == 0:  # no drop seen: keep the reference's defaults
    n_early_every, n_early_size = 4, 2
  return HParams(
      batch_size=24, learning_rate=1e-4, sigma=1.0, segment_length=16000,
      n_mel_channels=tuple(sd["upsample.weight"].shape)[0],
      sampling_rate=22050, filter_length=1024, hop_length=256,
      win_length=1024, mel_fmin=0.0, mel_fmax=8000.0, n_flows=n_flows,
      n_group=convinv_ch[0], n_early_every=n_early_every,
      n_early_size=n_early_size, n_layers=n_layers, n_channels=in0[1],
      kernel_size=in0[2])


def nvidia_paper_hparams() -> HParams:
  """The hparams of NVIDIA's published LJS checkpoints (the paper's
  constants)."""
  return HParams(
      batch_size=24, learning_rate=1e-4, sigma=1.0, segment_length=16000,
      n_mel_channels=80, sampling_rate=22050, filter_length=1024,
      hop_length=256, win_length=1024, mel_fmin=0.0, mel_fmax=8000.0,
      n_flows=12, n_group=8, n_early_every=4, n_early_size=2,
      n_layers=8, n_channels=256, kernel_size=3)


def load_torch_checkpoint(path: Union[str, Path]) -> CheckpointWaveglow:
  """Load any of the torch checkpoint forms (module docstring) as a
  :class:`CheckpointWaveglow` of numpy params."""
  _install_glow_shim()
  # weights_only=False on purpose: torch >= 2.6 defaults to True, which
  # refuses NVIDIA's pickled modules
  ckpt = torch.load(str(path), map_location="cpu", weights_only=False)

  if isinstance(ckpt, dict) and "state_dict" in ckpt and "hparams" in ckpt:
    hparams, _ = hparams_from_dict(dict(ckpt["hparams"]))
    sd = ckpt["state_dict"]
    learning_rate = float(ckpt.get("learning_rate", hparams.learning_rate))
    iteration = int(ckpt.get("iteration", 0))
  elif isinstance(ckpt, dict) and "model" in ckpt:
    model = ckpt["model"]
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    hparams = derive_hparams_from_state_dict(sd)
    learning_rate = 1e-4
    iteration = int(ckpt.get("iteration", NVIDIA_ITERATION))
  else:
    raise ValueError(f"unrecognized torch checkpoint structure at {path}")
  opt_leaves = (torch_adam_to_opt_leaves(ckpt["optimizer"], sd, hparams)
                if ckpt.get("optimizer") is not None else None)
  return CheckpointWaveglow(
      state_dict=state_dict_to_params(sd, hparams), optimizer=opt_leaves,
      learning_rate=learning_rate, iteration=iteration,
      hparams=asdict(hparams))


def convert_torch_checkpoint(origin: Path, destination: Path,
                             keep_orig: bool = False) -> CheckpointWaveglow:
  """Convert a torch checkpoint file to the npz format (atomically; in
  place when ``destination`` is ``origin``, keeping the original as
  ``<name>.orig`` with ``keep_orig``)."""
  origin, destination = Path(origin), Path(destination)
  ckpt = load_torch_checkpoint(origin)
  # resolved paths: a relative and an absolute spelling of one file must
  # compare equal, or the backup is skipped and the original overwritten
  if keep_orig and origin.resolve() == destination.resolve():
    origin.replace(origin.with_suffix(origin.suffix + ".orig"))
  ckpt.save(destination)
  return ckpt
