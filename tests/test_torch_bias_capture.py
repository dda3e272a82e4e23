"""The port's bias capture (``capture_bias``) in each capture dtype
against the JAX package's (``_bias_capture_fn``) on the same mel: the
zeros mel the ``Denoiser`` uses, and standard-normal mels drawn with numpy
(the JAX package draws its normal mode's mel with ``jax.random``, whose
bits torch cannot reproduce, so both packages are given the same mel).
The model is tiny, with its ``end`` convs randomised so that every
coupling acts and the bias is not zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveglow_tpu.hparams import TSTFTHParams as JaxTSTFTHParams
from waveglow_tpu.inference.denoiser import _bias_capture_fn
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu_torch.checkpointing.from_jax import params_from_numpy
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.hparams import HParams, TSTFTHParams
from waveglow_tpu_torch.dsp.stft import STFT
from waveglow_tpu_torch.inference.denoiser import (BIAS_MEL_LENGTH, Denoiser,
                                                   capture_bias)
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.models import waveglow as port_model

CFG = dict(n_flows=3, n_layers=2, n_channels=32)
# the bias spectrum's error over its max |value|: f32, and a bf16 capture
# (the port keeps the gate and the res/skip sum in f32 where the JAX XLA
# body rounds them to bf16)
TOL_OF_SCALE = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
  params = port_model.init_params(port_model.WaveGlowConfig(**CFG), seed=0)
  rng = np.random.default_rng(100)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (0.3 * rng.standard_normal(end["w"].shape)).astype(np.float32)
    end["b"] = (0.3 * rng.standard_normal(end["b"].shape)).astype(np.float32)
  return params


def jax_capture(params, mel, mode):
  hp = JaxTSTFTHParams()
  capture = _bias_capture_fn(
      jax_model.WaveGlowConfig(**CFG), None if mode == "f32" else "bfloat16",
      hp.filter_length, hp.hop_length, hp.win_length, hp.window)
  return np.asarray(capture(jax_model.fuse_for_inference(params),
                            jnp.asarray(mel)))


def bias_mel(seed):
  """[1, 80, 88] f32: zeros (``seed`` None) or standard-normal draws."""
  shape = (1, 80, BIAS_MEL_LENGTH)
  if seed is None:
    return np.zeros(shape, np.float32)
  return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def capture(params, mel, compute_dtype=None):
  hp = TSTFTHParams()
  stft = STFT(hp.filter_length, hp.hop_length, hp.win_length, hp.window,
              device="cpu")
  return capture_bias(params_from_numpy(params, "cpu"),
                      port_model.WaveGlowConfig(**CFG), stft,
                      torch.from_numpy(mel), compute_dtype)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [None, 0, 5], ids=["zeros", "normal0",
                                                    "normal5"])
def test_capture_equals_jax_capture(params, mode, seed):
  """The port's capture against the JAX capture of the same mel, within
  ``TOL_OF_SCALE`` of its max |value|; the bias is f32 in either dtype."""
  mel = bias_mel(seed)
  got = capture(params, mel, None if mode == "f32" else torch.bfloat16)
  ref = jax_capture(params, mel, mode)
  assert got.dtype == torch.float32
  assert got.shape == ref.shape == (1, 513, 1)
  scale = np.abs(ref).max()
  assert scale > 0
  err = np.abs(got.numpy() - ref).max()
  assert err <= TOL_OF_SCALE[mode] * scale, (err, scale)


def test_mels_and_dtypes_differ(params):
  """The mel and the dtype are really taken: a normal mel's bias differs
  from the zeros mel's and from another seed's, and a bf16 capture from
  the f32 one; the ``Denoiser``'s bias is the zeros mel's f32 capture."""
  zeros, normal = capture(params, bias_mel(None)), capture(params,
                                                           bias_mel(0))
  assert not torch.equal(zeros, normal)
  assert not torch.equal(normal, capture(params, bias_mel(5)))
  assert torch.equal(normal, capture(params, bias_mel(0)))
  assert not torch.equal(zeros, capture(params, bias_mel(None),
                                        torch.bfloat16))
  dn = Denoiser(params_from_numpy(params, "cpu"),
                port_model.WaveGlowConfig(**CFG), TSTFTHParams(), "cpu")
  assert torch.equal(dn.bias_spec, zeros)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_synthesizer_keeps_the_zeros_f32_capture(params, compute_dtype):
  """The ``Synthesizer`` captures from the zeros mel in f32 whatever its
  compute dtype, as the JAX one does; ``to`` keeps the bias."""
  hp = dict(CFG, compute_dtype=compute_dtype)
  synth = Synthesizer(CheckpointWaveglow.from_params(params, HParams()),
                      custom_hparams={k: str(v) for k, v in hp.items()},
                      device="cpu")
  dn = synth.denoiser
  assert torch.equal(dn.bias_spec, capture(params, bias_mel(None)))
  assert dn.to(torch.device("cpu")).bias_spec is dn.bias_spec
