"""The port's ``StreamingDenoiser`` against the JAX package's on the same
audio and the same bias spectrum, and against the port's one-call
``Denoiser``; the errors the port raises where the JAX module asserts. The
bias comes from a tiny model with its ``end`` convs randomised, so it is
not zero."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from waveglow_tpu.hparams import TSTFTHParams as JaxTSTFTHParams
from waveglow_tpu.inference.denoiser import Denoiser as JaxDenoiser
from waveglow_tpu.inference.stream_denoise import (
    StreamingDenoiser as JaxStreamingDenoiser)
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu_torch.checkpointing.from_jax import params_from_numpy
from waveglow_tpu_torch.hparams import TSTFTHParams
from waveglow_tpu_torch.inference.denoiser import Denoiser
from waveglow_tpu_torch.inference.stream_denoise import StreamingDenoiser
from waveglow_tpu_torch.models import waveglow as port_model

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(n_flows=2, n_layers=2, n_channels=32)
STRENGTH = 0.02
TOL = 2e-6  # the JAX suite's bound on a reassembled stream


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def tiny_params():
  params = port_model.init_params(port_model.WaveGlowConfig(**CFG), seed=0)
  rng = np.random.default_rng(100)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (0.3 * rng.standard_normal(end["w"].shape)).astype(np.float32)
    end["b"] = (0.3 * rng.standard_normal(end["b"].shape)).astype(np.float32)
  return params


@pytest.fixture(scope="module")
def denoisers():
  """(JAX denoiser, port denoiser) sharing the JAX denoiser's bias, here
  from its "normal" mode (a mel drawn by ``jax.random``)."""
  params = tiny_params()
  jax_dn = JaxDenoiser(jax_model.fuse_for_inference(params),
                       jax_model.WaveGlowConfig(**CFG), JaxTSTFTHParams(),
                       mode="normal")
  port_dn = Denoiser(params_from_numpy(params, "cpu"),
                     port_model.WaveGlowConfig(**CFG), TSTFTHParams(),
                     "cpu")
  assert port_dn.bias_spec.shape == (1, 513, 1)
  port_dn.bias_spec = torch.from_numpy(np.array(jax_dn.bias_spec))
  assert float(port_dn.bias_spec.abs().max()) > 0
  return jax_dn, port_dn


def audio(n, seed=0, scale=0.3):
  return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
      np.float32)


def run_stream(sd, wav, pieces):
  outs, pos, expected_start = [], 0, 0
  for size in pieces:
    emitted = sd.push(wav[pos:pos + size])
    pos += size
    for start, block in emitted:
      assert start == expected_start
      expected_start += len(block)
      outs.append(np.asarray(block))
  assert pos == len(wav)
  for start, block in sd.flush():
    assert start == expected_start
    expected_start += len(block)
    outs.append(np.asarray(block))
  return np.concatenate(outs) if outs else np.zeros((0,), np.float32)


# (total samples, pushed piece sizes, block_samples); None pushes it whole
PATTERNS = {
    "even": (48 * 256, [4096] * 3, 2048),
    "uneven": (40 * 256, [100, 5000, 1, 3000, 123, 2016, None], 1536),
    "single-push": (24 * 256, [None], 2048),
    "not-hop-aligned": (20 * 256 + 100, [None], 1024),
    "short-fallback": (4 * 256, [512, 512], 4096),
    "short-tail": (30000, [None], 16384),
}


def pieces_of(total, sizes):
  sizes = [s for s in sizes if s is not None]
  return sizes + ([total - sum(sizes)] if total > sum(sizes) else [])


@pytest.mark.parametrize("name", list(PATTERNS))
def test_matches_jax_streaming_denoiser(denoisers, name):
  jax_dn, port_dn = denoisers
  total, sizes, block = PATTERNS[name]
  wav = audio(total, seed=total)
  pieces = pieces_of(total, sizes)
  ref = run_stream(JaxStreamingDenoiser(jax_dn, STRENGTH,
                                        block_samples=block), wav, pieces)
  out = run_stream(StreamingDenoiser(port_dn, STRENGTH, block_samples=block),
                   wav, pieces)
  assert out.shape == ref.shape == ((total // 256) * 256,)
  np.testing.assert_allclose(out, ref, atol=TOL)


def test_many_tail_lengths_match_jax(denoisers):
  """Every residue of the total against the block flushes and matches."""
  jax_dn, port_dn = denoisers
  for total in (4096, 4096 + 256, 4096 + 1024, 6144 - 256, 8191):
    wav = audio(total, seed=total)
    ref = run_stream(JaxStreamingDenoiser(jax_dn, STRENGTH,
                                          block_samples=2048), wav, [total])
    out = run_stream(StreamingDenoiser(port_dn, STRENGTH, block_samples=2048),
                     wav, [total])
    assert out.shape == ref.shape, total
    np.testing.assert_allclose(out, ref, atol=TOL, err_msg=f"total={total}")


@pytest.mark.parametrize("name", ["even", "uneven", "not-hop-aligned",
                                  "short-fallback"])
def test_matches_the_one_call_denoiser(denoisers, name):
  _, port_dn = denoisers
  total, sizes, block = PATTERNS[name]
  wav = audio(total, seed=total + 1)
  full = port_dn(torch.from_numpy(wav[None]), STRENGTH)[0].numpy()
  out = run_stream(StreamingDenoiser(port_dn, STRENGTH, block_samples=block),
                   wav, pieces_of(total, sizes))
  assert out.shape == full.shape
  np.testing.assert_allclose(out, full, atol=TOL)
  assert np.abs(out - wav[:len(out)]).max() > 1e-3  # the bias was removed


@pytest.mark.parametrize("total", [256, 20 * 256 + 100])
def test_one_call_denoiser_matches_jax_per_row(denoisers, total):
  """The one-call ``Denoiser`` on a batch of two rows with per-row
  strengths against the JAX denoiser row by row, and each row against the
  port's own scalar call."""
  jax_dn, port_dn = denoisers
  wav = np.stack([audio(total, seed=total + 2), audio(total, seed=total + 3)])
  strengths = np.float32([STRENGTH, 4 * STRENGTH])
  out = port_dn(torch.from_numpy(wav),
                torch.from_numpy(strengths).reshape(-1, 1, 1)).numpy()
  assert out.shape == (2, (total // 256) * 256)
  for b in range(2):
    ref = np.asarray(jax_dn(wav[b:b + 1], float(strengths[b])))[0]
    np.testing.assert_allclose(out[b], ref, atol=TOL)
    np.testing.assert_array_equal(
        out[b], port_dn(torch.from_numpy(wav[b:b + 1]),
                        float(strengths[b]))[0].numpy())


def test_pcm16_blocks_equal_the_host_conversion(denoisers):
  _, port_dn = denoisers
  wav = audio(24 * 256, seed=6, scale=1.2)  # some samples clip
  f = run_stream(StreamingDenoiser(port_dn, STRENGTH, block_samples=2048),
                 wav, [3072, 3072])
  p = run_stream(StreamingDenoiser(port_dn, STRENGTH, block_samples=2048,
                                   pcm16=True), wav, [3072, 3072])
  assert p.dtype == np.int16 and np.abs(f).max() > 1.0
  np.testing.assert_array_equal(
      p, np.round(np.clip(f, -1.0, 1.0) * 32767.0).astype(np.int16))


def test_empty_and_subhop_streams_emit_nothing(denoisers):
  _, port_dn = denoisers
  assert StreamingDenoiser(port_dn, STRENGTH).flush() == []
  sd = StreamingDenoiser(port_dn, STRENGTH)
  assert sd.push(np.zeros(100, np.float32)) == []
  assert sd.flush() == []


def test_push_after_flush_raises(denoisers):
  sd = StreamingDenoiser(denoisers[1], STRENGTH)
  sd.push(audio(1024))
  sd.flush()
  with pytest.raises(RuntimeError, match="after flush"):
    sd.push(audio(256))


@pytest.mark.parametrize("block", [1000, 0, -256])
def test_bad_block_samples_raise(denoisers, block):
  with pytest.raises(ValueError, match="block_samples"):
    StreamingDenoiser(denoisers[1], STRENGTH, block_samples=block)


def test_odd_stft_ratio_raises():
  """hop 256 does not divide 768 / 2: the windows would leave the one-call
  frame grid."""
  hp = TSTFTHParams()
  hp.filter_length = hp.win_length = 768
  dn = Denoiser(params_from_numpy(tiny_params(), "cpu"),
                port_model.WaveGlowConfig(**CFG), hp, "cpu")
  with pytest.raises(ValueError, match="divide"):
    StreamingDenoiser(dn, STRENGTH)


@pytest.mark.parametrize("path", sorted(
    (ROOT / "waveglow_tpu_torch" / "inference").glob("*.py")),
    ids=lambda p: p.name)
def test_inference_modules_have_no_assert(path):
  """``python -O`` strips asserts: the port raises instead."""
  tree = ast.parse(path.read_text(), filename=str(path))
  assert not [node.lineno for node in ast.walk(tree)
              if isinstance(node, ast.Assert)]
