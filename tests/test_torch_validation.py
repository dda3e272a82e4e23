"""The port's ``validate`` (``device="cpu"``) against the JAX package's on
one tiny checkpoint (every ``end`` conv randomised) and one folder of
speech cuts, at sigma 0 (the noise drops out, and with it both packages'
random generators) and the default denoiser strength, both in f32 (the
JAX side on its default XLA route). The reports agree row for row; the
entry selection raises the JAX package's errors."""

from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.eval import validation as jv
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import init_params as jax_init
from waveglow_tpu.training import data as jax_data
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.eval import validation as pv
from waveglow_tpu_torch.training import data as port_data

TINY = {"n_flows": "2", "n_layers": "2", "n_channels": "32"}
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "audio.wav"
CUTS = ((22_050, 9_000), (60_000, 11_000))   # (start, samples): 36, 43 frames
SEED = 7
STRENGTH = 0.0005
# the port's synthesis keeps to the JAX package's within 2e-4 on the
# waveform (tests/test_torch_synthesizer.py); through peak normalization
# and the mel that moves these report columns by at most:
MCD_RTOL = 1e-3
COSINE_ATOL = 1e-5
SSIM_ATOL = 5e-3
MEL_ATOL = 5e-3
MEL_EXP_ATOL = 2e-6
EXACT = ("Name", "Subpath", "Iteration", "Seed", "Sigma", "Denoiser strength",
         "Overamplified?", "Inferred wav duration (s)", "# Difference frames",
         "Sampling rate (Hz)", "# MFCC Coefficients", "MFCC DTW PEN",
         "# MFCC DTW frames", "PEN", "# Frames", "Wav path")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
  root = tmp_path_factory.mktemp("validation")
  hp = jax_overwrite(JaxHParams(), TINY)
  params = jax_init(JaxConfig.from_hparams(hp), seed=3)
  rng = np.random.default_rng(4)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.1).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.1).astype(np.float32)
  JaxCkpt(state_dict=params, optimizer=None, learning_rate=hp.learning_rate,
          iteration=12, hparams=asdict(hp)).save(root / "12.npz")
  sr, speech = wavfile.read(FIXTURE)
  (root / "wavs").mkdir()
  for i, (start, n) in enumerate(CUTS):
    wavfile.write(root / "wavs" / f"cut{i}.wav", sr, speech[start:start + n])
  return root


def test_validate_rows_match_the_jax_package(ws):
  saved = {"jax": {}, "port": {}}

  def keep(side):
    return lambda entry, output: saved[side].__setitem__(entry.stem, output)

  common = dict(custom_hparams=None, denoiser_strength=STRENGTH, sigma=0.0,
                entry_names=set(), full_run=True, seed=SEED)
  jax_rows = jv.get_df(jv.validate(
      checkpoint=JaxCkpt.load(ws / "12.npz"),
      data=jax_data.load_dataset(ws / "wavs"), save_callback=keep("jax"),
      **common)).to_dict("records")
  port_rows = pv.get_rows(pv.validate(
      checkpoint=CheckpointWaveglow.load(ws / "12.npz"),
      data=port_data.load_dataset(ws / "wavs"), save_callback=keep("port"),
      device="cpu", **common))
  assert len(port_rows) == len(jax_rows) == len(CUTS)
  for got, want in zip(port_rows, jax_rows):
    assert list(got) == list(want)
    for col in EXACT:
      assert got[col] == want[col], col
    for col in ("MFCC DTW MCD", "MCD"):
      np.testing.assert_allclose(got[col], want[col], rtol=MCD_RTOL,
                                 err_msg=col)
    assert abs(got["Cosine Similarity (Padded)"]
               - want["Cosine Similarity (Padded)"]) <= COSINE_ATOL
    assert abs(got["Structural Similarity (Padded)"]
               - want["Structural Similarity (Padded)"]) <= SSIM_ATOL
  for stem, out in saved["port"].items():
    ref = saved["jax"][stem]
    # tests/test_torch_serving.py's bounds on MelSTFT.get_mel
    np.testing.assert_allclose(out.mel_orig, ref.mel_orig, atol=MEL_ATOL)
    np.testing.assert_allclose(np.exp(out.mel_orig), np.exp(ref.mel_orig),
                               atol=MEL_EXP_ATOL)
    np.testing.assert_array_equal(out.wav_orig, np.asarray(ref.wav_orig))
    assert out.mel_orig_img.shape == ref.mel_orig_img.shape
    assert out.mel_denoised_diff_img.dtype == np.uint8


def _entries(module, names):
  return [module.Entry(stem=Path(n).stem, basename=Path(n).name,
                       wav_absolute_path=Path("/data") / n) for n in names]


@pytest.mark.parametrize("names,wanted,message", [
    (["a.wav", "b.wav"], {"a.wav", "c.wav"}, "Missing: \\['c.wav'\\]"),
    (["x/a.wav", "y/a.wav", "b.wav"], {"a.wav"}, "match multiple files"),
    # a duplicate must not make up for a missing name
    (["x/a.wav", "y/a.wav"], {"a.wav", "b.wav"}, "Missing: \\['b.wav'\\]"),
])
def test_select_entries_errors_match_jax(names, wanted, message):
  with pytest.raises(ValueError, match=message):
    jv.select_entries(_entries(jax_data, names), wanted, False, SEED)
  with pytest.raises(ValueError, match=message):
    pv.select_entries(_entries(port_data, names), wanted, False, SEED)


def test_select_entries_choices_match_jax():
  names = ["a.wav", "b.wav", "c.wav", "d.wav"]
  jax, port = _entries(jax_data, names), _entries(port_data, names)
  for seed in range(5):
    assert ([e.basename for e in pv.select_entries(port, set(), False, seed)]
            == [e.basename for e in jv.select_entries(jax, set(), False,
                                                      seed)])
  assert pv.select_entries(port, set(), True, 0) == port
  assert [e.basename for e in pv.select_entries(
      port, {"b.wav", "d.wav"}, False, 0)] == ["b.wav", "d.wav"]
