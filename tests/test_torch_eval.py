"""The port's host evaluation stack against the JAX package's, on the CPU:
every metric on the same seeded arrays (to 1e-12 relative), the numpy
spectrogram render against matplotlib's (``plot_melspec_np``), the PNG
codec against matplotlib's files, ``write_tsv`` against pandas byte for
byte, the JAX asserts that the port turns into ``ValueError``, and the
host helpers of this slice (durations, crops, concatenation, the save
schedule, ``StepTimer``, ``trace``)."""

import csv
import datetime
import json
import struct
import zlib
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
from matplotlib import colormaps  # noqa: E402
from matplotlib import pyplot as plt  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from waveglow_tpu import profiling as jax_profiling  # noqa: E402
from waveglow_tpu.dsp import audio_io as jax_audio  # noqa: E402
from waveglow_tpu.eval import metrics as jm  # noqa: E402
from waveglow_tpu.eval import plots as jp  # noqa: E402
from waveglow_tpu.eval import validation as jv  # noqa: E402
from waveglow_tpu.training import data as jax_data  # noqa: E402
from waveglow_tpu.training import schedule as jax_schedule  # noqa: E402
from waveglow_tpu_torch import profiling  # noqa: E402
from waveglow_tpu_torch.dsp import audio_io  # noqa: E402
from waveglow_tpu_torch.eval import metrics as pm  # noqa: E402
from waveglow_tpu_torch.eval import plots as pp  # noqa: E402
from waveglow_tpu_torch.eval import validation as pv  # noqa: E402
from waveglow_tpu_torch.eval.png import read_png, write_png  # noqa: E402
from waveglow_tpu_torch.training import data as port_data  # noqa: E402
from waveglow_tpu_torch.training import schedule  # noqa: E402

METRIC_RTOL = 1e-12
# the SSIM metric over the port's render against over matplotlib's: 3e-4
# was measured on seeded random mels before the port was written
RENDER_SSIM_ATOL = 2e-3
# the share of the raw render's pixels equal to matplotlib's (the rest are
# spine fringes off by one level of 255)
RENDER_EQUAL_SHARE_MIN = 0.99
RENDER_FRAMES = (100, 413, 826)


def seeded_mels(seed, frames_a, frames_b, n_mels=80):
  rng = np.random.default_rng(seed)
  a = rng.uniform(-11.0, 1.0, (n_mels, frames_a))
  b = a[:, :frames_b] if frames_b <= frames_a else np.pad(
      a, ((0, 0), (0, frames_b - frames_a)), mode="edge")
  return a, b + rng.normal(0.0, 0.8, b.shape)


def close(got, want):
  np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=0)


# -- metrics ----------------------------------------------------------------------

@pytest.mark.parametrize("frames", [(37, 41), (41, 37), (30, 30)])
def test_dtw_cost_and_path_equal_jax(frames):
  a, b = seeded_mels(0, *frames, n_mels=16)
  cost, path = pm.dtw(a.T, b.T)
  jcost, jpath = jm.dtw(a.T, b.T)
  close(cost, jcost)
  assert path == jpath
  got = pm.align_mels_with_dtw(a, b)
  want = jm.align_mels_with_dtw(a, b)
  for g, w in zip(got, want):
    close(np.asarray(g), np.asarray(w))
  close(pm.get_msd(cost, len(path)), jm.get_msd(jcost, len(jpath)))


def test_mfccs_equal_jax():
  a, _ = seeded_mels(1, 50, 50)
  close(pm.mel_to_mfccs(a), jm.mel_to_mfccs(a))
  close(pm.mel_to_mfccs(a, 24), jm.mel_to_mfccs(a, 24))


@pytest.mark.parametrize("use_dtw", [True, False])
@pytest.mark.parametrize("take_log", [False, True])
@pytest.mark.parametrize("frames", [(60, 64), (64, 60)])
def test_mcd_penalty_frames_equal_jax(use_dtw, take_log, frames):
  a, b = seeded_mels(2, *frames)
  if take_log:
    a, b = np.exp(a), np.exp(b)
  got = pm.get_metrics_mels(a, b, use_dtw=use_dtw, take_log=take_log)
  want = jm.get_metrics_mels(a, b, use_dtw=use_dtw, take_log=take_log)
  close(got[:2], want[:2])
  assert got[2] == want[2]


@pytest.mark.parametrize("frames", [(50, 53), (53, 50), (50, 50)])
def test_cosine_equal_jax(frames):
  a, b = seeded_mels(3, *frames)
  b[5] = 0.0   # a zero channel: NaN distance, counted as 1
  close(pm.cosine_dist_mels(a, b), jm.cosine_dist_mels(a, b))
  for g, w in zip(pm.make_same_dim(a, b), jm.make_same_dim(a, b)):
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(40, 57), (40, 57, 3)])
def test_ssim_equal_jax(shape):
  rng = np.random.default_rng(4)
  a = rng.integers(0, 256, shape).astype(np.uint8)
  b = np.clip(a + rng.normal(0, 20, shape), 0, 255).astype(np.uint8)
  score, diff = pm.calculate_structural_similarity_np(a, b)
  jscore, jdiff = jm.calculate_structural_similarity_np(a, b)
  close(score, jscore)
  np.testing.assert_array_equal(diff, jdiff)
  if len(shape) == 2:
    close(pm.structural_similarity(a, b), jm.structural_similarity(a, b))


def test_file_ssim_reads_stored_bytes(tmp_path):
  rng = np.random.default_rng(5)
  a = rng.integers(0, 256, (30, 44, 3)).astype(np.uint8)
  b = rng.integers(0, 256, (30, 44, 3)).astype(np.uint8)
  write_png(tmp_path / "a.png", a)
  plt.imsave(tmp_path / "b.png", b)     # RGBA, adaptive filters
  score, diff = pm.calculate_structural_similarity(tmp_path / "a.png",
                                                   tmp_path / "b.png")
  want, want_diff = jm.calculate_structural_similarity_np(a, b)
  close(score, want)
  np.testing.assert_array_equal(diff, want_diff)


# -- the JAX asserts that raise ValueError in the port -----------------------

ASSERT_CASES = {
    "make_same_dim": (lambda m: m.make_same_dim(np.zeros((80, 10)),
                                                np.zeros((40, 12)))),
    "calculate_structural_similarity_np": (
        lambda m: m.calculate_structural_similarity_np(
            np.zeros((10, 12, 3), np.uint8), np.zeros((10, 13, 3), np.uint8))),
}


@pytest.mark.parametrize("name", sorted(ASSERT_CASES))
def test_metric_asserts_are_value_errors(name):
  with pytest.raises(AssertionError):
    ASSERT_CASES[name](jm)
  with pytest.raises(ValueError):
    ASSERT_CASES[name](pm)


def test_select_entries_from_nothing_is_a_value_error():
  with pytest.raises(AssertionError):
    jv.select_entries([], set(), full_run=False, seed=1)
  with pytest.raises(ValueError, match="no entries"):
    pv.select_entries([], set(), full_run=False, seed=1)


# -- the spectrogram render ------------------------------------------------------

def test_viridis_table_is_matplotlibs():
  want = colormaps["viridis"](np.arange(256), bytes=True)[:, :3]
  np.testing.assert_array_equal(pp.VIRIDIS, want)
  assert pp.VIRIDIS.shape == (256, 3) and pp.VIRIDIS.dtype == np.uint8


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_colormap_indices_equal_matplotlibs(dtype):
  from matplotlib import colors
  mel = np.random.default_rng(6).uniform(-11.5, 1.3, (80, 300)).astype(dtype)
  norm = colors.Normalize()
  norm.autoscale_None(mel)
  want = colormaps["viridis"](norm(mel), bytes=True)[..., :3]
  np.testing.assert_array_equal(pp.VIRIDIS[pp.colormap_indices(mel)], want)


@pytest.mark.parametrize("frames", RENDER_FRAMES)
def test_raw_render_against_matplotlib(frames, record_property):
  a, b = seeded_mels(7, frames, frames - 1)
  a, b = a.astype(np.float32), b.astype(np.float32)
  raw_a, labeled_a = pp.plot_melspec_np(a)
  raw_b, _ = pp.plot_melspec_np(b)
  jraw_a, jlabeled_a = jp.plot_melspec_np(a)
  jraw_b, _ = jp.plot_melspec_np(b)
  assert raw_a.shape == jraw_a.shape == (500, int(1.6 * frames), 3)
  assert raw_b.shape == jraw_b.shape
  assert labeled_a.shape == jlabeled_a.shape and labeled_a.dtype == np.uint8
  share = float((raw_a == jraw_a).all(-1).mean())
  record_property("equal_pixel_share", share)
  print(f"{frames} frames: {share:.6f} of the raw render's pixels equal "
        "matplotlib's")
  assert share >= RENDER_EQUAL_SHARE_MIN
  ssim, _ = pm.calculate_structural_similarity_np(
      *pp.make_same_width_by_filling_white([raw_a, raw_b]))
  jssim, _ = jm.calculate_structural_similarity_np(
      *jp.make_same_width_by_filling_white([jraw_a, jraw_b]))
  record_property("ssim_port_minus_jax", ssim - jssim)
  assert abs(ssim - jssim) <= RENDER_SSIM_ATOL


def test_render_layout():
  """The data box inside 15 px margins and a black spine; the labeled
  render keeps the canvas and adds a viridis bar on the right."""
  mel = np.linspace(0.0, 1.0, 80)[:, None].repeat(100, 1)   # rows 0 -> 1
  raw, labeled = pp.plot_melspec_np(mel)
  assert (raw[:14] == 255).all() and (raw[:, :14] == 255).all()
  assert (raw[15, 15:146] == 0).all() and (raw[15:486, 15] == 0).all()
  # origin lower: the bottom data row is the first colour, the top the last
  np.testing.assert_array_equal(raw[483, 80], pp.VIRIDIS[0])
  np.testing.assert_array_equal(raw[17, 80], pp.VIRIDIS[255])
  bar_col = labeled[17:484, 130]
  assert (np.diff(bar_col.astype(int).sum(-1)) <= 0).mean() > 0.9
  np.testing.assert_array_equal(labeled[:, :100], raw[:, :100])


@pytest.mark.parametrize("frames", [1, 10, 19])
def test_narrow_renders_widen_to_the_margins(frames):
  raw, labeled = pp.plot_melspec_np(np.random.default_rng(8).random(
      (80, frames)))
  assert raw.shape == labeled.shape == (500, 31, 3)
  assert (raw[250, 15] == 0).all() and (raw[250, 16] == 0).all()


def test_stacking_pads_with_white():
  a = np.zeros((2, 3, 3), np.uint8)
  b = np.zeros((1, 5, 3), np.uint8)
  for mod in (pp, jp):
    got = mod.stack_images_vertically([a, b])
    assert got.shape == (3, 5, 3)
    assert (got[:2, 3:] == 255).all() and (got[:2, :3] == 0).all()
  for g, w in zip(pp.make_same_width_by_filling_white([a, b]),
                  jp.make_same_width_by_filling_white([a, b])):
    np.testing.assert_array_equal(g, w)


# -- PNG ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
  img = np.random.default_rng(9).integers(0, 256, (17, 23, channels)
                                          ).astype(np.uint8)
  write_png(tmp_path / "x.png", img)
  got = read_png(tmp_path / "x.png")
  np.testing.assert_array_equal(got, img)
  # and matplotlib reads what the port writes
  mpl = plt.imread(tmp_path / "x.png")
  np.testing.assert_array_equal(np.rint(mpl * 255).astype(np.uint8), img)


def test_png_reads_matplotlibs_files(tmp_path):
  raw, labeled = jp.plot_melspec_np(
      np.random.default_rng(10).standard_normal((80, 60)))
  for name, img in (("raw", raw), ("labeled", labeled)):
    path = tmp_path / f"{name}.png"
    jp.save_image(path, img)     # plt.imsave: RGBA, adaptive filters
    got = read_png(path)
    assert got.shape == img.shape[:2] + (4,)
    np.testing.assert_array_equal(got[..., :3], img)
    assert (got[..., 3] == 255).all()
    want = np.rint(plt.imread(path) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def _png_with_every_filter(img):
  """A PNG of ``img`` whose row y is stored with filter type y % 5."""
  height, width, bpp = img.shape
  rows = img.reshape(height, -1).astype(np.int64)
  out = []
  for y in range(height):
    cur = rows[y]
    up = rows[y - 1] if y else np.zeros_like(cur)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
    kind = y % 5
    if kind == 0:
      pred = np.zeros_like(cur)
    elif kind == 1:
      pred = left
    elif kind == 2:
      pred = up
    elif kind == 3:
      pred = (left + up) // 2
    else:
      p = left + up - up_left
      pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
      pred = np.where((pa <= pb) & (pa <= pc), left,
                      np.where(pb <= pc, up, up_left))
    out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

  def chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
  header = struct.pack(">IIBBBBB", width, height, 8, {3: 2, 4: 6}[bpp], 0, 0,
                       0)
  return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
          + chunk(b"IDAT", zlib.compress(b"".join(out)))
          + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_undoes_all_five_filters(tmp_path, channels):
  img = np.random.default_rng(11).integers(0, 256, (15, 9, channels)
                                           ).astype(np.uint8)
  (tmp_path / "f.png").write_bytes(_png_with_every_filter(img))
  np.testing.assert_array_equal(read_png(tmp_path / "f.png"), img)
  np.testing.assert_array_equal(
      np.rint(plt.imread(tmp_path / "f.png") * 255).astype(np.uint8), img)


def test_png_rejects_what_it_does_not_read(tmp_path):
  (tmp_path / "no.png").write_bytes(b"GIF89a")
  with pytest.raises(ValueError, match="not a PNG"):
    read_png(tmp_path / "no.png")
  data = bytearray(_png_with_every_filter(np.zeros((2, 2, 3), np.uint8)))
  data[24] = 16   # bit depth 16
  (tmp_path / "deep.png").write_bytes(bytes(data))
  with pytest.raises(ValueError, match="8-bit"):
    read_png(tmp_path / "deep.png")
  with pytest.raises(ValueError, match="uint8"):
    write_png(tmp_path / "bad.png", np.zeros((2, 2), np.uint8))


# -- write_tsv ----------------------------------------------------------------------

TSV_ROWS = [
    {"name": "a\tb", "quote": 'say "x"', "int": 1, "int_gap": 4,
     "float": 0.1, "mixed": 3, "flag": True, "none": None, "nan": float("nan"),
     "path": Path("/x/y.wav"), "tiny": 1e-05, "f32": np.float32(0.1),
     "f32_mixed": np.float32(0.1), "big": 1e22, "np_int": np.int64(7)},
    {"name": "plain", "quote": "", "int": 2, "int_gap": None,
     "float": 2.0, "mixed": 2.5, "flag": False, "none": "z",
     "nan": 1.5, "path": Path("rel/p.wav"), "tiny": -0.0,
     "f32": np.float32(3.0), "f32_mixed": None, "big": 123456789.12345679,
     "np_int": np.int64(-3)},
]


def test_write_tsv_is_pandas_to_csv_byte_for_byte(tmp_path):
  pv.write_tsv(tmp_path / "port.tsv", TSV_ROWS)
  df = pd.DataFrame(data=[r.values() for r in TSV_ROWS],
                    columns=TSV_ROWS[0].keys())
  df.to_csv(tmp_path / "pandas.tsv", sep="\t", index=False)
  assert ((tmp_path / "port.tsv").read_bytes()
          == (tmp_path / "pandas.tsv").read_bytes())


def test_write_tsv_rejects_ragged_or_no_rows(tmp_path):
  with pytest.raises(ValueError, match="at least one row"):
    pv.write_tsv(tmp_path / "x.tsv", [])
  with pytest.raises(ValueError, match="columns"):
    pv.write_tsv(tmp_path / "x.tsv", [{"a": 1}, {"b": 1}])


def _validation_entry(mod, result_cls, data_mod, i):
  rng = np.random.default_rng(i)
  result = result_cls(
      wav=None, wav_denoised=None, sampling_rate=22050,
      inference_duration_s=float(rng.random()),
      denoising_duration_s=float(rng.random()),
      was_overamplified=bool(i % 2),
      timepoint=datetime.datetime(2024, 1, 2, 3, 4, 5))
  return mod.ValidationEntry(
      entry=data_mod.Entry(stem=f"u{i}", basename=f"u{i}.wav",
                           wav_absolute_path=Path(f"/d/u{i}.wav")),
      inference_result=result, seed=5, iteration=10 * i,
      timepoint=datetime.datetime(2024, 1, 2, 3, 4, 5 + i),
      inferred_duration_s=float(rng.random()), diff_frames=i - 1,
      mfcc_no_coeffs=16, mfcc_dtw_mcd=float(rng.random()),
      mfcc_dtw_penalty=float(rng.random()), mfcc_dtw_frames=40 + i,
      mcd=float(rng.random()), mcd_penalty=0.0, mcd_frames=41,
      structural_similarity=float(rng.random()),
      cosine_similarity=float(rng.random()), denoiser_strength=0.0005,
      sigma=0.666)


def test_report_equals_the_jax_dataframe(tmp_path):
  """``get_rows`` + ``write_tsv`` write the bytes of the JAX command's
  ``get_df(...).to_csv(sep="\\t", index=False)``."""
  from waveglow_tpu.inference.synthesizer import InferenceResult as JaxResult
  from waveglow_tpu_torch.inference.synthesizer import InferenceResult
  port = [_validation_entry(pv, InferenceResult, port_data, i)
          for i in range(3)]
  jax = [_validation_entry(jv, JaxResult, jax_data, i) for i in range(3)]
  pv.write_tsv(tmp_path / "port.csv", pv.get_rows(port))
  jv.get_df(jax).to_csv(tmp_path / "jax.csv", sep="\t", index=False)
  assert ((tmp_path / "port.csv").read_bytes()
          == (tmp_path / "jax.csv").read_bytes())
  with open(tmp_path / "port.csv", newline="") as f:
    assert len(next(csv.reader(f, delimiter="\t"))) == 23
  # the command's top-level total.csv: the iterations' reports concatenated
  pv.write_tsv(tmp_path / "port_all.csv", pv.get_rows(port[:2])
               + pv.get_rows(port[2:]))
  pd.concat([jv.get_df(jax[:2]), jv.get_df(jax[2:])]).to_csv(
      tmp_path / "jax_all.csv", sep="\t", index=False)
  assert ((tmp_path / "port_all.csv").read_bytes()
          == (tmp_path / "jax_all.csv").read_bytes())


# -- host helpers --------------------------------------------------------------------

def test_audio_helpers_equal_jax(tmp_path):
  rng = np.random.default_rng(12)
  wav = (rng.uniform(-0.5, 0.5, 5000) * 32767).astype(np.int16)
  wavfile.write(tmp_path / "a.wav", 22050, wav)
  assert audio_io.get_duration_s(wav, 22050) == jax_audio.get_duration_s(
      wav, 22050)
  assert (audio_io.get_duration_s_file(tmp_path / "a.wav")
          == jax_audio.get_duration_s_file(tmp_path / "a.wav"))
  for duration in (0.0, 0.1, 1.23456, 7.5):
    assert (audio_io.get_sample_count(22050, duration)
            == jax_audio.get_sample_count(22050, duration))
  for length in (100, 5000, 6000):
    got = audio_io.get_wav_segment(wav, length, np.random.default_rng(3))
    want = jax_audio.get_wav_segment(wav, length, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
  parts = [wav[:100], wav[100:350], wav[350:351]]
  for audios in (parts, parts[:1]):
    got = audio_io.concatenate_audios(audios, 0.01, 22050)
    want = jax_audio.concatenate_audios(audios, 0.01, 22050)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int16


def test_get_next_save_it_equals_jax():
  for epochs, batches, ipc, epc in ((3, 4, 5, 1), (2, 7, 0, 0), (4, 3, 2, 2)):
    port = schedule.SaveIterationSettings(
        epochs=epochs, batch_iterations=batches, iters_per_checkpoint=ipc,
        epochs_per_checkpoint=epc)
    jax = jax_schedule.SaveIterationSettings(
        epochs=epochs, batch_iterations=batches, iters_per_checkpoint=ipc,
        epochs_per_checkpoint=epc)
    for it in range(1, epochs * batches + 3):
      assert (schedule.get_next_save_it(it, port)
              == jax_schedule.get_next_save_it(it, jax))
  with pytest.raises(ValueError):
    schedule.get_next_save_it(0, port)


def test_step_timer_reports_like_jax(monkeypatch):
  clock = iter(np.arange(0.0, 100.0, 0.25))
  monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
  port = profiling.StepTimer(warmup_steps=1)
  for _ in range(4):
    with port.step():
      pass
  clock = iter(np.arange(0.0, 100.0, 0.25))
  monkeypatch.setattr(jax_profiling.time, "perf_counter", lambda: next(clock))
  jax = jax_profiling.StepTimer(warmup_steps=1)
  for _ in range(4):
    with jax.step():
      pass
  assert port.report(12.0, "samples") == jax.report(12.0, "samples")
  assert port.report(12.0, "samples")["throughput"] == 48.0
  with pytest.raises(RuntimeError):
    profiling.StepTimer().stop()


def test_trace_writes_a_chrome_trace(tmp_path):
  import torch
  with profiling.trace(tmp_path / "t", device="cpu"):
    torch.ones(8) @ torch.ones(8)
  events = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
  assert any("aten::" in e.get("name", "") for e in events["traceEvents"])
  with profiling.trace(None):   # no folder, no trace
    pass
  with pytest.raises(KeyError):
    with profiling.trace(tmp_path / "failed", device="cpu"):
      raise KeyError("inside")
  assert (tmp_path / "failed" / profiling.TRACE_FILE).is_file()


def test_tensorboard_flush(tmp_path):
  from waveglow_tpu_torch.training.tboard import make_tensorboard_logger
  tb = make_tensorboard_logger(tmp_path / "tb")
  tb.log_training(1, 0.5, 0.1)
  tb.flush()
  assert any(p.stat().st_size > 0 for p in (tmp_path / "tb").iterdir())
  tb.close()
