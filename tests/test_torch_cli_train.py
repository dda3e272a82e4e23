"""The port's training and validation commands end to end on the CPU
(``python -m waveglow_tpu_torch ... --device cpu``, tiny config): the JAX
``tests/test_cli.py::TestEndToEnd`` sequence, ``train`` ->
``continue-train`` -> ``--auto-resume`` -> ``validate`` ->
``synthesize --include-stats``, with the refusal over existing
checkpoints, ``--profile-dir``, the checkpoint filters, and every written
file held to what the port computes in this process. The tests of this
file run in order on one workspace."""

import csv
import json
import sys
import wave
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from waveglow_tpu_torch.checkpointing import load_checkpoint_any
from waveglow_tpu_torch.checkpointing.store import (
    filter_checkpoints, get_all_checkpoint_iterations)
from waveglow_tpu_torch.cli import main as cli
from waveglow_tpu_torch.cli.synthesis_cmd import InferenceEntry
from waveglow_tpu_torch.dsp.audio_io import convert_wav, normalize_wav
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.eval import metrics
from waveglow_tpu_torch.eval.plots import (make_same_width_by_filling_white,
                                           plot_melspec_np)
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.profiling import TRACE_FILE

TINY = ("n_flows=2,n_channels=32,n_layers=2,segment_length=4096,"
        "iters_per_checkpoint=1,epochs_per_checkpoint=0,epochs=1,"
        "batch_size=2,seed=1")
SEED = 5
COMMANDS = ("download", "train", "continue-train", "validate", "synthesize",
            "synthesize-wav", "serve")
ENTRY_FILES = ("original.wav", "inferred_denoised.wav", "original.mel.npy",
               "inferred_denoised.mel.npy", "original.png",
               "inferred_denoised.png", "diff.png", "comparison.png")


def write_noise_dataset(folder: Path, n=4, seconds=0.4, sr=22050, seed=0):
  folder.mkdir(parents=True, exist_ok=True)
  rng = np.random.default_rng(seed)
  for i in range(n):
    samples = (rng.uniform(-0.3, 0.3, int(sr * seconds))
               * 32767).astype(np.int16)
    with wave.open(str(folder / f"utt{i}.wav"), "wb") as f:
      f.setnchannels(1)
      f.setsampwidth(2)
      f.setframerate(sr)
      f.writeframes(samples.tobytes())


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
  root = tmp_path_factory.mktemp("cli_train")
  write_noise_dataset(root / "train")
  write_noise_dataset(root / "val", n=2, seed=1)
  return root


def run(ws, *args, device="cpu"):
  extra = ["--device", device] if device else []
  return cli.run([*map(str, args), *extra, "--log", str(ws / "cli.log")])


def train_args(ws, command="train", epochs=1, *extra):
  return (command, ws / "train", ws / "val", ws / "ckpts", "--custom-hparams",
          TINY.replace("epochs=1", f"epochs={epochs}"), "--tl-dir",
          ws / "logs", *extra)


def iterations(ws):
  return get_all_checkpoint_iterations(ws / "ckpts")


def read_tsv(path):
  with open(path, newline="") as f:
    return list(csv.DictReader(f, delimiter="\t"))


def expected_pcm(wav):
  return convert_wav(normalize_wav(np.asarray(wav)), np.int16)


def test_parser_lists_the_ports_seven_commands():
  parser = cli.build_parser()
  sub = next(a for a in parser._actions if a.dest == "command")
  assert tuple(sub.choices) == COMMANDS
  assert "benchmark" not in parser.format_help()


@pytest.mark.parametrize("flag", ["--coordinator-address", "--num-processes",
                                  "--process-id"])
def test_multi_process_flags_are_not_offered(ws, flag, tmp_path):
  """Only train and continue-train take the multi-process flags, as in the
  JAX package; validate refuses them."""
  with pytest.raises(SystemExit) as e:
    cli.build_parser().parse_args(["validate", str(tmp_path), str(tmp_path),
                                   str(ws / "val"), flag, "1"])
  assert e.value.code == 2


@pytest.mark.parametrize("command", ["train", "continue-train"])
def test_training_commands_take_the_multi_process_flags(ws, command,
                                                       tmp_path):
  ns = cli.build_parser().parse_args([
      command, str(ws / "train"), str(ws / "val"), str(tmp_path),
      "--coordinator-address", "127.0.0.1:1234", "--num-processes", "2",
      "--process-id", "1"])
  assert (ns.coordinator_address, ns.num_processes, ns.process_id) == (
      "127.0.0.1:1234", 2, 1)


@pytest.mark.parametrize("cmd", ["train", "continue-train", "validate"])
def test_default_device_is_the_card(ws, cmd, tmp_path):
  (tmp_path / "ck").mkdir()
  args = ((cmd, ws / "train", ws / "val", tmp_path / "ck")
          if cmd != "validate" else (cmd, tmp_path / "ck", tmp_path / "out",
                                     ws / "val"))
  assert run(ws, *args, device=None) == 1
  assert "no CUDA device is available" in (ws / "cli.log").read_text()
  assert not any((tmp_path / "ck").iterdir())
  assert not (tmp_path / "out").exists()


def test_01_train(ws):
  assert run(ws, *train_args(ws, "train", 1, "--profile-dir",
                             ws / "trace")) == 0
  # 4 files, batch 2: 2 steps, a checkpoint each
  assert iterations(ws) == [1, 2]
  steps = [json.loads(line) for line in
           (ws / "logs" / "metrics.jsonl").read_text().splitlines()]
  assert [r["iteration"] for r in steps if r["event"] == "train_step"] == [
      1, 2]
  trace = json.loads((ws / "trace" / TRACE_FILE).read_text())
  assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def test_01b_train_over_checkpoints_is_refused(ws):
  before = {p.name: p.read_bytes() for p in (ws / "ckpts").iterdir()}
  assert run(ws, *train_args(ws)) == 1
  assert "Checkpoints already exist" in (ws / "cli.log").read_text()
  assert {p.name: p.read_bytes() for p in (ws / "ckpts").iterdir()} == before


def test_01c_warm_start_needs_both_flags(ws, tmp_path):
  for extra in (("--warm-start",),
                ("--pre-trained-model", ws / "ckpts" / "1.npz")):
    args = list(train_args(ws, "train", 1, *extra))
    args[3] = tmp_path / "fresh"
    assert run(ws, *args) == 1
    assert "must be used together" in (ws / "cli.log").read_text()
    assert not (tmp_path / "fresh").exists()


def test_02_continue_train(ws):
  assert run(ws, *train_args(ws, "continue-train", 2)) == 0
  assert iterations(ws) == [1, 2, 3, 4]


def test_02b_train_auto_resume(ws):
  assert run(ws, *train_args(ws, "train", 3, "--auto-resume")) == 0
  assert iterations(ws) == [1, 2, 3, 4, 5, 6]
  assert load_checkpoint_any(ws / "ckpts" / "6.npz").iteration == 6


def test_02c_tensorboard_dir_without_the_package_fails_clearly(
    ws, monkeypatch, tmp_path):
  monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
  args = list(train_args(ws, "train", 1, "--tensorboard-dir",
                         tmp_path / "tb"))
  args[3] = tmp_path / "fresh"
  assert run(ws, *args) == 1
  assert "requires the tensorboard package" in (ws / "cli.log").read_text()


def check_validation_dir(ws, out, iteration, stems):
  """Every entry's files, its wav bit for bit in-process synthesis, and
  its row of ``total.csv`` recomputed from the saved mels."""
  rows = read_tsv(out / str(iteration) / "total.csv")
  assert [r["Subpath"] for r in rows] == stems
  synth = Synthesizer(load_checkpoint_any(ws / "ckpts" / f"{iteration}.npz"),
                      device="cpu")
  mel_op = MelSTFT(synth.hparams, device="cpu")
  for row in rows:
    dest = out / str(iteration) / row["Subpath"]
    assert sorted(p.name for p in dest.iterdir()) == sorted(ENTRY_FILES)
    mel = mel_op.get_mel_from_file(ws / "val" / row["Name"]).numpy()
    want = expected_pcm(synth.infer(mel, seed=SEED).wav_denoised)
    _, got = wavfile.read(dest / "inferred_denoised.wav")
    np.testing.assert_array_equal(got, want)
    orig = np.load(dest / "original.mel.npy")
    inferred = np.load(dest / "inferred_denoised.mel.npy")
    np.testing.assert_array_equal(orig, mel)
    mcd_dtw, pen_dtw, frames_dtw = metrics.get_metrics_mels(orig, inferred)
    mcd, pen, frames = metrics.get_metrics_mels(orig, inferred,
                                                use_dtw=False)
    raw = make_same_width_by_filling_white(
        [plot_melspec_np(orig)[0], plot_melspec_np(inferred)[0]])
    want_row = {
        "Iteration": str(iteration), "Seed": str(SEED),
        "MFCC DTW MCD": repr(mcd_dtw), "MFCC DTW PEN": repr(pen_dtw),
        "# MFCC DTW frames": str(frames_dtw), "MCD": repr(mcd),
        "PEN": repr(pen), "# Frames": str(frames),
        "# Difference frames": str(inferred.shape[1] - orig.shape[1]),
        "Cosine Similarity (Padded)": repr(metrics.cosine_dist_mels(
            orig, inferred)),
        "Structural Similarity (Padded)": repr(
            metrics.calculate_structural_similarity_np(*raw)[0])}
    assert {k: row[k] for k in want_row} == want_row
  return rows


def test_03_validate_single(ws):
  out = ws / "validation"
  assert run(ws, "validate", ws / "ckpts", out, ws / "val", "--custom-seed",
             SEED) == 0
  assert sorted(p.name for p in out.iterdir()) == ["6", "total.csv"]
  rows = read_tsv(out / "total.csv")
  assert len(rows) == 1 and len(rows[0]) == 23   # a seeded random entry
  check_validation_dir(ws, out, 6, [rows[0]["Subpath"]])


def test_04_validate_full_run(ws):
  out = ws / "validation_full"
  assert run(ws, "validate", ws / "ckpts", out, ws / "val", "--full-run",
             "--custom-seed", SEED) == 0
  rows = check_validation_dir(ws, out, 6, ["utt0", "utt1"])
  assert read_tsv(out / "total.csv") == rows


@pytest.mark.parametrize("flags,select,lo,hi", [
    (("--min-iteration", 2, "--max-iteration", 3), None, 2, 3),
    (("--select", 4), 4, None, None),
    (("--select", 2, "--min-iteration", 3), 2, 3, None)])
def test_05_validate_filtered_checkpoints(ws, flags, select, lo, hi,
                                          tmp_path):
  out = tmp_path / "validation"
  assert run(ws, "validate", ws / "ckpts", out, ws / "val", "--full-run",
             "--custom-seed", SEED, *flags) == 0
  want = filter_checkpoints(iterations(ws), select=select, min_it=lo,
                            max_it=hi)
  dirs = sorted((int(p.name) for p in out.iterdir() if p.is_dir()))
  assert dirs == want and want
  rows = read_tsv(out / "total.csv")
  assert [int(r["Iteration"]) for r in rows] == [it for it in want
                                                 for _ in range(2)]
  for it in want:
    assert read_tsv(out / str(it) / "total.csv") == [
        r for r in rows if int(r["Iteration"]) == it]


def test_05b_validate_custom_checkpoints_and_files(ws, tmp_path):
  out = tmp_path / "validation"
  assert run(ws, "validate", ws / "ckpts", out, ws / "val",
             "--custom-checkpoints", 1, 5, "--files", "utt1.wav",
             "--custom-seed", SEED) == 0
  rows = read_tsv(out / "total.csv")
  assert [(r["Iteration"], r["Name"]) for r in rows] == [
      ("1", "utt1.wav"), ("5", "utt1.wav")]
  assert run(ws, "validate", ws / "ckpts", tmp_path / "none", ws / "val",
             "--select", 7) == 1
  assert "No checkpoints match" in (ws / "cli.log").read_text()


def test_06_synthesize_include_stats(ws, tmp_path):
  mels = tmp_path / "mels"
  (mels / "sub").mkdir(parents=True)
  src = ws / "validation_full" / "6"
  np.save(mels / "sub" / "a.npy", np.load(src / "utt0" / "original.mel.npy"))
  np.save(mels / "b.npy", np.load(src / "utt1" / "original.mel.npy")[:, :30])
  ckpt = ws / "ckpts" / "6.npz"
  common = ("synthesize", ckpt, mels, "--custom-seed", SEED)
  assert run(ws, *common, "-out", tmp_path / "plain") == 0
  assert run(ws, *common, "--include-stats", "-out", tmp_path / "stats") == 0
  out = tmp_path / "stats"
  for rel in ("sub/a", "b"):
    assert ((out / f"{rel}.wav").read_bytes()
            == (tmp_path / "plain" / f"{rel}.wav").read_bytes())
    for suffix in (".orig.png", ".inferred.png", ".comparison.png"):
      assert (out / f"{rel}{suffix}").is_file()
  rows = read_tsv(out / "stats.csv")
  assert list(rows[0]) == [f.name for f in fields(InferenceEntry)]
  assert [Path(r["mel_path"]).name for r in rows] == ["b.npy", "a.npy"]
  synth = Synthesizer(load_checkpoint_any(ckpt), device="cpu")
  mel_op = MelSTFT(synth.hparams, device="cpu")
  for row in rows:
    mel = np.load(row["mel_path"])
    wav = normalize_wav(synth.infer(mel, seed=SEED,
                                    bucket_frames=64).wav_denoised)
    inferred = mel_op.get_mel(wav).numpy()
    mcd_dtw, pen_dtw, frames_dtw = metrics.get_metrics_mels(mel, inferred)
    assert (row["mcd_dtw"], row["mcd_dtw_penalty"], row["mcd_dtw_frames"]) \
        == (repr(mcd_dtw), repr(pen_dtw), str(frames_dtw))
    assert row["cosine_similarity"] == repr(metrics.cosine_dist_mels(
        mel, inferred))
    assert row["mel_original_frames"] == str(mel.shape[1])
    assert row["iteration"] == "6" and row["seed"] == str(SEED)
