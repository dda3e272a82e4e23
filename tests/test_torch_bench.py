"""The port's bench (``waveglow_tpu_torch/bench.py``) and its ``benchmark``
command on the CPU at a tiny config: the workload arrays against the JAX
bench's draws (the repo-root ``bench.py``), the training section's first
losses against the JAX package's train step on the same weights and audio,
the line's keys, the budget's skips, a failing section, and the command's
flags. The JAX bench itself runs the full-size model only, so its draws
are re-derived here."""

import copy
import functools
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveglow_tpu.cli import main as jax_cli
from waveglow_tpu.dsp.mel import MelSTFT as JaxMel
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import init_params as jax_init
from waveglow_tpu.training import step as jax_step
from waveglow_tpu_torch import bench
from waveglow_tpu_torch.cli import main as cli
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams

TINY = {"n_flows": "2", "n_layers": "2", "n_channels": "32",
        "segment_length": "2048"}
BATCH, FRAMES, TRAIN_BATCH = 2, 40, 2
# 40 frames stream as two 16-frame windows and a third (halo 5 frames)
ARGS = ["--device", "cpu", "--batch", str(BATCH), "--frames", str(FRAMES),
        "--iters", "2", "--latency-iters", "1", "--train-iters", "1",
        "--stream-chunk-frames", "16", "--train-batch", str(TRAIN_BATCH)]
# The keys of the JAX bench's line (bench.py:109-128, :165-218, :238-279,
# :283-293), every section run
JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "headline_dtype_note",
    "dtype", "batch", "utterance_seconds", "per_utterance_realtime_factor",
    "platform", "device", "batch1_latency_s_p50",
    "per_utterance_realtime_factor_batch1",
    "streaming_first_audio_latency_s_p50", "streaming_first_chunk_audio_s",
    "streaming_chunk_frames", "streaming_first_audio_denoised_s_p50",
    "training_samples_per_sec", "training_step_seconds",
    "training_loss_finite", "training_samples_per_sec_batch24",
    "training_batch24_config"}
# The JAX train step's loss against the port's: f32 sums in other orders
# (tests/test_torch_training.py::test_train_step_matches_jax's bound)
LOSS_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads (the suite runs files in parallel workers)."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def tiny_hparams():
  return overwrite_custom_hparams(HParams(), TINY)


@functools.lru_cache(maxsize=None)
def tiny_params():
  """The JAX package's weights for TINY from seed 0 (as the bench draws
  them), every zero-initialised ``end`` conv randomised (a zero end hides
  the WN stack from the loss)."""
  params = jax_init(JaxConfig.from_hparams(jax_overwrite(JaxHParams(), TINY)),
                    seed=0)
  rng = np.random.default_rng(100)
  for flow in params["flows"]:
    for k in ("w", "b"):
      flow["wn"]["end"][k] = (rng.standard_normal(
          flow["wn"]["end"][k].shape) * 0.05).astype(np.float32)
  return params


@functools.lru_cache(maxsize=None)
def bench_run(dtype):
  """The bench at TINY on the CPU, on :func:`tiny_params` (carried into the
  port through its from-numpy route, as the bench does), with what it
  passed to the synthesis calls and to each train step recorded."""
  record = {"mels": [], "steps": []}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(bench, "init_params",
               lambda config, seed: copy.deepcopy(tiny_params()))
    infer, make = bench.infer, bench.make_train_step

    def recording_infer(params, config, spect, **kwargs):
      record["mels"].append(spect.clone())
      return infer(params, config, spect, **kwargs)

    def recording_make(config, hp, mel_op, optimizer):
      step = make(config, hp, mel_op, optimizer)
      rec = {"hparams": hp, "audio": [], "losses": []}
      record["steps"].append(rec)

      def run(params, audio):
        loss = step(params, audio)
        rec["audio"].append(audio.clone())
        rec["losses"].append(float(loss))
        return loss

      return run

    mp.setattr(bench, "infer", recording_infer)
    mp.setattr(bench, "make_train_step", recording_make)
    args = bench.build_parser().parse_args(ARGS + ["--dtype", dtype])
    line = bench.run_benchmark(args, hparams=tiny_hparams())
  return line, record


def test_workload_arrays_are_the_jax_benchs():
  """The mel and both training batches, bit for bit the JAX bench's draws
  from one default_rng(0), in its order."""
  rng = np.random.default_rng(0)
  mel = rng.standard_normal((BATCH, 80, FRAMES)).astype(np.float32)  # :90-93
  audio = rng.uniform(-0.5, 0.5, (TRAIN_BATCH, 2048)).astype(
      np.float32)  # :242-244
  audio24 = rng.uniform(-0.5, 0.5, (24, 2048)).astype(np.float32)  # :268-9
  _, record = bench_run("float32")
  mels = [m.numpy() for m in record["mels"]]
  # warm-up and 2 timed calls on the batch, warm-up and 1 call on row 0
  assert len(mels) == 5
  for m in mels[:3]:
    assert np.array_equal(m, mel)
  for m in mels[3:]:
    assert np.array_equal(m, mel[:1])
  batch8, batch24 = record["steps"]
  assert len(batch8["audio"]) == len(batch24["audio"]) == 2
  for a in batch8["audio"]:
    assert np.array_equal(a.numpy(), audio)
  for a in batch24["audio"]:
    assert np.array_equal(a.numpy(), audio24)
  assert (batch8["hparams"].batch_size, batch8["hparams"].grad_accum) == (
      TRAIN_BATCH, 1)
  assert (batch24["hparams"].batch_size, batch24["hparams"].grad_accum) == (
      24, 3)


@pytest.mark.parametrize("section", [0, 1], ids=["batch", "batch24"])
def test_first_training_loss_matches_jax(section):
  """Each training section's first loss (its warm-up step, from the
  initial weights) against JAX ``make_train_step`` on the same weights and
  audio with the section's batch and grad_accum, f32: LOSS_REL."""
  _, record = bench_run("float32")
  rec = record["steps"][section]
  hp = jax_overwrite(JaxHParams(), {
      **TINY, "compute_dtype": "float32",
      "batch_size": str(rec["hparams"].batch_size),
      "grad_accum": str(rec["hparams"].grad_accum)})
  optimizer = jax_step.make_optimizer(hp.learning_rate)
  step = jax_step.make_train_step(JaxConfig.from_hparams(hp), hp,
                                  JaxMel(hp), optimizer)
  _, ref = step(jax_step.init_state(tiny_params(), optimizer),
                jnp.asarray(rec["audio"][0].numpy()))
  assert rec["losses"][0] == pytest.approx(float(ref), rel=LOSS_REL)
  assert rec["losses"][1] != rec["losses"][0]  # Adam moved the weights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_line_keys_are_the_jax_benchs(dtype):
  """The JAX bench's keys without vs_baseline (a TPU target) and
  headline_dtype_note (a TPU figure), with the card's power limit and the
  launch counts (the backward kernels' in bf16 only); rates and times
  finite and positive."""
  line, _ = bench_run(dtype)
  want = (JAX_KEYS - {"vs_baseline", "headline_dtype_note"}) | {
      "power_limit_w", "wn_kernel_launches"}
  if dtype == "bfloat16":
    want.add("bwd_kernel_launches")
  assert set(line) == want
  assert list(line)[:3] == ["metric", "value", "unit"]
  assert line["metric"] == "audio_seconds_synthesized_per_sec_per_chip"
  assert (line["dtype"], line["batch"], line["platform"], line["device"],
          line["power_limit_w"]) == (dtype, BATCH, "cpu", "cpu", None)
  assert line["streaming_chunk_frames"] == 16
  assert line["training_batch24_config"] == "grad_accum=3"
  assert line["training_loss_finite"] is True
  # the CPU runs the plain versions: no kernel launched
  assert line["wn_kernel_launches"] == line.get("bwd_kernel_launches", 0) == 0
  for key in ("value", "utterance_seconds", "per_utterance_realtime_factor",
              "batch1_latency_s_p50", "per_utterance_realtime_factor_batch1",
              "streaming_first_audio_latency_s_p50",
              "streaming_first_chunk_audio_s",
              "streaming_first_audio_denoised_s_p50",
              "training_samples_per_sec", "training_step_seconds",
              "training_samples_per_sec_batch24"):
    assert math.isfinite(line[key]) and line[key] > 0, key
  assert json.loads(json.dumps(line)) == line


def test_budget_zero_skips_latency_and_training():
  """Past the budget the optional sections are reported skipped under the
  JAX bench's keys, and only the throughput section runs."""
  args = bench.build_parser().parse_args(ARGS + ["--budget-seconds", "0"])
  line = bench.run_benchmark(args, hparams=tiny_hparams())
  assert {k: v for k, v in line.items() if k.endswith("_skipped")} == {
      "latency_skipped": "budget", "training_skipped": "budget",
      "training_batch24_skipped": "budget"}
  assert not [k for k in line if k.startswith(("batch1", "streaming",
                                               "training_samples"))]
  assert line["value"] > 0


def test_sections_left_out_report_nothing():
  args = bench.build_parser().parse_args(
      ARGS + ["--no-latency", "--no-train"])
  line = bench.run_benchmark(args, hparams=tiny_hparams())
  assert not [k for k in line if k.startswith(("batch1", "streaming",
                                               "training"))]


FAULTS = {"synthesis": "infer", "latency": "stream_chunks",
          "training": "make_train_step"}


def boom(*args, **kwargs):
  raise RuntimeError("boom")


@pytest.mark.parametrize("section", FAULTS)
def test_a_failing_section_raises(section, monkeypatch):
  monkeypatch.setattr(bench, FAULTS[section], boom)
  args = bench.build_parser().parse_args(ARGS)
  with pytest.raises(RuntimeError, match="boom"):
    bench.run_benchmark(args, hparams=tiny_hparams())


@pytest.mark.parametrize("section", FAULTS)
def test_benchmark_command_exits_1_on_a_failing_section(section, monkeypatch,
                                                        capsys, tmp_path):
  """The command prints no line (and no ``*_error`` key) and exits 1."""
  monkeypatch.setattr(bench, "HParams", tiny_hparams)
  monkeypatch.setattr(bench, FAULTS[section], boom)
  rc = cli.run(["benchmark", "--device", "cpu", "--batch", "1", "--frames",
                str(FRAMES), "--iters", "1", "--log",
                str(tmp_path / "bench.log")])
  assert rc == 1
  assert capsys.readouterr().out == ""
  assert "boom" in (tmp_path / "bench.log").read_text()


def test_benchmark_command_prints_one_line(monkeypatch, capsys, tmp_path):
  """``benchmark`` runs the bench in this process with the bench's own
  latency and training defaults and prints its line alone on stdout."""
  monkeypatch.setattr(bench, "HParams", tiny_hparams)
  rc = cli.run(["benchmark", "--device", "cpu", "--batch", "1", "--frames",
                str(FRAMES), "--iters", "1", "--dtype", "float32", "--log",
                str(tmp_path / "bench.log")])
  out = capsys.readouterr().out.splitlines()
  assert rc == 0 and len(out) == 1
  line = json.loads(out[0])
  assert (line["batch"], line["dtype"], line["streaming_chunk_frames"]) == (
      1, "float32", 128)
  assert "training_samples_per_sec_batch24" in line


def test_bench_defaults_to_the_card():
  args = bench.build_parser().parse_args(["--iters", "1"])
  with pytest.raises(RuntimeError, match="no CUDA device"):
    bench.run_benchmark(args, hparams=tiny_hparams())


@pytest.mark.parametrize("argv", [
    ["benchmark"],
    ["benchmark", "--batch", "3", "--frames", "50", "--iters", "2",
     "--dtype", "float32"]])
def test_parser_takes_the_jax_commands_flags(argv):
  ours = vars(cli.build_parser().parse_args(argv))
  theirs = vars(jax_cli.build_parser().parse_args(argv))
  for key in ("batch", "frames", "iters", "dtype"):
    assert ours[key] == theirs[key], key
  assert ours["device"] == "cuda"


@pytest.mark.parametrize("flag", [["--compile-cache", "cache"],
                                  ["--pallas"], ["--no-pallas"]])
def test_tpu_only_flags_are_refused(flag):
  """XLA's compile cache and the Pallas switch have no counterpart: the
  port has one synthesis path, every WN layer through its kernel."""
  with pytest.raises(SystemExit) as e:
    bench.build_parser().parse_args(flag)
  assert e.value.code == 2
  if flag[0] == "--compile-cache":
    with pytest.raises(SystemExit) as e:
      cli.build_parser().parse_args(["benchmark", *flag])
    assert e.value.code == 2
    assert jax_cli.build_parser().parse_args(
        ["benchmark", *flag]).compile_cache == "cache"
