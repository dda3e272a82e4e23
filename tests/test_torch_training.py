"""The port's training path against the JAX package: the mel front end, one
train step (loss, per-leaf grads, params after Adam), the data pipeline's
crops, ``train()`` with save and resume, and checkpoints that each package
resumes from the other's. Same numpy inputs to both packages; every tolerance
is stated in its test.
"""

import functools
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from waveglow_tpu.checkpointing.store import \
    CheckpointWaveglow as JaxCheckpoint
from waveglow_tpu.dsp.mel import MelSTFT as JaxMel
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import init_params
from waveglow_tpu.training import data as jax_data
from waveglow_tpu.training import loop as jax_loop
from waveglow_tpu.training import step as jax_step
from waveglow_tpu.training.loss import waveglow_loss as jax_loss
from waveglow_tpu_torch import native
from waveglow_tpu_torch.checkpointing.from_jax import (
    trainable_params_from_numpy, tree_leaves)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.models.waveglow import WaveGlowConfig
from waveglow_tpu_torch.training import data, loop, step
from waveglow_tpu_torch.training.loop import train
from waveglow_tpu_torch.training.loss import waveglow_loss

FIXTURE = Path(__file__).parent / "fixtures" / "audio.wav"

# The train-step config of tests/test_kernels.py::test_train_step_pallas_*.
STEP_HPARAMS = {"n_flows": "2", "n_layers": "3", "n_channels": "128",
                "segment_length": "2048", "batch_size": "2", "remat": "false"}
LOOP_HPARAMS = {"n_flows": "2", "n_layers": "2", "n_channels": "32",
                "segment_length": "2048", "batch_size": "2",
                "iters_per_checkpoint": "0", "epochs_per_checkpoint": "0",
                "seed": "1234"}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch: the suite runs its files in parallel
  worker processes, and torch's default of one thread per core
  oversubscribes the cores (the port's test files ran about twice as slow
  under that load)."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def fixture_segments(n, length, seed=0):
  """``n`` int16 cuts of the speech fixture at random offsets."""
  sr, wav = wavfile.read(FIXTURE)
  rng = np.random.default_rng(seed)
  starts = rng.integers(0, len(wav) - length, n)
  return sr, [wav[s:s + length] for s in starts]


def write_speech_dataset(folder, n=4, length=6000, seed=0):
  folder.mkdir(parents=True, exist_ok=True)
  sr, cuts = fixture_segments(n, length, seed)
  for i, cut in enumerate(cuts):
    wavfile.write(folder / f"{i:02d}.wav", sr, cut)
  return data.load_dataset(folder)


def to_jax_entries(entries):
  return [jax_data.Entry(e.stem, e.basename, e.wav_absolute_path)
          for e in entries]


def step_model(seed=0):
  """Params of STEP_HPARAMS with every zero-initialised ``end`` conv
  randomised (a zero end hides the WN stack from the loss), and audio."""
  hp = jax_overwrite(JaxHParams(), STEP_HPARAMS)
  params = init_params(JaxConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 1)
  for flow in params["flows"]:
    for k in ("w", "b"):
      flow["wn"]["end"][k] = (rng.standard_normal(
          flow["wn"]["end"][k].shape) * 0.05).astype(np.float32)
  audio = rng.uniform(-0.5, 0.5, (2, 2048)).astype(np.float32)
  return params, audio


# -- (b) the mel front end ---------------------------------------------------

def test_mel_spectrogram_matches_jax():
  """Log-mel of two speech segments against JAX: 2e-3 abs. The DFT and mel
  products are f32 sums over 1024 samples in another order; in a quiet
  band the DFT sums cancel, and the log turns their absolute rounding into
  a relative one (about 1e-3 at worst on these segments)."""
  _, cuts = fixture_segments(2, 8192, seed=3)
  audio = np.stack(cuts).astype(np.float32) / 32768.0
  ref = np.asarray(JaxMel(JaxHParams()).mel_spectrogram(jnp.asarray(audio)))
  got = MelSTFT(HParams(), device="cpu").mel_spectrogram(
      torch.from_numpy(audio)).numpy()
  assert got.shape == ref.shape == (2, 80, 33)
  np.testing.assert_allclose(got, ref, atol=2e-3)
  assert ref.max() - ref.min() > 5  # speech, not silence at the clamp


def test_get_wav_from_file_raises_on_bad_input(tmp_path):
  mel = MelSTFT(HParams(), device="cpu")
  sr, (cut,) = fixture_segments(1, 4000)
  wavfile.write(tmp_path / "ok.wav", sr, cut)
  np.testing.assert_array_equal(mel.get_wav_from_file(tmp_path / "ok.wav"),
                                cut.astype(np.float32) / 32768.0)
  wavfile.write(tmp_path / "rate.wav", 16000, cut)
  with pytest.raises(ValueError, match="sampling rate"):
    mel.get_wav_from_file(tmp_path / "rate.wav")
  loud = np.full(100, 1.5, dtype=np.float32)
  wavfile.write(tmp_path / "loud.wav", sr, loud)
  with pytest.raises(ValueError, match="overamplified"):
    mel.get_wav_from_file(tmp_path / "loud.wav")


def test_loss_matches_jax():
  rng = np.random.default_rng(0)
  z = rng.standard_normal((2, 10, 8)).astype(np.float32)
  log_s = [rng.standard_normal((2, 10, 4)).astype(np.float32)
           for _ in range(2)]
  log_det = [np.float32(3.5), np.float32(-1.25)]
  ref = float(jax_loss(jnp.asarray(z), [jnp.asarray(s) for s in log_s],
                       [jnp.asarray(d) for d in log_det], 0.7))
  got = float(waveglow_loss(torch.from_numpy(z),
                            [torch.from_numpy(s) for s in log_s],
                            [torch.tensor(d) for d in log_det], 0.7))
  assert got == pytest.approx(ref, rel=1e-6)


# -- (e) one train step ------------------------------------------------------

def port_step(params, audio, custom):
  """One port train step on the CPU: (loss, per-leaf grads, params)."""
  hp = overwrite_custom_hparams(HParams(), custom)
  tparams = trainable_params_from_numpy(params, "cpu")
  optimizer = step.make_optimizer(tparams, hp.learning_rate)
  train_step = step.make_train_step(WaveGlowConfig.from_hparams(hp), hp,
                                    MelSTFT(hp, device="cpu"), optimizer)
  loss = float(train_step(tparams, torch.from_numpy(audio)))
  leaves = tree_leaves(tparams)
  return (loss, [p.grad.numpy().copy() for p in leaves],
          [p.detach().numpy().copy() for p in leaves],
          step.adam_state_to_optax(optimizer, tparams))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
  """Loss, every leaf's gradient and the params and Adam state after one
  step against JAX ``make_train_step`` (XLA route, f32). JAX's grads are
  read from its Adam state: optax's first step stores ``mu = (1 - b1) *
  grad``, the grad averaged over the micro-batches. Loss 1e-5 relative;
  grads 1e-6 abs plus 1e-4 relative (f32 products summed in other orders,
  at most 0.12 in size); params 2e-6 abs: Adam's first step moves each
  weight by about lr = 1e-4 times the sign of its gradient, so a grad that
  differs in its last bits moves it by a few ulp of 1e-4."""
  custom = dict(STEP_HPARAMS, grad_accum=str(grad_accum))
  params, audio = step_model()
  hp = jax_overwrite(JaxHParams(), custom)
  config, mel = JaxConfig.from_hparams(hp), JaxMel(hp)
  optimizer = jax_step.make_optimizer(hp.learning_rate)
  state, ref_loss = jax_step.make_train_step(config, hp, mel, optimizer)(
      jax_step.init_state(params, optimizer), jnp.asarray(audio))
  ref_opt = jax.tree_util.tree_leaves(state["opt_state"])
  loss, grads, new_params, opt = port_step(params, audio, custom)
  ref_grads = [np.asarray(m) / (1 - 0.9) for m in ref_opt[1:1 + len(grads)]]

  assert loss == pytest.approx(float(ref_loss), rel=1e-5)
  assert len(ref_opt) == len(opt) == 1 + 2 * len(grads)
  for g, r in zip(grads, ref_grads):
    np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-4)
  for p, r in zip(new_params, jax.tree_util.tree_leaves(state["params"])):
    np.testing.assert_allclose(p, np.asarray(r), atol=2e-6)
  assert int(opt[0]) == int(ref_opt[0]) == 1
  for a, b in zip(opt[1:], ref_opt[1:]):
    np.testing.assert_allclose(a, np.asarray(b), atol=1e-8, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def remat_step(remat, scope="flow"):
  """:func:`port_step` on ``step_model(seed=4)``; cached, so both scopes
  share the run without remat."""
  params, audio = step_model(seed=4)
  return port_step(params, audio,
                   dict(STEP_HPARAMS, remat=remat, remat_scope=scope))


@pytest.mark.parametrize("scope", ["flow", "wn"])
def test_remat_gives_the_same_grads(scope):
  """Recomputing in the backward (``torch.utils.checkpoint``) replays the
  same forward on the same inputs, so the loss and grads are those without
  remat: 1e-7 abs."""
  loss0, grads0, _, _ = remat_step("false")
  loss1, grads1, _, _ = remat_step("true", scope)
  assert loss1 == pytest.approx(loss0, abs=1e-7)
  for a, b in zip(grads1, grads0):
    np.testing.assert_allclose(a, b, atol=1e-7)


def test_grad_accum_must_divide_the_batch():
  params, audio = step_model()
  with pytest.raises(ValueError, match="grad_accum=2"):
    port_step(params, np.concatenate([audio, audio[:1]]),
              dict(STEP_HPARAMS, grad_accum="2"))


# -- (f) the data pipeline ---------------------------------------------------

def test_segment_crops_equal_jax(tmp_path):
  """Same seed, epoch and index: the same crop offsets and samples as the
  JAX pipeline (its Python path and its native loader), bit for bit; a file
  shorter than the segment is zero-padded the same way."""
  entries = write_speech_dataset(tmp_path, n=5, length=5000, seed=1)
  sr, (short,) = fixture_segments(1, 1500, seed=2)
  wavfile.write(tmp_path / "short.wav", sr, short)
  entries = data.load_dataset(tmp_path)
  custom = {"segment_length": "2048", "seed": "77"}
  ours = data.SegmentDataset(entries, overwrite_custom_hparams(HParams(),
                                                               custom))
  jhp = jax_overwrite(JaxHParams(), custom)
  theirs = [jax_data.SegmentDataset(to_jax_entries(entries), jhp,
                                    use_native=native)
            for native in (False, True)]
  assert [e.basename for e in ours.entries] == [
      e.basename for e in theirs[0].entries]
  for epoch in (0, 3):
    for index in range(len(entries)):
      np.testing.assert_array_equal(ours.segment(index, epoch),
                                    theirs[0].segment(index, epoch))
    for ref in theirs:
      np.testing.assert_array_equal(ours.batch(range(6), epoch),
                                    ref.batch(range(6), epoch))
  loader = data.BatchLoader(ours, 2, drop_last=True)
  jloader = jax_data.BatchLoader(theirs[0], 2, drop_last=True)
  for a, b in zip(loader.epoch(1, start_batch=1), jloader.epoch(1, 1)):
    np.testing.assert_array_equal(a, b)


def write_pcm24(path, samples):
  """A mono 24-bit PCM wav (scipy and the Python decoder read it; the
  native loader, like the JAX package's, refuses it)."""
  data = b"".join(int(v).to_bytes(3, "little", signed=True) for v in samples)
  fmt = struct.pack("<HHIIHH", 1, 1, 22050, 22050 * 3, 3, 24)
  body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
          + struct.pack("<I", len(data)) + data)
  path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_mixed_dataset(folder, pcm24=False):
  """Speech cuts as PCM16, one as PCM32, one as IEEE float, one shorter
  than the segment and, with ``pcm24``, one 24-bit file."""
  entries = write_speech_dataset(folder, n=4, length=5000, seed=3)
  sr, (a, b, short) = fixture_segments(3, 4000, seed=4)
  wavfile.write(folder / "pcm32.wav", sr, a.astype(np.int32) << 16)
  wavfile.write(folder / "float.wav", sr, a.astype(np.float32) / 32768)
  wavfile.write(folder / "short.wav", sr, short[:1500])
  if pcm24:
    write_pcm24(folder / "pcm24.wav", b.astype(np.int32) << 8)
  return data.load_dataset(folder)


LOADERS = [(ours, theirs) for ours in (True, False) for theirs in (True, False)]


def loader_id(pair):
  return "-".join(("native" if n else "python") + "-" + who
                  for n, who in zip(pair, ("port", "jax")))


@pytest.mark.parametrize("ours_native,theirs_native", LOADERS,
                         ids=map(loader_id, LOADERS))
@pytest.mark.parametrize("pcm24", [False, True], ids=["decodable", "latch"])
def test_batches_equal_jax_across_loaders(tmp_path, caplog, ours_native,
                                          theirs_native, pcm24):
  """The port's native or Python batches against the JAX package's native
  or Python ones, bit for bit, at three epochs and through the prefetching
  loader, over PCM16, PCM32, IEEE-float and short files. With a 24-bit
  file (``latch``), a native dataset logs one warning at the first batch
  that holds it and decodes in Python from then on, as the JAX one does:
  the same batches all the same."""
  entries = write_mixed_dataset(tmp_path, pcm24)
  custom = {"segment_length": "2048", "seed": "77"}
  ours = data.SegmentDataset(
      entries, overwrite_custom_hparams(HParams(), custom),
      use_native=ours_native)
  theirs = jax_data.SegmentDataset(to_jax_entries(entries),
                                   jax_overwrite(JaxHParams(), custom),
                                   use_native=theirs_native)
  caplog.set_level("WARNING", logger=data.logger.name)
  before = native.BATCHES
  batches = 0
  for epoch in (0, 1, 3):
    for lo in range(0, len(entries), 3):
      rows = range(lo, min(lo + 3, len(entries)))
      assert ours.batch(rows, epoch).tobytes() == theirs.batch(
          rows, epoch).tobytes()
      batches += 1
  loader = data.BatchLoader(ours, 2, drop_last=True)
  jloader = jax_data.BatchLoader(theirs, 2, drop_last=True)
  for a, b in zip(loader.epoch(2, start_batch=1), jloader.epoch(2, 1)):
    assert a.tobytes() == b.tobytes()
    batches += 1
  warned = [r for r in caplog.records if r.name == data.logger.name
            and "native wav decode failed" in r.getMessage()]
  if not ours_native:
    assert native.BATCHES == before and not warned
  elif not pcm24:
    assert native.BATCHES - before == batches and not warned
  else:
    # the first batch that holds the 24-bit file latches the dataset: the
    # batches before it were the loader's, none after it
    first = min(i for i, e in enumerate(ours.entries)
                if e.basename == "pcm24.wav") // 3
    assert len(warned) == 1 and "pcm24.wav" in warned[0].getMessage()
    assert native.BATCHES - before == first


@pytest.mark.parametrize("kind,probed", [("float", True), ("pcm32", False)])
def test_length_comes_from_the_header(tmp_path, monkeypatch, kind, probed):
  """An entry's length is read from its header with no decode: by stdlib
  ``wave`` for PCM, by the native probe for IEEE float (which ``wave``
  cannot read), the same count as the JAX dataset's."""
  entries = write_mixed_dataset(tmp_path)
  hp = overwrite_custom_hparams(HParams(), {"segment_length": "2048"})
  ours = data.SegmentDataset(entries, hp)
  theirs = jax_data.SegmentDataset(to_jax_entries(entries),
                                   jax_overwrite(JaxHParams(),
                                                 {"segment_length": "2048"}))
  index = [e.basename for e in ours.entries].index(f"{kind}.wav")
  probe, decode = [], []
  wav_info = native.wav_info
  monkeypatch.setattr(native, "wav_info",
                      lambda path: probe.append(path) or wav_info(path))
  monkeypatch.setattr(data.audio_io, "wav_to_float32",
                      lambda path: decode.append(path))
  assert ours._length(index) == theirs._length(index) == 4000
  assert len(probe) == int(probed) and not decode


@pytest.mark.parametrize("use_native", [True, False])
def test_wrong_sampling_rate_is_named(tmp_path, caplog, use_native):
  """A file at another rate aborts the batch with the rate's message (not a
  decode failure, and no latch), on either path, as the JAX dataset does."""
  entries = write_speech_dataset(tmp_path, n=3, length=5000)
  sr, (cut,) = fixture_segments(1, 5000, seed=9)
  wavfile.write(tmp_path / "16k.wav", 16000, cut)
  entries = data.load_dataset(tmp_path)
  hp = overwrite_custom_hparams(HParams(), {"segment_length": "2048"})
  ours = data.SegmentDataset(entries, hp, use_native=use_native)
  theirs = jax_data.SegmentDataset(
      to_jax_entries(entries), jax_overwrite(JaxHParams(),
                                             {"segment_length": "2048"}),
      use_native=use_native)
  caplog.set_level("WARNING", logger=data.logger.name)
  for ds in (ours, theirs):
    with pytest.raises(ValueError, match="sampling rate 16000 != 22050"):
      ds.batch(range(4), 0)
  assert not [r for r in caplog.records if r.name == data.logger.name]
  assert ours._use_native == use_native


def test_train_reads_through_the_loader(tmp_path, monkeypatch):
  """``train()`` reads every batch through the native loader by default,
  and with the Python decoder (``use_native=False``) trains to the same
  bits."""
  entries = write_speech_dataset(tmp_path / "data")
  results = {}
  for use_native in (True, False):
    monkeypatch.setattr(loop, "SegmentDataset", functools.partial(
        data.SegmentDataset, use_native=use_native))
    before = native.BATCHES
    results[use_native] = train(LOOP_HPARAMS, tmp_path / f"logs{use_native}",
                                entries, entries, tmp_path / f"ck{use_native}",
                                max_iterations=2, device="cpu")
    records = [json.loads(line) for line in (
        tmp_path / f"logs{use_native}" / "metrics.jsonl").read_text()
        .splitlines()]
    events = [r["event"] for r in records]
    # each step's batch, and each validation's 2 batches of 2 entries
    read = events.count("train_step") + 2 * events.count("validation")
    assert native.BATCHES - before == (read if use_native else 0)
    results[use_native]["losses"] = [r["loss"] for r in records
                                     if "loss" in r]
  assert len(results[True]["losses"]) >= 2
  assert results[True]["losses"] == results[False]["losses"]
  for a, b in zip(tree_leaves(results[True]["params"]),
                  tree_leaves(results[False]["params"])):
    assert a.tobytes() == b.tobytes()


# -- (g), (i) train() ----------------------------------------------------------

def test_train_resume_equals_straight_run(tmp_path):
  """3 steps, a save, a resume and 2 more steps give the 5-step straight
  run's params and Adam state, bit for bit: the resume restarts at the
  exact next batch (mid-epoch here: 2 batches per epoch) and the npz holds
  f32 exactly. The metrics and TensorBoard logs agree."""
  entries = write_speech_dataset(tmp_path / "data")
  straight = train(dict(LOOP_HPARAMS, iters_per_checkpoint="3"),
                   tmp_path / "logs", entries, entries, tmp_path / "ck",
                   max_iterations=5, tensorboard_dir=tmp_path / "tb",
                   device="cpu")
  assert straight["step"] == 5
  assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
      "1.npz", "3.npz"]
  ckpt = CheckpointWaveglow.load(tmp_path / "ck" / "3.npz")
  assert ckpt.iteration == 3 and len(ckpt.optimizer) > 1
  resumed = train(None, None, entries, entries, tmp_path / "ck2",
                  checkpoint=ckpt, max_iterations=5, device="cpu")
  assert resumed["step"] == 5
  for a, b in zip(tree_leaves(resumed["params"]),
                  tree_leaves(straight["params"])):
    np.testing.assert_array_equal(a, b)
  for a, b in zip(resumed["opt_state"], straight["opt_state"]):
    np.testing.assert_array_equal(a, b)

  records = [json.loads(line) for line in
             (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
  losses = {r["iteration"]: r["loss"] for r in records
            if r["event"] == "train_step"}
  assert sorted(losses) == [1, 2, 3, 4, 5]
  assert all(np.isfinite(v) for v in losses.values())
  assert [r["iteration"] for r in records if r["event"] == "validation"] == [
      1, 3]
  from tensorboard.backend.event_processing.event_accumulator import \
      EventAccumulator
  events = EventAccumulator(str(tmp_path / "tb"))
  events.Reload()
  assert {e.step: pytest.approx(e.value, rel=1e-6)
          for e in events.Scalars("train/loss")} == losses


def test_train_raises_on_non_finite_loss(tmp_path, monkeypatch):
  entries = write_speech_dataset(tmp_path / "data", n=2)
  batch = data.SegmentDataset.batch

  def poisoned(self, indices, epoch):
    out = batch(self, indices, epoch)
    out[..., 0] = np.nan
    return out

  monkeypatch.setattr(data.SegmentDataset, "batch", poisoned)
  with pytest.raises(FloatingPointError, match="continue-train"):
    train(LOOP_HPARAMS, tmp_path / "logs", entries, entries, tmp_path / "ck",
          max_iterations=1, device="cpu")


def test_train_defaults_to_the_card(tmp_path):
  """Without ``device`` train() runs on the card, so here (no CUDA) it
  raises instead of training on the CPU."""
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  entries = write_speech_dataset(tmp_path / "data", n=2)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    train(LOOP_HPARAMS, None, entries, entries, tmp_path / "ck",
          max_iterations=1)
  assert not (tmp_path / "ck").exists()


@pytest.mark.parametrize("setting,queue", [
    ({"checkpoint_backend": "orbax"}, "Checkpoint interop"),
    ({"checkpoint_async": "true"}, "Checkpoint interop"),
])
def test_unported_settings_raise(tmp_path, setting, queue):
  """Settings this slice does not implement raise, naming the ROADMAP.md
  queue they wait for, instead of being ignored."""
  entries = write_speech_dataset(tmp_path / "data", n=2)
  with pytest.raises(ValueError, match=f"ROADMAP.md queue .*{queue}"):
    train(dict(LOOP_HPARAMS, **setting), None, entries, entries,
          tmp_path / "ck", max_iterations=1, device="cpu")


# -- (h) checkpoints across the packages ---------------------------------------

def assert_states_close(port_state, jax_state):
  """Params 2e-6 abs (two Adam steps of about lr = 1e-4 each, grads that
  differ in their last bits); Adam moments 1e-4 relative."""
  assert int(port_state["step"]) == int(jax_state["step"])
  for a, b in zip(tree_leaves(port_state["params"]),
                  jax.tree_util.tree_leaves(jax_state["params"])):
    np.testing.assert_allclose(a, np.asarray(b), atol=2e-6)
  ref_opt = jax.tree_util.tree_leaves(jax_state["opt_state"])
  assert len(port_state["opt_state"]) == len(ref_opt)
  assert int(port_state["opt_state"][0]) == int(ref_opt[0])
  for a, b in zip(port_state["opt_state"][1:], ref_opt[1:]):
    np.testing.assert_allclose(a, np.asarray(b), atol=1e-10, rtol=1e-4)


def test_checkpoints_resume_across_packages(tmp_path):
  """A checkpoint written by the port's train() resumes in the JAX
  package's train(), and the step it takes matches the port's own next
  step from that checkpoint; a JAX checkpoint resumes in the port and its
  next step matches the JAX run's."""
  entries = write_speech_dataset(tmp_path / "data")
  jax_entries = to_jax_entries(entries)
  custom = dict(LOOP_HPARAMS, iters_per_checkpoint="1")

  train(custom, None, entries, entries, tmp_path / "port", max_iterations=1,
        device="cpu")
  port_next = train(None, None, entries, entries, tmp_path / "port2",
                    checkpoint=CheckpointWaveglow.load(
                        tmp_path / "port" / "1.npz"),
                    max_iterations=2, device="cpu")
  jax_next = jax_loop.train(None, None, jax_entries, jax_entries,
                            tmp_path / "jax2",
                            checkpoint=JaxCheckpoint.load(
                                tmp_path / "port" / "1.npz"),
                            max_iterations=2)
  assert_states_close(port_next, jax_next)

  jax_straight = jax_loop.train(custom, None, jax_entries, jax_entries,
                                tmp_path / "jax", max_iterations=2)
  port_resumed = train(None, None, entries, entries, tmp_path / "port3",
                       checkpoint=CheckpointWaveglow.load(
                           tmp_path / "jax" / "1.npz"),
                       max_iterations=2, device="cpu")
  assert_states_close(port_resumed, jax_straight)


def test_warm_start_matches_jax(tmp_path):
  """Warm start from a checkpoint of a deeper model (3 layers into 2): the
  leaves whose path and shape match come from it, the others keep the
  seed's initialisation, in both packages; one step later the port's state
  matches the JAX package's (bounds of :func:`assert_states_close`)."""
  entries = write_speech_dataset(tmp_path / "data")
  jax_entries = to_jax_entries(entries)
  source_hp = overwrite_custom_hparams(HParams(),
                                       dict(LOOP_HPARAMS, n_layers="3"))
  source = init_params(JaxConfig.from_hparams(
      jax_overwrite(JaxHParams(), dict(LOOP_HPARAMS, n_layers="3"))), seed=7)
  CheckpointWaveglow.from_params(source, source_hp).save(tmp_path / "w.npz")

  port = train(LOOP_HPARAMS, None, entries, entries, tmp_path / "port",
               warm_model=CheckpointWaveglow.load(tmp_path / "w.npz"),
               max_iterations=1, device="cpu")
  ref = jax_loop.train(LOOP_HPARAMS, None, jax_entries, jax_entries,
                       tmp_path / "jax",
                       warm_model=JaxCheckpoint.load(tmp_path / "w.npz"),
                       max_iterations=1)
  assert_states_close(port, ref)
  # one Adam step moves a weight by about lr = 1e-4
  kept = port["params"]["flows"][0]["wn"]["in_layers"][1]["v"]
  np.testing.assert_allclose(
      kept, source["flows"][0]["wn"]["in_layers"][1]["v"], atol=2e-4)
  fresh = init_params(JaxConfig.from_hparams(
      jax_overwrite(JaxHParams(), LOOP_HPARAMS)), seed=1234)
  np.testing.assert_allclose(
      port["params"]["flows"][0]["wn"]["res_skip"][1]["v"],
      fresh["flows"][0]["wn"]["res_skip"][1]["v"], atol=2e-4)
