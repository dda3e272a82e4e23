"""The port's command line (``python -m waveglow_tpu_torch``) on the CPU
(``--device cpu``, tiny config, every ``end`` conv randomised): the parser,
``download`` against a localhost server, ``synthesize`` and
``synthesize-wav`` files against in-process synthesis, the JAX CLI against
the port's at sigma 0, ``serve``'s service and its ``/reload`` pickle gate,
and the device rule."""

import functools
import http.server
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from waveglow_tpu.checkpointing import import_torch as jax_import
from waveglow_tpu.checkpointing.export_torch import \
    export_torch_checkpoint as jax_export_torch
from waveglow_tpu.checkpointing.export_torch import \
    params_to_state_dict as jax_state_dict
from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.cli.main import run as jax_run
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import init_params as jax_init
from waveglow_tpu_torch import __version__
from waveglow_tpu_torch.checkpointing import download, load_checkpoint_any
from waveglow_tpu_torch.cli import main as cli
from waveglow_tpu_torch.dsp.audio_io import convert_wav, normalize_wav
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.inference import server
from waveglow_tpu_torch.inference.client import SynthesisClient
from waveglow_tpu_torch.inference.synthesizer import Synthesizer

TINY = {"n_flows": "5", "n_layers": "3", "n_channels": "32"}
SEED = 5
BUCKET = 16
FRAMES = (10, 12, 23)  # 10 and 12 share the 16-frame bucket
ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "audio.wav"
# tests/test_torch_synthesizer.py's bounds: infer against the JAX package's
# (atol on the waveform), and a micro-batch row against its solo call
INFER_VS_JAX_ATOL = 2e-4
BATCH_VS_SOLO_ATOL = 1e-5
TIMEOUT_S = 60


def tiny_checkpoint(seed=0):
  hp = jax_overwrite(JaxHParams(), TINY)
  params = jax_init(JaxConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 100)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.1).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.1).astype(np.float32)
  return JaxCkpt(state_dict=params, optimizer=None,
                 learning_rate=hp.learning_rate, iteration=77,
                 hparams=asdict(hp))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
  """A reference-format ``.pt`` and its npz, a folder of mels and one of
  two cuts of the speech fixture."""
  root = tmp_path_factory.mktemp("cli")
  ckpt = tiny_checkpoint()
  jax_export_torch(ckpt, root / "model.pt")
  ckpt.save(root / "model.npz")
  rng = np.random.default_rng(1)
  (root / "mels" / "sub").mkdir(parents=True)
  for i, f in enumerate(FRAMES):
    folder = root / "mels" / ("sub" if i == 0 else "")
    np.save(folder / f"m{i}.npy",
            rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32))
  sr, wav = wavfile.read(FIXTURE)
  (root / "wavs").mkdir()
  for i, (start, length) in enumerate(((1000, 4000), (50_000, 6100))):
    wavfile.write(root / "wavs" / f"cut{i}.wav", sr,
                  wav[start:start + length])
  return root


@pytest.fixture(scope="module")
def synth(ws):
  return Synthesizer(load_checkpoint_any(ws / "model.pt"), device="cpu")


def cli_run(ws, *args):
  return cli.run([*map(str, args), "--log", str(ws / "cli.log")])


def read_pcm(path):
  sr, pcm = wavfile.read(path)
  assert pcm.dtype == np.int16
  return pcm


def expected_pcm(wav):
  """What the command writes for a waveform: peak-normalized, int16."""
  return convert_wav(normalize_wav(wav), np.int16)


def mel_files(ws):
  return sorted((ws / "mels").rglob("*.npy"))


def out_path(ws, out, mel_path):
  return out / mel_path.relative_to(ws / "mels").with_suffix(".wav")


# -- parser ---------------------------------------------------------------------

def test_subcommands_registered():
  text = cli.build_parser().format_help()
  for cmd in ("download", "train", "continue-train", "validate", "synthesize",
              "synthesize-wav", "serve"):
    assert cmd in text


@pytest.mark.parametrize("args,code", [(["--help"], 0), (["--version"], 0),
                                       (["frobnicate"], 2)])
def test_help_version_and_unknown_command(capsys, args, code):
  with pytest.raises(SystemExit) as e:
    cli.build_parser().parse_args(args)
  assert e.value.code == code
  if args == ["--version"]:
    assert capsys.readouterr().out.strip() == f"waveglow-tpu-torch {__version__}"


def test_bare_invocation_prints_help_and_succeeds(capsys):
  assert cli.run([]) == 0
  assert "usage: waveglow-tpu-torch" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--mesh-data", "--mesh-model", "--mesh-time",
                                  "--compile-cache"])
def test_unported_serve_flags_are_argparse_errors(ws, flag):
  """``--compile-cache`` (the JAX daemon's XLA compile cache) has no
  counterpart and stays an argparse error; the mesh flags are ported
  (sharded serving) and parse to their value."""
  args = ["serve", str(ws / "model.npz"), flag, "2"]
  if flag == "--compile-cache":
    with pytest.raises(SystemExit) as e:
      cli.build_parser().parse_args(args)
    assert e.value.code == 2
  else:
    ns = cli.build_parser().parse_args(args)
    assert getattr(ns, flag[2:].replace("-", "_")) == 2


# -- download -------------------------------------------------------------------

@pytest.fixture
def http_dir(tmp_path):
  root = tmp_path / "srv"
  root.mkdir()
  handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                              directory=str(root))
  httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  yield root, f"http://127.0.0.1:{httpd.server_address[1]}"
  httpd.shutdown()
  httpd.server_close()
  thread.join(TIMEOUT_S)


def test_download_converts_like_the_jax_package(tmp_path, http_dir,
                                                monkeypatch):
  """``download`` fetches NVIDIA's raw form (legacy naming) from a
  localhost server and converts it in place; the npz equals, array for
  array and byte for byte of its metadata, the JAX package's conversion
  of the same file."""
  root, url = http_dir
  sd = {k.replace(".parametrizations.weight.original0", ".weight_g")
        .replace(".parametrizations.weight.original1", ".weight_v"): v
        for k, v in jax_state_dict(tiny_checkpoint(3).state_dict).items()}
  torch.save({"model": sd, "iteration": 580000}, str(root / "v3.pt"))
  monkeypatch.setitem(download._NGC_URLS, 3, f"{url}/v3.pt")
  dest = tmp_path / "dl" / "waveglow.pt"
  assert cli.run(["download", str(dest), "--ver", "3",
                  "--log", str(tmp_path / "cli.log")]) == 0
  shutil.copy(root / "v3.pt", tmp_path / "jax.pt")
  jax_import.convert_torch_checkpoint(tmp_path / "jax.pt", tmp_path / "jax.pt")
  with np.load(dest) as port, np.load(tmp_path / "jax.pt") as ref:
    assert sorted(port.files) == sorted(ref.files)
    for key in ref.files:
      assert port[key].dtype == ref[key].dtype, key
      np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
  assert load_checkpoint_any(dest).iteration == 580000


# -- synthesize, synthesize-wav ---------------------------------------------------

@pytest.mark.parametrize("name", ["model.pt", "model.npz"])
def test_synthesize_writes_normalized_infer(ws, synth, name):
  """Each file equals ``Synthesizer.infer`` + ``normalize_wav`` + int16 bit
  for bit, from the ``.pt`` and from its npz; the subfolder tree is
  mirrored."""
  out = ws / f"out_{name}"
  assert cli_run(ws, "synthesize", ws / name, ws / "mels", "--custom-seed",
                 SEED, "--bucket-frames", BUCKET, "--device", "cpu",
                 "-out", out) == 0
  for path in mel_files(ws):
    want = expected_pcm(synth.infer(np.load(path), seed=SEED,
                                    bucket_frames=BUCKET).wav_denoised)
    got = read_pcm(out_path(ws, out, path))
    assert got.shape == (np.load(path).shape[-1] * 256,)
    np.testing.assert_array_equal(got, want, err_msg=str(path))
  assert (out / "sub" / "m0.wav").is_file()


def test_synthesize_batch_agrees_with_batch_1(ws, synth):
  """``--batch 2``: 10 and 12 frames share a dispatch; each file equals
  ``infer_serving_many`` normalized, and is within the bound a batch row
  keeps to its solo call (``BATCH_VS_SOLO_ATOL`` on the waveform, carried
  through normalization and int16) of the ``--batch 1`` file."""
  solo_out, batch_out = ws / "solo", ws / "batch"
  for out, batch in ((solo_out, 1), (batch_out, 2)):
    assert cli_run(ws, "synthesize", ws / "model.pt", ws / "mels",
                   "--custom-seed", SEED, "--bucket-frames", BUCKET,
                   "--batch", batch, "--device", "cpu", "-out", out) == 0
  paths = mel_files(ws)
  many = synth.infer_serving_many([np.load(p) for p in paths],
                                  seeds=[SEED] * len(paths),
                                  bucket_frames=BUCKET, max_batch=2)
  for path, res in zip(paths, many):
    batched = read_pcm(out_path(ws, batch_out, path))
    np.testing.assert_array_equal(batched, expected_pcm(res.samples))
    solo = read_pcm(out_path(ws, solo_out, path))
    # |a/pa - b/pb| <= 2 e / pa for |a - b| <= e, then one int16 step
    peak = float(np.abs(res.samples).max())
    bound = 32767 * 2 * BATCH_VS_SOLO_ATOL / peak + 1
    assert np.abs(batched.astype(int) - solo).max() <= bound


def test_synthesize_skips_existing_and_overwrites_with_o(ws):
  out = ws / "skip"
  args = ("synthesize", ws / "model.npz", ws / "mels", "--custom-seed", SEED,
          "--device", "cpu", "-out", out)
  assert cli_run(ws, *args) == 0
  mel_path = mel_files(ws)[-1]
  target = out_path(ws, out, mel_path)
  target.write_bytes(b"stale")
  assert cli_run(ws, *args) == 0
  assert target.read_bytes() == b"stale"          # skipped
  assert "Skipping" in (ws / "cli.log").read_text()
  assert cli_run(ws, *args, "-o") == 0
  assert read_pcm(target).shape == (np.load(mel_path).shape[-1] * 256,)


def test_synthesize_wav_copy_synthesis(ws, synth):
  """Outputs land beside the inputs as ``<stem>.synthesized.wav`` and equal
  ``MelSTFT.get_mel_from_file`` + ``Synthesizer.infer``; a rerun reads no
  ``*.synthesized.wav`` back as input."""
  folder = ws / "wavs"
  args = ("synthesize-wav", ws / "model.npz", folder, "--custom-seed", SEED,
          "--device", "cpu")
  assert cli_run(ws, *args) == 0
  mel_op = MelSTFT(synth.hparams, device="cpu")
  for i in range(2):
    mel = mel_op.get_mel_from_file(folder / f"cut{i}.wav").numpy()
    want = expected_pcm(synth.infer(mel, seed=SEED,
                                    bucket_frames=64).wav_denoised)
    np.testing.assert_array_equal(
        read_pcm(folder / f"cut{i}.synthesized.wav"), want)
  assert cli_run(ws, *args, "-o") == 0
  assert sorted(p.name for p in folder.iterdir()) == [
      "cut0.synthesized.wav", "cut0.wav", "cut1.synthesized.wav", "cut1.wav"]


@pytest.mark.parametrize("cmd", ["synthesize", "synthesize-wav", "serve"])
def test_default_device_is_the_card(ws, cmd):
  """Without ``--device`` the command asks for the card, and fails here
  with the device rule's message, before anything is written."""
  folder = ws / ("wavs" if cmd == "synthesize-wav" else "mels")
  out = ws / f"nocard_{cmd}"
  args = [cmd, ws / "model.npz"] + ([] if cmd == "serve"
                                    else [folder, "-out", out])
  before = sorted(p.name for p in folder.rglob("*"))
  assert cli_run(ws, *args) == 1
  assert "no CUDA device is available" in (ws / "cli.log").read_text()
  assert not out.exists()
  assert sorted(p.name for p in folder.rglob("*")) == before


def test_jax_cli_and_port_cli_agree_at_sigma_0(ws, synth, tmp_path):
  """Both packages' ``synthesize`` on one ``.pt`` and one mel at sigma 0,
  where the noise drops out: the files agree within the bound ``infer``
  keeps to the JAX package's (``INFER_VS_JAX_ATOL`` on the waveform),
  carried through each side's peak normalization and int16 rounding."""
  folder = tmp_path / "one"
  folder.mkdir()
  mel_path = ws / "mels" / "m2.npy"
  shutil.copy(mel_path, folder / "m.npy")
  common = ["synthesize", str(ws / "model.pt"), str(folder), "--sigma", "0",
            "--custom-seed", str(SEED), "--log", str(tmp_path / "log")]
  assert jax_run(common + ["-out", str(tmp_path / "jax")]) == 0
  assert cli.run(common + ["-out", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
  ref = read_pcm(tmp_path / "jax" / "m.wav")
  got = read_pcm(tmp_path / "port" / "m.wav")
  assert got.shape == ref.shape == (FRAMES[-1] * 256,)
  peak = float(np.abs(synth.infer(np.load(mel_path), sigma=0.0,
                                  bucket_frames=64).wav_denoised).max())
  bound = 32767 * 2 * INFER_VS_JAX_ATOL / peak + 1
  err = np.abs(got.astype(int) - ref).max()
  assert err <= bound, (err, bound)


# -- serve ----------------------------------------------------------------------

@pytest.fixture
def served(monkeypatch):
  """Run ``serve`` with ``serve_forever`` replaced: the service the command
  built, and the address it would bind."""
  calls = []

  def fake_serve_forever(service, host, port, *, warmup_frames=None):
    calls.append((service, host, port, warmup_frames))

  monkeypatch.setattr(server, "serve_forever", fake_serve_forever)
  yield calls
  for service, *_ in calls:
    if service._batcher is not None:
      service._batcher.close()


def test_serve_builds_the_service_from_its_flags(ws, served):
  assert cli_run(ws, "serve", ws / "model.pt", "--host", "0.0.0.0", "--port",
                 0, "--sigma", 0.7, "--denoiser-strength", 0.01,
                 "--bucket-frames", 32, "--max-batch", 4, "--batch-window-ms",
                 2.5, "--max-queue", 9, "--max-frames", 1000,
                 "--warmup-frames", "16,32", "--compute-dtype", "bfloat16",
                 "--custom-hparams", "sigma=0.9", "--device", "cpu") == 0
  (service, host, port, warmup), = served
  assert (host, port, warmup) == ("0.0.0.0", 0, [16, 32])
  assert (service.default_sigma, service.default_denoiser_strength,
          service.bucket_frames, service.chunk_frames, service.max_batch,
          service.max_queue, service.max_frames,
          service.allow_torch_reload) == (0.7, 0.01, 32, None, 4, 9, 1000,
                                          False)
  assert service._batcher._window_s == 2.5e-3
  assert service.custom_hparams == {"sigma": "0.9",
                                    "compute_dtype": "bfloat16"}
  assert service.synth.hparams.compute_dtype == "bfloat16"
  assert service.synth.device.type == "cpu"
  assert service.synth.iteration == 77


def post_reload(url, path):
  req = urllib.request.Request(
      url + "/reload", data=json.dumps({"checkpoint": str(path)}).encode(),
      headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
    return r.status, json.loads(r.read())


@pytest.mark.parametrize("allow", [False, True])
def test_reload_of_a_pt_needs_the_flag(ws, served, monkeypatch, allow):
  """Without ``--allow-torch-reload``, ``/reload`` of a ``.pt`` gets the
  JAX daemon's refusal (HTTP 400) and ``torch.load`` is never called; with
  it, the file loads. An npz always reloads."""
  flags = ["--allow-torch-reload"] if allow else []
  assert cli_run(ws, "serve", ws / "model.npz", "--device", "cpu",
                 *flags) == 0
  (service, *_), = served
  httpd = server.make_server(service, "127.0.0.1", 0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  url = f"http://127.0.0.1:{httpd.server_port}"
  loads = []
  real_load = torch.load
  monkeypatch.setattr(torch, "load",
                      lambda *a, **k: loads.append(a) or real_load(*a, **k))
  try:
    if allow:
      status, body = post_reload(url, ws / "model.pt")
      assert status == 200 and body["iteration"] == 77 and len(loads) == 1
    else:
      with pytest.raises(urllib.error.HTTPError) as e:
        post_reload(url, ws / "model.pt")
      assert e.value.code == 400
      error = json.loads(e.value.read())["error"]
      e.value.close()
      assert error.startswith(
          "ValueError: refusing to hot-swap a torch-format checkpoint: the "
          "torch importer deserializes arbitrary pickles. Convert it to the "
          "native format first")
      assert "--allow-torch-reload on a trusted network" in error
      assert loads == []
    assert post_reload(url, ws / "model.npz") == (
        200, {"status": "reloaded", "iteration": 77,
              "checkpoint": str(ws / "model.npz")})
  finally:
    httpd.shutdown()
    httpd.server_close()
    thread.join(TIMEOUT_S)


def free_port():
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    return sock.getsockname()[1]


def wait_for_health(client, alive=lambda: True):
  deadline = time.monotonic() + TIMEOUT_S
  while True:
    assert alive(), "the daemon exited before answering"
    try:
      return client.health()
    except OSError:
      assert time.monotonic() < deadline, "no /healthz"
      time.sleep(0.1)


def test_serve_forever_ends_its_threads_and_restores_sigterm(ws):
  """C11: after SIGTERM, ``serve_forever`` returns with its micro-batcher
  and drain threads ended (a daemon thread torn down at interpreter exit
  inside torch aborted the process) and the previous handler back."""
  service = server.SynthesisService(load_checkpoint_any(ws / "model.npz"),
                                    device="cpu")
  port = free_port()
  before = signal.getsignal(signal.SIGTERM)
  errors = []

  def drive():
    deadline = time.monotonic() + TIMEOUT_S
    while signal.getsignal(signal.SIGTERM) is before:  # serve_forever's hook
      if time.monotonic() > deadline:
        errors.append("serve_forever installed no SIGTERM handler")
        return
      time.sleep(0.05)
    try:
      client = SynthesisClient(f"http://127.0.0.1:{port}", timeout_s=TIMEOUT_S)
      wait_for_health(client)
      client.synthesize(np.load(ws / "mels" / "m1.npy"), seed=1)
    except Exception as e:  # noqa: BLE001 -- reported below
      errors.append(e)
    finally:
      os.kill(os.getpid(), signal.SIGTERM)

  client_thread = threading.Thread(target=drive)
  client_thread.start()
  server.serve_forever(service, "127.0.0.1", port)
  client_thread.join(TIMEOUT_S)
  assert not client_thread.is_alive() and not errors
  assert len(service._batcher._threads) == 2
  assert not [t.name for t in threading.enumerate()
              if t.name.startswith("waveglow-")]
  assert signal.getsignal(signal.SIGTERM) is before


def test_serve_process_exits_0_after_sigterm(ws, synth, tmp_path):
  """``python -m waveglow_tpu_torch serve`` answers, refuses a ``.pt``
  reload, takes an npz one, and on SIGTERM drains and exits 0 (C11: it
  aborted at exit in about half the runs)."""
  port = free_port()
  proc = subprocess.Popen(
      [sys.executable, "-m", "waveglow_tpu_torch", "serve",
       str(ws / "model.pt"), "--port", str(port), "--device", "cpu",
       "--log", str(tmp_path / "serve.log")],
      cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
  try:
    client = SynthesisClient(f"http://127.0.0.1:{port}", timeout_s=TIMEOUT_S)
    assert wait_for_health(client, lambda: proc.poll() is None)[
        "status"] == "ok"
    mel = np.load(ws / "mels" / "m2.npy")
    np.testing.assert_allclose(
        client.synthesize(mel, seed=3),
        synth.infer_serving(mel, seed=3).samples, atol=BATCH_VS_SOLO_ATOL)
    with pytest.raises(urllib.error.HTTPError) as e:
      client.reload(ws / "model.pt")
    assert e.value.code == 400
    e.value.close()
    assert client.reload(ws / "model.npz")["status"] == "reloaded"
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out.decode()[-2000:]
    assert b"Everything was successful" in out
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.communicate()
