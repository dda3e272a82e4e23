"""Benchmark: synthesis throughput (audio-seconds per second per card),
latency and training rate (counterpart of the repo-root ``bench.py``).

  python -m waveglow_tpu_torch.bench [--dtype float32] [--iters 5]
  python -m waveglow_tpu_torch benchmark [--dtype float32] [--iters 5]

Prints ONE JSON line with the JAX bench's keys, starting with
``{"metric": "audio_seconds_synthesized_per_sec_per_chip", "value": N,
"unit": ...}``, plus the card's power limit and the WN kernel launches of
the run (``wn_kernel_launches``; in bf16 also ``bwd_kernel_launches``, the
backward-kernel calls of the training sections), so a reader sees that the
run went through the kernels.

Workload: full-size WaveGlow (12 flows x 8 layers x 256 channels) from
``init_params(config, seed=0)``, 826-frame (~9.6 s) utterances at batch 8,
in bf16 (f32 accumulation) or f32 parity mode (no TF32). The inputs are
the JAX bench's numpy arrays, drawn in its order from one
``np.random.default_rng(0)``: the mel, the training audio, the batch-24
audio. Sections: synthesis throughput; batch-1 latency, first audio of a
stream (raw and denoised); training samples/s at ``--train-batch`` and at
batch 24 as 3 micro-batches of 8. Latency and training start only while
the run is under ``--budget-seconds``; a skipped section is reported as
``*_skipped: "budget"``. A section that fails raises: the command exits 1
and prints no line.

Runs on the card unless ``--device cpu`` is given (the plain PyTorch path,
for tests); without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from waveglow_tpu_torch.checkpointing.from_jax import \
    trainable_params_from_numpy
from waveglow_tpu_torch.device import resolve_device, to_device
from waveglow_tpu_torch.dsp.mel import MelSTFT
from waveglow_tpu_torch.hparams import (HParams, TSTFTHParams,
                                        overwrite_custom_hparams,
                                        parse_custom_hparams)
from waveglow_tpu_torch.inference.denoiser import Denoiser
from waveglow_tpu_torch.inference.stream_denoise import StreamingDenoiser
from waveglow_tpu_torch.inference.streaming import stream_chunks
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models.waveglow import (WaveGlowConfig,
                                                fuse_for_inference, infer,
                                                init_params,
                                                params_for_compute,
                                                params_to_torch)
from waveglow_tpu_torch.ops.conv import compute_dtype_from_name
from waveglow_tpu_torch.training.step import make_optimizer, make_train_step

METRIC = "audio_seconds_synthesized_per_sec_per_chip"
DENOISER_STRENGTH = 0.0005
BATCH24, BATCH24_ACCUM = 24, 3


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      prog="python -m waveglow_tpu_torch.bench",
      description=__doc__.splitlines()[0])
  parser.add_argument("--batch", type=int, default=8)
  parser.add_argument("--frames", type=int, default=826,
                      help="mel frames per utterance (826 ~= 9.59 s)")
  parser.add_argument("--iters", type=int, default=20,
                      help="timed synthesis calls")
  parser.add_argument("--dtype", default="bfloat16",
                      choices=["bfloat16", "float32"])
  parser.add_argument("--latency", action="store_true", default=True,
                      help="also measure single-utterance (batch 1) latency "
                           "and streaming first-audio latency")
  parser.add_argument("--no-latency", dest="latency", action="store_false")
  parser.add_argument("--latency-iters", type=int, default=7)
  parser.add_argument("--stream-chunk-frames", type=int, default=128)
  parser.add_argument("--budget-seconds", type=float, default=1500,
                      help="soft deadline: optional sections (latency, "
                           "training) start only while under this elapsed "
                           "wall time")
  parser.add_argument("--train", action="store_true", default=True)
  parser.add_argument("--no-train", dest="train", action="store_false")
  parser.add_argument("--train-batch", type=int, default=8)
  parser.add_argument("--train-iters", type=int, default=5)
  parser.add_argument("--train-hparams", default=None,
                      help='extra training hparam overrides, e.g. '
                           '"remat_scope=wn,grad_accum=2"')
  parser.add_argument("--train-batch24", action="store_true", default=True,
                      help="also measure the reference-workload batch-24 "
                           "training rate (grad-accum 3x8)")
  parser.add_argument("--no-train-batch24", dest="train_batch24",
                      action="store_false")
  parser.add_argument("--device", default="cuda",
                      help="where the model runs: the card (fails without "
                           "one) or cpu (the plain PyTorch path, for tests)")
  return parser


def power_limit_w(device: torch.device) -> Optional[float]:
  """The card's power limit in watts, as ``nvidia-smi --query-gpu=
  name,power.limit`` reads it (the line of this device's UUID when several
  cards are listed); None on the CPU."""
  if device.type != "cuda":
    return None
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  lines = [ln.split(", ") for ln in out.stdout.strip().splitlines()]
  uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
  mine = [ln for ln in lines if uuid is not None and ln[0] == f"GPU-{uuid}"]
  if not mine and len(lines) == 1:
    mine = lines
  if len(mine) != 1:
    raise RuntimeError(f"cannot tell this card's line in nvidia-smi's "
                       f"output:\n{out.stdout}")
  return float(mine[0][2].split()[0])


def run_benchmark(args: argparse.Namespace,
                  hparams: Optional[HParams] = None) -> dict:
  """Run the sections ``args`` (from :func:`build_parser`) ask for and
  return the result line as a dict. ``hparams``: the model and training
  base (full ``HParams()`` when None)."""
  t_begin = time.perf_counter()

  def within_budget() -> bool:
    return time.perf_counter() - t_begin < args.budget_seconds

  device = resolve_device(args.device)

  def sync():
    if device.type == "cuda":
      torch.cuda.synchronize(device)

  launches0, bwd_launches0 = kl.LAUNCHES, kl.BWD_LAUNCHES
  base = hparams or HParams()
  hp = overwrite_custom_hparams(base, {"compute_dtype": args.dtype})
  config = WaveGlowConfig.from_hparams(hp)
  cdt = compute_dtype_from_name(args.dtype)
  sr = hp.sampling_rate

  # weights go to the device once; bf16 synthesis takes them cast once
  params_np = init_params(config, seed=0)
  params = params_to_torch(fuse_for_inference(params_np), device)
  cparams = params_for_compute(params, cdt)
  rng = np.random.default_rng(0)
  mel = to_device(rng.standard_normal(
      (args.batch, hp.n_mel_channels, args.frames)).astype(np.float32),
                  device)

  def synthesize(m, seed):
    return infer(cparams, config, m, sigma=1.0, seed=seed,
                 compute_dtype=cdt, device=device)

  wav = synthesize(mel, 0)  # warm-up
  sync()
  audio_seconds_per_call = wav.shape[0] * wav.shape[1] / sr
  start = time.perf_counter()
  for i in range(args.iters):
    wav = synthesize(mel, i + 1)
  sync()
  elapsed = time.perf_counter() - start
  audio_sec_per_sec = audio_seconds_per_call * args.iters / elapsed

  extras = {
      "dtype": args.dtype,
      "batch": args.batch,
      "utterance_seconds": round(audio_seconds_per_call / args.batch, 3),
      "per_utterance_realtime_factor": round(
          audio_sec_per_sec / args.batch, 1),
      "platform": "gpu" if device.type == "cuda" else "cpu",
      "device": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
      "power_limit_w": power_limit_w(device),
  }

  latency = args.latency and within_budget()
  if args.latency and not latency:
    extras["latency_skipped"] = "budget"
  if latency:
    # batch 1: the reference's usage model, one utterance a call; each
    # call synchronised (device-resident mel in, waveform left there)
    mel1 = mel[:1]
    wav1 = synthesize(mel1, 0)
    sync()
    utt_seconds = wav1.shape[1] / sr
    lat = []
    for i in range(args.latency_iters):
      t0 = time.perf_counter()
      synthesize(mel1, 100 + i)
      sync()
      lat.append(time.perf_counter() - t0)
    p50 = float(np.median(lat))
    extras["batch1_latency_s_p50"] = round(p50, 4)
    extras["per_utterance_realtime_factor_batch1"] = round(
        utt_seconds / p50, 1)

    # streaming: wall clock until the first piece is on the host
    def raw_stream(seed):
      return stream_chunks(cparams, config, mel1, sigma=1.0, seed=seed,
                           chunk_frames=args.stream_chunk_frames,
                           compute_dtype=cdt, device=device)

    def first_chunk(seed):
      gen = raw_stream(seed)
      _, piece = next(gen)
      piece = piece.cpu()
      gen.close()
      return piece

    piece = first_chunk(0)  # warm-up
    lat = []
    for i in range(args.latency_iters):
      t0 = time.perf_counter()
      first_chunk(200 + i)
      lat.append(time.perf_counter() - t0)
    extras["streaming_first_audio_latency_s_p50"] = round(
        float(np.median(lat)), 4)
    extras["streaming_first_chunk_audio_s"] = round(piece.shape[1] / sr, 3)
    extras["streaming_chunk_frames"] = args.stream_chunk_frames

    # denoised streaming: raw pieces through the windowed streaming
    # denoiser, a block sized so that the first chunk completes one
    dn = Denoiser(params, config, TSTFTHParams(), device)
    stft = dn.stft
    edge = stft.filter_length - stft.hop_length
    block = max(stft.hop_length,
                (args.stream_chunk_frames * 256 - 2 * edge
                 + stft.filter_length // 2)
                // stft.hop_length * stft.hop_length)

    def first_denoised(seed):
      gen = raw_stream(seed)
      sd = StreamingDenoiser(dn, DENOISER_STRENGTH, block_samples=block)
      for _, raw_piece in gen:
        out = sd.push(raw_piece[0].cpu().numpy())
        if out:
          gen.close()
          return out[0][1]
      return sd.flush()[0][1]

    first_denoised(0)  # warm-up
    lat_dn = []
    for i in range(args.latency_iters):
      t0 = time.perf_counter()
      first_denoised(300 + i)
      lat_dn.append(time.perf_counter() - t0)
    extras["streaming_first_audio_denoised_s_p50"] = round(
        float(np.median(lat_dn)), 4)
    del dn

  train = args.train and within_budget()
  if args.train and not train:
    extras["training_skipped"] = "budget"
  if train:
    overrides = {"compute_dtype": args.dtype,
                 "batch_size": str(args.train_batch),
                 **parse_custom_hparams(args.train_hparams)}

    def train_rate(thp, batch):
      """(samples/s, step s, last loss) of ``--train-iters`` steps after a
      warm-up step, from fresh weights, on one audio batch."""
      tparams = trainable_params_from_numpy(params_np, device)
      optimizer = make_optimizer(tparams, thp.learning_rate)
      step = make_train_step(config, thp, MelSTFT(thp, device), optimizer)
      audio = to_device(rng.uniform(
          -0.5, 0.5, (batch, thp.segment_length)).astype(np.float32), device)
      loss = step(tparams, audio)  # warm-up
      sync()
      t0 = time.perf_counter()
      for _ in range(args.train_iters):
        loss = step(tparams, audio)
      sync()
      t_el = time.perf_counter() - t0
      return batch * args.train_iters / t_el, t_el / args.train_iters, loss

    rate, step_s, loss = train_rate(
        overwrite_custom_hparams(base, overrides), args.train_batch)
    extras["training_samples_per_sec"] = round(rate, 2)
    extras["training_step_seconds"] = round(step_s, 4)
    extras["training_loss_finite"] = bool(np.isfinite(float(loss)))

  if args.train and args.train_batch24:
    if not (train and within_budget()):
      extras["training_batch24_skipped"] = "budget"
    else:
      # the reference workload's batch (24) as 3 micro-batches of 8
      thp24 = overwrite_custom_hparams(base, {
          **overrides, "batch_size": str(BATCH24),
          "grad_accum": str(BATCH24_ACCUM)})
      rate24, _, _ = train_rate(thp24, BATCH24)
      extras["training_samples_per_sec_batch24"] = round(rate24, 2)
      extras["training_batch24_config"] = f"grad_accum={BATCH24_ACCUM}"

  extras["wn_kernel_launches"] = kl.LAUNCHES - launches0
  if cdt is not None:
    extras["bwd_kernel_launches"] = kl.BWD_LAUNCHES - bwd_launches0
  return {"metric": METRIC, "value": round(audio_sec_per_sec, 2),
          "unit": "audio-sec/s/chip", **extras}


def main(argv=None) -> None:
  print(json.dumps(run_benchmark(build_parser().parse_args(argv))))


if __name__ == "__main__":
  main()
