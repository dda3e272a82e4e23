"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py [--seed N] [--out DIR]

Phases, in order; any error or tolerance breach fails the run (nonzero exit):
  1. device: a CUDA card is required; TF32 is switched off and printed.
  2. build: the fused WN-layer kernel is compiled from
     waveglow_tpu_torch/csrc/wn_layer.cu; build seconds and ptxas facts
     (when this run built it), and what the loaded build uses as the CUDA
     runtime reports it (registers, local bytes, shared memory).
  3. kernel: the kernel against its plain PyTorch version on the card at
     C=256, T=26,432 groups (826 frames), B in {1, 8}, every dilation and
     the last-layer variant, f32 and bf16, per-row valid_t, skip_acc on;
     times of kernel, plain version and a library yardstick beside the
     bound.
  4. slice: the full-width 12-flow x 256-channel model from random weights
     (seeded; the zero-initialised end convs randomised) saved and loaded as
     an npz checkpoint, served through Synthesizer.infer_serving and
     infer_serving_many in f32 and bf16 (two of the requests share a bucket,
     so one micro-batch has two rows of different true length); kernel
     launch counts, batched rows against solo calls, waveform against the
     plain path, bucket exactness, bf16 against f32, latency and
     throughput.
  5. a `kernels` JSON line, the card's name and power limit, and last the
     `{"ok": true, ...}` line.

Imports nothing of jax and nothing of the JAX package. Details go to
``<out>/chip_smoke.json`` (default ``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.hparams import HParams
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models.waveglow import (UPSAMPLE_STRIDE,
                                                WaveGlowConfig,
                                                infer, infer_noise_shapes,
                                                init_params)

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 on
# the CUDA cores, bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}

C = 256
T_KERNEL = 26_432          # 826 mel frames x 32 groups per frame
N_LAYERS = 8
FRAMES = (200, 230, 517, 826)  # the slice's requests; 200 and 230 share
BUCKET = 64                    # the 256-frame bucket
# Tolerances, stated before the run. Kernel vs plain: f32 sums the K=768
# conv product in another order; in bf16 an f32 ulp of difference can flip
# the bf16 rounding of an act, so the bound scales with the output.
KERNEL_TOL_F32 = 1e-4
KERNEL_TOL_BF16_REL = 2e-2
# Full model, kernel path vs plain path (same weights and noise), relative
# to max|wav|: 12 flows of exp(-log_s) couplings amplify per-layer
# differences.
SLICE_TOL_REL = {"f32": 1e-3, "bf16": 5e-2}

MODES = {"f32": None, "bf16": torch.bfloat16}


def log(msg: str) -> None:
  print(msg, flush=True)


def fail(msg: str) -> None:
  raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
  """Mean device milliseconds per call, by CUDA events over ``reps``."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


# -- phase 1 ---------------------------------------------------------------

def phase_device() -> dict:
  if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is False: a CUDA card is required")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  info = {"name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "nvidia_smi": nvidia_smi_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
  log("device " + json.dumps(info))
  return info


# -- phase 2 ---------------------------------------------------------------

def variant(mode: str, last: bool) -> str:
  return f"{mode},{'last' if last else 'layer'}"


def parse_ptxas(build_log: str) -> dict:
  """ptxas facts per kernel variant: registers, spills, static smem."""
  facts = {}
  name = None
  for line in build_log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      mangled = m.group(1)
      inst = re.search(r"wn_layer_kernelI(f|13__nv_bfloat16)Lb[01]ELb([01])E",
                       mangled)
      name = variant("f32" if inst.group(1) == "f" else "bf16",
                     inst.group(2) == "1") if inst else mangled
      facts[name] = {}
      continue
    if name is None:
      continue
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if m:
      facts[name]["spill_store_bytes"] = int(m.group(1))
      facts[name]["spill_load_bytes"] = int(m.group(2))
    m = re.search(r"Used (\d+) registers", line)
    if m:
      facts[name]["registers"] = int(m.group(1))
      m2 = re.search(r"(\d+) bytes smem", line)
      facts[name]["static_smem_bytes"] = int(m2.group(1)) if m2 else 0
  return facts


def phase_build() -> dict:
  start = time.perf_counter()
  kl.build_library()
  kl._library()
  seconds = time.perf_counter() - start
  built = kl.BUILD_SECONDS is not None
  attributes = {variant(mode, last): kl.kernel_info(mode == "bf16", last)
                for mode in MODES for last in (False, True)}
  info = {"built_in_this_run": built,
          "build_s": kl.BUILD_SECONDS if built else "cached",
          "build_and_load_s": seconds,
          "ptxas": (parse_ptxas(kl.BUILD_LOG) if built
                    else "cached: built by an earlier process"),
          "attributes": attributes}
  log("build " + json.dumps(info))
  if built and set(info["ptxas"]) != set(attributes):
    fail(f"ptxas facts for {sorted(info['ptxas'])}, expected "
         f"{sorted(attributes)}")
  return info


# -- phase 3 ---------------------------------------------------------------

def layer_inputs(batch: int, t: int, last: bool, dtype, seed: int):
  """Inputs at the scale the model feeds the layer, on the card."""
  g = torch.Generator(device="cuda").manual_seed(seed)

  def rand(*shape, scale):
    return torch.randn(*shape, generator=g, device="cuda") * scale

  rs = C if last else 2 * C
  valid = torch.tensor([t - 1000 * (i % 2) for i in range(batch)],
                       dtype=torch.int32, device="cuda")
  keep = torch.arange(t, device="cuda")[None, :, None] < valid[:, None, None]
  x = rand(batch, t, C, scale=0.5) * keep
  cond = rand(batch, t, 2, C, scale=0.5).to(dtype)
  w_in = rand(3, C, 2 * C, scale=(3 * C) ** -0.5).to(dtype)
  b_in = rand(2 * C, scale=0.1)
  w_rs = rand(C, rs, scale=C ** -0.5).to(dtype)
  b_rs = rand(rs, scale=0.1)
  acc = rand(batch, t, C, scale=1.0)
  return (x, cond, w_in, b_in, w_rs, b_rs), valid, acc


def layer_cost(batch: int, t: int, last: bool, mode: str):
  """(bytes, flops, bound_ms, bound_by) of one layer call: every input read
  once, every output written once; flops of the two products."""
  esize = 2 if mode == "bf16" else 4
  rs = C if last else 2 * C
  rows = batch * t
  nbytes = (rows * C * 4                       # x
            + rows * 2 * C * esize             # cond
            + (3 * C * 2 * C + C * rs) * esize  # w_in, w_rs
            + (2 * C + rs) * 4 + batch * 4     # biases, valid_t
            + rows * C * 4                     # skip_acc read
            + 2 * rows * C * 4)                # x' and skip written
  flops = 2 * rows * C * (3 * 2 * C + rs)
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[mode] * 1e3
  return nbytes, flops, max(t_bytes, t_ops), (
      "bytes" if t_bytes >= t_ops else "operations")


def library_layer(x, cond, w_in, b_in, w_rs, b_rs, dilation, dtype):
  """Yardstick the port never calls: cuDNN conv1d for the taps and a cuBLAS
  matmul for the res/skip (the layer's two products), with the gate between
  them. Inputs are given channels-first where conv1d wants them."""
  x_cf, w_conv = x, w_in
  pre = F.conv1d(x_cf, w_conv, b_in, padding=dilation, dilation=dilation)
  c = w_conv.shape[1]
  gates = pre.transpose(1, 2) + cond
  acts = torch.tanh(gates[..., :c]) * torch.sigmoid(gates[..., c:])
  return torch.matmul(acts.to(dtype), w_rs)


def phase_kernel(seed: int) -> dict:
  results = []
  timed = {}
  for mode, cdt in MODES.items():
    dtype = cdt or torch.float32
    for batch in (1, 8):
      for i in range(N_LAYERS + 1):
        last = i == N_LAYERS
        dilation = 2 ** min(i, N_LAYERS - 1)
        args, valid, acc = layer_inputs(batch, T_KERNEL, last, dtype,
                                        seed + i)
        xk, sk = kl.wn_layer_fused(*args, dilation, valid_t=valid,
                                   skip_acc=acc.clone(), compute_dtype=cdt)
        torch.cuda.synchronize()
        xp, sp = kl.wn_layer_plain(*args, dilation, valid_t=valid,
                                   skip_acc=acc.clone(), compute_dtype=cdt)
        err = max((xk - xp).abs().max().item(), (sk - sp).abs().max().item())
        scale = max(xp.abs().max().item(), sp.abs().max().item())
        bound = (KERNEL_TOL_F32 if mode == "f32"
                 else KERNEL_TOL_BF16_REL * scale)
        if not (torch.isfinite(xk).all() and torch.isfinite(sk).all()):
          fail(f"kernel output not finite ({mode}, B={batch}, d={dilation})")
        for row, v in enumerate(valid.tolist()):
          if v < T_KERNEL and xk[row, v:].abs().max().item() != 0:
            fail(f"kernel left rows >= valid_t nonzero ({mode}, B={batch})")
        rec = {"mode": mode, "B": batch, "dilation": dilation, "last": last,
               "max_abs_err": err, "bound": bound, "ref_max_abs": scale}
        if err > bound:
          fail(f"kernel disagrees with plain: {rec}")
        if dilation == 1 or last:
          nbytes, flops, bound_ms, bound_by = layer_cost(batch, T_KERNEL,
                                                         last, mode)
          skip = acc.clone()
          rec["kernel_ms"] = cuda_ms(lambda: kl.wn_layer_fused(
              *args, dilation, valid_t=valid, skip_acc=skip,
              compute_dtype=cdt))
          rec["plain_ms"] = cuda_ms(lambda: kl.wn_layer_plain(
              *args, dilation, valid_t=valid, skip_acc=skip,
              compute_dtype=cdt))
          x, cond, w_in, b_in, w_rs, b_rs = args
          x_cf = x.to(dtype).transpose(1, 2).contiguous()
          w_conv = w_in.permute(2, 1, 0).contiguous()   # [2C, C, 3]
          cond_flat = cond.reshape(batch, T_KERNEL, 2 * C)
          b_lib = b_in.to(dtype)
          rec["library_ms"] = cuda_ms(lambda: library_layer(
              x_cf, cond_flat, w_conv, b_lib, w_rs, b_rs, dilation, dtype))
          rec.update(bytes=nbytes, flops=flops, bound_ms=bound_ms,
                     bound_by=bound_by,
                     share_of_bound=bound_ms / rec["kernel_ms"])
          timed[(mode, batch, last)] = rec
        log("kernel " + json.dumps(rec))
        results.append(rec)
        del args, acc, xk, sk, xp, sp
  torch.cuda.empty_cache()
  return {"cases": results, "timed": timed}


# -- phase 4 ---------------------------------------------------------------

def full_width_checkpoint(seed: int, path: Path) -> CheckpointWaveglow:
  """12 x 256 model from the seed, every ``end`` randomised small (a zero
  end conv makes each coupling the identity and hides the kernel)."""
  hp = HParams()
  params = init_params(WaveGlowConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 1)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.02).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.02).astype(np.float32)
  CheckpointWaveglow.from_params(params, hp, iteration=1).save(path)
  return CheckpointWaveglow.load(path)


def phase_slice(ckpt: CheckpointWaveglow, mode: str, seed: int):
  """Serve the requests in ``mode``; returns the record and the first
  request's samples."""
  torch.cuda.reset_peak_memory_stats()
  synth = Synthesizer(ckpt, compute_dtype="bfloat16" if mode == "bf16"
                      else "float32", device="cuda")
  rng = np.random.default_rng(seed)
  mels = [rng.uniform(-11.0, 1.0, (80, f)).astype(np.float32) for f in FRAMES]
  seeds = [seed + i for i in range(len(mels))]
  synth.infer_serving(mels[0], seed=seeds[0], bucket_frames=BUCKET)  # warm-up

  # -- the main path, with the launch count read around it
  kl.LAUNCHES = 0
  solo, per_call = [], []
  for mel, s in zip(mels, seeds):
    before = kl.LAUNCHES
    solo.append(synth.infer_serving(mel, seed=s, bucket_frames=BUCKET))
    per_call.append(kl.LAUNCHES - before)
  before = kl.LAUNCHES
  # infer_serving_many is dispatch + finalize; both halves are called here
  # so the batches it formed can be read
  dispatched = synth.serving_many_dispatch(mels, seeds=seeds,
                                           bucket_frames=BUCKET)
  many = synth.serving_many_finalize(dispatched)
  many_launches = kl.LAUNCHES - before
  launches = kl.LAUNCHES
  batch_rows = [len(rows) for rows, _, _ in dispatched[0]]
  per_synthesis = synth.config.n_flows * synth.config.n_layers
  if per_call != [per_synthesis] * len(mels):
    fail(f"{mode}: launches per infer_serving {per_call}, expected "
         f"{per_synthesis} each")
  if max(batch_rows) < 2:
    fail(f"{mode}: infer_serving_many formed no batch of 2 rows or more: "
         f"{batch_rows}")
  if many_launches != per_synthesis * len(batch_rows):
    fail(f"{mode}: infer_serving_many launched {many_launches}, expected "
         f"{per_synthesis * len(batch_rows)} for batches {batch_rows}")
  for res, mel in zip(solo + many, mels + mels):
    if res.samples.shape != (mel.shape[-1] * UPSAMPLE_STRIDE,):
      fail(f"{mode}: output shape {res.samples.shape}")
    if not np.isfinite(res.samples).all():
      fail(f"{mode}: output not finite")
  many_vs_solo_rows = [float(np.abs(a.samples - b.samples).max())
                       for a, b in zip(solo, many)]
  many_vs_solo = max(many_vs_solo_rows)
  wav_scale = max(float(np.abs(r.samples).max()) for r in solo)
  if many_vs_solo > SLICE_TOL_REL[mode] * wav_scale:
    fail(f"{mode}: infer_serving_many rows differ from solo calls by "
         f"{many_vs_solo}")

  # -- kernel path vs plain path, same weights and injected noise
  mel, mel_seed = mels[-2], seeds[-2]   # 517 frames
  n_groups = mel.shape[-1] * UPSAMPLE_STRIDE // synth.config.n_group
  noise = [rng.standard_normal(s).astype(np.float32)
           for s in infer_noise_shapes(synth.config, 1, n_groups)]
  wav_k = synth.infer(mel, noise=noise, denoiser_strength=0.0).wav
  with torch.inference_mode():
    wav_p = infer(synth.params, synth.config,
                  torch.from_numpy(mel[None]).cuda(), noise=noise,
                  compute_dtype=synth._cdt,
                  layer=kl.wn_layer_plain)[0].cpu().numpy()
  plain_err = float(np.abs(wav_k - wav_p).max())
  plain_bound = SLICE_TOL_REL[mode] * float(np.abs(wav_p).max())
  if not np.isfinite(wav_k).all() or plain_err > plain_bound:
    fail(f"{mode}: kernel path vs plain path {plain_err} > {plain_bound}")

  # -- bucket exactness: kept samples of a padded call vs the unpadded call
  padded = synth.infer(mel, seed=mel_seed, bucket_frames=BUCKET,
                       denoiser_strength=0.0).wav
  unpadded = synth.infer(mel, seed=mel_seed, denoiser_strength=0.0).wav
  bucket_err = float(np.abs(padded - unpadded).max())
  bucket_bound = SLICE_TOL_REL[mode] * float(np.abs(unpadded).max())
  if bucket_err > bucket_bound:
    fail(f"{mode}: bucket-padded kept samples differ by {bucket_err}")

  # -- latency and throughput of infer_serving (host clock, synchronised)
  lat, audio_s = [], 0.0
  wall = time.perf_counter()
  for _ in range(3):
    for mel_i, s in zip(mels, seeds):
      t0 = time.perf_counter()
      synth.infer_serving(mel_i, seed=s, bucket_frames=BUCKET)
      lat.append(time.perf_counter() - t0)
      audio_s += mel_i.shape[-1] * UPSAMPLE_STRIDE / synth.hparams.sampling_rate
  wall = time.perf_counter() - wall
  t0 = time.perf_counter()
  synth.infer_serving_many(mels, seeds=seeds, bucket_frames=BUCKET)
  many_s = time.perf_counter() - t0
  info = {"mode": mode, "launches": launches,
          "profile_826_frames": profile_request(synth, mels[-1], seeds[-1]),
          "launches_per_synthesis": per_call,
          "many_launches": many_launches,
          "many_batch_rows": batch_rows,
          "many_vs_solo_max_abs": many_vs_solo_rows,
          "kernel_vs_plain_max_abs": plain_err,
          "kernel_vs_plain_bound": plain_bound,
          "bucket_max_abs": bucket_err, "bucket_bound": bucket_bound,
          "p50_latency_s": float(np.median(lat)),
          "latencies_s": lat,
          "audio_sec_per_s": audio_s / wall,
          "serving_many_s": many_s,
          "serving_many_requests": len(mels),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
  log("slice " + json.dumps(info))
  del synth
  torch.cuda.empty_cache()
  return info, solo[0].samples


def kernel_family(name: str) -> str:
  if "wn_layer_kernel" in name:
    return "wn_layer kernel"
  if re.search(r"gemm|xmma|nvjet|cutlass|cublas", name, re.I):
    return "cuBLAS matmul (cond, upsample, 1x1, STFT)"
  return "elementwise, copies and reductions"


def profile_request(synth: Synthesizer, mel: np.ndarray, seed: int) -> dict:
  """Device time of one infer_serving request by kernel family, and the
  device's idle share of the request's wall time (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    synth.infer_serving(mel, seed=seed, bucket_frames=BUCKET)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  families, top = {}, []
  for ev in prof.key_averages():
    # Host ops, and the device-timeline spans the profiler records for each
    # of them (named after the op), would count their kernels twice.
    if (ev.device_type != torch.autograd.DeviceType.CUDA
        or getattr(ev, "is_user_annotation", False)
        or ev.key.startswith("aten::")):
      continue
    dev_us = ev.self_device_time_total
    if dev_us <= 0:
      continue
    fam = kernel_family(ev.key)
    families[fam] = families.get(fam, 0.0) + dev_us / 1e3
    top.append((dev_us / 1e3, ev.count, ev.key[:90]))
  busy_ms = sum(families.values())
  top.sort(reverse=True)
  return {"wall_ms": wall_ms,
          "device_busy_ms": busy_ms if busy_ms else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if busy_ms else "not measured",
          "by_family_ms": families,
          "top_kernels": [{"ms": ms, "count": n, "name": k}
                          for ms, n, k in top[:8]]}


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--seed", type=int, default=1234)
  parser.add_argument("--out", type=Path, default=Path("chiprun_out"))
  args = parser.parse_args()

  device = phase_device()
  build = phase_build()
  kernel = phase_kernel(args.seed)
  with tempfile.TemporaryDirectory() as tmp:
    t0 = time.perf_counter()
    ckpt = full_width_checkpoint(args.seed, Path(tmp) / "1.npz")
    log(f"checkpoint 12x256 written and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
  slices, first = {}, {}
  for mode in MODES:
    slices[mode], first[mode] = phase_slice(ckpt, mode, args.seed)
  # bf16 really ran: the same request (same seed) differs from f32
  bf16_vs_f32 = float(np.abs(first["bf16"] - first["f32"]).max())
  scale = float(np.abs(first["f32"]).max())
  log(f"bf16 vs f32, first request: max abs {bf16_vs_f32} (scale {scale})")
  if not bf16_vs_f32 > 0:
    fail("bf16 serving gave the f32 waveform: bf16 did not run")
  slices["bf16"]["vs_f32_max_abs"] = bf16_vs_f32

  kernels = []
  for mode in MODES:
    rec = kernel["timed"][(mode, 1, False)]
    errs = [c["max_abs_err"] for c in kernel["cases"] if c["mode"] == mode]
    kernels.append({
        "name": f"wn_layer_fused[{mode}]", "route": "cuda",
        "source": "waveglow_tpu_torch/csrc/wn_layer.cu",
        "replaces": "waveglow_tpu/kernels/wn_layer.py:259",
        "launches": slices[mode]["launches"],
        "max_abs_err": max(errs), "ms": rec["kernel_ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "shape": f"B=1,T={T_KERNEL},C={C},d=1",
        "launches_per_synthesis": slices[mode]["launches_per_synthesis"][0],
        "ptxas": (build["ptxas"].get(variant(mode, False))
                  if build["built_in_this_run"] else build["ptxas"]),
        "loaded_build": build["attributes"][variant(mode, False)]})

  args.out.mkdir(parents=True, exist_ok=True)
  detail = {"device": device, "build": build,
            "kernel_cases": kernel["cases"], "slices": slices,
            "kernels": kernels}
  (args.out / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
  print(json.dumps({"kernels": kernels}))
  print(device["nvidia_smi"])
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
