"""Where the f32 (parity) WN forward's time goes at C = 512, on one NVIDIA
card.

  python3 fwd_f32_ablation.py [--variants base,no_fma,...]

Builds variants of the C = 512 f32 kernels (wn_layer_kernel_f32_tiles and
_rest) of waveglow_tpu_torch/csrc/wn_layer.cu with only C = 512 in the
launchers' dispatch (under
waveglow_tpu_torch/build/ablation_f32/, one nvcc per variant, started
together; ablation.py) and times
kl.wn_layer_fused in f32 through each (CUDA events, 20 calls after 3
warm-ups, with skip_acc and a per-row valid_t as phase 3 of chip_smoke.py
feeds it) at B=1, T=26,432, d=1 and d=128, the last layer at B=1, B=8 and
phase 12's training shape (B=4, T=2,000), beside the bound and the
library's time (cuDNN conv1d, the gate, a cuBLAS matmul; TF32 off) in
the same run:
  base           the kernel as it is (its output against wn_layer_plain);
  no_fma         no FMA loops (the loads, barriers, gate and epilogue stay);
  no_loads       no ring loads past the prologue (the FMAs read stale
                 slots);
  no_w           no weight copies (the taps and the acts are copied);
  no_tap_copies  no tap copies (the weights are copied);
  no_tap_reload  the taps of x copied for the first gate pass only (the
                 gate copies every tap again in each pass);
the layouts (held against wn_layer_plain like base):
  tile48         every tile in the 48-row layout (two passes of 256
                 channels), the acts still through the scratch;
  tile96         every tile in the 96-row layout (four passes of 128
                 channels), the rest too;
  rest48         the rest in one tile of the 48-row layout (4 warps for
                 each 16 rows) instead of 16-row tiles of one 512-channel
                 pass (8 warps).
The outputs of no_fma, no_loads, no_w, no_tap_copies and no_tap_reload
are wrong by design: only their times mean anything. Each variant's
registers and spills come from ptxas. Last, the first variant's kernel
runs back to back at B=8 for CLOCK_S seconds while nvidia-smi reads the SM
clock and the power draw every 100 ms: the clock the FMA loop really runs
at, against the 1,980 MHz the 67 TFLOP/s peak assumes. The last line is
one JSON object.
"""

import argparse
import json
import subprocess
import time

import torch

import ablation
import chip_smoke as cs
from waveglow_tpu_torch.kernels import wn_layer as kl

BLOCK = "__device__ __forceinline__ void f32_wide_block("
LOAD = "__device__ __forceinline__ void f32_wide_load("
REST = "using F32Rest = F32Wide<512, 1, 3>;"
TAPS = "  if (r < L::kTileRows)\n    cp_async16_zfill(slot + (r * kChunk"
EDITS = {
    "no_fma": [("        if (busy) {\n          const float* slot",
                "        if (false) {\n          const float* slot", BLOCK)],
    "no_loads": [(", n_chunks, load_chunk);", ", 0, load_chunk);", BLOCK),
                 (", gate_limit, load_chunk);", ", 0, load_chunk);", BLOCK),
                 ("if (c < n_chunks) load_chunk(c);",
                  "if (false) load_chunk(c);", BLOCK)],
    "no_w": [("copy_rows<", "if (false) copy_rows<", LOAD)],
    "no_tap_copies": [(TAPS, TAPS.replace("(r < L", "(false && r < L"),
                       LOAD)],
    "no_tap_reload": [(TAPS, TAPS.replace("(r < L", "(pass == 0 && r < L"),
                       LOAD)],
    "tile48": [("using F32Tiles = F32Wide<128, 6>;",
                "using F32Tiles = F32Wide<256, 3>;", None)],
    "tile96": [(REST, "using F32Rest = F32Wide<128, 6>;", None)],
    "rest48": [(REST, "using F32Rest = F32Wide<256, 3>;", None)],
}
C = 512
CLOCK_S = 5.0
# (B, T, dilation, last)
SHAPES = ((1, cs.T_KERNEL, 1, False), (1, cs.T_KERNEL, 128, False),
          (1, cs.T_KERNEL, cs.LAST_DILATION, True),
          (8, cs.T_KERNEL, 1, False), (4, cs.T_TRAIN, 1, False))


def only_width(src: str, width: int) -> str:
  """The source with every instance but ``width``'s taken out of the
  launchers' dispatch (a variant need only fit that width)."""
  for other in kl.kernel_widths():
    if other != width:
      for old in (f"    case {other}: return dispatch_width<{other}>(a, "
                  "bf16_mode, last, kernel, smem_bytes);\n",
                  f"    case {other}: err = f32_slots_for<{other}>(last, "
                  "sms, blocks_per_sm); break;\n"):
        src = ablation.edit(src, old, "", None)
  return src


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--variants", default=",".join(["base", *EDITS]))
  args = parser.parse_args()
  names = args.variants.split(",")
  device = cs.phase_device()
  src = only_width((kl.CSRC / "wn_layer.cu").read_text(), C)
  logs = {}
  libs = ablation.build("ablation_f32", {
      k: v for k, v in ablation.variants(src, EDITS).items() if k in names},
      logs)
  out = {"device": device["nvidia_smi"], "C": C,
         "ptxas": {k: {n: f for n, f in cs.parse_ptxas(log).items()
                       if n.startswith("f32")} for k, log in logs.items()}}
  print(json.dumps(out["ptxas"]), flush=True)
  for batch, t, dilation, last in SHAPES:
    inputs, valid, acc = cs.layer_inputs(batch, t, last, torch.float32, 7,
                                         C)
    ref = kl.wn_layer_plain(*inputs, dilation, valid_t=valid,
                            skip_acc=acc.clone())
    x, cond, w_in, b_in, w_rs, b_rs = inputs
    x_cf = x.transpose(1, 2).contiguous()
    w_conv = w_in.permute(2, 1, 0).contiguous()
    cond_flat = cond.reshape(batch, t, 2 * C)
    rec = {"B": batch, "T": t, "dilation": dilation, "last": last,
           "bound_ms": cs.layer_cost(batch, t, last, "f32", C)[2],
           "library_ms": cs.cuda_ms(lambda: cs.library_layer(
               x_cf, cond_flat, w_conv, b_in, w_rs, b_rs, dilation,
               torch.float32))}
    for name in names:
      ablation.use(libs[name])
      got = kl.wn_layer_fused(*inputs, dilation, valid_t=valid,
                              skip_acc=acc.clone())
      skip = acc.clone()
      rec[name] = {"ms": cs.cuda_ms(lambda: kl.wn_layer_fused(
          *inputs, dilation, valid_t=valid, skip_acc=skip)),
                   "max_abs_err": max((g - r).abs().max().item()
                                      for g, r in zip(got, ref))}
      del got, skip
    ablation.use(None)
    out[f"B={batch},T={t},d={dilation}{',last' if last else ''}"] = rec
    print(json.dumps(rec), flush=True)
    del inputs, valid, acc, ref, x_cf, w_conv, cond_flat
    torch.cuda.empty_cache()
  ablation.use(libs[names[0]])
  out["under_load"] = clocks_under_load()
  ablation.use(None)
  print(json.dumps(out["under_load"]), flush=True)
  print(json.dumps(out))


def clocks_under_load() -> dict:
  """The SM clock (MHz) and power draw (W) that nvidia-smi reads every
  100 ms while the f32 layer at C = 512, B=8 runs back to back for
  CLOCK_S seconds (after a warm-up): their minimum, median and maximum
  over the samples."""
  inputs, valid, acc = cs.layer_inputs(8, cs.T_KERNEL, False, torch.float32,
                                       7, C)
  skip = acc.clone()
  for _ in range(20):
    kl.wn_layer_fused(*inputs, 1, valid_t=valid, skip_acc=skip)
  torch.cuda.synchronize()
  smi = subprocess.Popen(
      ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
       "--format=csv,noheader,nounits", "-lms", "100"],
      stdout=subprocess.PIPE, text=True)
  start, calls = time.perf_counter(), 0
  while time.perf_counter() - start < CLOCK_S:
    for _ in range(20):
      kl.wn_layer_fused(*inputs, 1, valid_t=valid, skip_acc=skip)
    torch.cuda.synchronize()
    calls += 20
  smi.terminate()
  lines = smi.communicate()[0].strip().splitlines()
  samples = [tuple(float(v) for v in line.split(",")) for line in lines
             if line.count(",") == 1]
  out = {"calls": calls, "samples": len(samples)}
  for i, key in enumerate(("sm_mhz", "power_w")):
    vals = sorted(s[i] for s in samples)
    if vals:
      out[key] = {"min": vals[0], "median": vals[len(vals) // 2],
                  "max": vals[-1]}
  return out


if __name__ == "__main__":
  main()
