"""Where the shape-generic f32 WN forward's time goes, on one NVIDIA card.

  python3 any_ablation.py [--variants base,divide,...]

Builds variants of waveglow_tpu_torch/csrc/wn_layer_any.cu (under
waveglow_tpu_torch/build/ablation_any/, one nvcc per variant, started
together; ablation.py) and times kl.wn_layer_any in f32 through each
(CUDA events, 20 calls after 3 warm-ups, with skip_acc and a per-row
valid_t as phase 16 of chip_smoke.py feeds it) at B=1, T=26,432, d=1 at
phase 16's timed (C, K), and at T = 24,576 at (256, 5), where every block
holds two whole 96-row tiles and no short one, beside the bound and the
library's time (cuDNN conv1d over K taps, the gate, a cuBLAS matmul; TF32
off) in the same run:
  base     the kernels as they are (the output against wn_layer_plain);
  divide   the f32 kernel's divisions by run-time sizes on every K chunk
           as divisions, not multiply-shifts by divisors made on the host;
  no_rest  a block's last tile of 16 rows or fewer run pass by pass, not
           its two passes at once;
  no_c64   Cp = 64 through the 96-row instance (one column of warps idle),
           not its own 192-row one;
  no_fma   no FMA loops (the loads, barriers, gate and epilogue stay);
  no_w     no weight copies (the taps and the acts are copied).
divide, no_rest and no_c64 compute the same function (held against
wn_layer_plain like base); the outputs of no_fma and no_w are wrong by
design: only their times mean anything. Each variant's registers and
spills come from ptxas. The last line is one JSON object.
"""

import argparse
import json

import torch

import ablation
import chip_smoke as cs
from waveglow_tpu_torch.kernels import wn_layer as kl

F32 = "wn_any_kernel_f32(const __grid_constant__ AnyArgs a) {"
FMA = "        if (busy) {\n          const float* slot"
EDITS = {
    "divide": [("div_by(chunk, a.div_tile)", "chunk / a.div_tile.d", F32),
               ("div_by(local, a.div_gate)", "local / a.div_gate.d", F32),
               ("div_by(kc, a.div_tap16)", "kc / a.div_tap16.d", F32),
               ("div_by(j, div_acts16)", "j / div_acts16.d", F32)],
    "no_rest": [("const bool rest = !kTwo &&", "const bool rest = false &&",
                 F32)],
    "no_c64": [("return pad64(G) == 64;", "return false;", None)],
    "no_fma": [(FMA, FMA.replace("(busy)", "(false)"), F32)],
    "no_w": [("      cp_async16_zfill(wslot + (k * L::kWLd + n) * 4,",
              "      if (false)\n"
              "      cp_async16_zfill(wslot + (k * L::kWLd + n) * 4,",
              "__device__ __forceinline__ void f32_copy_w(")],
}
# (C, K, T): phase 16's timed shapes, and (256, 5) with no short tile
SHAPES = ((256, 5, cs.T_KERNEL), (256, 5, 24_576), (384, 3, cs.T_KERNEL),
          (64, 3, cs.T_KERNEL), (256, 3, cs.T_KERNEL))


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--variants", default=",".join(["base", *EDITS]))
  args = parser.parse_args()
  names = args.variants.split(",")
  device = cs.phase_device()
  src = (kl.CSRC / "wn_layer_any.cu").read_text()
  logs = {}
  libs = ablation.build("ablation_any", {
      k: v for k, v in ablation.variants(src, EDITS).items() if k in names},
      logs)
  out = {"device": device["nvidia_smi"],
         "ptxas": {k: {n: f for n, f in cs.parse_ptxas(log).items()
                       if n.startswith("f32")} for k, log in logs.items()}}
  print(json.dumps(out["ptxas"]), flush=True)
  for width, k, t in SHAPES:
    inputs, valid, acc = cs.layer_inputs(1, t, False, torch.float32, 7,
                                         width, k)
    ref = kl.wn_layer_plain(*inputs, 1, valid_t=valid, skip_acc=acc.clone())
    x, cond, w_in, b_in, w_rs, b_rs = inputs
    x_cf = x.transpose(1, 2).contiguous()
    w_conv = w_in.permute(2, 1, 0).contiguous()
    cond_flat = cond.reshape(1, t, 2 * width)
    rec = {"C": width, "K": k, "T": t,
           "bound_ms": cs.layer_cost(1, t, False, "f32", width, k,
                                     generic=True)[2],
           "library_ms": cs.cuda_ms(lambda: cs.library_layer(
               x_cf, cond_flat, w_conv, b_in, w_rs, b_rs, 1,
               torch.float32))}
    for name in names:
      ablation.use(libs[name])
      got = kl.wn_layer_any(*inputs, 1, valid_t=valid, skip_acc=acc.clone())
      skip = acc.clone()
      rec[name] = {"ms": cs.cuda_ms(lambda: kl.wn_layer_any(
          *inputs, 1, valid_t=valid, skip_acc=skip)),
                   "max_abs_err": max((g - r).abs().max().item()
                                      for g, r in zip(got, ref))}
      del got, skip
    ablation.use(None)
    out[f"C={width},K={k},T={t}"] = rec
    print(json.dumps(rec), flush=True)
    del inputs, valid, acc, ref, x_cf, w_conv, cond_flat
    torch.cuda.empty_cache()
  print(json.dumps(out))


if __name__ == "__main__":
  main()
