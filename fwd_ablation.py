"""Where the bf16 WN-layer forward at C = 512 spends its time, on one
NVIDIA card.

  python3 fwd_ablation.py

Builds timing-only variants of waveglow_tpu_torch/csrc/wn_layer.cu (under
waveglow_tpu_torch/build/fwd_ablation/, one nvcc per variant, started
together) and times the bf16 layer at C = 512 (kl.wn_layer_fused, B=1,
T=26,432, d=1, a non-last layer, skip_acc on): the call by CUDA events (20
calls after 3 warm-ups) and each kernel by torch.profiler
(chip_smoke.kernel_split, the mean of 10 calls). The variants:
  base       the kernels as they are (the output against wn_layer_plain,
             relative to its max |value|);
  no_wgmma   without the wgmmas;
  no_taps    without the taps: no rounding of x is launched and the gate
             kernel copies no tap rows;
  no_ring    without the weight copies into the ring.
The variants' outputs are wrong by design: only their times mean anything.
The last line is one JSON object.
"""

import json

import torch

import ablation
import chip_smoke as cs
from waveglow_tpu_torch.kernels import wn_layer as kl

C, T = 512, 26_432
WIDE = "__device__ __forceinline__ void wide_products("
GATE = "wn_layer_kernel_gate(const bf16* __restrict__ x_bf,"
EDITS = {
    "no_wgmma": [("    for (int k = 0; k < L::kKC / 16; ++k) {",
                  "    for (int k = 0; k < 0; ++k) {", WIDE)],
    "no_taps": [("  wn_layer_kernel_round<<<",
                 "  if (false) wn_layer_kernel_round<<<", None),
                ("        cp_async16_zfill(\n",
                 "        if (false) cp_async16_zfill(\n", GATE)],
    "no_ring": [("      wide_load_b(stage,",
                 "      if (false) wide_load_b(stage,", None)],
}


def main() -> None:
  device = cs.phase_device()
  libs = ablation.build("fwd_ablation", ablation.variants(
      (kl.CSRC / "wn_layer.cu").read_text(), EDITS))
  args, valid, acc = cs.layer_inputs(1, T, False, torch.bfloat16, 7, C)
  ref = kl.wn_layer_plain(*args, 1, valid_t=valid, skip_acc=acc.clone(),
                          compute_dtype=torch.bfloat16)
  skip = acc.clone()
  out = {"device": device["nvidia_smi"], "shape": f"B=1,T={T},C={C},d=1"}
  for name, lib in libs.items():
    ablation.use(lib)

    def run():
      return kl.wn_layer_fused(*args, 1, valid_t=valid, skip_acc=skip,
                               compute_dtype=torch.bfloat16)

    # round, gate and res/skip; without the taps no rounding is launched
    rec = {"ms": cs.cuda_ms(run), "kernels_ms": cs.kernel_split(
        run, cs.FWD_SPLIT, 2 if name == "no_taps" else 3)}
    if name == "base":
      got = kl.wn_layer_fused(*args, 1, valid_t=valid, skip_acc=acc.clone(),
                              compute_dtype=torch.bfloat16)
      rec["err_of_scale"] = max(
          ((g - r).abs().max() / r.abs().max()).item()
          for g, r in zip(got, ref))
    out[name] = rec
    print(name, json.dumps(rec), flush=True)
  ablation.use(None)
  print(json.dumps(out))


if __name__ == "__main__":
  main()
