"""Where the bf16 WN-layer forward at C = 512 spends its time, the whole
layer's and a model rank's share, on one NVIDIA card.

  python3 fwd_ablation.py

Builds timing-only variants of waveglow_tpu_torch/csrc/wn_layer.cu (under
waveglow_tpu_torch/build/fwd_ablation/, one nvcc per variant, started
together) and times, through each, the bf16 layer at C = 512
(kl.wn_layer_fused, B=1, T=26,432, d=1, a non-last layer, skip_acc on) and
rank 0's share of it at C' = 256, 128 and 64 (kl.wn_layer_shard; the same
three kernels at gate width C'): the call by CUDA events (20 calls after 3
warm-ups) and each kernel by torch.profiler (chip_smoke.kernel_split, the
mean of 10 calls). The variants:
  base       the kernels as they are (the output against its plain
             version, relative to its max |value|);
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
RANKS = (256, 128, 64)
WIDE = "__device__ __forceinline__ void wide_products("
GATE = "wn_layer_kernel_gate(const bf16* __restrict__ x_bf,"
EDITS = {
    "no_wgmma": [("    for (int k = 0; k < L::kKC / 16; ++k) {",
                  "    for (int k = 0; k < 0; ++k) {", WIDE)],
    "no_taps": [("  wn_layer_kernel_round<<<",
                 "  if (false) wn_layer_kernel_round<<<", None),
                ("        cp_async16_zfill(\n",
                 "        if (false) cp_async16_zfill(\n", GATE)],
    "no_ring": [("      wide_load_b<", "      if (false) wide_load_b<", None)],
}


def main() -> None:
  device = cs.phase_device()
  libs = ablation.build("fwd_ablation", ablation.variants(
      (kl.CSRC / "wn_layer.cu").read_text(), EDITS))
  bf = torch.bfloat16
  args, valid, acc = cs.layer_inputs(1, T, False, bf, 7, C)
  ref = kl.wn_layer_plain(*args, 1, valid_t=valid, skip_acc=acc.clone(),
                          compute_dtype=bf)
  ranks = {cp: cs.shard_slices(args, C // cp, 0) for cp in RANKS}
  rank_refs = {cp: kl.wn_layer_shard_plain(args[0], *sl, 1, compute_dtype=bf)
               for cp, sl in ranks.items()}
  skip = acc.clone()
  out = {"device": device["nvidia_smi"], "shape": f"B=1,T={T},C={C},d=1"}
  for name, lib in libs.items():
    ablation.use(lib)

    def layer():
      return kl.wn_layer_fused(*args, 1, valid_t=valid, skip_acc=skip,
                               compute_dtype=bf)

    calls = {"layer": layer}
    for cp, sl in ranks.items():
      calls[f"C'={cp}"] = (
          lambda sl=sl: kl.wn_layer_shard(args[0], *sl, 1, compute_dtype=bf))
    for case, run in calls.items():
      # round, gate and res/skip; without the taps no rounding is launched
      rec = {"ms": cs.cuda_ms(run), "kernels_ms": cs.kernel_split(
          run, cs.FWD_SPLIT, 2 if name == "no_taps" else 3)}
      if name == "base":
        if case == "layer":
          got = kl.wn_layer_fused(*args, 1, valid_t=valid,
                                  skip_acc=acc.clone(), compute_dtype=bf)
          pairs = zip(got, ref)
        else:
          cp = int(case.split("=")[1])
          pairs = [(run(), rank_refs[cp])]
        rec["err_of_scale"] = max(
            ((g - r).abs().max() / r.abs().max()).item() for g, r in pairs)
      out[f"{name},{case}"] = rec
      print(name, case, json.dumps(rec), flush=True)
  ablation.use(None)
  print(json.dumps(out))


if __name__ == "__main__":
  main()
