"""Where the bf16 WN-layer forward's wgmma gate and res/skip kernels spend
their time, the C = 512 layer's and every model rank's share, on one
NVIDIA card.

  python3 fwd_ablation.py

Builds timing-only variants of waveglow_tpu_torch/csrc/wn_layer.cu (under
waveglow_tpu_torch/build/fwd_ablation/, one nvcc per variant, started
together) and times, through each, the bf16 layer at C = 512
(kl.wn_layer_fused, B=1, T=26,432, d=1, a non-last layer, skip_acc on) and
rank 0's share of a layer at every (C, C') pair (kl.wn_layer_shard, same
shape; at C = 512 the layer's three kernels at gate width C', below it the
rank kernel, at (256, 128) the gate kernel on the f32 x and the res/skip
kernel): the call by CUDA
events (20 calls after 3 warm-ups) and each kernel by torch.profiler
(chip_smoke.kernel_split, the mean of 10 calls). The variants:
  base       the kernels as they are (the output against its plain
             version, relative to its max |value|);
  no_wgmma   without the wgmmas;
  no_taps    without the taps: no rounding of x is launched and the gate
             kernels copy no tap rows;
  no_ring    without the weight copies into the ring;
  no_acts    the res/skip kernel copies no acts (at C = 512 and at (256,
             128)): with the gate kernel's stores of them, what holding
             the acts in shared memory, as the rank kernel does, could
             save there at most.
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
GATE = "__device__ __forceinline__ void gate_rounded_x("
TAPS = "__device__ __forceinline__ void rank_body("
RS = "wn_layer_kernel_rs(const float* __restrict__ x,"
EDITS = {
    "no_wgmma": [("    for (int k = 0; k < L::kKC / 16; ++k) {",
                  "    for (int k = 0; k < 0; ++k) {", WIDE),
                 ("      for (int k = 0; k < L::kKC / 16; ++k)\n"
                  "        wgmma_m64<kNg",
                  "      for (int k = 0; k < 0; ++k)\n"
                  "        wgmma_m64<kNg", TAPS),
                 ("        for (int k = 0; k < kG / 16; ++k) {",
                  "        for (int k = 0; k < 0; ++k) {", TAPS)],
    "no_taps": [("  wn_layer_kernel_round<<<",
                 "  if (false) wn_layer_kernel_round<<<", None),
                ("        cp_async16_zfill(\n",
                 "        if (false) cp_async16_zfill(\n", GATE),
                ("        cp_async16_zfill(\n            f32s +",
                 "        if (false) cp_async16_zfill(\n            f32s +",
                 TAPS)],
    "no_ring": [("      wide_load_b<", "      if (false) wide_load_b<", None),
                ("        cp_async16_zfill(\n            stage + (n / 64)",
                 "        if (false) cp_async16_zfill(\n"
                 "            stage + (n / 64)", TAPS)],
    "no_acts": [("        cp_async16_zfill(stage + sw128_piece(r, q),\n"
                 "                         acts +",
                 "        if (false) cp_async16_zfill(\n"
                 "            stage + sw128_piece(r, q),\n"
                 "                         acts +", RS)],
}


def main() -> None:
  device = cs.phase_device()
  libs = ablation.build("fwd_ablation", ablation.variants(
      (kl.CSRC / "wn_layer.cu").read_text(), EDITS))
  bf = torch.bfloat16
  args, valid, acc = cs.layer_inputs(1, T, False, bf, 7, C)
  ref = kl.wn_layer_plain(*args, 1, valid_t=valid, skip_acc=acc.clone(),
                          compute_dtype=bf)
  inputs = {C: args}
  for c in sorted({c for c, _ in kl.shard_pairs()} - {C}):
    inputs[c] = cs.layer_inputs(1, T, False, bf, 7, c)[0]
  ranks = {(c, cp): cs.shard_slices(inputs[c], c // cp, 0)
           for c, cp in kl.shard_pairs()}
  rank_refs = {pair: kl.wn_layer_shard_plain(inputs[pair[0]][0], *sl, 1,
                                             compute_dtype=bf)
               for pair, sl in ranks.items()}
  skip = acc.clone()
  out = {"device": device["nvidia_smi"], "shape": f"B=1,T={T},d=1"}
  for name, lib in libs.items():
    ablation.use(lib)

    def layer():
      return kl.wn_layer_fused(*args, 1, valid_t=valid, skip_acc=skip,
                               compute_dtype=bf)

    calls = {"layer": (layer, 3)}
    for (c, cp), sl in ranks.items():
      x = inputs[c][0]
      calls[f"C={c},C'={cp}"] = (
          lambda x=x, sl=sl: kl.wn_layer_shard(x, *sl, 1, compute_dtype=bf),
          len(kl.wide_kernels(c, cp)))
    for case, (run, kernels) in calls.items():
      # without the taps no rounding of x is launched
      if name == "no_taps" and kernels == 3:
        kernels = 2
      rec = {"ms": cs.cuda_ms(run),
             "kernels_ms": cs.kernel_split(run, cs.FWD_SPLIT, kernels)}
      if name == "base":
        if case == "layer":
          got = kl.wn_layer_fused(*args, 1, valid_t=valid,
                                  skip_acc=acc.clone(), compute_dtype=bf)
          pairs = zip(got, ref)
        else:
          c, cp = (int(v.split("=")[1]) for v in case.split(","))
          pairs = [(run(), rank_refs[(c, cp)])]
        rec["err_of_scale"] = max(
            ((g - r).abs().max() / r.abs().max()).item() for g, r in pairs)
      out[f"{name},{case}"] = rec
      print(name, case, json.dumps(rec), flush=True)
  ablation.use(None)
  print(json.dumps(out))


if __name__ == "__main__":
  main()
