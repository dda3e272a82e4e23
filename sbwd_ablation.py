"""Where the bf16 shard backward's rows kernel spends its time, on one
NVIDIA card.

  python3 sbwd_ablation.py

Builds timing-only variants of waveglow_tpu_torch/csrc/wn_layer_bwd.cu
(under waveglow_tpu_torch/build/sbwd_ablation/, one nvcc per variant,
started together) and times each of its four kernels at B=12, T=2,000, d=1
(torch.profiler, the mean of 10 calls) at (C, C') = (256, 128), (512, 256),
(256, 32) and (128, 16):
  base       the kernels as they are (their gradients against
             wn_layer_shard_backward, relative to each gradient's max
             |value|);
  no_a       the rows kernel without its A operands: no f32 copies of x
             and g, no rounding into the A slots (the weight ring, the
             wgmmas and the epilogue stay);
  no_round   the f32 copies stay, the rounding goes;
  no_b       the rows kernel without its weight copies;
  no_wgmma   the rows kernel without its wgmmas.
The variants' gradients are wrong by design: only their times mean
anything. The last line is one JSON object.
"""

import json

import torch

import ablation
import chip_smoke as cs
from waveglow_tpu_torch.kernels import wn_layer as kl

PAIRS = ((256, 128), (512, 256), (256, 32), (128, 16))
STEP = "__device__ __forceinline__ void srows_step("
EDITS = {
    "no_a": [("    srows_load_a<kC, L::kNrs>(",
              "    if (false) srows_load_a<kC, L::kNrs>(", None),
             ("  srows_convert<kC, L::kNrs>(",
              "  if (false) srows_convert<kC, L::kNrs>(", None)],
    "no_round": [("  srows_convert<kC, L::kNrs>(",
                  "  if (false) srows_convert<kC, L::kNrs>(", None)],
    "no_b": [("    srows_load_b<kC, kCP, kLast>(",
              "    if (false) srows_load_b<kC, kCP, kLast>(", None)],
    "no_wgmma": [("    wgmma_m64<kN, 0, kTransB>(",
                  "    if (false) wgmma_m64<kN, 0, kTransB>(", STEP)],
}


def inputs(c: int, cp: int):
  gen = torch.Generator(device="cuda").manual_seed(c + cp)
  dev, bf = torch.device("cuda", 0), torch.bfloat16

  def rand(*shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device=dev) * scale

  saved = (rand(12, 2000, c), rand(12, 2000, 2 * cp).to(bf),
           rand(3 * c, 2 * cp, scale=c ** -0.5).to(bf),
           rand(2 * cp, scale=0.1), rand(cp * 2 * c, scale=cp ** -0.5).to(bf))
  return saved, rand(12, 2000, 2 * c)


def main() -> None:
  device = cs.phase_device()
  libs = ablation.build("sbwd_ablation", ablation.variants(
      (kl.CSRC / "wn_layer_bwd.cu").read_text(), EDITS))
  out = {"device": device["nvidia_smi"], "shape": "B=12,T=2000,d=1"}
  for c, cp in PAIRS:
    saved, g = inputs(c, cp)
    ref = kl.wn_layer_shard_backward(saved, g, 1, torch.bfloat16)
    for name, lib in libs.items():
      ablation.use(lib)
      rec = {"kernels_ms": cs.shard_backward_kernel_ms(saved, g, 1)}
      if name == "base":
        got = kl.wn_layer_shard_backward_fused(saved, g, 1)
        rec["err_of_scale"] = max(
            (a.float() - b.float()).abs().max().item()
            / b.float().abs().max().item() for a, b in zip(got, ref))
      out[f"{name},C={c},C'={cp}"] = rec
      print(name, c, cp, json.dumps(rec), flush=True)
  print(json.dumps(out))


if __name__ == "__main__":
  main()
