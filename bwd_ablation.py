"""Where the bf16 WN-layer backward's time goes, on one NVIDIA card.

  python3 bwd_ablation.py

Times the whole layer's bf16 backward (kl.wn_layer_backward_fused) at C =
128, 256 and 512, B=12, T=2,000, d=1, a non-last layer: the call by CUDA
events (20 calls after 3 warm-ups) and each of its kernels by
torch.profiler (chip_smoke.backward_kernel_ms, the mean of 10 calls), with
the gradients against wn_layer_backward relative to each gradient's max
|value|. It then builds timing-only variants of
waveglow_tpu_torch/csrc/wn_layer_bwd.cu (under
waveglow_tpu_torch/build/bwd_ablation/, one nvcc per variant, started
together) and times the kernels of each:
  no_a       the rows kernel without its A copies (the prep kernel's bf16
             x taps and drs; the weight copies, the wgmmas and the
             epilogue stay);
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

WIDTHS = (128, 256, 512)
B, T = 12, 2_000
FRAME = "__device__ __forceinline__ void frows_step("
EDITS = {
    "no_a": [("    for (int i = 0; i < kTileRows * 8 / kThreads; ++i) {\n"
              "      const int r = threadIdx.x / 8 + 32 * i;\n"
              "      if (j < L::kTapChunks) {",
              "    for (int i = 0; i < 0; ++i) {\n"
              "      const int r = threadIdx.x / 8 + 32 * i;\n"
              "      if (j < L::kTapChunks) {", None)],
    "no_b": [("    srows_load_b<kC, kC, kLast>(stage + kABytes,",
              "    if (false) srows_load_b<kC, kC, kLast>(stage + kABytes,",
              None)],
    "no_wgmma": [("    wgmma_m64<kN, 0, kTransB>(",
                  "    if (false) wgmma_m64<kN, 0, kTransB>(", FRAME)],
}


def main() -> None:
  device = cs.phase_device()
  variants = ablation.variants((kl.CSRC / "wn_layer_bwd.cu").read_text(),
                               EDITS)
  del variants["base"]  # the base is the package's own build
  libs = ablation.build("bwd_ablation", variants)
  out = {"device": device["nvidia_smi"], "shape": f"B={B},T={T},d=1"}
  for c in WIDTHS:
    gen = torch.Generator(device="cuda").manual_seed(c)

    def rand(*shape, scale=1.0):
      return torch.randn(*shape, generator=gen, device="cuda") * scale

    bf = torch.bfloat16
    saved = (rand(B, T, c, scale=0.5), rand(B, T, 2 * c, scale=0.5).to(bf),
             rand(3 * c, 2 * c, scale=(3 * c) ** -0.5).to(bf),
             rand(2 * c, scale=0.1), rand(c, 2 * c, scale=c ** -0.5).to(bf),
             rand(2 * c, scale=0.1))
    cot = (rand(B, T, c), rand(B, T, c))

    def run():
      return kl.wn_layer_backward_fused(saved, *cot, 1)

    ref = kl.wn_layer_backward(saved, *cot, 1, None, bf)
    rec = {"ms": cs.cuda_ms(run),
           "kernels_ms": cs.backward_kernel_ms(saved, cot, 1),
           "err_of_scale": max(
               ((g.float() - r.float()).abs().max()
                / r.float().abs().max()).item()
               for g, r in zip(run(), ref))}
    out[f"base,C={c}"] = rec
    print("base", c, json.dumps(rec), flush=True)
    for name, lib in libs.items():
      ablation.use(lib)
      rec = {"kernels_ms": cs.backward_kernel_ms(saved, cot, 1)}
      out[f"{name},C={c}"] = rec
      print(name, c, json.dumps(rec), flush=True)
    ablation.use(None)  # the package's own build for the next width
    del saved, cot, ref
    torch.cuda.empty_cache()
  print(json.dumps(out))


if __name__ == "__main__":
  main()
