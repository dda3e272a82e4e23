"""Where the bf16 shard backward's rows kernel spends its time, on one
NVIDIA card.

  python3 sbwd_ablation.py

Builds timing-only variants of waveglow_tpu_torch/csrc/wn_layer_shard_bwd.cu
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

import ctypes
import json
import subprocess

import torch

import chip_smoke as cs
from waveglow_tpu_torch.kernels import wn_layer as kl

OUT = kl.BUILD_DIR / "sbwd_ablation"
PAIRS = ((256, 128), (512, 256), (256, 32), (128, 16))
# (text, replacement) edits of the source, each found exactly once
EDITS = {
    "no_a": [("    srows_load_a<kC, L::kNrs>(",
              "    if (false) srows_load_a<kC, L::kNrs>("),
             ("  srows_convert<kC, L::kNrs>(",
              "  if (false) srows_convert<kC, L::kNrs>(")],
    "no_round": [("  srows_convert<kC, L::kNrs>(",
                  "  if (false) srows_convert<kC, L::kNrs>(")],
    "no_b": [("    srows_load_b<kC, kCP, kLast>(",
              "    if (false) srows_load_b<kC, kCP, kLast>(")],
    "no_wgmma": [("    wgmma_m64<kN, 0, kTransB>(",
                  "    if (false) wgmma_m64<kN, 0, kTransB>(")],
}


def variants(src: str) -> dict:
  out = {"base": src}
  for name, edits in EDITS.items():
    text = src
    for old, new in edits:
      if text.count(old) != 1:
        raise SystemExit(f"{name}: {old!r} is not in the source once")
      text = text.replace(old, new)
    out[name] = text
  return out


def build(sources: dict) -> dict:
  OUT.mkdir(parents=True, exist_ok=True)
  procs = {}
  for name, text in sources.items():
    (OUT / f"{name}.cu").write_text(text)
    procs[name] = subprocess.Popen(
        [kl._nvcc(), *kl.NVCC_FLAGS, "-I", str(kl.CSRC), "-shared", "-o",
         str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  libs = {}
  for name, proc in procs.items():
    log = proc.communicate()[0]
    if proc.returncode:
      raise SystemExit(f"nvcc failed for {name}:\n{log}")
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    # the three entries wn_layer_shard_backward_fused calls, bound as
    # kl._library() binds them
    lib.wn_layer_shard_backward_bf16.argtypes = (
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.wn_layer_shard_backward_bf16.restype = ctypes.c_int
    lib.wn_layer_shard_bwd_tile_rows.argtypes = [ctypes.c_int] * 2
    lib.wn_layer_shard_bwd_tile_rows.restype = ctypes.c_int
    lib.wn_layer_shard_bwd_weight_tiles.argtypes = [ctypes.c_int] * 3
    lib.wn_layer_shard_bwd_weight_tiles.restype = ctypes.c_int
    libs[name] = lib
  return libs


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
  src = (kl.CSRC / "wn_layer_shard_bwd.cu").read_text()
  libs = build(variants(src))
  out = {"device": device["nvidia_smi"], "shape": "B=12,T=2000,d=1"}
  for c, cp in PAIRS:
    saved, g = inputs(c, cp)
    ref = kl.wn_layer_shard_backward(saved, g, 1, torch.bfloat16)
    for name, lib in libs.items():
      kl._LIB = lib
      kl._shard_bwd_plan.cache_clear()
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
