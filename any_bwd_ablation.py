"""Where the shape-generic bf16 WN backward's time goes, on one NVIDIA card.

  python3 any_bwd_ablation.py [--variants base,serial,...]

Builds variants of waveglow_tpu_torch/csrc/wn_layer_bwd_any.cu (under
waveglow_tpu_torch/build/ablation_any_bwd/, one nvcc per variant, started
together; ablation.py) and times kl.wn_layer_backward_any through each
(CUDA events, 20 calls after 3 warm-ups; each kernel by torch.profiler,
chip_smoke.kernel_split) at chip_smoke.py phase 17's timed shapes (C, K) =
(256, 5), (384, 3), (256, 3), B=12, T=2,000, d=1, a non-last layer, beside
the bound, each kernel's own bound (kernel_bounds), the library's
backward and, at (256, 3), the specialised backward in the same run:
  base      the kernels as they are (the gradients against
            wn_layer_backward, each relative to its max |value|);
  stages4   every ring at most 4 stages, 2 chunks in flight (the rows
            kernel's six stages, dx's and weights' five or six below N =
            256, cut to four);
  ahead1    one chunk in flight under a product's wgmmas;
  wait0     each chunk's wgmmas waited for before the next chunk's step,
            none left running under its loads;
  serial    both: the overlap of the design this one replaced;
  w128      the weights kernel's tiles 128 columns wide where 256 divides
            Cp (at C = 256), twice the tiles, so its cut takes fewer
            ranges;
  dx_wide   the dx kernel's tiles as wide as the weights' (256 at C = 256,
            not 128: half the blocks, each dgates row read half as often,
            a ring of four stages, not six; the same at 384);
  per_row   (the base build) the weights kernel's ranges cut inside each
            batch row (kl.bwd_splits), never runs of whole batch rows: at
            least one workspace slot a batch row;
  no_a      the rows kernel without its A copies (the bf16 x taps and drs;
            its weight copies, wgmmas and epilogue stay);
  no_b      the rows kernel without its weight copies;
  no_wgmma  no product kernel's wgmmas (the copies, barriers and epilogues
            stay).
stages4, ahead1, wait0, serial, w128, dx_wide and per_row compute the same
function (held against wn_layer_backward like base); the gradients of
no_a, no_b and no_wgmma are wrong by design: only their times mean
anything. Each variant's registers and spills come from ptxas. The last
line is one JSON object.
"""

import argparse
import json

import torch

import ablation
import chip_smoke as cs
from waveglow_tpu_torch.kernels import wn_layer as kl

STEP = "__device__ __forceinline__ void ring_step("
ROWS = "wn_bwd_any_rows_kernel(const __grid_constant__ BwdArgs a) {"
AHEAD = ("constexpr int ring_ahead(int stages) { return stages - 2; }",
         "constexpr int ring_ahead(int stages) { return 1; }", None)
WAIT = ("  wgmma_wait<1>();\n  fence_acc(acc);",
        "  wgmma_wait<0>();\n  fence_acc(acc);", STEP)
EDITS = {
    "stages4": [("/ stage < 6 ? (kSmemMax - extra) / stage : 6;",
                 "/ stage < 4 ? (kSmemMax - extra) / stage : 4;", None)],
    "ahead1": [AHEAD],
    "wait0": [WAIT],
    "serial": [AHEAD, WAIT],
    "w128": [("return cp % 256 == 0 ? 256 :", "return cp % 256 == 0 ? 128 :",
              None)],
    "dx_wide": [("  return cp % 192 == 0 ? 192 : cp % 128 == 0 ? 128 : 64;",
                 "  return n_tile(cp);", None),
                ("    default: dx_body<192>(a, ring); break;",
                 "    case 192: dx_body<192>(a, ring); break;\n"
                 "    default: dx_body<256>(a, ring); break;", None)],
    "no_a": [("          cp_async16_zfill(st + a_dst + i * 4096, ok ? x0",
              "          if (false) cp_async16_zfill(st + a_dst + i * 4096, "
              "ok ? x0", ROWS),
             ("          cp_async16_zfill(st + a_dst + i * 4096,\n"
              "                           ok ? ga",
              "          if (false) cp_async16_zfill(st + a_dst + i * 4096,\n"
              "                           ok ? ga", ROWS)],
    "no_b": [("          cp_async16(st + wg_dst + i * 2048, w0",
              "          if (false) cp_async16(st + wg_dst + i * 2048, w0",
              ROWS),
             ("          cp_async16(st + kABytes + a_dst + i * 4096,\n",
              "          if (false)\n"
              "          cp_async16(st + kABytes + a_dst + i * 4096,\n",
              ROWS)],
    "no_wgmma": [("    wgmma_m64<kN, kTransA, kTransB>(",
                  "    if (false) wgmma_m64<kN, kTransA, kTransB>(", STEP)],
}
HOST = ("per_row",)  # variants of the host's plan, on the base build
SHAPES = ((256, 5), (384, 3), (256, 3))


def per_row_splits(batch, t, tiles, sms):
  """kl.any_bwd_splits restricted to cuts inside each batch row."""
  return (1, *kl.bwd_splits(batch, t, tiles, sms))


def kernel_bounds(width: int, k: int, ranges: int) -> dict:
  """Each kernel's least time (ms) at B=12, T=2,000, a non-last layer (C a
  multiple of 64: no pad kernel), as a function of its own inputs and
  outputs: its products at the bf16 tensor-core rate or its bytes (each
  input read once, each output written once) at the memory rate,
  whichever takes longer. prep: x, dx_next, dskip in, bf16 x and drs out;
  rows: the gate recompute and dacts (bf16 x, drs, cond in; acts, dcond
  out); dx: the taps' adjoint (dcond, dx_next in; dx out); weights: dw_in
  and dw_rs (bf16 x, dcond, acts, drs in; ``ranges`` f32 partials out);
  reduce: the partials and the column sums in, the gradients out."""
  rows, c, n_rs = 12 * 2_000, width, 2 * width
  slot = (k * c * 2 * c + c * n_rs) * 4
  bias = 12 * -(-2_000 // kl.ANY_BWD_TILE_ROWS) * (2 * c + n_rs) * 4
  work = {  # (operations, bytes)
      "prep": (0, rows * c * 4 * 3 + rows * (c + n_rs) * 2 + bias // 2),
      "rows": (2 * rows * (k * c * 2 * c + n_rs * c),
               rows * (c + n_rs + 2 * c) * 2 + rows * 3 * c * 2),
      "dx": (2 * rows * k * 2 * c * c, rows * 2 * c * 2 + rows * c * 8),
      "weights": (2 * rows * (k * c * 2 * c + c * n_rs),
                  rows * (c + 2 * c + c + n_rs) * 2 + ranges * slot),
      "reduce": (0, ranges * slot + bias + (2 * c + n_rs) * 4
                 + (k * c * 2 * c + c * n_rs) * 2)}
  return {name: max(ops / cs.PEAK_FLOPS["bf16"],
                    nbytes / cs.HBM_BYTES_PER_S) * 1e3
          for name, (ops, nbytes) in work.items()}


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--variants",
                      default=",".join(["base", *EDITS, *HOST]))
  args = parser.parse_args()
  names = args.variants.split(",")
  device = cs.phase_device()
  src = (kl.CSRC / "wn_layer_bwd_any.cu").read_text()
  logs = {}
  built = {k: v for k, v in ablation.variants(src, EDITS).items()
           if k in names or (k == "base" and set(names) & set(HOST))}
  libs = ablation.build("ablation_any_bwd", built, logs)
  out = {"device": device["nvidia_smi"], "shape": "B=12,T=2000,d=1",
         "ptxas": {k: {n: f for n, f in cs.parse_ptxas(log).items()
                       if ",any,bwd" in n} for k, log in logs.items()}}
  print(json.dumps(out["ptxas"]), flush=True)
  splits = kl.any_bwd_splits
  for width, k in SHAPES:
    inputs, cot = cs.trainable_inputs(False, torch.bfloat16, 1234, width, k)
    saved = tuple(a.detach() for a in inputs)
    cost = cs.trainable_cost(False, "bf16", width, k)
    ref = kl.wn_layer_backward(saved, *cot, 1, None, torch.bfloat16)
    rec = {"C": width, "K": k, "bound_ms": cost["bwd_bound_ms"],
           "library_ms": cs.library_grads_ms(saved, cot, 1, torch.bfloat16,
                                             True)}
    if (width, k) == (256, 3):
      ablation.use(None)
      rec["specialised_ms"] = cs.cuda_ms(
          lambda: kl.wn_layer_backward_fused(saved, *cot, 1))
    for name in names:
      ablation.use(libs["base" if name in HOST else name])
      kl.any_bwd_splits = per_row_splits if name == "per_row" else splits
      got = kl.wn_layer_backward_any(saved, *cot, 1)
      rec[name] = {
          "ms": cs.cuda_ms(lambda: kl.wn_layer_backward_any(saved, *cot, 1)),
          "kernels_ms": cs.kernel_split(
              lambda: kl.wn_layer_backward_any(saved, *cot, 1),
              cs.ANY_BWD_SPLIT, len(kl.any_bwd_kernels(width))),
          "ranges": kl._any_bwd_plan(12, 2_000, width, k, False,
                                     got[0].device)["ranges"],
          "kernel_bound_ms": kernel_bounds(
              width, k, kl._any_bwd_plan(12, 2_000, width, k, False,
                                         got[0].device)["ranges"]),
          "err_of_scale": max(((g.float() - r.float()).abs().max()
                               / r.float().abs().max()).item()
                              for g, r in zip(got, ref))}
      kl.any_bwd_splits = splits
      del got
    ablation.use(None)
    out[f"C={width},K={k}"] = rec
    print(json.dumps(rec), flush=True)
    del inputs, cot, saved, ref
    torch.cuda.empty_cache()
  print(json.dumps(out))


if __name__ == "__main__":
  main()
