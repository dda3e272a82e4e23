"""Where the f32 (parity) WN forward kernel's time goes, on one NVIDIA card.

  python3 fwd_f32_ablation.py

Builds variants of waveglow_tpu_torch/csrc/wn_layer.cu (under
waveglow_tpu_torch/build/ablation_f32/, one nvcc per variant, started
together) and times the f32 kernel (CUDA events, 20 calls after 3 warm-ups,
with skip_acc and a per-row valid_t as phase 3 of chip_smoke.py feeds it) at
B=1 and B=8, T=26,432, d=1, the last layer at B=1, and the training
segment (B=12, T=2,000):
  base       the kernel as it is;
  chunk32    32-row K chunks through a 2-stage ring (the largest chunk the
             shared memory holds with the acts);
  tile64     64-row tiles of 512 threads (4 warps a scheduler at most 128
             registers a thread: ptxas spills);
  no_fma     no FMA loops (the loads, barriers, gate and epilogue stay);
  no_loads   no ring loads past the prologue (the FMAs read stale slots).
The first three are correct kernels, held against wn_layer_plain; the
outputs of the last two are wrong by design: only their times mean
anything. Each variant's registers and spills come from ptxas.
"""

import ctypes
import json
import subprocess

import torch

import chip_smoke as cs
from waveglow_tpu_torch.kernels import wn_layer as kl

OUT = kl.BUILD_DIR / "ablation_f32"
SHAPES = ((1, cs.T_KERNEL, False), (1, cs.T_KERNEL, True),
          (8, cs.T_KERNEL, False), (cs.B_TRAIN, cs.T_TRAIN, False))


def edit(src: str, old: str, new: str, count: int = 1) -> str:
  if src.count(old) != count:
    raise SystemExit(f"expected {count} of {old!r} in the source")
  return src.replace(old, new)


def only_width(src: str, width: int) -> str:
  """The source with every instance but ``width``'s taken out of the
  launchers' dispatch (a variant need only fit that width)."""
  for other in kl.kernel_widths():
    if other != width:
      src = edit(src, f"    case {other}: return dispatch_width<{other}>(a, "
                      "bf16_mode, last, kernel, smem_bytes);\n", "")
      src = edit(src, f"    case {other}: err = f32_slots_for<{other}>(last, "
                      "sms, blocks_per_sm); break;\n", "")
  return src


def variants(src: str) -> dict:
  src = only_width(src, cs.C)
  return {
      "base": src,
      "chunk32": edit(edit(src, "constexpr int kChunk = 16;",
                           "constexpr int kChunk = 32;"),
                      "kStages = kC > 256 ? 3 : 4;",
                      "kStages = kC > 256 ? 3 : 2;"),
      "tile64": edit(src, "constexpr int kRowPairs = 3;",
                     "constexpr int kRowPairs = 4;"),
      "no_fma": edit(src, "        if (busy) {\n          const float* slot",
                     "        if (false) {\n          const float* slot", 2),
      "no_loads": edit(src, ", n_chunks, load_chunk);", ", 0, load_chunk);",
                       2)}


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
    fn = ctypes.CDLL(str(OUT / f"{name}.so")).wn_layer_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    libs[name] = (fn, {k: v for k, v in cs.parse_ptxas(log).items()
                       if k.startswith("f32")})
  return libs


def call(fn, args, dilation, valid, skip):
  """The launch wn_layer_fused makes in f32, with skip_acc."""
  x, cond, w_in, b_in, w_rs, b_rs = args
  x_out = torch.empty_like(x)
  err = fn(x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
           w_rs.data_ptr(), b_rs.data_ptr(), valid.data_ptr(),
           x_out.data_ptr(), skip.data_ptr(), 1, x.shape[0], x.shape[1],
           cs.C, dilation, 0, int(w_rs.numel() == cs.C * cs.C),
           torch.cuda.current_stream().cuda_stream)
  if err:
    raise SystemExit(f"launch failed: cudaError {err}")
  return x_out, skip


def main() -> None:
  device = cs.phase_device()
  libs = build(variants(kl.SOURCES[0].read_text()))
  for name, (_, ptxas) in libs.items():
    print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
  for batch, t, last in SHAPES:
    args, valid, acc = cs.layer_inputs(batch, t, last, torch.float32, 7)
    ref = kl.wn_layer_plain(*args, 1, valid_t=valid, skip_acc=acc.clone())
    rec = {"B": batch, "T": t, "last": last,
           "bound_ms": cs.layer_cost(batch, t, last, "f32", cs.C)[2]}
    for name, (fn, _) in libs.items():
      got = call(fn, args, 1, valid, acc.clone())
      skip = acc.clone()
      rec[name] = {"ms": cs.cuda_ms(lambda: call(fn, args, 1, valid, skip)),
                   "max_abs_err": max((g - r).abs().max().item()
                                      for g, r in zip(got, ref))}
    print(json.dumps(rec), flush=True)
    del args, valid, acc, ref
  print(device["nvidia_smi"])


if __name__ == "__main__":
  main()
