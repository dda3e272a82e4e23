"""Where the bf16 backward kernels' time goes, on one NVIDIA card.

  python3 bwd_ablation.py

Builds timing-only variants of waveglow_tpu_torch/csrc/wn_layer_bwd.cu
(under waveglow_tpu_torch/build/ablation/, one nvcc per variant, started
together) and times each of the four kernels at B=12, T=2,000, d=1
(torch.profiler, the mean of 10 calls):
  base     the kernels as they are (their gradients against
           wn_layer_backward, relative to each gradient's max |value|);
  no_mma   every mma.sync replaced by one integer op on its operands (the
           ldmatrix traffic, the rings, the staging and the epilogues stay);
then the base build with the weights kernel's rows split into 1 to 4
ranges per batch row. The variants' gradients are wrong by design: only
their times mean anything.
"""

import ctypes
import json
import re
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from waveglow_tpu_torch.kernels import wn_layer as kl

OUT = kl.BUILD_DIR / "ablation"


def variants(src: str) -> dict:
  mma = src[src.index('  asm volatile(\n      "mma.sync'):
            src.index("__device__ __forceinline__ uint32_t pack_bf16")]
  return {"base": src,
          "no_mma": src.replace(
              mma, "  d[0] += __int_as_float(a[0] ^ a[3] ^ b0 ^ b1);\n}\n\n")}


def build(sources: dict) -> dict:
  OUT.mkdir(parents=True, exist_ok=True)
  procs = {}
  for name, text in sources.items():
    (OUT / f"{name}.cu").write_text(text)
    procs[name] = subprocess.Popen(
        [kl._nvcc(), *kl.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"),
         str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
  libs = {}
  for name, proc in procs.items():
    log = proc.communicate()[0]
    if proc.returncode:
      raise SystemExit(f"nvcc failed for {name}:\n{log}")
    fn = ctypes.CDLL(str(OUT / f"{name}.so")).wn_layer_backward_bf16
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    libs[name] = fn
  return libs


def call(fn, saved, cot, dilation, n_splits, split_rows):
  """The launch wn_layer_backward_fused makes, with the split as given."""
  x, cond, w_in, b_in, w_rs, b_rs = saved
  batch, t, c = x.shape
  n_rs = w_rs.numel() // c

  def empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=x.device)

  outs = [empty(a.shape, a.dtype) for a in saved]
  scratch = [empty((batch * t, c), torch.bfloat16),
             empty((batch * t, c), torch.bfloat16),
             empty((batch * t, n_rs), torch.bfloat16),
             empty((batch * -(-t // 64), 2 * c + n_rs), torch.float32),
             empty((batch * n_splits, 6 * c * c + c * n_rs), torch.float32)]
  err = fn(*[a.data_ptr() for a in saved[:5]], cot[0].data_ptr(),
           cot[1].data_ptr(), None, *[o.data_ptr() for o in outs],
           *[s.data_ptr() for s in scratch], batch, t, c, dilation,
           int(n_rs == c), n_splits, split_rows,
           torch.cuda.current_stream().cuda_stream)
  if err:
    raise SystemExit(f"launch failed: cudaError {err}")
  return outs


def kernel_ms(run, reps=10) -> dict:
  run()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      run()
    torch.cuda.synchronize()
  out = {}
  for name, ms in cs.device_kernels(prof):
    kernel = re.search(r"wn_bwd_(rows|dx|weights|reduce)_kernel", name)
    if kernel:
      out[kernel.group(1)] = out.get(kernel.group(1), 0.0) + ms / reps
  return out


def main() -> None:
  device = cs.phase_device()
  libs = build(variants(kl.SOURCES[1].read_text()))
  args, cot = cs.trainable_inputs(False, torch.bfloat16, 5)
  saved = tuple(a.detach() for a in args)
  ref = kl.wn_layer_backward(saved, *cot, 1, None, torch.bfloat16)
  rows = [(name, fn, 1, kl.SPLIT_ROWS) for name, fn in libs.items()]
  rows += [("base", libs["base"], n, 32 * -(-cs.T_TRAIN // (32 * n)))
           for n in (2, 3, 4)]
  for name, fn, n_splits, split_rows in rows:
    def run():
      return call(fn, saved, cot, 1, n_splits, split_rows)
    rec = {"variant": name, "splits": n_splits, "split_rows": split_rows,
           "ms": cs.cuda_ms(run), "kernels_ms": kernel_ms(run)}
    if name == "base":
      rec["err_of_scale"] = [
          ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
          for g, r in zip(run(), ref)]
    print(json.dumps(rec), flush=True)
  print(device["nvidia_smi"])


if __name__ == "__main__":
  main()
