"""The WN-layer forward kernels, or the training step, of two trees of
this repo, on one NVIDIA card: their outputs bit for bit and their times
alternated.

  python3 fwd_compare.py OTHER_TREE [--train] [--out chiprun_out/fwd_compare.json]

OTHER_TREE is an unpacked checkout of another commit, for example
`git archive <commit> | tar -x -C build/parent`. Both trees' kernels are
built first, in two processes started together. Then four runs, each in a
process of its own, in the order other, this, this, other, call each
tree's kernels on the same inputs, made on the card from fixed seeds:
chip_smoke.py phase 3's bf16 cases at C = 128 and 256 and its f32 cases
at C = 256 and 512 (B=1 and 8, T=26,432, the eight layers of a flow, d =
1 to 128, and the last layer, a per-row valid_t and skip_acc;
kl.wn_layer_fused),
and rank 0's bf16 share of the C = 512 layer at C' = 256, 128 and 64
(B=1, d = 1, 128 and the last layer; kl.wn_layer_shard). Each run records
a checksum of each case's output bits and times, by CUDA events (20 calls
after 3 warm-ups), the cases phase 3 times (d=1, d=128, the last layer),
and beside them the library's time for the same function (chip_smoke's
yardstick: cuDNN conv1d, the gate, a cuBLAS matmul; TF32 off), which
both trees compute alike. With --train a run is instead chip_smoke.py
phase 6 of its tree (``phase_train``: train() at 12 x 8 x 256, batch 12,
segment 16,000, seed 1234) in f32 and in bf16; each mode's case records
the run's losses (the bits compared) and its median step and median
steady step on one batch in ms (host clock, ending in a synchronise). The
last line is one JSON object: for each case whether every run gave the
same bits, and each run's times.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (mode, width, batches): the layer's cases
LAYERS = (("bf16", 128, (1, 8)), ("bf16", 256, (1, 8)), ("f32", 256, (1, 8)),
          ("f32", 512, (1, 8)))
# the C = 512 bf16 rank's C'
RANKS = (256, 128, 64)
T = 26_432
N_LAYERS = 8
TIMED = (1, 128)
TRAIN_SEED = 1234


def checksum(out) -> list:
  """Two sums of a tensor's bits as int64 (plain and position-weighted):
  any change of a bit changes them but for a chance cancellation."""
  import torch
  bits = out.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
  weight = torch.arange(bits.numel(), device=bits.device) % 65_521 + 1
  return [int(bits.sum()), int((bits * weight).sum())]


def device_ms(call) -> float:
  import torch
  for _ in range(3):
    call()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(20):
    call()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / 20


def library(x, cond, w_in, b_in, w_rs, dilation, dtype):
  """The library's yardstick for a layer's (or a rank's) products and gate:
  cuDNN conv1d, the gate, a cuBLAS matmul (chip_smoke.library_layer's
  arithmetic), on inputs laid out as those calls want them."""
  import torch
  import torch.nn.functional as F
  c = w_in.shape[-1] // 2
  x_cf = x.to(dtype).transpose(1, 2).contiguous()
  w_conv = w_in.reshape(3, -1, 2 * c).permute(2, 1, 0).contiguous()
  cond = cond.reshape(*x.shape[:2], 2 * c)
  b_lib = b_in.to(dtype)

  def call():
    pre = F.conv1d(x_cf, w_conv, b_lib, padding=dilation, dilation=dilation)
    gates = pre.transpose(1, 2) + cond
    acts = torch.tanh(gates[..., :c]) * torch.sigmoid(gates[..., c:])
    return torch.matmul(acts.to(dtype), w_rs)

  return device_ms(call)


def worker(tree: str, build_only: bool) -> dict:
  sys.path.insert(0, tree)
  import torch
  from waveglow_tpu_torch.kernels import wn_layer as kl
  assert Path(kl.__file__).resolve().is_relative_to(Path(tree).resolve())
  kl.build_library()
  if build_only:
    return {}
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  out = {}
  for mode, width, batches in LAYERS:
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    cdt = torch.bfloat16 if mode == "bf16" else None
    for batch in batches:
      g = torch.Generator(device="cuda").manual_seed(1000 * width + batch)

      def rand(*shape, scale):
        return torch.randn(*shape, generator=g, device="cuda") * scale

      valid = torch.tensor([T - 1000 * (i % 2) for i in range(batch)],
                           dtype=torch.int32, device="cuda")
      keep = torch.arange(T, device="cuda")[None, :, None] < valid[:, None,
                                                                   None]
      x = rand(batch, T, width, scale=0.5) * keep
      cond = rand(batch, T, 2, width, scale=0.5).to(dtype)
      w_in = rand(3, width, 2 * width, scale=(3 * width) ** -0.5).to(dtype)
      b_in = rand(2 * width, scale=0.1)
      w_rs = rand(width, 2 * width, scale=width ** -0.5).to(dtype)
      b_rs = rand(2 * width, scale=0.1)
      acc = rand(batch, T, width, scale=1.0)
      for i in range(N_LAYERS + 1):
        last = i == N_LAYERS
        dilation = 2 ** min(i, N_LAYERS - 1)
        rs = (w_rs[:, :width].contiguous(), b_rs[:width].contiguous()) \
            if last else (w_rs, b_rs)
        args = (x, cond, w_in, b_in, *rs, dilation)
        x_next, skip = kl.wn_layer_fused(*args, valid_t=valid,
                                         skip_acc=acc.clone(),
                                         compute_dtype=cdt)
        rec = {"checksum": checksum(x_next) + checksum(skip)}
        if dilation in TIMED or last:
          buf = acc.clone()
          rec["ms"] = device_ms(lambda: kl.wn_layer_fused(
              *args, valid_t=valid, skip_acc=buf, compute_dtype=cdt))
          rec["library_ms"] = library(x, cond, w_in, b_in, rs[0], dilation,
                                      dtype)
        key = (f"{'' if mode == 'bf16' else 'f32,'}C={width},B={batch},"
               f"d={dilation}{',last' if last else ''}")
        out[key] = rec
      del x, cond, acc
      torch.cuda.empty_cache()
  bf = torch.bfloat16
  g = torch.Generator(device="cuda").manual_seed(7)
  x = torch.randn(1, T, 512, generator=g, device="cuda") * 0.5
  cond = (torch.randn(1, T, 2, 512, generator=g, device="cuda") * 0.5).to(bf)
  w_in = (torch.randn(3, 512, 2, 512, generator=g, device="cuda")
          * 1536 ** -0.5).to(bf)
  b_in = torch.randn(2, 512, generator=g, device="cuda") * 0.1
  w_rs = (torch.randn(512, 1024, generator=g, device="cuda")
          * 512 ** -0.5).to(bf)
  for cp in RANKS:
    cols = slice(0, cp)
    for dilation, last in ((1, False), (128, False), (128, True)):
      sl = (cond[..., cols].reshape(1, T, 2 * cp).contiguous(),
            w_in[..., cols].reshape(3 * 512, 2 * cp).contiguous(),
            b_in[:, cols].reshape(-1).contiguous(),
            w_rs[cols, :512 if last else 1024].contiguous())
      got = kl.wn_layer_shard(x, *sl, dilation, compute_dtype=bf)
      out[f"shard,C=512,C'={cp},d={dilation}{',last' if last else ''}"] = {
          "checksum": checksum(got),
          "ms": device_ms(lambda: kl.wn_layer_shard(x, *sl, dilation,
                                                    compute_dtype=bf)),
          "library_ms": library(x, *sl, dilation, bf)}
  return out


def train_worker(tree: str) -> dict:
  sys.path.insert(0, tree)
  import tempfile
  import chip_smoke as smoke
  assert Path(smoke.__file__).resolve().is_relative_to(Path(tree).resolve())
  smoke.phase_device()
  out = {}
  for mode in smoke.MODES:
    with tempfile.TemporaryDirectory() as tmp:
      info = smoke.phase_train(mode, TRAIN_SEED, Path(tmp))
    out[f"train,{mode}"] = {
        "checksum": [float(loss).hex() for loss in info["losses"]],
        "ms": info["median_step_s"] * 1e3,
        "steady_ms": info["steady_median_step_s"] * 1e3}
  return out


def run(tree: Path, *flags) -> subprocess.Popen:
  return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                           "--worker", str(tree), *flags], cwd=tree,
                          stdout=subprocess.PIPE, text=True)


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("other", nargs="?")
  parser.add_argument("--out", default=str(ROOT / "chiprun_out"
                                            / "fwd_compare.json"))
  parser.add_argument("--worker")
  parser.add_argument("--build-only", action="store_true")
  parser.add_argument("--train", action="store_true")
  args = parser.parse_args()
  if args.worker:
    print(json.dumps(train_worker(args.worker)
                     if args.train and not args.build_only
                     else worker(args.worker, args.build_only)))
    return
  if not args.other:
    parser.error("OTHER_TREE is needed")
  other = Path(args.other).resolve()
  trees = {"other": other, "this": ROOT}
  builds = [run(tree, "--build-only") for tree in trees.values()]
  if any(proc.wait() for proc in builds):
    raise SystemExit("a tree's kernels did not build")
  runs = []
  for name in ("other", "this", "this", "other"):
    proc = run(trees[name], *(["--train"] if args.train else []))
    text = proc.communicate()[0]
    if proc.returncode:
      raise SystemExit(f"the run of {name} failed")
    runs.append((name, json.loads(text.strip().splitlines()[-1])))
    print(name, "done", flush=True)
  cases = {}
  for case in runs[0][1]:
    sums = {tuple(r[case]["checksum"]) for _, r in runs}
    cases[case] = {"same_bits": len(sums) == 1,
                   **{key: [[name, r[case][key]] for name, r in runs]
                      for key in ("ms", "steady_ms", "library_ms")
                      if key in runs[0][1][case]}}
  import torch
  result = {"device": subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=False).stdout.strip(),
            "torch": torch.__version__, "other": str(other),
            "order": [name for name, _ in runs],
            "all_same_bits": all(c["same_bits"] for c in cases.values()),
            "cases": cases}
  Path(args.out).parent.mkdir(parents=True, exist_ok=True)
  Path(args.out).write_text(json.dumps(result, indent=1))
  print(json.dumps(result))


if __name__ == "__main__":
  main()
