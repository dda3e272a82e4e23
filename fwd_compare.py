"""The bf16 WN-layer forward at C = 128 and 256 of two trees of this repo,
on one NVIDIA card: their outputs bit for bit and their call times
alternated.

  python3 fwd_compare.py OTHER_TREE [--out chiprun_out/fwd_compare.json]

OTHER_TREE is an unpacked checkout of another commit, for example
`git archive <commit> | tar -x -C build/parent`. Both trees' kernels are
built first, in two processes started together. Then four runs, each in a
process of its own, in the order other, this, this, other, call each
tree's kl.wn_layer_fused on the same inputs, made on the card from fixed
seeds: chip_smoke.py phase 3's bf16 cases (B=1 and 8, T=26,432, the eight
layers of a flow, d = 1 to 128, and the last layer, a per-row valid_t and
skip_acc) at each width. Each run records a checksum of each case's
output bits and times, by CUDA events (20 calls after 3 warm-ups), the
cases phase 3 times (d=1, d=128, the last layer). The last line is one
JSON object: for each case whether every run gave the same bits, and each
run's ms.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTHS = (128, 256)
BATCHES = (1, 8)
T = 26_432
N_LAYERS = 8
TIMED = (1, 128)


def checksum(out) -> list:
  """Two sums of a tensor's bits as int64 (plain and position-weighted):
  any change of a bit changes them but for a chance cancellation."""
  import torch
  bits = out.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
  weight = torch.arange(bits.numel(), device=bits.device) % 65_521 + 1
  return [int(bits.sum()), int((bits * weight).sum())]


def worker(tree: str, build_only: bool) -> dict:
  sys.path.insert(0, tree)
  import torch
  from waveglow_tpu_torch.kernels import wn_layer as kl
  assert Path(kl.__file__).resolve().is_relative_to(Path(tree).resolve())
  kl.build_library()
  if build_only:
    return {}
  bf = torch.bfloat16
  out = {}
  for width in WIDTHS:
    for batch in BATCHES:
      g = torch.Generator(device="cuda").manual_seed(1000 * width + batch)

      def rand(*shape, scale):
        return torch.randn(*shape, generator=g, device="cuda") * scale

      valid = torch.tensor([T - 1000 * (i % 2) for i in range(batch)],
                           dtype=torch.int32, device="cuda")
      keep = torch.arange(T, device="cuda")[None, :, None] < valid[:, None,
                                                                   None]
      x = rand(batch, T, width, scale=0.5) * keep
      cond = rand(batch, T, 2, width, scale=0.5).to(bf)
      w_in = rand(3, width, 2 * width, scale=(3 * width) ** -0.5).to(bf)
      b_in = rand(2 * width, scale=0.1)
      w_rs = rand(width, 2 * width, scale=width ** -0.5).to(bf)
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
                                         compute_dtype=bf)
        rec = {"checksum": checksum(x_next) + checksum(skip)}
        if dilation in TIMED or last:
          buf = acc.clone()

          def call():
            kl.wn_layer_fused(*args, valid_t=valid, skip_acc=buf,
                              compute_dtype=bf)

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
          rec["ms"] = start.elapsed_time(end) / 20
        out[f"C={width},B={batch},d={dilation}{',last' if last else ''}"] = rec
      del x, cond, acc
      torch.cuda.empty_cache()
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
  args = parser.parse_args()
  if args.worker:
    print(json.dumps(worker(args.worker, args.build_only)))
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
    proc = run(trees[name])
    text = proc.communicate()[0]
    if proc.returncode:
      raise SystemExit(f"the run of {name} failed")
    runs.append((name, json.loads(text.strip().splitlines()[-1])))
    print(name, "done", flush=True)
  cases = {}
  for case in runs[0][1]:
    sums = {tuple(r[case]["checksum"]) for _, r in runs}
    cases[case] = {"same_bits": len(sums) == 1,
                   "ms": [[name, r[case]["ms"]] for name, r in runs
                          if "ms" in r[case]]}
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
