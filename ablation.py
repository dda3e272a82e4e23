"""What the ablation scripts (fwd_ablation.py, bwd_ablation.py,
sbwd_ablation.py) share: timing-only variants of one CUDA source of
waveglow_tpu_torch, made by text edits, built together and swapped in for
the package's own library.

An edit is (text, replacement, frame): the text is replaced wherever it
stands in the body of the function whose declaration starts with
``frame`` (the whole source when None), and must stand there at least
once.
"""

import subprocess

from waveglow_tpu_torch.kernels import wn_layer as kl


def edit(src: str, old: str, new: str, frame) -> str:
  start = src.index(frame) if frame else 0
  end = src.index("\n}\n", start) if frame else len(src)
  body = src[start:end]
  if old not in body:
    raise SystemExit(f"{old!r} is not in the source")
  return src[:start] + body.replace(old, new) + src[end:]


def variants(src: str, edits: dict) -> dict:
  """``src`` as "base" and each named list of edits applied to it."""
  out = {"base": src}
  for name, changes in edits.items():
    text = src
    for old, new, frame in changes:
      text = edit(text, old, new, frame)
    out[name] = text
  return out


def build(name: str, sources: dict) -> dict:
  """Each source built into a library under ``kl.BUILD_DIR / name``, one
  nvcc for each, all started together; the libraries loaded and bound as
  the package binds its own."""
  out = kl.BUILD_DIR / name
  out.mkdir(parents=True, exist_ok=True)
  procs = {}
  for variant, text in sources.items():
    (out / f"{variant}.cu").write_text(text)
    procs[variant] = subprocess.Popen(
        [kl._nvcc(), *kl.NVCC_FLAGS, "-I", str(kl.CSRC), "-shared", "-o",
         str(out / f"{variant}.so"), str(out / f"{variant}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  libs = {}
  for variant, proc in procs.items():
    log = proc.communicate()[0]
    if proc.returncode:
      raise SystemExit(f"nvcc failed for {variant}:\n{log}")
    libs[variant] = kl.load_library(out / f"{variant}.so")
  return libs


def use(lib) -> None:
  """Route the package's wrappers through ``lib`` (None: its own build)."""
  kl._LIB = lib
  kl._bwd_plan.cache_clear()
