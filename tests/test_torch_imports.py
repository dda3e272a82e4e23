"""The port stands alone: no module of ``waveglow_tpu_torch`` and neither
``chip_smoke.py`` nor an ablation script imports jax or anything of the
JAX package, nor a package that the card's machine does not have (it has
torch, numpy and scipy, not matplotlib, pandas, Pillow or tensorstore).
``torch.utils.tensorboard`` stays allowed: the training loop imports it
lazily and raises a clear error without it."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "waveglow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bwd_ablation.py",
    ROOT / "sbwd_ablation.py", ROOT / "fwd_ablation.py",
    ROOT / "ablation.py", ROOT / "fwd_compare.py"]


def imported_modules(path: Path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module or ""
      for alias in node.names:  # `from waveglow_tpu import x` names a module
        yield f"{node.module}.{alias.name}"


# not installed where the port runs
MISSING_ON_THE_CARD = ("matplotlib", "pandas", "PIL", "imageio", "skimage",
                       "librosa", "tensorstore", "orbax")


def forbidden(name: str) -> bool:
  top = name.split(".")[0]
  return top in ("jax", "jaxlib", "flax", "optax", "waveglow_tpu")


def missing_on_the_card(name: str) -> bool:
  return name.split(".")[0] in MISSING_ON_THE_CARD


def test_sources_found():
  assert len(SOURCES) > 10
  for name in ("wn_layer.cu", "wn_layer_bwd.cu"):
    assert (ROOT / "waveglow_tpu_torch" / "csrc" / name).is_file()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
  bad = sorted({m for m in imported_modules(path) if forbidden(m)})
  assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
  probe = tmp_path / "probe.py"
  probe.write_text("import os\nfrom waveglow_tpu.hparams import HParams\n"
                   "def f():\n  import jax.numpy as jnp\n")
  assert sorted(m for m in imported_modules(probe) if forbidden(m)) == [
      "jax.numpy", "waveglow_tpu.hparams", "waveglow_tpu.hparams.HParams"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_a_package_the_card_lacks(path):
  bad = sorted({m for m in imported_modules(path) if missing_on_the_card(m)})
  assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_package_the_card_lacks(tmp_path):
  probe = tmp_path / "probe.py"
  probe.write_text("import numpy\nfrom matplotlib import pyplot as plt\n"
                   "def f():\n  import pandas as pd\n  from PIL import Image\n"
                   "  from torch.utils.tensorboard import SummaryWriter\n")
  assert sorted(m for m in imported_modules(probe)
                if missing_on_the_card(m)) == [
      "PIL", "PIL.Image", "matplotlib", "matplotlib.pyplot", "pandas"]


def test_native_loader_is_scanned_and_its_own():
  """The C++ loader's module is among the scanned sources, and the source
  it builds is the port's own file under ``waveglow_tpu_torch/native/``
  (not the JAX package's, not a link to it), built into the port's
  gitignored build directory."""
  from waveglow_tpu_torch import native
  port_native = ROOT / "waveglow_tpu_torch" / "native"
  assert port_native / "__init__.py" in SOURCES
  assert native.SOURCE == port_native / "wavloader.cpp"
  assert native.SOURCE.is_file() and not native.SOURCE.is_symlink()
  text = native.SOURCE.read_text()
  for name in ("wav_info", "wav_read_f32", "batch_segments"):
    assert f" {name}(" in text, name
  assert native.BUILD_DIR == ROOT / "waveglow_tpu_torch" / "build"
  assert "build/" in (ROOT / ".gitignore").read_text().split()


BUILT_SOURCES = sorted(
    path.relative_to(ROOT / "waveglow_tpu_torch").as_posix()
    for path in (ROOT / "waveglow_tpu_torch").rglob("*")
    if path.suffix in (".cu", ".cuh", ".cpp") and "build" not in path.parts)


def test_every_built_source_is_found():
  from waveglow_tpu_torch import native
  assert native.SOURCE.relative_to(ROOT / "waveglow_tpu_torch").as_posix() \
      in BUILT_SOURCES
  assert "csrc/wn_layer.cu" in BUILT_SOURCES


@pytest.mark.parametrize("source", BUILT_SOURCES)
def test_built_source_ships_in_the_package(source):
  """Every source the port compiles at first use (the CUDA kernels, the
  C++ loader) matches a glob of the package data, so that an installed
  package can build it."""
  import fnmatch
  import tomllib
  data = tomllib.loads((ROOT / "pyproject.toml").read_text())
  globs = data["tool"]["setuptools"]["package-data"]["waveglow_tpu_torch"]
  assert any(fnmatch.fnmatch(source, glob) for glob in globs), (source, globs)
