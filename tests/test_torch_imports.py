"""The port stands alone: no module of ``waveglow_tpu_torch`` and not
``chip_smoke.py`` imports jax or anything of the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "waveglow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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


def forbidden(name: str) -> bool:
  top = name.split(".")[0]
  return top in ("jax", "jaxlib", "flax", "optax", "waveglow_tpu")


def test_sources_found():
  assert len(SOURCES) > 10
  assert (ROOT / "waveglow_tpu_torch" / "csrc" / "wn_layer.cu").is_file()


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
