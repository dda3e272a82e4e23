"""The ablation scripts' edits still find their text in the CUDA sources
they edit, and each variant differs from the source it was made from
(the scripts build and run only on the card)."""

import importlib

import pytest

import ablation
from waveglow_tpu_torch.kernels import wn_layer as kl

SCRIPTS = {"fwd_ablation": "wn_layer.cu", "bwd_ablation": "wn_layer_bwd.cu",
           "sbwd_ablation": "wn_layer_bwd.cu",
           "fwd_f32_ablation": "wn_layer.cu"}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_edits_apply_to_the_source(script):
  edits = importlib.import_module(script).EDITS
  src = (kl.CSRC / SCRIPTS[script]).read_text()
  out = ablation.variants(src, edits)
  assert out["base"] == src
  assert set(out) == {"base", *edits}
  for name in edits:
    assert out[name] != src, name


def test_edit_stays_in_its_frame():
  src = "void f() {\n  g(1);\n}\nvoid h() {\n  g(1);\n}\n"
  got = ablation.edit(src, "g(1);", "g(2);", "void h()")
  assert got == "void f() {\n  g(1);\n}\nvoid h() {\n  g(2);\n}\n"
  assert ablation.edit(src, "g(1);", "g(2);", None).count("g(2);") == 2


def test_edit_refuses_text_that_is_not_there():
  with pytest.raises(SystemExit, match="not in the source"):
    ablation.edit("void f() {\n}\n", "g(1);", "g(2);", "void f()")


def test_fwd_compare_checksum_sees_one_bit():
  """fwd_compare.py tells two trees' outputs apart by a checksum of their
  bits: one flipped bit anywhere changes it, a copy does not."""
  import torch

  import fwd_compare
  out = torch.randn(3, 50, 8, generator=torch.Generator().manual_seed(0))
  same = fwd_compare.checksum(out.clone())
  assert fwd_compare.checksum(out) == same
  for at in (0, 517, out.numel() - 1):
    flipped = out.clone().reshape(-1)
    flipped.view(torch.int32)[at] ^= 1
    assert fwd_compare.checksum(flipped.reshape(out.shape)) != same


@pytest.mark.parametrize("width", [128, 256, 512])
def test_f32_ablation_builds_one_width(width):
  """fwd_f32_ablation.py's variants keep one width in the launchers'
  dispatch (the ring variants need only fit C = 512), and its edits still
  apply to that source."""
  import fwd_f32_ablation
  src = (kl.CSRC / "wn_layer.cu").read_text()
  one = fwd_f32_ablation.only_width(src, width)
  for other in kl.kernel_widths():
    assert (f"return dispatch_width<{other}>(" in one) == (other == width)
    assert (f"f32_slots_for<{other}>(last" in one) == (other == width)
  out = ablation.variants(one, fwd_f32_ablation.EDITS)
  assert all(out[name] != one for name in fwd_f32_ablation.EDITS)
