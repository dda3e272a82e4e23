"""The host-side plan of a model rank's share at every shape, on the CPU (no
library is loaded): the dispatch rule between the specialised rank kernels
and the shape-generic ones, the generic forward's passes, grid, tiles and
scratch at a rank's gate width C' (csrc/wn_layer_any.cu in partial mode),
the generic backward's kernels, output tiles and scratch there
(csrc/wn_layer_bwd_any.cu), each the whole layer's at C' = C; the C entry
points' parameter lists against the ctypes signatures the wrappers bind;
and the wrappers' CPU route. The card runs the kernels themselves
(``test_torch_gpu.py``, ``-k shard_any``).
"""

import re

import numpy as np
import pytest
import torch

from waveglow_tpu_torch.kernels import wn_layer as kl

SMS = 132  # an H100 SXM
# (C, C'): a rank at each generic shape chip_smoke.py phase 18 runs, odd
# and under-64 widths among them, and the whole layer (C' = C).
RANKS = ((64, 32), (50, 25), (384, 192), (256, 128), (128, 64), (384, 128),
         (384, 48), (256, 64), (256, 16), (1280, 640), (30, 15), (30, 10))


@pytest.mark.parametrize("c,cp,k,want", [
    (256, 128, 3, True), (128, 16, 3, True), (512, 64, 3, True),
    (256, 16, 3, False), (256, 128, 5, False), (384, 192, 3, False),
    (384, 48, 3, False), (50, 25, 3, False), (256, 128, 1, False),
    (512, 512, 3, False)])
def test_the_dispatch_rule(c, cp, k, want):
  """The specialised rank kernels run at K = 3 and a built (C, C') pair;
  every other shape (another K, a model count outside SHARD_MODELS, a
  width outside the built set) takes the generic ones."""
  assert kl.shard_specialised(c, cp, k) is want
  assert want == (k == 3 and (c, cp) in kl.shard_pairs())


@pytest.mark.parametrize("c,cp", RANKS)
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_kernels_and_scratch_of_a_rank(c, cp, bf16):
  """A rank pads its C' gate channels to Gp and its C input and output
  channels to Cp: the acts [R, Gp]; x_p [R, Cp] in bf16 or where C % 64;
  the weights padded ([K*Cp, 2Gp], [Gp, n_rsp]) where C or C' is not a
  multiple of 64, and the prep kernel launched for them; at C' = C the
  whole layer's plan."""
  batch, t, k = 2, 300, 5
  cpad, gp = kl.any_cp(c), kl.any_cp(cp)
  size = 2 if bf16 else 4
  pad_w = c % 64 or cp % 64
  for last in (False, True):
    plan = kl.any_scratch(batch, t, c, k, last, bf16, cp)
    n_rsp = cpad if last else 2 * cpad
    want = {"acts": batch * t * gp * size}
    if bf16 or c % 64:
      want["x_p"] = batch * t * cpad * size
    if pad_w:
      want.update(w_in_p=k * cpad * 2 * gp * size, w_rs_p=gp * n_rsp * size)
    assert plan["sizes"] == want
    assert all(off % 256 == 0 for off in plan["offsets"].values())
    assert plan["bytes"] >= sum(want.values())
  kernels = kl.any_kernels(bf16, c, cp)
  assert ("prep" in kernels) == bool(bf16 or pad_w)
  assert kl.any_kernels(bf16, c, c) == kl.any_kernels(bf16, c)
  assert kl.any_scratch(batch, t, c, k, False, bf16, c) == kl.any_scratch(
      batch, t, c, k, False, bf16)


@pytest.mark.parametrize("c,cp", RANKS)
def test_bf16_units_of_a_rank(c, cp):
  """The bf16 gate kernel walks units of (128 rows, a pass of 128 of the Gp
  gate channels), the res/skip kernel units of (128 rows, a pass of the Cp
  output channels); each one wave of at most SMS blocks."""
  grid = kl.any_grid(1, 26_432, c, True, SMS, cp)
  tiles = -(-26_432 // kl.ANY_TILE_ROWS)
  assert grid["gate_passes"] == -(-kl.any_cp(cp) // kl.ANY_PASS)
  assert grid["passes"] == -(-kl.any_cp(c) // kl.ANY_PASS)
  assert grid["gate_units"] == tiles * grid["gate_passes"]
  assert grid["units"] == tiles * grid["passes"]
  assert grid["gate_blocks"] == min(grid["gate_units"], SMS)
  assert grid["blocks"] == min(grid["units"], SMS)
  whole = kl.any_grid(1, 26_432, c, True, SMS)
  assert {k: v for k, v in kl.any_grid(1, 26_432, c, True, SMS, c).items()
          if k in whole} == whole


@pytest.mark.parametrize("c,cp", RANKS)
@pytest.mark.parametrize("rows", [1, 17, 26_432, 12 * 2_000])
def test_f32_tiles_of_a_rank(c, cp, rows):
  """The f32 kernel at a rank: tiles of 192 rows where Gp = 64 (its
  res/skip passes of 64 output channels, Cp / 64 of them), else 96; its
  passes one after another (no rest tile: the rank's instance has none);
  every row of a block in one tile."""
  grid = kl.any_grid(1, rows, c, False, SMS, cp)
  per = grid["rows_per_block"]
  tiles = kl.any_f32_tiles(per, c, cp)
  two = kl.any_cp(cp) == 64
  assert kl.any_f32_two(c, cp) is two
  size = 192 if two else 96
  assert [r for r, _, _ in tiles] == list(range(0, per, size))
  assert sum(n for _, n, _ in tiles) == per
  if two:
    assert grid["passes"] == kl.any_cp(c) // 64
    assert grid["gate_passes"] == 1
  assert all(p == 1 for _, _, p in tiles)
  assert kl.any_f32_two(c) is (kl.any_cp(c) == 64)


@pytest.mark.parametrize("c,cp", RANKS)
@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_backward_tiles_and_scratch_of_a_rank(c, cp, k):
  """The rank's backward: the weights kernel's output tiles (dw_in_p [K*Cp,
  2Gp] and dw_rs_p^T [n_rsp, Gp] in tiles of 128 x N, N the widest of 256,
  192, 128, 64 dividing Gp), the pad kernel where C or C' is not a
  multiple of 64, and the scratch: the workspace B * n_splits * (K*Cp*2Gp
  + Gp*n_rsp) * 4 bytes, dg_p only where C' % 64."""
  cpad, gp = kl.any_cp(c), kl.any_cp(cp)
  n = kl.any_bwd_n_tile(cp)
  assert gp % n == 0
  for last in (False, True):
    n_rsp = cpad if last else 2 * cpad
    tiles = kl.any_bwd_weight_tiles(c, k, last, cp)
    assert tiles == (-(-k * cpad // 128) * (2 * gp // n)
                     + -(-n_rsp // 128) * (gp // n))
    assert kl.any_bwd_weight_tiles(c, k, last, c) == kl.any_bwd_weight_tiles(
        c, k, last)
    batch, t = 12, 2_000
    split_batches, n_splits_t, _ = kl.any_bwd_splits(batch, t, tiles, SMS)
    ranges = kl.any_bwd_ranges(batch, split_batches, n_splits_t)
    plan = kl.any_bwd_scratch(batch, t, c, k, last, ranges, cp)
    sizes = plan["sizes"]
    assert sizes["ws"] == ranges * (k * cpad * 2 * gp + gp * n_rsp) * 4
    assert sizes["acts_p"] == batch * t * gp * 2
    assert sizes["x_p"] == batch * t * cpad * 2
    assert sizes["g_p"] == batch * t * n_rsp * 2
    assert ("w_in_p" in sizes) == bool(c % 64 or cp % 64)
    assert ("dg_p" in sizes) == bool(cp % 64)
    assert kl.any_bwd_scratch(batch, t, c, k, last, ranges, c) == (
        kl.any_bwd_scratch(batch, t, c, k, last, ranges))
  assert ("pad" in kl.any_bwd_kernels(c, cp)) == bool(c % 64 or cp % 64)


# -- the C interface against the ctypes bindings -------------------------------

def c_parameters(name):
  """The parameter list of the extern "C" function ``name`` in the
  sources, as ctypes kinds: "P" a pointer or stream, "I" an int, "IP" an
  int pointer."""
  text = "".join(src.read_text() for src in kl.SOURCES)
  m = re.search(r"\b(?:cudaError_t|int)\s+" + name + r"\s*\(([^)]*)\)\s*\{",
                text)
  assert m, name
  kinds = []
  for param in m.group(1).split(","):
    param = " ".join(param.split())
    if re.fullmatch(r"int \w+", param):
      kinds.append("I")
    elif re.fullmatch(r"int\* \w+", param):
      kinds.append("IP")
    else:
      assert "*" in param or param.startswith("cudaStream_t"), param
      kinds.append("P")
  return kinds


@pytest.mark.parametrize("name", sorted(kl.SIGNATURES))
def test_entry_points_match_their_bindings(name):
  """Every entry point the wrappers bind takes the parameters its ctypes
  signature declares, in order (a pointer passed as a 32-bit int would
  be cut)."""
  kind = {kl._P: "P", kl._I: "I", kl._IP: "IP"}
  assert c_parameters(name) == [kind[t] for t in kl.SIGNATURES[name]]


# -- the wrappers' CPU route ---------------------------------------------------

def test_the_generic_rank_wrappers_take_the_plain_version_on_the_cpu():
  """``wn_layer_shard_any`` (and the dispatching ``wn_layer_shard``) run
  ``wn_layer_shard_plain`` on CPU tensors and count nothing; the generic
  rank backward needs CUDA tensors and raises on CPU ones, launching
  nothing."""
  rng = np.random.default_rng(5)
  c, cp, t, k = 10, 5, 12, 5

  def rand(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

  args = (rand(2, t, c), rand(2, t, 2 * cp), rand(k * c, 2 * cp),
          rand(2 * cp), rand(cp, 2 * c))
  before = (kl.ANY_SHARD_LAUNCHES, kl.SHARD_LAUNCHES)
  want = kl.wn_layer_shard_plain(*args, 3)
  for fn in (kl.wn_layer_shard_any, kl.wn_layer_shard):
    assert torch.equal(fn(*args, 3), want)
  assert (kl.ANY_SHARD_LAUNCHES, kl.SHARD_LAUNCHES) == before
  before = kl.ANY_SHARD_BWD_LAUNCHES
  with pytest.raises(ValueError, match="CUDA"):
    kl.wn_layer_shard_backward_any(args, torch.zeros(2, t, 2 * c), 3)
  assert kl.ANY_SHARD_BWD_LAUNCHES == before
