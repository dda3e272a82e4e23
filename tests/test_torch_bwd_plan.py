"""The host-side plans of the redesigned bf16 kernels, on the CPU (no
library is loaded): the whole layer's backward (its weights kernel's row
split and its one scratch allocation) and the C = 512 forward's grid
(every row of every pass taken once by one block). ``chip_smoke.py``'s
checks of their kernels are in ``test_torch_chip_smoke.py``.
"""

import pytest

from waveglow_tpu_torch.kernels import wn_layer as kl

SMS = 132  # an H100 SXM

# The whole layer's weights kernel's output tiles at each width (non-last,
# last): dw_in's 128-row tiles of 3C x ceil(2C / 256), then dw_rs^T's n_rs /
# 128 x ceil(C / 256) (wn_layer_bwd_weight_tiles at C' = C).
WEIGHT_TILES = {128: (5, 4), 256: (16, 14), 512: (64, 56)}


def test_weight_tiles_cover_every_width():
  assert sorted(WEIGHT_TILES) == sorted(kl.kernel_widths())


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("batch", [12, 4])
@pytest.mark.parametrize("width", sorted(WEIGHT_TILES))
def test_splits_fill_whole_waves_at_the_training_shapes(width, batch, last):
  """At T = 2,000 (the training segment), B = 12 (phases 5, 6) and 4 (phase
  12's step), the whole layer's weights kernel gets at least one full wave
  of blocks and its last wave at least 80% full, whole 64-row chunks a
  range, the ranges covering T with no empty one; more ranges than one a
  batch row only where one would not fill the waves."""
  t, tiles = 2_000, WEIGHT_TILES[width][last]
  n_splits, split_rows = kl.bwd_splits(batch, t, tiles, SMS)
  assert split_rows % kl.BWD_CHUNK_ROWS == 0
  assert (n_splits - 1) * split_rows < t <= n_splits * split_rows
  blocks = tiles * batch * n_splits
  assert blocks >= SMS
  assert blocks / (-(-blocks // SMS) * SMS) >= 0.8
  if tiles * batch >= SMS and tiles * batch / (
      -(-tiles * batch // SMS) * SMS) >= 0.85:
    assert n_splits == 1


@pytest.mark.parametrize("width,batch,want", [
    (512, 12, (1, 2048)),   # 768 blocks, 97% of 6 waves
    (256, 12, (2, 1024)),   # 384 blocks, 97% of 3 waves (one range: 73%)
    (128, 12, (4, 512)),    # 240 blocks
    (512, 4, (1, 2048))])   # 256 blocks, 97% of 2 waves
def test_splits_at_each_width(width, batch, want):
  assert kl.bwd_splits(batch, 2_000, WEIGHT_TILES[width][0], SMS) == want


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("width", sorted(WEIGHT_TILES))
def test_scratch_is_one_aligned_allocation(width, last):
  """The whole layer's scratch: five disjoint, 256-byte aligned pieces, the
  column sums' rows holding the 2C dgates sums and the n_rs drs sums of a
  128-row tile (B = 12, T = 2,000: 16 tiles a batch row)."""
  batch, t, c = 12, 2_000, width
  n_rs = c if last else 2 * c
  splits = kl.bwd_splits(batch, t, WEIGHT_TILES[c][last], SMS)[0]
  plan = kl.bwd_scratch(batch, t, c, c, last, splits, 128)
  rows = batch * t
  assert plan["sizes"] == {
      "acts": rows * c * 2, "x_bf": rows * c * 2, "g_bf": rows * n_rs * 2,
      "part_bias": batch * 16 * (2 * c + n_rs) * 4,
      "ws": batch * splits * (3 * c * 2 * c + c * n_rs) * 4}
  spans = sorted((plan["offsets"][k], plan["offsets"][k] + n)
                 for k, n in plan["sizes"].items())
  assert all(lo % 256 == 0 for lo, _ in spans)
  assert all(a_end <= b_lo for (_, a_end), (b_lo, _) in zip(spans, spans[1:]))
  assert spans[-1][1] <= plan["bytes"] < spans[-1][1] + 256


def test_scratch_of_a_rank_holds_no_drs_sums():
  """A rank's column sums are its 2C' dgates sums alone: the layer's drs
  sums are its prep kernel's, which a rank does not run."""
  plan = kl.bwd_scratch(12, 2_000, 256, 128, False, 2, 128)
  assert plan["sizes"]["part_bias"] == 12 * 16 * 256 * 4


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("batch,t,slots", [
    (1, 26_432, 132),   # phase 3's request: 207 tiles, the last of 64 rows
    (8, 26_432, 132),   # B = 8: the rows of 8 sequences, one flat run
    (3, 65, 132),       # fewer units than slots: a block a unit
    (1, 17, 132),       # one short tile
    (2, 129, 7)])       # fewer slots than units: blocks walk several
def test_wide_grid_takes_every_row_of_every_pass_once(batch, t, slots, last):
  """The C = 512 gate and res/skip kernels: each is one wave of at most
  ``slots`` blocks; over the blocks' units, every (row, pass) of the flat
  B*T rows is taken exactly once, the ragged last tile too."""
  grid = kl.wide_grid(batch, t, last, slots)
  rows = batch * t
  assert grid["tiles"] == -(-rows // kl.WIDE_TILE_ROWS)
  for kernel, passes in kl.wide_passes(last).items():
    units, blocks = grid[f"{kernel}_units"], grid[f"{kernel}_blocks"]
    assert units == grid["tiles"] * passes
    assert blocks == min(units, slots)
    taken = {}
    for block in range(blocks):
      for u in kl.block_units(units, blocks, block):
        tile, p = divmod(u, passes)
        r0 = tile * kl.WIDE_TILE_ROWS
        for r in range(r0, min(r0 + kl.WIDE_TILE_ROWS, rows)):
          taken[(r, p)] = taken.get((r, p), 0) + 1
    assert taken == {(r, p): 1 for r in range(rows) for p in range(passes)}
    per_block = [len(kl.block_units(units, blocks, b)) for b in range(blocks)]
    assert max(per_block) - min(per_block) <= 1


def test_wide_passes_cover_the_columns():
  """The gate kernel's passes cover the C = 512 channels (128 each, tanh
  and sigmoid); the res/skip kernel's the n_rs columns (256 each)."""
  assert kl.wide_passes(False) == {"gate": 4, "rs": 4}
  assert kl.wide_passes(True) == {"gate": 4, "rs": 2}
