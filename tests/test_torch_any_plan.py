"""The host-side plan of the shape-generic forward (csrc/wn_layer_any.cu),
on the CPU (no library is loaded): the padded width Cp and the passes of
128 channels, the kernels a call launches, the bf16 gate and res/skip
kernels' units and one-wave grids (every row of every pass taken once,
the ragged last unit, units across batch rows), the f32 layer kernel's
one-wave grid (each block owns the acts rows it writes to the scratch and
reads back) and the one scratch allocation at C = 50, 384 and 1,280. The
card checks that the library picks these grids
(``test_torch_gpu.py``: ``test_any_schedule_is_the_host_grid``).
"""

import pytest

from waveglow_tpu_torch.kernels import wn_layer as kl

SMS = 132  # an H100 SXM
TILE = kl.ANY_TILE_ROWS


@pytest.mark.parametrize("c,cp,passes", [
    (2, 64, 1), (48, 64, 1), (50, 64, 1), (64, 64, 1), (66, 128, 1),
    (128, 128, 1), (200, 256, 2), (256, 256, 2), (384, 384, 3),
    (512, 512, 4), (704, 704, 6), (1280, 1280, 10)])
def test_padded_width_and_passes(c, cp, passes):
  """Cp is C rounded up to 64 channels; a pass holds 128 of them, the last
  one 64 where Cp is an odd number of 64s (C = 704: five passes of 128,
  one of 64)."""
  assert kl.any_cp(c) == cp and cp % kl.ANY_PAD == 0 and cp - c < 64
  assert kl.any_passes(c) == passes
  assert 0 < cp - (passes - 1) * kl.ANY_PASS <= kl.ANY_PASS


@pytest.mark.parametrize("c,bf16,want", [
    (256, True, ("prep", "gate", "layer")), (50, True, ("prep", "gate",
                                                        "layer")),
    (256, False, ("layer",)), (384, False, ("layer",)),
    (50, False, ("prep", "layer")), (200, False, ("prep", "layer"))])
def test_kernels_of_a_call(c, bf16, want):
  """bf16 rounds x once (prep), then the gate and res/skip kernels; f32
  runs its one layer kernel, after a prep only where C is not a multiple
  of 64 (its operands' padded layout is then not theirs)."""
  assert kl.any_kernels(bf16, c) == want
  assert set(want) <= set(kl.ANY_FWD_KERNELS)


@pytest.mark.parametrize("c", [256, 384])
def test_bf16_units_at_the_timed_shapes(c):
  """B=1, T=26,432: 207 tiles of 128 rows, Cp / 128 passes a tile, one
  wave of 132 blocks walking the units."""
  grid = kl.any_grid(1, 26_432, c, True, SMS)
  assert grid["tiles"] == 207 and grid["passes"] == c // 128
  assert grid["units"] == 207 * c // 128
  assert grid["blocks"] == SMS


@pytest.mark.parametrize("c", [50, 256, 384, 704, 1280])
@pytest.mark.parametrize("batch,t,slots", [
    (1, 26_432, SMS),           # phase 16's request: a last unit of 64 rows
    (1, 3 * TILE + 127, SMS),   # the last unit 127 rows
    (1, 3 * TILE, SMS),         # 128
    (1, 3 * TILE + 1, SMS),     # 1
    (3, 43, SMS),               # 129 rows: a unit across three sequences
    (8, 2_017, SMS),            # phase 16's B = 8
    (2, 129, 5)])               # fewer slots than units
def test_every_row_of_every_pass_once(batch, t, slots, c):
  """Over the blocks' units, the gate and the res/skip kernels each take
  every (row, pass) of the flat B*T rows exactly once, the ragged last
  unit too, and no block takes two units more than another."""
  grid = kl.any_grid(batch, t, c, True, slots)
  rows, passes = batch * t, grid["passes"]
  units, blocks = grid["units"], grid["blocks"]
  assert blocks == min(units, slots)
  taken = {}
  for block in range(blocks):
    for u in kl.block_units(units, blocks, block):
      tile, p = divmod(u, passes)
      for r in range(tile * TILE, min(tile * TILE + TILE, rows)):
        taken[(r, p)] = taken.get((r, p), 0) + 1
  assert taken == {(r, p): 1 for r in range(rows) for p in range(passes)}
  per_block = [len(kl.block_units(units, blocks, b)) for b in range(blocks)]
  assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("left", [127, 128, 1])
def test_ragged_last_unit(left):
  """B*T leaving ``left`` rows in the last unit: the tiles count it, and
  its rows are the last ``left`` of the flat rows."""
  rows = 5 * TILE + left if left < TILE else 6 * TILE
  grid = kl.any_grid(1, rows, 384, True, SMS)
  assert grid["tiles"] == 6 and grid["units"] == 18
  assert rows - (grid["tiles"] - 1) * TILE == left


@pytest.mark.parametrize("batch,t", [(3, 43), (2, 129), (8, 2_017)])
def test_units_across_batch_rows(batch, t):
  """A unit is 128 flat rows: where T is not a multiple of 128 a unit
  holds rows of two (or more) sequences, each row's taps its own."""
  grid = kl.any_grid(batch, t, 256, True, SMS)
  spanning = [tile for tile in range(grid["tiles"])
              if len({r // t for r in range(tile * TILE,
                                            min((tile + 1) * TILE,
                                                batch * t))}) > 1]
  assert spanning


@pytest.mark.parametrize("c", [50, 256, 384, 704])
@pytest.mark.parametrize("batch,t,slots", [
    (1, 26_432, SMS), (8, 26_432, SMS), (12, 2_000, SMS), (3, 43, SMS),
    (1, kl.ANY_F32_TILE_ROWS - 1, SMS), (1, kl.ANY_F32_TILE_ROWS + 1, 1),
    (3, 301, 7)])
def test_f32_blocks_own_their_rows(batch, t, slots, c):
  """The f32 grid is one wave of at most ``slots`` blocks, each a whole
  number of 16-row quanta in the tiles of any_f32_tiles; the blocks cover
  the flat B*T rows once, so the acts rows a block writes to the scratch
  and reads back are its own; no tile holds more than 96 rows, and only a
  block's last tile runs its passes at once."""
  grid = kl.any_grid(batch, t, c, False, slots)
  rows, per = batch * t, grid["rows_per_block"]
  assert per % kl.F32_ROW_QUANTUM == 0 and grid["blocks"] <= slots
  owner = {}
  for b in range(grid["blocks"]):
    start, end = b * per, min(rows, (b + 1) * per)
    assert start < end
    tiles = kl.any_f32_tiles(end - start, c)
    assert all(at_once == 1 for _, _, at_once in tiles[:-1])
    size = kl.ANY_F32_TILE_ROWS * (2 if kl.any_cp(c) == 64 else 1)
    for first, n, _ in tiles:
      assert 0 < n <= size
      for r in range(start + first, start + first + n):
        assert r not in owner
        owner[r] = b
  assert sorted(owner) == list(range(rows))


@pytest.mark.parametrize("n,c,want", [
    (208, 256, [(0, 96, 1), (96, 96, 1), (192, 16, 2)]),  # B=1's blocks
    (208, 200, [(0, 96, 1), (96, 96, 1), (192, 16, 2)]),
    (208, 384, [(0, 96, 1), (96, 96, 1), (192, 16, 1)]),  # 3 passes
    (208, 128, [(0, 96, 1), (96, 96, 1), (192, 16, 1)]),  # 1 pass
    (224, 256, [(0, 96, 1), (96, 96, 1), (192, 32, 1)]),
    (16, 256, [(0, 16, 2)]), (9, 256, [(0, 9, 2)]), (96, 256, [(0, 96, 1)]),
    (208, 64, [(0, 192, 1), (192, 16, 1)]),   # Cp = 64: 192-row tiles
    (208, 50, [(0, 192, 1), (192, 16, 1)]), (100, 48, [(0, 100, 1)])])
def test_f32_rest_tile(n, c, want):
  """A block's last tile of 16 rows or fewer runs both passes at once
  where there are two (C up to 256): pair j of the warps on pass j. At Cp
  = 64 the second column of warps takes 96 more rows: 192-row tiles."""
  assert kl.any_f32_tiles(n, c) == want


@pytest.mark.parametrize("c,passes,rest", [(256, 2, True), (384, 3, False),
                                           (64, 1, False)])
def test_f32_grid_at_the_timed_shapes(c, passes, rest):
  """B=1, T=26,432 on 132 SMs: 208 rows a block, 128 blocks, two 96-row
  tiles and one of 16, which runs both passes at once at C = 256; at C =
  64 one tile of 192 rows and one of 16."""
  grid = kl.any_grid(1, 26_432, c, False, SMS)
  assert grid["rows_per_block"] == 208 and grid["blocks"] == 128
  assert grid["tiles_per_block"] == (2 if c == 64 else 3)
  assert grid["passes"] == passes and grid["rest_tile"] is rest


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c,k,bf16", [
    (50, 3, True), (50, 5, False), (384, 3, True), (384, 3, False),
    (1280, 5, True), (1280, 1, True)])
def test_scratch_at_each_width(c, k, bf16, last):
  """One allocation, in the compute dtype's element: the acts [R, Cp]
  first; x_p [R, Cp] in bf16 (x rounded once) or where Cp != C (x padded);
  and there the padded weights w_in_p [K*Cp, 2Cp] and w_rs_p [Cp, n_rsp];
  each part 256-byte aligned, no gap past that."""
  batch, t = 2, 1_001
  rows, cp, size = batch * t, kl.any_cp(c), 2 if bf16 else 4
  pad = cp != c
  plan = kl.any_scratch(batch, t, c, k, last, bf16)
  want = {"acts": rows * cp * size}
  if bf16 or pad:
    want["x_p"] = rows * cp * size
  if pad:
    want["w_in_p"] = k * cp * 2 * cp * size
    want["w_rs_p"] = cp * (cp if last else 2 * cp) * size
  assert plan["sizes"] == want
  assert list(plan["offsets"]) == list(want)
  end = 0
  for name, n in want.items():
    assert plan["offsets"][name] == end and end % 256 == 0
    end += -(-n // 256) * 256
  assert plan["bytes"] == end


def test_scratch_sizes_at_the_named_widths():
  """At B=1, T=26,432: C = 50 pads to 64 (x and both weights padded, in
  either mode), C = 384 and 1,280 are multiples of 64 (bf16: the rounded x
  and the acts; f32 at 384: the acts alone)."""
  rows = 26_432
  assert kl.any_scratch(1, rows, 50, 3, False, True)["sizes"] == {
      "acts": rows * 64 * 2, "x_p": rows * 64 * 2,
      "w_in_p": 3 * 64 * 128 * 2, "w_rs_p": 64 * 128 * 2}
  assert kl.any_scratch(1, rows, 50, 3, True, False)["sizes"] == {
      "acts": rows * 64 * 4, "x_p": rows * 64 * 4,
      "w_in_p": 3 * 64 * 128 * 4, "w_rs_p": 64 * 64 * 4}
  assert kl.any_scratch(1, rows, 384, 3, False, True)["bytes"] == (
      2 * rows * 384 * 2)
  assert kl.any_scratch(1, rows, 384, 3, False, False)["bytes"] == (
      rows * 384 * 4)
  assert kl.any_scratch(1, rows, 1280, 5, False, True)["bytes"] == (
      2 * rows * 1280 * 2)
