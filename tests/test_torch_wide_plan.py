"""The host-side plans of the bf16 gate and res/skip designs and of the
f32 forward at C = 512, on the CPU (no library is loaded): the C = 512
bf16 layer's and each model rank's kernels at every width (their units
and one-wave grids, every row of every pass taken once, the ragged last
unit, their one scratch allocation, the library calls that read their
build and grid) and the f32 layer's one-wave grid, whose blocks each own
the rows of the global acts scratch they write and read back. The card checks that the library picks these
grids (``test_torch_gpu.py``: ``test_wide_schedule_is_the_host_grid``,
``test_f32_schedule_is_the_host_grid``).
"""

import pytest

from waveglow_tpu_torch.kernels import wn_layer as kl

SMS = 132  # an H100 SXM
C = kl.WIDE_C
# The gate widths of the C = 512 bf16 kernels: the layer's, then a rank's
# C' at model = 2, 4, 8.
GATES = (C,) + tuple(cp for c, cp in kl.shard_pairs() if c == C)
# (gate passes of min(cp, 128) channels, res/skip passes of 256 columns
# (non-last, last)) at each gate width
PASSES = {512: (4, (4, 2)), 256: (2, (4, 2)), 128: (1, (4, 2)),
          64: (1, (4, 2))}
TILE = kl.WIDE_TILE_ROWS


def test_gate_widths_are_the_layer_and_its_ranks():
  assert GATES == (512, 256, 128, 64) and set(PASSES) == set(GATES)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("cp", GATES)
def test_units_for_each_gate_width(cp, last):
  """A 128-row tile takes cp / min(cp, 128) gate passes and n_rs / 256
  res/skip passes: at B=1, T=26,432 (207 tiles) the units of each kernel,
  and the blocks of one wave on 132 SMs."""
  gate, rs = PASSES[cp][0], PASSES[cp][1][last]
  assert kl.wide_passes(last, cp) == {"gate": gate, "rs": rs}
  grid = kl.wide_grid(1, 26_432, last, SMS, cp)
  assert grid["tiles"] == 207
  assert grid["gate_units"] == 207 * gate
  assert grid["rs_units"] == 207 * rs
  assert grid["gate_blocks"] == min(207 * gate, SMS)
  assert grid["rs_blocks"] == SMS


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("cp", GATES)
@pytest.mark.parametrize("batch,t,slots", [
    (1, 26_432, SMS),           # phase 3's request: a last unit of 64 rows
    (1, 3 * TILE + 127, SMS),   # the last unit 127 rows
    (1, 3 * TILE, SMS),         # 128
    (1, 3 * TILE + 1, SMS),     # 1
    (3, 43, SMS),               # 129 rows: a unit across sequences, then 1
    (2, 129, 5)])               # fewer slots than units
def test_every_row_of_every_pass_once(batch, t, slots, last, cp):
  """Over the blocks' units, each kernel takes every (row, pass) of the
  flat B*T rows exactly once, the ragged last unit too, and no block takes
  two units more than another."""
  grid = kl.wide_grid(batch, t, last, slots, cp)
  rows = batch * t
  for kernel, passes in kl.wide_passes(last, cp).items():
    units, blocks = grid[f"{kernel}_units"], grid[f"{kernel}_blocks"]
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
  grid = kl.wide_grid(1, rows, False, SMS, 64)
  assert grid["tiles"] == 6
  last_tile = grid["tiles"] - 1
  assert rows - last_tile * TILE == left


@pytest.mark.parametrize("cp", GATES)
@pytest.mark.parametrize("batch,t", [(1, 26_432), (8, 26_432), (3, 43)])
def test_bf16_scratch_is_the_rounded_x_then_the_acts(batch, t, cp):
  """The bf16 scratch: x rounded [B*T, 512] then the acts [B*T, cp], bf16,
  the acts right after the rounded x (where the launcher puts them: x_bf +
  B*T*C), 256-byte aligned, one allocation."""
  plan = kl.wide_scratch(batch, t, cp, True)
  rows = batch * t
  assert plan["sizes"] == {"x_bf": rows * C * 2, "acts": rows * cp * 2}
  assert plan["offsets"] == {"x_bf": 0, "acts": rows * C * 2}
  assert plan["offsets"]["acts"] % 256 == 0
  assert rows * (C + cp) * 2 <= plan["bytes"] < rows * (C + cp) * 2 + 256


@pytest.mark.parametrize("batch,t", [(1, 26_432), (8, 26_432), (4, 2_000)])
def test_f32_scratch_is_the_acts(batch, t):
  """The f32 layer's scratch at C = 512: the acts [B*T, 512] f32 (54 MB at
  B=1, T=26,432, the only bytes the design adds to the layer's)."""
  plan = kl.wide_scratch(batch, t, C, False)
  assert plan["sizes"] == {"acts": batch * t * C * 4}
  assert plan["offsets"] == {"acts": 0}
  assert plan["bytes"] == batch * t * C * 4
  assert kl.wide_scratch(1, 26_432, C, False)["bytes"] == 54_132_736


@pytest.mark.parametrize("width", [256, C])
@pytest.mark.parametrize("batch,t,slots", [
    (1, 26_432, SMS), (8, 26_432, SMS), (4, 2_000, SMS), (12, 2_000, SMS),
    (2, 17, SMS), (1, kl.F32_TILE_ROWS - 1, SMS),
    (1, kl.F32_TILE_ROWS + 1, 1), (3, 301, 7), (1, 26_432 - 208 * 127, 1)])
def test_f32_blocks_own_their_rows(batch, t, slots, width):
  """The f32 grid is one wave of at most ``slots`` blocks, each a whole
  number of 16-row quanta; the tiles of the blocks (kl.f32_tiles) cover
  the flat B*T rows once, so at C = 512 the acts rows a block writes to
  the scratch and reads back are its own; no tile holds more rows than
  its layout's."""
  grid = kl.f32_grid(batch, t, slots)
  rows, per = batch * t, grid["rows_per_block"]
  assert per % kl.F32_ROW_QUANTUM == 0 and grid["blocks"] <= slots
  owner = {}
  for b in range(grid["blocks"]):
    start, end = b * per, min(rows, (b + 1) * per)
    assert start < end
    for first, n, size in kl.f32_tiles(end - start, width):
      assert 0 < n <= size
      for r in range(start + first, start + first + n):
        assert r not in owner
        owner[r] = b
  assert sorted(owner) == list(range(rows))


@pytest.mark.parametrize("n,want", [
    (208, [(0, 96, 96), (96, 96, 96), (192, 16, 16)]),   # B=1's blocks
    (1616, [(k * 96, 96, 96) for k in range(16)] + [(1536, 80, 96)]),
    (96, [(0, 96, 96)]),
    (144, [(0, 96, 96), (96, 16, 16), (112, 16, 16), (128, 16, 16)]),
    (145, [(0, 96, 96), (96, 49, 96)]), (16, [(0, 16, 16)]),
    (9, [(0, 9, 16)]), (50, [(0, 50, 96)])])
def test_f32_tiles_at_512_end_in_16_row_tiles(n, want):
  """At C = 512 a block walks 96-row tiles, the last one short, unless 48
  rows or fewer are left: the rest kernel takes those in 16-row tiles of
  all 512 channels (at B=1, T=26,432 each block's 16-row rest then runs
  eight warps)."""
  assert kl.f32_tiles(n, C) == want


def test_f32_tiles_below_512_are_48_rows():
  assert kl.f32_tiles(208, 256) == [(0, 48, 48), (48, 48, 48), (96, 48, 48),
                                    (144, 48, 48), (192, 16, 48)]
  assert kl.f32_tiles(47, 128) == [(0, 47, 48)]


# -- every model rank's bf16 share below C = 512: one rank kernel (the gate
# on the f32 x, then the res/skip product from w_rs_s held in its shared
# memory) where w_rs_s fits, else, at (256, 128), the gate kernel on the
# f32 x and the res/skip kernel ------------------------------------------

RANK_PAIRS = tuple(p for p in kl.shard_pairs() if p[0] < C)
# the kernels of each pair below C = 512 and their passes of a 128-row tile
# (non-last, last): the rank kernel's one (its res/skip passes run inside a
# unit); at (256, 128) the gate kernel's one pass of all C' channels and
# the res/skip kernel's n_rs / 256
RANK_PASSES = {(256, 128): {"gate": (1, 1), "rs": (2, 1)},
               (256, 64): {"rank": (1, 1)}, (256, 32): {"rank": (1, 1)},
               (128, 64): {"rank": (1, 1)}, (128, 32): {"rank": (1, 1)},
               (128, 16): {"rank": (1, 1)}}


def test_rank_pairs_below_512():
  """Every pair below C = 512 runs the one rank kernel but (256, 128),
  whose w_rs_s (128 x 512 bf16, 128 KB) does not fit beside the gate's 224
  KB; C = 512 rounds x, then runs the gate and res/skip kernels."""
  assert set(RANK_PAIRS) == set(RANK_PASSES)
  assert kl.wide_kernels(C) == ("round", "gate", "rs")
  for c, cp in RANK_PAIRS:
    assert kl.rank_fused(c, cp) == ((c, cp) != (256, 128))
    assert kl.wide_kernels(c, cp) == tuple(RANK_PASSES[(c, cp)])
  assert not any(kl.rank_fused(c, cp) for c, cp in kl.shard_pairs()
                 if c == C)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c,cp", RANK_PAIRS)
def test_units_at_each_rank_pair(c, cp, last):
  """The units of each kernel at B=1, T=26,432 (207 tiles of 128 rows) and
  the blocks of one wave on 132 SMs."""
  want = {k: passes[last] for k, passes in RANK_PASSES[(c, cp)].items()}
  assert kl.wide_passes(last, cp, c) == want
  grid = kl.wide_grid(1, 26_432, last, SMS, cp, c)
  assert grid["tiles"] == 207
  for kernel, passes in want.items():
    assert grid[f"{kernel}_units"] == 207 * passes
    assert grid[f"{kernel}_blocks"] == SMS


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c,cp", RANK_PAIRS)
@pytest.mark.parametrize("batch,t,slots", [
    (1, 26_432, SMS), (1, 3 * TILE + 127, SMS), (1, 3 * TILE, SMS),
    (1, 3 * TILE + 1, SMS), (3, 43, SMS), (8, 2_000, 7)])
def test_every_row_of_every_pass_once_at_each_rank_pair(batch, t, slots,
                                                        last, c, cp):
  """At every pair below C = 512, over the blocks' units, each kernel
  takes every (row, pass) of the flat B*T rows exactly once, the ragged
  last unit too, and no block takes two units more than another."""
  grid = kl.wide_grid(batch, t, last, slots, cp, c)
  rows = batch * t
  for kernel, passes in kl.wide_passes(last, cp, c).items():
    units, blocks = grid[f"{kernel}_units"], grid[f"{kernel}_blocks"]
    assert units == -(-rows // TILE) * passes and blocks == min(units, slots)
    taken = [0] * (rows * passes)
    for block in range(blocks):
      for u in kl.block_units(units, blocks, block):
        tile, p = divmod(u, passes)
        for r in range(tile * TILE, min(tile * TILE + TILE, rows)):
          taken[r * passes + p] += 1
    assert taken == [1] * (rows * passes)
    per_block = [len(kl.block_units(units, blocks, b)) for b in range(blocks)]
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("c,cp", RANK_PAIRS)
@pytest.mark.parametrize("batch,t", [(1, 26_432), (8, 26_432), (3, 43)])
def test_rank_scratch_is_the_acts(batch, t, c, cp):
  """Below C = 512 a rank's bf16 call reads the f32 x itself (no rounded
  copy of x); its scratch is nothing where the rank kernel keeps the acts
  in shared memory, and the acts [B*T, C'] alone at (256, 128)."""
  plan = kl.wide_scratch(batch, t, cp, True, c)
  rows = batch * t
  if kl.rank_fused(c, cp):
    assert plan == {"offsets": {}, "sizes": {}, "bytes": 0}
    return
  assert plan["sizes"] == {"acts": rows * cp * 2}
  assert plan["offsets"] == {"acts": 0}
  assert rows * cp * 2 <= plan["bytes"] < rows * cp * 2 + 256
  assert plan["bytes"] % 256 == 0


class _InfoLibrary:
  """Stands in for the built library (this sandbox has no nvcc): records
  the arguments of each info and schedule call and fills its outputs."""

  def __init__(self):
    self.calls = []

  def wn_layer_wide_kernel_info(self, *args):
    self.calls.append(("info", args[:4]))
    for i, ref in enumerate(args[4:]):
      ref._obj.value = 100 + i
    return 0

  def wn_layer_wide_schedule(self, *args):
    self.calls.append(("schedule", args[:5]))
    for i, ref in enumerate(args[5:]):
      ref._obj.value = (SMS, 207, SMS - 1, SMS - 2)[i]
    return 0


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_wide_kernel_info_asks_for_each_pair(monkeypatch, c, cp, last):
  """wide_kernel_info asks the library for each kernel a pair launches by
  its index in WIDE_KERNELS, and shard_kernel_info in bf16 for the one
  that ends a rank's call (the rank kernel, or the res/skip kernel);
  a kernel the pair does not launch, or a pair outside the built set,
  raises before any call."""
  lib = _InfoLibrary()
  monkeypatch.setattr(kl, "_library", lambda: lib)
  kernels = kl.wide_kernels(c, cp)
  for kernel in kernels:
    info = kl.wide_kernel_info(kernel, last, cp, c)
    assert lib.calls[-1] == ("info", (c, kl.WIDE_KERNELS.index(kernel), cp,
                                      int(last)))
    assert info == {"registers": 100, "local_bytes": 101,
                    "static_smem_bytes": 102, "dynamic_smem_bytes": 103}
  assert kl.shard_kernel_info(c, cp, True, last) == info
  assert lib.calls[-1] == ("info", (c, kl.WIDE_KERNELS.index(kernels[-1]),
                                    cp, int(last)))
  calls = len(lib.calls)
  for kernel in set(kl.WIDE_KERNELS) - set(kernels):
    with pytest.raises(ValueError, match=f"no {kernel} kernel"):
      kl.wide_kernel_info(kernel, last, cp, c)
  with pytest.raises(ValueError, match=r"\(C, C'\) in"):
    kl.wide_kernel_info(kernels[0], last, 3 * cp, c)
  assert len(lib.calls) == calls


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c,cp", kl.shard_pairs() + ((C, C),))
def test_wide_schedule_asks_for_each_pair(monkeypatch, c, cp, last):
  """wide_schedule passes (C, C', B, T, last) to the library and reads
  back the slots, the tiles and the blocks of each kernel that does
  products, in launch order (the rank kernel's alone where it runs)."""
  lib = _InfoLibrary()
  monkeypatch.setattr(kl, "_library", lambda: lib)
  got = kl.wide_schedule(1, 26_432, last, cp, c)
  assert lib.calls == [("schedule", (c, cp, 1, 26_432, int(last)))]
  want = {"slots": SMS, "tiles": 207}
  if kl.rank_fused(c, cp):
    want["rank_blocks"] = SMS - 1
  else:
    want.update(gate_blocks=SMS - 1, rs_blocks=SMS - 2)
  assert got == want
