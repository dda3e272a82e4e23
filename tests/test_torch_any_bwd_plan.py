"""The host-side plan of the shape-generic bf16 backward
(csrc/wn_layer_bwd_any.cu), on the CPU (no library is loaded): the padded
width Cp, the rows kernel's passes, the dx and weights kernels' tile
widths, the kernels a call launches, the weights kernel's output tiles
(the host's mirror of the library's count, each padded weight element in
exactly one tile), the cut of its rows into ranges (every row of every
batch row in exactly one range, the chunks the kernel's counters walk,
whole waves where the rows allow) and the one scratch allocation at C =
50, 384 and 1,280, whose f32 partials take at most two slots at C =
1,280. The card checks that the library counts the same tiles
(``test_torch_gpu.py``:
``test_any_bwd_weight_tiles_mirror_is_the_library``).
"""

import pytest

from waveglow_tpu_torch.kernels import wn_layer as kl

SMS = 132  # an H100 SXM
M = kl.ANY_BWD_TILE_ROWS
CHUNK = kl.BWD_CHUNK_ROWS
WIDTHS = (48, 50, 64, 384, 1280)
TAPS = (1, 3, 5, 7)


@pytest.mark.parametrize("c,cp,passes,dx_n,w_n", [
    (48, 64, 1, 64, 64), (50, 64, 1, 64, 64), (64, 64, 1, 64, 64),
    (384, 384, 6, 192, 192), (1280, 1280, 20, 128, 256),
    (256, 256, 4, 128, 256), (640, 640, 10, 128, 128),
    (576, 576, 9, 192, 192), (512, 512, 8, 128, 256)])
def test_padded_width_and_tile_widths(c, cp, passes, dx_n, w_n):
  """Cp is C rounded up to 64; the rows kernel takes Cp / 64 passes of 64
  channels a tile; the weights tiles are the widest of 256, 192, 128, 64
  columns dividing Cp (so 2Cp too), the dx tiles the widest of 192, 128,
  64."""
  assert kl.any_cp(c) == cp and cp // kl.ANY_BWD_PASS == passes
  assert kl.any_bwd_dx_tile(c) == dx_n and kl.any_bwd_n_tile(c) == w_n
  assert cp % dx_n == 0 and cp % w_n == 0 and (2 * cp) % w_n == 0
  assert all(cp % n for n in (256, 192, 128, 64) if n > w_n)
  assert all(cp % n for n in (192, 128, 64) if n > dx_n)


@pytest.mark.parametrize("c,want", [
    (48, ("pad", "prep", "rows", "dx", "weights", "reduce")),
    (50, ("pad", "prep", "rows", "dx", "weights", "reduce")),
    (384, ("prep", "rows", "dx", "weights", "reduce")),
    (1280, ("prep", "rows", "dx", "weights", "reduce")),
    (256, ("prep", "rows", "dx", "weights", "reduce"))])
def test_kernels_of_a_call(c, want):
  """The weights are padded (the pad kernel) only where C is not a
  multiple of 64; elsewhere the kernels read w_in, w_rs and dcond as they
  lie. Every kernel a call launches is one of ANY_BWD_KERNELS."""
  assert kl.any_bwd_kernels(c) == want
  assert set(want) <= set(kl.ANY_BWD_KERNELS)


def tiles_of(c, k, last):
  """The weights kernel's output tiles as (matrix, first row, rows, first
  column, columns): dw_in_p [K*Cp, 2Cp] in tiles of M rows (the last one
  short) x N columns, then dw_rs_p^T [n_rsp, Cp]."""
  cp, n = kl.any_cp(c), kl.any_bwd_n_tile(c)
  n_rsp = cp if last else 2 * cp
  out = []
  for name, rows, cols in (("in", k * cp, 2 * cp), ("rs", n_rsp, cp)):
    for r0 in range(0, rows, M):
      for c0 in range(0, cols, n):
        out.append((name, r0, min(M, rows - r0), c0, n))
  return out


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("k", TAPS)
@pytest.mark.parametrize("c", WIDTHS)
def test_weight_tiles_mirror(c, k, last):
  """kl.any_bwd_weight_tiles counts the tiles that cover each element of
  the padded dw_in and dw_rs^T exactly once; no tile is wider than its
  matrix."""
  tiles = tiles_of(c, k, last)
  assert kl.any_bwd_weight_tiles(c, k, last) == len(tiles)
  cp = kl.any_cp(c)
  n_rsp = cp if last else 2 * cp
  for name, rows, cols in (("in", k * cp, 2 * cp), ("rs", n_rsp, cp)):
    mine = [t for t in tiles if t[0] == name]
    assert sum(t[2] * t[4] for t in mine) == rows * cols
    assert all(t[1] + t[2] <= rows and t[3] + t[4] <= cols for t in mine)


@pytest.mark.parametrize("c,k", [(64, 7), (192, 3), (50, 5), (320, 3)])
def test_a_dw_in_tile_may_take_two_taps(c, k):
  """Where Cp is an odd number of 64s a 128-row dw_in tile's two 64-row
  halves lie in two taps (each thread's 8 rows in one, with its own
  shift), and the last tile is 64 rows where K*Cp is an odd number of
  64s."""
  cp = kl.any_cp(c)
  split = [r0 for name, r0, rows, _, _ in tiles_of(c, k, False)
           if name == "in" and r0 // cp != (r0 + rows - 1) // cp]
  assert split
  for r0 in split:
    assert (r0 + 64) % cp == 0  # the halves meet at a tap's first row
  last = max(r0 for name, r0, *_ in tiles_of(c, k, False) if name == "in")
  assert k * cp - last == (64 if (k * cp // 64) % 2 else M)


def ranges_of(batch, t, cut):
  """The weights kernel's ranges as it reads them from blockIdx.y: range
  s is rows [tb, te) of batch rows [b0, b1)."""
  split_batches, n_splits_t, split_rows = cut
  out = []
  for s in range(kl.any_bwd_ranges(batch, split_batches, n_splits_t)):
    bq, ts = divmod(s, n_splits_t)
    b0 = bq * split_batches
    b1 = min(batch, b0 + split_batches)
    tb = ts * split_rows
    out.append((b0, b1, tb, min(t, tb + split_rows)))
  return out


def chunk_walk(rng):
  """The rows of a range's chunks in the order the kernel's counters walk
  them (ld_t1 += 64; past te, back to tb of the next batch row), as (batch
  row, first row) pairs."""
  b0, b1, tb, te = rng
  chunks = (b1 - b0) * -(-(te - tb) // CHUNK)
  t1, b, out = tb, b0, []
  for _ in range(chunks):
    out.append((b, t1))
    t1 += CHUNK
    if t1 >= te:
      t1, b = tb, b + 1
  return out


@pytest.mark.parametrize("tiles", [3, 9, 14, 16, 24, 48, 96, 800])
@pytest.mark.parametrize("batch,t", [(12, 2_000), (4, 2_000), (1, 1),
                                     (3, 17), (2, 63), (2, 64), (2, 65),
                                     (8, 300), (12, 26_432)])
def test_every_row_in_one_range(batch, t, tiles):
  """Each cut covers every row of every batch row exactly once, a range
  either a part of one batch row or a run of whole batch rows, and its
  chunks, walked as the kernel's counters walk them, are the range's rows
  in 64-row steps from tb, each batch row in turn."""
  cut = kl.any_bwd_splits(batch, t, tiles, SMS)
  split_batches, n_splits_t, split_rows = cut
  assert split_rows % CHUNK == 0 and n_splits_t * split_rows >= t
  assert split_batches == 1 or n_splits_t == 1
  seen = {}
  for rng in ranges_of(batch, t, cut):
    b0, b1, tb, te = rng
    assert b0 < b1 and tb < te
    walk = chunk_walk(rng)
    assert walk == [(b, t1) for b in range(b0, b1)
                    for t1 in range(tb, te, CHUNK)]
    for b, t1 in walk:
      for r in range(t1, min(t1 + CHUNK, te)):
        seen[(b, r)] = seen.get((b, r), 0) + 1
  assert seen == {(b, r): 1 for b in range(batch) for r in range(t)}


@pytest.mark.parametrize("c,k", [(256, 5), (384, 3), (256, 3), (50, 7),
                                 (384, 7), (1280, 7), (64, 1), (48, 5)])
@pytest.mark.parametrize("batch", [12, 4])
def test_the_cut_fills_whole_waves(batch, c, k):
  """At T = 2,000 the cut's blocks (tiles x ranges) fill at least one wave
  of the card and end in a last wave at least 85% full, or, where no cut
  does so within four waves, the fullest last wave there is; no cut with
  fewer ranges does as well."""
  t = 2_000
  tiles = kl.any_bwd_weight_tiles(c, k, False)
  cut = kl.any_bwd_splits(batch, t, tiles, SMS)
  blocks = tiles * kl.any_bwd_ranges(batch, *cut[:2])
  waves = -(-blocks // SMS)
  fill = blocks / (waves * SMS)
  assert blocks >= SMS
  ranges = kl.any_bwd_ranges(batch, *cut[:2])
  fewer = {-(-batch // -(-batch // g)) for g in range(1, batch + 1)}
  for r in sorted(n for n in fewer if n < ranges):
    other = tiles * r
    other_waves = -(-other // SMS)
    assert not (other >= SMS and other / (other_waves * SMS) > fill)
  if fill < 0.85:
    assert waves <= 4 or ranges <= batch


def test_the_cut_at_the_specialised_shape_is_theirs():
  """At (256, 3) the weights kernel has the specialised kernel's 16 tiles
  (6 x 2 of dw_in, 4 of dw_rs^T at N = 256) and takes its cut: each batch
  row in two ranges of 1,024 rows, 24 slots, so the sums run in its order
  (phase 17(b) compares the bits)."""
  tiles = kl.any_bwd_weight_tiles(256, 3, False)
  assert tiles == 16
  assert kl.any_bwd_splits(12, 2_000, tiles, SMS) == (
      1, *kl.bwd_splits(12, 2_000, tiles, SMS)) == (1, 2, 1024)


@pytest.mark.parametrize("c,k,want", [(256, 5, (1, 1, 2048)),
                                      (384, 3, (3, 1, 2048)),
                                      (1280, 7, (12, 1, 2048))])
def test_runs_of_whole_batch_rows(c, k, want):
  """Where a few ranges fill the card, a range is a run of whole batch
  rows: at (384, 3) 48 tiles x 4 ranges of 3 rows, at (1,280, 7) 800 tiles
  x one range of all 12 (a batch row a range at (256, 5))."""
  tiles = kl.any_bwd_weight_tiles(c, k, False)
  assert kl.any_bwd_splits(12, 2_000, tiles, SMS) == want


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c,k", [(50, 7), (384, 7), (1280, 7), (50, 3),
                                 (384, 3), (1280, 1)])
def test_scratch_layout(c, k, last):
  """One allocation: bf16 x_p, g_p, acts_p, the f32 part_bias of 128-row
  tiles and the workspace of the cut's ranges; where C is not a multiple
  of 64 the padded weights and dgates too; each part 256-byte aligned, no
  gap past that."""
  batch, t = 12, 2_000
  cp = kl.any_cp(c)
  n_rsp = cp if last else 2 * cp
  rows, tiles = batch * t, batch * -(-t // M)
  cut = kl.any_bwd_splits(batch, t, kl.any_bwd_weight_tiles(c, k, last),
                          SMS)
  ranges = kl.any_bwd_ranges(batch, *cut[:2])
  plan = kl.any_bwd_scratch(batch, t, c, k, last, ranges)
  want = {"x_p": rows * cp * 2, "g_p": rows * n_rsp * 2,
          "acts_p": rows * cp * 2,
          "part_bias": tiles * (2 * cp + n_rsp) * 4,
          "ws": ranges * (k * cp * 2 * cp + cp * n_rsp) * 4}
  if cp != c:
    want.update(w_in_p=k * cp * 2 * cp * 2, w_rs_p=cp * n_rsp * 2,
                dg_p=rows * 2 * cp * 2)
  assert plan["sizes"] == want
  end = 0
  for name, n in want.items():
    assert plan["offsets"][name] == end and end % 256 == 0
    end += -(-n // 256) * 256
  assert plan["bytes"] == end


@pytest.mark.parametrize("c", [50, 384, 1280])
def test_workspace_at_k7(c):
  """At K = 7, B = 12, T = 2,000 the workspace holds the cut's slots, not
  one a batch row: at C = 1,280 one slot of dw_in_p and dw_rs_p (105 MB),
  at most two (0.21 GB) against the 12 (1.26 GB) of a cut inside each
  batch row; at 384 four slots of three batch rows; at 50 (tiny slots)
  the cut inside the batch rows."""
  batch, t, k = 12, 2_000, 7
  cp = kl.any_cp(c)
  slot = (k * cp * 2 * cp + cp * 2 * cp) * 4
  cut = kl.any_bwd_splits(batch, t, kl.any_bwd_weight_tiles(c, k, False),
                          SMS)
  ranges = kl.any_bwd_ranges(batch, *cut[:2])
  ws = kl.any_bwd_scratch(batch, t, c, k, False, ranges)["sizes"]["ws"]
  assert ws == ranges * slot
  if c == 1280:
    assert slot == 104_857_600 and ranges <= 2 and ws <= 0.21e9
    assert batch * slot > 1.25e9
  if c == 384:
    assert cut == (3, 1, 2048) and ranges == 4
  if c == 50:
    assert cut[0] == 1 and ranges >= batch and ws < 10e6
