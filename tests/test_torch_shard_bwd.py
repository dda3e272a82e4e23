"""The bf16 shard backward's host-side schedule and its build checks, on the
CPU (no library is loaded).

``bwd_splits`` cuts the weights kernel's rows so its blocks fill the
card's waves; ``bwd_scratch`` lays its scratch out in one allocation;
``count_mma`` (HGMMA alone), ``wgmma_serialized`` and ``check_wgmma`` hold
the redesigned kernels to wgmma in phase 2 of ``chip_smoke.py``. The whole
layer's backward, which shares these, is tested in
``test_torch_bwd_plan.py``.
"""

import importlib.util
from pathlib import Path

import pytest

from waveglow_tpu_torch.kernels import wn_layer as kl

ROOT = Path(__file__).resolve().parents[1]
SMS = 132  # an H100 SXM

# The weights kernel's output tiles at each pair (non-last layer): dw_in_s's
# 128-row tiles of 3C x ceil(2C' / min(2C', 256)), then dw_rs_s^T's n_rs /
# 128 (wn_layer_bwd_weight_tiles; the card's test reads the library).
WEIGHT_TILES = {(128, 64): 5, (128, 32): 5, (128, 16): 5, (256, 128): 10,
                (256, 64): 10, (256, 32): 10, (512, 256): 32,
                (512, 128): 20, (512, 64): 20}


@pytest.fixture(scope="module")
def smoke():
  spec = importlib.util.spec_from_file_location("chip_smoke",
                                                ROOT / "chip_smoke.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def test_weight_tiles_cover_every_pair():
  assert sorted(WEIGHT_TILES) == sorted(kl.shard_pairs())


@pytest.mark.parametrize("batch", [12, 4])
@pytest.mark.parametrize("pair", sorted(WEIGHT_TILES))
def test_splits_fill_a_wave_at_the_training_shapes(pair, batch):
  """At T = 2,000 (the training segment) and B = 12 or 4 every pair's
  weights kernel gets at least one full wave of blocks, whole 64-row
  chunks a range, the ranges covering T with no empty one."""
  t, tiles = 2_000, WEIGHT_TILES[pair]
  n_splits, split_rows = kl.bwd_splits(batch, t, tiles, SMS)
  assert split_rows % kl.BWD_CHUNK_ROWS == 0
  assert (n_splits - 1) * split_rows < t <= n_splits * split_rows
  blocks = tiles * batch * n_splits
  assert blocks >= SMS
  waves = -(-blocks // SMS)
  assert waves <= 4 and blocks / (waves * SMS) >= 0.8


@pytest.mark.parametrize("batch,t,tiles,want", [
    (12, 2_000, 10, (2, 1024)),   # (256, 128): 240 blocks, 91% of 2 waves
    (12, 2_000, 32, (1, 2048)),   # (512, 256): 384 blocks, 97% of 3 waves
    (4, 2_000, 32, (2, 1024)),    # (512, 256) at batch 4: 256 blocks
    (12, 2_000, 5, (4, 512)),     # C = 128: 240 blocks
    (1, 17, 10, (1, 64)),         # one chunk: one range, whatever the fill
    (1, 129, 5, (3, 64))])        # too few rows for a wave: the fullest
def test_splits_take_the_fewest_ranges_that_fill_the_waves(batch, t, tiles,
                                                           want):
  assert kl.bwd_splits(batch, t, tiles, SMS) == want


def test_splits_stop_at_four_waves():
  """Where no cut fills 85% of its last wave, the fullest within 4 waves
  wins (C = 128 at batch 4: 11 ranges, 220 blocks, not 32 of 64 rows)."""
  assert kl.bwd_splits(4, 2_000, 5, SMS) == (11, 192)


@pytest.mark.parametrize("last", [False, True])
def test_scratch_is_one_aligned_allocation(last):
  """Five disjoint, 256-byte aligned pieces at the shapes the kernels take
  (at (256, 128), B = 12, T = 2,000, 2 ranges a batch row, 128-row tiles:
  68,370,432 bytes for a non-last layer)."""
  batch, t, c, cp, splits = 12, 2_000, 256, 128, 2
  plan = kl.bwd_scratch(batch, t, c, cp, last, splits, 128)
  n_rs = c if last else 2 * c
  rows = batch * t
  assert plan["sizes"] == {
      "acts": rows * cp * 2, "x_bf": rows * c * 2, "g_bf": rows * n_rs * 2,
      "part_bias": batch * 16 * 2 * cp * 4,
      "ws": batch * splits * (3 * c * 2 * cp + cp * n_rs) * 4}
  spans = sorted((plan["offsets"][k], plan["offsets"][k] + n)
                 for k, n in plan["sizes"].items())
  assert all(lo % 256 == 0 for lo, _ in spans)
  assert all(a_end <= b_lo for (_, a_end), (b_lo, _) in zip(spans, spans[1:]))
  assert spans[-1][1] <= plan["bytes"] < spans[-1][1] + 256
  if not last:
    assert plan["bytes"] == 68_370_432


_SBWD = "_ZN54_GLOBAL__N__05726558_21_wn_layer_shard_bwd_cu_3e1b28cf"
SBWD_WEIGHTS = (_SBWD + "22wn_sbwd_weights_kernelILi256ELi32EEEvPK13__nv_"
                "bfloat16S3_S3_S3_Pfiiiii")
SBWD_DX = (_SBWD + "17wn_sbwd_dx_kernelILi256ELi32EEEvPK13__nv_bfloat16S3_"
           "Pfiii")


def sass(counts):
  """SASS with ``counts[mangled] = (hgmma, hmma)`` instructions a kernel."""
  lines = ["\tcode for sm_90a"]
  for mangled, (hgmma, hmma) in counts.items():
    lines.append(f"\t\tFunction : {mangled}")
    lines += ["        /*0a50*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], "
              "R24 ;"] * hgmma
    lines += ["        /*0b50*/  HMMA.16816.F32.BF16 R24, R4, R8, R24 ;"] * hmma
  return "\n".join(lines)


def test_count_mma_counts_wgmma_alone(smoke):
  counts = sass({SBWD_WEIGHTS: (4, 0), SBWD_DX: (0, 6)})
  assert smoke.count_mma(counts, r"\bHGMMA\.") == {
      "bf16,C=256,C'=32,sbwd-weights": 4, "bf16,C=256,C'=32,sbwd-dx": 0}
  assert smoke.count_mma(counts) == {"bf16,C=256,C'=32,sbwd-weights": 4,
                                     "bf16,C=256,C'=32,sbwd-dx": 6}


def test_check_wgmma_demands_hgmma_of_the_shard_backward(smoke):
  """mma.sync (HMMA) no longer passes for the shard backward's product
  kernels; the reduce kernel and the C <= 256 forward are not held."""
  variants = [smoke.shard_bwd_variant(*v) for v in smoke.SHARD_BWD_KERNELS]
  variants += ["bf16,C=256,layer", "bf16,C=256,bwd-dx"]
  hgmma = {name: (0 if name.startswith("reduce") or name == "bf16,C=256,layer"
                  else 8) for name in variants}
  smoke.check_wgmma(hgmma, set(), variants)  # passes
  hgmma["bf16,C=512,C'=256,sbwd-rows,last"] = 0
  with pytest.raises(SystemExit, match="no wgmma"):
    smoke.check_wgmma(hgmma, set(), variants)


def test_check_wgmma_fails_on_serialized_wgmma(smoke):
  variants = [smoke.shard_bwd_variant(*v) for v in smoke.SHARD_BWD_KERNELS]
  hgmma = dict.fromkeys(variants, 8)
  with pytest.raises(SystemExit, match="serialized"):
    smoke.check_wgmma(hgmma, {"bf16,C=256,C'=32,sbwd-weights"}, variants)


@pytest.mark.parametrize("warning", [
    # the function named on the warning's own line
    "ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async "
    "instructions are serialized due to the presence of Extern calls in the "
    f"function '{SBWD_WEIGHTS}'",
    # or only by the entry ptxas was compiling
    "ptxas warning : (C7513) Potential Performance Loss: wgmma.mma_async "
    "instructions are serialized due to insufficient register resources"])
def test_wgmma_serialized_reads_ptxas(smoke, warning):
  log = "\n".join([
      f"ptxas info    : Compiling entry function '{SBWD_DX}' for 'sm_90a'",
      "ptxas info    : Used 166 registers, used 1 barriers",
      f"ptxas info    : Compiling entry function '{SBWD_WEIGHTS}' for "
      "'sm_90a'", warning,
      "ptxas info    : Used 96 registers, used 1 barriers"])
  assert smoke.wgmma_serialized(log) == {"bf16,C=256,C'=32,sbwd-weights"}
  assert smoke.wgmma_serialized(log.replace(warning, "")) == set()


def test_no_spill_is_allowed_in_the_shard_backward(smoke):
  """check_no_spills holds the shard backward's product kernels to no
  spill, as the f32 kernels; the other bf16 kernels are not held."""
  clean = {"registers": 96, "local_bytes": 0}
  smoke.check_no_spills(None, {"bf16,C=256,C'=32,sbwd-dx": clean,
                               "bf16,C=256,layer": {**clean,
                                                    "local_bytes": 8}})
  with pytest.raises(SystemExit, match="spills"):
    smoke.check_no_spills(
        {"bf16,C=256,C'=32,sbwd-dx": {"spill_store_bytes": 8}},
        {"bf16,C=256,C'=32,sbwd-dx": clean})


class _Trace:
  """Stands in for torch.profiler.profile (the CPU build traces no card)."""

  def __init__(self, activities):
    pass

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


@pytest.mark.parametrize("kept", [10, 1, 0])
def test_kernel_split_is_the_mean_of_the_traced_launches(smoke, monkeypatch,
                                                         kept):
  """Phase 13(a)'s per-kernel split: each kernel's mean device time over the
  launches the trace holds, by its variant name (a trace that lost calls
  late in a long process still gives each launch's time); a trace without
  one of the kernels is taken again, 3 times in all, then "not
  measured"."""
  import torch
  monkeypatch.setattr(torch.profiler, "profile", _Trace)
  monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
  monkeypatch.setattr(kl, "wn_layer_shard_backward_fused", lambda *a: None)
  names = [f"void (anonymous namespace)::wn_sbwd_{k}_kernel<256, 32>(...)"
           for k in ("rows", "dx", "weights", "reduce")]
  names[0] = names[0].replace("<256, 32>", "<256, 32, false>")
  trace = [(n, 0.5 * (i + 1)) for _ in range(kept) for i, n in enumerate(names)]
  traces = []

  def device_kernels(prof):
    traces.append(prof)
    return trace[1:] if kept == 10 else trace

  monkeypatch.setattr(smoke, "device_kernels", device_kernels)
  saved = (torch.zeros(1, 1, 256), None, None, torch.zeros(64), None)
  got = smoke.shard_backward_kernel_ms(saved, None, 1)
  assert len(traces) == (3 if kept == 0 else 1)  # a kernel missing: retried
  if kept == 0:
    assert got == "not measured"
  else:
    assert got == pytest.approx({
        "bf16,C=256,C'=32,sbwd-rows,layer": 0.5,
        "bf16,C=256,C'=32,sbwd-dx": 1.0,
        "bf16,C=256,C'=32,sbwd-weights": 1.5, "reduce,C=256,C'=32,sbwd": 2.0})
