"""The yardstick and the build checks of ``chip_smoke.py``, on the CPU.

``layer_cost`` sets the bound every kernel time in PERF.md is read against;
``parse_ptxas``, ``count_mma`` and ``check_tensor_cores`` read the build's
ptxas log and SASS and must know each kernel variant's mangled name;
``leaf_norm_rel_errors`` is the train-step check's gradient metric;
``latency_summary``, ``stream_windows``, ``expected_launches``,
``count_dispatches`` and ``c9_failures`` are the serving phase's
percentiles, launch accounting and C9 timing predicate;
``cli_dispatch_rows``, ``expected_cli_launches`` and ``pcm_mismatch`` are
the CLI phase's launch accounting and its file-for-file comparison;
``expected_train_launches``, ``expected_validate_launches``,
``validation_dirs_mismatch``, ``validation_metrics`` and ``state_mismatch``
are the training and validation commands' launch accounting, their
iteration folders, report rows and checkpoint comparison; ``loader_check``
and ``denoiser_check`` are phase 6's native-loader and normal-mel
bias-capture checks, rehearsed here on the CPU.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from waveglow_tpu_torch.kernels import wn_layer as kl

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
  spec = importlib.util.spec_from_file_location("chip_smoke",
                                                ROOT / "chip_smoke.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


# Mangled names of the four kernel instantiations at C=256 (the width is
# the first template argument).
F32_LAYER = ("_ZN12_GLOBAL__N_119wn_layer_kernel_f32ILi256ELb0EEEvPKfS2_S2_"
             "S2_S2_S2_PKiPfS5_iiiii")
F32_LAST = F32_LAYER.replace("Lb0EE", "Lb1EE")
MMA_LAYER = ("_ZN12_GLOBAL__N_119wn_layer_kernel_mmaILi256ELb0EEEvPKfPK13"
             "__nv_bfloat16S5_S2_S5_S2_PKiPfS8_iii")
MMA_LAST = MMA_LAYER.replace("Lb0EE", "Lb1EE")
# The same forward kernel compiled on its own into an object file (the
# anonymous namespace then carries the file's name and a hash), and the
# bf16 backward's kernels, as nvcc names them in that build.
F32_LAYER_OBJ = ("_ZN44_GLOBAL__N__dd736113_11_wn_layer_cu_ad47388519"
                 "wn_layer_kernel_f32ILi256ELb0EEEvPKfS2_S2_S2_S2_S2_PKiPfS5_"
                 "iiiii")
_BWD = "_ZN48_GLOBAL__N__c526ef15_15_wn_layer_bwd_cu_16bb117d"
BWD_ROWS_LAYER = (_BWD + "18wn_bwd_rows_kernelILi256ELb0EEEvPKfPK13__nv_"
                  "bfloat16S5_S2_S5_S2_S2_PKiPS3_S8_S8_S8_Pfii")
BWD_ROWS_LAST = BWD_ROWS_LAYER.replace("Lb0EE", "Lb1EE")
BWD_DX = (_BWD + "16wn_bwd_dx_kernelILi256EEvPK13__nv_bfloat16S2_PKfPKiPfii")
BWD_WEIGHTS = (_BWD + "21wn_bwd_weights_kernelILi256EEvPK13__nv_bfloat16S2_"
               "S2_S2_Pfiiiii")
BWD_REDUCE = (_BWD + "20wn_bwd_reduce_kernelILi256EEvPKfiS1_iiP13__nv_"
              "bfloat16S3_PfS4_")
BWD_PREP_LAYER = (_BWD + "18wn_bwd_prep_kernelILi256ELb0EEEvPKfS2_S2_PKiP13"
                  "__nv_bfloat16S6_Pfi")
BWD_PREP_LAST = BWD_PREP_LAYER.replace("Lb0EE", "Lb1EE")
BWD = {BWD_ROWS_LAYER: "bf16,C=256,bwd-rows,layer",
       BWD_ROWS_LAST: "bf16,C=256,bwd-rows,last",
       BWD_DX: "bf16,C=256,bwd-dx", BWD_WEIGHTS: "bf16,C=256,bwd-weights",
       BWD_REDUCE: "reduce,C=256,bwd", BWD_PREP_LAYER: "prep,C=256,bwd,layer",
       BWD_PREP_LAST: "prep,C=256,bwd,last"}


def test_layer_cost_at_the_kernel_phase_shape(smoke):
  """B=1, T=26,432, C=256, non-last: 27.7 GFLOP; 136.4 MB (x, cond,
  weights, biases, valid_t, skip_acc read; x' and skip written); bound by
  bytes in bf16 (0.0407 ms at 3.35 TB/s) and by operations in f32
  (0.4137 ms at 67 TFLOP/s)."""
  assert smoke.T_KERNEL == 26_432 and smoke.C == 256
  rows = 26_432
  flops = 2 * rows * 256 * (3 * 512 + 512)
  assert flops == 27_715_960_832
  nbytes, got_flops, bound_ms, bound_by = smoke.layer_cost(
      1, smoke.T_KERNEL, False, "bf16", 256)
  assert got_flops == flops
  assert nbytes == 136_384_516
  assert bound_by == "bytes"
  assert bound_ms == pytest.approx(0.040712, rel=1e-4)
  nbytes32, flops32, bound32, by32 = smoke.layer_cost(
      1, smoke.T_KERNEL, False, "f32", 256)
  assert flops32 == flops
  assert nbytes32 == nbytes + rows * 512 * 2 + 524_288 * 2  # 4-byte cond, w
  assert by32 == "operations"
  assert bound32 == pytest.approx(0.413640, rel=1e-4)


@pytest.mark.parametrize("mangled,name", [
    (F32_LAYER, "f32,C=256,layer"), (F32_LAST, "f32,C=256,last"),
    (MMA_LAYER, "bf16,C=256,layer"), (MMA_LAST, "bf16,C=256,last"),
    (F32_LAYER_OBJ, "f32,C=256,layer"), *BWD.items(),
    (MMA_LAYER.replace("ILi256E", "ILi512E"), "bf16,C=512,layer"),
    (F32_LAST.replace("ILi256E", "ILi128E"), "f32,C=128,last"),
    (BWD_DX.replace("ILi256E", "ILi128E"), "bf16,C=128,bwd-dx"),
    ("_Z5otherv", "_Z5otherv")])
def test_kernel_variant_from_mangled_name(smoke, mangled, name):
  assert smoke.kernel_variant(mangled) == name


def test_parse_ptxas_reads_every_variant(smoke):
  log = []
  for i, mangled in enumerate((F32_LAYER, F32_LAST, MMA_LAYER, MMA_LAST)):
    log += [f"ptxas info    : Compiling entry function '{mangled}' for "
            "'sm_90a'",
            f"ptxas info    : Function properties for {mangled}",
            f"    0 bytes stack frame, {4 * i} bytes spill stores, "
            f"{8 * i} bytes spill loads",
            f"ptxas info    : Used {100 + i} registers, used 1 barriers, "
            "400 bytes cmem[0]"]
  facts = smoke.parse_ptxas("\n".join(log))
  assert sorted(facts) == ["bf16,C=256,last", "bf16,C=256,layer",
                           "f32,C=256,last", "f32,C=256,layer"]
  assert facts["bf16,C=256,layer"] == {"spill_store_bytes": 8,
                                 "spill_load_bytes": 16, "registers": 102,
                                 "static_smem_bytes": 0}


SASS = f"""
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : {MMA_LAYER}
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a50*/                   HMMA.16816.F32.BF16 R24, R4, R8, R24 ;
        /*0a60*/                   HMMA.16816.F32.BF16 R28, R4, R10, R28 ;
\t\tFunction : {MMA_LAST}
        /*0a50*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
\t\tFunction : {F32_LAYER}
        /*0100*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : {F32_LAST}
        /*0100*/                   FFMA R1, R2, R3, R4 ;
"""


def test_count_mma_per_variant(smoke):
  counts = smoke.count_mma(SASS)
  assert counts == {"bf16,C=256,layer": 2, "bf16,C=256,last": 1,
                    "f32,C=256,layer": 0, "f32,C=256,last": 0}
  smoke.check_tensor_cores(counts, counts)  # passes


@pytest.mark.parametrize("fault", ["bf16 without mma", "f32 with mma",
                                   "variant missing"])
def test_check_tensor_cores_fails(smoke, fault):
  counts = smoke.count_mma(SASS)
  variants = list(counts)
  if fault == "bf16 without mma":
    counts["bf16,C=256,last"] = 0
  elif fault == "f32 with mma":
    counts["f32,C=256,layer"] = 3
  else:
    del counts["f32,C=256,last"]
  with pytest.raises(SystemExit, match="chip_smoke FAILED"):
    smoke.check_tensor_cores(counts, variants)


def test_backward_variants_are_the_runtime_queries(smoke):
  """The variants phase 2 asks the runtime about are the ones the SASS and
  ptxas carry, so its ``set(ptxas) == set(attributes)`` check holds."""
  assert {smoke.bwd_variant(k, last, width)
          for k, last, width in smoke.BWD_KERNELS if width == 256} == set(
      BWD.values())
  assert {width for _, _, width in smoke.BWD_KERNELS} == {128, 256, 512}


def ptxas_log(names):
  log = []
  for i, mangled in enumerate(names):
    log += [f"ptxas info    : Compiling entry function '{mangled}' for "
            "'sm_90a'",
            f"ptxas info    : Function properties for {mangled}",
            f"    0 bytes stack frame, {4 * i} bytes spill stores, "
            f"{8 * i} bytes spill loads",
            f"ptxas info    : Used {100 + i} registers, used 1 barriers"]
  return "\n".join(log)


def test_parse_ptxas_reads_the_backward_kernels(smoke):
  """One log of both sources, each compiled on its own (nvcc -c)."""
  names = (F32_LAYER_OBJ, MMA_LAYER, *BWD)
  facts = smoke.parse_ptxas(ptxas_log(names))
  assert sorted(facts) == sorted(["f32,C=256,layer", "bf16,C=256,layer",
                                  *BWD.values()])
  assert facts["bf16,C=256,bwd-dx"] == {"spill_store_bytes": 16,
                                  "spill_load_bytes": 32, "registers": 104,
                                  "static_smem_bytes": 0}


def bwd_sass(mma):
  """SASS of the backward kernels, ``mma[variant]`` tensor-core
  instructions in each."""
  lines = ["\tcode for sm_90a"]
  for mangled, name in BWD.items():
    lines.append(f"\t\tFunction : {mangled}")
    lines.append("        /*0000*/                   LDC R1, c[0x0][0x28] ;")
    lines += ["        /*0a50*/                   HMMA.16816.F32.BF16 R24, "
              "R4, R8, R24 ;"] * mma.get(name, 0)
  return "\n".join(lines)


def test_backward_kernels_pass_the_tensor_core_check(smoke):
  """Every backward kernel that does products has HMMA; the reduce and
  prep kernels have none and are not asked for any."""
  counts = smoke.count_mma(SASS + bwd_sass({
      "bf16,C=256,bwd-rows,layer": 3, "bf16,C=256,bwd-rows,last": 3,
      "bf16,C=256,bwd-dx": 2, "bf16,C=256,bwd-weights": 4}))
  assert (counts["reduce,C=256,bwd"] == 0
          and counts["prep,C=256,bwd,last"] == 0
          and counts["bf16,C=256,bwd-dx"] == 2)
  assert len(counts) == 11
  smoke.check_tensor_cores(counts, counts)  # passes


@pytest.mark.parametrize("without", ["bf16,C=256,bwd-rows,layer",
                                     "bf16,C=256,bwd-rows,last",
                                     "bf16,C=256,bwd-dx",
                                     "bf16,C=256,bwd-weights"])
def test_check_tensor_cores_fails_for_a_backward_kernel_without_mma(
    smoke, without):
  mma = {name: 2 for name in BWD.values() if name != "reduce,C=256,bwd"}
  mma[without] = 0
  counts = smoke.count_mma(SASS + bwd_sass(mma))
  with pytest.raises(SystemExit, match=without):
    smoke.check_tensor_cores(counts, counts)


@pytest.mark.parametrize("last", [False, True])
def test_trainable_cost_bills_the_bf16_backward_at_the_bf16_rate(smoke,
                                                                 last):
  """B=12, T=2,000, C=256. Non-last: the gradients' products are 50.3
  GFLOP (dacts and dw_rs, 2 x 12.6 of them with K or N = 2C, then dw_in
  and the taps' adjoint): 0.0509 ms at 989 TFLOP/s in bf16, above the
  0.0446 ms of the backward's 149.6 MB, and 0.7512 ms at 67 TFLOP/s in
  f32, as before. The whole bf16 layer: 75.5 GFLOP, 0.0763 ms (was
  0.7767 when the backward was billed at the f32 rate). Last layer
  (n_rs = C): 44.0 GFLOP, byte-bound in bf16."""
  assert (smoke.B_TRAIN, smoke.T_TRAIN, smoke.C) == (12, 2000, 256)
  rows = 24_000
  rs = 256 if last else 512
  flops = 2 * rows * (2 * 256 * rs + 2 * 768 * 512)
  bf16 = smoke.trainable_cost(last, "bf16", 256)
  f32 = smoke.trainable_cost(last, "f32", 256)
  assert bf16["bwd_flops"] == f32["bwd_flops"] == flops
  assert f32["bwd_bound_ms"] == pytest.approx(flops / 67e12 * 1e3, rel=1e-12)
  assert f32["bound_by"] == f32["bwd_bound_by"] == "operations"
  if last:
    assert bf16["bwd_bound_by"] == "bytes"
    assert bf16["bwd_bound_ms"] == pytest.approx(0.044566, rel=1e-4)
  else:
    assert flops == 50_331_648_000
    assert bf16["bwd_bound_by"] == "operations"
    assert bf16["bwd_bound_ms"] == pytest.approx(0.050891, rel=1e-4)
    assert f32["bwd_bound_ms"] == pytest.approx(0.751219, rel=1e-4)
    assert bf16["bound_ms"] == pytest.approx(0.076337, rel=1e-4)
    assert f32["bound_ms"] == pytest.approx(1.126828, rel=1e-4)


def attributes(local_bytes):
  return {"f32,C=256,layer": {"registers": 167, "local_bytes": local_bytes,
                              "static_smem_bytes": 0,
                              "dynamic_smem_bytes": 193_280},
          "bf16,C=256,layer": {"registers": 255, "local_bytes": 8,
                               "static_smem_bytes": 0,
                               "dynamic_smem_bytes": 229_376}}


@pytest.mark.parametrize("fault", [None, "local bytes", "ptxas spills"])
def test_check_no_spills_holds_the_f32_kernels(smoke, fault):
  """An f32 variant fails on local bytes in the loaded build or on spills
  in ptxas's report; other variants (the bf16 kernel's 8 local bytes) are
  not held to it, and a cached build (no ptxas report) is read from the
  runtime alone."""
  ptxas = {"f32,C=256,layer": {"spill_store_bytes": 0,
                               "spill_load_bytes": 0},
           "bf16,C=256,layer": {"spill_store_bytes": 8,
                                "spill_load_bytes": 8}}
  attrs = attributes(4 if fault == "local bytes" else 0)
  if fault == "ptxas spills":
    ptxas["f32,C=256,layer"]["spill_load_bytes"] = 16
  if fault is None:
    smoke.check_no_spills(ptxas, attrs)
    smoke.check_no_spills(None, attrs)
    return
  with pytest.raises(SystemExit, match="f32,C=256,layer kernel spills"):
    smoke.check_no_spills(ptxas, attrs)


def test_f32_grid_reads_each_shape(smoke, monkeypatch):
  """Phase 2's report of the f32 grid: the share of the busiest block is
  an equal share of B*T over SMs x blocks an SM, against its rows."""
  def schedule(batch, t, last=False, channels=256):
    return {"sms": 132, "blocks_per_sm": 1, "blocks": 128,
            "rows_per_block": 208, "tiles_per_block": 5, "waves": 128 / 132}
  monkeypatch.setattr(smoke.kl, "f32_schedule", schedule)
  info = smoke.f32_grid(attributes(0))
  assert info["kernel"]["registers"] == 167
  shapes = ["B=1,T=26432", "B=8,T=26432", "B=12,T=2000"]
  assert sorted(info) == sorted(["kernel", *shapes,
                                 *[f"{s},C={w}" for s in shapes
                                   for w in (128, 512)]])
  assert info["B=1,T=26432"]["share_of_busiest"] == pytest.approx(
      26_432 / 132 / 208)


def test_step_grad_metric_flags_a_perturbed_leaf(smoke):
  """Phase 6's train-step check compares each leaf's gradient norm-wise.
  A shift of 0.2 in every row of a leaf whose max |value| is 100 is 2e-3
  of that max, inside the bf16 bound by the max-elementwise metric the
  check used before; norm-wise it is about 0.14 of the leaf, flagged. The
  other leaves stay at zero error, and a zero reference gives the absolute
  norm."""
  rng = np.random.default_rng(0)
  refs = [torch.from_numpy(rng.standard_normal((100, 100)).astype(np.float32))
          for _ in range(3)] + [torch.zeros(4)]
  refs[1][0, 0] = 100.0
  grads = [r.clone() for r in refs]
  grads[1] += 0.2
  grads[3][0] = 2.0
  old = (grads[1] - refs[1]).abs().max() / refs[1].abs().max()
  assert old <= smoke.STEP_GRAD_TOL_REL["bf16"]
  rel = smoke.leaf_norm_rel_errors(grads, refs)
  assert rel[0] == rel[2] == 0.0 and rel[3] == 2.0
  assert rel[1] == pytest.approx(20.0 / np.linalg.norm(refs[1].numpy()),
                                 rel=1e-6)
  assert rel[1] > 0.1 > smoke.STEP_GRAD_TOL_REL["bf16"]
  assert max(smoke.STEP_GRAD_TOL_REL.values()) < 2e-2  # tighter than before


def test_latency_summary_uses_the_daemons_quantile_rule(smoke):
  """p50 and p99 by linear interpolation, as the daemon's /stats
  (``np.quantile``): of 1..100 ms, p50 50.5 ms and p99 99.01 ms."""
  seconds = [i / 1e3 for i in range(1, 101)]
  got = smoke.latency_summary(seconds)
  assert got["n"] == 100
  assert got["mean"] == pytest.approx(0.0505)
  assert got["p50"] == pytest.approx(0.0505)
  assert got["p99"] == pytest.approx(0.09901)
  assert smoke.latency_summary([0.2])["p99"] == pytest.approx(0.2)


def test_stream_windows_and_expected_launches(smoke):
  """The serving phase's launch accounting at full width: 96 layers a
  synthesis; an 826-frame stream at the daemon's chunk of 128 (100-frame
  halo) runs 7 windows, a 200-frame one a single padded window; a
  dispatch is one synthesis whatever its rows; a reload captures the
  denoiser bias with one more."""
  assert smoke.stream_windows(826, 128, 100) == 7
  assert smoke.stream_windows(826, 256, 100) == 4   # phase 7's chunk
  assert smoke.stream_windows(200, 128, 100) == 1
  assert smoke.stream_windows(329, 128, 100) == 3
  rows = [1, 1, 1, 1, 8, 4, 4]
  assert smoke.expected_launches(rows, [], 96) == 7 * 96
  assert smoke.expected_launches(rows, [7, 7, 1, 1], 96) == 23 * 96


def test_count_dispatches_records_rows_and_passes_through(smoke):
  calls = []

  class Synth:
    def _serve_rows(self, mel, *args, **kwargs):
      calls.append((mel.shape, args, kwargs))
      return "out"

  synth = Synth()
  rows = smoke.count_dispatches(synth)
  assert synth._serve_rows(np.zeros((8, 80, 64)), 1, pcm16=True) == "out"
  assert synth._serve_rows(np.zeros((1, 80, 64))) == "out"
  assert rows == [8, 1]
  assert calls[0] == ((8, 80, 64), (1,), {"pcm16": True})


@pytest.mark.parametrize("result_s,batch_done,flags", [
    (0.030, False, 0),    # within 1.5x of a 0.025 s solo call, batch pending
    (0.0375, False, 0),   # at the bound
    (0.040, False, 1),    # over 1.5x
    (0.030, True, 1),     # the batch finished first: the fetch waited
    (0.210, True, 2),     # a blocking fetch behind a 0.18 s batch
])
def test_c9_predicate(smoke, result_s, batch_done, flags):
  assert smoke.C9_RATIO == 1.5
  assert len(smoke.c9_failures(result_s, 0.025, batch_done)) == flags


def test_cli_dispatch_rows_follow_the_synthesizer(smoke):
  """``synthesize --batch`` dispatches as ``serving_many_dispatch`` groups
  a slice of files (read off a tiny CPU Synthesizer); one synthesis a file
  at ``--batch 1``."""
  from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
  from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
  from waveglow_tpu_torch.inference.synthesizer import Synthesizer
  from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, init_params
  hp = overwrite_custom_hparams(HParams(), {
      "n_flows": "2", "n_early_every": "1", "n_layers": "1",
      "n_channels": "8"})
  synth = Synthesizer(CheckpointWaveglow.from_params(
      init_params(WaveGlowConfig.from_hparams(hp), seed=0), hp),
                      device="cpu")
  rows = smoke.count_dispatches(synth)
  frames = [10, 12, 23, 14, 9, 30, 5]
  mels = [np.zeros((80, f), np.float32) for f in frames]
  synth.infer_serving_many(mels, bucket_frames=16, max_batch=4)
  assert rows == smoke.cli_dispatch_rows(frames, 16, 4) == [4, 1, 2]
  assert smoke.cli_dispatch_rows(frames, 16, 1) == [1] * 7
  assert smoke.cli_dispatch_rows(frames, 0, 4) == [1] * 7  # all distinct
  assert smoke.cli_dispatch_rows([7] * 33, 16, 4) == [4] * 8 + [1]  # slices


def test_expected_cli_launches_flags_a_wrong_route(smoke):
  """Phase 9's four requests at full width: the bias capture and 4 files
  (480 launches) at ``--batch 1``; the bias capture and 3 dispatches
  (200 and 230 frames share a 256-frame bucket) at ``--batch 4`` (384). A
  run that did not batch, or ran a synthesis more, is flagged."""
  frames = smoke.FRAMES
  assert smoke.expected_cli_launches(frames, 64, 1, 96) == 480
  assert smoke.expected_cli_launches(frames, 64, 4, 96) == 384
  assert smoke.expected_cli_launches(frames, 16, 4, 96) == 480
  assert 480 != smoke.expected_cli_launches(frames, 64, 4, 96)
  assert 480 + 96 != smoke.expected_cli_launches(frames, 64, 1, 96)


def test_pcm_mismatch_flags_each_difference(smoke, tmp_path):
  """None for the exact file; a message for one sample off, a sample
  rate, a length and a sample format that differ."""
  from scipy.io import wavfile
  wav = np.sin(np.linspace(0, 50, 999)).astype(np.float32) * 0.3
  want = smoke.expected_pcm(wav)
  assert want.dtype == np.int16 and np.abs(want).max() == 32767
  path = tmp_path / "a.wav"
  wavfile.write(path, 22050, want)
  assert smoke.pcm_mismatch(path, want, 22050) is None
  off = want.copy()
  off[500] += 1
  assert "1 samples differ, first at 500" in smoke.pcm_mismatch(path, off,
                                                                22050)
  assert smoke.pcm_mismatch(path, want, 16000) is not None
  assert smoke.pcm_mismatch(path, want[:-1], 22050) is not None
  wavfile.write(path, 22050, wav)  # float32 samples
  assert smoke.pcm_mismatch(path, want, 22050) is not None


def test_expected_train_launches(smoke):
  """Phase 10's ``train`` at full width: 2 steps of 96 layers, each with
  its remat recompute, and a validation batch at each of 2 saves: 576
  forward launches; in bf16 one backward-kernel call a layer a step (192),
  none in f32. A route without remat, or a save more, is flagged."""
  assert smoke.expected_train_launches(96, True, 2, 2, 1, True) == (576, 192)
  assert smoke.expected_train_launches(96, True, 2, 2, 1, False) == (576, 0)
  assert smoke.expected_train_launches(96, False, 2, 2, 1, False)[0] == 384
  assert smoke.expected_train_launches(96, True, 2, 3, 1, False)[0] == 672
  # phase 6's straight run: 6 steps, saves at 1, 3 and 6, 2 val batches
  assert smoke.expected_train_launches(96, True, 6, 3, 2, True) == (
      2 * 96 * 6 + 96 * 2 * 3, 96 * 6)


def test_expected_validate_launches(smoke):
  """A validated checkpoint costs its Synthesizer's bias capture and one
  synthesis an entry: 96 x 5 for phase 10's four entries; ``--select 2``
  over checkpoints 1-4 validates two."""
  assert smoke.expected_validate_launches(96, 4, 1) == 480
  assert smoke.expected_validate_launches(96, 4, 2) == 960
  assert smoke.expected_validate_launches(96, 4, 2) != 96 * 4 * 2


def test_validation_dirs_mismatch(smoke, tmp_path):
  """The iteration folders of a ``validate`` run against
  ``filter_checkpoints``: the newest alone without a filter, every second
  with ``--select 2``; a missing or extra folder is flagged, files are
  not folders."""
  out = tmp_path / "out"
  for it in (2, 4):
    (out / str(it)).mkdir(parents=True)
  (out / "total.csv").write_text("")
  assert smoke.validation_dirs_mismatch(out, [1, 2, 3, 4], select=2) is None
  assert smoke.validation_dirs_mismatch(out, [1, 2, 3, 4, 6],
                                        select=2) is not None
  assert smoke.validation_dirs_mismatch(out, [1, 2, 3, 4]) is not None
  assert smoke.validation_dirs_mismatch(out, [1, 2, 3, 4], min_it=2,
                                        max_it=4, select=2) is None
  last = tmp_path / "last"
  (last / "4").mkdir(parents=True)
  assert smoke.validation_dirs_mismatch(last, [1, 2, 3, 4]) is None
  assert smoke.validation_dirs_mismatch(last, [1, 2, 3, 5]) is not None


def test_validation_metrics_read_back_from_a_report(smoke, tmp_path):
  """The row check reads ``total.csv`` as written by ``write_tsv``: the
  metric columns of a report equal ``validation_metrics`` of its mels, and
  a mel off in one value changes them."""
  from waveglow_tpu_torch.eval.validation import write_tsv
  rng = np.random.default_rng(0)
  orig = rng.uniform(-11.0, 1.0, (80, 40)).astype(np.float32)
  inferred = (orig[:, :39] + rng.normal(0, 0.5, (80, 39))).astype(np.float32)
  want, seconds, labeled = smoke.validation_metrics(orig, inferred)
  from waveglow_tpu_torch.eval import metrics
  mcd_dtw, pen, frames = metrics.get_metrics_mels(orig, inferred)
  row = {"Iteration": 4, "# Difference frames": -1, "MFCC DTW MCD": mcd_dtw,
         "MFCC DTW PEN": pen, "# MFCC DTW frames": frames}
  row.update(zip(("MCD", "PEN", "# Frames"), metrics.get_metrics_mels(
      orig, inferred, use_dtw=False)))
  row["Cosine Similarity (Padded)"] = metrics.cosine_dist_mels(orig, inferred)
  row["Structural Similarity (Padded)"] = float(want[
      "Structural Similarity (Padded)"])
  write_tsv(tmp_path / "total.csv", [row])
  (got,) = smoke.read_tsv(tmp_path / "total.csv")
  assert {k: got[k] for k in want} == want
  assert sorted(seconds) == ["cosine_s", "mcd_dtw_s", "mcd_s", "render_s",
                             "ssim_s"]
  assert [img.shape for img in labeled] == [(500, 64, 3), (500, 62, 3)]
  inferred[3, 7] += 1.0
  assert smoke.validation_metrics(orig, inferred)[0] != want


def test_state_mismatch_names_each_difference(smoke, tmp_path):
  """A checkpoint saved by ``train()`` and read back equals its returned
  state; one bit of a param or an Adam leaf, the iteration and the
  settings are each flagged."""
  from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
  from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
  hp = overwrite_custom_hparams(HParams(), {"epochs": "2"})
  params = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": [np.ones(2, np.float32)]}
  opt = [np.array(4, np.int32), np.full(3, 0.5, np.float32)]
  from dataclasses import asdict
  CheckpointWaveglow(state_dict=params, optimizer=opt,
                     learning_rate=hp.learning_rate, iteration=4,
                     hparams=asdict(hp)).save(tmp_path / "4.npz")
  ckpt = CheckpointWaveglow.load(tmp_path / "4.npz")
  state = {"params": params, "opt_state": opt, "step": 4}
  assert smoke.state_mismatch(ckpt, state, hp) == []
  w = params["a"]["w"].copy()
  w[1, 2] = np.nextafter(w[1, 2], np.float32(10))   # one bit
  moved = [opt[0], opt[1].astype(np.float64)]
  assert smoke.state_mismatch(
      ckpt, {"params": {"a": {"w": w}, "b": params["b"]},
             "opt_state": moved, "step": 5},
      overwrite_custom_hparams(hp, {"epochs": "3"})) == [
      "params/a/w", "optimizer/1", "iteration 4 != 5", "hparams"]


# -- phase 11: sharded serving --------------------------------------------------

# As nvcc names them in the build (the f32 FFMA kernel and the bf16
# tensor-core one, each <C, C', last>).
SHARD_128 = ("_ZN50_GLOBAL__N__59f1e4f0_17_wn_layer_shard_cu_98e0463615wn_shard_"
             "kernelILi256ELi128ELb0EEEvPKfS2_S2_S2_S2_Pfiiii")
SHARD_MMA = ("_ZN50_GLOBAL__N__59f1e4f0_17_wn_layer_shard_cu_98e0463619wn_shard_"
             "kernel_mmaILi256ELi128ELb0EEEvPKfPK13__nv_bfloat16S5_S2_S5_Pfii")
# A rank's res/skip kernel at C = 512 in bf16 (csrc/wn_layer.cu's C = 512
# kernels at gate width C'), which ends its call and bears the name the
# mma.sync instance at C = 512 had.
SHARD_WIDE_RS = ("_ZN44_GLOBAL__N__0e86b78e_11_wn_layer_cu_4c7a5d2a18wn_layer_"
                 "kernel_rsILi256ELb0EEEvPKfPK13__nv_bfloat16S5_S2_PKiPfS8_iii")


@pytest.mark.parametrize("mangled,name", [
    (SHARD_128, "shard-f32,C=256,C'=128,layer"),
    (SHARD_128.replace("ILi256ELi128ELb0E", "ILi128ELi16ELb1E"),
     "shard-f32,C=128,C'=16,last"),
    (SHARD_WIDE_RS, "shard-bf16,C=512,C'=256,layer"),
    (SHARD_WIDE_RS.replace("ILi256ELb0E", "ILi64ELb1E"),
     "shard-bf16,C=512,C'=64,last"),
    (SHARD_MMA, "shard-bf16,C=256,C'=128,layer"),
    (SHARD_MMA.replace("ILi256ELi128ELb0E", "ILi256ELi32ELb1E"),
     "shard-bf16,C=256,C'=32,last")])
def test_shard_kernel_variant_names(smoke, mangled, name):
  assert smoke.kernel_variant(mangled) == name
  assert name in {smoke.shard_variant(*v) for v in smoke.SHARD_KERNELS}


def test_check_tensor_cores_holds_the_f32_shard_kernel(smoke):
  """The f32 shard kernel (FFMA) must have no tensor-core instruction and
  the bf16 one (mma.sync) some."""
  smoke.check_tensor_cores({"shard-bf16,C=256,C'=64,layer": 2,
                            "shard-f32,C=256,C'=64,layer": 0},
                           ["shard-bf16,C=256,C'=64,layer",
                            "shard-f32,C=256,C'=64,layer"])
  with pytest.raises(SystemExit, match="tensor-core"):
    smoke.check_tensor_cores({"shard-f32,C=256,C'=64,layer": 3},
                             ["shard-f32,C=256,C'=64,layer"])
  with pytest.raises(SystemExit, match="no HMMA/HGMMA"):
    smoke.check_tensor_cores({"shard-bf16,C=256,C'=64,layer": 0},
                             ["shard-bf16,C=256,C'=64,layer"])


def shard_attributes(name, local_bytes):
  return {name: {"registers": 160, "local_bytes": local_bytes,
                 "static_smem_bytes": 0, "dynamic_smem_bytes": 196_352}}


@pytest.mark.parametrize("fault", [None, "local bytes", "ptxas spills"])
def test_check_no_spills_holds_the_f32_shard_kernels(smoke, fault):
  """A shard-f32 variant fails on local bytes in the loaded build or on
  spills in ptxas's report, as the f32 forward does."""
  name = "shard-f32,C=512,C'=256,layer"
  ptxas = {name: {"spill_store_bytes": 0, "spill_load_bytes": 0}}
  attrs = shard_attributes(name, 8 if fault == "local bytes" else 0)
  if fault == "ptxas spills":
    ptxas[name]["spill_store_bytes"] = 8
  if fault is None:
    smoke.check_no_spills(ptxas, attrs)
    smoke.check_no_spills(None, attrs)
    return
  with pytest.raises(SystemExit, match=f"{name} kernel spills"):
    smoke.check_no_spills(ptxas, attrs)


def test_check_no_spills_leaves_the_bf16_shard_kernels(smoke):
  """A shard-bf16 variant on mma.sync (C <= 256) with local bytes and
  ptxas spills passes: those bf16 variants are not held to the rule; the
  C = 512 ones, wgmma, are (test_wgmma_is_demanded_of_the_rank_kernels)."""
  for name in ("shard-bf16,C=256,C'=128,layer", "shard-bf16,C=128,C'=16,last"):
    ptxas = {name: {"spill_store_bytes": 16, "spill_load_bytes": 16}}
    smoke.check_no_spills(ptxas, shard_attributes(name, 24))
    smoke.check_no_spills(None, shard_attributes(name, 24))


def test_shard_f32_grid_reads_each_instance(smoke, monkeypatch):
  """Phase 2's report of the f32 shard kernel: every f32 instance (18),
  its loaded build beside its grid at B=1, T=T_KERNEL, and no bf16 one."""
  seen = []

  def schedule(batch, t, last=False, channels=256, cp=None):
    seen.append((batch, t, channels, cp, last))
    return {"sms": 132, "blocks_per_sm": 1, "blocks": 127,
            "rows_per_block": 208, "tile_rows": 48, "quantum": 16,
            "tiles_per_block": 5, "waves": 127 / 132}
  monkeypatch.setattr(smoke.kl, "f32_schedule", schedule)
  attrs = {smoke.shard_variant(*v): {"registers": 100 + i, "local_bytes": 0}
           for i, v in enumerate(smoke.SHARD_KERNELS)}
  info = smoke.shard_f32_grid(attrs)
  assert len(info) == 18 and all(k.startswith("shard-f32") for k in info)
  rec = info["shard-f32,C=512,C'=256,last"]
  assert rec["registers"] == attrs["shard-f32,C=512,C'=256,last"][
      "registers"]
  assert rec["tile_rows"] == 48 and rec["blocks"] == 127
  assert sorted(seen) == sorted((1, smoke.T_KERNEL, c, cp, last)
                                for c, cp in smoke.kl.shard_pairs()
                                for last in (False, True))


def test_shard_f32_earlier_times_cover_every_pair(smoke):
  """The read-out of the f32 shard kernel's earlier times has one entry
  a built pair, each a positive time in ms."""
  assert set(smoke.SHARD_F32_EARLIER_MS) == set(smoke.kl.shard_pairs())
  assert all(0 < ms < 10 for ms in smoke.SHARD_F32_EARLIER_MS.values())


def test_shard_extra_keys_list_each_other_cp(smoke):
  """A shard entry of the kernels line carries each other C''s times and
  bound beside the top one, all measured in the run: the f32 kernel's
  earlier time, which the shard check prints, stays out of it."""
  timed = {cp: {"kernel_ms": cp / 1000, "plain_ms": 1.0, "library_ms": 2.0,
                "bound_ms": 0.1, "earlier_ms": cp / 100, "flops": 7}
           for cp in (128, 64, 32)}
  keys = smoke.shard_extra_keys(timed, 128)
  assert keys["kernel_ms_C'64"] == 0.064 and keys["bound_ms_C'32"] == 0.1
  assert "kernel_ms_C'128" not in keys and "flops_C'64" not in keys
  assert not any("earlier" in k for k in keys)
  assert len(keys) == 8


@pytest.mark.parametrize("cp", [128, 64, 32])
def test_shard_cost_at_the_kernel_phase_shape(smoke, cp):
  """FLOPs 2 * B * T * (768 * 2C' + C' * 512); bytes x, cond_s, the
  weights and the partial once each; f32 operation-bound at C' = 128."""
  t = smoke.T_KERNEL
  nbytes, flops, bound_ms, bound_by = smoke.shard_cost(1, t, cp, False,
                                                       "f32", 256)
  assert flops == 2 * t * (768 * 2 * cp + cp * 512)
  assert nbytes == (t * 256 * 4 + t * 2 * cp * 4
                    + (768 * 2 * cp + cp * 512) * 4 + 2 * cp * 4
                    + t * 512 * 4)
  assert bound_ms == pytest.approx(max(nbytes / 3.35e9, flops / 67e9))
  if cp == 128:
    assert bound_by == "operations"
  _, _, bf16_ms, bf16_by = smoke.shard_cost(1, t, cp, False, "bf16", 256)
  assert bf16_by == "bytes" and bf16_ms < bound_ms
  _, last_flops, _, _ = smoke.shard_cost(1, t, cp, True, "f32", 256)
  assert last_flops == 2 * t * (768 * 2 * cp + cp * 256)


def test_expected_mesh_launches_per_axis(smoke):
  """96 layers a synthesis: a data axis runs one synthesis a row group
  (the first device alone when the rows do not divide), a time axis one a
  non-empty span, a model axis the shard kernel once a rank and layer."""
  assert smoke.expected_mesh_launches("data", 4, 8, 826, 96) == {
      "fused": 384, "shard": 0}
  assert smoke.expected_mesh_launches("data", 4, 1, 826, 96) == {
      "fused": 96, "shard": 0}
  assert smoke.expected_mesh_launches("time", 4, 1, 3301, 96) == {
      "fused": 384, "shard": 0}
  assert smoke.expected_mesh_launches("time", 4, 1, 3, 96) == {
      "fused": 288, "shard": 0}
  assert smoke.expected_mesh_launches("model", 2, 4, 826, 96) == {
      "fused": 0, "shard": 192}
  with pytest.raises(ValueError, match="axis"):
    smoke.expected_mesh_launches("pipeline", 2, 1, 826, 96)


@pytest.mark.parametrize("frames,n", [(3304, 2), (3304, 4), (3301, 4),
                                      (3301, 2), (3, 4)])
def test_time_split_and_stitch(smoke, frames, n):
  """The spans and halo windows phase 11 runs at full width (100-frame
  halo) pass the stitch predicate; a gap, an overlap, a short halo and an
  uneven split are each flagged."""
  from waveglow_tpu_torch.parallel.time_shard import span_windows
  windows = span_windows(frames, n, 100)
  assert smoke.stitch_faults(windows, frames, 100) == []
  if frames > n:
    (s0, e0, lo0, hi0), *rest = windows
    gap = [(s0, e0 - 1, lo0, min(frames, e0 - 1 + 100))] + rest
    assert any("expected" in f for f in smoke.stitch_faults(gap, frames,
                                                            100))
    short = [(s0, e0, lo0, hi0 - 1)] + rest
    assert smoke.stitch_faults(short, frames, 100)
  uneven = [(0, frames - 1, 0, frames), (frames - 1, frames, 0, frames)]
  if frames > 3:
    assert any("differ" in f for f in smoke.stitch_faults(uneven, frames,
                                                          frames))


# -- phase 12: the other widths ------------------------------------------------

def test_phase_12_drives_every_other_built_width(smoke):
  assert smoke.WIDE_WIDTHS == (128, 512)
  assert set(smoke.WIDTH_DESIGN) == set(smoke.WIDE_WIDTHS)
  forward = {smoke.variant(*v) for v in smoke.FORWARD_KERNELS}
  assert len(forward) == 12 and "bf16,C=512,last" in forward
  shard = {smoke.shard_variant(*v) for v in smoke.SHARD_KERNELS}
  assert len(shard) == 36 and "shard-bf16,C=128,C'=16,layer" in shard


@pytest.mark.parametrize("width", [128, 512])
def test_layer_cost_scales_with_the_width(smoke, width):
  """At width C: flops 2 * rows * C * (3 * 2C + 2C); bytes x, cond, the
  weights, the biases, valid_t and skip_acc read, x' and skip written (at
  512 in bf16 also the bf16 copy of x, written and read). f32 is bound by
  operations at every width; bf16 by bytes at 128 and by operations at 512
  (4x the flops of 256 for 2x the bytes)."""
  rows = smoke.T_KERNEL
  nbytes, flops, bound_ms, by = smoke.layer_cost(1, rows, False, "bf16",
                                                 width)
  assert flops == 2 * rows * width * 8 * width
  assert nbytes == (rows * width * 4 + rows * 2 * width * 2
                    + 8 * width * width * 2 + 4 * width * 4 + 4
                    + 3 * rows * width * 4
                    + (2 * rows * width * 2 if width == 512 else 0))
  assert bound_ms == pytest.approx(max(nbytes / 3.35e9, flops / 989e9))
  assert by == ("bytes" if width == 128 else "operations")
  _, _, _, by32 = smoke.layer_cost(1, rows, False, "f32", width)
  assert by32 == "operations"


@pytest.mark.parametrize("width,cp", [(128, 16), (512, 256)])
def test_shard_cost_at_other_widths(smoke, width, cp):
  t = smoke.T_KERNEL
  _, flops, _, _ = smoke.shard_cost(1, t, cp, False, "bf16", width)
  assert flops == 2 * t * (3 * width * 2 * cp + cp * 2 * width)
  cost = smoke.trainable_cost(False, "bf16", width)
  assert cost["bwd_flops"] == 2 * 24_000 * (2 * width * 2 * width
                                            + 2 * 3 * width * 2 * width)


# -- phase 13: mesh training ------------------------------------------------------

_SBWD = "_ZN54_GLOBAL__N__05726558_21_wn_layer_shard_bwd_cu_3e1b28cf"
SBWD_ROWS = (_SBWD + "19wn_sbwd_rows_kernelILi256ELi128ELb0EEEvPKfPK13__nv_"
             "bfloat16S5_S2_S5_S2_PS3_S6_S6_S6_Pfii")


@pytest.mark.parametrize("mangled,name", [
    (SBWD_ROWS, "bf16,C=256,C'=128,sbwd-rows,layer"),
    (SBWD_ROWS.replace("ILi256ELi128ELb0E", "ILi128ELi16ELb1E"),
     "bf16,C=128,C'=16,sbwd-rows,last"),
    (_SBWD + "17wn_sbwd_dx_kernelILi512ELi256EEEvPK13__nv_bfloat16S3_Pfiii",
     "bf16,C=512,C'=256,sbwd-dx"),
    (_SBWD + "22wn_sbwd_weights_kernelILi256ELi32EEEvPK13__nv_bfloat16S3_S3_"
     "S3_Pfiiiii", "bf16,C=256,C'=32,sbwd-weights"),
    (_SBWD + "21wn_sbwd_reduce_kernelILi128ELi64EEEvPKfiS2_iiP13__nv_"
     "bfloat16S4_Pf", "reduce,C=128,C'=64,sbwd")])
def test_shard_backward_variant_names(smoke, mangled, name):
  """Each shard-backward kernel's mangled name maps to the variant phase 2
  queries from the runtime; the backward's own kernels keep theirs."""
  assert smoke.kernel_variant(mangled) == name
  assert name in {smoke.shard_bwd_variant(*v)
                  for v in smoke.SHARD_BWD_KERNELS}
  assert smoke.kernel_variant(BWD_DX) == "bf16,C=256,bwd-dx"


def test_shard_backward_kernels_are_held_to_the_tensor_cores(smoke):
  """Every pair's rows (both variants), dx and weights kernels must have
  HMMA/HGMMA; the reduce kernel is held to neither."""
  variants = [smoke.shard_bwd_variant(*v) for v in smoke.SHARD_BWD_KERNELS]
  assert len(variants) == 9 * 5
  mma = {name: (0 if name.startswith("reduce") else 12) for name in variants}
  smoke.check_tensor_cores(mma, variants)
  mma["bf16,C=128,C'=16,sbwd-weights"] = 0
  with pytest.raises(SystemExit):
    smoke.check_tensor_cores(mma, variants)


@pytest.mark.parametrize("width,cp,bound_ms,by", [
    (256, 128, 0.0370, "bytes"), (512, 256, 0.1018, "operations"),
    (128, 16, 0.0156, "bytes")])
def test_shard_backward_cost(smoke, width, cp, bound_ms, by):
  """At B=12, T=2,000, d=1, non-last: products 2 * R * (2 * n_rs * C' +
  2 * 3C * 2C') (dacts, dw_rs, dw_in, the taps' adjoint; 25.2 GFLOP at
  (256, 128), 100.7 at (512, 256)); bytes x, dx, g, cond_s, dcond_s, the
  weights and their gradients once each."""
  rows = smoke.B_TRAIN * smoke.T_TRAIN
  cost = smoke.shard_bwd_cost(smoke.B_TRAIN, smoke.T_TRAIN, width, cp, False,
                              "bf16")
  assert cost["flops"] == 2 * rows * (2 * 2 * width * cp
                                      + 2 * 3 * width * 2 * cp)
  assert cost["bytes"] == (2 * rows * width * 4 + 2 * rows * 2 * cp * 2
                           + 2 * (3 * width * 2 * cp + cp * 2 * width) * 2
                           + 2 * 2 * cp * 4 + rows * 2 * width * 4)
  assert cost["bound_ms"] == pytest.approx(bound_ms, abs=1e-4)
  assert cost["bound_by"] == by
  f32 = smoke.shard_bwd_cost(smoke.B_TRAIN, smoke.T_TRAIN, width, cp, False,
                             "f32")
  assert f32["bound_by"] == "operations" and f32["bound_ms"] > bound_ms


def test_expected_mesh_train_launches(smoke):
  """A step runs each data replica's forward twice with remat (the flow's
  recompute): a model group launches the shard kernel once a rank and
  layer and, in bf16, the shard backward once a rank and layer, and never
  the full layer's kernels; a model = 1 replica runs the full layer's."""
  assert smoke.expected_mesh_train_launches(1, 2, "bf16", 96) == {
      "fused": 0, "backward": 0, "shard": 384, "shard_backward": 192}
  assert smoke.expected_mesh_train_launches(2, 2, "f32", 96) == {
      "fused": 0, "backward": 0, "shard": 768, "shard_backward": 0}
  assert smoke.expected_mesh_train_launches(2, 1, "bf16", 96) == {
      "fused": 384, "backward": 192, "shard": 0, "shard_backward": 0}
  # three steps and two validation batches (no remat there)
  assert smoke.expected_mesh_train_launches(
      2, 2, "bf16", 96, steps=3, evals=2) == {
          "fused": 0, "backward": 0, "shard": 2 * 96 * 8 * 2,
          "shard_backward": 2 * 96 * 3 * 2}
  assert smoke.expected_mesh_train_launches(1, 2, "bf16", 96,
                                            remat=False)["shard"] == 192


def test_phase_13_meshes_and_kernels_line_keys(smoke):
  """Phase 13 drives the (1, 2), (2, 1) and (2, 2) meshes and the kernels
  line's entries carry every key of the contract."""
  assert smoke.MESH_TRAIN == ((1, 2), (2, 1), (2, 2))
  assert smoke.MESH_WIDE == 512 and (512, 256) in smoke.kl.shard_pairs()
  source = (ROOT / "chip_smoke.py").read_text()
  start = source.index("# phase 13: the trainable shard")
  block = source[start:source.index("args.out.mkdir", start)]
  for key in ("name", "route", "source", "replaces", "launches",
              "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms"):
    assert f'"{key}"' in block or f"{key}=" in block, key


def test_phase_13_rehearses_a_model_mesh_on_the_cpu(smoke, monkeypatch,
                                                    tmp_path):
  """Phase 13(b) on a tiny model, f32, a (1, 2) mesh of the CPU: the
  step against the unsharded one, the launch counts (the CPU's plain
  versions counted in the kernels' place), train() with saves at 1 and
  2, the resume bit for bit and the checkpoint resumed unsharded."""
  import dataclasses
  from waveglow_tpu_torch.checkpointing.from_jax import (
      trainable_params_from_numpy, tree_leaves)
  from waveglow_tpu_torch.dsp.mel import MelSTFT
  from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
  from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, init_params
  from waveglow_tpu_torch.training import step as train_lib
  from waveglow_tpu_torch.training.data import SegmentDataset
  kl = smoke.kl
  monkeypatch.setattr(smoke, "DEVICE", "cpu")
  for name, fn in (("synchronize", lambda *a, **k: None),
                   ("empty_cache", lambda: None),
                   ("reset_peak_memory_stats", lambda *a, **k: None),
                   ("max_memory_allocated", lambda *a, **k: 0)):
    monkeypatch.setattr(torch.cuda, name, fn)
  monkeypatch.setattr(smoke, "logical_devices", lambda n: ["cpu"] * n)

  class NoTrace:  # the CPU has no CUDA activity to trace
    def __init__(self, activities):
      pass

    def __enter__(self):
      return self

    def __exit__(self, *exc):
      return False

    def events(self):
      return []

  monkeypatch.setattr(torch.profiler, "profile", NoTrace)
  monkeypatch.setattr(smoke, "B_TRAIN", 4)
  monkeypatch.setattr(smoke, "N_WAVS", 8)
  shard_plain = kl.wn_layer_shard_plain

  def counted(*args, **kwargs):
    kl.SHARD_LAUNCHES += 1
    return shard_plain(*args, **kwargs)

  monkeypatch.setattr(kl, "wn_layer_shard_plain", counted)
  custom = {"batch_size": "4", "iters_per_checkpoint": "2",
            "epochs_per_checkpoint": "0", "n_flows": "2", "n_layers": "2",
            "n_channels": "32", "segment_length": "2048", "seed": "3"}
  hp = overwrite_custom_hparams(HParams(), custom)
  config = WaveGlowConfig.from_hparams(hp)
  params_np = init_params(config, seed=3)
  for flow in params_np["flows"]:
    flow["wn"]["end"]["w"] = flow["wn"]["end"]["w"] + 0.02
  entries = smoke.write_wavs(tmp_path / "wavs", 3)
  batch = torch.from_numpy(SegmentDataset(entries, hp).batch(range(4), 0))
  params = trainable_params_from_numpy(params_np, "cpu")
  ref_loss = float(train_lib.compute_grads(
      train_lib.make_loss_fn(config, hp, MelSTFT(hp, "cpu")), params, batch))
  ref = (ref_loss, [p.grad.detach() for p in tree_leaves(params)])
  rec = smoke.mesh_train_case("f32", custom, hp, config, params_np, batch,
                              ref, 1, 2, entries, entries[:4], tmp_path)
  assert rec["step_launches"] == {"fused": 0, "backward": 0, "shard": 16,
                                  "shard_backward": 0}
  # 4 layers x 2 ranks x (3 steps with remat + 2 validation batches)
  assert rec["train_launches"]["shard"] == 4 * 2 * (2 * 3 + 2)
  assert rec["resume_bitwise"] and rec["grad_norm_rel"] < 1e-5
  assert rec["device_busy_ms"] == "not measured"
  assert len(rec["losses"]) == smoke.MESH_TRAIN_STEPS
  assert not (tmp_path / "ck").exists()


# -- the redesigned bf16 kernels (the whole layer's backward, the C = 512
# forward): their names, the wgmma rule and the per-kernel split --------

_FWD_OBJ = "_ZN44_GLOBAL__N__0e86b78e_11_wn_layer_cu_4c7a5d2a"


@pytest.mark.parametrize("mangled,want", [
    (_BWD + "18wn_bwd_prep_kernelILi512ELb1EEEvPKfS2_S2_PKiP13__nv_bfloat16"
     "S6_Pfi", "prep,C=512,bwd,last"),
    (_BWD + "18wn_bwd_rows_kernelILi128ELb0EEEvPK13__nv_bfloat16S3_S3_PKfS3_"
     "S3_PS1_S6_Pfii", "bf16,C=128,bwd-rows,layer"),
    (_BWD + "16wn_bwd_dx_kernelILi256EEEvPK13__nv_bfloat16S3_PfPKfPKiiii",
     "bf16,C=256,bwd-dx"),
    (_BWD + "21wn_bwd_reduce_kernelILi512EEEvPKfiS1_iiP13__nv_bfloat16S3_PfS4_",
     "reduce,C=512,bwd"),
    (_FWD_OBJ + "20wn_layer_kernel_gateILi512EEvPK13__nv_bfloat16S2_S2_PKfPS0_"
     "iii", "bf16,C=512,gate"),
    (_FWD_OBJ + "18wn_layer_kernel_rsILi512ELb1EEEvPKfPK13__nv_bfloat16S5_S2_"
     "PKiPfS8_iii", "bf16,C=512,last"),
    (_FWD_OBJ + "20wn_layer_kernel_gateILi128EEvPK13__nv_bfloat16S2_S2_PKfPS0_"
     "iii", "shard-bf16,C=512,C'=128,gate"),
    (_FWD_OBJ + "18wn_layer_kernel_rsILi64ELb0EEEvPKfPK13__nv_bfloat16S5_S2_"
     "PKiPfS8_iii", "shard-bf16,C=512,C'=64,layer"),
    (_FWD_OBJ + "21wn_layer_kernel_roundEPKfP13__nv_bfloat16l",
     "round,C=512,fwd")])
def test_kernel_variant_names_the_redesigned_kernels(smoke, mangled, want):
  assert smoke.kernel_variant(mangled) == want


def test_wgmma_is_demanded_of_the_redesigned_kernels(smoke):
  """Phase 2 holds the whole layer's rows, dx and weights kernels at every
  width and the C = 512 forward's gate and res/skip kernels to HGMMA, no
  serialized wgmma and no spill; the prep, reduce and rounding kernels
  and the C <= 256 forward are not held."""
  held = [smoke.bwd_variant(k, last, w) for k, last, w in smoke.BWD_KERNELS
          if k in ("rows", "dx", "weights")]
  held += ["bf16,C=512,layer", "bf16,C=512,last", "bf16,C=512,gate"]
  free = ["bf16,C=256,layer", "bf16,C=128,last", "round,C=512,fwd",
          "reduce,C=512,bwd", "prep,C=128,bwd,last"]
  assert len(held) == 3 * 4 + 3
  assert all(smoke.held_to_wgmma(n) for n in held)
  assert not any(smoke.held_to_wgmma(n) for n in free)
  hgmma = {**dict.fromkeys(held, 8), **dict.fromkeys(free, 0)}
  smoke.check_wgmma(hgmma, set(), held + free)  # passes
  for name in held:
    with pytest.raises(SystemExit, match="no wgmma"):
      smoke.check_wgmma({**hgmma, name: 0}, set(), held + free)
  with pytest.raises(SystemExit, match="serialized"):
    smoke.check_wgmma(hgmma, {"bf16,C=512,gate"}, held + free)
  with pytest.raises(SystemExit, match="spills"):
    smoke.check_no_spills(None, {"bf16,C=512,bwd-rows,layer": {
        "registers": 200, "local_bytes": 16}})


def test_phase2_lists_every_kernel_of_the_new_designs(smoke):
  """Phase 2's attribute list holds the whole layer's five kernels at every
  width (rows and prep in both variants) and the C = 512 gate kernel and
  rounding of x; a rank's backward has no prep kernel."""
  names = {smoke.bwd_variant(*v) for v in smoke.BWD_KERNELS}
  for w in kl.kernel_widths():
    for k in ("dx", "weights"):
      assert f"bf16,C={w},bwd-{k}" in names
    assert f"reduce,C={w},bwd" in names
    for end in ("layer", "last"):
      assert f"bf16,C={w},bwd-rows,{end}" in names
      assert f"prep,C={w},bwd,{end}" in names
  assert len(names) == 7 * len(kl.kernel_widths())
  assert [smoke.wide_variant(*k) for k in smoke.WIDE_KERNELS] == [
      "bf16,C=512,gate", "round,C=512,fwd", "shard-bf16,C=512,C'=256,gate",
      "shard-bf16,C=512,C'=128,gate", "shard-bf16,C=512,C'=64,gate"]
  assert {k for k, *_ in smoke.SHARD_BWD_KERNELS} == {
      "rows", "dx", "weights", "reduce"}


class _SplitTrace:
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
  """Phases 5 and 12's per-kernel split: each kernel's mean device time over
  the launches the trace holds (a trace that lost launches late in a long
  process still gives each launch's time); a trace without one of the
  expected kernels is taken again, 6 times in all, then "not measured"."""
  import torch
  monkeypatch.setattr(torch.profiler, "profile", _SplitTrace)
  monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
  names = [f"void (anonymous namespace)::wn_bwd_{k}_kernel<512>(...)"
           for k in kl.BWD_KERNELS]
  trace = [(n, 0.5 * (i + 1)) for _ in range(kept) for i, n in enumerate(names)]
  traces = []

  def device_kernels(prof):
    traces.append(prof)
    return trace[1:] if kept == 10 else trace

  monkeypatch.setattr(smoke, "device_kernels", device_kernels)
  got = smoke.kernel_split(lambda: None, smoke.BWD_SPLIT, len(kl.BWD_KERNELS))
  assert len(traces) == (6 if kept == 0 else 1)
  if kept == 0:
    assert got == "not measured"
  else:
    assert got == pytest.approx(
        {k: 0.5 * (i + 1) for i, k in enumerate(kl.BWD_KERNELS)})


# -- the C = 512 redesigns: a rank's bf16 share on the layer's wgmma
# kernels, and the f32 layer's acts through a global scratch ---------------

RANKS_512 = tuple(cp for c, cp in kl.shard_pairs() if c == kl.WIDE_C)


def test_wgmma_is_demanded_of_the_rank_kernels(smoke):
  """Phase 2 holds a rank's gate and res/skip kernels at C = 512 (bf16) to
  HGMMA, no serialized wgmma and no spill, as the layer's; the mma.sync
  shard kernels at C <= 256 and the f32 shard kernels are not held."""
  held = [f"shard-bf16,C=512,C'={cp},{k}" for cp in RANKS_512
          for k in ("gate", "layer", "last")]
  free = ["shard-bf16,C=256,C'=128,layer", "shard-bf16,C=128,C'=16,last",
          "shard-f32,C=512,C'=256,layer", "round,C=512,fwd"]
  assert len(held) == 9
  assert all(smoke.held_to_wgmma(n) for n in held)
  assert not any(smoke.held_to_wgmma(n) for n in free)
  hgmma = {**dict.fromkeys(held, 4), **dict.fromkeys(free, 0)}
  smoke.check_wgmma(hgmma, set(), held + free)
  for name in held:
    with pytest.raises(SystemExit, match="no wgmma"):
      smoke.check_wgmma({**hgmma, name: 0}, set(), held + free)
    with pytest.raises(SystemExit, match="serialized"):
      smoke.check_wgmma(hgmma, {name}, held + free)
    with pytest.raises(SystemExit, match="spills"):
      smoke.check_no_spills(None, shard_attributes(name, 8))


def test_phase2_lists_every_rank_kernel_at_512(smoke):
  """Phase 2's attribute names hold, for each rank C' at C = 512, its gate
  kernel (WIDE_KERNELS) and its res/skip kernel in both variants (the
  shard kernel's name, SHARD_KERNELS), and no other bf16 shard instance
  at 512; every one of them is held to wgmma."""
  names = {smoke.wide_variant(*k) for k in smoke.WIDE_KERNELS}
  names |= {smoke.shard_variant(*v) for v in smoke.SHARD_KERNELS}
  for cp in RANKS_512:
    for k in ("gate", "layer", "last"):
      assert f"shard-bf16,C=512,C'={cp},{k}" in names
  wide = {n for n in names if n.startswith("shard-bf16,C=512,")}
  assert len(wide) == 3 * len(RANKS_512)
  assert all(smoke.held_to_wgmma(n) for n in wide)


def test_width_design_names_each_mode(smoke):
  """The kernels line's design strings: one for each mode at each other
  width, the C = 512 f32 layer's naming its global acts scratch and
  4-stage ring, and the C = 512 bf16 shard's the layer's kernels at gate
  width C'."""
  for width in smoke.WIDE_WIDTHS:
    assert set(smoke.WIDTH_DESIGN[width]) == set(smoke.MODES)
  f32 = smoke.WIDTH_DESIGN[kl.WIDE_C]["f32"]
  assert "global f32 scratch" in f32 and "96-row tiles" in f32
  assert "wgmma" in smoke.WIDTH_DESIGN[kl.WIDE_C]["bf16"]
  assert "gate width C'" in smoke.SHARD_WIDE_DESIGN
  assert "mma.sync" in smoke.SHARD_DESIGN["bf16"]


def test_shard_extra_keys_carry_the_split_where_taken(smoke):
  """The C = 512 bf16 shard entry carries each other C''s round / gate /
  rs split beside its times; an entry without a split gets no such key."""
  split = {"round": 0.027, "gate": 0.06, "rs": 0.05}
  timed = {cp: {"kernel_ms": 0.1, "plain_ms": 1.0, "library_ms": 0.3,
                "bound_ms": 0.05, "kernels_ms": split} for cp in RANKS_512}
  keys = smoke.shard_extra_keys(timed, 256)
  assert keys["kernels_ms_C'128"] == split and keys["kernels_ms_C'64"] == split
  assert "kernels_ms_C'256" not in keys and len(keys) == 10


_F32W = "_ZN44_GLOBAL__N__0e86b78e_11_wn_layer_cu_4c7a5d2a"


@pytest.mark.parametrize("mangled,want", [
    (_F32W + "25wn_layer_kernel_f32_tilesILb0EEEvPKfS2_S2_S2_S2_S2_PKiPfS5_"
     "S5_iiiii", "f32,C=512,layer"),
    (_F32W + "25wn_layer_kernel_f32_tilesILb1EEEvPKfS2_S2_S2_S2_S2_PKiPfS5_"
     "S5_iiiii", "f32,C=512,last"),
    (_F32W + "24wn_layer_kernel_f32_restILb0EEEvPKfS2_S2_S2_S2_S2_PKiPfS5_"
     "S5_iiiii", "f32,C=512,rest,layer"),
    (_F32W + "24wn_layer_kernel_f32_restILb1EEEvPKfS2_S2_S2_S2_S2_PKiPfS5_"
     "S5_iiiii", "f32,C=512,rest,last")])
def test_kernel_variant_names_the_f32_kernels_at_512(smoke, mangled, want):
  """The f32 forward at C = 512 is two kernels: the tiles kernel bears the
  width's f32 variant names, the rest kernel its own; both are held to
  no tensor-core instruction and no spill, as every f32 kernel."""
  assert smoke.kernel_variant(mangled) == want
  with pytest.raises(SystemExit, match="tensor-core"):
    smoke.check_tensor_cores({want: 2}, [want])
  with pytest.raises(SystemExit, match="spills"):
    smoke.check_no_spills(None, {want: {"registers": 168, "local_bytes": 4}})


@pytest.mark.parametrize("mode,batch,width,rest,want", [
    ("f32", 1, 512, True, 2), ("f32", 8, 512, False, 1),
    ("bf16", 1, 512, True, 3), ("f32", 1, 256, True, 1),
    ("bf16", 8, 128, True, 1)])
def test_forward_kernels_counts_each_launch(smoke, monkeypatch, mode, batch,
                                            width, rest, want):
  """The per-kernel split expects the kernels one call launches: three in
  bf16 at C = 512, the f32 tiles kernel and the rest kernel where a block
  has a rest of 48 rows or fewer, else one."""
  monkeypatch.setattr(smoke.kl, "f32_schedule", lambda *a, **k: {
      "sms": 132, "blocks_per_sm": 1})
  monkeypatch.setattr(smoke.kl, "f32_rest_launched", lambda *a: rest)
  assert smoke.forward_kernels(mode, batch, width) == want


# -- phase 6's loader and normal-mel capture checks, rehearsed on the CPU ---

def tiny_train_hparams(smoke):
  return smoke.overwrite_custom_hparams(smoke.HParams(), {
      "n_flows": "2", "n_layers": "2", "n_channels": "32",
      "segment_length": "4096", "batch_size": "4"})


def test_loader_check_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
  """Phase 6's loader check at a small size: the batches of two epochs bit
  for bit, then LOADER_REPS timed batches each way over the LJSpeech-like
  folder (its files 1.5-10 s), the folder removed afterwards."""
  monkeypatch.setattr(smoke, "N_WAVS", 8)
  monkeypatch.setattr(smoke, "B_TRAIN", 4)
  monkeypatch.setattr(smoke, "LOADER_WAVS", 12)
  hp = tiny_train_hparams(smoke)
  entries = smoke.write_wavs(tmp_path / "wavs", 3)
  before = smoke.native.BATCHES
  rec = smoke.loader_check(entries, hp, 3, tmp_path)
  assert len(rec["native_ms"]) == len(rec["python_ms"]) == smoke.LOADER_REPS
  assert rec["timing_folder"]["files"] == 12
  low, high = rec["timing_folder"]["seconds_min_max"]
  assert smoke.LOADER_SECONDS[0] <= low <= high <= smoke.LOADER_SECONDS[1]
  # 2 epochs x 2 batches, then one batch a rep, through the loader
  assert smoke.native.BATCHES - before == 4 + smoke.LOADER_REPS
  assert not (tmp_path / "loader_wavs").exists()


@pytest.fixture
def tiny_capture(smoke, monkeypatch):
  """The CPU in the card's place: a tiny model for ``full_width_params``
  and ``wn_layer_plain`` counted in ``LAUNCHES`` (the CPU branch of
  ``wn_layer_fused`` calls it)."""
  from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, init_params
  hp = tiny_train_hparams(smoke)
  monkeypatch.setattr(smoke, "DEVICE", "cpu")
  monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

  def tiny_params(seed, width=32):
    params = init_params(WaveGlowConfig.from_hparams(hp), seed=seed)
    rng = np.random.default_rng(seed + 1)
    for flow in params["flows"]:
      end = flow["wn"]["end"]
      end["w"] = (rng.standard_normal(end["w"].shape) * 0.02).astype(
          np.float32)
    return params

  monkeypatch.setattr(smoke, "full_width_params", tiny_params)
  plain = kl.wn_layer_plain

  def counted(*args, **kwargs):
    kl.LAUNCHES += 1
    return plain(*args, **kwargs)

  monkeypatch.setattr(kl, "wn_layer_plain", counted)
  return hp


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_denoiser_check_rehearses_on_the_cpu(smoke, tiny_capture, mode):
  rec = smoke.denoiser_check(mode, 5, tiny_capture)
  assert rec["launches"] == 4  # 2 flows x 2 layers a capture
  assert rec["max_abs_err_vs_plain"] <= rec["bound"]
  assert rec["vs_zeros_max_abs"] > 0


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_denoiser_check_flags_a_capture_that_ignores_the_mel(
    smoke, tiny_capture, monkeypatch, mode):
  """A capture that runs the zeros mel whatever mel it is given fails the
  check: its bias is the zeros mel's."""
  capture = smoke.capture_bias

  def zeros_only(params, config, stft, mel, *args, **kwargs):
    return capture(params, config, stft, torch.zeros_like(mel), *args,
                   **kwargs)

  monkeypatch.setattr(smoke, "capture_bias", zeros_only)
  with pytest.raises(SystemExit):
    smoke.denoiser_check(mode, 5, tiny_capture)
