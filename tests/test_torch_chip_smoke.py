"""The yardstick and the build checks of ``chip_smoke.py``, on the CPU.

``layer_cost`` sets the bound every kernel time in PERF.md is read against;
``parse_ptxas``, ``count_mma`` and ``check_tensor_cores`` read the build's
ptxas log and SASS and must know each kernel variant's mangled name.
"""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
  spec = importlib.util.spec_from_file_location("chip_smoke",
                                                ROOT / "chip_smoke.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


# Mangled names of the four kernel instantiations (C=256 build).
F32_LAYER = ("_ZN12_GLOBAL__N_119wn_layer_kernel_f32ILb0EEEvPKfS2_S2_S2_S2_"
             "S2_PKiPfS5_iii")
F32_LAST = F32_LAYER.replace("ILb0EE", "ILb1EE")
MMA_LAYER = ("_ZN12_GLOBAL__N_119wn_layer_kernel_mmaILb0EEEvPKfPK13"
             "__nv_bfloat16S5_S2_S5_S2_PKiPfS8_iii")
MMA_LAST = MMA_LAYER.replace("ILb0EE", "ILb1EE")


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
      1, smoke.T_KERNEL, False, "bf16")
  assert got_flops == flops
  assert nbytes == 136_384_516
  assert bound_by == "bytes"
  assert bound_ms == pytest.approx(0.040712, rel=1e-4)
  nbytes32, flops32, bound32, by32 = smoke.layer_cost(
      1, smoke.T_KERNEL, False, "f32")
  assert flops32 == flops
  assert nbytes32 == nbytes + rows * 512 * 2 + 524_288 * 2  # 4-byte cond, w
  assert by32 == "operations"
  assert bound32 == pytest.approx(0.413640, rel=1e-4)


@pytest.mark.parametrize("mangled,name", [
    (F32_LAYER, "f32,layer"), (F32_LAST, "f32,last"),
    (MMA_LAYER, "bf16,layer"), (MMA_LAST, "bf16,last"),
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
  assert sorted(facts) == ["bf16,last", "bf16,layer", "f32,last",
                           "f32,layer"]
  assert facts["bf16,layer"] == {"spill_store_bytes": 8,
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
  assert counts == {"bf16,layer": 2, "bf16,last": 1, "f32,layer": 0,
                    "f32,last": 0}
  smoke.check_tensor_cores(counts, counts)  # passes


@pytest.mark.parametrize("fault", ["bf16 without mma", "f32 with mma",
                                   "variant missing"])
def test_check_tensor_cores_fails(smoke, fault):
  counts = smoke.count_mma(SASS)
  variants = list(counts)
  if fault == "bf16 without mma":
    counts["bf16,last"] = 0
  elif fault == "f32 with mma":
    counts["f32,layer"] = 3
  else:
    del counts["f32,last"]
  with pytest.raises(SystemExit, match="chip_smoke FAILED"):
    smoke.check_tensor_cores(counts, variants)
