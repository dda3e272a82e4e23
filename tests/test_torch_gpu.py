"""CUDA kernel tests: the fused WN-layer kernel against its plain PyTorch
version on the card. They need an NVIDIA card with nvcc and skip elsewhere.

This file imports no jax (the card's machine has none); run it there without
the repo's jax-configuring conftest:

  python -m pytest tests/test_torch_gpu.py -m gpu -p no:cacheprovider --noconftest
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from waveglow_tpu_torch.kernels import wn_layer as kl

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


def layer_inputs(device, batch, t, c, last, dtype, seed=0):
  rng = np.random.default_rng(seed)

  def rand(*shape, scale):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

  rs = c if last else 2 * c
  x = rand(batch, t, c, scale=0.5)
  cond = rand(batch, t, 2, c, scale=0.5).to(dtype)
  w_in = rand(3, c, 2 * c, scale=(3 * c) ** -0.5).to(dtype)
  b_in = rand(2 * c, scale=0.1)
  w_rs = rand(c, rs, scale=c ** -0.5).to(dtype)
  b_rs = rand(rs, scale=0.1)
  return x, cond, w_in, b_in, w_rs, b_rs


# The widths the kernels are built for.
WIDTHS = kl.kernel_widths()


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dilation,last", [(1, False), (64, False),
                                           (2, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain(cuda, dilation, last, bf16, c):
  batch, t = 2, 300  # ragged last tile
  dtype = torch.bfloat16 if bf16 else torch.float32
  cdt = torch.bfloat16 if bf16 else None
  args = layer_inputs(cuda, batch, t, c, last, dtype)
  valid = torch.tensor([t, t - 77], dtype=torch.int32, device=cuda)
  assert dilation < t - 77  # the taps reach across kept rows
  x = args[0] * (torch.arange(t, device=cuda)[None, :, None]
                 < valid[:, None, None])
  acc = torch.randn(batch, t, c, generator=torch.Generator().manual_seed(1)
                    ).to(cuda)
  before = kl.LAUNCHES
  xk, sk = kl.wn_layer_fused(x, *args[1:], dilation, valid_t=valid,
                             skip_acc=acc.clone(), compute_dtype=cdt)
  torch.cuda.synchronize()
  assert kl.LAUNCHES == before + 1
  xp, sp = kl.wn_layer_plain(x, *args[1:], dilation, valid_t=valid,
                             skip_acc=acc.clone(), compute_dtype=cdt)
  # f32: the K=3C sum is taken in another order; bf16: acts round to bf16 at
  # different points when an f32 ulp differs, so bound by the output scale
  for got, ref in ((xk, xp), (sk, sp)):
    err = (got - ref).abs().max().item()
    bound = 2e-2 * ref.abs().max().item() if bf16 else 1e-4
    assert err <= bound, (err, bound)
  assert (xk[1, t - 77:] == 0).all()


# Time rows per tile of each forward kernel: the bf16 tensor-core kernel's
# block at C <= 256, and the f32 kernel's tile (its blocks take whole shares
# of the B*T rows in such tiles, the last one short); the bf16 kernels at C
# = 512 take units of kl.WIDE_TILE_ROWS flat B*T rows. The bf16 backward's
# prep, rows and dx kernels work in 128-row tiles
# (test_bwd_schedule_reads_the_loaded_build reads them from the library).
ROW_TILE = {"bf16": 64, "f32": kl.F32_TILE_ROWS}
BWD_ROW_TILE = 128


def check_against_plain(device, batch, t, dilation, last, bf16, valid,
                        seed, c):
  """One launch with ``skip_acc`` and a per-row ``valid_t`` against
  wn_layer_plain at ``c`` channels, at the bounds of
  test_kernel_matches_plain; rows at and past valid_t must come out
  zero."""
  dtype = torch.bfloat16 if bf16 else torch.float32
  cdt = torch.bfloat16 if bf16 else None
  x, *rest = layer_inputs(device, batch, t, c, last, dtype, seed)
  valid = torch.tensor(valid, dtype=torch.int32, device=device)
  x = x * (torch.arange(t, device=device)[None, :, None]
           < valid[:, None, None])
  acc = torch.randn(batch, t, c,
                    generator=torch.Generator().manual_seed(seed)).to(device)
  xk, sk = kl.wn_layer_fused(x, *rest, dilation, valid_t=valid,
                             skip_acc=acc.clone(), compute_dtype=cdt)
  torch.cuda.synchronize()
  xp, sp = kl.wn_layer_plain(x, *rest, dilation, valid_t=valid,
                             skip_acc=acc.clone(), compute_dtype=cdt)
  for got, ref in ((xk, xp), (sk, sp)):
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    bound = 2e-2 * ref.abs().max().item() if bf16 else 1e-4
    assert err <= bound, (err, bound)
  for row, v in enumerate(valid.tolist()):
    assert (xk[row, v:] == 0).all()


@pytest.mark.parametrize("t,bf16", [
    (17, False), (17, True), (ROW_TILE["bf16"] + 1, False),
    (ROW_TILE["bf16"] + 1, True), (ROW_TILE["f32"] - 1, False),
    (ROW_TILE["f32"], False), (ROW_TILE["f32"] + 1, False), (5000, False)])
@pytest.mark.parametrize("c", WIDTHS)
def test_kernel_short_and_ragged_tiles(cuda, t, bf16, c):
  """T shorter than one row tile, one tile less one row, one tile, one tile
  plus one row; and f32 at T=5,000, where each block of the f32 kernel takes
  a full tile and a short one, and a tile holds the end of one sequence and
  the start of the next."""
  check_against_plain(cuda, 2, t, 2, False, bf16, [t, t - 5], seed=5, c=c)


@pytest.mark.parametrize("batch,t", [
    (1, kl.WIDE_TILE_ROWS - 1), (1, kl.WIDE_TILE_ROWS),
    (1, kl.WIDE_TILE_ROWS + 1), (2, kl.WIDE_TILE_ROWS // 2),
    (2, kl.WIDE_TILE_ROWS // 2 + 1), (3, 43)])
def test_wide_kernel_ragged_last_unit(cuda, batch, t):
  """The bf16 kernels at C = 512 walk units of WIDE_TILE_ROWS flat B*T
  rows: B*T one unit less one row, one unit, one unit plus one row (a
  1-row last unit, at B=1 and at B=3, where a unit holds the end of one
  sequence and the start of the next), and two sequences that fill one
  unit or spill two rows into a second."""
  valid = [t - 5 * (row % 2) for row in range(batch)]
  check_against_plain(cuda, batch, t, 2, False, True, valid, seed=5,
                      c=kl.WIDE_C)


@pytest.mark.parametrize("t,bf16", [
    pytest.param(300, False, id="False"), pytest.param(300, True, id="True"),
    pytest.param(ROW_TILE["f32"] * 2 + 1, False,
                 id=f"f32-{ROW_TILE['f32'] * 2 + 1}"),
    pytest.param(5000, False, id="f32-5000")])
@pytest.mark.parametrize("c", WIDTHS)
def test_kernel_widest_halo(cuda, t, bf16, c):
  """d=128: at T=300 and at two f32 tiles plus one row the taps reach past
  both ends of the sequence; the halo is wider than two f32 tiles, so a
  tile's taps come from other blocks' rows and the other sequence's rows
  read as zero; T=5,000 has blocks of two tiles."""
  check_against_plain(cuda, 2, t, 128, False, bf16, [t, t - 50], seed=6,
                      c=c)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_batch_with_one_valid_row(cuda, bf16, c):
  """B=8 with one row kept at valid_t=1."""
  valid = [300, 1, 299, 170, 64, 65, 300, 2]
  check_against_plain(cuda, 8, 300, 8, False, bf16, valid, seed=7, c=c)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dilation", [1, 128])
def test_kernel_last_layer(cuda, dilation, bf16, c):
  """The last-layer variant ([C, C] res/skip, x' = x)."""
  check_against_plain(cuda, 2, 200, dilation, True, bf16, [200, 133],
                      seed=8, c=c)


MODE_CASES = {"bf16": torch.bfloat16, "f32": None}


@pytest.mark.parametrize("last,mode", [
    pytest.param(False, "bf16", id="False"),
    pytest.param(True, "bf16", id="True"),
    pytest.param(False, "f32", id="f32-False"),
    pytest.param(True, "f32", id="f32-True")])
@pytest.mark.parametrize("c", WIDTHS)
def test_bf16_kernel_is_deterministic(cuda, last, mode, c):
  """Two launches of the kernel of each mode on the same inputs give the
  same bits (no atomics, no split K)."""
  cdt = MODE_CASES[mode]
  args = layer_inputs(cuda, 2, 1000, c, last, cdt or torch.float32, seed=9)
  acc = torch.randn(2, 1000, c,
                    generator=torch.Generator().manual_seed(9)).to(cuda)
  runs = [kl.wn_layer_fused(*args, 16, skip_acc=acc.clone(),
                            compute_dtype=cdt) for _ in range(2)]
  assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dilation,mode", [
    pytest.param(1, "bf16", id="1"), pytest.param(128, "bf16", id="128"),
    pytest.param(1, "f32", id="f32-1"), pytest.param(128, "f32", id="f32-128")])
@pytest.mark.parametrize("c", WIDTHS)
def test_bf16_kernel_repeats_bitwise_at_full_length(cuda, dilation, mode, c):
  """Many launches at B=1, T=26,432 (826 frames: 413 bf16 row tiles; f32
  blocks of four full tiles and a short one) give the bits of the first: a
  rarely corrupted tile (a ring slot or shared memory reused before every
  thread, or the tensor cores, are done with it) would show as a differing
  launch."""
  t = 26_432
  cdt = MODE_CASES[mode]
  args = layer_inputs(cuda, 1, t, c, False, cdt or torch.float32, seed=10)
  acc = torch.randn(1, t, c,
                    generator=torch.Generator().manual_seed(10)).to(cuda)
  first = kl.wn_layer_fused(*args, dilation, skip_acc=acc.clone(),
                            compute_dtype=cdt)
  for _ in range(64):
    again = kl.wn_layer_fused(*args, dilation, skip_acc=acc.clone(),
                              compute_dtype=cdt)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_kernel_without_accumulator(cuda):
  args = layer_inputs(cuda, 1, 333, 256, False, torch.float32, seed=2)
  xk, sk = kl.wn_layer_fused(*args, 4)
  xp, sp = kl.wn_layer_plain(*args, 4)
  torch.testing.assert_close(xk, xp, atol=1e-4, rtol=0)
  torch.testing.assert_close(sk, sp, atol=1e-4, rtol=0)


def test_kernel_rejects_bad_inputs(cuda):
  x, cond, w_in, b_in, w_rs, b_rs = layer_inputs(cuda, 1, 64, 256,
                                                 False, torch.float32)
  with pytest.raises(ValueError, match="dtype"):
    kl.wn_layer_fused(x, cond, w_in, b_in, w_rs, b_rs, 1,
                      compute_dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="contiguous"):
    kl.wn_layer_fused(x, cond.transpose(2, 3), w_in, b_in, w_rs, b_rs, 1)
  with pytest.raises(ValueError, match="valid_t"):
    kl.wn_layer_fused(x, cond, w_in, b_in, w_rs, b_rs, 1, valid_t=10)
  with pytest.raises(ValueError, match=r"C in \(128, 256, 512\), got C = 192"):
    kl.wn_layer_fused(x[..., :192].contiguous(), cond, w_in, b_in, w_rs,
                      b_rs, 1)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("last", [False, True])
def test_kernel_info_reads_the_loaded_build(cuda, bf16, last, c):
  info = kl.kernel_info(c, bf16, last)
  assert 0 < info["registers"] <= 255
  assert info["dynamic_smem_bytes"] > 48 * 1024  # needs the opt-in
  assert info["static_smem_bytes"] >= 0 and info["local_bytes"] >= 0
  if not bf16:
    # one wave of blocks, each a whole number of 16-row quanta, covering
    # B*T rows at the kernel phase's shapes
    for batch, t in ((1, 26_432), (8, 26_432), (12, 2_000), (2, 17)):
      grid = kl.f32_schedule(batch, t, last, channels=c)
      assert grid["blocks_per_sm"] >= 1 and grid["waves"] <= 1
      assert grid["rows_per_block"] % 16 == 0
      assert ((grid["blocks"] - 1) * grid["rows_per_block"] < batch * t
              <= grid["blocks"] * grid["rows_per_block"])


@pytest.mark.parametrize("dilation,last", [(1, False), (64, False),
                                           (2, True)])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("bf16", [False, True])
def test_trainable_grads_match_plain(cuda, dilation, last, bf16, c):
  """wn_layer_trainable on the card: the forward is one kernel launch equal
  to wn_layer_fused, and the six gradients (with a per-row valid_t) match
  autograd through wn_layer_plain. Each gradient within 1e-4 (f32) or 2e-2
  (bf16) of its own max |value|: the backward never reads the kernel's
  outputs, so f32 differs only by sums in other orders, and in bf16 the
  plain layer differentiates its bf16-rounded acts."""
  batch, t = 2, 300
  dtype = torch.bfloat16 if bf16 else torch.float32
  cdt = torch.bfloat16 if bf16 else None
  args = list(layer_inputs(cuda, batch, t, c, last, dtype, seed=3))
  valid = torch.tensor([t, t - 77], dtype=torch.int32, device=cuda)
  args[0] = args[0] * (torch.arange(t, device=cuda)[None, :, None]
                       < valid[:, None, None])
  args = [a.detach().clone().requires_grad_() for a in args]
  gen = torch.Generator(device=cuda).manual_seed(4)
  cot = [torch.randn(batch, t, c, generator=gen, device=cuda)
         for _ in range(2)]
  before = kl.LAUNCHES
  out = kl.wn_layer_trainable(*args, dilation, valid_t=valid,
                              compute_dtype=cdt)
  assert kl.LAUNCHES == before + 1
  fused = kl.wn_layer_fused(*[a.detach() for a in args], dilation,
                            valid_t=valid, compute_dtype=cdt)
  assert all(torch.equal(a, b) for a, b in zip(out, fused))
  grads = torch.autograd.grad(out, args, cot)
  plain = torch.autograd.grad(
      kl.wn_layer_plain(*args, dilation, valid_t=valid, compute_dtype=cdt),
      args, cot)
  tol = 2e-2 if bf16 else 1e-4
  for got, ref, arg in zip(grads, plain, args):
    assert got.dtype == arg.dtype and got.shape == arg.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_trainable_raises_on_bad_inputs(cuda):
  x, cond, w_in, b_in, w_rs, b_rs = layer_inputs(cuda, 1, 64, 256,
                                                 False, torch.float32)
  with pytest.raises(ValueError, match="dtype"):
    kl.wn_layer_trainable(x, cond, w_in, b_in, w_rs, b_rs, 1,
                          compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_kernel_route_matches_plain(cuda, compute_dtype):
  """One train step of a 2-flow, 2-layer, 256-channel model (ends
  randomised): loss and every leaf's gradient through the kernel against
  the plain route, loss 1e-5 (f32) / 1e-3 (bf16) abs, grads 1e-3 / 5e-2
  of each leaf's max |grad|; the step launches the kernel twice per layer
  (the forward and its remat recompute)."""
  from waveglow_tpu_torch.checkpointing.from_jax import (
      trainable_params_from_numpy, tree_leaves)
  from waveglow_tpu_torch.dsp.mel import MelSTFT
  from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
  from waveglow_tpu_torch.models.waveglow import WaveGlowConfig, init_params
  from waveglow_tpu_torch.training import step

  hp = overwrite_custom_hparams(HParams(), {
      "n_flows": "2", "n_layers": "2", "segment_length": "2048",
      "compute_dtype": compute_dtype})
  config = WaveGlowConfig.from_hparams(hp)
  params_np = init_params(config, seed=0)
  rng = np.random.default_rng(1)
  for flow in params_np["flows"]:
    for k in ("w", "b"):
      flow["wn"]["end"][k] = (rng.standard_normal(
          flow["wn"]["end"][k].shape) * 0.02).astype(np.float32)
  audio = torch.from_numpy(
      rng.uniform(-0.5, 0.5, (2, 2048)).astype(np.float32)).to(cuda)
  mel = MelSTFT(hp, device=cuda)
  results = []
  for layer in (kl.wn_layer_trainable, kl.wn_layer_plain):
    params = trainable_params_from_numpy(params_np, cuda)
    before = kl.LAUNCHES
    loss = step.compute_grads(step.make_loss_fn(config, hp, mel, layer),
                              params, audio)
    results.append((float(loss), [p.grad for p in tree_leaves(params)],
                    kl.LAUNCHES - before))
  (loss_k, grads_k, launches_k), (loss_p, grads_p, launches_p) = results
  assert launches_k == 2 * 2 * 2 and launches_p == 0
  bf16 = compute_dtype == "bfloat16"
  assert abs(loss_k - loss_p) <= (1e-3 if bf16 else 1e-5)
  for got, ref in zip(grads_k, grads_p):
    scale = ref.abs().max().item()
    assert scale > 0
    assert (got - ref).abs().max().item() <= (5e-2 if bf16 else 1e-3) * scale


# -- the bf16 backward kernels (csrc/wn_layer_bwd.cu) ------------------------

GRAD_NAMES = ("x", "cond", "w_in", "b_in", "w_rs", "b_rs")


def bwd_inputs(device, batch, t, dilation, last, valid, seed, drop=None,
               c=256):
  """The saved inputs of a bf16 layer at ``c`` channels (x zero at rows >=
  valid_t), the two cotangents (``drop`` of them None) and valid_t as the
  kernel takes it."""
  x, *rest = layer_inputs(device, batch, t, c, last, torch.bfloat16, seed)
  valid_t = None
  if valid is not None:
    valid_t = torch.tensor(valid, dtype=torch.int32, device=device)
    x = x * (torch.arange(t, device=device)[None, :, None]
             < valid_t[:, None, None])
  rng = np.random.default_rng(seed + 100)
  cots = [torch.from_numpy(rng.standard_normal((batch, t, c))
                           .astype(np.float32)).to(device) for _ in range(2)]
  if drop is not None:
    cots[drop] = None
  return (x, *rest), cots, valid_t


def check_bwd_against_plain(device, batch, t, dilation, last, valid, seed,
                            drop=None, c=256):
  """One call of the backward kernels (one count in BWD_LAUNCHES) against
  wn_layer_backward at the same rounding points: each gradient within 2e-2
  of its own max |value| (f32 sums in another order can flip one bf16
  rounding of a dgate or an act), in its input's dtype and shape."""
  saved, cots, valid_t = bwd_inputs(device, batch, t, dilation, last, valid,
                                    seed, drop, c)
  before = kl.BWD_LAUNCHES
  got = kl.wn_layer_backward_fused(saved, *cots, dilation, valid_t)
  torch.cuda.synchronize()
  assert kl.BWD_LAUNCHES == before + 1
  ref = kl.wn_layer_backward(saved, *cots, dilation, valid_t, torch.bfloat16)
  for name, g, r, arg in zip(GRAD_NAMES, got, ref, saved):
    assert g.dtype == arg.dtype and g.shape == arg.shape, name
    assert torch.isfinite(g).all(), name
    err = (g.float() - r.float()).abs().max().item()
    assert err <= 2e-2 * r.float().abs().max().item(), (name, err)
  return got


@pytest.mark.parametrize("dilation,last", [(1, False), (64, False),
                                           (128, False), (1, True),
                                           (128, True)])
@pytest.mark.parametrize("c", WIDTHS)
def test_bwd_kernel_matches_plain(cuda, dilation, last, c):
  """Every dilation's halo (d=128 reaches past both ends at T=300) and the
  last layer, with a per-row valid_t."""
  check_bwd_against_plain(cuda, 2, 300, dilation, last, [300, 223], seed=11,
                          c=c)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("t", [17, 65, BWD_ROW_TILE - 1, BWD_ROW_TILE,
                               BWD_ROW_TILE + 1])
def test_bwd_kernel_short_and_ragged_tiles(cuda, t, c):
  """T shorter than one row tile, one tile less one row, one tile, and one
  tile plus one row (a 1-row last tile of the prep, rows and dx kernels)."""
  check_bwd_against_plain(cuda, 2, t, 2, False, [t, t - 5], seed=12, c=c)


def test_bwd_kernel_batch_with_one_valid_row(cuda):
  """B=8 with one row kept at valid_t=1."""
  valid = [300, 1, 299, 170, 64, 65, 300, 2]
  check_bwd_against_plain(cuda, 8, 300, 8, False, valid, seed=13)


@pytest.mark.parametrize("drop,last", [(0, False), (1, False), (0, True),
                                       (1, True)])
def test_bwd_kernel_none_cotangents(cuda, drop, last):
  """A None dx_next or dskip is zero (the last layer with dskip None has
  zero gradients but dx)."""
  check_bwd_against_plain(cuda, 2, 200, 4, last, None, seed=14, drop=drop)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("last", [False, True])
def test_bwd_kernel_repeats_bitwise(cuda, last, c):
  """Two calls at the training shape (B=12, T=2,000) give the same bits:
  no atomics, every sum in a fixed order."""
  saved, cots, _ = bwd_inputs(cuda, 12, 2000, 1, last, None, seed=15, c=c)
  first = kl.wn_layer_backward_fused(saved, *cots, 1)
  again = kl.wn_layer_backward_fused(saved, *cots, 1)
  assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_bwd_kernel_rejects_bad_inputs(cuda):
  saved, cots, _ = bwd_inputs(cuda, 1, 64, 1, False, None, seed=16)
  x, cond, w_in, b_in, w_rs, b_rs = saved
  with pytest.raises(ValueError, match="dtype"):
    kl.wn_layer_backward_fused((x, cond, w_in.float(), b_in, w_rs, b_rs),
                               *cots, 1)
  with pytest.raises(ValueError, match="shape"):
    kl.wn_layer_backward_fused(saved, cots[0][:, :32], cots[1], 1)
  with pytest.raises(ValueError, match="dtype"):
    kl.wn_layer_backward_fused(saved, cots[0].to(torch.bfloat16), cots[1], 1)
  with pytest.raises(ValueError, match="valid_t"):
    kl.wn_layer_backward_fused(saved, *cots, 1, valid_t=10)
  with pytest.raises(ValueError, match=r"C in \(128, 256, 512\), got C = 192"):
    kl.wn_layer_backward_fused((x[..., :192].contiguous(), *saved[1:]),
                               *cots, 1)


@pytest.mark.parametrize("kernel,last", [("rows", False), ("rows", True),
                                         ("dx", False), ("weights", False),
                                         ("reduce", False), ("prep", False),
                                         ("prep", True)])
@pytest.mark.parametrize("c", WIDTHS)
def test_bwd_kernel_info_reads_the_loaded_build(cuda, kernel, last, c):
  info = kl.bwd_kernel_info(kernel, last, c)
  assert 0 < info["registers"] <= 255
  assert info["static_smem_bytes"] >= 0 and info["local_bytes"] >= 0
  assert (info["dynamic_smem_bytes"] > 48 * 1024) == (
      kernel not in ("reduce", "prep"))


# The whole layer's weights kernel's output tiles (non-last): dw_in's, then
# dw_rs^T's (tests/test_torch_bwd_plan.py holds the host side).
BWD_WEIGHT_TILES = {128: 5, 256: 16, 512: 64}


@pytest.mark.parametrize("c", WIDTHS)
def test_bwd_schedule_reads_the_loaded_build(cuda, c):
  """The library's tiles agree with the host's schedule: 128-row tiles of
  the rows and prep kernels, the weights kernel's output tiles; at B=12,
  T=2,000 its blocks fill at least one wave of the card."""
  lib = kl._library()
  assert lib.wn_layer_bwd_tile_rows(c, c) == 128
  tiles = lib.wn_layer_bwd_weight_tiles(c, c, 0)
  assert tiles == BWD_WEIGHT_TILES[c]
  assert lib.wn_layer_bwd_weight_tiles(c, c, 1) == tiles - c // 128 * max(
      1, c // 256)
  sms = torch.cuda.get_device_properties(cuda).multi_processor_count
  n_splits, _ = kl.bwd_splits(12, 2_000, tiles, sms)
  assert tiles * 12 * n_splits >= sms


# The gate widths of the C = 512 bf16 kernels: the layer's, then a rank's
# C' at model = 2, 4, 8.
WIDE_GATES = (kl.WIDE_C,) + tuple(cp for c, cp in kl.shard_pairs()
                                   if c == kl.WIDE_C)


@pytest.mark.parametrize("cp", WIDE_GATES)
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("batch,t", [(1, 26_432), (8, 26_432), (3, 65)])
def test_wide_schedule_is_the_host_grid(cuda, batch, t, last, cp):
  """The C = 512 bf16 forward's grid (the layer's and a rank's) as the
  library picks it is kl.wide_grid at the slots the card holds (one block
  an SM)."""
  got = kl.wide_schedule(batch, t, last, cp)
  sms = torch.cuda.get_device_properties(cuda).multi_processor_count
  assert got["slots"] == sms
  want = kl.wide_grid(batch, t, last, got["slots"], cp)
  assert {k: got[k] for k in ("tiles", "gate_blocks", "rs_blocks")} == {
      k: want[k] for k in ("tiles", "gate_blocks", "rs_blocks")}


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
def test_f32_schedule_is_the_host_grid(cuda, c, last):
  """The f32 forward kernel's grid as the library picks it is kl.f32_grid
  at the slots the card holds (at C = 512 each block owns the rows of the
  acts scratch it writes and reads back)."""
  for batch, t in ((1, 26_432), (8, 26_432), (4, 2_000), (2, 17)):
    got = kl.f32_schedule(batch, t, last, channels=c)
    want = kl.f32_grid(batch, t, got["sms"] * got["blocks_per_sm"])
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("cp", WIDE_GATES)
@pytest.mark.parametrize("kernel,last", [("gate", False), ("rs", False),
                                         ("rs", True), ("round", False)])
def test_wide_kernel_info_reads_the_loaded_build(cuda, kernel, last, cp):
  """Every C = 512 bf16 kernel, the layer's and each rank's, is in the
  loaded build, spills nothing and takes the ring's 196,608 bytes (the
  rounding of x none); a rank's res/skip kernel is its shard kernel's
  info."""
  info = kl.wide_kernel_info(kernel, last, cp)
  assert 0 < info["registers"] <= 255 and info["local_bytes"] == 0
  assert (info["dynamic_smem_bytes"] == 196_608) == (kernel != "round")
  if kernel == "rs" and cp < kl.WIDE_C:
    assert kl.shard_kernel_info(kl.WIDE_C, cp, True, last) == info


def test_trainable_bf16_backward_goes_through_the_kernel(cuda):
  """wn_layer_trainable's backward in bf16 on the card is one call of the
  backward kernels; in f32 it is the torch-ops route (no call)."""
  for cdt, calls in ((torch.bfloat16, 1), (None, 0)):
    dtype = cdt or torch.float32
    args = [a.requires_grad_() for a in
            layer_inputs(cuda, 2, 100, 256, False, dtype, seed=17)]
    out = kl.wn_layer_trainable(*args, 2, compute_dtype=cdt)
    before = kl.BWD_LAUNCHES
    torch.autograd.grad(out, args, [torch.ones_like(o) for o in out])
    assert kl.BWD_LAUNCHES == before + calls


# Streamed synthesis against one-call synthesis on the card at the kernel's
# width (2 flows x 4 layers x 256 channels, a 5-frame halo), relative to
# max |wav|.
STREAM_TOL_REL = {None: 1e-6, torch.bfloat16: 1e-6}


@pytest.fixture(scope="module")
def stream_model():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  from waveglow_tpu_torch.checkpointing.from_jax import params_from_numpy
  from waveglow_tpu_torch.models import waveglow as wg
  cfg = wg.WaveGlowConfig(n_flows=2, n_layers=4, n_channels=256)
  params = wg.init_params(cfg, seed=0)
  rng = np.random.default_rng(1)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.05).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.05).astype(np.float32)
  fused = params_from_numpy(params, "cuda")
  return cfg, {None: fused,
               torch.bfloat16: wg.params_for_compute(fused, torch.bfloat16)}


@pytest.mark.parametrize("frames,windows", [(70, 5), (12, 1)],
                         ids=["5-windows", "padded-window"])
@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_stream_matches_one_call_on_the_card(cuda, stream_model, frames,
                                             windows, cdt):
  from waveglow_tpu_torch.inference import streaming
  from waveglow_tpu_torch.models.waveglow import infer
  cfg, params = stream_model
  mel = np.random.default_rng(frames).uniform(
      -11.0, 1.0, (1, 80, frames)).astype(np.float32)
  ref = infer(params[cdt], cfg, mel, seed=3, compute_dtype=cdt).cpu().numpy()
  before = kl.LAUNCHES
  pieces = list(streaming.stream_chunks(params[cdt], cfg, mel, seed=3,
                                        chunk_frames=16, compute_dtype=cdt))
  assert kl.LAUNCHES - before == windows * cfg.n_flows * cfg.n_layers
  out = torch.cat([p for _, p in pieces], dim=1).cpu().numpy()
  assert out.shape == ref.shape == (1, frames * 256)
  assert np.isfinite(out).all()
  assert np.abs(out - ref).max() <= STREAM_TOL_REL[cdt] * np.abs(ref).max()


# -- serving fetches and copies that wait for nothing else (C9, C10) ---------

SLEEP_CYCLES = 300_000_000  # ~0.15-0.2 s of device time at H100 clocks


def test_to_device_copies_without_waiting(cuda):
  """A blocking host-to-device copy waits for the work enqueued before it;
  ``device.to_device`` does not, and lands the same values."""
  from waveglow_tpu_torch.device import to_device
  host = np.arange(1000, dtype=np.float32)
  busy = torch.cuda.Event()
  torch.cuda._sleep(SLEEP_CYCLES)
  busy.record()
  got = to_device(host, cuda)
  assert not busy.query()
  torch.cuda.synchronize()
  np.testing.assert_array_equal(got.cpu().numpy(), host)
  torch.cuda._sleep(SLEEP_CYCLES)
  busy.record()
  torch.as_tensor(host, device=cuda)  # the blocking copy, for contrast
  assert busy.query()


@pytest.fixture(scope="module")
def serving_synth(stream_model):
  from waveglow_tpu_torch.checkpointing.from_jax import params_to_numpy
  from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
  from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
  from waveglow_tpu_torch.inference.synthesizer import Synthesizer
  cfg, params = stream_model
  hp = overwrite_custom_hparams(HParams(), {
      "n_flows": str(cfg.n_flows), "n_layers": str(cfg.n_layers)})
  ckpt = CheckpointWaveglow.from_params(params_to_numpy(params[None]), hp)
  return Synthesizer(ckpt, device="cuda")


def test_serving_dispatch_and_fetch_wait_for_nothing_else(cuda,
                                                          serving_synth):
  """``serving_dispatch`` returns with the device still busy before it (no
  blocking copy inside), and ``serving_finalize`` returns with the device
  busy after it (its fetch was enqueued at dispatch); the result equals
  ``infer_serving``'s."""
  mel = np.random.default_rng(4).uniform(-11.0, 1.0, (80, 60)).astype(
      np.float32)
  ref = serving_synth.infer_serving(mel, seed=2)
  before = torch.cuda.Event()
  torch.cuda._sleep(SLEEP_CYCLES)
  before.record()
  solo = serving_synth.serving_dispatch(mel, seed=2)
  assert not before.query()
  after = torch.cuda.Event()
  torch.cuda._sleep(SLEEP_CYCLES)
  after.record()
  res = serving_synth.serving_finalize(solo)
  assert not after.query()
  np.testing.assert_array_equal(res.samples, ref.samples)
  torch.cuda.synchronize()


# -- checkpoint interop on the card ------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pt_import_synthesizes_like_the_npz(cuda, tmp_path, compute_dtype):
  """A reference ``.pt`` imported and synthesized at full width (12 x 8 x
  256) on the card equals the npz route bit for bit, 96 kernel launches a
  synthesis."""
  from waveglow_tpu_torch.checkpointing import load_checkpoint_any
  from waveglow_tpu_torch.checkpointing.export_torch import \
      export_torch_checkpoint
  from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
  from waveglow_tpu_torch.hparams import HParams
  from waveglow_tpu_torch.inference.synthesizer import Synthesizer
  from waveglow_tpu_torch.models import waveglow as wg
  hp = HParams()
  params = wg.init_params(wg.WaveGlowConfig.from_hparams(hp), seed=0)
  rng = np.random.default_rng(1)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.02).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.02).astype(np.float32)
  ckpt = CheckpointWaveglow.from_params(params, hp, iteration=3)
  ckpt.save(tmp_path / "c.npz")
  export_torch_checkpoint(ckpt, tmp_path / "c.pt")
  mel = rng.uniform(-11.0, 1.0, (80, 60)).astype(np.float32)
  outs = {}
  for name in ("c.npz", "c.pt"):
    synth = Synthesizer(load_checkpoint_any(tmp_path / name),
                        compute_dtype=compute_dtype, device="cuda")
    before = kl.LAUNCHES
    outs[name] = synth.infer(mel, seed=4).wav_denoised
    assert kl.LAUNCHES - before == hp.n_flows * hp.n_layers == 96
    del synth
  assert outs["c.pt"].shape == (60 * 256,)
  assert np.isfinite(outs["c.pt"]).all()
  np.testing.assert_array_equal(outs["c.pt"], outs["c.npz"])


# -- validation and the training command on the card -------------------------

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "audio.wav"
SMALL = {"n_flows": "2", "n_layers": "4", "n_channels": "256"}


def write_cuts(folder, cuts):
  from scipy.io import wavfile
  sr, speech = wavfile.read(FIXTURE)
  folder.mkdir(parents=True)
  for i, (start, n) in enumerate(cuts):
    wavfile.write(folder / f"cut{i}.wav", sr, speech[start:start + n])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_validate_on_the_card(cuda, tmp_path, compute_dtype):
  """``validate(device="cuda")`` of two speech cuts: 8 WN launches for the
  bias capture and 8 an entry, each output wav the normalized
  ``Synthesizer.infer`` of the same mel and seed bit for bit, finite
  metrics."""
  from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
  from waveglow_tpu_torch.dsp.audio_io import normalize_wav
  from waveglow_tpu_torch.dsp.mel import MelSTFT
  from waveglow_tpu_torch.eval.validation import get_rows, validate
  from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
  from waveglow_tpu_torch.inference.synthesizer import Synthesizer
  from waveglow_tpu_torch.models import waveglow as wg
  from waveglow_tpu_torch.training.data import load_dataset
  hp = overwrite_custom_hparams(HParams(), SMALL)
  params = wg.init_params(wg.WaveGlowConfig.from_hparams(hp), seed=0)
  rng = np.random.default_rng(1)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.05).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.05).astype(np.float32)
  ckpt = CheckpointWaveglow.from_params(params, hp, iteration=9)
  write_cuts(tmp_path / "wavs", ((22_050, 9_000), (60_000, 20_000)))
  data = load_dataset(tmp_path / "wavs")
  outputs = {}
  before = kl.LAUNCHES
  rows = get_rows(validate(
      ckpt, data, {"compute_dtype": compute_dtype}, 0.0005, 1.0, set(), True,
      lambda entry, out: outputs.__setitem__(entry.stem, out), seed=3,
      device="cuda"))
  per_synthesis = hp.n_flows * hp.n_layers
  assert kl.LAUNCHES - before == per_synthesis * (1 + len(data))
  synth = Synthesizer(ckpt, compute_dtype=compute_dtype, device="cuda")
  mel_op = MelSTFT(synth.hparams, device="cuda")
  for row, entry in zip(rows, data):
    mel = mel_op.get_mel(mel_op.get_wav_from_file(
        entry.wav_absolute_path)).cpu().numpy()
    want = normalize_wav(synth.infer(mel, seed=3).wav_denoised)
    np.testing.assert_array_equal(outputs[entry.stem].wav_inferred_denoised,
                                  want)
    for col in ("MFCC DTW MCD", "MCD", "Cosine Similarity (Padded)",
                "Structural Similarity (Padded)"):
      assert np.isfinite(row[col]), col
    assert row["Iteration"] == 9


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_command_on_the_card(cuda, tmp_path, compute_dtype):
  """``train`` from the command line at width 256: 2 steps and checkpoints
  1 and 2, forward and backward launches at the count the code gives, and
  checkpoint 2 bit for bit a ``train(max_iterations=2)`` in this
  process."""
  from waveglow_tpu_torch.cli import main as cli
  from waveglow_tpu_torch.training.data import load_dataset
  from waveglow_tpu_torch.training.loop import train
  custom = dict(SMALL, segment_length="4096", batch_size="2", epochs="1",
                iters_per_checkpoint="1", epochs_per_checkpoint="0",
                compute_dtype=compute_dtype)
  write_cuts(tmp_path / "train", [(20_000 * i, 9_000) for i in range(4)])
  write_cuts(tmp_path / "val", [(150_000, 9_000)])
  kl.LAUNCHES = kl.BWD_LAUNCHES = 0
  assert cli.run([
      "train", str(tmp_path / "train"), str(tmp_path / "val"),
      str(tmp_path / "ck"), "--custom-hparams",
      ",".join(f"{k}={v}" for k, v in custom.items()),
      "--tl-dir", str(tmp_path / "logs"), "--log",
      str(tmp_path / "cli.log")]) == 0
  per_forward = int(SMALL["n_flows"]) * int(SMALL["n_layers"])
  # 2 steps with their remat recompute, one validation batch at 2 saves
  assert kl.LAUNCHES == 2 * 2 * per_forward + 2 * per_forward
  assert kl.BWD_LAUNCHES == (2 * per_forward
                             if compute_dtype == "bfloat16" else 0)
  assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
      "1.npz", "2.npz"]
  train(custom, None, load_dataset(tmp_path / "train"),
        load_dataset(tmp_path / "val"), tmp_path / "ref", max_iterations=2,
        device="cuda")
  with np.load(tmp_path / "ck" / "2.npz") as a, \
      np.load(tmp_path / "ref" / "2.npz") as b:
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
      assert a[key].tobytes() == b[key].tobytes(), key


# -- the normal-mel bias capture and the native loader on the card --------------

@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_normal_mel_capture_through_the_kernels(cuda, compute_dtype):
  """The bias capture of a standard-normal mel at width 256 runs through
  the WN kernel (8 launches), within 1e-3 (f32) or 5e-2 (bf16) of the max
  |value| of the same capture through ``wn_layer_plain`` on the card;
  f32 bias, finite, not the zeros mel's (the ``Denoiser``'s)."""
  from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
  from waveglow_tpu_torch.inference.denoiser import (BIAS_MEL_LENGTH,
                                                     Denoiser, capture_bias)
  from waveglow_tpu_torch.models import waveglow as wg
  hp = overwrite_custom_hparams(HParams(), SMALL)
  config = wg.WaveGlowConfig.from_hparams(hp)
  params = wg.init_params(config, seed=0)
  rng = np.random.default_rng(2)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.05).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.05).astype(np.float32)
  tree = wg.params_to_torch(wg.fuse_for_inference(params), cuda)
  dn = Denoiser(tree, config, hp, cuda)
  mel = torch.randn((1, hp.n_mel_channels, BIAS_MEL_LENGTH),
                    generator=torch.Generator().manual_seed(3)).to(cuda)
  before = kl.LAUNCHES
  bias = capture_bias(tree, config, dn.stft, mel, compute_dtype)
  torch.cuda.synchronize()
  assert kl.LAUNCHES - before == config.n_flows * config.n_layers
  plain = capture_bias(tree, config, dn.stft, mel, compute_dtype,
                       layer=kl.wn_layer_plain)
  assert kl.LAUNCHES - before == config.n_flows * config.n_layers
  assert bias.dtype == torch.float32
  assert torch.isfinite(bias).all()
  scale = plain.abs().max().item()
  bound = (1e-3 if compute_dtype is None else 5e-2) * scale
  assert (bias - plain).abs().max().item() <= bound
  assert not torch.equal(dn.bias_spec, bias)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_same_bits_native_or_python(cuda, tmp_path, monkeypatch,
                                               compute_dtype):
  """One ``train()`` step at width 256 on batches read through the native
  loader and through the Python decoder (``use_native=False``): the same
  loss bits and the same params after the step."""
  import functools
  import json
  from waveglow_tpu_torch import native
  from waveglow_tpu_torch.training import data, loop
  custom = dict(SMALL, segment_length="4096", batch_size="2", epochs="1",
                iters_per_checkpoint="0", epochs_per_checkpoint="0",
                compute_dtype=compute_dtype)
  write_cuts(tmp_path / "wavs", [(20_000 * i, 9_000) for i in range(2)])
  entries = data.load_dataset(tmp_path / "wavs")
  out = {}
  for use_native in (True, False):
    monkeypatch.setattr(loop, "SegmentDataset", functools.partial(
        data.SegmentDataset, use_native=use_native))
    before = native.BATCHES
    result = loop.train(custom, tmp_path / f"logs{use_native}", entries,
                        entries, tmp_path / f"ck{use_native}",
                        max_iterations=1, device="cuda")
    assert (native.BATCHES > before) == use_native
    losses = [json.loads(line).get("loss") for line in
              (tmp_path / f"logs{use_native}" / "metrics.jsonl")
              .read_text().splitlines()]
    out[use_native] = (losses, result["params"])
  assert out[True][0] == out[False][0]
  assert out[True][0] and np.isfinite(out[True][0][0])
  from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
  for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
    assert a.tobytes() == b.tobytes()


# -- the tensor-parallel shard kernel (model mesh axis) ----------------------

def shard_slices(args, model, rank):
  """Rank ``rank``'s slices of a full layer's (cond, w_in, b_in, w_rs), as
  ``parallel.sharding.shard_params`` cuts them."""
  _, cond, w_in, b_in, w_rs, _ = args
  c = args[0].shape[-1]
  cp = c // model
  cols = slice(rank * cp, (rank + 1) * cp)
  return (cond.reshape(*cond.shape[:2], 2, c)[..., cols].reshape(
              *cond.shape[:2], 2 * cp).contiguous(),
          w_in.reshape(3, c, 2, c)[..., cols].reshape(3, c, 2 * cp)
          .contiguous(),
          b_in.reshape(2, c)[:, cols].reshape(-1).contiguous(),
          w_rs.reshape(c, -1)[cols].contiguous())


@pytest.mark.parametrize("dilation,last", [(1, False), (128, False),
                                           (2, True), (512, False)])
@pytest.mark.parametrize("batch,t", [(2, 300), (3, 37), (3, 301)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,model", [(c, c // cp)
                                     for c, cp in kl.shard_pairs()])
def test_shard_kernel_matches_plain(cuda, model, bf16, batch, t, dilation,
                                    last, c):
  """Each rank's partial against ``wn_layer_shard_plain``, and the ranks'
  partials summed against the unsharded kernel's ``rs`` (x' - x and the
  skip, less b_rs) at the bounds of the full kernel. The shapes give the
  f32 kernel's flat-row grid its edges: a ragged last tile (T = 300),
  fewer rows than one tile (3 x 37), tiles that cross a sequence boundary
  in the flat B*T rows (3 x 301); d = 512 (and 128 at T = 37) leaves
  every side tap in the padding."""
  dtype = torch.bfloat16 if bf16 else torch.float32
  cdt = torch.bfloat16 if bf16 else None
  args = layer_inputs(cuda, batch, t, c, last, dtype, seed=model)
  x = args[0]
  before = kl.SHARD_LAUNCHES
  total = None
  for rank in range(model):
    cond_s, w_in_s, b_in_s, w_rs_s = shard_slices(args, model, rank)
    got = kl.wn_layer_shard(x, cond_s, w_in_s, b_in_s, w_rs_s, dilation,
                            compute_dtype=cdt)
    torch.cuda.synchronize()
    ref = kl.wn_layer_shard_plain(x, cond_s, w_in_s, b_in_s, w_rs_s,
                                  dilation, compute_dtype=cdt)
    assert got.shape == ref.shape == (batch, t, c if last else 2 * c)
    bound = 2e-2 * ref.abs().max().item() if bf16 else 1e-4
    assert (got - ref).abs().max().item() <= bound
    total = got if total is None else total + got
  assert kl.SHARD_LAUNCHES == before + model
  xk, sk = kl.wn_layer_fused(*args, dilation, compute_dtype=cdt)
  b_rs = args[5]
  full = sk if last else torch.cat([xk - x, sk], dim=-1)
  summed = total + b_rs
  bound = 2e-2 * full.abs().max().item() if bf16 else 1e-4
  assert (summed - full).abs().max().item() <= bound


@pytest.mark.parametrize("batch,t", [
    (1, kl.WIDE_TILE_ROWS - 1), (1, kl.WIDE_TILE_ROWS),
    (1, kl.WIDE_TILE_ROWS + 1), (3, 43)])
@pytest.mark.parametrize("dilation,last", [(2, False), (128, False),
                                           (128, True)])
@pytest.mark.parametrize("cp", WIDE_GATES[1:])
def test_wide_shard_kernel_ragged_last_unit(cuda, cp, dilation, last, batch,
                                            t):
  """A rank's share at C = 512 in bf16 (the layer's three kernels at gate
  width C') walks units of WIDE_TILE_ROWS flat B*T rows: B*T one unit less
  one row, one unit, one unit plus one row, and 3 x 43 (units across
  sequences); each against wn_layer_shard_plain, every rank launched once,
  the ranks summed against the unsharded layer."""
  model = kl.WIDE_C // cp
  args = layer_inputs(cuda, batch, t, kl.WIDE_C, last, torch.bfloat16,
                      seed=cp + t)
  before, total = kl.SHARD_LAUNCHES, None
  for rank in range(model):
    sl = shard_slices(args, model, rank)
    got = kl.wn_layer_shard(args[0], *sl, dilation,
                            compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ref = kl.wn_layer_shard_plain(args[0], *sl, dilation,
                                  compute_dtype=torch.bfloat16)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    total = got if total is None else total + got
  assert kl.SHARD_LAUNCHES == before + model
  xk, sk = kl.wn_layer_fused(*args, dilation, compute_dtype=torch.bfloat16)
  full = sk if last else torch.cat([xk - args[0], sk], dim=-1)
  assert ((total + args[5] - full).abs().max().item()
          <= 2e-2 * full.abs().max().item())


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("cp", WIDE_GATES[1:])
def test_wide_shard_kernel_repeats_bitwise(cuda, cp, last):
  """16 launches of a rank's share at C = 512 in bf16 at B=1, T=26,432 (207
  units a pass on one wave of persistent blocks) give the bits of the
  first (no atomics, no split K)."""
  args = layer_inputs(cuda, 1, 26_432, kl.WIDE_C, last, torch.bfloat16,
                      seed=cp)
  sl = shard_slices(args, kl.WIDE_C // cp, 1)
  one = kl.wn_layer_shard(args[0], *sl, 4, compute_dtype=torch.bfloat16)
  for _ in range(16):
    two = kl.wn_layer_shard(args[0], *sl, 4, compute_dtype=torch.bfloat16)
    assert torch.equal(one, two)


@pytest.mark.parametrize("dilation,last", [(1, False), (128, False),
                                           (128, True)])
@pytest.mark.parametrize("batch", [1, 8])
def test_f32_wide_kernel_matches_plain(cuda, batch, dilation, last):
  """The f32 layer at C = 512 (its acts through a global scratch, read
  back through the ring) at B = 1 and 8, d = 1, 128 and the last layer,
  each row with its own valid_t, skip_acc on, within 1e-4 of
  wn_layer_plain (true f32, no TF32)."""
  t = 2_000
  valid = [t - 37 * row for row in range(batch)]
  check_against_plain(cuda, batch, t, dilation, last, False, valid,
                      seed=batch + dilation, c=kl.WIDE_C)


@pytest.mark.parametrize("last", [False, True])
def test_f32_wide_kernels_info_reads_the_loaded_build(cuda, last):
  """The f32 forward at C = 512 is two kernels in the loaded build, the
  tiles kernel (kernel_info; 384 threads) and the rest kernel (256): no
  spill, their rings as dynamic shared memory (4 slots of 96 rows and a
  128-channel pass; 3 slots of 16 rows and the 512-channel pass)."""
  tiles = kl.kernel_info(kl.WIDE_C, False, last)
  rest = kl.f32_rest_kernel_info(last)
  assert 0 < tiles["registers"] <= 168 and 0 < rest["registers"] <= 255
  assert tiles["local_bytes"] == 0 and rest["local_bytes"] == 0
  assert tiles["dynamic_smem_bytes"] == 4 * (96 * 16 + 16 * 256) * 4
  assert rest["dynamic_smem_bytes"] == 3 * (16 * 16 + 16 * 1024) * 4


@pytest.mark.parametrize("t", [13_000, 19_000, 20_000, 26_432])
def test_f32_wide_kernel_tiles(cuda, t):
  """B=1 at T where a block's rows (one wave on the card) are one 96-row
  tile and a 16-row rest (13,000), a 96-row tile and a rest of three
  16-row tiles (19,000), a 96-row tile and a short 64-row one (20,000),
  and two 96-row tiles and a rest (26,432): against wn_layer_plain, the
  tiles as kl.f32_tiles gives them."""
  grid = kl.f32_schedule(1, t, channels=kl.WIDE_C)
  assert kl.f32_tiles(grid["rows_per_block"], kl.WIDE_C)
  check_against_plain(cuda, 1, t, 8, False, False, [t - 3], seed=t,
                      c=kl.WIDE_C)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("bf16", [False, True])
def test_shard_kernel_repeats_bitwise_and_refuses(cuda, bf16, c):
  """16 launches give the same bits (no atomics, no split K), and inputs
  outside the built set or of the other mode's dtype raise."""
  dtype = torch.bfloat16 if bf16 else torch.float32
  cdt = torch.bfloat16 if bf16 else None
  args = layer_inputs(cuda, 1, 1000, c, False, dtype)
  sl = shard_slices(args, 2, 1)
  one = kl.wn_layer_shard(args[0], *sl, 4, compute_dtype=cdt)
  for _ in range(16):
    two = kl.wn_layer_shard(args[0], *sl, 4, compute_dtype=cdt)
    assert torch.equal(one, two)
  with pytest.raises(ValueError, match=r"\(C, C'\) in"):
    kl.wn_layer_shard(args[0], *shard_slices(args, 16, 0), 4,
                      compute_dtype=cdt)
  with pytest.raises(ValueError, match="dtype"):
    kl.wn_layer_shard(args[0], *sl, 4,
                      compute_dtype=None if bf16 else torch.bfloat16)


@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_shard_kernel_info_reads_the_loaded_build(cuda, c, cp):
  """Every (C, C') instance is in the loaded build; both take their shared
  memory as dynamic (the f32 kernel's 4-stage ring and acts take 108,544
  to 212,992 bytes, over the 48 KB of static), and the f32 one does not
  spill."""
  for bf16 in (False, True):
    for last in (False, True):
      info = kl.shard_kernel_info(c, cp, bf16, last)
      assert 0 < info["registers"] <= 255
      assert info["dynamic_smem_bytes"] > 0
      if not bf16:
        assert info["dynamic_smem_bytes"] > 48 * 1024
        assert info["local_bytes"] == 0


@pytest.mark.parametrize("c,cp", kl.shard_pairs())
@pytest.mark.parametrize("last", [False, True])
def test_shard_f32_schedule_covers_the_rows_in_one_wave(cuda, c, cp, last):
  """The f32 shard kernel's grid: one wave of blocks, each a whole number
  of quanta (4 warps' rows; a tile holds 3 or 4) of the flat B*T rows,
  covering them exactly once, at the kernel phase's shapes, the model
  mesh's batch and fewer rows than one tile."""
  for batch, t in ((1, 26_432), (8, 26_432), (3, 37), (3, 301), (1, 1)):
    grid = kl.f32_schedule(batch, t, last, channels=c, cp=cp)
    assert grid["blocks_per_sm"] >= 1 and grid["waves"] <= 1
    assert grid["tile_rows"] // grid["quantum"] in (3, 4)
    assert grid["tile_rows"] % grid["quantum"] == 0
    assert grid["rows_per_block"] % grid["quantum"] == 0
    assert ((grid["blocks"] - 1) * grid["rows_per_block"] < batch * t
            <= grid["blocks"] * grid["rows_per_block"])


@pytest.mark.parametrize("frames,n", [(400, 4), (397, 4), (3, 4), (251, 2)])
@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_time_sharded_is_bit_for_bit_on_the_card(cuda, stream_model, frames,
                                                 n, cdt):
  """``infer_time_sharded`` over a logical time mesh of the card equals
  one-call ``infer`` bit for bit, at frame counts that ``n`` divides and
  does not (and fewer frames than devices), with the WN kernel launched
  once a layer and non-empty span. Bit for bit needs each window's
  matrix products to round as the one call's do, which cuBLAS does not
  promise for a small row count: windows of 34 frames gave other bits on
  an H100. Every window here holds over 100 frames (3,200 rows a batch
  row), as every window of the full-width model does (its halo is 100
  frames a side)."""
  from waveglow_tpu_torch.models.waveglow import infer
  from waveglow_tpu_torch.parallel.time_shard import infer_time_sharded
  cfg, params = stream_model
  mel = np.random.default_rng(frames).uniform(
      -11.0, 1.0, (2, 80, frames)).astype(np.float32)
  ref = infer(params[cdt], cfg, mel, seed=[3, 4], compute_dtype=cdt)
  before = kl.LAUNCHES
  out = infer_time_sharded([params[cdt]] * n, cfg, mel, seed=[3, 4],
                           compute_dtype=cdt)
  assert kl.LAUNCHES - before == min(n, frames) * cfg.n_flows * cfg.n_layers
  assert torch.equal(out, ref)


@pytest.mark.parametrize("model", [2, 4])
def test_model_mesh_synthesis_on_the_card(cuda, stream_model, model):
  """``infer`` over a tensor-parallel group on a logical model mesh of
  the card: every WN layer through the shard kernel, none through the
  full one, close to the unsharded synthesis (f32)."""
  from waveglow_tpu_torch.checkpointing.from_jax import params_to_numpy
  from waveglow_tpu_torch.models.waveglow import infer
  from waveglow_tpu_torch.parallel.mesh import make_mesh
  from waveglow_tpu_torch.parallel.sharding import shard_params
  cfg, params = stream_model
  mesh = make_mesh(model=model, devices=[cuda] * model)
  group = shard_params(params_to_numpy(params[None]), mesh)[0]
  mel = np.random.default_rng(5).uniform(-11.0, 1.0, (1, 80, 40)).astype(
      np.float32)
  ref = infer(params[None], cfg, mel, seed=1).cpu().numpy()
  before, shard_before = kl.LAUNCHES, kl.SHARD_LAUNCHES
  out = infer(group, cfg, mel, seed=1).cpu().numpy()
  assert kl.LAUNCHES == before
  assert kl.SHARD_LAUNCHES - shard_before == (
      model * cfg.n_flows * cfg.n_layers)
  assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


# -- widths outside the built set, and launches on a second card -------------

def test_other_widths_are_refused_on_the_card(cuda):
  """A CUDA tensor at a width outside the built set raises, naming the
  set, in the forward, the backward and the shard kernel's wrappers; it
  never falls back to the plain version."""
  args = layer_inputs(cuda, 1, 64, 384, False, torch.float32)
  before = kl.LAUNCHES
  with pytest.raises(ValueError, match=r"C in \(128, 256, 512\), got C = 384"):
    kl.wn_layer_fused(*args, 1)
  assert kl.LAUNCHES == before
  saved, cots, _ = bwd_inputs(cuda, 1, 64, 1, False, None, seed=18, c=384)
  before = kl.BWD_LAUNCHES
  with pytest.raises(ValueError, match=r"C in \(128, 256, 512\), got C = 384"):
    kl.wn_layer_backward_fused(saved, *cots, 1)
  assert kl.BWD_LAUNCHES == before
  sl = shard_slices(layer_inputs(cuda, 1, 64, 256, False, torch.float32),
                    2, 0)
  x = torch.zeros(1, 64, 384, device=cuda)
  with pytest.raises(ValueError, match=r"\(C, C'\) in"):
    kl.wn_layer_shard(x, *sl, 1)


@pytest.mark.parametrize("c", WIDTHS)
def test_bwd_kernel_launches_on_the_tensors_card(cuda, c):
  """The backward launches on the card its tensors are on, whatever the
  current device (two cards: the inputs on cuda:1, cuda:0 current), and
  gives the bits it gives there as the current device."""
  if torch.cuda.device_count() < 2:
    pytest.skip("needs 2 CUDA cards")
  other = torch.device("cuda", 1)
  saved, cots, _ = bwd_inputs(other, 2, 300, 4, False, None, seed=19, c=c)
  with torch.cuda.device(other):
    ref = kl.wn_layer_backward_fused(saved, *cots, 4)
    torch.cuda.synchronize(other)
  with torch.cuda.device(0):
    got = kl.wn_layer_backward_fused(saved, *cots, 4)
    torch.cuda.synchronize(other)
  for g, r in zip(got, ref):
    assert g.device == other and torch.equal(g, r)


# -- the trainable shard's bf16 backward (csrc/wn_layer_bwd.cu) ------------------

def shard_bwd_inputs(device, batch, t, c, model, rank, last, seed=0):
  """Rank ``rank``'s bf16 saved inputs of the trainable shard and a
  cotangent of its partial, with the whole layer's inputs they cut."""
  args = layer_inputs(device, batch, t, c, last, torch.bfloat16, seed=seed)
  cond_s, w_in_s, b_in_s, w_rs_s = shard_slices(args, model, rank)
  rng = np.random.default_rng(seed + 7)
  n_rs = c if last else 2 * c
  g = torch.from_numpy(rng.standard_normal((batch, t, n_rs)).astype(
      np.float32)).to(device)
  return (args[0], cond_s, w_in_s.reshape(3 * c, -1), b_in_s, w_rs_s), g, args


@pytest.mark.parametrize("dilation,last,batch,t", [
    (1, False, 2, 300), (128, True, 3, 37), (8, False, 3, 301),
    (512, True, 1, 70)])
@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_shard_bwd_kernel_matches_plain(cuda, c, cp, dilation, last, batch,
                                        t):
  """One call of the shard backward kernels (one count in
  SHARD_BWD_LAUNCHES) against wn_layer_shard_backward at the same bf16
  rounding points: each gradient within 2e-2 of its scale; the ragged
  tiles (T = 37, 300, 301) and a dilation past T leave every side tap in
  the padding."""
  saved, g, _ = shard_bwd_inputs(cuda, batch, t, c, c // cp, 1, last)
  before = kl.SHARD_BWD_LAUNCHES
  got = kl.wn_layer_shard_backward_fused(saved, g, dilation)
  torch.cuda.synchronize()
  assert kl.SHARD_BWD_LAUNCHES == before + 1
  ref = kl.wn_layer_shard_backward(saved, g, dilation, torch.bfloat16)
  for a, b in zip(got, ref):
    assert a.shape == b.shape and a.dtype == b.dtype
    scale = b.float().abs().max().item()
    assert (a.float() - b.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_shard_bwd_kernel_ranks_make_the_full_backward(cuda, c, cp, last):
  """The ranks' kernel outputs, dx summed (plus the residual's cotangent)
  and the rest concatenated, against the full layer's backward kernel
  (wn_layer_backward_fused) at 2e-2 of scale; and two launches give the
  same bits."""
  model, batch, t = c // cp, 2, 300
  outs = []
  for rank in range(model):
    saved, g, args = shard_bwd_inputs(cuda, batch, t, c, model, rank, last)
    outs.append(kl.wn_layer_shard_backward_fused(saved, g, 2))
    again = kl.wn_layer_shard_backward_fused(saved, g, 2)
    assert all(torch.equal(a, b) for a, b in zip(outs[-1], again))
  n_rs = c if last else 2 * c
  dx_next = None if last else g[..., :c].contiguous()
  dskip = g if last else g[..., c:].contiguous()
  want = kl.wn_layer_backward_fused(args, dx_next, dskip, 2)
  torch.cuda.synchronize()
  dx = sum(o[0] for o in outs) + (0 if last else g[..., :c])

  def cat(i, shape):
    return torch.cat([o[i].reshape(shape) for o in outs], dim=-1)

  got = (dx, cat(1, (batch, t, 2, -1)).reshape(batch, t, 2 * c),
         cat(2, (3 * c, 2, -1)).reshape(3 * c, 2 * c),
         cat(3, (2, -1)).reshape(-1),
         torch.cat([o[4].reshape(cp, n_rs) for o in outs], 0))
  for a, b in zip(got, want):
    scale = b.float().abs().max().item()
    assert (a.float() - b.float().reshape(a.shape)).abs().max().item() <= (
        2e-2 * scale)


def test_shard_trainable_goes_through_the_kernels(cuda):
  """wn_layer_shard_trainable in bf16 on the card: the forward is the shard
  kernel, the backward the shard backward kernels (f32 takes torch ops)."""
  saved, g, _ = shard_bwd_inputs(cuda, 2, 200, 256, 2, 0, False)
  leaves = [v.clone().requires_grad_() for v in saved]
  for cdt, calls in ((torch.bfloat16, 1), (None, 0)):
    args = leaves if cdt else [v.float().detach().requires_grad_()
                               for v in leaves]
    fwd, bwd = kl.SHARD_LAUNCHES, kl.SHARD_BWD_LAUNCHES
    out = kl.wn_layer_shard_trainable(*args, 1, compute_dtype=cdt)
    out.backward(g)
    torch.cuda.synchronize()
    assert kl.SHARD_LAUNCHES == fwd + 1
    assert kl.SHARD_BWD_LAUNCHES == bwd + calls


def test_shard_bwd_kernel_refuses(cuda):
  """A pair that was not built, f32 operands and a CPU tensor raise; the
  kernel never falls back to the plain version."""
  saved, g, args = shard_bwd_inputs(cuda, 1, 64, 256, 2, 0, False)
  cond_s, w_in_s, b_in_s, w_rs_s = shard_slices(args, 16, 0)
  with pytest.raises(ValueError, match=r"\(C, C'\) in"):
    kl.wn_layer_shard_backward_fused(
        (args[0], cond_s, w_in_s.reshape(768, -1), b_in_s, w_rs_s), g, 1)
  with pytest.raises(ValueError, match="dtype"):
    kl.wn_layer_shard_backward_fused(
        (saved[0], saved[1].float(), *saved[2:]), g, 1)
  with pytest.raises(ValueError, match="CUDA"):
    kl.wn_layer_shard_backward_fused(tuple(v.cpu() for v in saved),
                                     g.cpu(), 1)


@pytest.mark.parametrize("kernel,last", [("rows", False), ("rows", True),
                                         ("dx", False), ("weights", False),
                                         ("reduce", False)])
@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_shard_bwd_kernel_info_reads_the_loaded_build(cuda, c, cp, kernel,
                                                      last):
  info = kl.shard_bwd_kernel_info(kernel, c, cp, last)
  assert info["registers"] > 0 and info["local_bytes"] == 0


# The redesigned kernels' tile edges: T = 17 (one ragged 128-row tile, one
# 64-row chunk of the weights kernel), 127 and 129 (either side of a tile),
# 2,000 (the training segment); B = 1, 4, 12; d = 1, 128 and 512 (every
# side tap in the padding).
SBWD_EDGES = [(1, 17, 1, False), (4, 127, 128, True), (4, 129, 512, False),
              (12, 2_000, 1, True), (1, 129, 128, False), (12, 17, 512, True)]


@pytest.mark.parametrize("batch,t,dilation,last", SBWD_EDGES)
@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_shard_bwd_kernel_at_the_tile_edges(cuda, c, cp, batch, t, dilation,
                                            last):
  """Every pair, both variants, against wn_layer_shard_backward at 2e-2 of
  each gradient's scale; a second launch gives the same bits."""
  saved, g, _ = shard_bwd_inputs(cuda, batch, t, c, c // cp, 0, last,
                                 seed=batch + t)
  got = kl.wn_layer_shard_backward_fused(saved, g, dilation)
  again = kl.wn_layer_shard_backward_fused(saved, g, dilation)
  torch.cuda.synchronize()
  ref = kl.wn_layer_shard_backward(saved, g, dilation, torch.bfloat16)
  for a, b, r in zip(got, again, ref):
    assert torch.equal(a, b)
    scale = r.float().abs().max().item()
    assert (a.float() - r.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("batch,t,dilation,last", [(1, 129, 128, False),
                                                   (12, 2_000, 1, True)])
@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_shard_bwd_ranks_make_the_full_backward_at_the_edges(
    cuda, c, cp, batch, t, dilation, last):
  """The ranks summed (dx) and concatenated (the rest) against the full
  layer's backward kernels at 2e-2 of scale, at a tile's edge and at the
  training shape."""
  model = c // cp
  outs = []
  for rank in range(model):
    saved, g, args = shard_bwd_inputs(cuda, batch, t, c, model, rank, last)
    outs.append(kl.wn_layer_shard_backward_fused(saved, g, dilation))
  n_rs = c if last else 2 * c
  dx_next = None if last else g[..., :c].contiguous()
  dskip = g if last else g[..., c:].contiguous()
  want = kl.wn_layer_backward_fused(args, dx_next, dskip, dilation)
  torch.cuda.synchronize()
  got = (sum(o[0] for o in outs) + (0 if last else g[..., :c]),
         torch.cat([o[1].reshape(batch, t, 2, -1) for o in outs], -1),
         torch.cat([o[2].reshape(3 * c, 2, -1) for o in outs], -1),
         torch.cat([o[3].reshape(2, -1) for o in outs], -1),
         torch.cat([o[4].reshape(cp, n_rs) for o in outs], 0))
  for a, b in zip(got, want):
    scale = b.float().abs().max().item()
    assert (a.float().reshape(b.shape) - b.float()).abs().max().item() <= (
        2e-2 * scale)


# The weights kernel's output tiles a pair (non-last; last: n_rs = C, so
# C / 128 fewer), as tests/test_torch_shard_bwd.py lays out its splits.
SBWD_WEIGHT_TILES = {(128, 64): 5, (128, 32): 5, (128, 16): 5,
                     (256, 128): 10, (256, 64): 10, (256, 32): 10,
                     (512, 256): 32, (512, 128): 20, (512, 64): 20}


@pytest.mark.parametrize("c,cp", kl.shard_pairs())
def test_shard_bwd_schedule_reads_the_loaded_build(cuda, c, cp):
  """The library's tiles agree with the host's schedule: 128-row tiles of
  the rows kernel, the weights kernel's output tiles; at B=12, T=2,000 its
  blocks fill at least one wave of the card."""
  lib = kl._library()
  assert lib.wn_layer_bwd_tile_rows(c, cp) == 128
  tiles = lib.wn_layer_bwd_weight_tiles(c, cp, 0)
  assert tiles == SBWD_WEIGHT_TILES[(c, cp)]
  assert lib.wn_layer_bwd_weight_tiles(c, cp, 1) == tiles - c // 128
  sms = torch.cuda.get_device_properties(cuda).multi_processor_count
  n_splits, _ = kl.bwd_splits(12, 2_000, tiles, sms)
  assert tiles * 12 * n_splits >= sms
