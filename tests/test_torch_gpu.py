"""CUDA kernel tests: the fused WN-layer kernel against its plain PyTorch
version on the card. They need an NVIDIA card with nvcc and skip elsewhere.

This file imports no jax (the card's machine has none); run it there without
the repo's jax-configuring conftest:

  python -m pytest tests/test_torch_gpu.py -m gpu -p no:cacheprovider --noconftest
"""

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


@pytest.mark.parametrize("dilation,last", [(1, False), (64, False),
                                           (2, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain(cuda, dilation, last, bf16):
  batch, t, c = 2, 300, kl.CHANNELS  # ragged last tile
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


def test_kernel_without_accumulator(cuda):
  args = layer_inputs(cuda, 1, 333, kl.CHANNELS, False, torch.float32,
                      seed=2)
  xk, sk = kl.wn_layer_fused(*args, 4)
  xp, sp = kl.wn_layer_plain(*args, 4)
  torch.testing.assert_close(xk, xp, atol=1e-4, rtol=0)
  torch.testing.assert_close(sk, sp, atol=1e-4, rtol=0)


def test_kernel_rejects_bad_inputs(cuda):
  x, cond, w_in, b_in, w_rs, b_rs = layer_inputs(cuda, 1, 64, kl.CHANNELS,
                                                 False, torch.float32)
  with pytest.raises(ValueError, match="dtype"):
    kl.wn_layer_fused(x, cond, w_in, b_in, w_rs, b_rs, 1,
                      compute_dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="contiguous"):
    kl.wn_layer_fused(x, cond.transpose(2, 3), w_in, b_in, w_rs, b_rs, 1)
  with pytest.raises(ValueError, match="valid_t"):
    kl.wn_layer_fused(x, cond, w_in, b_in, w_rs, b_rs, 1, valid_t=10)
  with pytest.raises(ValueError, match="C = 256"):
    kl.wn_layer_fused(x[..., :128].contiguous(), cond, w_in, b_in, w_rs,
                      b_rs, 1)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("last", [False, True])
def test_kernel_info_reads_the_loaded_build(cuda, bf16, last):
  info = kl.kernel_info(bf16, last)
  assert 0 < info["registers"] <= 255
  assert info["dynamic_smem_bytes"] > 48 * 1024  # needs the opt-in
  assert info["static_smem_bytes"] >= 0 and info["local_bytes"] >= 0
