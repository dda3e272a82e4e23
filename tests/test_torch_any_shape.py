"""The port's synthesis at every shape the JAX package serves: any odd
``kernel_size`` and any even ``n_channels``, which on the card run through
the shape-generic kernel (``csrc/wn_layer_any.cu``) and here through its
plain version. Against the JAX package on the same numpy weights and noise:
the WN stack (the JAX XLA body), whole synthesis, bucket padding,
streaming, the CLI and the parameter conversions; and the dispatch rule and
the mesh entry points at kernel_size 5. Tiny configs (at most
3 flows, 3 layers); every ``end`` conv randomised."""

import shutil
from dataclasses import asdict

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from waveglow_tpu.checkpointing.export_torch import \
    export_torch_checkpoint as jax_export_torch
from waveglow_tpu.checkpointing.import_torch import \
    load_torch_checkpoint as jax_load_torch
from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.cli.main import run as jax_run
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.inference import streaming as jax_streaming
from waveglow_tpu.models import waveglow as jax_model
from waveglow_tpu.models import wn as jax_wn
from waveglow_tpu_torch.checkpointing import load_checkpoint_any
from waveglow_tpu_torch.checkpointing.export_torch import \
    export_torch_checkpoint
from waveglow_tpu_torch.checkpointing.from_jax import (
    params_from_numpy, params_to_numpy, trainable_params_from_numpy,
    tree_leaves)
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.cli import main as cli
from waveglow_tpu_torch.dsp.audio_io import convert_wav, normalize_wav
from waveglow_tpu_torch.hparams import HParams, overwrite_custom_hparams
from waveglow_tpu_torch.inference import streaming
from waveglow_tpu_torch.inference.synthesizer import Synthesizer
from waveglow_tpu_torch.kernels import wn_layer as kl
from waveglow_tpu_torch.models import waveglow as port_model
from waveglow_tpu_torch.models import wn as port_wn
from waveglow_tpu_torch.parallel import mesh as mesh_lib
from waveglow_tpu_torch.parallel.sharding import (gather_tree, shard_params,
                                                  shard_trainable_params)

# The two tiny models of the slice: kernel_size 5 at a built-in width, and
# a width no specialised kernel is built for (C = 48, the JAX package's own
# test width).
CONFIGS = {"k5": dict(n_flows=3, n_layers=3, n_channels=32, kernel_size=5),
           "c48": dict(n_flows=3, n_layers=3, n_channels=48)}
DTYPES = {"f32": None, "bf16": torch.bfloat16}
# tests/test_torch_model.py's bounds: f32 synthesis against the JAX
# package's (atol on the waveform; sums in another order), bf16 relative to
# the waveform's scale (the port keeps pre, the gate and rs in f32 where
# the JAX XLA body rounds them to bf16).
INFER_ATOL_F32 = 2e-4
INFER_TOL_BF16_REL = 5e-2
# The WN stack alone against the JAX XLA body, f32, relative to max |ref|:
# the K*C deep conv is one im2col product there and K products here.
WN_TOL_REL = 1e-5
# tests/test_torch_streaming.py's bound: streamed against one-call,
# relative to max |wav|.
STREAM_TOL = {"f32": 1e-5, "bf16": 1e-3}
SEED = 5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
  """Two intra-op threads for torch: the suite runs its files in parallel
  worker processes."""
  before = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(before)


def randomize_end(params, seed):
  rng = np.random.default_rng(seed)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.1).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.1).astype(np.float32)
  return params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
  """(JAX config, JAX fused params, port config, port params by mode) of
  one tiny config."""
  cfg = CONFIGS[request.param]
  jcfg = jax_model.WaveGlowConfig(**cfg)
  params = randomize_end(jax_model.init_params(jcfg, seed=0), seed=1)
  pparams = params_from_numpy(params, "cpu")
  return (jcfg, jax_model.fuse_for_inference(params),
          port_model.WaveGlowConfig(**cfg),
          {"f32": pparams,
           "bf16": port_model.params_for_compute(pparams, torch.bfloat16)})


def mel_and_noise(cfg, frames, seed=0):
  rng = np.random.default_rng(seed)
  mel = rng.standard_normal((1, 80, frames)).astype(np.float32)
  shapes = jax_model.infer_noise_shapes(cfg, 1, frames * 32)
  noise = [rng.standard_normal(s).astype(np.float32) for s in shapes]
  return mel, noise


# -- the WN stack --------------------------------------------------------------

def to_torch(tree):
  if isinstance(tree, dict):
    return {k: to_torch(v) for k, v in tree.items()}
  if isinstance(tree, list):
    return [to_torch(v) for v in tree]
  return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("c,k", [(32, 1), (48, 5), (50, 3), (40, 7)])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "valid_t"])
def test_wn_forward_matches_the_jax_xla_body(c, k, masked):
  """The port's ``wn_forward`` (the kernel wrapper, which takes the plain
  version here, and ``wn_layer_plain``) against the JAX ``wn_forward``'s
  XLA body on one set of numpy weights, 3 layers (dilations 1, 2, 4), with
  and without per-row valid lengths."""
  rng = np.random.default_rng(c + k)
  n_half, n_mel, layers, batch, t = 4, 16, 3, 2, 40
  params = port_wn.init_wn_params(rng, n_half, n_mel, layers, c, k,
                                  weight_norm=False)
  params["end"]["w"] = (rng.standard_normal(params["end"]["w"].shape)
                        * 0.1).astype(np.float32)
  params["end"]["b"] = (rng.standard_normal(params["end"]["b"].shape)
                        * 0.1).astype(np.float32)
  audio = rng.standard_normal((batch, t, n_half)).astype(np.float32)
  spect = rng.standard_normal((batch, t, n_mel)).astype(np.float32)
  valid = np.array([t, t - 13], np.int32) if masked else None
  ref = np.asarray(jax_wn.wn_forward(
      params, jnp.asarray(audio), jnp.asarray(spect), c, layers, k,
      valid_t=None if valid is None else jnp.asarray(valid)))
  assert np.abs(ref).max() > 0.1
  for layer in (kl.wn_layer_fused, kl.wn_layer_plain):
    out = port_wn.wn_forward(
        to_torch(params), torch.from_numpy(audio), torch.from_numpy(spect),
        c, layers, k, layer=layer,
        valid_t=None if valid is None else torch.from_numpy(valid)).numpy()
    assert out.shape == ref.shape == (batch, t, 2 * n_half)
    assert np.abs(out - ref).max() <= WN_TOL_REL * np.abs(ref).max()


def test_the_plain_layer_takes_the_taps_from_w_in():
  """``wn_layer_plain`` derives K from w_in ([K, C, 2C], [K, C, 2, C] or
  [K*C, 2C]) and centres the taps on t: a K = 5 layer whose outer taps are
  zero is the K = 3 layer of its inner taps; an even K raises."""
  rng = np.random.default_rng(3)
  c, t = 6, 20

  def rand(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

  x, cond, b_in = rand(1, t, c), rand(1, t, 2 * c), rand(2 * c)
  w3, w_rs, b_rs = rand(3, c, 2 * c), rand(c, 2 * c), rand(2 * c)
  w5 = torch.cat([torch.zeros(1, c, 2 * c), w3, torch.zeros(1, c, 2 * c)])
  want = kl.wn_layer_plain(x, cond, w3, b_in, w_rs, b_rs, 2)
  for w in (w5, w5.reshape(5, c, 2, c), w5.reshape(5 * c, 2 * c)):
    got = kl.wn_layer_plain(x, cond, w, b_in, w_rs, b_rs, 2)
    for a, b in zip(got, want):
      np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
  with pytest.raises(ValueError, match="odd"):
    kl.wn_layer_plain(x, cond, rand(4, c, 2 * c), b_in, w_rs, b_rs, 1)


# -- whole synthesis -----------------------------------------------------------

def test_infer_f32_matches_jax(model):
  jcfg, jparams, pcfg, pparams = model
  mel, noise = mel_and_noise(jcfg, 6)
  ref = np.asarray(jax_model.infer(
      jparams, jcfg, jnp.asarray(mel), sigma=0.8,
      noise=[jnp.asarray(n) for n in noise]))
  out = port_model.infer(pparams["f32"], pcfg, torch.from_numpy(mel),
                         sigma=0.8, noise=noise, device="cpu").numpy()
  assert out.shape == ref.shape == (1, 6 * 256)
  assert np.abs(ref).max() > 0.1  # the couplings are not the identity
  np.testing.assert_allclose(out, ref, atol=INFER_ATOL_F32)


def test_infer_bf16_matches_jax(model):
  jcfg, jparams, pcfg, pparams = model
  mel, noise = mel_and_noise(jcfg, 6, seed=1)
  ref = np.asarray(jax_model.infer(
      jparams, jcfg, jnp.asarray(mel), noise=[jnp.asarray(n) for n in noise],
      compute_dtype=jnp.bfloat16))
  out = port_model.infer(pparams["bf16"], pcfg, torch.from_numpy(mel),
                         noise=noise, compute_dtype=torch.bfloat16,
                         device="cpu").numpy()
  assert np.abs(out - ref).max() <= INFER_TOL_BF16_REL * np.abs(ref).max()


@pytest.mark.parametrize("mode", sorted(DTYPES))
def test_bucket_padded_kept_samples_bit_equal(model, mode):
  """A mel padded with silence frames plus ``true_frames`` keeps the
  unpadded call's samples bit for bit: the residual rows past the true
  length are zero after every layer, so the K-tap conv reads them as its
  zero padding."""
  _, _, pcfg, pparams = model
  mel, _ = mel_and_noise(pcfg, 7, seed=3)
  padded = np.concatenate(
      [mel, np.full((1, 80, 5), np.log(1e-5), np.float32)], axis=-1)
  ref = port_model.infer(pparams[mode], pcfg, mel, seed=11,
                         compute_dtype=DTYPES[mode], device="cpu").numpy()
  out = port_model.infer(pparams[mode], pcfg, padded, seed=11,
                         compute_dtype=DTYPES[mode], true_frames=7,
                         device="cpu").numpy()
  np.testing.assert_array_equal(out[:, :7 * 256], ref)


# -- streaming -----------------------------------------------------------------

def test_receptive_halo_matches_jax_at_kernel_size_5():
  overrides = {"kernel_size": "5", "n_flows": "3", "n_layers": "3"}
  jcfg = jax_model.WaveGlowConfig.from_hparams(
      jax_overwrite(JaxHParams(), overrides))
  pcfg = port_model.WaveGlowConfig.from_hparams(
      overwrite_custom_hparams(HParams(), overrides))
  halo = streaming.receptive_halo_frames(pcfg)
  assert halo == jax_streaming.receptive_halo_frames(jcfg)
  k3 = streaming.receptive_halo_frames(port_model.WaveGlowConfig(
      n_flows=3, n_layers=3))
  assert halo > k3  # five taps reach twice as far as three


@pytest.mark.parametrize("mode", sorted(DTYPES))
def test_stream_matches_one_call(model, mode):
  """31 frames in chunks of 4 (8 windows, the last chunk 3 frames)
  reassemble to the one-call synthesis with the same seed."""
  _, _, pcfg, pparams = model
  mel = np.random.default_rng(31).standard_normal((1, 80, 31)).astype(
      np.float32)
  ref = port_model.infer(pparams[mode], pcfg, mel, seed=5,
                         compute_dtype=DTYPES[mode], device="cpu").numpy()
  pieces = list(streaming.stream_chunks(
      pparams[mode], pcfg, mel, seed=5, compute_dtype=DTYPES[mode],
      device="cpu", chunk_frames=4))
  assert len(pieces) == 8
  out = torch.cat([p for _, p in pieces], dim=1).numpy()
  assert out.shape == ref.shape == (1, 31 * 256)
  assert np.abs(out - ref).max() <= STREAM_TOL[mode] * np.abs(ref).max()


# -- the CLI and the checkpoint conversions ------------------------------------

K5_HPARAMS = {"n_flows": "3", "n_layers": "3", "n_channels": "32",
              "kernel_size": "5"}


@pytest.fixture(scope="module")
def k5_files(tmp_path_factory):
  """A kernel_size 5 checkpoint the JAX package wrote (npz and reference
  ``.pt``) and a folder of two mels."""
  root = tmp_path_factory.mktemp("k5")
  hp = jax_overwrite(JaxHParams(), K5_HPARAMS)
  params = randomize_end(
      jax_model.init_params(jax_model.WaveGlowConfig.from_hparams(hp),
                            seed=2), seed=3)
  ckpt = JaxCkpt(state_dict=params, optimizer=None,
                 learning_rate=hp.learning_rate, iteration=9,
                 hparams=asdict(hp))
  ckpt.save(root / "model.npz")
  jax_export_torch(ckpt, root / "model.pt")
  (root / "mels").mkdir()
  rng = np.random.default_rng(4)
  for i, frames in enumerate((9, 14)):
    np.save(root / "mels" / f"m{i}.npy",
            rng.uniform(-11.0, 1.0, (80, frames)).astype(np.float32))
  return root, params


def test_synthesize_at_kernel_size_5(k5_files, tmp_path):
  """``synthesize`` with ``--custom-hparams kernel_size=5,...`` from the
  npz writes ``Synthesizer.infer`` normalized to int16 bit for bit, and at
  sigma 0 (no noise) agrees with the JAX CLI's file within the bound that
  ``infer`` keeps to the JAX package's, carried through normalization."""
  root, _ = k5_files
  custom = ",".join(f"{k}={v}" for k, v in K5_HPARAMS.items())
  out = tmp_path / "port"
  assert cli.run(["synthesize", str(root / "model.npz"), str(root / "mels"),
                  "--custom-hparams", custom, "--custom-seed", str(SEED),
                  "--device", "cpu", "-out", str(out),
                  "--log", str(tmp_path / "log")]) == 0
  synth = Synthesizer(load_checkpoint_any(root / "model.npz"), device="cpu")
  assert synth.config.kernel_size == 5
  for path in sorted((root / "mels").glob("*.npy")):
    want = convert_wav(normalize_wav(synth.infer(
        np.load(path), seed=SEED, bucket_frames=64).wav_denoised), np.int16)
    _, got = wavfile.read(out / f"{path.stem}.wav")
    np.testing.assert_array_equal(got, want)

  one = tmp_path / "one"
  one.mkdir()
  shutil.copy(root / "mels" / "m1.npy", one / "m.npy")
  common = ["synthesize", str(root / "model.npz"), str(one), "--sigma", "0",
            "--custom-hparams", custom, "--custom-seed", str(SEED),
            "--log", str(tmp_path / "log")]
  assert jax_run(common + ["-out", str(tmp_path / "jax")]) == 0
  assert cli.run(common + ["-out", str(tmp_path / "port0"),
                           "--device", "cpu"]) == 0
  _, ref = wavfile.read(tmp_path / "jax" / "m.wav")
  _, got = wavfile.read(tmp_path / "port0" / "m.wav")
  assert got.shape == ref.shape == (14 * 256,)
  peak = float(np.abs(synth.infer(np.load(one / "m.npy"), sigma=0.0,
                                  bucket_frames=64).wav_denoised).max())
  bound = 32767 * 2 * INFER_ATOL_F32 / peak + 1
  assert np.abs(got.astype(int) - ref).max() <= bound


def test_jax_parameters_carry_across_at_kernel_size_5(k5_files, tmp_path):
  """The JAX tree, its npz and the reference ``.pt`` the JAX package wrote
  reach the port with the same values and a kernel_size 5 config; the
  port's ``.pt`` export reads back into the JAX package bit for bit."""
  root, params = k5_files
  fused = jax_model.fuse_for_inference(params)
  port = params_to_numpy(params_from_numpy(params, "cpu"))
  for a, b in zip(tree_leaves(port), tree_leaves(fused)):
    np.testing.assert_array_equal(a, np.asarray(b))
  trainable = trainable_params_from_numpy(params, "cpu")
  assert tuple(trainable["flows"][0]["wn"]["in_layers"][1]["v"].shape) == (
      5, 32, 2, 32)
  for name in ("model.npz", "model.pt"):
    ckpt = load_checkpoint_any(root / name)
    assert ckpt.get_hparams().kernel_size == 5, name
    assert ckpt.get_hparams().n_channels == 32, name
    for a, b in zip(tree_leaves(ckpt.state_dict), tree_leaves(params)):
      np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)
  npz = load_checkpoint_any(root / "model.npz")
  export_torch_checkpoint(npz, tmp_path / "back.pt")
  back = jax_load_torch(tmp_path / "back.pt")
  assert back.get_hparams().kernel_size == 5
  for a, b in zip(tree_leaves(back.state_dict), tree_leaves(npz.state_dict)):
    np.testing.assert_array_equal(np.asarray(a), b)


def test_a_width_the_kernels_are_not_built_for_round_trips(tmp_path):
  """A C = 50 checkpoint (no specialised kernel) saved by the port loads
  with its width and synthesizes as the params it saved."""
  hp = overwrite_custom_hparams(HParams(), {
      "n_flows": "2", "n_layers": "2", "n_channels": "50"})
  cfg = port_model.WaveGlowConfig.from_hparams(hp)
  params = randomize_end(port_model.init_params(cfg, seed=6), seed=7)
  CheckpointWaveglow.from_params(params, hp, iteration=1).save(
      tmp_path / "c50.npz")
  ckpt = load_checkpoint_any(tmp_path / "c50.npz")
  assert ckpt.get_hparams().n_channels == 50
  mel = np.random.default_rng(8).standard_normal((1, 80, 5)).astype(
      np.float32)
  a = port_model.infer(params_from_numpy(ckpt.state_dict, "cpu"), cfg, mel,
                       seed=1, device="cpu").numpy()
  b = port_model.infer(params_from_numpy(params, "cpu"), cfg, mel, seed=1,
                       device="cpu").numpy()
  np.testing.assert_array_equal(a, b)
  assert np.isfinite(a).all() and np.abs(a).max() > 0


# -- the dispatch rule and the training and mesh entry points at kernel_size 5 -

@pytest.mark.parametrize("c,k,want", [
    (128, 3, True), (256, 3, True), (512, 3, True),
    (256, 5, False), (256, 1, False), (128, 7, False),
    (384, 3, False), (64, 3, False), (50, 3, False), (48, 5, False),
])
def test_specialised_only_at_the_built_widths_and_three_taps(c, k, want):
  assert kl.specialised(c, k) is want


def test_the_generic_kernel_caps_are_its_shared_memory():
  """ANY_MAX_C keeps the caps of the generic forward's first design
  (csrc/wn_layer_any.cu's kMaxCF32, kMaxCBf16): the largest multiple of 64
  channels whose 64-row tile (double-buffered operands, in bf16 the f32
  taps staged, and the acts of every channel) fit the 232,448 bytes a
  block may use. Every width the JAX package's tests and HParams use is
  under it."""
  def f32_bytes(cpad):
    return (2 * 16 * 68 + 2 * 16 * 128 + cpad * 68) * 4

  def bf16_bytes(cpad):
    return (2 * 64 * 128 + 2 * 2 * 64 * 128 + 64 * 64 * 4
            + cpad // 64 * 64 * 128)

  for dtype, size in ((torch.float32, f32_bytes),
                      (torch.bfloat16, bf16_bytes)):
    cap = kl.ANY_MAX_C[dtype]
    assert cap % 64 == 0
    assert size(cap) <= 232_448 < size(cap + 64)
    assert cap >= max(32, 48, 64, 128, 256, 512)


def test_wn_layer_any_takes_the_plain_version_on_the_cpu():
  rng = np.random.default_rng(9)
  c, t = 10, 12

  def rand(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

  args = (rand(2, t, c), rand(2, t, 2 * c), rand(5, c, 2 * c), rand(2 * c),
          rand(c, c), rand(c))
  valid = torch.tensor([t, 7], dtype=torch.int32)
  before = kl.ANY_LAUNCHES
  got = kl.wn_layer_any(*args, 3, valid_t=valid)
  want = kl.wn_layer_plain(*args, 3, valid_t=valid)
  assert kl.ANY_LAUNCHES == before  # no kernel here
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_training_and_mesh_entry_points_refuse_kernel_size_5():
  """The mesh entry points no longer refuse kernel_size 5: a model mesh's
  synthesis (``wn_forward_tp``) and its training (``wn_forward_train_tp``)
  over a model = 2 group of the CPU give the unsharded route's output
  (``wn_forward``, ``wn_forward_train``) and, in training, its gradients
  of every leaf (the ranks' slices gathered). Training without a mesh
  (``wn_forward_train``, ``forward``) runs at kernel_size 5: through the
  trainable layer (its CPU route) it gives the plain route's output and
  gradients."""
  cfg = port_model.WaveGlowConfig(**CONFIGS["k5"])
  params = randomize_end(port_model.init_params(cfg, seed=0), seed=1)
  wn = params_from_numpy(params, "cpu")["flows"][0]["wn"]
  tr = trainable_params_from_numpy(params, "cpu")
  rng = np.random.default_rng(2)
  audio0 = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
  spect = torch.from_numpy(rng.standard_normal((1, 8, 640)).astype(
      np.float32))
  c, layers, k = cfg.n_channels, cfg.n_layers, cfg.kernel_size
  mesh = mesh_lib.make_mesh(1, 2, devices=["cpu"] * 2)
  group = [g["flows"][0]["wn"] for g in shard_params(
      port_model.fuse_for_inference(params), mesh)[0]]
  want = port_wn.wn_forward(wn, audio0, spect, c, layers, k)
  got = port_wn.wn_forward_tp(group, audio0, [spect] * 2, c, layers, k)
  assert want.abs().max() > 0.1
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                             atol=1e-5 * want.abs().max().item())
  ranks = shard_trainable_params(params, mesh)[0]
  outs = {}
  for route, run in (
      ("mesh", lambda: port_wn.wn_forward_train_tp(
          [g["flows"][0]["wn"] for g in ranks], audio0, spect, c, layers,
          k)),
      ("unsharded", lambda: port_wn.wn_forward_train(
          tr["flows"][0]["wn"], audio0, spect, c, layers, k))):
    out = run()
    out.square().sum().backward()
    outs[route] = out.detach()
  np.testing.assert_allclose(outs["mesh"].numpy(), outs["unsharded"].numpy(),
                             rtol=0,
                             atol=1e-5 * outs["unsharded"].abs().max().item())

  def grad(p):
    return (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()

  got_grads = gather_tree(ranks, grad)
  want_grads = [grad(p) for p in tree_leaves(tr)]
  assert len(got_grads) == len(want_grads)
  assert sum(np.abs(g).max() > 0 for g in want_grads) >= 10
  for n, (g, w) in enumerate(zip(got_grads, want_grads)):
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=1e-5 * max(np.abs(w).max(), 1e-30),
                               err_msg=f"leaf {n}")

  mel = torch.from_numpy(rng.standard_normal((1, 80, 2)).astype(np.float32))
  audio = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 512)).astype(
      np.float32))
  runs = {
      "wn_forward_train": (lambda layer: port_wn.wn_forward_train(
          tr["flows"][0]["wn"], audio0, spect, c, layers, k, layer=layer),
                           tree_leaves(tr["flows"][0]["wn"])),
      "forward": (lambda layer: port_model.forward(
          tr, cfg, mel, audio, layer=layer)[0], tree_leaves(tr)),
  }
  for name, (run, leaves) in runs.items():
    outs = {}
    for route, layer in (("trainable", kl.wn_layer_trainable),
                         ("plain", kl.wn_layer_plain)):
      for leaf in leaves:
        leaf.grad = None
      out = run(layer)
      out.square().sum().backward()
      outs[route] = (out.detach(), [leaf.grad.clone() for leaf in leaves])
    (got, got_grads), (want, want_grads) = outs["trainable"], outs["plain"]
    assert got.shape == want.shape and got.abs().max() > 0, name
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * want.abs().max().item(),
                               err_msg=name)
    for n, (g, w) in enumerate(zip(got_grads, want_grads)):
      assert w.abs().max() > 0, f"{name} leaf {n}"
      np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                 atol=1e-5 * w.abs().max().item(),
                                 err_msg=f"{name} leaf {n}")
