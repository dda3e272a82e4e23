"""The port's torch checkpoint interop against the JAX package's own
functions: every ``.pt`` form (parametrization naming, legacy
``weight_g``/``weight_v``, fused weights, NVIDIA's raw ``{"model": ...}``
with a state dict or a pickled module), Adam state both ways, export both
ways, resume, the checkpoint-directory helpers and the loaders, and the
download module. Every ``.pt`` is built with torch in the test; tiny config,
every ``end`` conv randomised."""

import functools
import http.server
import sys
import threading
import types
import warnings
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from waveglow_tpu import checkpointing as jax_ckpting
from waveglow_tpu.checkpointing import download as jax_download
from waveglow_tpu.checkpointing import export_torch as jax_export
from waveglow_tpu.checkpointing import import_torch as jax_import
from waveglow_tpu.checkpointing import store as jax_store
from waveglow_tpu.checkpointing.store import CheckpointWaveglow as JaxCkpt
from waveglow_tpu.hparams import HParams as JaxHParams
from waveglow_tpu.hparams import overwrite_custom_hparams as jax_overwrite
from waveglow_tpu.models.waveglow import WaveGlowConfig as JaxConfig
from waveglow_tpu.models.waveglow import init_params as jax_init
from waveglow_tpu.training.step import make_optimizer as jax_make_optimizer
from waveglow_tpu_torch import checkpointing as ckpting
from waveglow_tpu_torch.checkpointing import download
from waveglow_tpu_torch.checkpointing import export_torch, import_torch, store
from waveglow_tpu_torch.checkpointing.from_jax import (
    trainable_params_from_numpy, tree_leaves, tree_unflatten)
from waveglow_tpu_torch.checkpointing.store import (CheckpointWaveglow,
                                                    flatten_tree)
from waveglow_tpu_torch.training import step as train_step

TINY = {"n_flows": "5", "n_early_every": "2", "n_early_size": "2",
        "n_layers": "2", "n_channels": "32"}
LR = 3e-4
G, V = ".parametrizations.weight.original0", ".parametrizations.weight.original1"


def tiny_params(seed=0):
  hp = jax_overwrite(JaxHParams(), TINY)
  params = jax_init(JaxConfig.from_hparams(hp), seed=seed)
  rng = np.random.default_rng(seed + 100)
  for flow in params["flows"]:
    end = flow["wn"]["end"]
    end["w"] = (rng.standard_normal(end["w"].shape) * 0.1).astype(np.float32)
    end["b"] = (rng.standard_normal(end["b"].shape) * 0.1).astype(np.float32)
  return params, hp


def reference_hparams(hp):
  return {k: v for k, v in asdict(hp).items()
          if k in export_torch.REFERENCE_HPARAMS}


def legacy_naming(sd):
  """Parametrization naming -> the legacy hook's ``weight_g``/``weight_v``."""
  return {k.replace(G, ".weight_g").replace(V, ".weight_v"): v
          for k, v in sd.items()}


def fused_naming(sd):
  """Every weight-normed conv folded to one ``weight`` (as
  ``remove_weightnorm`` leaves it)."""
  out = {}
  for k, v in sd.items():
    if k.endswith(G):
      prefix = k[:-len(G)]
      out[f"{prefix}.weight"] = torch._weight_norm(sd[prefix + V], v, 0)
    elif not k.endswith(V):
      out[k] = v
  return out


def adam_state(sd, seed, step=7):
  """A torch Adam ``state_dict()`` over ``sd`` in the reference model's
  parameter order, with random moments."""
  gen = torch.Generator().manual_seed(seed)
  names = export_torch.reference_parameter_order(sd)
  state = {i: {"step": torch.tensor(float(step)),
               "exp_avg": torch.randn(sd[n].shape, generator=gen),
               "exp_avg_sq": torch.rand(sd[n].shape, generator=gen)}
           for i, n in enumerate(names)}
  return {"state": state, "param_groups": [{"params": list(range(len(names)))}]}


def glow_module(sd):
  """A real ``nn.Module`` tree of a throwaway ``glow`` module's classes
  (as NVIDIA pickled theirs), its convs under legacy ``weight_norm`` hooks
  where ``sd`` has ``weight_g``/``weight_v``, loaded with ``sd``."""
  glow = types.ModuleType("glow")
  for name in ("WaveGlow", "WN", "Invertible1x1Conv"):
    setattr(glow, name, type(name, (torch.nn.Module,), {"__module__": "glow"}))
  model = glow.WaveGlow()
  up = sd["upsample.weight"].shape
  model.upsample = torch.nn.ConvTranspose1d(up[0], up[1], up[2], stride=256)
  n_flows, n_layers = export_torch.count_flows_and_layers(sd)

  def conv(prefix):
    legacy = f"{prefix}.weight_v" in sd
    cout, cin, k = sd[f"{prefix}.weight_v" if legacy
                      else f"{prefix}.weight"].shape
    layer = torch.nn.Conv1d(cin, cout, k, bias=f"{prefix}.bias" in sd)
    if not legacy:
      return layer
    with warnings.catch_warnings():  # the legacy hook is deprecated
      warnings.simplefilter("ignore", FutureWarning)
      return torch.nn.utils.weight_norm(layer)

  model.WN = torch.nn.ModuleList()
  model.convinv = torch.nn.ModuleList()
  for f in range(n_flows):
    wn = glow.WN()
    wn.in_layers = torch.nn.ModuleList(
        conv(f"WN.{f}.in_layers.{i}") for i in range(n_layers))
    wn.res_skip_layers = torch.nn.ModuleList(
        conv(f"WN.{f}.res_skip_layers.{i}") for i in range(n_layers))
    for name in ("start", "end", "cond_layer"):
      setattr(wn, name, conv(f"WN.{f}.{name}"))
    model.WN.append(wn)
    inv = glow.Invertible1x1Conv()
    inv.conv = conv(f"convinv.{f}.conv")
    model.convinv.append(inv)
  model.load_state_dict(sd)  # strict: the names must all match
  return glow, model


def write_variant(variant, path, seed=0, optimizer=False):
  """Write one torch form of the tiny model to ``path``; returns the params
  it was written from."""
  params, hp = tiny_params(seed)
  sd = jax_export.params_to_state_dict(params)
  if variant == "legacy":
    sd = legacy_naming(sd)
  elif variant == "fused":
    sd = fused_naming(sd)
  opt = adam_state(sd, seed) if optimizer else None
  if variant.startswith("nvidia"):
    sd = legacy_naming(sd)
    payload = {"model": sd, "iteration": 1234}
    if optimizer:
      payload["optimizer"] = adam_state(sd, seed)
    if variant == "nvidia_module":
      glow, payload["model"] = glow_module(sd)
      sys.modules["glow"] = glow
      try:
        torch.save(payload, str(path))
      finally:
        del sys.modules["glow"]  # the loaders' shim must resolve it
      return params
  else:
    payload = {"state_dict": sd, "optimizer": opt, "learning_rate": LR,
               "iteration": 42, "hparams": reference_hparams(hp)}
  torch.save(payload, str(path))
  return params


def assert_checkpoints_equal(port, ref):
  """Bit for bit: params (dtype included), optimizer leaves, metadata."""
  fp, fr = flatten_tree(port.state_dict), flatten_tree(ref.state_dict)
  assert fp.keys() == fr.keys()
  for k in fp:
    assert fp[k].dtype == fr[k].dtype, k
    np.testing.assert_array_equal(fp[k], fr[k], err_msg=k)
  assert (port.optimizer is None) == (ref.optimizer is None)
  if ref.optimizer is not None:
    assert len(port.optimizer) == len(ref.optimizer)
    for a, b in zip(port.optimizer, ref.optimizer):
      assert np.asarray(a).dtype == np.asarray(b).dtype
      np.testing.assert_array_equal(a, b)
  assert port.iteration == ref.iteration
  assert port.learning_rate == ref.learning_rate
  assert port.hparams == ref.hparams


@pytest.fixture(autouse=True)
def no_glow_module():
  """Each case starts without a ``glow`` module, as a fresh process does."""
  sys.modules.pop("glow", None)
  yield
  sys.modules.pop("glow", None)


# -- import: every form ----------------------------------------------------------

@pytest.mark.parametrize("optimizer", [False, True], ids=["params", "adam"])
@pytest.mark.parametrize("variant", ["new", "legacy", "fused", "nvidia_raw",
                                     "nvidia_module"])
def test_load_torch_checkpoint_matches_jax(tmp_path, variant, optimizer):
  """The port's tree equals the JAX package's bit for bit, and so do the
  optimizer leaves, iteration, learning rate and hparams. The
  ``nvidia_module`` form is a pickled module under legacy
  ``torch.nn.utils.weight_norm`` hooks (they pickle), its ``glow`` module
  gone from ``sys.modules`` before the load."""
  path = tmp_path / f"{variant}.pt"
  params = write_variant(variant, path, optimizer=optimizer)
  port = import_torch.load_torch_checkpoint(path)
  sys.modules.pop("glow", None)
  ref = jax_import.load_torch_checkpoint(path)
  assert_checkpoints_equal(port, ref)
  assert (port.optimizer is not None) == optimizer
  if variant != "fused":  # the fused form holds no (g, v) to compare
    for a, b in zip(tree_leaves(port.state_dict), tree_leaves(params)):
      np.testing.assert_array_equal(a, b)
  if variant.startswith("nvidia"):
    assert port.iteration == 1234 and port.learning_rate == 1e-4
    hp = port.get_hparams()
    assert (hp.n_flows, hp.n_layers, hp.n_channels, hp.n_group,
            hp.n_early_every, hp.n_early_size, hp.batch_size) == (
                5, 2, 32, 8, 2, 2, 24)


def test_load_checkpoint_as_torch_and_any(tmp_path):
  path = tmp_path / "c.pt"
  write_variant("new", path)
  assert ckpting.sniff_checkpoint_format(path) == "torch"
  ref = jax_import.load_torch_checkpoint(path)
  assert_checkpoints_equal(ckpting.load_checkpoint_as(path, "torch"), ref)
  assert_checkpoints_equal(ckpting.load_checkpoint_any(path), ref)
  assert_checkpoints_equal(ckpting.load_checkpoint_lazy(path), ref)


def test_unrecognized_structure_raises(tmp_path):
  path = tmp_path / "odd.pt"
  torch.save({"weights": torch.zeros(2)}, str(path))
  with pytest.raises(ValueError, match="unrecognized torch checkpoint"):
    import_torch.load_torch_checkpoint(path)


@pytest.mark.parametrize("variant", ["new", "legacy", "fused"])
def test_derive_hparams_matches_jax(variant):
  params, hp = tiny_params()
  sd = jax_export.params_to_state_dict(params)
  sd = {"new": sd, "legacy": legacy_naming(sd),
        "fused": fused_naming(sd)}[variant]
  port = import_torch.derive_hparams_from_state_dict(sd)
  assert asdict(port) == asdict(jax_import.derive_hparams_from_state_dict(sd))
  assert asdict(import_torch.nvidia_paper_hparams()) == asdict(
      jax_import.nvidia_paper_hparams())


# -- optimizer leaves --------------------------------------------------------------

def test_adam_leaves_match_jax():
  params, hp = tiny_params(seed=3)
  sd = jax_export.params_to_state_dict(params)
  opt = adam_state(sd, seed=3, step=11)
  port = import_torch.torch_adam_to_opt_leaves(opt, sd, hp)
  ref = jax_import.torch_adam_to_opt_leaves(opt, sd, hp)
  assert len(port) == len(ref) == 1 + 2 * len(tree_leaves(params))
  assert port[0].dtype == ref[0].dtype == np.int32 and int(port[0]) == 11
  for a, b in zip(port, ref):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", ["empty", "no state", "partial",
                                   "extra param", "shape", "foreign keys"])
def test_adam_leaves_none_where_jax_gives_none(fault):
  params, hp = tiny_params(seed=4)
  sd = jax_export.params_to_state_dict(params)
  opt = adam_state(sd, seed=4)
  if fault == "empty":
    opt = {}
  elif fault == "no state":
    opt = {"state": {}, "param_groups": []}
  elif fault == "partial":
    opt["state"].pop(len(opt["state"]) - 1)
  elif fault == "extra param":
    opt["param_groups"] = [{"params": list(range(len(sd) + 1))}]
  elif fault == "shape":
    opt["state"][0]["exp_avg"] = torch.zeros(3, 3)
  else:
    sd = dict(sd, stray=torch.zeros(1))
  assert jax_import.torch_adam_to_opt_leaves(opt, sd, hp) is None
  assert import_torch.torch_adam_to_opt_leaves(opt, sd, hp) is None


def test_tree_unflatten_inverts_tree_leaves():
  params, _ = tiny_params()
  leaves = tree_leaves(params)
  assert tree_leaves(tree_unflatten(params, leaves)) == leaves
  jax_leaves = jax.tree_util.tree_leaves(params)
  assert all(a is b for a, b in zip(leaves, jax_leaves))
  with pytest.raises(ValueError, match="leaves"):
    tree_unflatten(params, leaves[:-1])


# -- export -----------------------------------------------------------------------

def real_optax_leaves(params):
  """Leaves of a real optax Adam state after two updates."""
  opt = jax_make_optimizer(LR)
  state = opt.init(params)
  grads = jax.tree_util.tree_map(np.asarray, params)
  for _ in range(2):
    _, state = opt.update(grads, state, params)
  return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def checkpoint_pair(optimizer):
  params, hp = tiny_params(seed=5)
  opt = real_optax_leaves(params) if optimizer else None
  meta = dict(learning_rate=LR, iteration=9, hparams=asdict(hp))
  return (CheckpointWaveglow(state_dict=params, optimizer=opt, **meta),
          JaxCkpt(state_dict=params, optimizer=opt, **meta))


def assert_payloads_equal(a, b):
  assert a.keys() == b.keys()
  assert list(a["state_dict"]) == list(b["state_dict"])
  for k in a["state_dict"]:
    assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
  assert (a["optimizer"] is None) == (b["optimizer"] is None)
  if a["optimizer"] is not None:
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
      assert sa[i].keys() == sb[i].keys()
      for k in sa[i]:
        assert sa[i][k].dtype == sb[i][k].dtype
        assert torch.equal(sa[i][k], sb[i][k]), (i, k)
  for key in ("learning_rate", "iteration", "hparams"):
    assert a[key] == b[key], key


@pytest.mark.parametrize("optimizer", [False, True], ids=["params", "adam"])
def test_export_matches_jax_and_reimports_both_ways(tmp_path, optimizer):
  """Port export == JAX export key for key; port export -> JAX import and
  JAX export -> port import give the checkpoint back bit for bit."""
  port_ckpt, jax_ckpt = checkpoint_pair(optimizer)
  export_torch.export_torch_checkpoint(port_ckpt, tmp_path / "port.pt")
  jax_export.export_torch_checkpoint(jax_ckpt, tmp_path / "jax.pt")
  load = functools.partial(torch.load, map_location="cpu", weights_only=False)
  port_payload = load(str(tmp_path / "port.pt"))
  assert_payloads_equal(port_payload, load(str(tmp_path / "jax.pt")))
  assert port_payload["optimizer"] is None or optimizer

  back_in_jax = jax_import.load_torch_checkpoint(tmp_path / "port.pt")
  back_in_port = import_torch.load_torch_checkpoint(tmp_path / "jax.pt")
  assert_checkpoints_equal(back_in_port, back_in_jax)
  for a, b in zip(tree_leaves(back_in_port.state_dict),
                  tree_leaves(port_ckpt.state_dict)):
    np.testing.assert_array_equal(a, b)
  if optimizer:
    for a, b in zip(back_in_port.optimizer, port_ckpt.optimizer):
      np.testing.assert_array_equal(a, b)


def test_reference_parameter_order_matches_jax():
  params, _ = tiny_params()
  sd = jax_export.params_to_state_dict(params)
  for form in (sd, legacy_naming(sd), fused_naming(sd)):
    assert (export_torch.reference_parameter_order(form)
            == jax_export.reference_parameter_order(form))
  with pytest.raises(AssertionError):
    export_torch.reference_parameter_order(dict(sd, stray=torch.zeros(1)))


def test_opt_leaves_of_the_wrong_count_raise():
  params, _ = tiny_params()
  leaves = real_optax_leaves(params)
  with pytest.raises(ValueError, match="leaves"):
    export_torch.opt_leaves_to_torch_adam(leaves[:-1], params, LR)


# -- resume -----------------------------------------------------------------------

def test_reference_pt_with_adam_resumes_in_the_port(tmp_path):
  """A reference ``.pt`` with Adam state: its moments land on the port's
  optimizer through ``adam_state_from_optax`` and come back out unchanged;
  the next step runs from them."""
  path = tmp_path / "with_adam.pt"
  write_variant("new", path, seed=6, optimizer=True)
  ckpt = import_torch.load_torch_checkpoint(path)
  params = trainable_params_from_numpy(ckpt.state_dict, "cpu")
  optimizer = train_step.make_optimizer(params, ckpt.learning_rate)
  train_step.adam_state_from_optax(optimizer, params, ckpt.optimizer)
  leaves = tree_leaves(params)
  state = optimizer.state[leaves[0]]
  assert float(state["step"]) == 7
  for a, b in zip(train_step.adam_state_to_optax(optimizer, params),
                  ckpt.optimizer):
    np.testing.assert_array_equal(a, b)
  for p in leaves:
    p.grad = torch.ones_like(p)
  optimizer.step()
  assert float(optimizer.state[leaves[0]]["step"]) == 8


# -- directories and loaders ------------------------------------------------------

@pytest.mark.parametrize("select,min_it,max_it", [
    (None, None, None), (2, None, None), (0, 3, None), (None, None, 4),
    (3, 2, 9), (5, 7, 1)])
def test_filter_checkpoints_matches_jax(select, min_it, max_it):
  its = [1, 2, 3, 4, 6, 9, 10]
  assert (store.filter_checkpoints(its, select, min_it, max_it)
          == jax_store.filter_checkpoints(its, select, min_it, max_it))
  assert store.filter_checkpoints([]) == jax_store.filter_checkpoints([])


def test_checkpoint_directory_helpers_match_jax(tmp_path):
  for it in (10, 3, 200):
    (tmp_path / f"{it}.npz").write_bytes(b"")
  (tmp_path / "notes.npz").write_bytes(b"")
  (tmp_path / "7.pt").write_bytes(b"")
  assert store.get_checkpoint_filename(5) == jax_store.get_checkpoint_filename(5)
  for d in (tmp_path, tmp_path / "missing"):
    assert (store.get_all_checkpoint_iterations(d)
            == jax_store.get_all_checkpoint_iterations(d))
  assert store.get_all_checkpoint_iterations(tmp_path) == [3, 10, 200]
  assert (store.get_last_checkpoint(tmp_path)
          == jax_store.get_last_checkpoint(tmp_path)
          == (tmp_path / "200.npz", 200))
  assert store.get_checkpoint(tmp_path, 10) == tmp_path / "10.npz"
  assert (store.get_custom_or_last_checkpoint(tmp_path, 3)
          == jax_store.get_custom_or_last_checkpoint(tmp_path, 3))
  assert (store.get_custom_or_last_checkpoint(tmp_path, None)
          == jax_store.get_custom_or_last_checkpoint(tmp_path, None))
  with pytest.raises(FileNotFoundError):
    store.get_checkpoint(tmp_path, 7)
  with pytest.raises(FileNotFoundError):
    store.get_last_checkpoint(tmp_path / "missing")


def test_any_helpers_never_pass_over_a_newer_orbax_save(tmp_path):
  """``3.npz`` beside ``5.orbax/state``: the newest save is the orbax one,
  which the port lists and refuses to load; ``3.npz`` is not returned in
  its place."""
  params, hp = tiny_params()
  CheckpointWaveglow.from_params(params, hp, iteration=3).save(
      tmp_path / "3.npz")
  (tmp_path / "5.orbax" / "state").mkdir(parents=True)
  (tmp_path / "8.orbax").mkdir()  # no state item: not a checkpoint
  assert (ckpting.get_all_iterations_any(tmp_path)
          == jax_ckpting.get_all_iterations_any(tmp_path) == [3, 5])
  last, it = ckpting.get_last_checkpoint_any(tmp_path)
  assert (last, it) == jax_ckpting.get_last_checkpoint_any(tmp_path)
  assert it == 5 and last == (tmp_path / "5.orbax").resolve()
  assert ckpting.get_checkpoint_any(tmp_path, 3) == tmp_path / "3.npz"
  assert ckpting.load_checkpoint_any(tmp_path / "3.npz").iteration == 3
  for load in (ckpting.load_checkpoint_any, ckpting.load_checkpoint_lazy):
    with pytest.raises(ValueError, match="reads no orbax checkpoint"):
      load(last)
  with pytest.raises(FileNotFoundError):
    ckpting.get_checkpoint_any(tmp_path, 8)
  with pytest.raises(FileNotFoundError):
    ckpting.get_last_checkpoint_any(tmp_path / "empty")


@pytest.mark.parametrize("relative", [False, True])
def test_convert_in_place_keeps_the_original(tmp_path, monkeypatch, relative):
  """In place with ``keep_orig``: the npz the JAX package writes, and the
  ``.pt`` kept as ``.orig`` also when one path is spelled relatively."""
  monkeypatch.chdir(tmp_path)
  path = tmp_path / "w.pt"
  write_variant("legacy", path)
  original = path.read_bytes()
  origin = "w.pt" if relative else path
  import_torch.convert_torch_checkpoint(origin, path, keep_orig=True)
  assert (tmp_path / "w.pt.orig").read_bytes() == original
  assert ckpting.sniff_checkpoint_format(path) == "npz"
  assert_checkpoints_equal(
      CheckpointWaveglow.load(path),
      jax_import.load_torch_checkpoint(tmp_path / "w.pt.orig"))


# -- download ---------------------------------------------------------------------

@pytest.mark.parametrize("html", [
    '<form id="f" action="https://drive.usercontent.google.com/download" '
    'method="get"><input type="hidden" name="id" value="X1"/>'
    '<input type="hidden" name="confirm" value="t"/></form>',
    '<a href="/uc?export=download&amp;confirm=AbCd&amp;id=XYZ">go</a>',
    '<form action="/p.pt?export=download&amp;id=XYZ"><input type="hidden" '
    'name="confirm" value="t"/></form>',
    "<html>quota exceeded</html>"], ids=["form", "legacy", "relative", "none"])
def test_parse_gdrive_interstitial_matches_jax(html):
  assert (download.parse_gdrive_interstitial(html)
          == jax_download.parse_gdrive_interstitial(html))


@pytest.fixture
def http_dir(tmp_path):
  """A directory served over HTTP on 127.0.0.1."""
  root = tmp_path / "srv"
  root.mkdir()
  handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                              directory=str(root))
  httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  yield root, f"http://127.0.0.1:{httpd.server_address[1]}"
  httpd.shutdown()
  httpd.server_close()
  thread.join(10)


def test_gdrive_confirm_flow_over_localhost(tmp_path, http_dir):
  root, url = http_dir
  payload = b"CHECKPOINT-BYTES" * 100
  (root / "payload.pt").write_bytes(payload)
  (root / "inter.html").write_text(
      f'<html><form id="f" action="{url}/payload.pt" method="get">'
      '<input type="hidden" name="confirm" value="t"/></form></html>')
  dest = tmp_path / "v1.pt"
  download._download_gdrive(f"{url}/inter.html", dest)
  assert dest.read_bytes() == payload
  assert not (tmp_path / "v1.pt.part").exists()


def test_ngc_download_is_atomic_over_localhost(tmp_path, http_dir,
                                               monkeypatch):
  """The body lands at the destination and no ``.part`` stays; a fetch
  that fails leaves no file."""
  root, url = http_dir
  (root / "v3.pt").write_bytes(b"x" * 5000)
  monkeypatch.setitem(download._NGC_URLS, 3, f"{url}/v3.pt")
  dest = tmp_path / "d" / "ckpt.pt"
  download.download_pretrained_model(dest, version=3)
  assert dest.read_bytes() == b"x" * 5000
  monkeypatch.setitem(download._NGC_URLS, 2, f"{url}/missing.pt")
  with pytest.raises(Exception):
    download.download_pretrained_model(tmp_path / "e.pt", version=2)
  assert not (tmp_path / "e.pt").exists()
  assert not (tmp_path / "e.pt.part").exists()
  with pytest.raises(ValueError, match="unsupported pretrained version"):
    download.download_pretrained_model(tmp_path / "f.pt", version=4)
  assert download._TIMEOUT_S == jax_download._TIMEOUT_S == 60.0
  assert download._GDRIVE_V1 == jax_download._GDRIVE_V1
