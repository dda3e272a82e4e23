"""Multi-process training in the port: two processes joined over
``torch.distributed`` with ``gloo`` on the CPU, each a worker started with
``subprocess`` (as the JAX package's ``tests/test_multihost.py`` does),
driving ``train()`` and the ``train`` command with its multi-process flags.
Every wait has its own time limit, and the process group a timeout, so a
hang fails the test instead of eating the suite's clock.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.checkpointing.store import CheckpointWaveglow
from waveglow_tpu_torch.training import loop
from waveglow_tpu_torch.training.loop import train
from test_torch_training import write_speech_dataset

REPO = Path(__file__).resolve().parents[1]
# lr is tiny on purpose (as in the JAX package's two-process test): Adam
# turns summation-order noise in near-zero grads into lr-sized steps, so at
# the default lr the one- and two-process losses drift apart at ~1e-2
# within a few steps; at 1e-7 any wrong row, batch or resume point still
# moves the loss by far more than the bound.
HPARAMS = {"n_flows": "2", "n_layers": "2", "n_channels": "32",
           "segment_length": "2048", "batch_size": "4", "seed": "1234",
           "iters_per_checkpoint": "2", "epochs_per_checkpoint": "0",
           "learning_rate": "0.0000001"}
STEPS = 3
WAIT_S = 240           # each worker's whole run
GROUP_TIMEOUT_S = 120  # each collective

WORKER = """
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
from waveglow_tpu_torch.checkpointing.from_jax import tree_leaves
from waveglow_tpu_torch.parallel.mesh import initialize_multihost
from waveglow_tpu_torch.training import loop
from waveglow_tpu_torch.training.data import load_dataset

rank, port, data, ckpts, out = sys.argv[1:6]
initialize_multihost(f"127.0.0.1:{{port}}", 2, int(rank), backend="gloo",
                     timeout_s={timeout})
losses = []
make_step = loop.make_mesh_train_step

def recording(*args, **kwargs):
  step = make_step(*args, **kwargs)
  def run(audio):
    loss = step(audio)
    losses.append(float(loss))
    return loss
  return run

loop.make_mesh_train_step = recording
entries = load_dataset(data)
state = loop.train({hparams!r}, None, entries, entries, ckpts,
                   max_iterations={steps}, device="cpu")
np.savez(out, *tree_leaves(state["params"]), *state["opt_state"])
print("RESULT " + json.dumps({{"losses": losses, "step": state["step"]}}))
"""

CLI_WORKER = """
import sys
sys.path.insert(0, {repo!r})
from waveglow_tpu_torch.cli import main
rank, port, data, ckpts, logs = sys.argv[1:6]
sys.exit(main.run(["train", data, data, ckpts, "--custom-hparams", {hp!r},
                   "--device", "cpu", "--tl-dir", logs,
                   "--coordinator-address", f"127.0.0.1:{{port}}",
                   "--num-processes", "2", "--process-id", rank]))
"""


def free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def run_pair(script: Path, args_of) -> list:
  """Start the worker twice (ranks 0 and 1) and wait for both; returns
  their (rc, stdout, stderr). A worker that overruns is killed."""
  env = dict(os.environ, OMP_NUM_THREADS="1")
  procs = [subprocess.Popen([sys.executable, str(script), *args_of(rank)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env) for rank in range(2)]
  outs = []
  try:
    for p in procs:
      out, err = p.communicate(timeout=WAIT_S)
      outs.append((p.returncode, out, err))
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()
  for rc, out, err in outs:
    assert rc == 0, f"worker failed:\nstdout:{out[-2000:]}\nstderr:{err[-3000:]}"
  return outs


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
  """train() in two gloo processes (global batch 4, 2 rows a process), each
  saving into a folder of its own; and its one-process counterpart."""
  tmp = tmp_path_factory.mktemp("multihost")
  entries = write_speech_dataset(tmp / "data", n=8, length=6000)
  script = tmp / "worker.py"
  script.write_text(WORKER.format(repo=str(REPO), hparams=HPARAMS,
                                  steps=STEPS, timeout=GROUP_TIMEOUT_S))
  port = str(free_port())
  outs = run_pair(script, lambda r: [str(r), port, str(tmp / "data"),
                                     str(tmp / f"ck{r}"),
                                     str(tmp / f"state{r}.npz")])
  results = [json.loads(next(line for line in out.splitlines()
                             if line.startswith("RESULT "))[7:])
             for _, out, _ in outs]
  states = [np.load(tmp / f"state{r}.npz") for r in range(2)]
  losses = []
  make_step = loop.make_train_step

  def recording(*args, **kwargs):
    step = make_step(*args, **kwargs)

    def run(params, audio):
      loss = step(params, audio)
      losses.append(float(loss))
      return loss
    return run

  loop.make_train_step = recording
  try:
    single = train(HPARAMS, None, entries, entries, tmp / "ck_single",
                   max_iterations=STEPS, device="cpu")
  finally:
    loop.make_train_step = make_step
  return {"tmp": tmp, "results": results, "states": states,
          "single": single, "single_losses": losses}


def test_two_processes_agree_with_each_other_and_one_process(two_process_run):
  """Both ranks report the same losses (each step's is the global batch's,
  reduced in process order), within 1e-4 relative of one-process train()
  on the same global batches; their params and Adam state are the same
  bits; only process 0 wrote checkpoints."""
  run = two_process_run
  a, b = run["results"]
  assert a["step"] == b["step"] == STEPS
  assert a["losses"] == b["losses"]
  assert all(np.isfinite(a["losses"]))
  assert a["losses"] == pytest.approx(run["single_losses"], rel=1e-4)
  s0, s1 = run["states"]
  assert s0.files == s1.files
  for key in s0.files:
    np.testing.assert_array_equal(s0[key], s1[key])
  assert sorted(p.name for p in (run["tmp"] / "ck0").iterdir()) == [
      "1.npz", "2.npz"]
  assert not (run["tmp"] / "ck1").exists()
  params = tree_leaves(run["single"]["params"])
  for i, leaf in enumerate(params):
    np.testing.assert_allclose(s0[f"arr_{i}"], leaf, atol=1e-7)


def test_two_processes_through_the_cli_flags(two_process_run):
  """The train command with --num-processes 2 --process-id r
  --coordinator-address (gloo with --device cpu): process 0's step-2
  checkpoint is bit for bit that of the train() run; process 1 writes
  none."""
  tmp = two_process_run["tmp"]
  hp = ",".join(f"{k}={v}" for k, v in dict(HPARAMS, epochs="1").items())
  script = tmp / "cli_worker.py"
  script.write_text(CLI_WORKER.format(repo=str(REPO), hp=hp))
  port = str(free_port())
  run_pair(script, lambda r: [str(r), port, str(tmp / "data"),
                              str(tmp / f"cli_ck{r}"),
                              str(tmp / f"cli_logs{r}")])
  assert sorted(p.name for p in (tmp / "cli_ck0").iterdir()) == [
      "1.npz", "2.npz"]
  assert not (tmp / "cli_ck1").exists()
  got = CheckpointWaveglow.load(tmp / "cli_ck0" / "2.npz")
  want = CheckpointWaveglow.load(tmp / "ck0" / "2.npz")
  assert got.iteration == want.iteration == 2
  for a, b in zip(tree_leaves(got.state_dict), tree_leaves(want.state_dict)):
    np.testing.assert_array_equal(a, b)
  for a, b in zip(got.optimizer, want.optimizer):
    np.testing.assert_array_equal(a, b)
  records = [json.loads(line) for line in
             (tmp / "cli_logs0" / "metrics.jsonl").read_text().splitlines()]
  assert [r["iteration"] for r in records if r["event"] == "train_step"] == [
      1, 2]
  assert not (tmp / "cli_logs1" / "metrics.jsonl").exists()


def test_one_process_is_not_a_group():
  """initialize_multihost is a no-op for one process; the process index
  and count read 0 and 1 without a group."""
  from waveglow_tpu_torch.parallel import mesh
  mesh.initialize_multihost("127.0.0.1:1", 1, 0)
  assert not torch.distributed.is_initialized()
  assert (mesh.process_index(), mesh.process_count()) == (0, 1)
  with pytest.raises(ValueError, match="--process-id"):
    mesh.initialize_multihost("127.0.0.1:1", 2, None)
