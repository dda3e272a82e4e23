"""``serve`` subcommand: run the HTTP synthesis daemon (counterpart of
``waveglow_tpu/cli/serve_cmd.py``).

A long-lived service keeps the model on the card across requests; see
:mod:`waveglow_tpu_torch.inference.server` for the endpoints.
``--mesh-data``/``--mesh-model``/``--mesh-time`` serve over several cards
(``parallel.mesh``): ``cuda:0 .. cuda:n-1`` with ``--device cuda``, n
copies of the CPU with ``--device cpu``. A host with fewer cards than the
mesh needs is refused.
"""

from __future__ import annotations

import logging
from argparse import ArgumentParser, Namespace

from waveglow_tpu_torch.cli.argparse_helpers import (
    add_compute_arguments, add_denoiser_and_sigma_arguments,
    add_hparams_argument, get_optional, parse_existing_path,
    parse_non_negative_integer, parse_positive_integer)
from waveglow_tpu_torch.hparams import parse_custom_hparams

logger = logging.getLogger(__name__)


def init_serve_parser(parser: ArgumentParser):
  parser.description = ("Serve mel->wav synthesis over HTTP "
                        "(POST /synthesize, /synthesize-wav, /stream).")
  parser.add_argument("checkpoint", metavar="CHECKPOINT",
                      type=parse_existing_path,
                      help="checkpoint to serve (.npz or .pt)")
  parser.add_argument("--host", default="127.0.0.1",
                      help="bind address (0.0.0.0 exposes the service "
                           "beyond this machine)")
  parser.add_argument("--port", type=parse_non_negative_integer,
                      default=8642, help="TCP port (0 = ephemeral)")
  add_denoiser_and_sigma_arguments(parser)
  add_hparams_argument(parser)
  parser.add_argument("--bucket-frames", type=parse_non_negative_integer,
                      default=64,
                      help="pad request mels to a multiple of this many "
                           "frames, so requests of different lengths share "
                           "micro-batches; 0 disables")
  parser.add_argument("--chunk-frames",
                      type=get_optional(parse_positive_integer),
                      default=None,
                      help="synthesize in fixed mel windows of this many "
                           "frames (bounds activation memory for unbounded "
                           "request lengths)")
  parser.add_argument("--max-batch", type=parse_positive_integer, default=8,
                      help="micro-batch up to this many concurrent requests "
                           "into one device dispatch (1 serializes "
                           "requests batch-1)")
  parser.add_argument("--batch-window-ms", type=float, default=5.0,
                      help="wait this long for companion requests before "
                           "dispatching (0 = dispatch immediately)")
  parser.add_argument("--max-queue", type=parse_non_negative_integer,
                      default=64,
                      help="admission limit: reject requests with HTTP 503 "
                           "once this many are in flight (queued + "
                           "executing; 0 = never shed)")
  parser.add_argument("--mesh-data", type=parse_positive_integer, default=1,
                      help="shard micro-batched request rows over this many "
                           "cards (data parallelism; each card synthesizes "
                           "its rows independently)")
  parser.add_argument("--mesh-model", type=parse_positive_integer, default=1,
                      help="tensor-shard the WN hidden channels over this "
                           "many cards (2, 4 or 8: Megatron column/row "
                           "split, one reduce of the partial res/skip sums "
                           "per WN layer)")
  parser.add_argument("--mesh-time", type=parse_positive_integer, default=1,
                      help="shard each utterance's mel frames over this many "
                           "cards (long-utterance synthesis; each card "
                           "recomputes the receptive-field halo of its "
                           "span). Mutually exclusive with "
                           "--mesh-data/--mesh-model")
  parser.add_argument("--max-frames", type=parse_non_negative_integer,
                      default=8192,
                      help="size limit: reject request mels over this many "
                           "frames with HTTP 413 (8192 ~= 95 s of audio; "
                           "0 = unlimited — combine a higher limit with "
                           "--chunk-frames to bound memory)")
  parser.add_argument("--allow-torch-reload", action="store_true",
                      default=False,
                      help="let POST /reload hot-swap torch-format "
                           "checkpoints (loads arbitrary pickles — enable "
                           "only on trusted networks; npz reloads are "
                           "always allowed)")
  parser.add_argument("--warmup-frames", type=str, default=None,
                      help="comma-separated mel frame counts to run the "
                           "serving calls for (solo and every power-of-two "
                           "micro-batch, raw and denoised) before binding "
                           "the port, e.g. '832' or '512,832,1600'")
  add_compute_arguments(parser)
  return _run


def build_mesh(ns: Namespace):
  """The mesh the ``--mesh-*`` flags ask for (None for one device): over
  ``cuda:0 .. cuda:n-1``, or n copies of the CPU with ``--device cpu``.
  Raises ``ValueError`` when ``--mesh-time`` is combined with the other
  two, or when the host has fewer cards than the mesh needs."""
  from waveglow_tpu_torch.parallel.mesh import make_mesh, make_time_mesh

  n = max(ns.mesh_data * ns.mesh_model, ns.mesh_time)
  devices = ["cpu"] * n if ns.device.startswith("cpu") else None
  if ns.mesh_time > 1:
    if ns.mesh_data > 1 or ns.mesh_model > 1:
      raise ValueError("--mesh-time is mutually exclusive with "
                       "--mesh-data/--mesh-model")
    return make_time_mesh(ns.mesh_time, devices=devices)
  if ns.mesh_data > 1 or ns.mesh_model > 1:
    return make_mesh(data=ns.mesh_data, model=ns.mesh_model,
                     devices=devices)
  return None


def _run(ns: Namespace) -> bool:
  from waveglow_tpu_torch.checkpointing import load_checkpoint_any
  from waveglow_tpu_torch.device import resolve_device
  from waveglow_tpu_torch.inference.server import (SynthesisService,
                                                   serve_forever)

  device = resolve_device(ns.device)  # no card, no work
  mesh = build_mesh(ns)
  custom_hparams = parse_custom_hparams(ns.custom_hparams)
  if ns.compute_dtype is not None:
    custom_hparams["compute_dtype"] = ns.compute_dtype
  service = SynthesisService(
      load_checkpoint_any(ns.checkpoint),
      custom_hparams=custom_hparams or None,
      bucket_frames=ns.bucket_frames, chunk_frames=ns.chunk_frames,
      sigma=ns.sigma, denoiser_strength=ns.denoiser_strength,
      max_batch=ns.max_batch, batch_window_ms=ns.batch_window_ms,
      max_queue=ns.max_queue, max_frames=ns.max_frames,
      allow_torch_reload=ns.allow_torch_reload,
      device=None if mesh is not None else device, mesh=mesh)
  if mesh is not None:
    logger.info("Serving over a device mesh: %s", mesh.shape)
  warmup_frames = ([int(f) for f in ns.warmup_frames.split(",") if f]
                   if ns.warmup_frames else None)
  logger.info("Model ready; binding %s:%d", ns.host, ns.port)
  serve_forever(service, ns.host, ns.port, warmup_frames=warmup_frames)
  return True
