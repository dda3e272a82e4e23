"""CLI dispatcher: waveglow-tpu-torch {download,train,continue-train,
validate,synthesize,synthesize-wav,serve} (counterpart of
``waveglow_tpu/cli/main.py``).

Each subcommand's init function configures its parser and returns the
handler; the run wrapper sets up logging, logs a platform banner to the
file logger, times the handler and prints a success or failure banner.
Exit codes: 0 success (and a bare invocation, which prints help), 1
failure, 130 interrupted. The JAX CLI's ``benchmark`` is not offered: it
runs the JAX package's bench, and the port has no bench yet.
"""

from __future__ import annotations

import argparse
import logging
import sys
import tempfile
import time
from pathlib import Path

from waveglow_tpu_torch import __version__
from waveglow_tpu_torch.cli.argparse_helpers import parse_path

PROG = "waveglow-tpu-torch"
DEFAULT_LOG = Path(tempfile.gettempdir()) / f"{PROG}.log"

logger = logging.getLogger(__name__)


def _init_download_parser(parser: argparse.ArgumentParser):
  parser.description = ("Download a pre-trained model from Nvidia and "
                        "convert it to the native format.")
  parser.add_argument("checkpoint", metavar="CHECKPOINT", type=parse_path,
                      help="download checkpoint to this path")
  parser.add_argument("--ver", type=int, metavar="VERSION",
                      choices=[1, 2, 3, 5], default=3,
                      help="pre-trained version")
  return _download_ns


def _download_ns(ns: argparse.Namespace) -> bool:
  from waveglow_tpu_torch.checkpointing.download import \
      download_pretrained_model
  from waveglow_tpu_torch.checkpointing.import_torch import \
      convert_torch_checkpoint

  download_pretrained_model(destination=ns.checkpoint, version=ns.ver)
  convert_torch_checkpoint(origin=ns.checkpoint, destination=ns.checkpoint)
  logger.info("Completed. Downloaded and converted to: %s",
              ns.checkpoint.absolute())
  return True


def _subcommands():
  from waveglow_tpu_torch.cli.serve_cmd import init_serve_parser
  from waveglow_tpu_torch.cli.synthesis_cmd import (init_synthesis_parser,
                                                    init_synthesis_wav_parser)
  from waveglow_tpu_torch.cli.training_cmd import (
      init_continue_training_parser, init_training_parser)
  from waveglow_tpu_torch.cli.validation_cmd import init_validation_parser
  return (
      ("download", "download pre-trained checkpoints from Nvidia",
       _init_download_parser),
      ("train", "start training", init_training_parser),
      ("continue-train", "continue training from a checkpoint",
       init_continue_training_parser),
      ("validate", "validate checkpoint(s)", init_validation_parser),
      ("synthesize", "synthesize mel-spectrograms into an audio signal",
       init_synthesis_parser),
      ("synthesize-wav", "synthesize audio files sample-wise "
       "(copy synthesis)", init_synthesis_wav_parser),
      ("serve", "run the HTTP synthesis daemon", init_serve_parser),
  )


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      prog=PROG,
      description="CLI to use WaveGlow on an NVIDIA card (PyTorch/CUDA).",
      formatter_class=argparse.ArgumentDefaultsHelpFormatter)
  parser.add_argument("-v", "--version", action="version",
                      version=f"{PROG} {__version__}")
  subparsers = parser.add_subparsers(dest="command")
  for name, description, init_fn in _subcommands():
    sub = subparsers.add_parser(
        name, help=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub.set_defaults(handler=init_fn(sub))
    sub.add_argument("--log", type=parse_path, metavar="FILE",
                     default=DEFAULT_LOG, help="path to write the log")
    sub.add_argument("--debug", action="store_true",
                     help="include debugging information in the log")
  return parser


def debug_file_exists() -> bool:
  """A ``$TMP/waveglow-tpu-torch-debug`` marker file forces debug logging
  for every run without editing commands."""
  return (Path(tempfile.gettempdir()) / f"{PROG}-debug").is_file()


def run(args=None) -> int:
  from waveglow_tpu_torch.cli.logging_config import (configure_root_logger,
                                                     log_platform_banner,
                                                     try_init_file_logger)

  parser = build_parser()
  ns = parser.parse_args(args)
  if not hasattr(ns, "handler"):
    parser.print_help()  # a bare invocation succeeds
    return 0

  debug = ns.debug or debug_file_exists()
  configure_root_logger(debug=debug)
  try_init_file_logger(ns.log, debug=debug)
  log_platform_banner(__version__)

  start = time.perf_counter()
  try:
    success = ns.handler(ns)
  except KeyboardInterrupt:
    logger.warning("Interrupted.")
    return 130
  except Exception:  # noqa: BLE001
    logger.exception("Command failed with an unexpected error.")
    success = False
  duration = time.perf_counter() - start

  if success or success is None:
    logger.info("\x1b[32mEverything was successful!\x1b[0m "
                "(%.2fs)", duration)
    return 0
  logger.error("\x1b[31mSomething went wrong! See the log for details: "
               "%s\x1b[0m (%.2fs)", ns.log, duration)
  return 1


def run_prod() -> None:
  sys.exit(run())


if __name__ == "__main__":
  run_prod()
