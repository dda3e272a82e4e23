"""CLI logging: ANSI-colored console + optional timestamped file logger
(counterpart of ``waveglow_tpu/cli/logging_config.py``).

The console root logger colors by level; a separate non-propagating file
logger captures the full record of a run, with per-input-file queue loggers
that write a batch job's messages grouped by file.
"""

from __future__ import annotations

import logging
import platform
import sys
from pathlib import Path
from typing import Optional

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[0m",       # default
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[1;31m",
}
_RESET = "\x1b[0m"


class ColorFormatter(logging.Formatter):

  def format(self, record: logging.LogRecord) -> str:
    message = super().format(record)
    if sys.stderr.isatty():
      color = _COLORS.get(record.levelno, "")
      return f"{color}{message}{_RESET}"
    return message


def configure_root_logger(debug: bool = False) -> None:
  root = logging.getLogger()
  root.setLevel(logging.DEBUG if debug else logging.INFO)
  for handler in list(root.handlers):
    root.removeHandler(handler)
  console = logging.StreamHandler()
  console.setFormatter(ColorFormatter("%(message)s"))
  root.addHandler(console)
  # quiet noisy third-party loggers
  for name in ("torch", "urllib3", "PIL"):
    logging.getLogger(name).setLevel(logging.WARNING)


def try_init_file_logger(log_path: Optional[Path],
                         debug: bool = False) -> Optional[logging.Logger]:
  file_logger = logging.getLogger("file-logger")
  # an earlier run in this process: its handler would go on writing at its
  # own offset into a file this run truncates
  for old in list(file_logger.handlers):
    file_logger.removeHandler(old)
    logging.getLogger().removeHandler(old)
    old.close()
  if log_path is None:
    return None
  try:
    log_path = Path(log_path)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(log_path, mode="w")
  except OSError:
    logging.getLogger(__name__).warning("Could not open log file %s",
                                        log_path)
    return None
  handler.setFormatter(logging.Formatter(
      "[%(asctime)s] (%(levelname)s) %(name)s: %(message)s"))
  file_logger.propagate = False
  file_logger.setLevel(logging.DEBUG if debug else logging.INFO)
  file_logger.addHandler(handler)
  logging.getLogger().addHandler(handler)  # mirror everything to the file
  return file_logger


_stem_loggers: dict = {}


def init_file_stem_loggers(stems) -> "OrderedDict[str, Queue]":
  """Per-file-stem queue loggers for batch jobs (reference
  logging_configuration.py:90-101).

  Each stem gets a logger whose records are buffered in a queue instead of
  interleaving in the shared file log; flush with
  :func:`flush_file_stem_loggers` to write them GROUPED per input file.
  The loggers are constructed directly (not via ``logging.getLogger``) so a
  100k-file batch job does not permanently grow the process-global
  ``logging.Logger.manager.loggerDict``; they live in a per-run registry
  cleared at flush.
  """
  from collections import OrderedDict
  from logging.handlers import QueueHandler
  from queue import Queue

  _stem_loggers.clear()
  queues: "OrderedDict[str, Queue]" = OrderedDict()
  for stem in stems:
    stem_logger = logging.Logger(f"file-stem.{stem}", level=logging.DEBUG)
    q: Queue = Queue(-1)
    stem_logger.addHandler(QueueHandler(q))
    _stem_loggers[stem] = stem_logger
    queues[stem] = q
  return queues


def get_file_stem_logger(stem: str) -> logging.Logger:
  """The queue-backed logger created by :func:`init_file_stem_loggers`."""
  return _stem_loggers[stem]


def flush_file_stem_loggers(queues) -> None:
  """Write every stem's buffered records to the file logger, grouped per
  file (reference logging_configuration.py:117-124).

  The grouped copies exist only for the ``--log`` file; if no file logger is
  configured (``--log`` omitted or the file failed to open), the buffered
  records are discarded instead of propagating to the root console handler,
  which would re-print every per-file line already logged live.
  """
  flogger = logging.getLogger("file-logger")
  if flogger.handlers:
    for stem, q in queues.items():
      flogger.info("Log messages for file: %s", stem)
      while not q.empty():
        flogger.handle(q.get_nowait())
  else:
    for q in queues.values():
      while not q.empty():
        q.get_nowait()
  _stem_loggers.clear()


def log_platform_banner(version: str) -> None:
  """Versions of the port, Python, torch and the CUDA runtime, and the
  card, into the ``--log`` file (nothing when there is none)."""
  logger = logging.getLogger("file-logger")
  if not logger.handlers:  # no --log file: don't propagate to the console
    return
  logger.info("waveglow-tpu-torch version: %s", version)
  logger.info("python version: %s", sys.version.replace("\n", " "))
  logger.info("platform: %s", platform.platform())
  try:
    import torch
    logger.info("torch version: %s; CUDA runtime: %s", torch.__version__,
                torch.version.cuda or "none (CPU build)")
    if torch.cuda.is_available():
      logger.info("card: %s (%d visible)", torch.cuda.get_device_name(0),
                  torch.cuda.device_count())
    else:
      logger.info("card: none visible")
  except Exception:  # noqa: BLE001 - the banner is best-effort
    pass
