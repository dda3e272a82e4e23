"""Typed argparse validators and the flags several subcommands share
(counterpart of ``waveglow_tpu/cli/argparse_helpers.py``)."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable

import torch


def parse_path(value: str) -> Path:
  try:
    return Path(value)
  except ValueError as ex:
    raise argparse.ArgumentTypeError(f"invalid path: {value!r}") from ex


def parse_existing_file(value: str) -> Path:
  path = parse_path(value)
  if not path.is_file():
    raise argparse.ArgumentTypeError(f"file does not exist: {value!r}")
  return path


def parse_existing_directory(value: str) -> Path:
  path = parse_path(value)
  if not path.is_dir():
    raise argparse.ArgumentTypeError(f"directory does not exist: {value!r}")
  return path


def parse_existing_path(value: str) -> Path:
  """A file OR a directory (orbax checkpoints are directories)."""
  path = parse_path(value)
  if not path.exists():
    raise argparse.ArgumentTypeError(f"path does not exist: {value!r}")
  return path


def parse_non_empty(value: str) -> str:
  if not value:
    raise argparse.ArgumentTypeError("value must not be empty")
  return value


def parse_positive_integer(value: str) -> int:
  try:
    result = int(value)
  except ValueError as ex:
    raise argparse.ArgumentTypeError(f"not an integer: {value!r}") from ex
  if result <= 0:
    raise argparse.ArgumentTypeError(f"value must be > 0: {value!r}")
  return result


def parse_non_negative_integer(value: str) -> int:
  try:
    result = int(value)
  except ValueError as ex:
    raise argparse.ArgumentTypeError(f"not an integer: {value!r}") from ex
  if result < 0:
    raise argparse.ArgumentTypeError(f"value must be >= 0: {value!r}")
  return result


def parse_float(value: str) -> float:
  try:
    return float(value)
  except ValueError as ex:
    raise argparse.ArgumentTypeError(f"not a float: {value!r}") from ex


def parse_float_0_to_1(value: str) -> float:
  result = parse_float(value)
  if not 0.0 <= result <= 1.0:
    raise argparse.ArgumentTypeError(f"value must be in [0, 1]: {value!r}")
  return result


def get_optional(parser_fn: Callable) -> Callable:
  def wrapper(value: str):
    if value is None or value == "":
      return None
    return parser_fn(value)
  return wrapper


def add_hparams_argument(parser: argparse.ArgumentParser) -> None:
  parser.add_argument(
      "--custom-hparams", type=get_optional(parse_non_empty), default=None,
      metavar="CUSTOM-HYPERPARAMETERS",
      help='custom hyperparameters comma separated, e.g. '
           '"batch_size=4,n_flows=12"')


def add_denoiser_and_sigma_arguments(parser: argparse.ArgumentParser) -> None:
  parser.add_argument("--sigma", type=parse_float, default=1.0,
                      help="sigma used for synthesis")
  parser.add_argument("--denoiser-strength", type=parse_float_0_to_1,
                      default=0.0005, metavar="DENOISER-STRENGTH",
                      help="strength of denoising to remove model bias")


def parse_device(value: str) -> str:
  """``cuda``, ``cuda:<index>`` or ``cpu``; whether a card is there is
  checked where the device is first used (``device.resolve_device``)."""
  try:
    device = torch.device(value)
  except RuntimeError as ex:
    raise argparse.ArgumentTypeError(f"invalid device: {value!r}") from ex
  if device.type not in ("cuda", "cpu"):
    raise argparse.ArgumentTypeError(
        f"device must be cuda[:N] or cpu: {value!r}")
  return value


def add_compute_arguments(parser: argparse.ArgumentParser) -> None:
  parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                      default=None,
                      help="matmul precision: float32 (parity mode, no "
                           "TF32) or bfloat16 (the fast path)")
  parser.add_argument("--device", type=parse_device, default="cuda",
                      help="where the model runs: the card (fails without "
                           "one) or cpu (the plain PyTorch path, for tests)")
