"""``python -m waveglow_tpu_torch`` -> the CLI dispatcher."""

from waveglow_tpu_torch.cli.main import run_prod

run_prod()
