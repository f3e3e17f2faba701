"""Command-line entry points: `python -m mipnerf_pl_tpu_torch.cli.train` / `.eval`."""
