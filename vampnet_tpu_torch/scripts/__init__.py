"""The port's command-line scripts (counterparts of the repository's `scripts/`),
run as modules: `python -m vampnet_tpu_torch.scripts.<name>`."""
