"""The command-line interface: ``python -m sgformer_tpu_torch.cli.main``."""
