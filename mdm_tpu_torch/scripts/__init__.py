"""Entry points of the port run with ``python -m mdm_tpu_torch.scripts.<name>``."""
