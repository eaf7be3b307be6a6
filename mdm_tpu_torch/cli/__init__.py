"""Command-line entry points (counterpart of mdm_tpu/cli): train, generate, edit."""
