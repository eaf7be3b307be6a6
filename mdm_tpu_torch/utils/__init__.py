"""Config/CLI utilities (counterpart of mdm_tpu/utils)."""
from . import factory, parser  # noqa: F401
