"""Visualization (counterpart of mdm_tpu/visualize): stick-figure rendering."""
from .plot_script import plot_3d_motion, save_multiple_samples  # noqa: F401
