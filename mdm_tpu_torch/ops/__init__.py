"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. The kernel choice follows the tensor's device: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises."""
from ._mask import row_bias_contrib  # noqa: F401
from .layer_inference import (  # noqa: F401
    fused_layer_inference,
    layer_inference_reference,
)
