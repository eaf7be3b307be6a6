"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. The kernel choice follows the tensor's device: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises."""
from ._mask import row_bias_contrib  # noqa: F401
from .attention_train_block import (  # noqa: F401
    fused_block_attention_inference,
    fused_train_attention_block,
    train_attention_block_bwd_reference,
    train_attention_block_reference,
)
from .encoder_tail import (  # noqa: F401
    encoder_tail_bwd_reference,
    encoder_tail_reference,
    fused_encoder_tail,
    fused_encoder_tail_inference,
)
from .layer_inference import (  # noqa: F401
    fused_layer_inference,
    layer_inference_reference,
)
