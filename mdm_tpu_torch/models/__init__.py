from .bridge import state_dict_from_flax  # noqa: F401
from .layers import (  # noqa: F401
    TimestepEmbedder,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
    gelu_exact,
    key_padding_bias,
    sinusoidal_table,
)
from .mdm import (  # noqa: F401
    MDM,
    Conditioning,
    EmbedAction,
    EmbedTargetLoc,
    MDMConfig,
    cfg_denoiser,
    cfg_denoiser_cached,
)
