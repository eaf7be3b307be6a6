from .pipeline import (  # noqa: F401
    GenerationConfig,
    MotionGenerator,
    auto_mesh,
    dataset_norm_stats,
    in_between_mask,
    load_norm_stats,
    upper_body_mask,
)
from .text import HashTextEmbedder, make_text_embedder  # noqa: F401
