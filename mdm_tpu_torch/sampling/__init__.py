from .pipeline import GenerationConfig, MotionGenerator, load_norm_stats  # noqa: F401
from .text import HashTextEmbedder, make_text_embedder  # noqa: F401
